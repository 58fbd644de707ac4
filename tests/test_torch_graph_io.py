"""The port's graph I/O and dataset utilities against gnn_tpu's on the same
seeded graphs: graph folders written by either package and read by both
(.npy files byte-equal), load_mutag on a small TU-format folder the test
writes, getindices / getbatches / normalize_graphs / prepare_LKO_data, the
dataset generators with scikit-learn out of reach, and a merged graph-focus
Graph packed as its graphs by model.to_batch."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import datasets as jdata
from gnn_tpu.graphs import utils as jutils
from gnn_tpu.graphs.batch import GraphBatch as JBatch
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs import utils as tutils
from gnn_tpu_torch.graphs.batch import GraphBatch as TBatch
from gnn_tpu_torch.graphs.graph import Graph as TGraph, GraphObject, split_graphs

torch.set_num_threads(1)
FIELDS = ("arcs", "nodes", "targets", "set_mask", "output_mask", "sample_weights", "NodeGraph",
          "node_types", "focus", "aggregation_mode")


def _same_graph(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert x.dtype == y.dtype, f
        else:
            assert x == y, f


def _pair(kind, seed=0):
    """The same graph in both packages: (gnn_tpu Graph, port Graph)."""
    rng = np.random.default_rng(seed)
    g = jdata.random_graph(9, 3, 2, 2, 0.5, focus="g" if kind == "g" else "n", rng=rng)
    kw = dict(arcs=g.arcs, nodes=g.nodes, targets=g.targets, focus=g.focus,
              aggregation_mode="sum")
    if kind == "masked":
        kw.update(set_mask=rng.random(9) < 0.6, output_mask=rng.random(9) < 0.8)
        kw["targets"] = g.targets[kw["output_mask"]]
        kw["sample_weights"] = rng.random(int(kw["output_mask"].sum())) + 0.5
    if kind == "typed":
        kw["node_types"] = rng.integers(0, 3, 9)
    if kind == "g":
        parts = [jdata.random_graph(int(n), 3, 2, 2, 0.5, focus="g", rng=rng) for n in (5, 7)]
        j = JGraph.merge(parts, aggregation_mode="sum")
        t = TGraph.merge([TGraph(arcs=p.arcs, nodes=p.nodes, targets=p.targets, focus="g")
                          for p in parts], aggregation_mode="sum")
        return j, t
    return JGraph(**kw), TGraph(**kw)


KINDS = ("plain", "masked", "typed", "g")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ("gnn_tpu", "port"))
def test_npy_folders_interchange(kind, writer, tmp_path):
    j, t = _pair(kind)
    _same_graph(t, j)
    (j if writer == "gnn_tpu" else t).save(str(tmp_path / "a"))
    (t if writer == "gnn_tpu" else j).save(str(tmp_path / "b"))
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    for n in names:   # byte-equal files
        assert (tmp_path / "a" / n).read_bytes() == (tmp_path / "b" / n).read_bytes(), n
    focus = j.focus
    _same_graph(TGraph.load(str(tmp_path / "a"), focus=focus, aggregation_mode="sum"),
                JGraph.load(str(tmp_path / "a"), focus=focus, aggregation_mode="sum"))
    _same_graph(TGraph.load(str(tmp_path / "a") + "/", problem_based=focus,
                            aggregation_mode="sum"), j)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ("gnn_tpu", "port"))
def test_txt_folders_interchange(kind, writer, tmp_path):
    j, t = _pair(kind, seed=1)
    (j if writer == "gnn_tpu" else t).savetxt(str(tmp_path / "a"))
    (t if writer == "gnn_tpu" else j).savetxt(str(tmp_path / "b"))
    for n in sorted(os.listdir(tmp_path / "a")):
        assert (tmp_path / "a" / n).read_text() == (tmp_path / "b" / n).read_text(), n
    _same_graph(TGraph.load_txt(str(tmp_path / "a"), focus=j.focus, aggregation_mode="sum"),
                JGraph.load_txt(str(tmp_path / "a"), focus=j.focus, aggregation_mode="sum"))


def test_graph_accessors_match():
    j, t = _pair("masked", seed=2)
    for name in ("getArcs", "getNodes", "getTargets", "getSetMask", "getOutputMask",
                 "getSampleWeights", "getNodeGraph"):
        a, b = getattr(t, name)(), getattr(j, name)()
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for mode in ("average", "normalized", "sum"):
        t.set_aggregation(mode)
        j.setAggregation(mode)
        for name in ("getAdjacency", "getArcNode"):
            a, b = getattr(t, name)(), getattr(j, name)()
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a.toarray(), b.toarray())
    with pytest.raises(ValueError):
        t.set_aggregation("max")
    c = t.copy()
    _same_graph(c, t)
    c.nodes[0, 0] += 1.0
    assert c.nodes[0, 0] != t.nodes[0, 0]
    assert t.problem_based == j.problem_based and t.n_graphs == j.n_graphs
    assert GraphObject is TGraph
    g = TGraph(arcs=j.arcs, nodes=j.nodes, targets=j.targets, problem_based="g",
               NodeGraph=np.full((9, 1), 1 / 9))
    assert g.focus == "g" and g.NodeGraph.shape == (9, 1)


def test_from_graph_tensor_round_trips():
    _, t = _pair("g", seed=3)
    gb = TBatch.from_graph(t)
    _same_graph(TGraph.fromGraphTensor(gb), gb.to_graph())


def _write_tu(folder, rng, n_graphs=5):
    """A TU-format Mutagenicity folder: 1-based node ids, duplicate arcs."""
    os.makedirs(folder)
    sizes = rng.integers(3, 7, n_graphs)
    gid = np.repeat(np.arange(1, n_graphs + 1), sizes)
    start = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    for g in range(n_graphs):
        for _ in range(2 * sizes[g]):
            a, b = rng.integers(start[g], start[g + 1], 2) + 1
            edges += [(a, b), (b, a)]
    edges += edges[:3]                       # duplicates, dropped by the parser
    edges = np.array(edges)
    np.savetxt(os.path.join(folder, "Mutagenicity_edges.txt"), edges, fmt="%d", delimiter=", ")
    np.savetxt(os.path.join(folder, "Mutagenicity_edge_labels.txt"),
               rng.integers(0, 3, len(edges)), fmt="%d")
    np.savetxt(os.path.join(folder, "Mutagenicity_node_labels.txt"),
               rng.integers(0, 4, len(gid)), fmt="%d")
    np.savetxt(os.path.join(folder, "Mutagenicity_graph_indicator.txt"), gid, fmt="%d")
    np.savetxt(os.path.join(folder, "Mutagenicity_graph_labels.txt"),
               rng.integers(0, 2, n_graphs), fmt="%d")


@pytest.mark.parametrize("mode", ("average", "sum"))
def test_load_mutag_matches_gnn_tpu(mode, tmp_path):
    _write_tu(str(tmp_path / "tu"), np.random.default_rng(4))
    want = jdata.load_mutag(str(tmp_path / "tu"), aggregation_mode=mode)
    got = tdata.load_mutag(str(tmp_path / "tu"), aggregation_mode=mode)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        _same_graph(a, b)


@pytest.mark.parametrize("focus", ("n", "a"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_generators_draw_gnn_tpus_targets_without_sklearn(focus, seed, monkeypatch):
    want = jdata.random_graph(30, 3, 2, 3, 0.3, focus=focus, rng=seed)
    want_simple = jdata.simple_graph(focus)
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        import sklearn  # noqa: F401
    got = tdata.random_graph(30, 3, 2, 3, 0.3, focus=focus, rng=seed)
    _same_graph(got, want)
    _same_graph(tdata.simple_graph(focus), want_simple)
    _same_graph(tdata.random_graph(30, 3, 2, 3, 0.3, problem_based=focus, rng=seed), want)


def test_ward_labels_match_sklearn():
    from sklearn.cluster import AgglomerativeClustering
    rng = np.random.default_rng(5)
    for n, d, k in ((4, 2, 2), (40, 3, 5), (120, 1, 7), (9, 2, 9)):
        x = rng.random((n, d))
        np.testing.assert_array_equal(tdata.ward_labels(x, k),
                                      AgglomerativeClustering(n_clusters=k).fit(x).labels_)
    with pytest.raises(ValueError):
        tdata.ward_labels(rng.random((3, 2)), 4)


@pytest.mark.parametrize("args", [(10, 0.7, 0.1, 0), (4337, 0.7, 0.1, 0), (23, 0.5, 0.25, 7),
                                  (11, 0.6, 0.2, False)])
def test_getindices_matches(args):
    assert tutils.getindices(*args) == jutils.getindices(*args)


def _graph_sets(seed, n=12, focus="g"):
    gs = tdata.mutag_shaped(seed=seed, n_graphs=n)
    if focus == "n":
        rng = np.random.default_rng(seed)
        gs = [tdata.random_graph(int(rng.integers(6, 12)), 3, 1, 2, 0.5, focus="n", rng=rng)
              for _ in range(n)]
    js = [JGraph(arcs=g.arcs, nodes=g.nodes, targets=g.targets, focus=g.focus,
                 node_graph=g.NodeGraph) for g in gs]
    return js, gs


@pytest.mark.parametrize("kw", [dict(batch_size=5), dict(number_of_batches=3),
                                dict(batch_size=4, one_graph_per_batch=False),
                                dict(number_of_batches=2, aggregation_mode="sum")])
def test_getbatches_matches(kw):
    js, ts = _graph_sets(0)
    want, got = jutils.getbatches(js, **kw), tutils.getbatches(ts, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            _same_graph(x, y)


def test_getbatches_blocked_matches_from_graphs_blocked():
    from gnn_tpu_torch.graphs.batch import from_graphs_blocked
    _, ts = _graph_sets(1, n=9)
    got = tutils.getbatches(ts, batch_size=4, block_w=32)
    want = [from_graphs_blocked(ts[i:i + 4], block_w=32, focus="g") for i in (0, 4, 8)]
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.pad_shapes() == b.pad_shapes()
        assert torch.equal(a.nodes, b.nodes) and torch.equal(a.graph_ids, b.graph_ids)


@pytest.mark.parametrize("based_on", ("gTr", "all"))
@pytest.mark.parametrize("ranges", [(None, None), ((-1, 1), (0, 2))])
def test_normalize_graphs_matches(based_on, ranges):
    js, ts = _graph_sets(2, focus="n")
    for gs in (js, ts):                      # a constant arc-label column
        gs[0].arcs[:, 2] = 0.25
    jutils.normalize_graphs(js[:6], js[6:9], js[9:], based_on, *ranges)
    tutils.normalize_graphs(ts[:6], ts[6:9], ts[9:], based_on, *ranges)
    for a, b in zip(ts, js):
        _same_graph(a, b)


@pytest.mark.parametrize("useVa", (False, True))
@pytest.mark.parametrize("single", (False, True))
def test_prepare_lko_data_matches(useVa, single):
    js, ts = _graph_sets(3, n=16, focus="n")
    if single:
        js, ts = JGraph.merge(js), TGraph.merge(ts)
    want = jutils.prepare_LKO_data(js, number_of_batches=4, useVa=useVa, seed=11)
    got = tutils.prepare_LKO_data(ts, number_of_batches=4, useVa=useVa, seed=11)
    for gl, wl in zip(got, want):
        assert len(gl) == len(wl) == 4
        for a, b in zip(gl, wl):
            for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
                if y is None:
                    assert x is None
                else:
                    _same_graph(x, y)


@pytest.mark.parametrize("typed", (False, True))
def test_merged_graph_focus_batch_pools_each_graph(typed, tmp_path):
    """model.to_batch of a merged graph-focus Graph (as getbatches and
    prepare_LKO_data make) packs its graphs: the outputs equal gnn_tpu's on
    the merged graph's from_graph batch."""
    from gnn_tpu import GNNgraphBased as JModel, MLPSpec as JSpec, get_inout_dims
    from gnn_tpu_torch import GNNgraphBased, MLPSpec
    js, ts = _graph_sets(4, n=7)
    if typed:
        for g in ts:
            g.node_types = np.arange(g.n_nodes, dtype=np.int32) % 2
    mt = TGraph.merge(ts)
    parts = split_graphs(mt)
    assert len(parts) == 7
    for a, b in zip(parts, ts):
        _same_graph(a, b)
    in_s, l_s = get_inout_dims("state", 14, 3, 2, "g", 0, None)
    in_o, l_o = get_inout_dims("output", 14, 3, 2, "g", 0, None)
    kw_s = dict(input_dim=in_s, units=tuple(l_s), activations="tanh", batch_normalization=False)
    kw_o = dict(input_dim=in_o, units=tuple(l_o), activations="softmax",
                batch_normalization=False)
    jm = JModel(JSpec(**kw_s), JSpec(**kw_o), max_iteration=4, seed=0, path_writer=str(tmp_path / "w"))
    tm = GNNgraphBased(MLPSpec(**kw_s), MLPSpec(**kw_o), max_iteration=4, seed=0, device="cpu")
    tm.set_params(*jax.tree_util.tree_map(np.asarray, (jm.params, jm.bn)))
    want = jm(JBatch.from_graph(JGraph.merge(js)))
    np.testing.assert_allclose(tm(mt), want, atol=1e-6)
    assert tm.to_batch(mt).n_real[2] == 7
