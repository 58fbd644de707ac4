"""gnn_tpu_torch host graphs and batches against gnn_tpu: the same graphs
(numpy seeds) must give array-equal graphs and exactly equal batch fields."""

import jax  # noqa: F401  (conftest pins jax to the CPU)
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs import datasets as jdata
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs.graph import Graph as TGraph

torch.set_num_threads(1)


def _pair(seed, n_graphs, sizes=(8, 30), big=True, focus="g"):
    """The same random graphs built by both packages (hybrid_workload shape:
    block_w 32, one graph spanning several blocks)."""
    out = []
    for mod in (jdata, tdata):
        rng = np.random.default_rng(seed)
        gs = [mod.random_graph(int(rng.integers(*sizes)), 5, 3, 2, 0.5, focus=focus, rng=rng)
              for _ in range(n_graphs)]
        if big:
            gs.insert(3, mod.random_graph(70, 5, 3, 2, 0.2, focus=focus, rng=rng))
        out.append(gs)
    return out


@pytest.mark.parametrize("focus", ["n", "a", "g"])
def test_random_graph_matches(focus):
    jg = jdata.random_graph(25, 5, 3, 2, 0.4, focus=focus, rng=7)
    tg = tdata.random_graph(25, 5, 3, 2, 0.4, focus=focus, rng=7)
    for name in ("arcs", "nodes", "targets", "set_mask", "output_mask", "sample_weights"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    np.testing.assert_array_equal(tg.edge_weights(), jg.edge_weights())
    np.testing.assert_array_equal(tg.graph_ids(), jg.graph_ids())
    np.testing.assert_array_equal(tg.pool_weights(), jg.pool_weights())


@pytest.mark.parametrize("mode", ["average", "normalized", "sum"])
def test_merge_and_weights_match(mode):
    jgs, tgs = _pair(3, 5, big=False)
    jm = JGraph.merge(jgs, focus="g", aggregation_mode=mode)
    tm = TGraph.merge(tgs, focus="g", aggregation_mode=mode)
    for name in ("arcs", "nodes", "targets", "set_mask", "output_mask", "NodeGraph"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    np.testing.assert_array_equal(tm.edge_weights(), jm.edge_weights())
    np.testing.assert_array_equal(tm.graph_ids(), jm.graph_ids())
    np.testing.assert_array_equal(tm.pool_weights(), jm.pool_weights())


def test_simple_graph_matches():
    for focus in ("n", "g"):
        jg, tg = jdata.simple_graph(focus), tdata.simple_graph(focus)
        np.testing.assert_array_equal(tg.arcs, jg.arcs)
        np.testing.assert_array_equal(tg.targets, jg.targets)


_SAME = ("nodes", "node_mask", "graph_ids", "pool_w", "src", "dst", "arc_labels",
         "edge_w", "edge_mask", "set_mask", "output_mask", "targets", "sample_weights",
         "out_index", "sel_mask", "agg_arcs_cache", "res_w", "loop_ids", "loop_nm",
         "dep_ids", "res_src_loc", "res_dst_loc", "block_perm")


def _assert_fields_equal(jb, tb):
    for name in _SAME:
        jv, tv = getattr(jb, name), getattr(tb, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
    assert tb.n_real == tuple(int(x) for x in np.asarray(jb.n_real))
    # adjacency: adjT[b, src, dst] of the loop / dep blocks, unpacked f32;
    # loop rows past the real loop blocks are zero padding
    adj = np.asarray(jb.adj_blocks)
    n_dep = 0 if jb.dep_ids is None else len(np.asarray(jb.dep_ids))
    n_loop = adj.shape[0] - n_dep
    want = adj[np.asarray(jb.loop_ids)].transpose(0, 2, 1).copy()
    want[n_loop:] = 0
    np.testing.assert_array_equal(tb.adj_loop.numpy(), want)
    if jb.adj_dep is not None:
        np.testing.assert_array_equal(tb.adj_dep.numpy(),
                                      adj[np.asarray(jb.dep_ids)].transpose(0, 2, 1))


@pytest.mark.parametrize("big,focus", [(True, "g"), (False, "g"), (True, "n"), (True, "a")])
def test_blocked_fused_layout_fields_match(big, focus):
    """Loop AND dep blocks (big=True: a 70-node graph over 32-node blocks)
    and a batch without dep blocks."""
    jgs, tgs = _pair(0, 12 if big else 10, big=big, focus=focus)
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus=focus, fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus=focus, fused_layout=True)
    assert (tb.adj_dep is not None) == big
    _assert_fields_equal(jb, tb)
    assert tbatch.packed_block_count(tgs, 32) == jbatch.packed_block_count(jgs, 32)


def test_blocked_padding_and_buckets_match():
    """Serving-style pads: min_blocks, edge and target pads, 24-block loop padding."""
    jgs, tgs = _pair(5, 60, big=True)
    kw = dict(block_w=32, focus="g", edge_pad=8192, target_pad=128, min_blocks=64,
              fused_layout=True)
    jb = jbatch.from_graphs_blocked(jgs, **kw)
    tb = tbatch.from_graphs_blocked(tgs, **kw)
    assert tb.adj_loop.shape[0] % 24 == 0
    _assert_fields_equal(jb, tb)


def test_mutag_shaped_set():
    gs = tdata.mutag_shaped(seed=1, n_graphs=300)
    n = sum(g.n_nodes for g in gs)
    e = sum(g.n_arcs for g in gs)
    assert gs[0].DIM_NODE_LABEL == 14 and gs[0].DIM_ARC_LABEL == 3 and gs[0].DIM_TARGET == 2
    assert 1.9 < e / n < 2.2
    assert sum(g.n_nodes > 128 for g in gs) == 3
    tb = tbatch.from_graphs_blocked(gs, block_w=128, fused_layout=True)
    assert tb.adj_dep is not None and tb.adj_loop is not None
    again = tdata.mutag_shaped(seed=1, n_graphs=300)
    np.testing.assert_array_equal(again[7].arcs, gs[7].arcs)
