"""Batches without blocks against gnn_tpu's, on the CPU: GraphBatch.from_graph
and its utilities, the generators, aggregation='pallas' (the segment kernel
K18's plain version) in the plain body, and Predictor(blocked=False).

Both packages get the same numpy-seeded graphs. Batch fields must be equal
(the host arc-label aggregation within 1e-6: its terms may be added in
another order). Forwards: realised iteration counts equal, states and
outputs within atol 3e-5 (the contract's bound); training steps: loss rtol
1e-5, moving statistics atol 1e-5, grads rtol 2e-4 (atol 1e-6), with the
dropout masks gnn_tpu draws; served outputs within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs import generator as jgen
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu.models import core as jcore
from gnn_tpu.serving import Predictor as JPredictor
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased, Predictor
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs import generator as tgen
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import segment as tseg
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_composite import check_step_against_gnn_tpu, composite_specs, composite_weights
from test_torch_core import _specs, _weights
from test_torch_serving import _models
from test_torch_training import _jax_masks

torch.set_num_threads(1)
TGB = tbatch.GraphBatch
JGB = jbatch.GraphBatch
NL, AL, DT = 5, 3, 2
ATOL = 3e-5
FIELDS = ("nodes", "node_mask", "graph_ids", "pool_w", "src", "dst", "arc_labels", "edge_w",
          "edge_mask", "set_mask", "output_mask", "targets", "sample_weights", "out_index",
          "sel_mask", "agg_arcs_cache")


def graph_pair(seed, focus, n=4, typed=False, masks=True):
    """(gnn_tpu Graph, port Graph) of n merged random graphs with random set
    and output masks, sample weights and, with `typed`, node types in
    range(2), from one seed."""
    rng = np.random.default_rng(seed)
    parts = [tdata.random_graph(int(rng.integers(6, 20)), NL, AL, DT, 0.4, focus=focus, rng=rng)
             for _ in range(n)]
    g = TGraph.merge(parts)
    n_ent = g.n_arcs if focus == "a" else g.n_nodes
    set_mask = rng.random(n_ent) < 0.7 if masks else None
    out_mask = rng.random(n_ent) < 0.8 if masks and focus != "g" else None
    T = g.targets.shape[0] if out_mask is None else int(out_mask.sum())
    targets = np.eye(DT)[rng.integers(0, DT, T)]
    kw = dict(focus=focus, set_mask=set_mask, output_mask=out_mask,
              sample_weights=rng.random(T) + 0.5, node_graph=g.NodeGraph,
              node_types=rng.integers(0, 2, g.n_nodes) if typed else None)
    return (JGraph(g.arcs, g.nodes, targets, **kw), TGraph(g.arcs, g.nodes, targets, **kw))


def assert_batches_equal(tb, jb):
    for f in FIELDS:
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert got.shape == want.shape, f
        if f == "agg_arcs_cache":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tb.node_types is None) == (jb.node_types is None)
    if tb.node_types is not None:
        np.testing.assert_array_equal(tb.node_types.numpy(), np.asarray(jb.node_types))
    assert tb.n_real == tuple(int(x) for x in np.asarray(jb.n_real))
    assert (tb.focus, tb.edges_sorted, tb.has_blocks) == (jb.focus, jb.edges_sorted, False)
    assert (tb.agg_plan is None) == (jb.agg_plan is None)


# ------------------------------------------------------------------ from_graph
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("pads", [None, (512, 1024, 384)])
@pytest.mark.parametrize("sort_edges", [True, False])
@pytest.mark.parametrize("focus", ["n", "a", "g"])
def test_from_graph_fields_match_gnn_tpu(focus, sort_edges, pads, typed):
    jg, tg = graph_pair(0, focus, typed=typed)
    kw = dict(sort_edges=sort_edges)
    if pads:
        kw.update(node_pad=pads[0], edge_pad=pads[1], target_pad=pads[2])
    tb = TGB.from_graph(tg, **kw)
    assert_batches_equal(tb, JGB.from_graph(jg, **kw))
    if pads:
        assert tb.pad_shapes() == pads


def test_from_graph_raises_as_gnn_tpu():
    jg, tg = graph_pair(1, "n")
    for kw in (dict(node_pad=8), dict(edge_pad=16), dict(target_pad=4)):
        for build, g in ((TGB.from_graph, tg), (JGB.from_graph, jg)):
            with pytest.raises(ValueError, match="below real sizes"):
                build(g, **kw)
    kw = dict(focus="n", output_mask=np.ones(tg.n_nodes, bool))
    bad = [G(tg.arcs, tg.nodes, tg.targets[:-1], **kw) for G in (TGraph, JGraph)]
    for build, g in zip((TGB.from_graph, JGB.from_graph), bad):
        with pytest.raises(ValueError, match="targets rows"):
            build(g)


@pytest.mark.parametrize("focus", ["n", "a", "g"])
def test_to_graph_round_trips(focus):
    """to_graph inverts from_graph (arcs in stored order) and equals
    gnn_tpu's; a blocked batch reconstructs too, with compressed node ids."""
    jg, tg = graph_pair(2, focus, typed=True)
    tb, jb = TGB.from_graph(tg), JGB.from_graph(jg)
    back, jback = tb.to_graph(), jb.to_graph()
    for name in ("arcs", "nodes", "targets", "set_mask", "output_mask", "sample_weights",
                 "node_types", "NodeGraph"):
        want = getattr(jback, name)
        if want is None:
            assert getattr(back, name) is None
        else:
            np.testing.assert_array_equal(getattr(back, name), want, err_msg=name)
    assert back.aggregation_mode == jback.aggregation_mode == "average"
    assert_batches_equal(TGB.from_graph(back), JGB.from_graph(jback))
    if focus != "a":        # arc focus: the targets come back in stored-arc order
        assert_batches_equal(TGB.from_graph(back), jb)
    parts = [graph_pair(3 + i, focus, n=1, masks=False) for i in range(3)]
    jblk = jbatch.from_graphs_blocked([p[0] for p in parts], block_w=32)
    tblk = tbatch.from_graphs_blocked([p[1] for p in parts], block_w=32)
    got, want = tblk.to_graph(), jblk.to_graph()
    for name in ("arcs", "nodes", "targets", "set_mask", "output_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("focus", ["n", "a", "g"])
def test_with_set_mask_and_repad_match_gnn_tpu(focus):
    """with_set_mask recomputes sel_mask as gnn_tpu's; repad grows every
    field as gnn_tpu's and rebuilds the plan for the new node count;
    shrinking and blocked batches raise."""
    jg, tg = graph_pair(4, focus, typed=True)
    tb = TGB.from_graph(tg, build_plan=True)
    jb = JGB.from_graph(jg, build_plan=True)
    mask = np.random.default_rng(5).random(len(tg.set_mask)) < 0.5
    assert_batches_equal(tb.with_set_mask(mask), jb.with_set_mask(mask))
    Np, Ep, Tp = (2 * x for x in tb.pad_shapes())
    grown = tb.repad(Np, Ep, Tp)
    assert_batches_equal(grown, jb.repad(Np, Ep, Tp))
    assert grown.agg_plan.fwd.num_rows == Np
    x = torch.randn(Np, 3)
    np.testing.assert_allclose(tseg.block_aggregate(x, grown.agg_plan).numpy(),
                               tcore.state_aggregation(tcore.GNNSpec(
                                   focus=focus, state_spec=TSpec(input_dim=1, units=(1,)),
                                   output_spec=TSpec(input_dim=1, units=(1,))), grown)(x).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert tb.repad(*tb.pad_shapes()) is tb
    with pytest.raises(ValueError, match="shrink"):
        tb.repad(Np // 4, Ep, Tp)
    blk = tbatch.from_graphs_blocked([tg], block_w=32)
    with pytest.raises(ValueError, match="final shape"):
        blk.repad(*blk.pad_shapes())


# -------------------------------------------------- aggregation='pallas' (K18)
def _count_plain_k18(monkeypatch):
    calls = []
    plain = tseg.segment_aggregate_ref

    def counted(state, plan):
        calls.append(plan.num_rows)
        return plain(state, plan)
    monkeypatch.setattr(tseg, "segment_aggregate_ref", counted)
    return calls


@pytest.mark.parametrize("focus,act,bn", [("n", "tanh", False), ("a", "relu", True),
                                          ("g", "selu", True)])
def test_pallas_forward_matches_gnn_tpu(focus, act, bn, monkeypatch):
    """gnn_forward with aggregation='pallas' on from_graph(build_plan=True)
    runs the plain body with K18 (its plain version here) once an
    iteration, and equals gnn_tpu's, which runs its Pallas kernel."""
    js, ts = _specs(act=act, bn=bn, focus=focus, aggregation="pallas")
    jg, tg = graph_pair(6, focus, n=6)
    (jp, jbn), (tp, tbn) = _weights(js)
    jb = JGB.from_graph(jg, build_plan=True)
    tb = TGB.from_graph(tg, build_plan=True)
    calls = _count_plain_k18(monkeypatch)
    assert tcore._eval_route(ts, tb) == "plain"
    rt = tcore.gnn_forward(ts, tp, tbn, tb)
    assert len(calls) == ts.max_iteration
    rj = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(1))
    assert float(rt["iters"]) == float(rj["iters"])
    np.testing.assert_allclose(rt["state"].numpy(), np.asarray(rj["state"]), atol=ATOL)
    np.testing.assert_allclose(rt["out"].numpy(), np.asarray(rj["out"]), atol=ATOL)


def test_pallas_composite_forward_matches_gnn_tpu(monkeypatch):
    """A two-type composite 'pallas' spec: the type-masked plain body with
    K18, against gnn_tpu's composite forward on the same plan batch."""
    from gnn_tpu.models import composite as jcomp
    from gnn_tpu_torch.models import composite as tcomp
    js, ts = composite_specs(2, aggregation="pallas")
    (jp, jbn), (tp, tbn) = composite_weights(js)
    jg, tg = graph_pair(7, "g", n=5, typed=True)
    jb = JGB.from_graph(jg, build_plan=True)
    tb = TGB.from_graph(tg, build_plan=True)
    calls = _count_plain_k18(monkeypatch)
    rt = tcomp.composite_forward(ts, tp, tbn, tb)
    assert len(calls) == ts.max_iteration
    rj = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(1))
    assert float(rt["iters"]) == float(rj["iters"])
    np.testing.assert_allclose(rt["state"].numpy(), np.asarray(rj["state"]), atol=ATOL)
    np.testing.assert_allclose(rt["out"].numpy(), np.asarray(rj["out"]), atol=ATOL)


def test_pallas_bn_training_step_matches_gnn_tpu(monkeypatch):
    """One BatchNorm training step of the flagship-shaped 'pallas' model on a
    plan batch against gnn_tpu's (its Pallas kernel forward and, for the
    gradient, on the transpose plan), with gnn_tpu's masks: K18 runs K
    times forward and K - 1 times on the transpose plan."""
    K = 4
    sk = dict(input_dim=2 * NL + AL, units=(NL,), activations="selu",
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=True, dropout_rate=(0.15,), dropout_pos=(0,),
              alphadropout=True)
    ok = dict(input_dim=NL, units=(DT,), activations="softmax", kernel_initializer="glorot_normal",
              bias_initializer="glorot_normal", dropout_rate=(0.1,), dropout_pos=(0,),
              batch_normalization=False)
    from gnn_tpu.ops.mlp import MLPSpec as JSpec
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=0.01, aggregation="pallas")
    jg, tg = graph_pair(8, "g", n=8, masks=False)
    jb = JGB.from_graph(jg, build_plan=True)
    tb = TGB.from_graph(tg, build_plan=True)
    jp, _ = jcore.gnn_init(js, jax.random.key(0))
    jbn = {"state": {"mean": jnp.full((NL,), 0.1), "var": jnp.full((NL,), 0.7)}, "output": {}}
    rng = jax.random.key(3)
    cfg = jopt.optimizer_config("adam")
    lf = "categorical_crossentropy"
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                iters, loss, res = jcore.evaluate_single(js, p, jbn, jb, rng, lf, {},
                                                         training=True)
                return loss + jcore.regularization(js, p), (iters, loss, res)
            return jax.grad(f, has_aux=True)(p)
        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
        step = jcore.make_train_step(js, lf, {}, cfg, mean=True)
        p_j, bn_j, _, _ = step(jp, jbn, jopt.make_optimizer(cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}

    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=cfg, max_iteration=K,
                          threshold=0.01, aggregation="pallas", seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    assert tcore._train_route(model.spec, tb) == "plain"
    calls = _count_plain_k18(monkeypatch)
    out = model.training_step(tb, masks=_jax_masks(js, tb.n_node_pad, rng))
    # K forward; the transpose K - 1 times: the first iteration aggregates
    # the node labels, which need no gradient
    assert len(calls) == 2 * K - 1
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(model.bn["state"][k].numpy(), np.asarray(bn_j["state"][k]),
                                   atol=1e-5)
    for net in ("state", "output"):
        for name, leaves in model.params[net].items():
            for k, p in leaves.items():
                flip = (lambda a: a.T) if k == "w" else (lambda a: a)
                np.testing.assert_allclose(flip(p.grad.numpy()), np.asarray(g_j[net][name][k]),
                                           rtol=2e-4, atol=1e-6, err_msg=f"grad {net}/{name}/{k}")
                np.testing.assert_allclose(flip(p.detach().numpy()),
                                           np.asarray(p_j[net][name][k]), atol=2e-6)


def test_pallas_composite_training_step_matches_gnn_tpu():
    """A two-type composite 'pallas' model trains on a plan batch through the
    plain body with K18, as gnn_tpu's through its kernel."""
    js, ts = composite_specs(2, aggregation="pallas")
    (jp, jbn), _ = composite_weights(js)
    jg, tg = graph_pair(9, "g", n=6, typed=True, masks=False)
    check_step_against_gnn_tpu(js, jp, jbn, JGB.from_graph(jg, build_plan=True), ts,
                               TGB.from_graph(tg, build_plan=True), jax.random.key(4), "plain")


# ------------------------------------------------------------------ generators
@pytest.mark.parametrize("shuffle,build_plan", [(True, False), (False, True)])
def test_graph_data_generator_matches_gnn_tpu(shuffle, build_plan):
    pairs = [graph_pair(10 + i, "g", n=1, masks=False) for i in range(7)]
    jgen_ = jgen.GraphDataGenerator([p[0] for p in pairs], batch_size=3, shuffle=shuffle, rng=5,
                                    build_plan=build_plan)
    tgen_ = tgen.GraphDataGenerator([p[1] for p in pairs], batch_size=3, shuffle=shuffle, rng=5,
                                    build_plan=build_plan)
    assert len(tgen_) == len(jgen_) == 3
    for _ in range(2):                                   # two epochs, reshuffled
        batches = list(zip(tgen_, jgen_))
        assert len(batches) == 3
        for tb, jb in batches:
            assert_batches_equal(tb, jb)
    with pytest.raises(ValueError, match="non-empty"):
        tgen.GraphDataGenerator([])


@pytest.mark.parametrize("focus", ["n", "a"])
def test_single_graph_data_generator_matches_gnn_tpu(focus):
    jg, tg = graph_pair(20, focus, n=3)
    jgen_ = jgen.SingleGraphDataGenerator(jg, batch_size=7, rng=2, build_plan=True)
    tgen_ = tgen.SingleGraphDataGenerator(tg, batch_size=7, rng=2, build_plan=True)
    assert len(tgen_) == len(jgen_) > 1
    for tb, jb in zip(tgen_, jgen_):
        assert_batches_equal(tb, jb)
    with pytest.raises(ValueError, match="node/edge focus"):
        tgen.SingleGraphDataGenerator(graph_pair(21, "g", n=1)[1])


# --------------------------------------------------------- serving, satellite
@pytest.mark.parametrize("focus", ["n", "a", "g"])
def test_unblocked_predictor_matches_gnn_tpu(tmp_path, focus):
    """Predictor(blocked=False) merges a request into one batch without
    blocks (and without a plan, as gnn_tpu) and serves it on the plain body:
    gnn_tpu's Predictor(blocked=False) within 1e-5; fused_layout=False
    serves blocked batches on the plain body, as gnn_tpu's."""
    jm, tm = _models(tmp_path, focus, act="selu", bn=True)
    parts = [tdata.random_graph(int(n), 3, 1, 2, 0.5, focus=focus, rng=np.random.default_rng(n))
             for n in (9, 14, 22, 17)]
    tgs = [TGraph(g.arcs, g.nodes, g.targets, focus=focus) for g in parts]
    jgs = [JGraph(g.arcs, g.nodes, g.targets, focus=focus) for g in parts]
    jp = JPredictor(jm, blocked=False)
    tp = Predictor(tm, blocked=False, device="cpu")
    assert not tp.build_batch(tgs).has_blocks and tp.build_batch(tgs).agg_plan is None
    for req_t, req_j in ((tgs, jgs), (tgs[2], jgs[2]), (tgs[:2], jgs[:2])):
        got, want = tp.predict(req_t), jp.predict(req_j)
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-5)
    tp.predict(tgs)
    assert tp.stats["batch_cache_hits"] == 1
    # blocked batches without the loop/dep layout: the plain body, as gnn_tpu's
    flat = Predictor(tm, fused_layout=False, block_w=32, device="cpu")
    assert flat.build_batch(tgs).has_blocks and flat.build_batch(tgs).adj_loop is None
    for g, w in zip(flat.predict(tgs), JPredictor(jm, fused_layout=False, block_w=32).predict(jgs)):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_fused_on_a_batch_without_blocks_raises_as_gnn_tpu():
    """aggregation='fused' on a from_graph batch raises gnn_tpu's ValueError
    (gnn_tpu/models/core.py:426-429); on a blocked batch without the loop/dep
    layout it runs K4 over every block each iteration and matches gnn_tpu's
    per-step fused path."""
    js, ts = _specs(focus="g", aggregation="fused")
    (jp, jbn), (tp, tbn) = _weights(js)
    jg, tg = graph_pair(30, "g", masks=False)
    with pytest.raises(ValueError, match="needs a block-dense batch") as jerr:
        jcore.gnn_forward(js, jp, jbn, JGB.from_graph(jg), jax.random.key(0))
    with pytest.raises(ValueError, match="needs a block-dense batch") as terr:
        tcore.gnn_forward(ts, tp, tbn, TGB.from_graph(tg))
    assert str(terr.value) == str(jerr.value)
    tb, jb = (m.from_graphs_blocked([g], block_w=32) for m, g in ((tbatch, tg), (jbatch, jg)))
    assert tb.n_node_pad > 32 and tb.adj_loop is None
    got = tcore.gnn_forward(ts, tp, tbn, tb)
    kern = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(0))
    with jax.default_matmul_precision("highest"):
        body = jcore.gnn_forward(dataclasses.replace(js, aggregation="blocked"), jp, jbn, jb,
                                 jax.random.key(0))
    assert float(got["iters"]) == float(kern["iters"]) == float(body["iters"])
    for key in ("state", "out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(body[key]), atol=ATOL)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(kern[key]), atol=2e-4)
    assert tcore._eval_route(dataclasses.replace(ts, aggregation="auto"),
                             TGB.from_graph(tg)) == "plain"
