"""gnn_tpu_torch's composite (per-node-type) GNN against gnn_tpu's, on the CPU:
node types through Graph, merge and the blocked batch, the typed-label
helpers, the plain body against gnn_tpu's type-masked XLA body, the model
classes' save/load in both directions, serving, and the repairs that came
with them (grad_mode on save/load, composite keys in convert.py).

Graphs and weights come from numpy seeds and gnn_tpu (carried across with
convert.params_from_jax). gnn_tpu's XLA body is reached with
GNN_TPU_FUSED_BN=0 (tests/test_typed_kernels.py:84-86); the port's plain body
with aggregation='blocked'. Tolerances as tests/test_torch_core.py: realised
iteration counts equal, states and outputs within atol 3e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs import typed as jtyped
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu.models import composite as jcomp
from gnn_tpu.models import core as jcore
from gnn_tpu.models import gnn as jgnn
from gnn_tpu.models.engine import tree_from_npz, tree_to_npz
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch import (CompositeGNNedgeBased, CompositeGNNgraphBased, CompositeGNNnodeBased,
                           GNNgraphBased, GNNnodeBased, Predictor)
from gnn_tpu_torch.convert import flatten, load_npz, params_from_jax, params_to_jax
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs import typed as ttyped
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec

torch.set_num_threads(1)
ATOL = 3e-5
NL, AL, DT = 5, 3, 2
ACTS = ("selu", "tanh", "relu")


def typed_graphs(seed, T, focus="g", n=6, big=True, absent=None):
    """Both packages' graphs from one seed: n graphs of 8-29 nodes and, with
    `big`, a 70-node one spanning several 32-node blocks (dep blocks and
    residual arcs); node types uniform over range(T) without `absent`."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(8, 30)) for _ in range(n)]
    if big:
        sizes.insert(2, 70)
    kinds = [t for t in range(T) if t != absent]
    out = ([], [])
    for s in sizes:
        g = tdata.random_graph(s, NL, AL, DT, 0.2 if s > 40 else 0.5, focus=focus, rng=rng)
        types = rng.choice(kinds, s).astype(np.int32)
        for lst, G in zip(out, (JGraph, TGraph)):
            lst.append(G(g.arcs, g.nodes, g.targets, focus=focus, node_types=types))
    return out


def composite_specs(T, focus="g", bn=True, rate=0.1, acts=ACTS, K=4, threshold=0.01, **kw):
    """(gnn_tpu spec, port spec): T one-layer state nets (activations cycling
    through `acts`, AlphaDropout `rate` at the input, the trailing BatchNorm
    when `bn`) and a softmax readout with dropout 0.1."""
    drop = dict(dropout_rate=(rate,), dropout_pos=(0,), alphadropout=True) if rate else {}
    sk = [dict(input_dim=2 * NL + AL, units=(NL,), activations=acts[t % len(acts)],
               kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
               batch_normalization=bn, **drop) for t in range(T)]
    ok = dict(input_dim=(2 * NL + AL if focus == "a" else NL), units=(DT,),
              activations="softmax", kernel_initializer="glorot_normal",
              bias_initializer="glorot_normal", batch_normalization=False,
              dropout_rate=(0.1,), dropout_pos=(0,))
    common = dict(focus=focus, max_iteration=K, threshold=threshold, **kw)
    js = jcomp.CompositeGNNSpec(state_specs=tuple(JSpec(**s) for s in sk),
                                output_spec=JSpec(**ok), **common)
    ts = tcomp.CompositeGNNSpec(state_specs=tuple(TSpec(**s) for s in sk),
                                output_spec=TSpec(**ok), **common)
    return js, ts


def composite_weights(js, seed=0):
    """((params, bn) of gnn_tpu, (params, bn) of the port): gnn_tpu's init
    with non-trivial moving statistics per type."""
    params, bn = jcomp.composite_init(js, jax.random.key(seed))
    bn = {"state": tuple({"mean": jnp.full((NL,), 0.05 * (t + 1)),
                          "var": jnp.full((NL,), 0.6 + 0.1 * t)} if b else {}
                         for t, b in enumerate(bn["state"])),
          "output": bn["output"]}
    return (params, bn), params_from_jax(*jax.tree_util.tree_map(np.asarray, (params, bn)))


def batches(jgs, tgs, focus="g"):
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus=focus, fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus=focus, fused_layout=True)
    return jb, tb


def jax_masks(js, Np, rows_out, rng):
    """The keep-masks gnn_tpu draws in one composite training forward, along
    its key chain: composite_forward splits (rng, rng_prop, rng_out)
    (composite.py:260); composite_propagate splits rng_prop into (rng,
    rng_init, rng_loop) (:141) and rng_loop into K step keys (:163); type
    t's net takes fold_in(step key, t) (:208), and each dropout layer
    split(key)[1] (mlp.py:252-256; pallas_typed.py:636-650)."""
    _, rng_prop, rng_out = jax.random.split(rng, 3)
    _, _, rng_loop = jax.random.split(rng_prop, 3)
    steps = jax.random.split(rng_loop, js.max_iteration)

    def keep(key, spec, rows):
        return np.asarray(jax.random.bernoulli(jax.random.split(key)[1],
                                               1.0 - spec.dropout_rate[0],
                                               (rows, spec.input_dim)))
    state = tuple(
        {0: torch.tensor(np.stack([keep(jax.random.fold_in(k, t), s, Np) for k in steps]))}
        if s.dropout_rate else {} for t, s in enumerate(js.state_specs))
    return {"state": state, "output": {0: torch.tensor(keep(rng_out, js.output_spec, rows_out))}}


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------------ modules
def test_graph_and_batch_node_types_match():
    jgs, tgs = typed_graphs(0, 3)
    for j, t in zip(jgs, tgs):
        np.testing.assert_array_equal(t.node_types, j.node_types)
        assert t.node_types.dtype == j.node_types.dtype
    # merge: types concatenated, a graph without types counts as type 0
    plain = tdata.random_graph(9, NL, AL, DT, 0.5, focus="g", rng=np.random.default_rng(1))
    jplain = JGraph(plain.arcs, plain.nodes, plain.targets, focus="g")
    jm = JGraph.merge(jgs[:2] + [jplain])
    tm = TGraph.merge(tgs[:2] + [plain])
    np.testing.assert_array_equal(tm.node_types, jm.node_types)
    assert TGraph.merge([plain]).node_types is None
    with pytest.raises(ValueError, match="node_types"):
        TGraph(plain.arcs, plain.nodes, plain.targets, focus="g", node_types=[0, 1])
    jb, tb = batches(jgs, tgs)
    np.testing.assert_array_equal(tb.node_types.numpy(), np.asarray(jb.node_types))
    assert tb.node_types.dtype == torch.int64
    assert tb.to("cpu").node_types is not None
    assert int(tb.node_types[~tb.node_mask].abs().sum()) == 0       # 0 on pad
    jb2, tb2 = batches(jgs[:2] + [jplain], tgs[:2] + [plain])
    np.testing.assert_array_equal(tb2.node_types.numpy(), np.asarray(jb2.node_types))
    assert tbatch.from_graphs_blocked([plain], block_w=32).node_types is None


@pytest.mark.parametrize("dims,layout", [((2, 3, 1), "block"), ((2, 3, 1), "overlay"),
                                         ((4,), "block")])
def test_typed_label_helpers_match(dims, layout):
    rng = np.random.default_rng(3)
    types = rng.integers(0, len(dims), 11)
    feats = [rng.standard_normal(dims[t]) for t in types]
    assert ttyped.typed_label_offsets(dims, layout) == jtyped.typed_label_offsets(dims, layout)
    np.testing.assert_array_equal(ttyped.pack_typed_labels(types, feats, dims, layout),
                                  jtyped.pack_typed_labels(types, feats, dims, layout))
    for net, focus in (("state", "n"), ("output", "a"), ("output", "g")):
        for hidden in (None, 7, [4, 6]):
            assert (ttyped.composite_get_inout_dims(net, dims, 3, 2, focus, hidden, layout)
                    == jtyped.composite_get_inout_dims(net, dims, 3, 2, focus, hidden, layout))


@pytest.mark.parametrize("call", [
    lambda m: m.typed_label_offsets((2, 3), "stacked"),
    lambda m: m.typed_label_offsets((2, 0)),
    lambda m: m.pack_typed_labels([0, 2], [[1.0, 2.0], [1.0]], (2, 1)),
    lambda m: m.pack_typed_labels([0, 1], [[1.0, 2.0], [1.0, 2.0]], (2, 1)),
    lambda m: m.composite_get_inout_dims("state", (2,), 3, 2, "x"),
    lambda m: m.composite_get_inout_dims("hidden", (2,), 3, 2, "n")])
def test_typed_label_helpers_raise_as_gnn_tpu(call):
    with pytest.raises(ValueError) as want:
        call(jtyped)
    with pytest.raises(ValueError) as got:
        call(ttyped)
    assert str(got.value) == str(want.value)


def test_spec_validation_matches():
    js, ts = composite_specs(2)
    ss = ts.state_specs
    other = dataclasses.replace(ss[1], units=(4,))
    with pytest.raises(ValueError, match="share"):
        tcomp.CompositeGNNSpec(focus="g", state_specs=(ss[0], other), output_spec=ts.output_spec)
    with pytest.raises(ValueError, match="at least one"):
        tcomp.CompositeGNNSpec(focus="g", state_specs=(), output_spec=ts.output_spec)
    with pytest.raises(ValueError, match="dropout-free"):
        tcomp.CompositeGNNSpec(focus="g", state_specs=ss, output_spec=ts.output_spec,
                               grad_mode="ift")
    assert ts.n_types == js.n_types == 2 and ts.state_spec == ss[0]


# --------------------------------------------------------------- plain body
@pytest.mark.parametrize("focus,T,bn", [("g", 3, True), ("n", 2, True), ("a", 2, False),
                                        ("g", 1, False)])
def test_plain_body_matches_xla_body(monkeypatch, focus, T, bn):
    """Eval forward of the port's plain body (aggregation='blocked') against
    gnn_tpu's type-masked XLA body, by focus, with and without BatchNorm."""
    monkeypatch.setenv("GNN_TPU_FUSED_BN", "0")
    jgs, tgs = typed_graphs(1, T, focus=focus)
    js, ts = composite_specs(T, focus=focus, bn=bn)
    (jp, jbn), (tp, tbn) = composite_weights(js)
    jb, tb = batches(jgs, tgs, focus)
    want = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(0))
    plain = dataclasses.replace(ts, aggregation="blocked")
    assert tcomp._route(plain, tb, False) == "plain"
    got = tcomp.composite_forward(plain, tp, tbn, tb)
    assert float(got["iters"]) == float(want["iters"])
    np.testing.assert_allclose(_np(got["state"]), np.asarray(want["state"]), atol=ATOL)
    np.testing.assert_allclose(_np(got["out"]), np.asarray(want["out"]), atol=ATOL)
    # the full eval 5-tuple (iters, loss, out rows, state, out_entity)
    lf = "categorical_crossentropy"
    full_t = tcomp.composite_full_eval(plain, tp, tbn, tb, lf)
    full_j = jcomp.make_composite_full_eval(js, lf, {})(jp, jbn, jb, jax.random.key(0))
    for a, b in zip(full_t, full_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("T,bn,rate", [(3, True, 0.1), (2, False, 0.1)])
def test_plain_body_training_step_matches_xla_body(monkeypatch, T, bn, rate):
    """One training step on the plain body (BatchNorm and BN-free composite
    specs; gnn_tpu also trains BN-free composites on its XLA body) against
    make_composite_train_step with the same JAX-drawn masks: iterations
    equal, loss rtol 1e-5, grads rtol 2e-4, moving statistics 1e-5, params
    after one Adam step 2e-6."""
    monkeypatch.setenv("GNN_TPU_FUSED_BN", "0")
    jgs, tgs = typed_graphs(2, T)
    js, ts = composite_specs(T, bn=bn, rate=rate)
    ts = dataclasses.replace(ts, aggregation="blocked")
    (jp, jbn), _ = composite_weights(js)
    jb, tb = batches(jgs, tgs)
    rng = jax.random.key(4)
    check_step_against_gnn_tpu(js, jp, jbn, jb, ts, tb, rng, expect_route="plain")


def check_step_against_gnn_tpu(js, jp, jbn, jb, ts, tb, rng, expect_route, grad_rtol=2e-4,
                               optimizer="adam"):
    """The port's CompositeGNNgraphBased.training_step against gnn_tpu's
    make_composite_train_step (and its grads), at highest matmul precision,
    with gnn_tpu's masks, both with the optimizer named. Returns the port's
    model."""
    from gnn_tpu.training import optimizers as jopt
    cfg = jopt.optimizer_config(optimizer)
    lf = "categorical_crossentropy"
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                res = jcomp.composite_forward(js, p, jbn, jb, rng, training=True)
                loss = jcore.weighted_loss(jcore.get_loss(lf), {}, jb, res["out"])
                return loss + jcomp.composite_regularization(js, p), (res["iters"], loss, res)
            return jax.grad(f, has_aux=True)(p)
        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
        step = jcomp.make_composite_train_step(js, lf, {}, cfg)
        p_j, bn_j, _, _ = step(jp, jbn, jopt.make_optimizer(cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    model = CompositeGNNgraphBased(ts.state_specs, ts.output_spec, optimizer=cfg,
                                   max_iteration=ts.max_iteration, threshold=ts.threshold,
                                   aggregation=ts.aggregation, seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    assert tcomp._route(model.spec, tb, True) == expect_route
    masks = jax_masks(js, tb.n_node_pad, tb.n_node_pad, rng)
    out = model.training_step(tb, masks=masks)
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for t, (got, want) in enumerate(zip(model.bn["state"], bn_j["state"])):
        for k in got:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=1e-5,
                                       err_msg=f"moving {k} of type {t}")
    grads = jax.tree_util.tree_map(lambda p: p.grad, model.params, is_leaf=torch.is_tensor)
    got_g, got_p = (flatten(params_to_jax(t, {})[0]) for t in (grads, model.params))
    want_g, want_p = (flatten(jax.tree_util.tree_map(np.asarray, t)) for t in (g_j, p_j))
    assert sorted(got_g) == sorted(want_g)
    for key in want_g:
        np.testing.assert_allclose(got_g[key], want_g[key], rtol=grad_rtol, atol=1e-6,
                                   err_msg=f"grad {key}")
        np.testing.assert_allclose(got_p[key], want_p[key], atol=2e-6, err_msg=f"param {key}")
    return model


# ---------------------------------------------------------- models, serving
def test_composite_save_load_both_ways(tmp_path):
    """A gnn_tpu composite save loads in the port (GNNnodeBased.load dispatches
    on model_class) with the same weights and outputs; the port's save loads
    in gnn_tpu, its params tree equal, and gnn_tpu's tree_from_npz reads it."""
    jgs, tgs = typed_graphs(3, 3)
    js, ts = composite_specs(3)
    jm = jgnn.CompositeGNNgraphBased(js.state_specs, js.output_spec, max_iteration=4,
                                     path_writer=str(tmp_path / "w"), seed=0)
    jm.save(str(tmp_path / "j"))
    back = GNNnodeBased.load(str(tmp_path / "j"), device="cpu")
    assert type(back) is CompositeGNNgraphBased and back.spec == ts
    saved = flatten(load_npz(str(tmp_path / "j" / "params.npz")))
    for key, v in flatten(params_to_jax(back.params, back.bn)[0]).items():
        np.testing.assert_array_equal(v, saved[key])
    jb, tb = batches(jgs, tgs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GNN_TPU_FUSED_BN", "0")
        want = jcomp.composite_forward(jm.spec, jm.params, jm.bn, jb, jax.random.key(0))
    np.testing.assert_allclose(back.forward(tb)["out"].numpy(), np.asarray(want["out"]),
                               atol=ATOL)
    back.training_step(tb)
    back.save(str(tmp_path / "t"))
    with open(tmp_path / "t" / "config.json") as f:
        assert [TSpec.from_config(c) for c in json.load(f)["net_states"]] == list(ts.state_specs)
    jm2 = jgnn.CompositeGNNgraphBased.load(str(tmp_path / "t"), path_writer=str(tmp_path / "w2"))
    assert jm2.spec == js
    saved = params_to_jax(back.params, back.bn)
    for tree, like, name in ((saved[0], jm.params, "params"), (saved[1], jm.bn, "bn")):
        loaded = tree_from_npz(str(tmp_path / "t" / f"{name}.npz"), like)
        assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(like)
        for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, tree))):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_convert_round_trips_composite_keys(tmp_path):
    """gnn_tpu -> port -> gnn_tpu: a composite tree_to_npz file keyed
    "['state'][0]..." nests into per-type tuples and flattens back to the
    same keys and arrays, BatchNorm-free per-type statistics included."""
    for bn in (True, False):
        js, _ = composite_specs(3, bn=bn)
        params, stats = jcomp.composite_init(js, jax.random.key(1))
        tree_to_npz(str(tmp_path / "p.npz"), params)
        tree_to_npz(str(tmp_path / "b.npz"), stats)
        p_np, b_np = load_npz(str(tmp_path / "p.npz")), load_npz(str(tmp_path / "b.npz"))
        assert isinstance(p_np["state"], tuple) and len(p_np["state"]) == 3
        tp, tbn = params_from_jax(p_np, b_np)
        assert isinstance(tp["state"], tuple) and len(tbn["state"]) == 3
        back_p, back_b = params_to_jax(tp, tbn)
        with np.load(str(tmp_path / "p.npz")) as data:
            flat = flatten(back_p)
            assert sorted(flat) == sorted(data.files)
            for k in data.files:
                np.testing.assert_array_equal(flat[k], data[k])
        np.savez(str(tmp_path / "q.npz"), **flatten(back_p))
        np.savez(str(tmp_path / "c.npz"), **flatten(back_b))
        for path, like in (("q.npz", params), ("c.npz", stats)):
            loaded = tree_from_npz(str(tmp_path / path), like)
            assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(like)


def test_grad_mode_kept_and_ift_refuses_to_train(tmp_path):
    """An ift save from gnn_tpu keeps grad_mode and ift_backward_iters in the
    port, serves as gnn_tpu does, refuses to train (models/ift.py is not
    ported), and saves back as ift; the composite classes keep it too."""
    from gnn_tpu.graphs import datasets as jdata
    from gnn_tpu.models.gnn import GNNgraphBased as JGraphBased
    rng = np.random.default_rng(5)
    gs = [tdata.random_graph(int(rng.integers(8, 30)), NL, AL, DT, 0.5, focus="g", rng=rng)
          for _ in range(5)]
    jgs = [JGraph(g.arcs, g.nodes, g.targets, focus="g") for g in gs]
    sk = dict(input_dim=2 * NL + AL, units=(NL,), activations="tanh", batch_normalization=True)
    ok = dict(input_dim=NL, units=(DT,), activations="softmax", batch_normalization=False)
    jm = JGraphBased(JSpec(**sk), JSpec(**ok), grad_mode="ift", ift_backward_iters=13,
                     path_writer=str(tmp_path / "w"), seed=0)
    jm.save(str(tmp_path / "j"))
    model = GNNgraphBased.load(str(tmp_path / "j"), device="cpu")
    assert (model.spec.grad_mode, model.spec.ift_backward_iters) == ("ift", 13)
    tb = model.to_batch(gs, block_w=32)
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    want = jcore.gnn_forward(jm.spec, jm.params, jm.bn, jb, jax.random.key(0))
    np.testing.assert_allclose(model.forward(tb)["out"].numpy(), np.asarray(want["out"]),
                               atol=ATOL)
    with pytest.raises(NotImplementedError, match="models/ift.py"):
        model.training_step(tb)
    model.save(str(tmp_path / "t"))
    back = JGraphBased.load(str(tmp_path / "t"), path_writer=str(tmp_path / "w2"))
    assert (back.spec.grad_mode, back.spec.ift_backward_iters) == ("ift", 13)
    js, ts = composite_specs(2, rate=0.0)
    cm = CompositeGNNgraphBased(ts.state_specs, ts.output_spec, grad_mode="ift",
                                ift_backward_iters=7, seed=0, device="cpu")
    jgs2, tgs2 = typed_graphs(6, 2)
    ctb = cm.to_batch(tgs2, block_w=32)
    assert tcomp._route(cm.spec, ctb, False) == "plain"
    with pytest.raises(NotImplementedError, match="models/ift.py"):
        cm.training_step(ctb)
    cm.save(str(tmp_path / "c"))
    cj = jgnn.CompositeGNNgraphBased.load(str(tmp_path / "c"), path_writer=str(tmp_path / "w3"))
    assert (cj.spec.grad_mode, cj.spec.ift_backward_iters) == ("ift", 7)


@pytest.mark.parametrize("klass,focus", [(CompositeGNNnodeBased, "n"),
                                         (CompositeGNNedgeBased, "a"),
                                         (CompositeGNNgraphBased, "g")])
def test_predictor_serves_composite_models(klass, focus):
    """Predictor on a composite model of each focus gives composite_forward's
    rows (the typed eval route) split per graph, for a request and a single
    graph; a request without node types raises."""
    _, tgs = typed_graphs(7, 3, focus=focus, n=4)
    _, ts = composite_specs(3, focus=focus)
    model = klass(ts.state_specs, ts.output_spec, max_iteration=4, seed=1, device="cpu")
    pred = Predictor(model, device="cpu")
    outs = pred.predict(tgs)
    gb = pred.build_batch(tgs)
    assert tcomp._route(model.spec, gb, False) == "typed_eval"
    res = tcomp.composite_forward(model.spec, model.params, model.bn, gb)
    rows = _np(res["out"])[gb.sel_mask.numpy()]
    np.testing.assert_array_equal(np.concatenate(outs), rows)
    assert pred.stats["last_iters"] == float(res["iters"])
    np.testing.assert_array_equal(pred.predict(tgs[1]), outs[1])
    untyped = TGraph(tgs[0].arcs, tgs[0].nodes, tgs[0].targets, focus=focus)
    with pytest.raises(ValueError, match="node_types"):
        pred.predict(untyped)
    with pytest.raises(ValueError, match="node_types"):
        model.to_batch([untyped], block_w=32)
    with pytest.raises(ValueError, match="node_types"):   # gnn_tpu's composite_propagate raise
        model.forward(tbatch.from_graphs_blocked([untyped], block_w=32, fused_layout=True))
    too_high = TGraph(tgs[0].arcs, tgs[0].nodes, tgs[0].targets, focus=focus,
                      node_types=np.full(tgs[0].n_nodes, 3))
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        pred.predict(too_high)
    # a graph without types in a typed request is type 0, as in gnn_tpu's batch
    mixed = pred.predict([tgs[0], untyped])
    assert len(mixed) == 2


def test_composite_models_default_to_the_card():
    _, ts = composite_specs(2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompositeGNNgraphBased(ts.state_specs, ts.output_spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(CompositeGNNgraphBased(ts.state_specs, ts.output_spec, device="cpu"))
    model = CompositeGNNgraphBased(ts.state_specs, ts.output_spec, seed=0, device="cpu")
    assert all(p["dense_0"]["w"].device.type == "cpu" for p in model.params["state"])
    # every per-type leaf is the optimizer's
    n_opt = sum(len(g["params"]) for g in model._opt.param_groups)
    assert n_opt == len(list(tcore.param_leaves(model.params))) == 2 * 4 + 2
