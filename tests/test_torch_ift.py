"""grad_mode='ift' in gnn_tpu_torch (models/ift.py, the IFT routes of
models/core.py and models/composite.py) against gnn_tpu's implicit adjoint,
on the CPU.

gnn_tpu runs its exact f32 body (aggregation='blocked', highest matmul
precision) with the adjoint of gnn_tpu/models/ift.py; the port takes its own
route: the eval kernels' plain versions (K3/K4 'hybrid', K10/K9 'hybrid2')
or the plain body for the fixed point, then the Neumann solve through one
plain step. Tolerances are ROADMAP's: iteration counts equal, outputs atol
3e-5, the loss rtol 1e-5, grads rtol 2e-4 (atol 1e-6), params after one Adam
step atol 1e-5. On an IFT spec no training kernel and no kernel's backward
(K5, K11, K2, K15, K17) is called.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu.models import composite as jcomp
from gnn_tpu.models import core as jcore
from gnn_tpu.models.ift import fixed_point_ift as j_fixed_point_ift
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import (CompositeGNNgraphBased, GNNedgeBased, GNNgraphBased, GNNnodeBased,
                           Graph)
from gnn_tpu_torch.convert import flatten
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.models.ift import fixed_point_ift
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops import typed as ttyped
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
ATOL = 3e-5
K = 5
NL, AL, DT = 5, 3, 2
TCLASS = {"n": GNNnodeBased, "a": GNNedgeBased, "g": GNNgraphBased}
# every wrapper of a training kernel and of a kernel's backward
TRAIN_WRAPPERS = {tf: ("propagation_loop_bwd", "train_loop", "train_loop_bwd", "train_step"),
                  tf2: ("propagation_loop2_bwd", "train_loop2", "train_loop2_bwd"),
                  tbn: ("bn_forward_step", "bn_backward_step", "bn2_forward_step",
                        "bn2_backward_step"),
                  ttyped: ("bnT_forward_step", "bnT_backward_step")}
EVAL_WRAPPERS = {tf: ("propagation_loop", "propagation_step"),
                 tf2: ("propagation_loop2", "propagation_step2")}


def _np(t):
    return t.detach().numpy()


def flip(key, a):
    return a.T if key.endswith("['w']") and "dense_" in key else a


def jax_flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def graphs(seed, focus, types=0):
    """Both packages' graphs from one seed: 6 graphs of 8-19 nodes and a
    70-node one spanning several 32-node blocks; with `types`, node types."""
    rng = np.random.default_rng(seed)
    jgs, tgs = [], []
    for i in range(7):
        n, dens = (70, 0.15) if i == 2 else (int(rng.integers(8, 20)), 0.5)
        g = tdata.random_graph(n, NL, AL, DT, dens, focus=focus, rng=rng)
        t = rng.integers(0, types, n).astype(np.int32) if types else None
        jgs.append(JGraph(g.arcs, g.nodes, g.targets, focus=focus, node_types=t))
        tgs.append(TGraph(g.arcs, g.nodes, g.targets, focus=focus, node_types=t))
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus=focus, fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus=focus, fused_layout=True)
    assert tb.adj_loop is not None and tb.adj_dep is not None
    return jb, tb


def nets(focus, hidden=(), bn=False, act="tanh"):
    sk = dict(input_dim=2 * NL + AL, units=tuple(hidden) + (NL,), activations=act,
              kernel_initializer="glorot_normal", bias_initializer="zeros",
              batch_normalization=bn)
    ok = dict(input_dim=2 * NL + AL if focus == "a" else NL, units=(DT,), activations="softmax",
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    return sk, ok


def counted(monkeypatch):
    calls = collections.Counter()
    for mod in set(TRAIN_WRAPPERS) | set(EVAL_WRAPPERS):
        for name in TRAIN_WRAPPERS.get(mod, ()) + EVAL_WRAPPERS.get(mod, ()):
            fn = getattr(mod, name)

            def wrapper(*args, _name=name, _fn=fn, **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)
            monkeypatch.setattr(mod, name, wrapper)
    return calls


def output_masks(js, rows, rng):
    """gnn_tpu's readout keep-mask along its chain (rng, rng_prop, rng_out),
    split(key)[1] (mlp.py:252-256); the IFT state nets have no dropout."""
    _, _, rng_out = jax.random.split(rng, 3)
    keep = jax.random.bernoulli(jax.random.split(rng_out)[1], 1.0 - js.output_spec.dropout_rate[0],
                                (rows, js.output_spec.input_dim))
    return {"state": {}, "output": {0: torch.tensor(np.asarray(keep))}}


def contractive(params):
    """The state nets' weights scaled by 0.3, as tests/test_core.py:393 does:
    the implicit adjoint assumes a contractive state map (Scarselli's
    condition), without which the Neumann series diverges and amplifies the
    last bits of the fixed point in both packages alike."""
    return {**params, "state": jax.tree_util.tree_map(lambda x: 0.3 * x, params["state"])}


def step_against_gnn_tpu(monkeypatch, js, jp, jbn, jb, tb, model, composite=False):
    """One IFT step of `model` against gnn_tpu's make_train_step (or
    make_composite_train_step) on the same weights and masks; returns the
    wrapper calls."""
    rng = jax.random.key(4)
    cfg = jopt.optimizer_config("adam")
    fwd = jcomp.composite_forward if composite else jcore.gnn_forward
    reg = jcomp.composite_regularization if composite else jcore.regularization
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                res = fwd(js, p, jbn, jb, rng, training=True)
                loss = jcore.weighted_loss(jcore.get_loss(LOSS), {}, jb, res["out"])
                return loss + reg(js, p), (res["iters"], loss, res["out"])
            return jax.grad(f, has_aux=True)(p)
        g_j, (iters_j, loss_j, out_j) = grads_fn(jp)
        step = (jcomp.make_composite_train_step(js, LOSS, {}, cfg, mean=True) if composite
                else jcore.make_train_step(js, LOSS, {}, cfg, mean=True))
        p_j, bn_j, _, iters_s = step(jp, jbn, jopt.make_optimizer(cfg).init(jp), jb, rng)
    assert float(iters_s) == float(iters_j)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / max(float(iters_j), 1.0),
                                                  g_j["state"])}
    rows = tb.n_edge_pad if tb.focus == "a" else tb.n_node_pad
    masks = output_masks(js, rows, rng)
    if composite:
        masks["state"] = tuple({} for _ in js.state_specs)
    calls = counted(monkeypatch)
    out = model.training_step(tb, masks=masks)
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    want_g, want_p, want_b = jax_flat(g_j), jax_flat(p_j), jax_flat(bn_j)
    for key, p in flatten(model.params).items():
        np.testing.assert_allclose(flip(key, _np(p.grad)), want_g[key], rtol=2e-4, atol=1e-6,
                                   err_msg=f"grad {key}")
        np.testing.assert_allclose(flip(key, _np(p)), want_p[key], atol=1e-5,
                                   err_msg=f"param {key}")
    for key, v in flatten(model.bn).items():
        np.testing.assert_allclose(_np(v), want_b[key], atol=1e-5, err_msg=f"moving {key}")
    assert not any(calls[n] for names in TRAIN_WRAPPERS.values() for n in names), dict(calls)
    return calls


# ------------------------------------------------------------------ ift.py
def test_fixed_point_ift_matches_gnn_tpu():
    """fixed_point_ift on a contractive map s <- tanh(W s + U c + b): the
    Neumann adjoint's parameter grads against gnn_tpu's, and no gradient to
    the fixed point or the constants."""
    rng = np.random.default_rng(0)
    n, d = 9, 4
    W = (0.3 * rng.standard_normal((d, d))).astype(np.float32)
    U = rng.standard_normal((3, d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    c = rng.standard_normal((n, 3)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)

    def jf(p, s, consts):
        return jnp.tanh(s @ p["W"] + consts @ p["U"] + p["b"])
    s = jnp.zeros((n, d))
    jp = {"W": jnp.asarray(W), "U": jnp.asarray(U), "b": jnp.asarray(b)}
    for _ in range(80):
        s = jf(jp, s, c)
    want = jax.grad(lambda p: jnp.sum(v * j_fixed_point_ift(jf, 17, p, s, jnp.asarray(c))))(jp)

    tp = [torch.tensor(x, requires_grad=True) for x in (W, U, b)]
    tc = torch.tensor(c, requires_grad=True)

    def tf_(ps, s_, consts):
        return torch.tanh(s_ @ ps[0] + consts @ ps[1] + ps[2])
    s_star = torch.tensor(np.asarray(s), requires_grad=True)
    out = fixed_point_ift(tf_, 17, tp, s_star, tc)
    np.testing.assert_array_equal(_np(out), np.asarray(s))
    torch.sum(torch.tensor(v) * out).backward()
    for t, key in zip(tp, ("W", "U", "b")):
        np.testing.assert_allclose(_np(t.grad), np.asarray(want[key]), rtol=2e-4, atol=1e-6)
    assert s_star.grad is None and tc.grad is None


# ------------------------------------------------------------- model steps
@pytest.mark.parametrize("focus,hidden,bn,aggregation,route", [
    ("n", (), False, "segment", "plain"), ("a", (), False, "auto", "hybrid"),
    ("g", (8,), False, "auto", "hybrid2"), ("g", (), True, "auto", "bn"),
    ("n", (8,), True, "auto", "bn")])
def test_ift_step_matches_gnn_tpu(monkeypatch, focus, hidden, bn, aggregation, route):
    """One grad_mode='ift' step of each focus and route against gnn_tpu's:
    the fixed point from the plain body, K3/K4 or K10/K9 (once, K times),
    the BatchNorm routes' specs on the plain body with the statistics taken
    at the fixed point; no training kernel and no backward is called."""
    jb, tb = graphs(1, focus)
    sk, ok = nets(focus, hidden, bn, act="selu" if hidden else "tanh")
    common = dict(focus=focus, max_iteration=K, threshold=0.01, grad_mode="ift",
                  ift_backward_iters=20)
    js = jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), aggregation="blocked",
                       **common)
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    jp = contractive(jp)
    if bn:
        jbn = {"state": {"mean": jnp.full((NL,), 0.1), "var": jnp.full((NL,), 0.8)},
               "output": {}}
    model = TCLASS[focus](TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01,
                          aggregation=aggregation, grad_mode="ift", ift_backward_iters=20,
                          seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    assert tcore._train_route(model.spec, tb) == route
    calls = step_against_gnn_tpu(monkeypatch, js, jp, jbn, jb, tb, model)
    want = {"hybrid": {"propagation_loop": 1, "propagation_step": K},
            "hybrid2": {"propagation_loop2": 1, "propagation_step2": K}}.get(route, {})
    assert dict(calls) == want


def test_ift_composite_step_matches_gnn_tpu(monkeypatch):
    """A composite model with BatchNorm in every per-type net (typed kernels
    K16/K17 in 'unroll'): under 'ift' the plain body in both packages, the
    per-type statistics at the fixed point."""
    jb, tb = graphs(2, "g", types=3)
    sk, ok = nets("g", bn=True)
    sks = [dict(sk, activations=a) for a in ("selu", "tanh", "relu")]
    js = jcomp.CompositeGNNSpec(focus="g", state_specs=tuple(JSpec(**s) for s in sks),
                                output_spec=JSpec(**ok), max_iteration=K, threshold=0.01,
                                grad_mode="ift", ift_backward_iters=20)
    jp, jbn = jcomp.composite_init(js, jax.random.key(0))
    jp = contractive(jp)
    jbn = {"state": tuple({"mean": jnp.full((NL,), 0.05 * (t + 1)),
                           "var": jnp.full((NL,), 0.6 + 0.1 * t)} for t in range(3)),
           "output": {}}
    model = CompositeGNNgraphBased([TSpec(**s) for s in sks], TSpec(**ok), max_iteration=K,
                                   threshold=0.01, grad_mode="ift", ift_backward_iters=20,
                                   seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    step_against_gnn_tpu(monkeypatch, js, jp, jbn, jb, tb, model, composite=True)


@pytest.mark.parametrize("aggregation,blocked", [("segment", False), ("auto", True)])
def test_ift_grads_equal_the_unrolled_grads_at_convergence(aggregation, blocked):
    """At a converged fixed point of a contractive state net (60 iterations,
    threshold 1e-7, weights scaled by 0.3), the IFT grads with 60 backward
    iterations equal the port's own unrolled grads (as tests/test_core.py:378
    holds gnn_tpu's), on the plain body and on the K3/K4 route."""
    rng = np.random.default_rng(3)
    gs = []
    for _ in range(4 if blocked else 1):
        n, e = 30, 120
        nodes = 0.3 * rng.standard_normal((n, 3)).astype(np.float32)
        arcs = np.concatenate([rng.integers(0, n, (e, 1)), rng.integers(0, n, (e, 1)),
                               0.3 * rng.standard_normal((e, 1)).astype(np.float32)], axis=1)
        t = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
        gs.append(Graph(arcs=arcs, nodes=nodes, targets=t, focus="n",
                        aggregation_mode="average"))
    gb = (tbatch.from_graphs_blocked(gs, block_w=32, focus="n", fused_layout=True) if blocked
          else tbatch.GraphBatch.from_graph(gs[0]))
    ss = TSpec(input_dim=7, units=(3,), activations="tanh", batch_normalization=False)
    so = TSpec(input_dim=3, units=(2,), activations="softmax", batch_normalization=False)
    grads = []
    for mode in ("unroll", "ift"):
        model = GNNnodeBased(ss, so, loss_function="mse", max_iteration=60, threshold=1e-7,
                             aggregation=aggregation, grad_mode=mode, ift_backward_iters=60,
                             seed=0, device="cpu")
        with torch.no_grad():
            for p in tcore.param_leaves(model.params):
                p.mul_(0.3)
        assert tcore._train_route(model.spec, gb) == ("hybrid" if blocked else "plain")
        model.training_step(gb, mean=False, masks={"state": {}, "output": {}})
        grads.append([p.grad for p in tcore.param_leaves(model.params)])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) / (float(a.abs().max()) + 1e-8) < 5e-3


def test_ift_eval_forward_equals_unroll():
    """At eval the gradient mode changes nothing: the same routes and
    outputs as 'unroll'."""
    jb, tb = graphs(5, "g")
    sk, ok = nets("g", (8,), bn=True, act="selu")
    outs = []
    for mode in ("unroll", "ift"):
        model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, grad_mode=mode, seed=1,
                              device="cpu")
        assert tcore._eval_route(model.spec, tb) == "hybrid2"
        outs.append(model.forward(tb)["out"])
    np.testing.assert_array_equal(_np(outs[0]), _np(outs[1]))


def test_ift_never_calls_a_backward_kernel(monkeypatch):
    """On IFT specs of every route, neither K5's nor K11's plain version (nor
    any other backward) is reached, while the unrolled twin of the same
    spec calls them."""
    jb, tb = graphs(6, "g")
    seen = collections.Counter()
    for name in ("propagation_loop_bwd_ref", "propagation_loop2_bwd_ref"):
        mod = tf if name.startswith("propagation_loop_") else tf2
        fn = getattr(mod, name)

        def wrapper(*args, _name=name, _fn=fn, **kwargs):
            seen[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapper)
    for hidden in ((), (8,)):
        sk, ok = nets("g", hidden, act="selu")
        for mode in ("ift", "unroll"):
            seen.clear()
            model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, grad_mode=mode,
                                  seed=2, device="cpu")
            model.training_step(tb)
            assert sum(seen.values()) == (mode == "unroll"), (hidden, mode, dict(seen))
