"""The typed BatchNorm kernels K16/K17 of composite models (plain versions in
gnn_tpu_torch/ops/typed.py) and the routes through them, against gnn_tpu on
the CPU:

* the plain K16/K17 against gnn_tpu's _bnT_fwd_call/_bnT_bwd_call, which run
  in interpret mode (bf16 hi/lo emulation of f32: per-node outputs within
  3e-5, sums over nodes within 2e-4 of their largest entry);
* the typed eval route (K16 once an iteration) against gnn_tpu's
  typed_eval_propagate (interpret, 2e-4) and its XLA body (3e-5);
* the typed BN training step (K16/K17 through ops/bn.py's K-loop with
  per-type moments) against gnn_tpu's XLA body with JAX's per-type masks
  (loss rtol 1e-5, grads rtol 2e-4, moving statistics 1e-5) and against its
  bn_typed_train_propagate (interpret, 2e-4), an absent type included;
* one node type against the homogeneous model with the same weights: the
  K16 route against K3/K4 at eval, the K16/K17 route against K1/K2 in
  training.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.models import composite as jcomp
from gnn_tpu.ops import pallas_fused as pf
from gnn_tpu.ops import pallas_typed as pt
from gnn_tpu_torch import CompositeGNNgraphBased, GNNgraphBased
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import typed as ttyped
from gnn_tpu_torch.ops.fused2 import SMEM_BYTES
from test_torch_bn import _fm, _split, _t
from test_torch_composite import (batches, check_step_against_gnn_tpu, composite_specs,
                                  composite_weights, jax_masks, typed_graphs)

torch.set_num_threads(1)
ATOL = 3e-5
KERNEL_TOL = 2e-4     # gnn_tpu's typed kernels (bf16 hi/lo) against f32


def _inputs(seed, B=4, W=32, D=5, F=3, T=3, rate=0.15):
    """Feature-major (gnn_tpu) operands of one typed BN iteration: an
    'average' block adjacency (~10% arcs), node types (type T-1 absent when
    T > 2), keep bits, and activations, weights and cotangents that keep
    every output O(1)."""
    rng = np.random.default_rng(seed)
    arcs = rng.random((B, W, W)) < 0.1
    C = 2 * D + F + 1

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    kinds = T - 1 if T > 2 else T
    aff = np.stack([rng.uniform(0.5, 1.2, (T, D)), 0.1 * rng.standard_normal((T, D))] * 2)
    bnv = rng.uniform(0.3, 0.8, (T, 9, D))
    return dict(adjT=(arcs / np.maximum(arcs.sum(axis=1, keepdims=True), 1)).astype(np.float32),
                y1=f32(B, D, W), y2=f32(B, D, W), aff=aff.astype(np.float32),
                types=rng.integers(0, kinds, (B, W)).astype(np.uint8),
                rT=f32(B, D, W, scale=0.3), mc=(rng.random((B, C - 1, W)) > rate).astype(np.int8),
                feats=f32(B, F, W, scale=0.5), w_stk=f32(T * D, C, scale=0.4),
                nm=(rng.random((B, W)) < 0.8).astype(np.float32),
                ds_in=f32(B, D, W, scale=0.3), gsel=f32(B, D, W, scale=0.3), yk=f32(B, D, W),
                agg=f32(B, D, W), bnv=bnv.astype(np.float32))


def _tm3(types, T):
    """gnn_tpu's raw one-hot type masks [B, T, W]."""
    return jnp.asarray(np.swapaxes(np.eye(T, dtype=np.float32)[types], 1, 2))


def _close(got, want):
    """Sums over nodes: within KERNEL_TOL of the largest entry (plus ATOL)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL + KERNEL_TOL * np.abs(want).max())


@pytest.mark.parametrize("acts,rate,alpha,res,Bl", [
    (("selu", "tanh", "relu"), 0.15, True, True, 3), (("selu",), 0.0, True, False, 4),
    (("tanh", "linear"), 0.2, False, True, 2), (("relu", "selu", "selu", "tanh"), 0.1, True,
                                                 False, 1)])
def test_bnT_forward_step_ref_matches_pallas(acts, rate, alpha, res, Bl):
    T = len(acts)
    x = _inputs(1, T=T, rate=rate)
    thr = 0.05
    y_j, agg_j, marg_j, msum_j = pt._bnT_fwd_call(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["y1"]), jnp.asarray(x["y2"]),
        jnp.asarray(x["aff"])[..., None], _tm3(x["types"], T),
        jnp.asarray(x["mc"]) if rate else None, jnp.asarray(x["rT"]) if res else None,
        jnp.asarray(x["feats"]), jnp.asarray(x["w_stk"]), jnp.asarray(x["nm"])[:, None, :],
        acts=acts, T=T, alpha_drop=alpha, rate=rate, group=2, thr=thr, interpret=True)
    ttyped.reset_launches()
    adj_loop, adj_dep = _split(x["adjT"], Bl)
    y, agg, marg, msum = ttyped.bnT_forward_step(
        adj_loop, adj_dep, _t(x["y1"]), _t(x["y2"]),
        torch.from_numpy(x["aff"]).reshape(2, 2, T, -1), torch.from_numpy(x["types"]),
        _t(x["mc"]).to(torch.uint8) if rate else None, _t(x["rT"]) if res else None,
        _t(x["feats"]), torch.from_numpy(x["w_stk"]), torch.from_numpy(x["nm"]),
        activations=acts, alpha_drop=alpha, rate=rate, threshold=thr)
    assert not any(ttyped.launches.values())   # plain on the CPU
    np.testing.assert_allclose(_fm(y), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(_fm(agg), np.asarray(agg_j), atol=ATOL)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(marg_j)[:, 0])
    _close(msum.sum(0), np.asarray(msum_j).sum(0))


@pytest.mark.parametrize("acts,rate,alpha,flag,Bl", [
    (("selu", "tanh", "relu"), 0.15, True, 1.0, 3), (("selu",), 0.0, True, 0.0, 4),
    (("tanh", "linear"), 0.2, False, 1.0, 1), (("relu", "selu", "selu", "tanh"), 0.1, True,
                                                0.0, 2)])
def test_bnT_backward_step_ref_matches_pallas(acts, rate, alpha, flag, Bl):
    T = len(acts)
    x = _inputs(2, T=T, rate=rate)
    bnv16 = np.concatenate([x["bnv"], np.zeros((T, 7, x["bnv"].shape[-1]), np.float32)], 1)
    ds_j, dw_j, dagg_j, red_j = pt._bnT_bwd_call(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["y1"]), jnp.asarray(x["yk"]),
        jnp.asarray(x["agg"]), _tm3(x["types"], T), jnp.asarray(x["mc"]) if rate else None,
        jnp.asarray(x["feats"]), jnp.asarray(x["w_stk"]), jnp.asarray(x["ds_in"]),
        jnp.asarray(x["gsel"]), jnp.asarray(bnv16)[..., None], jnp.full((1, 1), flag, jnp.float32),
        jnp.asarray(x["nm"])[:, None, :], acts=acts, T=T, alpha_drop=alpha, rate=rate, group=2,
        interpret=True)
    adj_loop, adj_dep = _split(x["adjT"], Bl)
    ds, dw, dagg, red = ttyped.bnT_backward_step(
        adj_loop, adj_dep, _t(x["y1"]), _t(x["yk"]), _t(x["agg"]), torch.from_numpy(x["types"]),
        _t(x["mc"]).to(torch.uint8) if rate else None, _t(x["feats"]),
        torch.from_numpy(x["w_stk"]), _t(x["ds_in"]), _t(x["gsel"]), torch.from_numpy(x["bnv"]),
        torch.tensor(flag), torch.from_numpy(x["nm"]), activations=acts, alpha_drop=alpha,
        rate=rate)
    np.testing.assert_allclose(_fm(ds), np.asarray(ds_j), atol=ATOL)
    np.testing.assert_allclose(_fm(dagg), np.asarray(dagg_j), atol=ATOL)
    _close(dw.sum(0), dw_j)
    _close(red.sum(0), red_j)


def test_typed_kernel_shapes_checked():
    """K16/K17 stage the stacked weights in shared memory when they fit, read
    them through the caches when they do not, and take shapes whose leanest
    staged plan exceeds a CTA's 227 KB and more than MAX_TYPES types through
    their wide plans (ops/typed.py::_bnT_fwd_plan, _bnT_bwd_plan); node types
    other than int32 are refused."""
    need, plan = ttyped._bnT_fwd_plan(128, 14, 3, 4)
    assert ttyped._BNT_FWD_PLANS[plan][3] == 1 and (need, plan) == (
        4 * (128 * 31 + 4 * 32 * 16 + 4 * 4 * 14 + 3 * 128 + 8 + 128 * 15 + 128 * 31 // 4
             + 16 * 128) + 128 + 16 * 128 + 8 * 128, 0)
    need, plan = ttyped._bnT_fwd_plan(96, 64, 3, 8)
    assert ttyped._BNT_FWD_PLANS[plan][3] == 0 and need <= SMEM_BYTES
    types = torch.zeros((2, 128), dtype=torch.int32)
    adj = torch.zeros((2, 128, 128))
    assert ttyped._check_typed(adj, None, 2, 64, 64, types, torch.zeros((32 * 64, 193)),
                               ("selu",) * 32) == (2, 128, 32)
    assert ttyped._bnT_bwd_plan(128, 64, 64, 32)[1] == 3
    assert ttyped._check_typed(adj, None, 2, 14, 3, types, torch.zeros((33 * 14, 32)),
                               ("selu",) * 33) == (2, 128, 33)
    assert ttyped._bnT_fwd_plan(128, 14, 3, 33)[1] == ttyped._bnT_bwd_plan(128, 14, 3, 33)[1] == 3
    with pytest.raises(ValueError, match="int32"):
        ttyped._check_typed(adj, None, 2, 14, 3, types.to(torch.uint8),
                            torch.zeros((4 * 14, 32)), ("selu",) * 4)
    Bl, W, T = ttyped._check_typed(adj, None, 2, 14, 3, types, torch.zeros((4 * 14, 32)),
                                   ("selu",) * 4)
    assert (Bl, W, T) == (2, 128, 4)


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("T,focus,bn", [(3, "g", True), (2, "n", True), (2, "g", False),
                                        (1, "a", True)])
def test_typed_eval_route_matches_gnn_tpu(monkeypatch, T, focus, bn):
    """The typed eval route (plain K16 once an iteration, the inference
    affine per type; the identity without BatchNorm) against gnn_tpu's
    typed_eval_propagate (interpret) and its XLA body."""
    jgs, tgs = typed_graphs(11, T, focus=focus)
    js, ts = composite_specs(T, focus=focus, bn=bn)
    (jp, jbn), (tp, tbn_) = composite_weights(js)
    jb, tb = batches(jgs, tgs, focus)
    assert tcomp._route(ts, tb, False) == "typed_eval"
    ttyped.reset_launches()
    got = tcomp.composite_forward(ts, tp, tbn_, tb)
    assert not any(ttyped.launches.values())
    kern = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(0))
    monkeypatch.setenv("GNN_TPU_FUSED_BN", "0")
    body = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(0))
    assert float(got["iters"]) == float(kern["iters"]) == float(body["iters"])
    for key in ("state", "out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(body[key]), atol=ATOL)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(kern[key]), atol=KERNEL_TOL)


@pytest.mark.parametrize("T,threshold,absent,rate", [(3, 0.01, None, 0.1), (3, 0.4, 1, 0.1),
                                                     (2, 0.01, None, 0.0), (1, 1e9, None, 0.1)])
def test_typed_bn_training_step_matches_gnn_tpu(monkeypatch, T, threshold, absent, rate):
    """One training step through the typed BN route against gnn_tpu's XLA
    body with JAX's per-type masks (an absent type's moments are 0 and its
    moving statistics still move while the loop runs), and the forward's
    states and per-type moving statistics against gnn_tpu's
    bn_typed_train_propagate in interpret mode."""
    jgs, tgs = typed_graphs(12, T, absent=absent)
    js, ts = composite_specs(T, threshold=threshold, rate=rate)
    (jp, jbn), (tp, tbn_) = composite_weights(js)
    jb, tb = batches(jgs, tgs)
    rng = jax.random.key(5)
    kern = jcomp.composite_forward(js, jp, jbn, jb, rng, training=True)
    masks = jax_masks(js, tb.n_node_pad, tb.n_node_pad, rng)
    with torch.no_grad():
        got = tcomp.composite_forward(ts, tp, tbn_, tb, training=True, masks=masks)
    assert float(got["iters"]) == float(kern["iters"])
    if threshold == 1e9:
        assert float(got["iters"]) == 0.0
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(kern["state"]),
                               atol=KERNEL_TOL)
    for t, (a, b) in enumerate(zip(got["bn"]["state"], kern["bn"]["state"])):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), atol=1e-5,
                                       err_msg=f"moving {k} of type {t}")
    if absent is not None:      # the absent type's statistics moved toward (0, 0)
        assert float(got["bn"]["state"][absent]["var"].max()) < float(
            tbn_["state"][absent]["var"].min())
    monkeypatch.setenv("GNN_TPU_FUSED_BN", "0")
    ttyped.reset_launches()
    check_step_against_gnn_tpu(js, jp, jbn, jb, ts, tb, rng, expect_route="typed_bn")
    assert not any(ttyped.launches.values())


# ------------------------------------------------------------------ T = 1
def _one_type_pair(rate=0.1):
    """A one-type composite model and the homogeneous model with the same
    weights, on one batch."""
    _, tgs = typed_graphs(13, 1)
    _, ts = composite_specs(1, rate=rate)
    comp = CompositeGNNgraphBased(ts.state_specs, ts.output_spec, max_iteration=4, seed=3,
                                  device="cpu")
    comp.bn["state"][0].update(mean=torch.full((5,), 0.1), var=torch.full((5,), 0.7))
    homo = GNNgraphBased(ts.state_specs[0], ts.output_spec, max_iteration=4, seed=0, device="cpu")
    homo.params = {"state": {k: {n: v.detach().clone().requires_grad_() for n, v in d.items()}
                             for k, d in comp.params["state"][0].items()},
                   "output": {k: {n: v.detach().clone().requires_grad_() for n, v in d.items()}
                              for k, d in comp.params["output"].items()}}
    homo.bn = {"state": dict(comp.bn["state"][0]), "output": {}}
    homo._install(homo.params, homo.bn)
    return comp, homo, comp.to_batch(tgs, block_w=32)


def test_one_type_serves_as_the_homogeneous_model():
    """gnn_tpu's test_shared_weights_equal_homogeneous on the kernel routes:
    K16 with one type against K3/K4."""
    comp, homo, tb = _one_type_pair()
    assert tcomp._route(comp.spec, tb, False) == "typed_eval"
    assert tcore._eval_route(homo.spec, tb) == "hybrid"
    a, b = comp.forward(tb), homo.forward(tb)
    assert float(a["iters"]) == float(b["iters"])
    np.testing.assert_allclose(a["state"].numpy(), b["state"].numpy(), atol=1e-6)
    np.testing.assert_allclose(a["out"].numpy(), b["out"].numpy(), atol=1e-6)


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_one_type_trains_as_the_homogeneous_model(rate):
    """The K-loop with per-type moments at one type (K16/K17) gives the K1/K2
    route's numbers on the same batch and masks: iterations, loss, moving
    statistics, grads and params after a step."""
    comp, homo, tb = _one_type_pair(rate)
    assert tcomp._route(comp.spec, tb, True) == "typed_bn"
    assert tcore._train_route(homo.spec, tb) == "bn"
    masks = tcore.draw_masks(homo.spec, tb, torch.Generator().manual_seed(4))
    out_c = comp.training_step(tb, masks={"state": (masks["state"],),
                                          "output": masks["output"]})
    out_h = homo.training_step(tb, masks=masks)
    assert float(out_c["iters"]) == float(out_h["iters"])
    np.testing.assert_allclose(float(out_c["loss"]), float(out_h["loss"]), rtol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(comp.bn["state"][0][k].numpy(), homo.bn["state"][k].numpy(),
                                   atol=1e-6)
    for net in ("state", "output"):
        tree = comp.params[net][0] if net == "state" else comp.params[net]
        for name, leaves in tree.items():
            for k, p in leaves.items():
                q = homo.params[net][name][k]
                np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=2e-4, atol=1e-7,
                                           err_msg=f"grad {net}/{name}/{k}")
                np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-6)


def test_typed_loop_at_one_type_equals_the_k1_loop():
    """ops/bn.py's K-loop with TypedLoopOperands at T = 1 against the same
    loop with BNLoopOperands (K1/K2) on one batch: the returned state, the
    moments and the gradients of a functional of the state."""
    comp, homo, tb = _one_type_pair()
    masks = tcore.draw_masks(homo.spec, tb, torch.Generator().manual_seed(6))
    weight = torch.randn(tb.nodes.shape, generator=torch.Generator().manual_seed(7))
    runs = []
    for typed in (True, False):
        p = {k: {n: v.detach().clone().requires_grad_() for n, v in d.items()}
             for k, d in homo.params["state"].items()}
        if typed:
            s0, w_stk, op = ttyped.typed_operands(comp.spec, (p,), tb, True, (masks["state"][0],))
            weights = (w_stk,)
        else:
            s0, weights, op = tbn.bn_loop_operands(homo.spec, p, tb, masks["state"][0])
        iters, state3, moms = tbn.bn_train_loop(s0, weights, p["bn"]["gamma"], p["bn"]["beta"],
                                                op)
        torch.sum(torch.tanh(state3) * weight.reshape(state3.shape)).backward()
        runs.append((iters, state3.detach(), moms.reshape(moms.shape[0], 2, -1),
                     [t.grad for d in p.values() for t in d.values()]))
    (i_t, s_t, m_t, g_t), (i_h, s_h, m_h, g_h) = runs
    assert float(i_t) == float(i_h)
    np.testing.assert_allclose(s_t.numpy(), s_h.numpy(), atol=1e-6)
    np.testing.assert_allclose(m_t.numpy(), m_h.numpy(), atol=1e-6)
    for a, b in zip(g_t, g_h):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_typed_routes_dispatch_as_gnn_tpu():
    """K16/K17 take one-layer per-type nets with the trailing BatchNorm and
    input dropout shared by the types; BN-free specs train on the plain
    body and serve through K16; two-layer nets, 'segment' aggregation and
    'ift' stay on the plain body."""
    _, tgs = typed_graphs(14, 2)
    _, ts = composite_specs(2)
    gb = CompositeGNNgraphBased(ts.state_specs, ts.output_spec, seed=0,
                                device="cpu").to_batch(tgs, block_w=32)
    assert (tcomp._route(ts, gb, True), tcomp._route(ts, gb, False)) == ("typed_bn", "typed_eval")
    free = dataclasses.replace(ts, state_specs=tuple(
        dataclasses.replace(s, batch_normalization=False) for s in ts.state_specs))
    assert (tcomp._route(free, gb, True), tcomp._route(free, gb, False)) == ("plain", "typed_eval")
    mixed = dataclasses.replace(ts, state_specs=(
        ts.state_specs[0], dataclasses.replace(ts.state_specs[1], dropout_rate=(0.2,))))
    assert tcomp._route(mixed, gb, True) == "plain"
    two = dataclasses.replace(ts, state_specs=tuple(
        dataclasses.replace(s, units=(7, 5), activations=("selu", "selu"),
                            kernel_initializer=("lecun_normal",) * 2,
                            bias_initializer=("lecun_normal",) * 2) for s in ts.state_specs))
    assert (tcomp._route(two, gb, True), tcomp._route(two, gb, False)) == ("plain", "plain")
    assert tcomp._route(dataclasses.replace(ts, aggregation="segment"), gb, False) == "plain"
    nodrop = dataclasses.replace(ts, state_specs=tuple(
        dataclasses.replace(s, dropout_rate=(), dropout_pos=()) for s in ts.state_specs))
    assert tcomp._route(dataclasses.replace(nodrop, grad_mode="ift"), gb, True) == "plain"
    # a block-dense batch without the loop/dep layout routes the typed kernels,
    # as gnn_tpu (composite.py:170); a batch without blocks the plain body
    flat = tbatch.from_graphs_blocked(tgs, block_w=32)
    assert (tcomp._route(ts, flat, True), tcomp._route(ts, flat, False)) == ("typed_bn",
                                                                             "typed_eval")
    assert tcomp._route(ts, tbatch.GraphBatch.from_graph(TGraph.merge(tgs)), False) == "plain"
