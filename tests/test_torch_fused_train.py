"""Plain versions of the dropout-training kernels K6/K7/K8
(gnn_tpu_torch/ops/fused.py) and their autograd Functions against gnn_tpu's
Pallas kernels and custom VJPs, which run in interpret mode on the CPU.

Tolerances: per-node outputs and cotangents atol 3e-5, gnn_tpu's bound for its
kernels' bf16 hi/lo f32 emulation (tests/test_fused.py); the dense weight's
cotangent, a sum over every node, within rtol 2e-4 (the exactness contract's
grad tolerance) and that atol; movement flags equal. The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these plain
versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import pallas_fused as pf
from gnn_tpu_torch.ops import fused as tf

torch.set_num_threads(1)
ATOL = 3e-5
RTOL = 2e-4
K = 3
DROPS = [(True, 0.2), (False, 0.15)]
ACTS = ["selu", "tanh", "relu", "linear"]


def _inputs(seed, B=4, W=32, D=5, H=None):
    """Feature-major (gnn_tpu) operands: an 'average' block adjacency (~10%
    arcs), per-iteration keep bits and feature terms, and weights that keep
    the states O(1), the range where gnn_tpu's hi/lo emulation is within
    3e-5 of f32."""
    H = H or D
    rng = np.random.default_rng(seed)
    arcs = rng.random((B, W, W)) < 0.1

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return dict(adjT=(arcs / np.maximum(arcs.sum(axis=1, keepdims=True), 1)).astype(np.float32),
                s0=rng.uniform(-1, 1, (B, D, W)).astype(np.float32),
                ms=(rng.random((K, B, D, W)) > 0.2).astype(np.int8),
                ma=(rng.random((K, B, D, W)) > 0.2).astype(np.int8),
                fT=f32(K, B, H, W, scale=0.3), w_cat=f32(H, 2 * D, scale=0.2),
                nm=(rng.random((B, W)) < 0.8).astype(np.float32),
                g=f32(K, B, H, W, scale=0.1), r=f32(B, D, W, scale=0.3))


def _nm(x):
    """Feature-major [..., F, W] (numpy or jax) -> the port's node-major [..., W, F]."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(x), -1, -2)))


def _fm(t):
    return np.swapaxes(t.detach().numpy(), -1, -2)


def _keep(m):
    return _nm(m).to(torch.uint8)


def _pack(x):
    return pf.pack_adjacency(jnp.asarray(x["adjT"]))


@pytest.mark.parametrize("alpha,rate", DROPS)
@pytest.mark.parametrize("act", ACTS)
def test_train_loop_ref_matches_pallas(act, alpha, rate):
    """K7: trajectory, movement flags and pre-dropout aggregations."""
    x = _inputs(1)
    thr = 0.05
    traj_j, marg_j, agg_j = pf._loop_train_impl(
        _pack(x), jnp.asarray(x["s0"]), jnp.asarray(x["ms"]), jnp.asarray(x["ma"]),
        jnp.asarray(x["fT"]), jnp.asarray(x["w_cat"]), jnp.asarray(x["nm"]), K=K,
        threshold=thr, activation=act, alpha_drop=alpha, rate=rate, group=2, interpret=None)
    tf.reset_launches()
    traj, marg, agg = tf.train_loop(
        torch.from_numpy(x["adjT"]), _nm(x["s0"]), _keep(x["ms"]), _keep(x["ma"]), _nm(x["fT"]),
        torch.from_numpy(x["w_cat"]), torch.from_numpy(x["nm"]), K, thr, act, alpha, rate)
    assert not any(tf.launches.values())                     # the plain version on the CPU
    assert traj.shape == (K, 4, 32, 5) and agg.shape == (K, 4, 32, 5)
    np.testing.assert_allclose(_fm(traj), np.asarray(traj_j), atol=ATOL)
    np.testing.assert_allclose(_fm(agg), np.asarray(agg_j), atol=ATOL)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(marg_j))
    assert 0 < marg.sum() < marg.numel()


@pytest.mark.parametrize("alpha,rate", DROPS)
@pytest.mark.parametrize("act", ACTS)
def test_train_loop_bwd_ref_matches_pallas(act, alpha, rate):
    """K8 on the Pallas forward's trajectory and aggregations: the state
    cotangent, the per-iteration fT cotangents and the block-summed dw."""
    x = _inputs(2)
    args = [jnp.asarray(x[k]) for k in ("s0", "ms", "ma", "fT", "w_cat", "nm")]
    traj_j, _, agg_j = pf._loop_train_impl(
        _pack(x), *args, K=K, threshold=0.05, activation=act, alpha_drop=alpha, rate=rate,
        group=2, interpret=None)
    gs_j, dw_j, dfT_j = pf._loop_train_bwd_impl(
        _pack(x), args[0], traj_j, agg_j, args[1], args[2], args[3], args[4],
        jnp.asarray(x["g"]), K=K, activation=act, alpha_drop=alpha, rate=rate, group=2,
        interpret=None)
    gs, dw, dfT = tf.train_loop_bwd(
        torch.from_numpy(x["adjT"]), _nm(x["s0"]), _nm(traj_j), _nm(agg_j), _keep(x["ms"]),
        _keep(x["ma"]), _nm(x["fT"]), torch.from_numpy(x["w_cat"]), _nm(x["g"]), act, alpha,
        rate)
    assert dw.shape == (4, 5, 10)                            # per-block partials
    np.testing.assert_allclose(_fm(gs), np.asarray(gs_j), atol=ATOL)
    np.testing.assert_allclose(_fm(dfT), np.asarray(dfT_j), atol=ATOL)
    np.testing.assert_allclose(dw.sum(0).numpy(), np.asarray(dw_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("alpha,rate", DROPS + [(True, 0.0)])
def test_train_loop_grads_match_jax_vjp(alpha, rate):
    """The K7/K8 autograd Function against jax.vjp of fused_train_loop."""
    x = _inputs(3)
    act, thr = "selu", 0.05
    adj, ms, ma, nm = _pack(x), jnp.asarray(x["ms"]), jnp.asarray(x["ma"]), jnp.asarray(x["nm"])
    (traj_j, _), vjp = jax.vjp(
        lambda s0, fT, w: pf.fused_train_loop(adj, s0, ms, ma, fT, w, nm, K, thr, act, alpha,
                                              rate, 2),
        jnp.asarray(x["s0"]), jnp.asarray(x["fT"]), jnp.asarray(x["w_cat"]))
    g_s0, g_fT, g_w = vjp((jnp.asarray(x["g"]), jnp.zeros((K, 4, 32))))
    s0, fT = _nm(x["s0"]).requires_grad_(), _nm(x["fT"]).requires_grad_()
    w = torch.from_numpy(x["w_cat"]).requires_grad_()
    traj, marg = tf.fused_train_loop(
        torch.from_numpy(x["adjT"]), s0, _keep(x["ms"]) if rate else None,
        _keep(x["ma"]) if rate else None, fT, w, torch.from_numpy(x["nm"]), K, thr, act, alpha,
        rate)
    assert not marg.requires_grad
    np.testing.assert_allclose(_fm(traj), np.asarray(traj_j), atol=ATOL)
    torch.sum(traj * _nm(x["g"])).backward()
    np.testing.assert_allclose(_fm(s0.grad), np.asarray(g_s0), atol=ATOL)
    np.testing.assert_allclose(_fm(fT.grad), np.asarray(g_fT), atol=ATOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("res,D,H,act,alpha,rate", [
    (True, 5, 5, "selu", True, 0.2), (False, 5, 5, "tanh", False, 0.15),
    (True, 5, 7, "relu", True, 0.1), (False, 6, 6, "linear", True, 0.0)])
def test_train_step_matches_pallas_and_vjp(res, D, H, act, alpha, rate):
    """K6's plain version against the Pallas kernel, and its autograd
    Function's plain backward against jax.vjp of fused_train_step
    (_train_bwd_rule), with and without the raw residual aggregation."""
    x = _inputs(4, D=D, H=H)
    s, m = x["s0"], x["ma"][0]
    sd = np.asarray(pf._make_drop(alpha, rate)[0](jnp.asarray(s), jnp.asarray(x["ms"][0])))
    adj, mj = _pack(x), jnp.asarray(m)
    jargs = [jnp.asarray(a) for a in (s, sd, x["r"], x["fT"][0], x["w_cat"])]

    def f(s_, sd_, r_, fT_, w_):
        return pf.fused_train_step(adj, s_, sd_, mj, r_ if res else None, fT_, w_, act, alpha,
                                   rate, 2)
    (y_j, agg_j), vjp = jax.vjp(f, *jargs)
    cot = vjp((jnp.asarray(x["g"][0]), jnp.zeros_like(agg_j)))
    y_ref, agg_ref = tf.train_step(
        torch.from_numpy(x["adjT"]), _nm(s), _nm(sd), _keep(m), _nm(x["r"]) if res else None,
        _nm(x["fT"][0]), torch.from_numpy(x["w_cat"]), act, alpha, rate)
    np.testing.assert_allclose(_fm(y_ref), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(_fm(agg_ref), np.asarray(agg_j), atol=ATOL)

    ts = [_nm(a).requires_grad_() for a in (s, sd, x["r"], x["fT"][0])]
    w = torch.from_numpy(x["w_cat"]).requires_grad_()
    y = tf.fused_train_step(torch.from_numpy(x["adjT"]), ts[0], ts[1],
                            _keep(m) if rate else None, ts[2] if res else None, ts[3], w, act,
                            alpha, rate)
    torch.sum(y * _nm(x["g"][0])).backward()
    for name, t, want in zip(("ds", "dsd", "drT", "dfT"), ts, cot[:4]):
        if name == "drT" and not res:
            assert t.grad is None
            continue
        np.testing.assert_allclose(_fm(t.grad), np.asarray(want), atol=ATOL, err_msg=name)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(cot[4]), rtol=RTOL, atol=ATOL)


def test_padded_rows_add_nothing():
    """Padded loop rows (node mask 0, an empty adjacency, the state of block
    0 gathered by a loop id of 0) whose states nothing reads add exactly 0 to
    dw and to their own state cotangent."""
    x = _inputs(5)
    x["adjT"][3] = 0.0
    x["nm"][3] = 0.0
    x["s0"][3] = x["s0"][0]
    x["g"][:, 3] = 0.0
    args = [torch.from_numpy(x["adjT"]), _nm(x["s0"]), _keep(x["ms"]), _keep(x["ma"])]
    traj, _, agg = tf.train_loop(*args, _nm(x["fT"]), torch.from_numpy(x["w_cat"]),
                                 torch.from_numpy(x["nm"]), K, 0.05, "selu", True, 0.2)
    gs, dw, dfT = tf.train_loop_bwd(args[0], args[1], traj, agg, args[2], args[3], _nm(x["fT"]),
                                    torch.from_numpy(x["w_cat"]), _nm(x["g"]), "selu", True, 0.2)
    assert torch.isfinite(traj[:, 3]).all()
    assert (dw[3] == 0).all() and (gs[3] == 0).all() and (dfT[:, 3] == 0).all()
    assert (dw[:3] != 0).any()


def test_train_kernel_widths_checked():
    x = _inputs(6, D=5, H=6)
    meta = {k: torch.from_numpy(np.asarray(v)).to("meta") for k, v in x.items()}
    with pytest.raises(ValueError, match="H == D"):
        tf.train_loop(meta["adjT"], meta["s0"], None, None, meta["fT"], meta["w_cat"],
                      meta["nm"], K, 0.01, "tanh")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tf.train_step(meta["adjT"], meta["r"], meta["r"], None, None, meta["fT"][0],
                      meta["w_cat"], "tanh")
