"""Plain versions of the eval propagation kernels K3/K4 (gnn_tpu_torch/ops/fused.py)
against gnn_tpu's Pallas kernels, which run in interpret mode on the CPU.

Tolerance: atol 3e-5, gnn_tpu's own bound for its kernels' bf16 hi/lo f32
emulation against true f32 (tests/test_fused.py). Movement flags must be
equal. The CUDA kernels themselves run only on the card (chip_smoke.py holds
them against these plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import pallas_fused as pf
from gnn_tpu_torch.ops import fused as tf

torch.set_num_threads(1)
ATOL = 3e-5


def _inputs(seed, B=3, W=32, D=5, H=5, affine=True):
    """Feature-major (gnn_tpu) inputs: an 'average'-mode block adjacency
    (~10% arcs, weight 1/in-degree), labels in [-1, 1] and weights that keep
    the states O(1), the range where gnn_tpu's hi/lo emulation is within
    3e-5 of f32 (its error is relative, about 8e-6 of a value)."""
    rng = np.random.default_rng(seed)
    arcs = rng.random((B, W, W)) < 0.1
    adjT = arcs / np.maximum(arcs.sum(axis=1, keepdims=True), 1)
    x = dict(
        adjT=adjT.astype(np.float32),
        s=rng.uniform(-1, 1, (B, D, W)).astype(np.float32),
        fT=(0.3 * rng.standard_normal((B, H, W))).astype(np.float32),
        rT=(0.3 * rng.standard_normal((B, H, W))).astype(np.float32),
        w2=(0.25 * rng.standard_normal((2 * H, D))).astype(np.float32),
        nm=(rng.random((B, W)) < 0.8).astype(np.float32),
        aff=(np.stack([rng.uniform(0.5, 1.0, H), 0.1 * rng.standard_normal(H)])
             .astype(np.float32) if affine else None),
    )
    return x


def _nm(x):
    """Feature-major [B, F, W] -> the port's node-major [B, W, F] tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _opt(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("act", ["selu", "tanh", "relu", "linear"])
def test_loop_ref_matches_pallas(act, affine):
    x = _inputs(1, affine=affine)
    K, thr = 4, 0.05
    tf.reset_launches()
    traj_j, marg_j = pf.fused_propagation_loop(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["s"]), jnp.asarray(x["fT"]),
        jnp.asarray(x["w2"]), None if x["aff"] is None else jnp.asarray(x["aff"]),
        jnp.asarray(x["nm"]), K, thr, act, 3)
    traj_t, marg_t = tf.propagation_loop(
        torch.from_numpy(x["adjT"]), _nm(x["s"]), _nm(x["fT"]), torch.from_numpy(x["w2"]),
        _opt(x["aff"]), torch.from_numpy(x["nm"]), K, thr, act)
    assert traj_t.shape == (K, 3, 32, 5) and marg_t.shape == (K, 3, 32)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j).transpose(0, 1, 3, 2),
                               atol=ATOL)
    np.testing.assert_array_equal(marg_t.numpy(), np.asarray(marg_j))
    assert not any(tf.launches.values())


@pytest.mark.parametrize("res,D,H", [(True, 5, 5), (False, 5, 5), (True, 6, 9)])
@pytest.mark.parametrize("act", ["selu", "tanh", "relu", "linear"])
def test_step_ref_matches_pallas(act, res, D, H):
    x = _inputs(2, D=D, H=H, affine=res)
    tf.reset_launches()
    out_j = pf.fused_propagation_step(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["s"]),
        jnp.asarray(x["rT"]) if res else None, jnp.asarray(x["fT"]), jnp.asarray(x["w2"]),
        None if x["aff"] is None else jnp.asarray(x["aff"]), activation=act, group=3)
    out_t = tf.propagation_step(
        torch.from_numpy(x["adjT"]), _nm(x["s"]), _nm(x["rT"]) if res else None,
        _nm(x["fT"]), torch.from_numpy(x["w2"]), _opt(x["aff"]), act)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j).transpose(0, 2, 1), atol=ATOL)
    assert not any(tf.launches.values())


def test_bn_inference_affine_matches():
    rng = np.random.default_rng(3)
    g, b, m = (rng.standard_normal(7).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.2, 2.0, 7).astype(np.float32)
    want = pf.bn_inference_affine(*(jnp.asarray(a) for a in (g, b, m, v)))
    got = tf.bn_inference_affine(*(torch.from_numpy(a) for a in (g, b, m, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_selu_matches_kernel_formula():
    """The kernels' selu is exp(min(x, 0)) - 1 (pallas_fused.py:61-63)."""
    x = np.linspace(-20, 5, 1001).astype(np.float32)
    want = pf._ACTS["selu"](jnp.asarray(x))
    got = tf._ACTS["selu"](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert tf.FUSABLE_ACTIVATIONS == pf.FUSABLE_ACTIVATIONS


def test_loop_kernel_width_rule():
    x = _inputs(4, D=5, H=6)
    with pytest.raises(ValueError, match="H == D"):
        t = torch.from_numpy
        tf.propagation_loop(t(x["adjT"]).to("meta"), _nm(x["s"]).to("meta"),
                            _nm(x["fT"]).to("meta"), t(x["w2"]).to("meta"), None,
                            t(x["nm"]).to("meta"), 2, 0.01, "tanh")


def _sum_close(got, want):
    """Block-summed partials: within rtol 2e-4 (the exactness contract's grad
    tolerance) and the per-node atol."""
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=ATOL)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("act", ["selu", "tanh", "relu", "linear"])
def test_loop_bwd_ref_matches_pallas(act, affine):
    """K5 on the Pallas forward's trajectory: the state and fT cotangents and
    the block-summed dw2 and daff."""
    x = _inputs(5, affine=affine)
    K, thr = 4, 0.05
    rng = np.random.default_rng(6)
    g = (0.1 * rng.standard_normal((K, 3, 5, 32))).astype(np.float32)
    adj = pf.pack_adjacency(jnp.asarray(x["adjT"]))
    aff = None if x["aff"] is None else jnp.asarray(x["aff"])
    traj_j, _ = pf.fused_propagation_loop(adj, jnp.asarray(x["s"]), jnp.asarray(x["fT"]),
                                          jnp.asarray(x["w2"]), aff, jnp.asarray(x["nm"]), K,
                                          thr, act, 3)
    gs_j, dw2_j, dfT_j, daff_j = pf._loop_bwd_impl(
        adj, jnp.asarray(x["s"]), traj_j, jnp.asarray(x["fT"]), jnp.asarray(x["w2"]), aff,
        jnp.asarray(g), K=K, activation=act, group=3, interpret=None)
    tf.reset_launches()
    gs, dw2, dfT, daff = tf.propagation_loop_bwd(
        torch.from_numpy(x["adjT"]), _nm(x["s"]), _nm4(traj_j), _nm(x["fT"]),
        torch.from_numpy(x["w2"]), _opt(x["aff"]), _nm4(g), act)
    assert not any(tf.launches.values())
    assert dw2.shape == (3, 10, 5)                           # per-block partials
    np.testing.assert_allclose(gs.numpy(), np.asarray(gs_j).transpose(0, 2, 1), atol=ATOL)
    np.testing.assert_allclose(dfT.numpy(), np.asarray(dfT_j).transpose(0, 2, 1), atol=ATOL)
    _sum_close(dw2.sum(0).numpy(), np.asarray(dw2_j))
    if affine:
        _sum_close(daff.sum(0).numpy(), np.asarray(daff_j)[..., 0])
    else:
        assert daff is None and daff_j is None


def _nm4(x):
    """Feature-major [K, B, F, W] -> node-major [K, B, W, F]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 1, 3, 2)))


@pytest.mark.parametrize("affine", [False, True])
def test_loop_grads_match_jax_vjp(affine):
    """The K3/K5 autograd Function against jax.vjp of fused_propagation_loop."""
    x = _inputs(7, affine=affine)
    K, thr, act = 4, 0.05, "selu"
    g = (0.1 * np.random.default_rng(8).standard_normal((K, 3, 5, 32))).astype(np.float32)
    adj, nm = pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["nm"])
    primals = [jnp.asarray(x[k]) for k in ("s", "fT", "w2")]
    if affine:
        primals.append(jnp.asarray(x["aff"]))
    (traj_j, _), vjp = jax.vjp(
        lambda s0, fT, w2, *aff: pf.fused_propagation_loop(adj, s0, fT, w2, *(aff or (None,)),
                                                           nm, K, thr, act, 3), *primals)
    want = vjp((jnp.asarray(g), jnp.zeros((K, 3, 32))))
    ts = [_nm(x["s"]).requires_grad_(), _nm(x["fT"]).requires_grad_(),
          torch.from_numpy(x["w2"]).requires_grad_()]
    aff_t = torch.from_numpy(x["aff"]).requires_grad_() if affine else None
    traj, marg = tf.fused_propagation_loop(torch.from_numpy(x["adjT"]), *ts, aff_t,
                                           torch.from_numpy(x["nm"]), K, thr, act)
    assert not marg.requires_grad
    torch.sum(traj * _nm4(g)).backward()
    np.testing.assert_allclose(ts[0].grad.numpy(), np.asarray(want[0]).transpose(0, 2, 1),
                               atol=ATOL)
    np.testing.assert_allclose(ts[1].grad.numpy(), np.asarray(want[1]).transpose(0, 2, 1),
                               atol=ATOL)
    _sum_close(ts[2].grad.numpy(), np.asarray(want[2]))
    if affine:
        _sum_close(aff_t.grad.numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("res,affine,act", [(True, True, "selu"), (False, False, "tanh"),
                                            (True, False, "relu")])
def test_step_grads_match_jax_vjp(res, affine, act):
    """K4's plain backward against jax.vjp of fused_propagation_step
    (_fused_bwd_rule)."""
    x = _inputs(9, affine=affine)
    g = (0.3 * np.random.default_rng(10).standard_normal((3, 5, 32))).astype(np.float32)
    adj = pf.pack_adjacency(jnp.asarray(x["adjT"]))
    names = ["s", "rT", "fT", "w2"] + (["aff"] if affine else [])
    primals = [jnp.asarray(x[k]) for k in names]

    def f(s, rT, fT, w2, *aff):
        return pf.fused_propagation_step(adj, s, rT if res else None, fT, w2,
                                         *(aff or (None,)), activation=act, group=3)
    _, vjp = jax.vjp(f, *primals)
    want = dict(zip(names, vjp(jnp.asarray(g))))
    ts = {k: (_nm(x[k]) if k in ("s", "rT", "fT") else torch.from_numpy(x[k])).requires_grad_()
          for k in names}
    out = tf.fused_propagation_step(torch.from_numpy(x["adjT"]), ts["s"],
                                    ts["rT"] if res else None, ts["fT"], ts["w2"],
                                    ts.get("aff"), act)
    torch.sum(out * _nm(g)).backward()
    for k in ("s", "rT", "fT"):
        if k == "rT" and not res:
            assert ts[k].grad is None
            continue
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(want[k]).transpose(0, 2, 1),
                                   atol=ATOL, err_msg=k)
    for k in ("w2", "aff")[:len(names) - 3]:
        _sum_close(ts[k].grad.numpy(), np.asarray(want[k]))
