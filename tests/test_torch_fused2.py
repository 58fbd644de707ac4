"""Plain versions of the two-layer kernels K9/K10/K11/K12/K13
(gnn_tpu_torch/ops/fused2.py) and their autograd Functions against gnn_tpu's
Pallas kernels and custom VJPs, which run in interpret mode on the CPU.

The port's kernels take the whole first dense layer w0 = [Ws | Wa | Wf] and
the raw arc-label aggregation, and the residual raw; gnn_tpu's eval kernels
take w20 = [Ws; Wa], the hoisted term fT0 = Wf @ feats + b0 and the residual
through Wa. The tests build gnn_tpu's operands from the port's (in highest
precision): the same linear maps.

Tolerances are gnn_tpu's own for these kernels against its f32 body
(tests/test_fused.py): states 3e-5 for K9/K10 and 1e-4 for K12, cotangents
rtol 2e-4 with atol 2e-5; movement flags equal. The CUDA kernels themselves
run only on the card (chip_smoke.py holds them against these plain versions
there). The shape-coverage tests hold the register-tiled K10, K11, K12, K13
and K15's shared-memory plans (ops/fused2.py::_tile2_plan) to the layouts of the
per-node kernels they replaced: every shape those fitted in a CTA is still
taken."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import pallas_fused as pf
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused2 as tf2

torch.set_num_threads(1)
ATOL_EVAL = 3e-5
ATOL_TRAIN = 1e-4
RTOL, ATOL_GRAD = 2e-4, 2e-5
K = 3
AL = 3
DROPS = [(True, 0.2), (False, 0.15)]


def _inputs(seed, B=4, W=32, D=5, H1=16):
    """Feature-major (gnn_tpu) operands: an 'average' block adjacency (~10%
    arcs), keep bits, arc-label aggregations and weights that keep the states
    O(1), the range where gnn_tpu's hi/lo emulation is within its bounds."""
    rng = np.random.default_rng(seed)
    arcs = rng.random((B, W, W)) < 0.1
    C = 2 * D + AL

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return dict(adjT=(arcs / np.maximum(arcs.sum(axis=1, keepdims=True), 1)).astype(np.float32),
                s0=rng.uniform(-1, 1, (B, D, W)).astype(np.float32),
                ms=(rng.random((K, B, D, W)) > 0.2).astype(np.int8),
                ma=(rng.random((K, B, D, W)) > 0.2).astype(np.int8),
                feats=f32(B, AL, W, scale=0.5), fd=f32(K, B, AL, W, scale=0.5),
                w0=f32(H1, C, scale=0.8 / np.sqrt(C)), b0=f32(H1, scale=0.2),
                w1=f32(D, H1, scale=1.0 / np.sqrt(H1)), b1=f32(D, scale=0.1),
                aff=np.stack([rng.uniform(0.5, 1.5, D), 0.1 * rng.standard_normal(D)])
                .astype(np.float32),
                nm=(rng.random((B, W)) < 0.8).astype(np.float32),
                r=f32(B, D, W, scale=0.3), g=f32(K, B, D, W, scale=0.1))


def _nm(x):
    """Feature-major [..., F, W] (numpy or jax) -> the port's node-major [..., W, F]."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(x), -1, -2)))


def _fm(t):
    return np.swapaxes(t.detach().numpy(), -1, -2)


def _keep(m):
    return _nm(m).to(torch.uint8)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pack(x):
    return pf.pack_adjacency(jnp.asarray(x["adjT"]))


def _hp(spec, *args):
    return jnp.einsum(spec, *args, precision=jax.lax.Precision.HIGHEST)


def _eval_operands(w0, b0, feats, r, D):
    """gnn_tpu's K9/K10 operands from the port's: w20 = [Ws; Wa], fT0 =
    Wf @ feats + b0 [B, H1, W], rT = Wa @ r [B, H1, W] (r None: None)."""
    w20 = jnp.concatenate([w0[:, :D], w0[:, D:2 * D]], axis=0)
    fT0 = _hp("hf,bfw->bhw", w0[:, 2 * D:], feats) + b0[None, :, None]
    rT = None if r is None else _hp("hd,bdw->bhw", w0[:, D:2 * D], r)
    return w20, fT0, rT


def _weights(x):
    return [_t(x[k]) for k in ("w0", "b0", "w1", "b1")]


@pytest.mark.parametrize("res,affine,acts,H1", [
    (True, True, ("selu", "tanh"), 16), (True, False, ("tanh", "selu"), 16),
    (False, True, ("relu", "linear"), 16), (False, False, ("selu", "selu"), 16),
    (True, True, ("selu", "selu"), 150)])
def test_step2_ref_matches_pallas(res, affine, acts, H1):
    """K9 with and without the residual and the inference-BN affine."""
    x = _inputs(1, B=4 if H1 < 100 else 2, H1=H1)
    D = x["s0"].shape[1]
    j = {k: jnp.asarray(v) for k, v in x.items()}
    w20, fT0, rT = _eval_operands(j["w0"], j["b0"], j["feats"], j["r"] if res else None, D)
    aff = j["aff"] if affine else jnp.stack([jnp.ones(D), jnp.zeros(D)])
    want = pf._step2_impl(_pack(x), j["s0"], rT, fT0, w20, j["w1"], j["b1"], aff, act0=acts[0],
                          act1=acts[1], group=2, interpret=None)
    tf2.reset_launches()
    got = tf2.propagation_step2(_t(x["adjT"]), _nm(x["s0"]), _nm(x["r"]) if res else None,
                                _nm(x["feats"]), *_weights(x), _t(x["aff"]) if affine else None,
                                *acts)
    assert not any(tf2.launches.values())                     # the plain version on the CPU
    np.testing.assert_allclose(_fm(got), np.asarray(want), atol=ATOL_EVAL)


@pytest.mark.parametrize("acts,H1,thr", [(("selu", "tanh"), 16, 0.05),
                                         (("tanh", "relu"), 16, 0.2),
                                         (("selu", "selu"), 150, 0.05)])
def test_loop2_ref_matches_pallas(acts, H1, thr):
    """K10: trajectory and movement flags."""
    x = _inputs(2, B=4 if H1 < 100 else 2, H1=H1)
    D = x["s0"].shape[1]
    j = {k: jnp.asarray(v) for k, v in x.items()}
    w20, fT0, _ = _eval_operands(j["w0"], j["b0"], j["feats"], None, D)
    traj_j, marg_j = pf._loop2_impl(_pack(x), j["s0"], fT0, w20, j["w1"], j["b1"], j["aff"],
                                    j["nm"], K=K, threshold=thr, act0=acts[0], act1=acts[1],
                                    group=2, interpret=None)
    traj, marg = tf2.propagation_loop2(_t(x["adjT"]), _nm(x["s0"]), _nm(x["feats"]), *_weights(x),
                                       _t(x["aff"]), _t(x["nm"]), K, thr, *acts)
    assert traj.shape == (K,) + tuple(_nm(x["s0"]).shape)
    np.testing.assert_allclose(_fm(traj), np.asarray(traj_j), atol=ATOL_EVAL)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(marg_j))
    assert 0 < marg.sum() < marg.numel()


def _train_args(x):
    return [jnp.asarray(x[k]) for k in ("s0", "ms", "ma", "fd", "w0", "b0", "w1", "b1", "nm")]


def _train_loop_j(x, acts, alpha, rate, thr=0.05):
    return pf._loop2_train_impl(_pack(x), *_train_args(x), K=K, threshold=thr, act0=acts[0],
                                act1=acts[1], alpha_drop=alpha, rate=rate, group=2,
                                interpret=None)


@pytest.mark.parametrize("alpha,rate,acts,H1", [(True, 0.2, ("selu", "selu"), 16),
                                                (False, 0.15, ("tanh", "relu"), 16),
                                                (True, 0.1, ("selu", "selu"), 150)])
def test_train_loop2_ref_matches_pallas(alpha, rate, acts, H1):
    """K12: trajectory, movement flags and pre-dropout aggregations."""
    x = _inputs(3, B=4 if H1 < 100 else 2, H1=H1)
    traj_j, marg_j, agg_j = _train_loop_j(x, acts, alpha, rate)
    traj, marg, agg = tf2.train_loop2(
        _t(x["adjT"]), _nm(x["s0"]), _keep(x["ms"]), _keep(x["ma"]), _nm(x["fd"]), *_weights(x),
        _t(x["nm"]), K, 0.05, *acts, alpha, rate)
    np.testing.assert_allclose(_fm(traj), np.asarray(traj_j), atol=ATOL_TRAIN)
    np.testing.assert_allclose(_fm(agg), np.asarray(agg_j), atol=ATOL_TRAIN)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(marg_j))


@pytest.mark.parametrize("alpha,rate,acts,H1", [(True, 0.2, ("selu", "tanh"), 16),
                                                (False, 0.15, ("relu", "selu"), 16),
                                                (True, 0.1, ("selu", "selu"), 150)])
def test_train_loop2_bwd_ref_matches_pallas(alpha, rate, acts, H1):
    """K13 on the Pallas forward's trajectory and aggregations: the state and
    fd cotangents and the block-summed weight cotangents."""
    x = _inputs(4, B=4 if H1 < 100 else 2, H1=H1)
    traj_j, _, agg_j = _train_loop_j(x, acts, alpha, rate)
    a = _train_args(x)
    want = pf._loop2_train_bwd_impl(_pack(x), a[0], traj_j, agg_j, *a[1:8], jnp.asarray(x["g"]),
                                    K=K, act0=acts[0], act1=acts[1], alpha_drop=alpha, rate=rate,
                                    group=2, interpret=None)
    gs, dw0, db0, dw1, db1, dfd = tf2.train_loop2_bwd(
        _t(x["adjT"]), _nm(x["s0"]), _nm(traj_j), _nm(agg_j), _keep(x["ms"]), _keep(x["ma"]),
        _nm(x["fd"]), *_weights(x), _nm(x["g"]), *acts, alpha, rate)
    B = x["s0"].shape[0]
    assert dw0.shape == (B, H1, 13) and dw1.shape == (B, 5, H1)   # per-block partials
    np.testing.assert_allclose(_fm(gs), np.asarray(want[0]), rtol=RTOL, atol=ATOL_GRAD)
    for name, got, w in (("dw0", dw0, want[1]), ("db0", db0, want[2]), ("dw1", dw1, want[3]),
                         ("db1", db1, want[4])):
        np.testing.assert_allclose(got.sum(0).numpy(), np.asarray(w), rtol=RTOL, atol=ATOL_GRAD,
                                   err_msg=name)
    np.testing.assert_allclose(_fm(dfd), np.asarray(want[5]), rtol=RTOL, atol=ATOL_GRAD)


@pytest.mark.parametrize("alpha,rate", DROPS + [(True, 0.0)])
def test_train_loop2_grads_match_jax_vjp(alpha, rate):
    """The K12/K13 autograd Function against jax.vjp of fused_train_loop2,
    the cotangent of fd included."""
    x = _inputs(5)
    acts, thr = ("selu", "tanh"), 0.05
    adj, nm = _pack(x), jnp.asarray(x["nm"])
    ms, ma = jnp.asarray(x["ms"]), jnp.asarray(x["ma"])
    names = ("s0", "fd", "w0", "b0", "w1", "b1")
    (traj_j, _), vjp = jax.vjp(
        lambda s0, fd, w0, b0, w1, b1: pf.fused_train_loop2(
            adj, s0, ms, ma, fd, w0, b0, w1, b1, nm, K, thr, *acts, alpha, rate, 2),
        *[jnp.asarray(x[k]) for k in names])
    want = vjp((jnp.asarray(x["g"]), jnp.zeros((K, 4, 32))))
    s0, fd = _nm(x["s0"]).requires_grad_(), _nm(x["fd"]).requires_grad_()
    ws = [w.requires_grad_() for w in _weights(x)]
    traj, marg = tf2.fused_train_loop2(
        _t(x["adjT"]), s0, _keep(x["ms"]) if rate else None, _keep(x["ma"]) if rate else None,
        fd, *ws, _t(x["nm"]), K, thr, *acts, alpha, rate)
    assert not marg.requires_grad
    np.testing.assert_allclose(_fm(traj), np.asarray(traj_j), atol=ATOL_TRAIN)
    torch.sum(traj * _nm(x["g"])).backward()
    for name, t, w in zip(names, [s0, fd] + ws, want):
        got = _fm(t.grad) if name in ("s0", "fd") else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=RTOL, atol=ATOL_GRAD, err_msg=name)


@pytest.mark.parametrize("res,affine", [(True, True), (False, False)])
def test_step2_grads_match_jax_vjp(res, affine):
    """K9's autograd Function (its plain backward, gnn_tpu's _step2_bwd) against
    jax.vjp of fused_propagation_step2, through the same operand maps."""
    x = _inputs(6)
    D = x["s0"].shape[1]
    acts = ("selu", "tanh")
    adj = _pack(x)
    names = ("s0", "r", "feats", "w0", "b0", "w1", "b1", "aff")

    def f(s, r, feats, w0, b0, w1, b1, aff):
        w20, fT0, rT = _eval_operands(w0, b0, feats, r if res else None, D)
        return pf.fused_propagation_step2(adj, s, rT, fT0, w20, w1, b1, aff if affine else None,
                                          *acts, 2)
    y_j, vjp = jax.vjp(f, *[jnp.asarray(x[k]) for k in names])
    want = vjp(jnp.asarray(x["g"][0]))
    s, r, feats = (_nm(x[k]).requires_grad_() for k in ("s0", "r", "feats"))
    ws = [w.requires_grad_() for w in _weights(x)]
    aff = _t(x["aff"]).requires_grad_()
    y = tf2.fused_propagation_step2(_t(x["adjT"]), s, r if res else None, feats, *ws,
                                    aff if affine else None, *acts)
    np.testing.assert_allclose(_fm(y), np.asarray(y_j), atol=ATOL_EVAL)
    torch.sum(y * _nm(x["g"][0])).backward()
    for name, t, w in zip(names, [s, r, feats] + ws + [aff], want):
        if (name == "r" and not res) or (name == "aff" and not affine):
            assert t.grad is None
            continue
        got = _fm(t.grad) if name in ("s0", "r", "feats") else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=RTOL, atol=ATOL_GRAD, err_msg=name)


@pytest.mark.parametrize("affine,acts", [(True, ("selu", "tanh")), (False, ("tanh", "tanh")),
                                          (True, ("tanh", "tanh")), (False, ("selu", "tanh"))])
def test_loop2_bwd_ref_matches_jax_vjp(affine, acts):
    """K11 on the Pallas forward's trajectory against jax.vjp of gnn_tpu's
    fused_propagation_loop2 (its K11 in interpret mode) through the operand
    maps, which carry the cotangent of the hoisted fT0 back through Wf to
    feats, Wf and b0: the state and feats cotangents and the block-summed
    weight and affine cotangents."""
    x = _inputs(7)
    D = x["s0"].shape[1]
    thr = 0.05
    adj, nm = _pack(x), jnp.asarray(x["nm"])
    names = ("s0", "feats", "w0", "b0", "w1", "b1", "aff")

    def f(s0, feats, w0, b0, w1, b1, aff):
        w20, fT0, _ = _eval_operands(w0, b0, feats, None, D)
        return pf.fused_propagation_loop2(adj, s0, fT0, w20, w1, b1, aff if affine else None, nm,
                                          K, thr, *acts, 2)
    (traj_j, _), vjp = jax.vjp(f, *[jnp.asarray(x[k]) for k in names])
    want = vjp((jnp.asarray(x["g"]), jnp.zeros((K, 4, 32))))
    tf2.reset_launches()
    gs, dw0, db0, dw1, db1, dfeats, daff = tf2.propagation_loop2_bwd(
        _t(x["adjT"]), _nm(x["s0"]), _nm(traj_j), _nm(x["feats"]), *_weights(x),
        _t(x["aff"]) if affine else None, _nm(x["g"]), *acts)
    assert not any(tf2.launches.values())                     # the plain version on the CPU
    assert dw0.shape == (4, 16, 13) and (daff is None) != affine   # per-block partials
    got = [gs, dfeats, dw0, db0, dw1, db1, daff]
    for name, t, w in zip(names, got, want):
        if t is None:
            continue
        t = _fm(t) if name in ("s0", "feats") else t.sum(0).numpy()
        np.testing.assert_allclose(t, np.asarray(w), rtol=RTOL, atol=ATOL_GRAD, err_msg=name)


def test_loop2_backward_raises_naming_k11():
    """A backward through K10's autograd Function no longer raises for want
    of K11: it runs K11 and gives the grads autograd gives through
    propagation_loop2_ref, with and without the affine; margins carry none."""
    x = _inputs(9)
    args = (_t(x["nm"]), K, 0.05, "selu", "tanh")
    for affine in (True, False):
        grads = []
        for fn in (tf2.fused_propagation_loop2, tf2.propagation_loop2_ref):
            leaves = [_nm(x["s0"]).requires_grad_(), _nm(x["feats"]).requires_grad_()]
            leaves += [w.requires_grad_() for w in _weights(x)] + [_t(x["aff"]).requires_grad_()]
            traj, marg = fn(_t(x["adjT"]), *leaves[:6], leaves[6] if affine else None, *args)
            assert not marg.requires_grad
            torch.sum(traj * _nm(x["g"])).backward()
            grads.append([t.grad for t in leaves])
        for a, b in zip(*grads):
            if not affine and b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=1e-6)


def test_padded_rows_add_nothing():
    """Padded loop rows (node mask 0, an empty adjacency, the state of block
    0 gathered by a loop id of 0) whose states nothing reads add exactly 0 to
    the weight partials and to their own state and fd cotangents."""
    x = _inputs(8)
    x["adjT"][3] = 0.0
    x["nm"][3] = 0.0
    x["s0"][3] = x["s0"][0]
    x["g"][:, 3] = 0.0
    args = [_t(x["adjT"]), _nm(x["s0"]), _keep(x["ms"]), _keep(x["ma"]), _nm(x["fd"])]
    traj, _, agg = tf2.train_loop2(*args, *_weights(x), _t(x["nm"]), K, 0.05, "selu", "selu",
                                   True, 0.2)
    gs, dw0, db0, dw1, db1, dfd = tf2.train_loop2_bwd(
        args[0], args[1], traj, agg, *args[2:], *_weights(x), _nm(x["g"]), "selu", "selu", True,
        0.2)
    assert torch.isfinite(traj[:, 3]).all()
    for t in (gs, dw0, db0, dw1, db1):
        assert (t[3] == 0).all()
    assert (dfd[:, 3] == 0).all() and (dw0[:3] != 0).any()


def test_two_layer_kernel_widths_checked():
    """A hidden width over MAX_HIDDEN, widths over 64 and shapes whose staged
    plans overflow a CTA's shared memory pass every width check and take the
    wide plan (their plans mirror it); what the kernels cannot take still
    raises before any launch: a block width outside 32..128 and tensors on
    neither the CPU nor a card (here the meta tensors past every check)."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    def step(W=32, D=5, al=AL, H1=16):
        return tf2.propagation_step2(meta(2, W, W), meta(2, W, D), None, meta(2, W, al),
                                     meta(H1, 2 * D + al), meta(H1), meta(D, H1), meta(D))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        step(H1=tf2.MAX_HIDDEN + 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        step(D=65)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tf2.train_loop2_bwd(meta(2, 128, 128), meta(2, 128, 64), meta(K, 2, 128, 64),
                            meta(K, 2, 128, 64), None, None, meta(K, 2, 128, 64),
                            meta(256, 192), meta(256), meta(64, 256), meta(64),
                            meta(K, 2, 128, 64))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tf2.propagation_loop2_bwd(meta(2, 128, 128), meta(2, 128, 64), meta(K, 2, 128, 64),
                                  meta(2, 128, 64), meta(256, 192), meta(256), meta(64, 256),
                                  meta(64), None, meta(K, 2, 128, 64))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        step(W=128, D=14, H1=tf2.MAX_HIDDEN)
    with pytest.raises(ValueError, match="block width"):
        step(W=48)
    assert tf2._tile2_plan(32, 5, AL, tf2.MAX_HIDDEN + 1, "K9")[1] == 0
    assert tf2._tile2_plan(32, 65, AL, 16, "K9")[1] == len(tf2._PLANS["K9"])
    assert tf2._tile2_plan(128, 64, 64, 256, "K13")[1] == len(tf2._PLANS["K13"])
    assert tf2._tile2_plan(128, 64, 64, 256, "K11")[1] == len(tf2._PLANS["K11"])
    assert tf2._tile2_plan(128, 14, 3, tf2.MAX_HIDDEN, "K11")[1] is not None
    assert tf2._tile2_plan(128, 14, 3, tf2.MAX_HIDDEN, "K9")[0] <= tf2.SMEM_BYTES


def _per_node_smem_bytes(kernel, W, D, AL, H1):
    """Shared memory a CTA of the per-node K10 and K12 (the resident
    adjacency, state and staging rows, the weights: the layout of the
    per-node K9, fused2.py::_smem_bytes before its redesign) or of the per-node
    reverse kernels K11, K13 and K15 (x3 and dh1 rows, two 17-wide chunk
    tiles, the weights; K11 and its affine [2][D], K15 and bnv [9][D] and the
    node mask [W]) took, one thread a node, as fused2.py::_smem_bytes and
    bn.py::_smem2_bytes reckoned them (AL: K15's F); the widths may be numpy
    arrays."""
    C = 2 * D + AL
    weights = H1 * (C + D + 1)
    if kernel in ("K10", "K12"):
        return 4 * (W * (W + 1) + W * (D | 1) + W * (np.maximum(D, AL) | 1) + weights + 3 * D)
    extra = {"K11": 2 * D, "K13": 0, "K15": 9 * D + W}[kernel]
    return 4 * (W * (C | 1) + W * (D | 1) + 2 * W * 17 + weights + D + extra)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _tiled_wrapper_checks(kernel, W, D, al, H1, refused=None):
    """Run the width and shared-memory checks of the tiled kernel's wrapper
    (K10 propagation_loop2, K11 propagation_loop2_bwd, K12 train_loop2, K13
    train_loop2_bwd; for K15 bn2_backward_step's _check_two_layer) on meta
    tensors of this shape: they must pass (past them the four wrappers raise
    for the meta device), or, given `refused`, raise a ValueError matching
    it."""
    meta = _meta
    wts = (meta(H1, 2 * D + al), meta(H1), meta(D, H1), meta(D))
    calls = {
        "K10": lambda: tf2.propagation_loop2(meta(2, W, W), meta(2, W, D), meta(2, W, al), *wts,
                                             None, meta(2, W), K, 0.05),
        "K11": lambda: tf2.propagation_loop2_bwd(meta(2, W, W), meta(2, W, D), meta(K, 2, W, D),
                                                 meta(2, W, al), *wts, meta(2, D),
                                                 meta(K, 2, W, D)),
        "K12": lambda: tf2.train_loop2(meta(2, W, W), meta(2, W, D), None, None,
                                       meta(K, 2, W, al), *wts, meta(2, W), K, 0.05),
        "K13": lambda: tf2.train_loop2_bwd(meta(2, W, W), meta(2, W, D), meta(K, 2, W, D),
                                           meta(K, 2, W, D), None, None, meta(K, 2, W, al), *wts,
                                           meta(K, 2, W, D)),
        "K15": lambda: tbn._check_two_layer(meta(2, W, W), None, 2, D, al,
                                            meta(H1, 2 * D + al + 1), meta(D, H1), meta(D)),
    }
    if kernel == "K15" and refused is None:
        calls[kernel]()
        return
    with pytest.raises(ValueError, match=refused or "CPU or CUDA"):
        calls[kernel]()


@pytest.mark.parametrize("kernel", ["K10", "K13", "K11", "K15", "K12"])
@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_tiled_kernels_take_every_shape_the_per_node_kernels_took(kernel, W):
    """Over every D, AL in 1..64 and H1 in 1..MAX_HIDDEN, each shape whose
    per-node layout fitted 227 KB fits one of the tiled kernel's plans
    (ops/fused2.py::_tile2_bytes, reckoned on the whole grid at once). The
    wrapper's own checks pass on D, AL in {1, 5, 14, 16, 17, 32, 33, 64}, H1 in
    {1, 7, 150, 512}, and on the 16 taken shapes that leave the least room."""
    D, AL, H1 = np.meshgrid(np.arange(1, 65), np.arange(1, 65),
                            np.arange(1, tf2.MAX_HIDDEN + 1), indexing="ij")
    took = _per_node_smem_bytes(kernel, W, D, AL, H1) <= tf2.SMEM_BYTES
    least = np.min([tf2._tile2_bytes(tf2._KIND[kernel], W, D, AL, H1, p)
                    for p in tf2._PLANS[kernel]], axis=0)
    refused = took & (least > tf2.SMEM_BYTES)
    assert not refused.any(), (
        f"{int(refused.sum())} shapes refused, e.g. (D, AL, H1) = "
        f"{tuple(int(v[refused][0]) for v in (D, AL, H1))}")
    widths = (1, 5, 14, 16, 17, 32, 33, 64)
    taken = 0
    for d, al, h1 in itertools.product(widths, widths, (1, 7, 150, 512)):
        if _per_node_smem_bytes(kernel, W, d, al, h1) <= tf2.SMEM_BYTES:
            _tiled_wrapper_checks(kernel, W, d, al, h1)
            taken += 1
    assert taken > 100
    room = np.where(took, tf2.SMEM_BYTES - least, np.iinfo(np.int64).max).ravel()
    for i in np.argsort(room, kind="stable")[:16]:
        _tiled_wrapper_checks(kernel, W, *(int(v.ravel()[i]) for v in (D, AL, H1)))


@pytest.mark.parametrize("kernel", ["K10", "K11", "K13", "K15", "K12"])
def test_tiled_kernels_raise_above_their_last_plan(kernel):
    """(The name is from when such shapes were refused.) A shape that not
    even the leanest staged plan fits (W 128, D = AL = 64, the least such H1)
    takes the wide plan (index len(_PLANS), its bytes, as every larger H1 up to
    2048 does) and passes the wrapper's checks before any launch; one hidden
    unit fewer takes the leanest staged plan."""
    bytes_at = [tf2._tile2_bytes(tf2._KIND[kernel], 128, 64, 64, h1, tf2._PLANS[kernel][-1])
                for h1 in range(1, tf2.MAX_HIDDEN + 1)]
    h1 = next(h for h, b in enumerate(bytes_at, 1) if b > tf2.SMEM_BYTES)
    need, plan = tf2._tile2_plan(128, 64, 64, h1, kernel)
    wide = len(tf2._PLANS[kernel])
    assert plan == wide and need == tf2._tile2_wide(tf2._KIND[kernel], 128, 64, 64, h1)[0]
    assert need <= tf2.SMEM_BYTES
    assert all(tf2._tile2_plan(128, 64, 64, h, kernel)[1] == wide for h in range(h1, 2049, 97))
    assert tf2._tile2_plan(128, 64, 64, h1 - 1, kernel)[1] == wide - 1
    _tiled_wrapper_checks(kernel, 128, 64, 64, h1)
    _tiled_wrapper_checks(kernel, 128, 64, 64, h1 - 1)


def test_tiled_kernels_fit_their_ctas_at_the_recipe():
    """At the hidden-150 recipe (W 128, D 14, AL 3, H1 150) K10 and K12 take
    their first plans (two y0 tiles, the adjacency lists) in at most 113 KB,
    so two CTAs of 256 threads, 16 warps, fit an SM's 228 KB (1 KB kept a
    CTA); K13 and K11 their first plans (h0 kept, the weight partials in
    shared memory, the prefetch; K11 with both list sets and two y0 tiles) in
    one CTA's 227 KB; K15 its first plan (h0 recomputed) in at most 113 KB,
    two CTAs an SM."""
    for kernel in ("K10", "K12"):
        need, plan = tf2._tile2_plan(128, 14, 3, 150, kernel)
        assert plan == 0 and need <= 113 * 1024
        assert 2 * (need + 1024) <= 228 * 1024
    for kernel in ("K13", "K11", "K15"):
        need, plan = tf2._tile2_plan(128, 14, 3, 150, kernel)
        assert plan == 0 and need <= tf2.SMEM_BYTES
    need, plan = tf2._tile2_plan(128, 14, 3, 150, "K15")
    assert tf2._PLANS["K15"][plan][2] == 0 and 2 * (need + 1024) <= 228 * 1024
