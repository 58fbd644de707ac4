"""The two-layer BN training kernels' plain versions (gnn_tpu_torch/ops/bn.py
K14/K15) against gnn_tpu's Pallas kernels _bn2_fwd_call/_bn2_bwd_call
(ops/pallas_bn.py), which run in interpret mode on the CPU, and the
two-layer K-loop's K15-based backward against autograd through the plain
training body.

Tolerances as tests/test_torch_bn.py: per-node outputs atol 3e-5 (gnn_tpu's
bound for its kernels' bf16 hi/lo f32 emulation); sums over nodes (moment,
weight and reduction partials, summed over blocks) within 1e-4 of the sum of
their terms' magnitudes plus 3e-5; movement flags equal. The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions there)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import pallas_bn as pb
from gnn_tpu.ops import pallas_fused as pf
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops.mlp import MLPSpec
from test_torch_bn import _close_sum, _fm, _hybrid_batch, _split, _t

torch.set_num_threads(1)
ATOL = 3e-5


def _inputs(seed, H1, B=4, W=32, D=5, F=3, rate=0.1):
    """Feature-major (gnn_tpu) operands of one two-layer BN iteration: an
    'average' block adjacency (~10% arcs), keep bits, and activations, weights
    and cotangents that keep every output O(1), the range where gnn_tpu's
    hi/lo emulation is within 3e-5 of f32."""
    rng = np.random.default_rng(seed)
    arcs = rng.random((B, W, W)) < 0.1
    C = 2 * D + F + 1

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    aff = np.stack([np.stack([rng.uniform(0.5, 1.2, D), 0.1 * rng.standard_normal(D)])
                    for _ in range(2)]).astype(np.float32)
    return dict(adjT=(arcs / np.maximum(arcs.sum(axis=1, keepdims=True), 1)).astype(np.float32),
                y1=f32(B, D, W), y2=f32(B, D, W), aff=aff, rT=f32(B, D, W, scale=0.3),
                mc=(rng.random((B, C - 1, W)) > rate).astype(np.int8),
                feats=f32(B, F, W, scale=0.5), w0=f32(H1, C, scale=0.6 / np.sqrt(C)),
                w1=f32(D, H1, scale=1.0 / np.sqrt(H1)), b1=f32(D, scale=0.1),
                nm=(rng.random((B, W)) < 0.8).astype(np.float32),
                ds_in=f32(B, D, W, scale=0.3), gsel=f32(B, D, W, scale=0.3), yk=f32(B, D, W),
                agg=f32(B, D, W), bnv=np.concatenate([rng.uniform(0.3, 0.8, (9, D)),
                                                      np.zeros((7, D))]).astype(np.float32))


def _w(x):
    return [torch.from_numpy(x[k]) for k in ("w0", "w1", "b1")]


@pytest.mark.parametrize("acts,rate,alpha,res,Bl,H1", [
    (("selu", "selu"), 0.1, True, True, 3, 16), (("selu", "tanh"), 0.0, True, False, 4, 37),
    (("tanh", "relu"), 0.2, False, True, 2, 16), (("relu", "linear"), 0.0, False, True, 1, 16)])
def test_bn2_forward_step_ref_matches_pallas(acts, rate, alpha, res, Bl, H1):
    """K14: the pre-BN activation, the aggregation, the flags and the moment
    sums, with and without dropout and the residual rows."""
    x = _inputs(1, H1, rate=rate)
    thr = 0.05
    y_j, agg_j, marg_j, msum_j = pb._bn2_fwd_call(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["y1"]), jnp.asarray(x["y2"]),
        jnp.asarray(x["aff"])[..., None], jnp.asarray(x["mc"]) if rate else None,
        jnp.asarray(x["rT"]) if res else None, jnp.asarray(x["feats"]), jnp.asarray(x["w0"]),
        jnp.asarray(x["w1"]), jnp.asarray(x["b1"]), jnp.asarray(x["nm"])[:, None, :],
        act0=acts[0], act1=acts[1], alpha_drop=alpha, rate=rate, group=2, thr=thr,
        interpret=True)
    tbn.reset_launches()
    adj_loop, adj_dep = _split(x["adjT"], Bl)
    y, agg, marg, msum = tbn.bn2_forward_step(
        adj_loop, adj_dep, _t(x["y1"]), _t(x["y2"]), torch.from_numpy(x["aff"]),
        _t(x["mc"]).to(torch.uint8) if rate else None, _t(x["rT"]) if res else None,
        _t(x["feats"]), *_w(x), torch.from_numpy(x["nm"]), act0=acts[0], act1=acts[1],
        alpha_drop=alpha, rate=rate, threshold=thr)
    assert not any(tbn.launches.values())                       # the plain version on the CPU
    np.testing.assert_allclose(_fm(y), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(_fm(agg), np.asarray(agg_j), atol=ATOL)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(marg_j)[:, 0])
    assert 0 < marg.sum() < marg.numel()
    _close_sum(msum.sum(0), np.asarray(msum_j).sum((0, 1)),
               (y.abs() * torch.from_numpy(x["nm"])[..., None]).sum((0, 1)))


@pytest.mark.parametrize("acts,rate,alpha,flag,Bl,H1", [
    (("selu", "selu"), 0.1, True, 1.0, 3, 16), (("selu", "tanh"), 0.0, True, 0.0, 4, 37),
    (("tanh", "relu"), 0.2, False, 1.0, 1, 16), (("relu", "selu"), 0.0, False, 1.0, 2, 16)])
def test_bn2_backward_step_ref_matches_pallas(acts, rate, alpha, flag, Bl, H1):
    """K15: the state and aggregation cotangents per node and the dw0 (db0
    its last column), dw1, db1 and reduction partials summed over blocks."""
    x = _inputs(2, H1, rate=rate)
    ds_j, dw0_j, dw1_j, db1_j, dagg_j, red_j = pb._bn2_bwd_call(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["y1"]), jnp.asarray(x["yk"]),
        jnp.asarray(x["agg"]), jnp.asarray(x["mc"]) if rate else None, jnp.asarray(x["feats"]),
        jnp.asarray(x["w0"]), jnp.asarray(x["w1"]), jnp.asarray(x["b1"]),
        jnp.asarray(x["ds_in"]), jnp.asarray(x["gsel"]), jnp.asarray(x["bnv"])[..., None],
        jnp.full((1, 1), flag, jnp.float32), jnp.asarray(x["nm"])[:, None, :], act0=acts[0],
        act1=acts[1], alpha_drop=alpha, rate=rate, group=2, interpret=True)
    adj_loop, adj_dep = _split(x["adjT"], Bl)
    keep = _t(x["mc"]).to(torch.uint8) if rate else None
    args = (adj_loop, adj_dep, _t(x["y1"]), _t(x["yk"]), _t(x["agg"]), keep, _t(x["feats"]),
            *_w(x), _t(x["ds_in"]), _t(x["gsel"]), torch.from_numpy(x["bnv"][:len(tbn.BNV_ROWS)]),
            torch.tensor(flag), torch.from_numpy(x["nm"]))
    kw = dict(act0=acts[0], act1=acts[1], alpha_drop=alpha, rate=rate)
    ds, dw0, dw1, db1, dagg, red = tbn.bn2_backward_step(*args, **kw)
    np.testing.assert_allclose(_fm(ds), np.asarray(ds_j), atol=ATOL)
    np.testing.assert_allclose(_fm(dagg), np.asarray(dagg_j), atol=ATOL)
    # the summed terms' magnitudes: the same reverse on |dh1|, |y0|, |dh0|, |x3|
    bnv = torch.from_numpy(x["bnv"])
    w0, w1, b1 = _w(x)
    x3 = tbn._x3(args[2] * bnv[0] + bnv[1], args[4], args[6], keep, alpha, rate)
    h0 = torch.nn.functional.linear(x3, w0[:, :-1], w0[:, -1])
    y0 = tf._ACTS[acts[0]](h0)
    dh1 = tbn._bn_gy(args[3], args[10], args[11], bnv, flag, args[14]) * tf._act_grad(
        acts[1], torch.nn.functional.linear(y0, w1, b1))
    dh0 = torch.matmul(dh1, w1) * tf._act_grad(acts[0], h0)
    x3a = torch.cat([x3, torch.ones_like(x3[..., :1])], -1)
    _close_sum(dw0.sum(0), np.asarray(dw0_j), torch.einsum("bwj,bwc->jc", dh0.abs(), x3a.abs()))
    _close_sum(dw1.sum(0), np.asarray(dw1_j), torch.einsum("bwd,bwj->dj", dh1.abs(), y0.abs()))
    _close_sum(db1.sum(0), np.asarray(db1_j), dh1.abs().sum((0, 1)))
    xp_hat = (args[2] - bnv[7]) * bnv[8]
    _close_sum(red.sum(0), np.asarray(red_j),
               torch.stack([ds.abs().sum((0, 1)), (ds * xp_hat).abs().sum((0, 1))]))


def _spec(rate, threshold, acts=("selu", "tanh")):
    kw = dict(dropout_rate=(rate,), dropout_pos=(0,), alphadropout=True) if rate else {}
    ss = MLPSpec(input_dim=13, units=(16, 5), activations=acts, kernel_initializer="lecun_normal",
                 bias_initializer="lecun_normal", batch_normalization=True, **kw)
    so = MLPSpec(input_dim=5, units=(2,), activations="softmax", batch_normalization=False)
    return tcore.GNNSpec(focus="g", state_spec=ss, output_spec=so, max_iteration=4,
                         threshold=threshold, aggregation="auto")


@pytest.mark.parametrize("threshold,rate", [(0.01, 0.1), (0.01, 0.0), (0.4, 0.1), (1e9, 0.1)])
def test_bn2_loop_backward_matches_autograd_through_plain_body(threshold, rate):
    """Gradients of a loss on the state through the two-layer bn_train_loop
    (K launches of K15 with the [D]-sized glue and the residual scatter)
    equal torch autograd through the plain training body on the same batch
    and masks; moving statistics and realised counts agree too."""
    gb = _hybrid_batch()
    spec = _spec(rate, threshold)
    assert tcore._train_route(spec, gb) == "bn"
    params, bn = tcore.gnn_init(spec, torch.Generator().manual_seed(0))
    bn["state"] = {"mean": torch.full((5,), 0.1), "var": torch.full((5,), 0.7)}
    masks = tcore.draw_masks(spec, gb, torch.Generator().manual_seed(1))
    weight = torch.randn(gb.nodes.shape, generator=torch.Generator().manual_seed(2))

    def run(sp):
        ps = {name: {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
              for name, leaves in params["state"].items()}
        iters, state, new_bn = tcore.propagate(sp, ps, bn["state"], gb, True, masks["state"])
        torch.sum(torch.tanh(state) * weight).backward()
        return iters, state, new_bn, [t.grad for t in tcore.param_leaves(ps)]

    tbn.reset_launches()
    k_loop, s_loop, bn_loop, g_loop = run(spec)
    assert not any(tbn.launches.values())                       # plain on the CPU
    k_body, s_body, bn_body, g_body = run(dataclasses.replace(spec, aggregation="segment"))
    assert float(k_loop) == float(k_body)
    if threshold == 1e9:
        assert float(k_loop) == 0.0
    np.testing.assert_allclose(s_loop.detach().numpy(), s_body.detach().numpy(), atol=ATOL)
    for key in ("mean", "var"):
        np.testing.assert_allclose(bn_loop[key].numpy(), bn_body[key].numpy(), atol=1e-5)
    assert len(g_loop) == 6                     # dense_0 w, b; dense_1 w, b; gamma, beta
    for a, b in zip(g_loop, g_body):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_bn2_kernel_widths_checked():
    """K14/K15 take a hidden width over MAX_HIDDEN, arc-label widths over 64
    and shapes whose rows and weights overflow a CTA's shared memory (the
    wide plan); what they cannot take raises before any launch: a hidden
    width of 0, tensors on neither the CPU nor a card."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    def fwd(R=2, W=32, D=5, F=3, H1=16):
        return tbn.bn2_forward_step(meta(R, W, W), None, meta(R, W, D), meta(R, W, D),
                                    meta(2, 2, D), None, None, meta(R, W, F),
                                    meta(H1, 2 * D + F + 1), meta(D, H1), meta(D), meta(R, W),
                                    act0="selu", act1="selu", alpha_drop=True, rate=0.0,
                                    threshold=0.01)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fwd()
    # the register-tiled K14 takes the first of its plans that fits: 2 CTAs an SM
    need = tbn._smem2_bytes(128, 14, 3, 150, backward=False)
    assert need == tf2._tile2_plan(128, 14, 3, 150, "K14")[0] and 2 * (need + 1024) <= 228 * 1024
    # the register-tiled K15 takes the first of its plans that fits (h0 kept)
    assert tbn._smem2_bytes(128, 14, 3, 150, backward=True) == tf2._tile2_plan(
        128, 14, 3, 150, "K15")[0] <= tbn.SMEM_BYTES
    assert tbn._smem2_bytes(128, 14, 3, tf2.MAX_HIDDEN, backward=True) <= tbn.SMEM_BYTES
    # a hidden width over MAX_HIDDEN, F over 64 and a shape no staged plan fits
    # pass the checks (their plans: a staged one, the wide plan twice)
    assert tbn._check_two_layer(meta(2, 32, 32), None, 2, 5, 3, meta(tf2.MAX_HIDDEN + 1, 14),
                                meta(5, tf2.MAX_HIDDEN + 1), meta(5)) == (2, 32,
                                                                         tf2.MAX_HIDDEN + 1)
    assert tbn._check_two_layer(meta(2, 32, 32), None, 2, 5, 65, meta(16, 76), meta(5, 16),
                                meta(5)) == (2, 32, 16)
    assert tbn._check_two_layer(meta(2, 128, 128), None, 2, 64, 64, meta(512, 193),
                                meta(64, 512), meta(64)) == (2, 128, 512)
    assert tf2._tile2_plan(32, 5, 3, tf2.MAX_HIDDEN + 1, "K15")[1] == 0
    assert tf2._tile2_plan(32, 5, 65, 16, "K14")[1] == len(tf2._PLANS["K14"])
    assert tf2._tile2_plan(128, 64, 64, 512, "K15")[1] == len(tf2._PLANS["K15"])
    with pytest.raises(ValueError, match="hidden width H1=0"):
        tbn._check_two_layer(meta(2, 32, 32), None, 2, 5, 3, meta(0, 14), meta(5, 0), meta(5))
