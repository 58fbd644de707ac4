"""The BN training kernels' plain versions (gnn_tpu_torch/ops/bn.py) against
gnn_tpu's Pallas kernels K1/K2 (ops/pallas_bn.py), which run in interpret
mode on the CPU, and the K-loop's K2-based backward against autograd through
the plain training body.

Tolerances: per-node outputs atol 3e-5, gnn_tpu's bound for its kernels'
bf16 hi/lo f32 emulation (tests/test_fused.py); sums over nodes (the
moment, dw and reduction partials, summed over blocks) within 1e-4 of the
sum of their terms' magnitudes, that emulation's relative error (about
8e-6 a term) with room, since a sum can cancel far below its terms;
movement flags equal. The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
these plain versions there)."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import pallas_bn as pb
from gnn_tpu.ops import pallas_fused as pf
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops.mlp import MLPSpec

torch.set_num_threads(1)
ATOL = 3e-5
SUM_RTOL = 1e-4


def _close_sum(got, want, terms_abs):
    """|got - want| <= SUM_RTOL * (sum of the terms' magnitudes) + ATOL."""
    bound = SUM_RTOL * np.asarray(terms_abs) + ATOL
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= bound).all(), f"max err {err.max()}, at bound {bound.flat[err.argmax()]}"


def _inputs(seed, B=4, W=32, D=5, F=3, rate=0.15):
    """Feature-major (gnn_tpu) operands of one BN iteration: an 'average'
    block adjacency (~10% arcs), keep bits, and activations, weights and
    cotangents that keep every output O(1), the range where gnn_tpu's hi/lo
    emulation is within 3e-5 of f32 (its error is relative, about 8e-6)."""
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
                feats=f32(B, F, W, scale=0.5), w_aug=f32(D, C, scale=0.4),
                nm=(rng.random((B, W)) < 0.8).astype(np.float32),
                ds_in=f32(B, D, W, scale=0.3), gsel=f32(B, D, W, scale=0.3), yk=f32(B, D, W),
                agg=f32(B, D, W), bnv=np.concatenate([rng.uniform(0.3, 0.8, (9, D)),
                                                      np.zeros((7, D))]).astype(np.float32))


def _t(x):
    """Feature-major [B, F, W] -> the port's node-major [B, W, F] tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


def _fm(t):
    return np.swapaxes(t.numpy(), 1, 2)


def _split(adjT, Bl):
    """The port's two adjacency operands: rows [0, Bl) and the rest."""
    a = torch.from_numpy(adjT)
    return a[:Bl].contiguous(), (a[Bl:].contiguous() if Bl < a.shape[0] else None)


@pytest.mark.parametrize("act,rate,alpha,res,Bl", [
    ("selu", 0.15, True, True, 3), ("selu", 0.0, True, False, 4), ("tanh", 0.2, False, True, 2),
    ("relu", 0.1, True, False, 1), ("linear", 0.0, False, True, 4)])
def test_bn_forward_step_ref_matches_pallas(act, rate, alpha, res, Bl):
    x = _inputs(1, rate=rate)
    thr = 0.05
    y_j, agg_j, marg_j, msum_j = pb._bn_fwd_call(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["y1"]), jnp.asarray(x["y2"]),
        jnp.asarray(x["aff"])[..., None], jnp.asarray(x["mc"]) if rate else None,
        jnp.asarray(x["rT"]) if res else None, jnp.asarray(x["feats"]), jnp.asarray(x["w_aug"]),
        jnp.asarray(x["nm"])[:, None, :], activation=act, alpha_drop=alpha, rate=rate, group=2,
        thr=thr, interpret=True)
    tbn.reset_launches()
    adj_loop, adj_dep = _split(x["adjT"], Bl)
    y, agg, marg, msum = tbn.bn_forward_step(
        adj_loop, adj_dep, _t(x["y1"]), _t(x["y2"]), torch.from_numpy(x["aff"]),
        _t(x["mc"]).to(torch.uint8) if rate else None, _t(x["rT"]) if res else None,
        _t(x["feats"]), torch.from_numpy(x["w_aug"]), torch.from_numpy(x["nm"]),
        activation=act, alpha_drop=alpha, rate=rate, threshold=thr)
    assert not any(tbn.launches.values())
    np.testing.assert_allclose(_fm(y), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(_fm(agg), np.asarray(agg_j), atol=ATOL)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(marg_j)[:, 0])
    _close_sum(msum.sum(0), np.asarray(msum_j).sum((0, 1)),
               (y.abs() * torch.from_numpy(x["nm"])[..., None]).sum((0, 1)))


@pytest.mark.parametrize("act,rate,alpha,flag,Bl", [
    ("selu", 0.15, True, 1.0, 3), ("selu", 0.0, True, 0.0, 4), ("tanh", 0.2, False, 1.0, 1),
    ("relu", 0.1, True, 0.0, 2)])
def test_bn_backward_step_ref_matches_pallas(act, rate, alpha, flag, Bl):
    x = _inputs(2, rate=rate)
    ds_j, dw_j, dagg_j, red_j = pb._bn_bwd_call(
        pf.pack_adjacency(jnp.asarray(x["adjT"])), jnp.asarray(x["y1"]), jnp.asarray(x["yk"]),
        jnp.asarray(x["agg"]), jnp.asarray(x["mc"]) if rate else None, jnp.asarray(x["feats"]),
        jnp.asarray(x["w_aug"]), jnp.asarray(x["ds_in"]), jnp.asarray(x["gsel"]),
        jnp.asarray(x["bnv"])[..., None], jnp.full((1, 1), flag, jnp.float32),
        jnp.asarray(x["nm"])[:, None, :], activation=act, alpha_drop=alpha, rate=rate, group=2,
        interpret=True)
    adj_loop, adj_dep = _split(x["adjT"], Bl)
    ds, dw, dagg, red = tbn.bn_backward_step(
        adj_loop, adj_dep, _t(x["y1"]), _t(x["yk"]), _t(x["agg"]),
        _t(x["mc"]).to(torch.uint8) if rate else None, _t(x["feats"]),
        torch.from_numpy(x["w_aug"]), _t(x["ds_in"]), _t(x["gsel"]),
        torch.from_numpy(x["bnv"][:len(tbn.BNV_ROWS)]), torch.tensor(flag),
        torch.from_numpy(x["nm"]), activation=act, alpha_drop=alpha, rate=rate)
    np.testing.assert_allclose(_fm(ds), np.asarray(ds_j), atol=ATOL)
    np.testing.assert_allclose(_fm(dagg), np.asarray(dagg_j), atol=ATOL)
    # magnitudes of the summed terms: dw = sum dh^T [x3; 1], red = sum (ds, ds * x_hat_prev)
    bnv = torch.from_numpy(x["bnv"])
    nm3 = torch.from_numpy(x["nm"])[..., None]
    y_prev, y_k = _t(x["y1"]), _t(x["yk"])
    x3 = tbn._x3(y_prev * bnv[0] + bnv[1], _t(x["agg"]), _t(x["feats"]),
                 _t(x["mc"]).to(torch.uint8) if rate else None, alpha, rate)
    w = torch.from_numpy(x["w_aug"])
    gy = bnv[4] * (_t(x["ds_in"]) + flag * _t(x["gsel"])) - nm3 * (
        bnv[5] + (y_k - bnv[2]) * bnv[3] * bnv[6])
    dh = gy * tbn._act_grad(act, torch.nn.functional.linear(x3, w[:, :-1], w[:, -1]))
    x3a = torch.cat([x3, torch.ones_like(x3[..., :1])], -1)
    _close_sum(dw.sum(0), np.asarray(dw_j), torch.einsum("bwj,bwc->jc", dh.abs(), x3a.abs()))
    xp_hat = (y_prev - bnv[7]) * bnv[8]
    _close_sum(red.sum(0), np.asarray(red_j),
               torch.stack([ds.abs().sum((0, 1)), (ds * xp_hat).abs().sum((0, 1))]))


def test_bn_affine_matches():
    rng = np.random.default_rng(3)
    g, b, m = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    want = pb._affine(*(jnp.asarray(a) for a in (g, b, m, v)))
    got = tbn._affine(*(torch.from_numpy(a) for a in (g, b, m, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _hybrid_batch(seed=0):
    rng = np.random.default_rng(seed)
    gs = [tdata.random_graph(int(rng.integers(8, 30)), 5, 3, 2, 0.5, focus="g", rng=rng)
          for _ in range(12)]
    gs.insert(3, tdata.random_graph(70, 5, 3, 2, 0.2, focus="g", rng=rng))
    return tbatch.from_graphs_blocked(gs, block_w=32, focus="g", fused_layout=True)


@pytest.mark.parametrize("threshold,rate", [(0.01, 0.15), (0.01, 0.0), (0.4, 0.15),
                                            (1e9, 0.15)])
def test_bn_loop_backward_matches_autograd_through_plain_body(threshold, rate):
    """Gradients of a loss on the state through bn_train_loop (K launches of
    K2 with the [D]-sized glue and the residual scatter) equal torch
    autograd through the plain training body on the same batch and masks;
    moving statistics and realised counts agree too."""
    gb = _hybrid_batch()
    assert gb.adj_dep is not None and gb.adj_loop.shape[0] > 2   # loop and dep blocks
    kw = dict(dropout_rate=(rate,), dropout_pos=(0,), alphadropout=True) if rate else {}
    ss = MLPSpec(input_dim=13, units=(5,), activations="selu", kernel_initializer="lecun_normal",
                 bias_initializer="lecun_normal", batch_normalization=True, **kw)
    so = MLPSpec(input_dim=5, units=(2,), activations="softmax", batch_normalization=False)
    spec = tcore.GNNSpec(focus="g", state_spec=ss, output_spec=so, max_iteration=4,
                         threshold=threshold, aggregation="auto")
    params, bn = tcore.gnn_init(spec, torch.Generator().manual_seed(0))
    bn["state"] = {"mean": torch.full((5,), 0.1), "var": torch.full((5,), 0.7)}
    masks = tcore.draw_masks(spec, gb, torch.Generator().manual_seed(1))
    weight = torch.randn(gb.nodes.shape, generator=torch.Generator().manual_seed(2))

    def run(sp):
        p = {k: v.clone().requires_grad_(True) for k, v in params["state"]["dense_0"].items()}
        pb_ = {k: v.clone().requires_grad_(True) for k, v in params["state"]["bn"].items()}
        ps = {"dense_0": p, "bn": pb_}
        iters, state, new_bn = tcore.propagate(sp, ps, bn["state"], gb, True, masks["state"])
        torch.sum(torch.tanh(state) * weight).backward()
        return iters, state, new_bn, [t.grad for t in (p["w"], p["b"], pb_["gamma"], pb_["beta"])]

    tbn.reset_launches()
    k_loop, s_loop, bn_loop, g_loop = run(spec)
    assert not any(tbn.launches.values())   # plain on the CPU
    k_body, s_body, bn_body, g_body = run(dataclasses.replace(spec, aggregation="segment"))
    assert float(k_loop) == float(k_body)
    if threshold == 1e9:
        assert float(k_loop) == 0.0
    np.testing.assert_allclose(s_loop.detach().numpy(), s_body.detach().numpy(), atol=ATOL)
    for key in ("mean", "var"):
        np.testing.assert_allclose(bn_loop[key].numpy(), bn_body[key].numpy(), atol=1e-5)
    for a, b in zip(g_loop, g_body):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def _per_node_k2_bytes(W, D, F):
    """Shared memory a CTA of the per-node K2 took, one thread a node: the
    resident adjacency [W][W + 1], x3 rows of odd stride, two row buffers
    [W][D | 1], w_aug [D][C], bnv [9][D], the node mask [W] and the keep bytes
    (bn_train.cu's Layout, shared with the per-node K1); the widths may be
    numpy arrays."""
    C1 = 2 * D + F
    return 4 * (W * (W + 1) + W * (C1 | 1) + 2 * W * (D | 1) + D * (C1 + 1) + 9 * D + W
                + (W * C1 + 3) // 4)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k2_plans_take_every_shape_the_per_node_kernel_took(W):
    """Over every D in 1..64 and F in 0..64, each shape whose per-node K2
    layout fitted 227 KB fits one of K2's plans (ops/bn.py::_bn_bwd_bytes,
    reckoned on the whole grid at once), and the wrapper's plan check passes
    on the 16 taken shapes that leave the least room and on D in {1, 5, 14,
    16, 17, 33, 64}, F in {0, 3, 20, 64}."""
    D, F = np.meshgrid(np.arange(1, 65), np.arange(0, 65), indexing="ij")
    took = _per_node_k2_bytes(W, D, F) <= tbn.SMEM_BYTES
    least = np.min([tbn._bn_bwd_bytes(W, D, F, p) for p in tbn._BN_BWD_PLANS], axis=0)
    refused = took & (least > tbn.SMEM_BYTES)
    assert not refused.any(), (
        f"{int(refused.sum())} shapes refused, e.g. (D, F) = "
        f"{tuple(int(v[refused][0]) for v in (D, F))}")
    assert took.sum() > 100
    room = np.where(took, tbn.SMEM_BYTES - least, np.iinfo(np.int64).max).ravel()
    for i in np.argsort(room, kind="stable")[:16]:
        tbn._check_bn_bwd_plan(W, int(D.ravel()[i]), int(F.ravel()[i]))
    for d, f in itertools.product((1, 5, 14, 16, 17, 33, 64), (0, 3, 20, 64)):
        if _per_node_k2_bytes(W, d, f) <= tbn.SMEM_BYTES:
            tbn._check_bn_bwd_plan(W, d, f)


def test_k2_raises_above_its_last_plan(monkeypatch):
    """A shape that not even K2's leanest staged plan fits (W 128, D 64, the
    least such F) takes the wide plan (index 2, its bytes); one arc-label
    column fewer the leanest staged plan. Both pass every check of the
    wrapper on meta tensors and stop only where the library would be loaded
    for the launch."""
    last = tbn._BN_BWD_PLANS[-1]
    f = next(f for f in range(0, 512) if tbn._bn_bwd_bytes(128, 64, f, last) > tbn.SMEM_BYTES)
    need, plan = tbn._bn_bwd_plan(128, 64, f)
    assert plan == len(tbn._BN_BWD_PLANS) and need == tbn._bn_bwd_wide(128, 64, f)[0]
    assert tbn._bn_bwd_plan(128, 64, f - 1)[1] == len(tbn._BN_BWD_PLANS) - 1

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)

    def no_library():
        raise ValueError("launch reached")
    monkeypatch.setattr(tbn._build, "library", no_library)
    for width in (f, f - 1):
        R, W, D, C = 2, 128, 64, 2 * 64 + width + 1
        rows = [meta(R, W, D) for _ in range(3)]
        with pytest.raises(ValueError, match="launch reached"):
            tbn._launch_backward(meta(R, W, W), None, *rows, None, meta(R, W, width),
                                 meta(D, C), meta(R, W, D), meta(R, W, D), meta(9, D), meta(),
                                 meta(R, W), activation="selu", alpha_drop=True, rate=0.0)
        tbn._check_bn_bwd_plan(128, 64, width)


def test_k2_fits_its_ctas_at_the_flagship():
    """At the flagship's widths (W 128, D 14, F 3) K2 takes its first plan
    (the row lists, the rows staged) in at most 74 KB, so three CTAs fit an
    SM's 228 KB (1 KB kept a CTA), against the per-node kernel's two."""
    need, plan = tbn._bn_bwd_plan(128, 14, 3)
    assert plan == 0 and 3 * (need + 1024) <= 228 * 1024
    assert 2 * (_per_node_k2_bytes(128, 14, 3) + 1024) <= 228 * 1024 < 3 * (
        _per_node_k2_bytes(128, 14, 3) + 1024)
