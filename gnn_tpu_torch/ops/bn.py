"""BatchNorm-training propagation kernels K1/K2 of a one-layer state net and
K14/K15 of a two-layer one (counterpart of gnn_tpu/ops/pallas_bn.py).

A state net with a trailing BatchNorm couples every block each iteration
through the batch moments, so training runs one kernel launch per iteration
with [D]-sized glue between launches:

    for k in 1..K:
      y_k, agg_k, marg_k, msum_k = K1 (bn_forward_step)
      mean/var -> affine_k                                  (glue, [2, D])

K1 takes the previous two pre-BN activations and their affines, normalizes
them at load, tests movement, aggregates over the block adjacency (plus the
residual term), applies the input dropout to x3 = [s | agg | feats] and the
bias-augmented dense w_aug = [Ws | Wa | Wf | b], and returns the pre-BN
activation and per-block moment partials. K2 (bn_backward_step) runs one
reverse iteration with the BatchNorm backward folded in from [9, D]
coefficient rows, and returns per-block dw and reduction partials. K14
(bn2_forward_step) and K15 (bn2_backward_step) are the same with a hidden
layer: w0_aug = [Ws | Wa | Wf | b0] [H1, 2D+F+1], act0, then w1 [D, H1], b1
and act1; K15 returns per-block dw0, dw1 and db1 partials.
`bn_train_loop` is the K-iteration loop of either depth as one
torch.autograd.Function, with [T, D] moments and affines per node type (T = 1
here; ops/typed.py runs the same loop over K16/K17 for composite models);
`bn_train_propagate` drives it for models/core.py.

Layout: node-major blocks [R, W, D] over the rows [loop blocks | dep blocks]
of a fused-layout batch, the order hybrid_operands uses, or over every block
in order (the all-dep layout of graphs/batch.py: no loop rows, adj_loop
None, Bl = 0). The kernels read the two block adjacencies adjT[b, src, dst]
where they lie (row r < Bl in adj_loop, the rest in adj_dep), so no copy of
the adjacency is made. Padded loop rows carry node mask 0, so moments, flags
and gradients ignore them.
Keep-masks are uint8 [R, W, 2D+F] in x3 column order.

On a bf16 block adjacency (gnn_tpu's `hp = False` branch) a one-layer
state net runs K1_bf16 (`bn_forward_step_bf16`) and K2_bf16
(`bn_backward_step_bf16`, ops/csrc/bn_bf16.cu): the aggregation over bf(s),
the dense layer over bf([x3 | 1]) and bf(w_aug) (the bias column through
bf16), dx2 = bf(dh) @ bf(w_aug[:, :2D]) and the aggregation's reverse over
bf(dagg), all with f32 sums, dw the unrounded f32 product. A two-layer one
runs K14_bf16 (`bn2_forward_step_bf16`) and K15_bf16
(`bn2_backward_step_bf16`, ops/csrc/bn2_bf16.cu): the first layer as
K1_bf16's H1 wide, then h1 = bf(y0) @ bf(w1) + b1; in the reverse dy0 =
bf(dh1) @ bf(w1), dx2 = bf(dh0) @ bf(w0_aug[:, :2D]), dw0 and dw1 the
unrounded f32 products. Their plain versions sum in the CUDA-core kernels'
order (ops/fused2.py's bf16 helpers, the block sums node by node);
K15_bf16 runs its contraction on bf16 tensor-core tiles (ops/csrc/
mma_bf16.cuh; the weights rounded and zero-padded once a call by
`bn2_bf16_tiles`), which add in their own order, so it is held to its
plain version by Part B's gate and not bit for bit. BNLoopOperands picks
them by the adjacency's dtype. The moment glue and the residual term run
in float64 rounded once (`BNLoopOperands.acc`).

Each wrapper runs its plain PyTorch version (`*_ref`) for CPU tensors and
launches the CUDA kernel (ops/csrc/bn_fwd.cu, bn_train.cu, bn2_fwd.cu,
bn2_train.cu, bn_bf16.cu, bn2_bf16.cu) for CUDA tensors; it never falls back
from one to the other.
`launches` counts kernel launches. K1 and K2 take the first of their staged
shared-memory plans that fits a CTA, else their wide plan, which takes every
D and F with x3 and the [W][D]-sized rows in a device-memory workspace that
the wrapper allocates (`_bn_plan`, `_bn_fwd_wide`, `_bn_bwd_wide`); K14/K15
likewise take every D, F and H1 (their staged plans D and F up to 64, then
tile2.cuh's wide plan: `_smem2_bytes`, fused2._tile2_plan).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gnn_tpu_torch.ops import _build, fused2
from gnn_tpu_torch.ops.fold import fold_features, in_kernel_order, initial_state, kernel_columns
from gnn_tpu_torch.ops.fused import (_ACT_CODE, _ACTS, FUSABLE_ACTIVATIONS, SMEM_BYTES,
                                     _act_grad, _check, _check_fits, _check_keep, _drop_args,
                                     _first_plan, _make_drop, _plan_info, _ptr, _r4, _stream,
                                     _Workspace, moved, supports_fused_train)
from gnn_tpu_torch.ops.fused2 import _dense2_vjp, _tile2_plan, dense2
from gnn_tpu_torch.ops.mlp import BN_EPS, BN_MOMENTUM

# kernel launches since the last reset, by wrapper
launches = {"bn_forward_step": 0, "bn_backward_step": 0, "bn2_forward_step": 0,
            "bn2_backward_step": 0, "bn_forward_step_bf16": 0, "bn_backward_step_bf16": 0,
            "bn2_forward_step_bf16": 0, "bn2_backward_step_bf16": 0}

# coefficient rows of bnv, the [9, D] input of K2
BNV_ROWS = ("scale_prev", "shift_prev", "mean_k", "rstd_k", "gamma_rstd_k",
            "b2", "c2", "mean_prev", "rstd_prev")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supports_fused_bn_train(state_spec) -> bool:
    """K1/K2 take the spec: one dense layer, a kernel activation, dropout only
    at the input, and the trailing BatchNorm on."""
    return bool(state_spec.batch_normalization) and supports_fused_train(state_spec)


def supports_fused_bn2_train(state_spec) -> bool:
    """K14/K15 take the spec: two dense layers, kernel activations, dropout
    only at the input, and the trailing BatchNorm on."""
    return (bool(state_spec.batch_normalization) and state_spec.num_layers == 2
            and all(a in FUSABLE_ACTIVATIONS for a in state_spec.activations)
            and all(p == 0 for p in state_spec.dropout_pos))


def _affine(gamma, beta, mean, var, exact: bool = False):
    """[2, D] (scale; shift) of the training BatchNorm for given batch moments:
    y * scale + shift == (y - mean) * rsqrt(var + eps) * gamma + beta. With
    `exact` it is evaluated in float64 with IEEE-rounded square root and
    division and rounded to f32 once: the same bits on every device (the
    card's f32 rsqrt may differ from the CPU's in the last bit)."""
    if exact:
        scale = gamma.double() / torch.sqrt(var.double() + BN_EPS)
        return torch.stack([scale, beta.double() - mean.double() * scale]).float()
    scale = gamma * torch.rsqrt(var + BN_EPS)
    return torch.stack([scale, beta - mean * scale])


def _rstd(var, exact: bool = False):
    """rsqrt(var + eps), with `exact` as _affine's."""
    if exact:
        return (1.0 / torch.sqrt(var.double() + BN_EPS)).float()
    return torch.rsqrt(var + BN_EPS)


def _ident_aff(D, like):
    return torch.stack([torch.ones(D, dtype=like.dtype, device=like.device),
                        torch.zeros(D, dtype=like.dtype, device=like.device)])


# ------------------------------------------------------------ plain versions
def _by_block_set(adj_loop, adj_dep, x, fn):
    """fn(adjT, rows) over the loop rows [0, Bl) and the dep rows, either set
    None when it has no rows, concatenated."""
    Bl = 0 if adj_loop is None else adj_loop.shape[0]
    parts = [fn(a, r) for a, r in ((adj_loop, x[:Bl]), (adj_dep, x[Bl:])) if a is not None]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _agg_blocks(adj_loop, adj_dep, s):
    """agg[b, dst] = sum_src adjT[b, src, dst] * s[b, src] over both block sets."""
    return _by_block_set(adj_loop, adj_dep, s, lambda a, x: torch.matmul(a.transpose(1, 2), x))


def _contract_dst(adj_loop, adj_dep, g):
    """out[b, src] = sum_dst adjT[b, src, dst] * g[b, dst] (reverse of _agg_blocks)."""
    return _by_block_set(adj_loop, adj_dep, g, torch.matmul)


def _x3(s, agg, feats, keep, alpha_drop: bool, rate: float):
    """The dense input [s | agg | feats] after the input dropout, [R, W, 2D+F]."""
    drop, _ = _make_drop(alpha_drop, rate)
    return drop(torch.cat([s, agg, feats], dim=-1), keep)


def _ones_col(x3):
    """[x3 | 1]: the bias-augmented dense input."""
    return torch.cat([x3, torch.ones_like(x3[..., :1])], -1)


def _bn_forward(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, nm, dense, alpha_drop, rate,
                threshold):
    """One BN-training iteration with the state net `dense` (x3 -> y)."""
    s = y1 * aff[0, 0] + aff[0, 1]
    s_old = y2 * aff[1, 0] + aff[1, 1]
    marg = moved(s, s_old, threshold) * nm
    agg = _agg_blocks(adj_loop, adj_dep, s)
    if rT is not None:
        agg = agg + rT
    y = dense(_x3(s, agg, feats, keep, alpha_drop, rate))
    return y, agg, marg, torch.sum(y * nm[..., None], dim=1)


def bn_forward_step_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, *,
                        activation: str, alpha_drop: bool, rate: float, threshold: float):
    """Plain PyTorch K1. Returns (y [R, W, D] pre-BN activation, agg [R, W, D]
    (with the residual term, before the dropout), marg [R, W] movement flags
    times nm, msum [R, D] per-block sums of y * nm)."""
    return _bn_forward(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, nm,
                       lambda x3: _ACTS[activation](F.linear(x3, w_aug[:, :-1], w_aug[:, -1])),
                       alpha_drop, rate, threshold)


def bn2_forward_step_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1, nm,
                         *, act0: str, act1: str, alpha_drop: bool, rate: float,
                         threshold: float):
    """Plain PyTorch K14: K1 with the two-layer state net
    act1(w1 @ act0(w0_aug @ [x3; 1]) + b1). Returns as bn_forward_step_ref."""
    return _bn_forward(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, nm,
                       lambda x3: dense2(x3, w0_aug[:, :-1], w0_aug[:, -1], w1, b1, act0, act1),
                       alpha_drop, rate, threshold)


def _bn_gy(y_k, ds_in, gsel, bnv, flag, nm):
    """The pre-BN activation's cotangent from the state cotangent and the
    BatchNorm backward coefficients (BNV_ROWS)."""
    xk = (y_k - bnv[2]) * bnv[3]
    return bnv[4] * (ds_in + flag * gsel) - nm[..., None] * (bnv[5] + xk * bnv[6])


def _bn_ds(adj_loop, adj_dep, dx2, keep, alpha_drop: bool, rate: float,
           contract=_contract_dst):
    """(ds, dagg) from the cotangent dx2 [R, W, 2D] of the dense input's
    state and aggregated slices: through the dropout's derivative and the
    aggregation's reverse `contract`."""
    D = dx2.shape[-1] // 2
    dxs, dagg = dx2[..., :D], dx2[..., D:]
    if rate > 0.0:
        dm = _make_drop(alpha_drop, rate)[1](keep)
        dxs, dagg = dxs * dm[..., :D], dagg * dm[..., D:2 * D]
    return dxs + contract(adj_loop, adj_dep, dagg), dagg


def _red(ds, xp_hat):
    """Per-block reduction partials [R, 2, D]: (sum ds, sum ds * x_hat_prev)."""
    return torch.stack([torch.sum(ds, dim=1), torch.sum(ds * xp_hat, dim=1)], dim=1)


def bn_backward_step_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in,
                         gsel, bnv, flag, nm, *, activation: str, alpha_drop: bool,
                         rate: float, act_grad=_act_grad):
    """Plain PyTorch K2: one reverse iteration with the BatchNorm backward
    folded in. `bnv` [9, D] holds the rows named in BNV_ROWS; `flag` (0-d)
    gates the state cotangent `gsel` in. Returns (ds [R, W, D], dw [R, D, C]
    per-block partials of the w_aug cotangent, dagg [R, W, D], red [R, 2, D]
    per-block (sum ds, sum ds * x_hat_prev)). act_grad (name, h) is the
    activation's derivative."""
    D = y_prev.shape[-1]
    x3 = _x3(y_prev * bnv[0] + bnv[1], agg, feats, keep, alpha_drop, rate)
    h = F.linear(x3, w_aug[:, :-1], w_aug[:, -1])
    dh = _bn_gy(y_k, ds_in, gsel, bnv, flag, nm) * act_grad(activation, h)
    dw = torch.matmul(dh.transpose(1, 2), _ones_col(x3))
    ds, dagg = _bn_ds(adj_loop, adj_dep, torch.matmul(dh, w_aug[:, :2 * D]), keep, alpha_drop,
                      rate)
    return ds, dw, dagg, _red(ds, (y_prev - bnv[7]) * bnv[8])


def bn2_backward_step_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1,
                          ds_in, gsel, bnv, flag, nm, *, act0: str, act1: str, alpha_drop: bool,
                          rate: float, act_grad=_act_grad):
    """Plain PyTorch K15: K2 with the two-layer state net. Returns (ds
    [R, W, D], dw0 [R, H1, C] per-block partials of the w0_aug cotangent (db0
    its last column), dw1 [R, D, H1], db1 [R, D], dagg [R, W, D], red
    [R, 2, D]). act_grad as fused2._dense2_vjp's (act1, then act0)."""
    D = y_prev.shape[-1]
    x3 = _x3(y_prev * bnv[0] + bnv[1], agg, feats, keep, alpha_drop, rate)
    dx3, dw0, db0, dw1, db1, _ = _dense2_vjp(x3, w0_aug[:, :-1], w0_aug[:, -1], w1, b1,
                                             _bn_gy(y_k, ds_in, gsel, bnv, flag, nm), act0, act1,
                                             act_grad=act_grad)
    ds, dagg = _bn_ds(adj_loop, adj_dep, dx3[..., :2 * D], keep, alpha_drop, rate)
    return (ds, torch.cat([dw0, db0[..., None]], dim=-1), dw1, db1, dagg,
            _red(ds, (y_prev - bnv[7]) * bnv[8]))


# ------------------------------------------- bf16 adjacency: plain versions
def _agg_bf16(adj_loop, adj_dep, s):
    """agg[b, dst] = sum_src adjT[b, src, dst] * bf(s[b, src]), the sources
    ascending (fused2._exact_adj), over both block sets."""
    return _by_block_set(adj_loop, adj_dep, s, lambda a, x: fused2._exact_adj(
        fused2._adj_slots(a.float()), fused2._bf("s", x)))


def _contract_bf16(adj_loop, adj_dep, g):
    """out[b, src] = sum_dst adjT[b, src, dst] * bf(g[b, dst]), the
    destinations ascending: _agg_bf16's reverse, rounding point dagg."""
    return _by_block_set(adj_loop, adj_dep, g, lambda a, x: fused2._exact_adj(
        fused2._adj_slots(a.float().transpose(1, 2)), fused2._bf("dagg", x)))


def _dense_bf16(x3, w_aug, D: Optional[int] = None):
    """h = bf([x3 | 1]) @ bf(w_aug)^T summed over the columns ascending, the
    bias last (fused2._exact_dot). x3's slices round at the points x3s (the
    state, D wide: w_aug's rows unless given), agg (the aggregation, a sum of
    the card's order) and x3f (the features)."""
    D = w_aug.shape[0] if D is None else D
    xb = torch.cat([fused2._bf("x3s", x3[..., :D]), fused2._bf("agg", x3[..., D:2 * D]),
                    fused2._bf("x3f", x3[..., 2 * D:]), torch.ones_like(x3[..., :1])], -1)
    return fused2._exact_dot(xb, fused2._bf("w", w_aug))


def bn_forward_step_bf16_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, *,
                             activation: str, alpha_drop: bool, rate: float, threshold: float):
    """Plain PyTorch K1_bf16 (gnn_tpu's _bn_fwd_kernel with hp false): K1 with
    the aggregation over bf(s) and the dense layer over bf([x3 | 1]) and
    bf(w_aug), the bias column through bf16; every sum in the kernel's order,
    the activation in float64 (fused2.act64). Returns as bn_forward_step_ref."""
    s = y1 * aff[0, 0] + aff[0, 1]
    s_old = y2 * aff[1, 0] + aff[1, 1]
    marg = moved(s, s_old, threshold) * nm
    agg = _agg_bf16(adj_loop, adj_dep, s)
    if rT is not None:
        agg = agg + rT
    y = fused2.act64(activation, _dense_bf16(_x3(s, agg, feats, keep, alpha_drop, rate), w_aug))
    return y, agg, marg, fused2.node_sum(y * nm[..., None])


def bn_backward_step_bf16_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in,
                              gsel, bnv, flag, nm, *, activation: str, alpha_drop: bool,
                              rate: float):
    """Plain PyTorch K2_bf16 (gnn_tpu's _bn_bwd_kernel with hp false): h
    recomputed with K1_bf16's rounding, dw the f32 product dh^T @ [x3 | 1]
    (gnn_tpu's _BDT_HI, unrounded), dx2 = bf(dh) @ bf(w_aug[:, :2D]) and the
    aggregation's reverse over bf(dagg); every sum in the kernel's order.
    Returns as bn_backward_step_ref."""
    D = y_prev.shape[-1]
    x3 = _x3(y_prev * bnv[0] + bnv[1], agg, feats, keep, alpha_drop, rate)
    h = _dense_bf16(x3, w_aug)
    dh = _bn_gy(y_k, ds_in, gsel, bnv, flag, nm) * fused2.act_grad64(activation, h)
    x3a = _ones_col(x3)
    dw = fused2.node_outer(dh, x3a)
    dx2 = fused2._exact_dot(fused2._bf("dh", dh), fused2._bf("w", w_aug[:, :2 * D]).t())
    ds, dagg = _bn_ds(adj_loop, adj_dep, dx2, keep, alpha_drop, rate, _contract_bf16)
    xp_hat = (y_prev - bnv[7]) * bnv[8]
    return ds, dw, dagg, torch.stack([fused2.node_sum(ds), fused2.node_sum(ds * xp_hat)], dim=1)


def _dense2_bf16(x3, w0_aug, w1, b1, act0: str):
    """(h0, y0, h1) of a two-layer bf16 BN iteration from its f32 dense input
    x3: h0 = bf([x3 | 1]) @ bf(w0_aug)^T, y0 = act0(h0), h1 = bf(y0) @
    bf(w1)^T + b1 (gnn_tpu's _mm_packed and _dense1_fm with hp false)."""
    h0 = _dense_bf16(x3, w0_aug, w1.shape[0])
    y0 = fused2.act64(act0, h0)
    return h0, y0, fused2._exact_dot(fused2._bf("y0", y0), fused2._bf("w1", w1)) + b1


def bn2_forward_step_bf16_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1,
                              nm, *, act0: str, act1: str, alpha_drop: bool, rate: float,
                              threshold: float):
    """Plain PyTorch K14_bf16 (gnn_tpu's _bn2_fwd_kernel with hp false): K1_bf16
    with the two-layer state net, h0 = bf([x3 | 1]) @ bf(w0_aug)^T, y0 =
    act0(h0), h1 = bf(y0) @ bf(w1)^T + b1, y = act1(h1); every sum in the
    kernel's order, the activations in float64 (fused2.act64). Returns as
    bn_forward_step_ref."""
    s = y1 * aff[0, 0] + aff[0, 1]
    s_old = y2 * aff[1, 0] + aff[1, 1]
    marg = moved(s, s_old, threshold) * nm
    agg = _agg_bf16(adj_loop, adj_dep, s)
    if rT is not None:
        agg = agg + rT
    _, _, h1 = _dense2_bf16(_x3(s, agg, feats, keep, alpha_drop, rate), w0_aug, w1, b1, act0)
    y = fused2.act64(act1, h1)
    return y, agg, marg, fused2.node_sum(y * nm[..., None])


def bn2_backward_step_bf16_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1,
                               ds_in, gsel, bnv, flag, nm, *, act0: str, act1: str,
                               alpha_drop: bool, rate: float):
    """Plain PyTorch K15_bf16 (gnn_tpu's _bn2_bwd_kernel with hp false): h0, y0
    and h1 recomputed with K14_bf16's rounding, dh1 = gy * act1'(h1), dy0 =
    bf(dh1) @ bf(w1), dh0 = dy0 * act0'(h0), dx2 = bf(dh0) @ bf(w0_aug[:, :2D])
    and the aggregation's reverse over bf(dagg) (rounding points dh1, dh0,
    dagg); dw1 of y0, dw0 of [x3 | 1] (both unrounded: gnn_tpu's _BDT_HI) and
    db1 summed node by node. Returns as bn2_backward_step_ref."""
    D = y_prev.shape[-1]
    x3 = _x3(y_prev * bnv[0] + bnv[1], agg, feats, keep, alpha_drop, rate)
    h0, y0, h1 = _dense2_bf16(x3, w0_aug, w1, b1, act0)
    dh1 = _bn_gy(y_k, ds_in, gsel, bnv, flag, nm) * fused2.act_grad64(act1, h1)
    dy0 = fused2._exact_dot(fused2._bf("dh1", dh1), fused2._bf("w1", w1).t())
    dh0 = dy0 * fused2.act_grad64(act0, h0)
    dx2 = fused2._exact_dot(fused2._bf("dh0", dh0), fused2._bf("w", w0_aug[:, :2 * D]).t())
    ds, dagg = _bn_ds(adj_loop, adj_dep, dx2, keep, alpha_drop, rate, _contract_bf16)
    xp_hat = (y_prev - bnv[7]) * bnv[8]
    return (ds, fused2.node_outer(dh0, _ones_col(x3)), fused2.node_outer(dh1, y0),
            fused2.node_sum(dh1), dagg,
            torch.stack([fused2.node_sum(ds), fused2.node_sum(ds * xp_hat)], dim=1))


# ------------------------------------------------------------------ wrappers
# bn_fwd.cu's kBnFwdPlans, K1's staged shared-memory plans in order of
# preference: (threads a CTA, room of the column lists, keep bytes staged).
# The first is the flagship's; the wide plan (_bn_fwd_wide) follows them.
_BN_FWD_PLANS = ((256, 16, 1), (128, 0, 0))
# bn_train.cu's kBnBwdPlans, K2's: (threads a CTA, room of the row lists,
# rows and keep bytes staged), likewise (_bn_bwd_wide).
_BN_BWD_PLANS = ((256, 16, 1), (128, 0, 0))


def _bn_fwd_bytes(W, D, F, plan):
    """Shared memory of bn_fwd.cu::fwd_layout: x3 [C1][W], w_aug transposed
    [C1 + 1][D rounded up to 4], the affines [4][D], nm [W], the row buffer
    [W][D|1]; staged, the keep bytes; the column lists ([E][W] floats, then W
    counts, E*W sources and the list build's counts [threads / 32][W] as
    bytes); each region a multiple of 16 bytes. The widths may be ints or
    numpy integer arrays."""
    nt, E, st = plan
    C1 = 2 * D + F
    floats = (_r4(C1 * W) + (C1 + 1) * _r4(D) + _r4(4 * D) + _r4(W) + _r4(W * (D | 1))
              + st * _r4((W * C1 + 3) // 4) + E * W)
    return 4 * floats + ((W + E * W + nt // 32 * W) if E else 0)


def _bn_bwd_bytes(W, D, F, plan):
    """Shared memory of bn_train.cu::bwd_layout: x3 [C1][W], dh [D][W], w_aug
    transposed [C][D rounded up to 4], bnv [9][D], nm [W]; staged, y_prev [W][D] and the keep bytes;
    the late region (ds_in, gsel, y_k, or dagg [W][D|1] and, staged, the
    partials of the 8 node ranges);
    the row lists ([E][W] floats, W counts and E*W destinations as bytes);
    each region a multiple of 16 bytes. The widths may be ints or numpy
    integer arrays."""
    nt, E, st = plan
    C1 = 2 * D + F
    C = C1 + 1
    floats = _r4(C1 * W) + _r4(D * W) + C * _r4(D) + _r4(9 * D) + _r4(W)
    if st:
        floats = floats + _r4(W * D) + _r4((W * C1 + 3) // 4)
    part = st * 8 * D * C           # the partials of 8 node ranges (D * C >= 2D)
    floats = floats + np.maximum(st * 3 * _r4(W * D), _r4(W * (D | 1)) + _r4(part)) + E * W
    return 4 * floats + (W + E * W if E else 0)


def _bn_fwd_wide(W, D, F):
    """(shared-memory bytes, workspace floats a block row) of bn_fwd.cu's wide
    plan (256 threads, 16-entry lists): nm [W] and the column lists in shared
    memory (floats, then W counts, 16*W sources and the list build's counts
    [8][W] as bytes); x3 [C1][W] and the row buffer [W][D|1] in the
    workspace. The widths may be ints or numpy integer arrays."""
    return 4 * (_r4(W) + 16 * W) + W + 16 * W + 8 * W, _r4((2 * D + F) * W) + _r4(W * (D | 1))


def _bn_bwd_wide(W, D, F):
    """(shared-memory bytes, workspace floats a block row) of bn_train.cu's
    wide plan (256 threads, 16-entry lists): nm [W] and the row lists in
    shared memory (floats, then W counts and 16*W destinations as bytes); x3
    [C1][W], dh [D][W] and dagg [W][D|1] in the workspace."""
    return (4 * (_r4(W) + 16 * W) + W + 16 * W,
            _r4((2 * D + F) * W) + _r4(D * W) + _r4(W * (D | 1)))


# K1's and K2's staged plan lists, their layouts' bytes (W, D, F, plan) and
# their wide plans
_BN_PLANS = {"K1": (_BN_FWD_PLANS, _bn_fwd_bytes, _bn_fwd_wide),
             "K2": (_BN_BWD_PLANS, _bn_bwd_bytes, _bn_bwd_wide)}


def _bn_plan(kernel: str, W: int, D: int, F: int):
    """(shared-memory bytes, plan index) K1 or K2 takes at this shape
    (fused._first_plan; the wide plan is index 2)."""
    plans, nbytes, wide = _BN_PLANS[kernel]
    return _first_plan(plans, nbytes, W, D, F, wide=wide)


def _bn_bwd_plan(W: int, D: int, F: int):
    return _bn_plan("K2", W, D, F)


def _check_bn_plan(kernel: str, W: int, D: int, F: int) -> None:
    """Raise before any launch at a shape no plan of K1 or K2 fits."""
    _check_fits(*_bn_plan(kernel, W, D, F), f"W={W}, D={D}, F={F}")


def _check_bn_bwd_plan(W: int, D: int, F: int) -> None:
    _check_bn_plan("K2", W, D, F)


def forward_info(W: int, D: int, F: int) -> dict:
    """fused._plan_info of K1 (gnn_bn_forward)."""
    return _plan_info("gnn_bn_forward", W, D, F)


def backward_info(W: int, D: int, F: int) -> dict:
    """fused._plan_info of K2 (gnn_bn_backward)."""
    return _plan_info("gnn_bn_backward", W, D, F)


def _check_blocks(adj_loop, adj_dep, R):
    """(Bl, W) after checking the two adjacencies (either None: no rows of
    that set) against R block rows."""
    adj = adj_loop if adj_loop is not None else adj_dep
    if adj is None:
        raise ValueError("the BatchNorm kernels need a block adjacency")
    W, W2 = adj.shape[-2:]
    if W != W2 or W % 32 or not 32 <= W <= 128:
        raise ValueError(f"block width must be 32, 64, 96 or 128, got adjT {tuple(adj.shape)}")
    dev = adj.device
    Bl = Bd = 0
    if adj_loop is not None:
        Bl = adj_loop.shape[0]
        _check("adj_loop", adj_loop, (Bl, W, W), dev)
    if adj_dep is not None:
        Bd = adj_dep.shape[0]
        _check("adj_dep", adj_dep, (Bd, W, W), dev)
    if R != Bl + Bd:
        raise ValueError(f"{R} block rows, but the adjacencies hold {Bl} + {Bd}")
    return Bl, W


def _require_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"BN training kernels need CPU or CUDA tensors, got {t.device}")


def bn_forward_step(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, *,
                    activation: str, alpha_drop: bool, rate: float, threshold: float):
    """K1: one BN-training iteration over every block row.

    :param adj_loop / adj_dep: [Bl, W, W] / [Bd, W, W] (or None) transposed
        block adjacencies of rows [0, Bl) and [Bl, Bl + Bd).
    :param y1 / y2: [R, W, D] the two previous pre-BN activations.
    :param aff: [2, 2, D] their (scale; shift) affines.
    :param keep: uint8 [R, W, 2D+F] input keep-mask (None when rate == 0).
    :param rT: [R, W, D] residual term (normalized, weighted, summed), or None.
    :param feats: [R, W, F] loop-invariant feature rows; w_aug: [D, 2D+F+1].
    :param nm: [R, W] float node mask.
    Returns (y [R, W, D], agg [R, W, D], marg [R, W], msum [R, D]).
    """
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate, threshold=threshold)
    if y1.device.type == "cpu":
        return bn_forward_step_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm,
                                   **kw)
    _require_cuda(y1)
    return _launch_forward(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, **kw)


def _launch_forward(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, *,
                    activation, alpha_drop, rate, threshold):
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    Bl, W = _check_blocks(adj_loop, adj_dep, R)
    _check_bn_plan("K1", W, D, Fd)
    dev = y1.device
    _check("w_aug", w_aug, (D, 2 * D + Fd + 1), dev)
    keep, (y, agg, marg, msum) = _forward_operands(y1, y2, aff, keep, rT, feats, nm, W, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        ws = _Workspace(R, W, D, Fd).allocate(lib, "bn_forward", dev)
        err = lib.gnn_bn_forward(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y1), _ptr(y2), _ptr(aff), _ptr(keep), _ptr(rT),
            _ptr(feats), _ptr(w_aug), _ptr(nm), _ptr(y), _ptr(agg), _ptr(marg), _ptr(msum),
            R, Bl, W, D, Fd, float(threshold), _ACT_CODE[activation], mode, a, b, _stream(dev),
            _ptr(ws))
    _build.check(err, "bn_forward_step (K1)")
    launches["bn_forward_step"] += 1
    return y, agg, marg, msum


def _forward_operands(y1, y2, aff, keep, rT, feats, nm, W: int, rate: float):
    """K1's (K1_bf16's, K14_bf16's) operands but the adjacency and the weights
    checked: (the keep-mask, the outputs (y, agg, marg, msum) allocated)."""
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    dev = y1.device
    for name, t in (("y1", y1), ("y2", y2), ("rT", rT)):
        if t is not None:
            _check(name, t, (R, W, D), dev)
    _check("aff", aff, (2, 2, D), dev)
    _check("feats", feats, (R, W, Fd), dev)
    _check("nm", nm, (R, W), dev)
    keep = _check_keep(keep, (R, W, 2 * D + Fd), dev, rate)
    y = torch.empty((R, W, D), dtype=torch.float32, device=dev)
    return keep, (y, torch.empty_like(y), torch.empty((R, W), dtype=torch.float32, device=dev),
                  torch.empty((R, D), dtype=torch.float32, device=dev))


def bn_backward_step(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel,
                     bnv, flag, nm, *, activation: str, alpha_drop: bool, rate: float):
    """K2: one reverse BN-training iteration over every block row.

    :param y_prev / y_k / agg: [R, W, D] the forward's pre-BN activations of
        iterations k-1 and k and the aggregation of k.
    :param ds_in: [R, W, D] the state cotangent from iteration k+1.
    :param gsel: [R, W, D] the returned state's cotangent, added when `flag`
        (a 0-d float tensor on the device) is 1.
    :param bnv: [9, D] BatchNorm coefficients (BNV_ROWS).
    Other arguments as bn_forward_step. Returns (ds [R, W, D], dw [R, D, C],
    dagg [R, W, D], red [R, 2, D]), dw and red per block row.
    """
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if y_prev.device.type == "cpu":
        return bn_backward_step_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug,
                                    ds_in, gsel, bnv, flag, nm, **kw)
    _require_cuda(y_prev)
    return _launch_backward(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in,
                            gsel, bnv, flag, nm, **kw)


def _launch_backward(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel,
                     bnv, flag, nm, *, activation, alpha_drop, rate):
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    Bl, W = _check_blocks(adj_loop, adj_dep, R)
    _check_bn_plan("K2", W, D, Fd)
    dev = y_prev.device
    _check("w_aug", w_aug, (D, 2 * D + Fd + 1), dev)
    keep, (ds, dagg, red) = _backward_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv,
                                               flag, nm, W, rate)
    dw = torch.empty((R, D, 2 * D + Fd + 1), dtype=torch.float32, device=dev)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        ws = _Workspace(R, W, D, Fd).allocate(lib, "bn_backward", dev)
        err = lib.gnn_bn_backward(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y_prev), _ptr(y_k), _ptr(agg), _ptr(keep),
            _ptr(feats), _ptr(w_aug), _ptr(ds_in), _ptr(gsel), _ptr(bnv), _ptr(flag), _ptr(nm),
            _ptr(ds), _ptr(dw), _ptr(dagg), _ptr(red), R, Bl, W, D, Fd,
            _ACT_CODE[activation], mode, a, b, _stream(dev), _ptr(ws))
    _build.check(err, "bn_backward_step (K2)")
    launches["bn_backward_step"] += 1
    return ds, dw, dagg, red


def _backward_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv, flag, nm, W: int,
                       rate: float):
    """K2's (K2_bf16's, K15_bf16's) operands but the adjacency and the weights
    checked: (the keep-mask, the outputs (ds, dagg, red) allocated)."""
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    C = 2 * D + Fd + 1
    dev = y_prev.device
    for name, t in (("y_prev", y_prev), ("y_k", y_k), ("agg", agg), ("ds_in", ds_in),
                    ("gsel", gsel)):
        _check(name, t, (R, W, D), dev)
    _check("feats", feats, (R, W, Fd), dev)
    _check("bnv", bnv, (len(BNV_ROWS), D), dev)
    _check("flag", flag, (), dev)
    _check("nm", nm, (R, W), dev)
    keep = _check_keep(keep, (R, W, C - 1), dev, rate)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return keep, (out(R, W, D), out(R, W, D), out(R, 2, D))


def bn_bf16_smem_bytes(W: int, D: int, F: int) -> int:
    """Shared memory of a K1_bf16 / K2_bf16 CTA (ops/csrc/bn_bf16.cu::
    bn_bf16_smem): the bf16 adjacency [W][W], x3 [W][2D+F] and three rows
    [W][D] of floats."""
    return 2 * W * W + 4 * W * (5 * D + F)


def bn2_bf16_layout(W: int, D: int, F: int):
    """(SC, dg_in_x3, bytes) of K15_bf16's CTA (ops/csrc/bn2_bf16.cu::
    bn2_bwd_bf16_layout): f32 x3a = [x3 | 1] [W][C | 1] (C = 2D + F + 1, the
    row stride made odd), h1 then dh1 [W][D] and dx2 [W][2D], then a region
    that holds y0 and dh0 of a sub-chunk of SC hidden units [W][SC] in f32
    and, at the end, the bf16 adjacency [W][W+8] and bf(dagg)
    [W][pad16(D)+8] (the latter in x3a's region where it fits there); SC is
    32 where the CTA then fits SMEM_BYTES, else 16."""
    xs = (2 * D + F + 1) | 1
    rows = 4 * W * (xs + 3 * D)
    dg, adj = 2 * W * (fused2.pad16(D) + 8), 2 * W * (W + 8)
    dg_in_x3 = dg <= 4 * W * xs
    tail = adj + (0 if dg_in_x3 else dg)
    for sc in (32, 16):
        nbytes = rows + max(8 * W * sc, tail)
        if nbytes <= SMEM_BYTES:
            break
    return sc, dg_in_x3, nbytes


def bn2_bf16_smem_bytes(kernel: str, W: int, D: int, F: int) -> int:
    """Shared memory of a K14_bf16 or K15_bf16 CTA (ops/csrc/bn2_bf16.cu::
    bn2_bf16_smem and bn2_bwd_bf16_layout): K14_bf16 the bf16 adjacency [W][W]
    and, of floats, x3 [W][2D+F], two rows [W][D] (s, h1) and a hidden chunk
    [W][32] (bf(y0)); K15_bf16 its tensor-core layout (bn2_bf16_layout). The
    hidden width runs in chunks, so it takes no room."""
    C1 = 2 * D + F
    if kernel == "K14_bf16":
        return 2 * W * W + 4 * W * (C1 + 2 * D + fused2.BF16_CHUNK)
    return bn2_bf16_layout(W, D, F)[2]


def _check_bf16_blocks(adj_loop, adj_dep, R: int, D: int, F: int, kernel: str,
                       smem=bn_bf16_smem_bytes):
    """(Bl, W) of the bf16 kernels' block rows: contiguous, 16-byte aligned
    bf16 adjacencies on the card, and the shared memory `smem`(W, D, F) of
    the widths (no wide plan: a CTA that does not fit raises)."""
    adj = adj_loop if adj_loop is not None else adj_dep
    if adj is None:
        raise ValueError("the BatchNorm kernels need a block adjacency")
    W = adj.shape[-1]
    if adj.shape[-2] != W or W % 32 or not 32 <= W <= 128:
        raise ValueError(f"block width must be 32, 64, 96 or 128, got adjT {tuple(adj.shape)}")
    Bl = 0 if adj_loop is None else adj_loop.shape[0]
    Bd = 0 if adj_dep is None else adj_dep.shape[0]
    for name, a in (("adj_loop", adj_loop), ("adj_dep", adj_dep)):
        if a is not None and (a.dtype != torch.bfloat16 or a.device != adj.device
                              or tuple(a.shape[1:]) != (W, W) or not a.is_contiguous()
                              or a.data_ptr() % 16):
            raise ValueError(f"{kernel} needs contiguous, 16-byte aligned bf16 {name} "
                             f"[B, {W}, {W}] on {adj.device}, got {a.dtype} {tuple(a.shape)}")
    if R != Bl + Bd:
        raise ValueError(f"{R} block rows, but the adjacencies hold {Bl} + {Bd}")
    need = smem(W, D, F)
    if need > SMEM_BYTES:
        raise ValueError(f"{kernel} takes widths whose CTA fits {SMEM_BYTES} bytes of shared "
                         f"memory: D={D}, F={F} at W={W} needs {need}")
    return Bl, W


def bn_forward_step_bf16(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug, nm, *,
                         activation: str, alpha_drop: bool, rate: float, threshold: float):
    """K1_bf16: one BN-training iteration over every block row of a bf16
    adjacency (gnn_tpu's _bn_fwd_kernel with hp false). Arguments and result
    as bn_forward_step's, adj_loop / adj_dep bf16."""
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate, threshold=threshold)
    if y1.device.type == "cpu":
        return bn_forward_step_bf16_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w_aug,
                                        nm, **kw)
    _require_cuda(y1)
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    Bl, W = _check_bf16_blocks(adj_loop, adj_dep, R, D, Fd, "K1_bf16")
    dev = y1.device
    _check("w_aug", w_aug, (D, 2 * D + Fd + 1), dev)
    keep, (y, agg, marg, msum) = _forward_operands(y1, y2, aff, keep, rT, feats, nm, W, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_bn_forward_bf16(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y1), _ptr(y2), _ptr(aff), _ptr(keep), _ptr(rT),
            _ptr(feats), _ptr(w_aug), _ptr(nm), _ptr(y), _ptr(agg), _ptr(marg), _ptr(msum),
            R, Bl, W, D, Fd, float(threshold), _ACT_CODE[activation], mode, a, b, _stream(dev))
    _build.check(err, "bn_forward_step_bf16 (K1_bf16)")
    launches["bn_forward_step_bf16"] += 1
    return y, agg, marg, msum


def bn_backward_step_bf16(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug, ds_in, gsel,
                          bnv, flag, nm, *, activation: str, alpha_drop: bool, rate: float):
    """K2_bf16: one reverse BN-training iteration over every block row of a
    bf16 adjacency (gnn_tpu's _bn_bwd_kernel with hp false). Arguments and
    result as bn_backward_step's, adj_loop / adj_dep bf16."""
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if y_prev.device.type == "cpu":
        return bn_backward_step_bf16_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w_aug,
                                         ds_in, gsel, bnv, flag, nm, **kw)
    _require_cuda(y_prev)
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    Bl, W = _check_bf16_blocks(adj_loop, adj_dep, R, D, Fd, "K2_bf16")
    dev = y_prev.device
    _check("w_aug", w_aug, (D, 2 * D + Fd + 1), dev)
    keep, (ds, dagg, red) = _backward_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv,
                                               flag, nm, W, rate)
    dw = torch.empty((R, D, 2 * D + Fd + 1), dtype=torch.float32, device=dev)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_bn_backward_bf16(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y_prev), _ptr(y_k), _ptr(agg), _ptr(keep),
            _ptr(feats), _ptr(w_aug), _ptr(ds_in), _ptr(gsel), _ptr(bnv), _ptr(flag), _ptr(nm),
            _ptr(ds), _ptr(dw), _ptr(dagg), _ptr(red), R, Bl, W, D, Fd,
            _ACT_CODE[activation], mode, a, b, _stream(dev))
    _build.check(err, "bn_backward_step_bf16 (K2_bf16)")
    launches["bn_backward_step_bf16"] += 1
    return ds, dw, dagg, red


def _smem2_bytes(W: int, D: int, F: int, H1: int, backward: bool) -> int:
    """Shared memory a CTA of the register-tiled K14 or K15 needs: the first
    of tile2.cuh's kBn2FwdPlans or kBn2BwdPlans that fits, or the leanest's
    (fused2._tile2_plan)."""
    return _tile2_plan(W, D, F, H1, "K15" if backward else "K14")[0]


def _check_weights2(w0_aug, w1, b1, D, F, dev):
    """H1 after checking a two-layer state net's weights w0_aug [H1, 2D+F+1],
    w1 [D, H1] and b1 [D] on `dev`."""
    H1 = w0_aug.shape[0]
    if H1 < 1:
        raise ValueError(f"hidden width H1={H1} must be positive")
    _check("w0_aug", w0_aug, (H1, 2 * D + F + 1), dev)
    _check("w1", w1, (D, H1), dev)
    _check("b1", b1, (D,), dev)
    return H1


def _check_two_layer(adj_loop, adj_dep, R, D, F, w0_aug, w1, b1):
    """(Bl, W, H1) after checking the block rows and the weights' shapes
    (K14/K15 take every D, F and H1 at W <= 128)."""
    Bl, W = _check_blocks(adj_loop, adj_dep, R)
    return Bl, W, _check_weights2(w0_aug, w1, b1, D, F, w0_aug.device)


def bn2_forward_step(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1, nm, *,
                     act0: str, act1: str, alpha_drop: bool, rate: float, threshold: float):
    """K14: one two-layer BN-training iteration over every block row.

    :param w0_aug: [H1, 2D+F+1] the first dense layer [Ws | Wa | Wf | b0].
    :param w1, b1: [D, H1], [D] the second.
    Other arguments and the result as bn_forward_step.
    """
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate, threshold=threshold)
    if y1.device.type == "cpu":
        return bn2_forward_step_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1,
                                    b1, nm, **kw)
    _require_cuda(y1)
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    Bl, W, H1 = _check_two_layer(adj_loop, adj_dep, R, D, Fd, w0_aug, w1, b1)
    dev = y1.device
    keep, (y, agg, marg, msum) = _forward_operands(y1, y2, aff, keep, rT, feats, nm, W, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        ws = _Workspace(R, W, D, Fd, H1).allocate(lib, "bn2_forward", dev)
        err = lib.gnn_bn2_forward(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y1), _ptr(y2), _ptr(aff), _ptr(keep), _ptr(rT),
            _ptr(feats), _ptr(w0_aug), _ptr(w1), _ptr(b1), _ptr(nm), _ptr(y), _ptr(agg),
            _ptr(marg), _ptr(msum), R, Bl, W, D, Fd, H1, float(threshold), _ACT_CODE[act0],
            _ACT_CODE[act1], mode, a, b, _stream(dev), _ptr(ws))
    _build.check(err, "bn2_forward_step (K14)")
    launches["bn2_forward_step"] += 1
    return y, agg, marg, msum


def bn2_backward_step(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1, ds_in,
                      gsel, bnv, flag, nm, *, act0: str, act1: str, alpha_drop: bool,
                      rate: float):
    """K15: one reverse two-layer BN-training iteration over every block row.

    Arguments as bn_backward_step with the weights of bn2_forward_step.
    Returns (ds [R, W, D], dw0 [R, H1, 2D+F+1], dw1 [R, D, H1], db1 [R, D],
    dagg [R, W, D], red [R, 2, D]), dw0, dw1, db1 and red per block row.
    """
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
    if y_prev.device.type == "cpu":
        return bn2_backward_step_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1,
                                     b1, ds_in, gsel, bnv, flag, nm, **kw)
    _require_cuda(y_prev)
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    C = 2 * D + Fd + 1
    Bl, W, H1 = _check_two_layer(adj_loop, adj_dep, R, D, Fd, w0_aug, w1, b1)
    dev = y_prev.device
    keep, (ds, dagg, red) = _backward_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv,
                                               flag, nm, W, rate)
    dw0, dw1, db1 = _two_layer_partials(R, D, C, H1, dev)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        ws = _Workspace(R, W, D, Fd, H1).allocate(lib, "bn2_backward", dev)
        err = lib.gnn_bn2_backward(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y_prev), _ptr(y_k), _ptr(agg), _ptr(keep),
            _ptr(feats), _ptr(w0_aug), _ptr(w1), _ptr(b1), _ptr(ds_in), _ptr(gsel), _ptr(bnv),
            _ptr(flag), _ptr(nm), _ptr(ds), _ptr(dw0), _ptr(dw1), _ptr(db1), _ptr(dagg),
            _ptr(red), R, Bl, W, D, Fd, H1, _ACT_CODE[act0], _ACT_CODE[act1], mode, a, b,
            _stream(dev), _ptr(ws))
    _build.check(err, "bn2_backward_step (K15)")
    launches["bn2_backward_step"] += 1
    return ds, dw0, dw1, db1, dagg, red


def _two_layer_partials(R: int, D: int, C: int, H1: int, dev):
    """K15's (K15_bf16's) per-block weight partials dw0 [R, H1, C], dw1
    [R, D, H1] and db1 [R, D], allocated."""
    return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((R, H1, C), (R, D, H1), (R, D)))


def _smem2_bf16(kernel: str):
    return lambda W, D, F: bn2_bf16_smem_bytes(kernel, W, D, F)


def bn2_forward_step_bf16(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug, w1, b1, nm,
                          *, act0: str, act1: str, alpha_drop: bool, rate: float,
                          threshold: float):
    """K14_bf16: one two-layer BN-training iteration over every block row of a
    bf16 adjacency (gnn_tpu's _bn2_fwd_kernel with hp false). Arguments and
    result as bn2_forward_step's, adj_loop / adj_dep bf16."""
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate, threshold=threshold)
    if y1.device.type == "cpu":
        return bn2_forward_step_bf16_ref(adj_loop, adj_dep, y1, y2, aff, keep, rT, feats, w0_aug,
                                         w1, b1, nm, **kw)
    _require_cuda(y1)
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    Bl, W = _check_bf16_blocks(adj_loop, adj_dep, R, D, Fd, "K14_bf16", _smem2_bf16("K14_bf16"))
    dev = y1.device
    H1 = _check_weights2(w0_aug, w1, b1, D, Fd, dev)
    keep, (y, agg, marg, msum) = _forward_operands(y1, y2, aff, keep, rT, feats, nm, W, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_bn2_forward_bf16(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y1), _ptr(y2), _ptr(aff), _ptr(keep), _ptr(rT),
            _ptr(feats), _ptr(w0_aug), _ptr(w1), _ptr(b1), _ptr(nm), _ptr(y), _ptr(agg),
            _ptr(marg), _ptr(msum), R, Bl, W, D, Fd, H1, float(threshold), _ACT_CODE[act0],
            _ACT_CODE[act1], mode, a, b, _stream(dev))
    _build.check(err, "bn2_forward_step_bf16 (K14_bf16)")
    launches["bn2_forward_step_bf16"] += 1
    return y, agg, marg, msum


def bn2_bf16_tiles(w0_aug, w1):
    """K15_bf16's weights as bf16 tiles (fused2.tile_bf16; Cp, H1p, Dp: C =
    2D + F + 1, H1 and D up to a multiple of 16): [bf(w0_aug)^T [Cp, H1p] |
    bf(w0_aug) [H1p, Cp]] flat (h0's and dx2's, the first 2D columns of the
    second dx2's) and bf(w1)^T [H1p, Dp]."""
    D, H1 = w1.shape
    p16 = fused2.pad16
    Cp, H1p = p16(w0_aug.shape[1]), p16(H1)
    return (torch.cat([fused2.tile_bf16(w0_aug.t(), Cp, H1p).reshape(-1),
                       fused2.tile_bf16(w0_aug, H1p, Cp).reshape(-1)]),
            fused2.tile_bf16(w1.t(), H1p, p16(D)))


def bn2_backward_step_bf16(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats, w0_aug, w1, b1,
                           ds_in, gsel, bnv, flag, nm, *, act0: str, act1: str, alpha_drop: bool,
                           rate: float):
    """K15_bf16: one reverse two-layer BN-training iteration over every block
    row of a bf16 adjacency (gnn_tpu's _bn2_bwd_kernel with hp false).
    Arguments and result as bn2_backward_step's, adj_loop / adj_dep bf16."""
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
    if y_prev.device.type == "cpu":
        return bn2_backward_step_bf16_ref(adj_loop, adj_dep, y_prev, y_k, agg, keep, feats,
                                          w0_aug, w1, b1, ds_in, gsel, bnv, flag, nm, **kw)
    _require_cuda(y_prev)
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    C = 2 * D + Fd + 1
    Bl, W = _check_bf16_blocks(adj_loop, adj_dep, R, D, Fd, "K15_bf16", _smem2_bf16("K15_bf16"))
    dev = y_prev.device
    H1 = _check_weights2(w0_aug, w1, b1, D, Fd, dev)
    keep, (ds, dagg, red) = _backward_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv,
                                               flag, nm, W, rate)
    dw0, dw1, db1 = _two_layer_partials(R, D, C, H1, dev)
    mode, a, b = _drop_args(alpha_drop, rate)
    w0t, w1t = bn2_bf16_tiles(w0_aug, w1)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_bn2_backward_bf16(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y_prev), _ptr(y_k), _ptr(agg), _ptr(keep),
            _ptr(feats), _ptr(w0t), _ptr(w1t), _ptr(b1), _ptr(ds_in), _ptr(gsel), _ptr(bnv),
            _ptr(flag), _ptr(nm), _ptr(ds), _ptr(dw0), _ptr(dw1), _ptr(db1), _ptr(dagg),
            _ptr(red), R, Bl, W, D, Fd, H1, _ACT_CODE[act0], _ACT_CODE[act1], mode, a, b,
            _stream(dev))
    _build.check(err, "bn2_backward_step_bf16 (K15_bf16)")
    launches["bn2_backward_step_bf16"] += 1
    return ds, dw0, dw1, db1, dagg, red


# ------------------------------------------------------------- the K-loop
@dataclasses.dataclass
class BNLoopOperands:
    """The constant operands of bn_train_loop (no gradient flows to them).

    The loop keeps T sets of BatchNorm moments and affines, one per node
    type: T = 1 here (K1/K2, K14/K15); ops/typed.py::TypedLoopOperands sets
    the node types of a composite model's typed loop (K16/K17).

    :param keep: uint8 [K, R, W, 2D+F] keep-masks, or None when rate == 0.
    :param res: (src, dst, w) residual arcs in flat block-row node ids, or None.
    :param activations: the state net's, one (K1/K2) or two (K14/K15); per
        type for a typed loop.
    :param types: int32 [R, W] node type of each block-row node (0 on pad),
        or None: one type.
    :param res_type: [Er] int64 type of each residual arc's source node, or
        None: one type.
    """
    adj_loop: torch.Tensor
    adj_dep: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]
    feats: torch.Tensor
    nm: torch.Tensor
    res: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    K: int
    threshold: float
    activations: Tuple[str, ...]
    alpha_drop: bool
    rate: float
    types: Optional[torch.Tensor] = None
    res_type: Optional[torch.Tensor] = None
    n_types: int = 1

    def __post_init__(self):
        if self.types is not None:
            self._ti = self.types.long()
            self._onehot = [(self._ti == t).to(self.nm.dtype)[..., None]
                            for t in range(self.n_types)]

    def sel(self, coef):
        """Per-node rows of per-type coefficients [T, D]: [R, W, D] (the one
        row [D] when there is one type)."""
        return coef[0] if self.types is None else coef[self._ti]

    def type_sum(self, x):
        """[T, D] sums of x [R, W, D] over the nodes of each type, padded
        nodes counting as type 0 (mask x for real nodes only)."""
        if self.types is None:
            return torch.sum(x, dim=(0, 1))[None]
        return torch.stack([torch.sum(x * m, dim=(0, 1)) for m in self._onehot])

    def res_sel(self, coef):
        """Per residual arc rows [Er, D] of per-type coefficients, by the
        arc's source node's type."""
        return coef[0] if self.res_type is None else coef[self.res_type]

    def res_sum(self, vals):
        """[T, D] sums of per residual arc values [Er, D] by source type."""
        if self.res_type is None:
            return torch.sum(vals, dim=0)[None]
        return vals.new_zeros((self.n_types, vals.shape[1])).index_add_(0, self.res_type, vals)

    def step_kw(self):
        acts = (dict(activation=self.activations[0]) if len(self.activations) == 1
                else dict(zip(("act0", "act1"), self.activations)))
        return dict(acts, alpha_drop=self.alpha_drop, rate=self.rate)

    def keep_k(self, k):
        return None if self.keep is None else self.keep[k]

    @property
    def bf16(self) -> bool:
        """Whether the block adjacency is bf16 (the kernels' bf16 variants)."""
        adj = self.adj_loop if self.adj_loop is not None else self.adj_dep
        return adj.dtype == torch.bfloat16

    def acc(self, x):
        """x in the glue's accumulation type: float64 on a bf16 adjacency,
        whose sums (the moments, the residual scatters, the reverse's
        reductions) are rounded to f32 once, so that the card and the CPU
        take the same bits whatever order they add in (a last-bit
        difference would move bf(s) and bf(dh) across rounding
        boundaries); x itself otherwise."""
        return x.double() if self.bf16 else x

    def forward_step(self, k, y1, y2, aff, rT, weights):
        """Iteration k: K1 for the weights (w_aug,), K14 for (w0_aug, w1, b1)
        (K1_bf16, K14_bf16 on a bf16 adjacency). aff [2, 2, 1, D]; returns
        (y, agg, marg, msum [R, 1, D])."""
        step = ((bn_forward_step_bf16, bn2_forward_step_bf16) if self.bf16 else
                (bn_forward_step, bn2_forward_step))[len(weights) != 1]
        y, agg, marg, msum = step(self.adj_loop, self.adj_dep, y1, y2, aff.reshape(2, 2, -1),
                                  self.keep_k(k), rT, self.feats, *weights, self.nm,
                                  threshold=self.threshold, **self.step_kw())
        return y, agg, marg, msum[:, None]

    def backward_step(self, k, y_prev, y_k, agg, weights, ds_in, gsel, bnv, flag):
        """The reverse of iteration k, K2 or K15 (K2_bf16, K15_bf16), with bnv
        [1, 9, D]: (ds, the weights' per-block cotangents, dagg, red
        [R, 1, 2, D])."""
        step = ((bn_backward_step_bf16, bn2_backward_step_bf16) if self.bf16 else
                (bn_backward_step, bn2_backward_step))[len(weights) != 1]
        ds, *dweights, dagg, red = step(self.adj_loop, self.adj_dep, y_prev, y_k, agg,
                                        self.keep_k(k), self.feats, *weights, ds_in, gsel,
                                        bnv[0], flag, self.nm, **self.step_kw())
        return ds, dweights, dagg, red[:, None]


def _res_term(y, aff, res, op: BNLoopOperands):
    """Residual term [R, W, D]: the sources' states normalized with the
    affine aff [2, T, D] of their type, weighted, summed into their
    destinations (_res_gather + _res_scatter)."""
    src, dst, w = res
    R, W, D = y.shape
    vals = op.acc((y.reshape(-1, D)[src] * op.res_sel(aff[0]) + op.res_sel(aff[1])) * w[:, None])
    return vals.new_zeros((R * W, D)).index_add_(0, dst, vals).to(y.dtype).reshape(R, W, D)


class _BNTrainLoop(torch.autograd.Function):
    """K launches of K1 (K14, K16) forward and K launches of K2 (K15, K17)
    backward, with the reference's global early stop and snapshot selection
    as tensor ops (no host synchronisation): _bn_loop_fwd / _bn_loop_bwd
    (_bn2_loop_*, pallas_typed.py::_bnT_loop_*). The moments, affines and
    BatchNorm coefficients are per node type ([T, D] rows, T = 1 without
    types): each type's moments are taken over its real nodes, each node
    takes its own type's affine."""

    @staticmethod
    def forward(ctx, s0, gamma, beta, op: BNLoopOperands, *weights):
        D = s0.shape[-1]
        T = op.n_types
        nm3 = op.nm[..., None]
        cnt = torch.clamp_min(op.type_sum(nm3), 1.0)                       # [T, 1]
        ident = _ident_aff(D, s0)[:, None].expand(2, T, D)
        y1, y2, a1, a2 = s0, torch.ones_like(s0), ident, ident
        ys, aggs, moms, affs, margs = [], [], [], [], []
        for k in range(op.K):
            rT = None if op.res is None else _res_term(y1, a1, op.res, op)
            y, agg, marg, msum = op.forward_step(k, y1, y2, torch.stack([a1, a2]), rT, weights)
            mean = (torch.sum(op.acc(msum), dim=0) / cnt).to(y.dtype)
            # two-pass variance, centred on each node's own type's mean
            var = (op.type_sum(torch.square(op.acc(y) - op.sel(mean)) * nm3) / cnt).to(y.dtype)
            y2, a2 = y1, a1
            y1, a1 = y, _affine(gamma, beta, mean, var, op.bf16)
            ys.append(y)
            aggs.append(agg)
            moms.append(torch.stack([mean, var], dim=1))                  # [T, 2, D]
            affs.append(a1)
            margs.append(marg)
        loop_any = (torch.stack(margs) > 0.5).flatten(1).any(dim=1)           # [K]
        iters = torch.sum(torch.cumprod(loop_any.float(), dim=0))
        idx = torch.clamp_min(iters.long() - 1, 0).reshape(1)
        moms_t = torch.stack(moms)
        y_sel = torch.stack(ys).index_select(0, idx)[0]
        mom_sel = moms_t.index_select(0, idx)[0]
        # centered normalize of the returned snapshot (mlp.py::_batchnorm)
        state3 = ((y_sel - op.sel(mom_sel[:, 0])) * op.sel(_rstd(mom_sel[:, 1], op.bf16))
                  * op.sel(gamma) + op.sel(beta))
        state3 = torch.where(iters >= 1.0, state3, s0)
        ctx.op = op
        ctx.saved = (s0, weights, gamma, iters, idx, ys, aggs, moms, affs, cnt)
        ctx.mark_non_differentiable(iters, moms_t)
        return iters, state3, moms_t

    @staticmethod
    def backward(ctx, _g_iters, g_state, _g_moms):
        op = ctx.op
        s0, weights, gamma, iters, idx, ys, aggs, moms, affs, cnt = ctx.saved
        R, W, D = s0.shape
        T = op.n_types
        g_state = torch.zeros_like(s0) if g_state is None else g_state.contiguous()
        active = iters >= 1.0
        ident = _ident_aff(D, s0)[:, None].expand(2, T, D)
        zero, one = ident[1], ident[0]
        # the snapshot's cotangent enters at iteration idx: its reduction terms
        Sg = op.type_sum(op.acc(g_state)).to(s0.dtype)
        rks = [_rstd(m[:, 1], op.bf16) for m in moms]
        Sgx = [op.type_sum(op.acc(g_state * ((ys[j] - op.sel(moms[j][:, 0])) * op.sel(rks[j]))))
               .to(s0.dtype) for j in range(op.K)]
        ds = torch.zeros_like(s0)
        red = torch.zeros((T, 2, D), dtype=s0.dtype, device=s0.device)
        dweights = [torch.zeros_like(w) for w in weights]
        dgamma, dbeta = torch.zeros_like(zero), torch.zeros_like(zero)
        for k in reversed(range(op.K)):
            flag = ((idx[0] == k) & active).float()
            s1 = red[:, 0] + flag * Sg
            s2 = red[:, 1] + flag * Sgx[k]
            dbeta = dbeta + s1
            dgamma = dgamma + s2
            a = gamma * rks[k]
            aff_p = ident if k == 0 else affs[k - 1]
            mean_p = zero if k == 0 else moms[k - 1][:, 0]
            r_p = one if k == 0 else rks[k - 1]
            bnv = torch.stack([aff_p[0], aff_p[1], moms[k][:, 0], rks[k], a, a * s1 / cnt,
                               a * s2 / cnt, mean_p, r_p], dim=1)                # [T, 9, D]
            y_prev = s0 if k == 0 else ys[k - 1]
            ds_new, dw_k, dagg, red_part = op.backward_step(k, y_prev, ys[k], aggs[k], weights, ds,
                                                            g_state, bnv, flag)
            red = torch.sum(op.acc(red_part), dim=0).to(s0.dtype)
            dweights = [a + torch.sum(b, dim=0) for a, b in zip(dweights, dw_k)]
            if op.res is not None:
                # ds[src] += w * dagg[dst]; for k > 0 the next reverse step's
                # reduction partials take these rows too, by source type
                src, dst, rw = op.res
                vals = dagg.reshape(-1, D)[dst] * rw[:, None]
                ds_new = (op.acc(ds_new.reshape(-1, D)).index_add_(0, src, op.acc(vals))
                          .to(s0.dtype).reshape(R, W, D))
                if k > 0:
                    xp_src = (ys[k - 1].reshape(-1, D)[src] - op.res_sel(mean_p)) * op.res_sel(r_p)
                    red = red + torch.stack([op.res_sum(op.acc(vals)),
                                             op.res_sum(op.acc(vals * xp_src))],
                                            dim=1).to(s0.dtype)
            ds = ds_new
        # iters == 0: the forward returned s0 itself
        ds = ds + torch.where(active, 0.0, g_state)
        return (ds, dgamma, dbeta, None, *dweights)


def bn_train_loop(s0, weights, gamma, beta, op: BNLoopOperands):
    """The K-iteration BN training loop (fused_bn_train_loop, or
    fused_bn2_train_loop for the weights (w0_aug, w1, b1) of a two-layer state
    net, or fused_bn_typed_train_loop for the stacked per-type weights
    (w_stk,) of a typed loop). gamma, beta: [D], or [T, D] per type.
    Returns (iters, state3 [R, W, D] the snapshot at the realised count,
    moms [K, 2, D], or [K, T, 2, D] per type, the batch moments of every
    iteration). Gradients flow to s0, the weights, gamma and beta through K
    launches of K2 (K15, K17); iters and moms carry none."""
    iters, state3, moms = _BNTrainLoop.apply(s0, gamma.reshape(op.n_types, -1),
                                             beta.reshape(op.n_types, -1), op, *weights)
    return iters, state3, (moms if op.types is not None else moms[:, 0])


def block_rows(gb):
    """(blocks, nm, res) of a blocked batch's block rows [loop blocks | dep
    blocks] (every block in order in the all-dep layout): blocks(x) takes
    node rows x [..., Np, F] in global order to [..., R, W, F]; nm [R, W] is
    the float node mask (0 on padded loop rows); res (src, dst, w) holds the
    residual arcs in flat block-row node ids, or is None without dep
    blocks."""
    W = gb.block_w
    B = gb.n_node_pad // W
    loop, dep = gb.adj_loop is not None, gb.adj_dep is not None
    ids = [x for x, on in ((gb.loop_ids, loop), (gb.dep_ids, dep)) if on]
    rows = torch.cat(ids) if len(ids) > 1 else ids[0]

    def blocks(x):
        return x.reshape(*x.shape[:-2], B, W, x.shape[-1]).index_select(x.dim() - 2, rows)

    nms = [gb.loop_nm] if loop else []
    res = None
    if dep:
        nms.append(gb.node_mask.reshape(B, W).index_select(0, gb.dep_ids).to(torch.float32))
        off = gb.adj_loop.shape[0] * W if loop else 0
        res = (gb.res_src_loc + off, gb.res_dst_loc + off, gb.res_w)
    return blocks, torch.cat(nms) if len(nms) > 1 else nms[0], res


def input_rate(state_spec) -> float:
    """The state net's dropout rate at its input (position 0), 0 without."""
    return float(dict(zip(state_spec.dropout_pos, state_spec.dropout_rate)).get(0, 0.0))


def block_keep(blocks, keep_state: Optional[torch.Tensor], rate: float, cols=None):
    """uint8 [K, R, W, 2D+F] block-row keep-masks of the input dropout from
    bool [K, Np, in_dim] masks in global node order and the reference's
    column order, taken to x3's (kernel_columns `cols`; the orders agree at
    state_dim 0); None when rate == 0."""
    if rate <= 0.0:
        return None
    if keep_state is None:
        raise ValueError("a keep-mask for dropout position 0 is required in training")
    return blocks(in_kernel_order(keep_state, cols)).to(torch.uint8)


def bn_loop_operands(spec, params_state, gb, keep_state: Optional[torch.Tensor],
                     init: Optional[torch.Tensor] = None):
    """(s0 [R, W, D], weights, BNLoopOperands) of a blocked batch: the
    weights (w_aug,) with w_aug = [Ws | Wa | Wf | b] [D, 2D+F+1] for a
    one-layer state net, (w0_aug, w1, b1) with w0_aug [H1, 2D+F+1] for a
    two-layer one; the keep-masks in x3 column order and the block rows
    [loop blocks | dep blocks] with their node mask and residual arcs. At
    state_dim > 0 the labels and their aggregation fold into the features
    (ops/fold.py, gnn_tpu pallas_bn.py:975-1010).

    :param keep_state: bool [K, Np, in_dim] input keep-masks in global node
        order (None without input dropout).
    :param init: the initial state [Np, state_dim] at state_dim > 0."""
    blocks, nm, res = block_rows(gb)
    ss = spec.state_spec
    rate = input_rate(ss)
    cols = kernel_columns(spec, gb.nodes.shape[1])
    op = BNLoopOperands(adj_loop=gb.adj_loop, adj_dep=gb.adj_dep,
                        keep=block_keep(blocks, keep_state, rate, cols),
                        feats=blocks(fold_features(spec, gb)), nm=nm, res=res,
                        K=spec.max_iteration, threshold=float(spec.threshold),
                        activations=tuple(ss.activations), alpha_drop=bool(ss.alphadropout),
                        rate=rate)
    weights = (augmented(params_state["dense_0"], cols),)
    if ss.num_layers == 2:
        d1 = params_state["dense_1"]
        weights += (d1["w"].contiguous(), d1["b"])
    return blocks(initial_state(spec, gb, init)), weights, op


def augmented(dense, cols=None) -> torch.Tensor:
    """[w | b] [H, in + 1]: a dense layer's bias-augmented weight, its
    input columns in the kernels' order (kernel_columns `cols`)."""
    return torch.cat([in_kernel_order(dense["w"], cols), dense["b"][:, None]], dim=1)


def moving_stats(bn_state, moms, iters):
    """The moving BatchNorm statistics after a loop with batch moments moms
    [K, 2, D]: updated only by the iterations that ran (iters of them)."""
    mean_mv, var_mv = bn_state["mean"], bn_state["var"]
    for j in range(moms.shape[0]):
        on = iters > j
        mean_mv = torch.where(on, mean_mv * BN_MOMENTUM + moms[j, 0] * (1.0 - BN_MOMENTUM),
                              mean_mv)
        var_mv = torch.where(on, var_mv * BN_MOMENTUM + moms[j, 1] * (1.0 - BN_MOMENTUM), var_mv)
    return {"mean": mean_mv, "var": var_mv}


def bn_train_propagate(spec, params_state, bn_state, gb, keep_state: Optional[torch.Tensor],
                       init: Optional[torch.Tensor] = None):
    """BN training propagation of models/core.py::propagate on a blocked
    batch (bn_loop_operands): runs bn_train_loop, applies the active-gated
    moving-statistics update and returns the state in global node order.
    Returns (iters, state [Np, D], new_bn_state)."""
    s0, weights, op = bn_loop_operands(spec, params_state, gb, keep_state, init)
    iters, state3, moms = bn_train_loop(s0, weights, params_state["bn"]["gamma"],
                                        params_state["bn"]["beta"], op)
    state = state3.index_select(0, gb.block_perm).reshape(gb.n_node_pad, -1)
    return iters, state, moving_stats(bn_state, moms, iters)
