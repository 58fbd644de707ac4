"""Typed BatchNorm propagation kernels of composite (per-node-type) GNNs:
K16/K17 (counterpart of gnn_tpu/ops/pallas_typed.py).

A composite model gives each node type t its own one-layer state net, with
its own trailing BatchNorm: y = act_t(w_t @ [drop(x3); 1]), normalized by the
moments of type t's real nodes. Aggregation, movement flags and the dropout
are the homogeneous chain's (ops/bn.py), computed once on the selected
state; only the dense layer, its activation and the BatchNorm coefficients
are selected by each node's type.

* `bnT_forward_step` (K16, replaces `_bnT_fwd_kernel`): one iteration over
  every block row. The two previous pre-BN activations are normalized with
  each node's own type's affine (aff [2, 2, T, D]); then margins, the
  aggregation plus the residual term, the dropped x3 = [s | agg | feats],
  each node's own type's rows [t*D, (t+1)*D) of the stacked weights w_stk
  [T*D, 2D+F+1] and activation, and per-block per-type moment sums msum
  [R, T, D] over real nodes.
* `bnT_backward_step` (K17, replaces `_bnT_bwd_kernel`): its reverse with the
  per-type BatchNorm backward folded in from bnv [T, 9, D] (rows as
  ops/bn.py::BNV_ROWS): ds, dagg, per-block dw [R, T*D, C] (a node adds into
  its type's rows only) and red [R, T, 2, D] grouped by node type.

gnn_tpu selects with a one-hot type mask and multiplies every node by all T
weight slabs; here a node's type is an index (int32 [R, W], 0 on pad, as the
raw one-hot's padded rows select type 0) and a node meets only its own
type's weights, so the dense work is K1's whatever T is. Moments, margins
and the BatchNorm's moment term mask padded nodes with nm; the reduction
partials red group ds by the raw type, pads in type 0, as gnn_tpu's do.

On a bf16 block adjacency (gnn_tpu's `hp = False` branch) the loop runs
K16_bf16 (`bnT_forward_step_bf16`) and K17_bf16 (`bnT_backward_step_bf16`,
ops/csrc/bn_typed_bf16.cu): K1_bf16's and K2_bf16's rounding (ops/bn.py)
with each node's own type's weights, the per-type sums node by node.

The K-loop is ops/bn.py's `_BNTrainLoop` with per-type moments
(`TypedLoopOperands`, which picks the bf16 variants by the adjacency's
dtype); `bn_typed_train_propagate` drives it in training and
`typed_eval_propagate` runs K16 once an iteration with the fixed per-type
inference affine at eval (rate 0, the moment sums ignored).

Each wrapper runs its plain PyTorch version (`*_ref`) for CPU tensors and
launches the CUDA kernel (ops/csrc/bn_typed.cu, bn_typed_bf16.cu) for CUDA
tensors; it never falls back from one to the other. `launches` counts kernel
launches. The bf16 variants take the widths whose CTA fits shared memory
(`bnT_bf16_smem_bytes`, any T); the f32 kernels take every D, F and number
of types T: the first of their staged
shared-memory plans that fits a CTA (D up to 64, T up to MAX_TYPES; the
stacked weights staged there when they fit, else read through the L1/L2
caches), else their wide plan, which keeps x3 and the [W][D]-sized rows in a
device-memory workspace the wrapper allocates (`_bnT_fwd_plan`,
`_bnT_bwd_plan`, `_bnT_fwd_wide`, `_bnT_bwd_wide`). Each type's activation
code is a byte of a device array (`_act_codes`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gnn_tpu_torch.ops import _build, fused2
from gnn_tpu_torch.ops.fold import fold_features, initial_state, kernel_columns
from gnn_tpu_torch.ops.bn import (BNV_ROWS, BNLoopOperands, _affine, _agg_blocks, _agg_bf16,
                                  _bn_ds, _bn_gy, _check_bf16_blocks, _check_blocks,
                                  _contract_bf16, _dense_bf16, _ident_aff, _ones_col,
                                  _require_cuda, _res_term, _x3, augmented, block_keep,
                                  block_rows, bn_train_loop, input_rate, moving_stats)
from gnn_tpu_torch.ops.fused import (_ACT_CODE, _ACTS, FUSABLE_ACTIVATIONS, SMEM_BYTES,
                                     _act_grad, _check, _check_keep, _drop_args, _first_plan,
                                     _plan_info, _ptr, _r4, _stream, _Workspace, moved)

MAX_TYPES = 32   # the most node types the staged plans take (their design range;
                 # the wide plan takes any number)

# kernel launches since the last reset, by wrapper
launches = {"bnT_forward_step": 0, "bnT_backward_step": 0, "bnT_forward_step_bf16": 0,
            "bnT_backward_step_bf16": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supports_typed_bn_train(state_specs) -> bool:
    """K16/K17 train the specs: every per-type state net one dense layer with
    the trailing BatchNorm, a kernel activation and dropout only at the
    input, all types sharing the dropout configuration (the activations may
    differ)."""
    s0 = state_specs[0]
    return all(
        s.num_layers == 1
        and bool(s.batch_normalization)
        and s.activations[0] in FUSABLE_ACTIVATIONS
        and all(p == 0 for p in s.dropout_pos)
        and s.dropout_pos == s0.dropout_pos
        and s.dropout_rate == s0.dropout_rate
        and bool(s.alphadropout) == bool(s0.alphadropout)
        for s in state_specs)


def supports_typed_eval(state_specs) -> bool:
    """K16 serves the specs: every per-type state net one dense layer with a
    kernel activation (the BatchNorm, if any, is a fixed per-type affine at
    inference; dropout is inactive)."""
    return all(s.num_layers == 1 and s.activations[0] in FUSABLE_ACTIVATIONS
               for s in state_specs)


# ------------------------------------------------------------ plain versions
def _per_type(fn, activations, h, ti):
    """fn(activation, h) with each node's own type's activation."""
    if len(set(activations)) == 1:
        return fn(activations[0], h)
    out = torch.empty_like(h)
    for t, a in enumerate(activations):
        m = ti == t
        out[m] = fn(a, h[m])
    return out


def _own_pre_activation(x3, w_stk, ti, T):
    """h [R, W, D]: each node's own type's rows of w_stk applied to [x3; 1]."""
    D = w_stk.shape[0] // T
    h_all = F.linear(x3, w_stk[:, :-1], w_stk[:, -1]).unflatten(-1, (T, D))
    return torch.gather(h_all, -2, ti[..., None, None].expand(*ti.shape, 1, D))[..., 0, :]


def _type_sums(onehot, x):
    """[R, T, D] per-block sums of x [R, W, D] over each type's nodes."""
    return torch.einsum("rwt,rwd->rtd", onehot, x)


def bnT_forward_step_ref(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, *,
                         activations, alpha_drop: bool, rate: float, threshold: float):
    """Plain PyTorch K16. Returns (y [R, W, D] pre-BN activation, agg
    [R, W, D] (with the residual term, before the dropout), marg [R, W]
    movement flags times nm, msum [R, T, D] per-block sums of y * nm over
    each type's nodes)."""
    T = len(activations)
    ti = types.long()
    s = y1 * aff[0, 0][ti] + aff[0, 1][ti]
    s_old = y2 * aff[1, 0][ti] + aff[1, 1][ti]
    marg = moved(s, s_old, threshold) * nm
    agg = _agg_blocks(adj_loop, adj_dep, s)
    if rT is not None:
        agg = agg + rT
    h = _own_pre_activation(_x3(s, agg, feats, keep, alpha_drop, rate), w_stk, ti, T)
    y = _per_type(lambda a, x: _ACTS[a](x), activations, h, ti)
    return y, agg, marg, _type_sums(F.one_hot(ti, T).to(y.dtype) * nm[..., None], y)


def bnT_backward_step_ref(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk, ds_in,
                          gsel, bnv, flag, nm, *, activations, alpha_drop: bool, rate: float,
                          act_grad=_act_grad):
    """Plain PyTorch K17: one reverse typed iteration with the per-type
    BatchNorm backward folded in. `bnv` [T, 9, D] holds each type's rows
    named in ops/bn.py::BNV_ROWS; `flag` (0-d) gates the state cotangent
    `gsel` in. Returns (ds [R, W, D], dw [R, T*D, C] per-block partials of the
    w_stk cotangent, dagg [R, W, D], red [R, T, 2, D] per-block (sum ds,
    sum ds * x_hat_prev) over each type's nodes, pads in type 0). act_grad
    is the activations' derivative (chip_smoke.py switches its branch at
    kinks): called once on every node when the types share their
    activation, else once per type on that type's nodes."""
    T = len(activations)
    D = y_prev.shape[-1]
    ti = types.long()
    v = bnv[ti].movedim(-2, 0)                              # [9, R, W, D] own type's rows
    x3 = _x3(y_prev * v[0] + v[1], agg, feats, keep, alpha_drop, rate)
    h = _own_pre_activation(x3, w_stk, ti, T)
    dh = _bn_gy(y_k, ds_in, gsel, v, flag, nm) * _per_type(act_grad, activations, h, ti)
    onehot = F.one_hot(ti, T).to(dh.dtype)
    dh_all = (onehot[..., None] * dh[..., None, :]).flatten(-2)       # [R, W, T*D]
    dw = torch.matmul(dh_all.transpose(1, 2), _ones_col(x3))
    ds, dagg = _bn_ds(adj_loop, adj_dep, torch.matmul(dh_all, w_stk[:, :2 * D]), keep,
                      alpha_drop, rate)
    red = torch.stack([_type_sums(onehot, ds), _type_sums(onehot, ds * ((y_prev - v[7]) * v[8]))],
                      dim=2)
    return ds, dw, dagg, red


# ------------------------------------------- bf16 adjacency: plain versions
def _own_dense_bf16(x3, w_stk, ti, T):
    """h [R, W, D]: each node's own type's rows of w_stk applied to
    bf([x3 | 1]) as bn._dense_bf16 (the columns ascending, the bias last);
    every type's product is exact term by term, so selecting after the sums
    gives the kernel's per-node sum."""
    D = w_stk.shape[0] // T
    h_all = _dense_bf16(x3, w_stk, D).unflatten(-1, (T, D))
    return torch.gather(h_all, -2, ti[..., None, None].expand(*ti.shape, 1, D))[..., 0, :]


def _type_node_sums(onehot, x):
    """[R, T, D] per-block sums of x [R, W, D] over each type's nodes in node
    order, one f32 add a node (fused2.node_sum; another type's node adds a
    zero, which keeps the sum's bits)."""
    return fused2.node_sum(onehot[..., None] * x[..., None, :])


def bnT_forward_step_bf16_ref(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm,
                              *, activations, alpha_drop: bool, rate: float, threshold: float):
    """Plain PyTorch K16_bf16 (gnn_tpu's _bnT_fwd_kernel with hp false): K16
    with K1_bf16's rounding, the aggregation over bf(s) and each node's own
    type's dense layer over bf([x3 | 1]) and bf(w_stk), the bias column
    through bf16; every sum in the kernel's order, the activations in
    float64 (fused2.act64), msum node by node. Returns as
    bnT_forward_step_ref."""
    T = len(activations)
    ti = types.long()
    s = y1 * aff[0, 0][ti] + aff[0, 1][ti]
    s_old = y2 * aff[1, 0][ti] + aff[1, 1][ti]
    marg = moved(s, s_old, threshold) * nm
    agg = _agg_bf16(adj_loop, adj_dep, s)
    if rT is not None:
        agg = agg + rT
    h = _own_dense_bf16(_x3(s, agg, feats, keep, alpha_drop, rate), w_stk, ti, T)
    y = _per_type(fused2.act64, activations, h, ti)
    return y, agg, marg, _type_node_sums(F.one_hot(ti, T).to(y.dtype), y * nm[..., None])


def bnT_backward_step_bf16_ref(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk,
                               ds_in, gsel, bnv, flag, nm, *, activations, alpha_drop: bool,
                               rate: float):
    """Plain PyTorch K17_bf16 (gnn_tpu's _bnT_bwd_kernel with hp false): h
    recomputed with K16_bf16's rounding, dh with each node's own type's
    BatchNorm coefficients, dw the unrounded f32 product into the node's
    type's rows (gnn_tpu's _BDT_HI), dx2 = bf(dh) @ bf(w_own[:, :2D]) and the
    aggregation's reverse over bf(dagg); dw and red summed node by node.
    Returns as bnT_backward_step_ref."""
    T = len(activations)
    D = y_prev.shape[-1]
    ti = types.long()
    v = bnv[ti].movedim(-2, 0)                              # [9, R, W, D] own type's rows
    x3 = _x3(y_prev * v[0] + v[1], agg, feats, keep, alpha_drop, rate)
    h = _own_dense_bf16(x3, w_stk, ti, T)
    dh = _bn_gy(y_k, ds_in, gsel, v, flag, nm) * _per_type(fused2.act_grad64, activations, h, ti)
    onehot = F.one_hot(ti, T).to(dh.dtype)
    dw = fused2.node_outer((onehot[..., None] * dh[..., None, :]).flatten(-2), _ones_col(x3))
    dhb = fused2._bf("dh", dh)
    dx_all = torch.stack([fused2._exact_dot(dhb, fused2._bf("w", w_stk[t * D:(t + 1) * D, :2 * D])
                                            .t()) for t in range(T)], dim=-2)
    dx2 = torch.gather(dx_all, -2, ti[..., None, None].expand(*ti.shape, 1, 2 * D))[..., 0, :]
    ds, dagg = _bn_ds(adj_loop, adj_dep, dx2, keep, alpha_drop, rate, _contract_bf16)
    red = torch.stack([_type_node_sums(onehot, ds),
                       _type_node_sums(onehot, ds * ((y_prev - v[7]) * v[8]))], dim=2)
    return ds, dw, dagg, red


# ------------------------------------------------------------------ wrappers
# bn_typed.cu's kBnTFwdPlans, K16's shared-memory plans in order of
# preference: (threads a CTA, room of the column lists, keep bytes staged,
# stacked weights staged). The first is the composite recipe's; the last fits
# every shape the per-node K16 took.
_BNT_FWD_PLANS = ((256, 16, 1, 1), (256, 16, 1, 0), (128, 0, 0, 0))
_BNT_FWD_WIDE = (256, 16, 0, 0)      # kBnTFwdWide, after the list


def _bnT_fwd_bytes(W, D, F, T, plan):
    """Shared memory of bn_typed.cu::fwdT_layout: x3 [C1][W], with ws the
    weights transposed [T][C][D rounded up to 4], the per-type affines
    [4][T][D], nm [W], the types, their order and starts ([W], [W], [T + 1]
    ints), the row buffer [W][D|1], with st the keep bytes; the column lists
    ([E][W] floats, then W counts, E*W sources and the list build's counts
    [threads / 32][W] as bytes); each float region a multiple of 16 bytes.
    The widths may be ints or numpy integer arrays."""
    nt, E, st, ws = plan
    C1 = 2 * D + F
    floats = (_r4(C1 * W) + ws * T * (C1 + 1) * _r4(D) + _r4(4 * T * D) + _r4(W) + 2 * W
              + _r4(T + 1) + _r4(W * (D | 1)) + st * _r4((W * C1 + 3) // 4) + E * W)
    return 4 * floats + (W + E * W + nt // 32 * W if E else 0)


def _bnT_fwd_wide(W, D, F, T):
    """K16's wide plan (fwdT_layout(..., wide = true)): (shared-memory bytes,
    workspace floats a block row). The workspace holds x3 [C1][W], the row
    buffer [W][D|1] and the types' starts [T + 1]; shared memory nm [W], the
    types and their order ([W], [W] ints), the column lists ([16][W] floats,
    then W counts, 16*W sources and the list build's counts [8][W] as
    bytes)."""
    nt, E = _BNT_FWD_WIDE[:2]
    ws = _r4((2 * D + F) * W) + _r4(W * (D | 1)) + _r4(T + 1)
    return 4 * (_r4(W) + 2 * W + E * W) + W + E * W + nt // 32 * W, ws


def _typed_plan(plans, nbytes, wide, W, D, F, T):
    """fused._first_plan over the staged plans where they take the shape (D
    up to 64, T up to MAX_TYPES), else the wide plan (index 3)."""
    if D <= 64 and T <= MAX_TYPES:
        return _first_plan(plans, nbytes, W, D, F, T, wide=wide)
    need = int(wide(W, D, F, T)[0])
    return need, (len(plans) if need <= SMEM_BYTES else None)


def _bnT_fwd_plan(W: int, D: int, F: int, T: int):
    """(shared-memory bytes, plan index) K16 takes at this shape: the first
    plan of _BNT_FWD_PLANS that fits a CTA, else the wide plan (index 3)."""
    return _typed_plan(_BNT_FWD_PLANS, _bnT_fwd_bytes, _bnT_fwd_wide, W, D, F, T)


# bn_typed.cu's kBnTBwdPlans, K17's shared-memory plans in order of
# preference: (threads a CTA, room of the row lists, rows and keep bytes
# staged, stacked weights staged). The first is the composite recipe's; the
# last fits every shape the per-node K17 took.
_BNT_BWD_PLANS = ((256, 8, 1, 1), (256, 8, 1, 0), (128, 0, 0, 0))
_BNT_BWD_WIDE = (256, 8, 0, 0)       # kBnTBwdWide, after the list


def _bnT_bwd_bytes(W, D, F, T, plan):
    """Shared memory of bn_typed.cu::bwdT_layout: x3 [C1][W], dh [D][W], with
    ws the weights transposed [T][C][D rounded up to 4], bnv [T][9][D], nm
    [W], the types, their order and starts ([W], [W], [T + 1] ints); staged,
    y_prev [W][D] and the keep bytes; the late region (ds_in, gsel, y_k, or
    dagg [W][D|1]); the row lists ([E][W] floats, W counts and E*W
    destinations as bytes); each region a multiple of 16 bytes. The widths
    may be ints or numpy integer arrays."""
    nt, E, st, ws = plan
    C1 = 2 * D + F
    floats = (_r4(C1 * W) + _r4(D * W) + ws * T * (C1 + 1) * _r4(D) + _r4(T * 9 * D) + _r4(W)
              + 2 * W + _r4(T + 1))
    if st:
        floats = floats + _r4(W * D) + _r4((W * C1 + 3) // 4)
    floats = floats + np.maximum(st * 3 * _r4(W * D), _r4(W * (D | 1))) + E * W
    return 4 * floats + (W + E * W if E else 0)


def _bnT_bwd_wide(W, D, F, T):
    """K17's wide plan (bwdT_layout(..., wide = true)): (shared-memory bytes,
    workspace floats a block row). The workspace holds x3 [C1][W], dh
    [D][W], dagg and ds [W][D|1] each and the types' starts [T + 1]; shared
    memory nm [W], the types and their order, the row lists ([8][W] floats,
    W counts and 8*W destinations as bytes)."""
    E = _BNT_BWD_WIDE[1]
    ws = _r4((2 * D + F) * W) + _r4(D * W) + 2 * _r4(W * (D | 1)) + _r4(T + 1)
    return 4 * (_r4(W) + 2 * W + E * W) + W + E * W, ws


def _bnT_bwd_plan(W: int, D: int, F: int, T: int):
    """(shared-memory bytes, plan index) K17 takes at this shape: the first
    plan of _BNT_BWD_PLANS that fits a CTA, else the wide plan (index 3)."""
    return _typed_plan(_BNT_BWD_PLANS, _bnT_bwd_bytes, _bnT_bwd_wide, W, D, F, T)


def backward_info(W: int, D: int, F: int, T: int) -> dict:
    """fused._plan_info of K17 (gnn_bnT_backward)."""
    return _plan_info("gnn_bnT_backward", W, D, F, T)


def _check_typed(adj_loop, adj_dep, R, D, Fd, types, w_stk, activations):
    """(Bl, W, T) after checking the block rows and widths, the node types
    and the stacked weights (every D, F and T has a plan at W <= 128)."""
    Bl, W = _check_blocks(adj_loop, adj_dep, R)
    return Bl, W, _check_types(R, W, D, Fd, types, w_stk, activations)


def _check_types(R, W, D, Fd, types, w_stk, activations):
    """T after checking the node types (int32 [R, W]) and the stacked weights
    [T*D, 2D+F+1]."""
    T = len(activations)
    if T < 1:
        raise ValueError("the typed kernels need at least one node type")
    dev = w_stk.device
    if types.device != dev or types.dtype != torch.int32 or tuple(types.shape) != (R, W) \
            or not types.is_contiguous():
        raise ValueError(f"types must be a contiguous int32 tensor of shape {(R, W)} on {dev}, "
                         f"got {types.dtype} {tuple(types.shape)} on {types.device}")
    _check("w_stk", w_stk, (T * D, 2 * D + Fd + 1), dev)
    return T


_CODES = {}   # (activations, device) -> uint8 [T] activation codes on the device


def _act_codes(activations, dev) -> torch.Tensor:
    """The per-type activation codes, type t's at byte t, on `dev` (made
    once for each set of activations and device)."""
    key = (tuple(activations), str(dev))
    if key not in _CODES:
        _CODES[key] = torch.tensor([_ACT_CODE[a] for a in activations], dtype=torch.uint8,
                                   device=dev)
    return _CODES[key]


def bnT_forward_step(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, *,
                     activations, alpha_drop: bool, rate: float, threshold: float):
    """K16: one typed BN-training iteration over every block row.

    :param adj_loop / adj_dep: [Bl, W, W] / [Bd, W, W] (or None) transposed
        block adjacencies of rows [0, Bl) and [Bl, Bl + Bd).
    :param y1 / y2: [R, W, D] the two previous pre-BN activations.
    :param aff: [2, 2, T, D] their per-type (scale; shift) affines.
    :param types: int32 [R, W] node types (0 on pad).
    :param keep: uint8 [R, W, 2D+F] each node's own type's input keep-mask
        (None when rate == 0).
    :param rT: [R, W, D] residual term, or None.
    :param feats: [R, W, F]; w_stk: [T*D, 2D+F+1] the per-type [Ws|Wa|Wf|b].
    :param nm: [R, W] float node mask; activations: one name per type.
    Returns (y [R, W, D], agg [R, W, D], marg [R, W], msum [R, T, D]).
    """
    kw = dict(activations=tuple(activations), alpha_drop=alpha_drop, rate=rate,
              threshold=threshold)
    if y1.device.type == "cpu":
        return bnT_forward_step_ref(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk,
                                    nm, **kw)
    _require_cuda(y1)
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    Bl, W, T = _check_typed(adj_loop, adj_dep, R, D, Fd, types, w_stk, activations)
    dev = y1.device
    keep, (y, agg, marg, msum) = _fwdT_operands(y1, y2, aff, keep, rT, feats, nm, W, T, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        ws = _Workspace(R, W, D, Fd, T).allocate(lib, "bnT_forward", dev)
        err = lib.gnn_bnT_forward(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y1), _ptr(y2), _ptr(aff), _ptr(types), _ptr(keep),
            _ptr(rT), _ptr(feats), _ptr(w_stk), _ptr(nm), _ptr(y), _ptr(agg), _ptr(marg),
            _ptr(msum), R, Bl, W, D, Fd, T, float(threshold), _ptr(_act_codes(activations, dev)),
            mode, a, b, _stream(dev), _ptr(ws))
    _build.check(err, "bnT_forward_step (K16)")
    launches["bnT_forward_step"] += 1
    return y, agg, marg, msum


def _fwdT_operands(y1, y2, aff, keep, rT, feats, nm, W: int, T: int, rate: float):
    """K16's (K16_bf16's) operands but the adjacency, the types and the
    weights checked: (the keep-mask, the outputs (y, agg, marg, msum)
    allocated)."""
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    dev = y1.device
    for name, t in (("y1", y1), ("y2", y2), ("rT", rT)):
        if t is not None:
            _check(name, t, (R, W, D), dev)
    _check("aff", aff, (2, 2, T, D), dev)
    _check("feats", feats, (R, W, Fd), dev)
    _check("nm", nm, (R, W), dev)
    keep = _check_keep(keep, (R, W, 2 * D + Fd), dev, rate)
    y = torch.empty((R, W, D), dtype=torch.float32, device=dev)
    return keep, (y, torch.empty_like(y), torch.empty((R, W), dtype=torch.float32, device=dev),
                  torch.empty((R, T, D), dtype=torch.float32, device=dev))


def bnT_backward_step(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk, ds_in, gsel,
                      bnv, flag, nm, *, activations, alpha_drop: bool, rate: float):
    """K17: one reverse typed BN-training iteration over every block row.

    :param y_prev / y_k / agg: [R, W, D] the forward's pre-BN activations of
        iterations k-1 and k and the aggregation of k.
    :param ds_in: [R, W, D] the state cotangent from iteration k+1.
    :param gsel: [R, W, D] the returned state's cotangent, added when `flag`
        (a 0-d float tensor on the device) is 1.
    :param bnv: [T, 9, D] each type's BatchNorm coefficients (BNV_ROWS).
    Other arguments as bnT_forward_step. Returns (ds [R, W, D], dw
    [R, T*D, C], dagg [R, W, D], red [R, T, 2, D]), dw and red per block row.
    """
    kw = dict(activations=tuple(activations), alpha_drop=alpha_drop, rate=rate)
    if y_prev.device.type == "cpu":
        return bnT_backward_step_ref(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats,
                                     w_stk, ds_in, gsel, bnv, flag, nm, **kw)
    _require_cuda(y_prev)
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    C = 2 * D + Fd + 1
    Bl, W, T = _check_typed(adj_loop, adj_dep, R, D, Fd, types, w_stk, activations)
    dev = y_prev.device
    keep, (ds, dw, dagg, red) = _bwdT_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv,
                                               flag, nm, W, T, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        ws = _Workspace(R, W, D, Fd, T).allocate(lib, "bnT_backward", dev)
        err = lib.gnn_bnT_backward(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y_prev), _ptr(y_k), _ptr(agg), _ptr(types),
            _ptr(keep), _ptr(feats), _ptr(w_stk), _ptr(ds_in), _ptr(gsel), _ptr(bnv), _ptr(flag),
            _ptr(nm), _ptr(ds), _ptr(dw), _ptr(dagg), _ptr(red), R, Bl, W, D, Fd, T,
            _ptr(_act_codes(activations, dev)), mode, a, b, _stream(dev), _ptr(ws))
    _build.check(err, "bnT_backward_step (K17)")
    launches["bnT_backward_step"] += 1
    return ds, dw, dagg, red


def _bwdT_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv, flag, nm, W: int, T: int,
                   rate: float):
    """K17's (K17_bf16's) operands but the adjacency, the types and the
    weights checked: (the keep-mask, the outputs (ds, dw, dagg, red)
    allocated)."""
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    C = 2 * D + Fd + 1
    dev = y_prev.device
    for name, t in (("y_prev", y_prev), ("y_k", y_k), ("agg", agg), ("ds_in", ds_in),
                    ("gsel", gsel)):
        _check(name, t, (R, W, D), dev)
    _check("feats", feats, (R, W, Fd), dev)
    _check("bnv", bnv, (T, len(BNV_ROWS), D), dev)
    _check("flag", flag, (), dev)
    _check("nm", nm, (R, W), dev)
    keep = _check_keep(keep, (R, W, C - 1), dev, rate)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return keep, (out(R, W, D), out(R, T * D, C), out(R, W, D), out(R, T, 2, D))


def bnT_bf16_smem_bytes(W: int, D: int, F: int) -> int:
    """Shared memory of a K16_bf16 / K17_bf16 CTA (ops/csrc/bn_typed_bf16.cu::
    bnT_bf16_smem): K1_bf16's (bn.bn_bf16_smem_bytes: the bf16 adjacency
    [W][W], x3 [W][2D+F] and three rows [W][D] of floats) and the node types
    [W] as ints. The number of types takes no room."""
    return 2 * W * W + 4 * W * (5 * D + F + 1)


def bnT_forward_step_bf16(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats, w_stk, nm, *,
                          activations, alpha_drop: bool, rate: float, threshold: float):
    """K16_bf16: one typed BN-training iteration over every block row of a
    bf16 adjacency (gnn_tpu's _bnT_fwd_kernel with hp false). Arguments and
    result as bnT_forward_step's, adj_loop / adj_dep bf16."""
    kw = dict(activations=tuple(activations), alpha_drop=alpha_drop, rate=rate,
              threshold=threshold)
    if y1.device.type == "cpu":
        return bnT_forward_step_bf16_ref(adj_loop, adj_dep, y1, y2, aff, types, keep, rT, feats,
                                         w_stk, nm, **kw)
    _require_cuda(y1)
    R, _, D = y1.shape
    Fd = feats.shape[-1]
    Bl, W = _check_bf16_blocks(adj_loop, adj_dep, R, D, Fd, "K16_bf16", bnT_bf16_smem_bytes)
    T = _check_types(R, W, D, Fd, types, w_stk, activations)
    dev = y1.device
    keep, (y, agg, marg, msum) = _fwdT_operands(y1, y2, aff, keep, rT, feats, nm, W, T, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_bnT_forward_bf16(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y1), _ptr(y2), _ptr(aff), _ptr(types), _ptr(keep),
            _ptr(rT), _ptr(feats), _ptr(w_stk), _ptr(nm), _ptr(y), _ptr(agg), _ptr(marg),
            _ptr(msum), R, Bl, W, D, Fd, T, float(threshold), _ptr(_act_codes(activations, dev)),
            mode, a, b, _stream(dev))
    _build.check(err, "bnT_forward_step_bf16 (K16_bf16)")
    launches["bnT_forward_step_bf16"] += 1
    return y, agg, marg, msum


def bnT_backward_step_bf16(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats, w_stk, ds_in,
                           gsel, bnv, flag, nm, *, activations, alpha_drop: bool, rate: float):
    """K17_bf16: one reverse typed BN-training iteration over every block row
    of a bf16 adjacency (gnn_tpu's _bnT_bwd_kernel with hp false). Arguments
    and result as bnT_backward_step's, adj_loop / adj_dep bf16."""
    kw = dict(activations=tuple(activations), alpha_drop=alpha_drop, rate=rate)
    if y_prev.device.type == "cpu":
        return bnT_backward_step_bf16_ref(adj_loop, adj_dep, y_prev, y_k, agg, types, keep, feats,
                                          w_stk, ds_in, gsel, bnv, flag, nm, **kw)
    _require_cuda(y_prev)
    R, _, D = y_prev.shape
    Fd = feats.shape[-1]
    Bl, W = _check_bf16_blocks(adj_loop, adj_dep, R, D, Fd, "K17_bf16", bnT_bf16_smem_bytes)
    T = _check_types(R, W, D, Fd, types, w_stk, activations)
    dev = y_prev.device
    keep, (ds, dw, dagg, red) = _bwdT_operands(y_prev, y_k, agg, keep, feats, ds_in, gsel, bnv,
                                               flag, nm, W, T, rate)
    mode, a, b = _drop_args(alpha_drop, rate)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_bnT_backward_bf16(
            _ptr(adj_loop), _ptr(adj_dep), _ptr(y_prev), _ptr(y_k), _ptr(agg), _ptr(types),
            _ptr(keep), _ptr(feats), _ptr(w_stk), _ptr(ds_in), _ptr(gsel), _ptr(bnv), _ptr(flag),
            _ptr(nm), _ptr(ds), _ptr(dw), _ptr(dagg), _ptr(red), R, Bl, W, D, Fd, T,
            _ptr(_act_codes(activations, dev)), mode, a, b, _stream(dev))
    _build.check(err, "bnT_backward_step_bf16 (K17_bf16)")
    launches["bnT_backward_step_bf16"] += 1
    return ds, dw, dagg, red


# ------------------------------------------------------------- the K-loop
@dataclasses.dataclass
class TypedLoopOperands(BNLoopOperands):
    """bn_train_loop's operands of a typed loop: `types` set, `activations`
    one per type, the weights (w_stk,); iterations run K16 and K17 (K16_bf16
    and K17_bf16 on a bf16 adjacency)."""

    def forward_step(self, k, y1, y2, aff, rT, weights):
        step = bnT_forward_step_bf16 if self.bf16 else bnT_forward_step
        return step(self.adj_loop, self.adj_dep, y1, y2, aff, self.types, self.keep_k(k), rT,
                    self.feats, *weights, self.nm, threshold=self.threshold, **self.step_kw())

    def backward_step(self, k, y_prev, y_k, agg, weights, ds_in, gsel, bnv, flag):
        step = bnT_backward_step_bf16 if self.bf16 else bnT_backward_step
        ds, dw, dagg, red = step(self.adj_loop, self.adj_dep, y_prev, y_k, agg, self.types,
                                 self.keep_k(k), self.feats, *weights, ds_in, gsel, bnv, flag,
                                 self.nm, **self.step_kw())
        return ds, [dw], dagg, red

    def step_kw(self):
        return dict(activations=self.activations, alpha_drop=self.alpha_drop, rate=self.rate)


def _own_type_keep(keep_states, types):
    """bool [K, Np, C]: each node's own type's keep-mask, from one bool
    [K, Np, C] draw per type (gnn_tpu's per-node selection of the keep
    stream, pallas_typed.py:635-650)."""
    sel = keep_states[0]
    for t in range(1, len(keep_states)):
        sel = torch.where((types == t)[None, :, None], keep_states[t], sel)
    return sel


def typed_operands(spec, params_state, gb, training: bool, keep_states=None, init=None):
    """(s0 [R, W, D], w_stk [T*D, 2D+F+1], TypedLoopOperands) of a
    blocked batch with node types: the per-type bias-augmented weights
    stacked, the block rows [loop blocks | dep blocks] with their node mask,
    types and residual arcs (with their source's type), and each node's own
    type's keep-masks (no dropout at eval). At state_dim > 0 the labels and
    their aggregation fold into the features (ops/fold.py, gnn_tpu
    composite.py:139-151).

    :param keep_states: in training, one bool [K, Np, in_dim] input keep-mask
        per type in global node order (None without input dropout).
    :param init: the initial state [Np, state_dim] at state_dim > 0."""
    blocks, nm, res = block_rows(gb)
    ss = spec.state_specs[0]
    rate = input_rate(ss) if training else 0.0
    cols = kernel_columns(spec, gb.nodes.shape[1])
    keep = None
    if rate > 0.0:
        if keep_states is None:
            raise ValueError("a keep-mask for dropout position 0 is required in training")
        keep = block_keep(blocks, _own_type_keep(keep_states, gb.node_types), rate, cols)
    types = blocks(gb.node_types[:, None])[..., 0].to(torch.int32)
    res_type = None
    if res is not None:
        res_type = types.reshape(-1)[res[0]].long()
    op = TypedLoopOperands(adj_loop=gb.adj_loop, adj_dep=gb.adj_dep, keep=keep,
                           feats=blocks(fold_features(spec, gb)), nm=nm, res=res,
                           K=spec.max_iteration,
                           threshold=float(spec.threshold),
                           activations=tuple(s.activations[0] for s in spec.state_specs),
                           alpha_drop=bool(ss.alphadropout), rate=rate, types=types,
                           res_type=res_type, n_types=spec.n_types)
    w_stk = torch.cat([augmented(p["dense_0"], cols) for p in params_state])
    return blocks(initial_state(spec, gb, init)), w_stk, op


def bn_typed_train_propagate(spec, params_state, bn_state, gb, keep_states=None, init=None):
    """Typed BN training propagation of models/composite.py on a
    blocked batch with node types (gnn_tpu's bn_typed_train_propagate):
    the K-loop of K16/K17 with per-type moments, then each type's
    active-gated moving statistics. Returns (iters, state [Np, D], the new
    per-type BatchNorm statistics as a tuple)."""
    s0, w_stk, op = typed_operands(spec, params_state, gb, True, keep_states, init)
    gamma = torch.stack([p["bn"]["gamma"] for p in params_state])
    beta = torch.stack([p["bn"]["beta"] for p in params_state])
    iters, state3, moms = bn_train_loop(s0, (w_stk,), gamma, beta, op)
    state = state3.index_select(0, gb.block_perm).reshape(gb.n_node_pad, -1)
    return iters, state, tuple(moving_stats(b, moms[:, t], iters) for t, b in enumerate(bn_state))


def typed_eval_propagate(spec, params_state, bn_state, gb, init=None):
    """Typed inference propagation (gnn_tpu's typed_eval_propagate): K16 once
    an iteration with rate 0, the first with the identity affine, the later
    ones with each type's fixed inference affine (identity without
    BatchNorm; on a bf16 adjacency evaluated in float64 and rounded once, as
    core.inference_affine); the moment sums are not used. The early stop and snapshot
    as the training loop's, the snapshot normalized by each node's own
    type's affine. Returns (iters, state [Np, D], bn_state unchanged)."""
    s0, w_stk, op = typed_operands(spec, params_state, gb, False, init=init)
    D = s0.shape[-1]
    T = spec.n_types
    ident = _ident_aff(D, s0)[:, None].expand(2, T, D)
    if spec.state_specs[0].batch_normalization:
        aff1 = torch.stack([_affine(p["bn"]["gamma"], p["bn"]["beta"], b["mean"], b["var"],
                                    op.bf16)
                            for p, b in zip(params_state, bn_state)], dim=1)      # [2, T, D]
    else:
        aff1 = ident
    y1, y2, a1, a2 = s0, torch.ones_like(s0), ident, ident
    ys, margs = [], []
    for k in range(op.K):
        rT = None if op.res is None else _res_term(y1, a1, op.res, op)
        y, _, marg, _ = op.forward_step(k, y1, y2, torch.stack([a1, a2]), rT, (w_stk,))
        y2, a2 = y1, a1
        y1, a1 = y, aff1
        ys.append(y)
        margs.append(marg)
    loop_any = (torch.stack(margs) > 0.5).flatten(1).any(dim=1)
    iters = torch.sum(torch.cumprod(loop_any.float(), dim=0))
    idx = torch.clamp_min(iters.long() - 1, 0).reshape(1)
    y_sel = torch.stack(ys).index_select(0, idx)[0]
    state3 = torch.where(iters >= 1.0, y_sel * op.sel(aff1[0]) + op.sel(aff1[1]), s0)
    return iters, state3.index_select(0, gb.block_perm).reshape(gb.n_node_pad, -1), bn_state
