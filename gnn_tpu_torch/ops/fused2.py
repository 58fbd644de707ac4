"""Propagation kernels of a two-layer state net (counterpart of the
two-layer half of gnn_tpu/ops/pallas_fused.py): the eval kernels K9/K10 with
K10's reverse K11, and the dropout-training kernels K12/K13, which run the
hidden-150 accuracy recipe.

One iteration on a block of W nodes, node-major:

    agg = adjT^T @ s (+ rT),   x3 = [drop(s) | drop(agg) | f]
    s'  = act1(w1 @ act0(w0 @ x3 + b0) + b1) (* scale + shift)

with w0 [H1, 2D + AL] the whole first dense layer [Ws | Wa | Wf] and w1
[D, H1] (the params' dense_0.w and dense_1.w), f the arc-label aggregation
and (scale, shift) the inference BatchNorm. gnn_tpu's kernels multiply first
and contract the adjacency H1 wide, and read a hoisted H1-wide feature term
Wf @ f + b0; these aggregate the D-wide state first and form the feature
term from f's AL columns: the same linear map at D/H1 of the adjacency
operations and AL/H1 of the feature bytes.

* `propagation_loop2` (K10, replaces `_loop2_kernel_T`): all K eval
  iterations of residual-free blocks, f the raw arc-label aggregation; the
  states after every iteration and the pre-update movement flags.
* `propagation_loop2_bwd` (K11, replaces `_loop2_bwd_kernel`): K10's K
  reverse iterations, recomputing each iteration's aggregation (K10 saves
  none): the state cotangent, per-block weight and affine partials and the
  cotangent of f, summed over the iterations (f is loop-invariant).
* `propagation_step2` (K9, replaces `_step2_kernel_T`): one eval iteration of
  residual-coupled blocks. rT is the raw residual aggregation, added to agg
  before w0; gnn_tpu passes it through W0a instead (the same linear map at
  D/H1 of the bytes).
* `train_loop2` (K12, replaces `_loop2_train_kernel_T`): all K
  dropout-training iterations of residual-free blocks, f = fd[k] the dropped
  arc-label aggregation of iteration k; also the pre-dropout aggregations.
* `train_loop2_bwd` (K13, replaces `_loop2_train_bwd_kernel`): K12's K
  reverse iterations: the state cotangent, per-block weight partials and
  fd's cotangent.

On a batch whose block adjacency is bf16 (gnn_tpu's low-precision mode,
its kernels' `hp = False` branch) the eval kernels have bf16 variants, in
gnn_tpu's association: they multiply first and contract the adjacency H1
wide, with the rounding points of _iter_core, _dense1_fm and
_loop2_bwd_kernel. Write bf(x) for x rounded to bf16 (nearest even) and
used as f32; every product of two bf values is exact in f32 and the sums
accumulate in f32:

    U  = bf(s) @ bf(w20)^T                 w20 = [W0s; W0a] [2H1, D]
    h0 = U_s + bf(U_a) contracted with adjT (bf16) + fT (+ rT)
    s' = act1(bf(act0(h0)) @ bf(w1)^T + b1) (* scale + shift)

with fT = W0fold @ feats + b0 and the residual term rT = W0a @ Σres H1
wide, both f32, outside the rounding.

* `propagation_loop2_bf16` (K10_bf16, ops/csrc/loop2_bf16.cu, replaces
  `_loop2_kernel_T` with hp false): all K iterations of residual-free blocks,
  the aggregation on bf16 tensor-core tiles (ops/csrc/mma_bf16.cuh), the
  weights rounded and zero-padded once a call (`tile_bf16`).
* `propagation_loop2_bwd_bf16` (K11_bf16, eval_loop2_bwd_bf16.cu, replaces
  `_loop2_bwd_kernel` with hp false): its K reverse iterations, the forward
  recomputed with the same rounding and the reverse products on bf16
  operands (dy0 = bf(dh1) @ bf(w1), dua = bf(dh0) contracted with adjT,
  gs = bf(du) @ bf(w20)); dw20, dw1 and db1 sum f32 operands in f32.
* `propagation_step2_bf16` (K9_bf16, fused2_bf16.cu, replaces
  `_step2_kernel_T` with hp false): one iteration of residual-coupled
  blocks; its backward is gnn_tpu's `_step2_bwd`, an f32 recompute with the
  bf16 adjacency upcast.

The dropout-training kernels' bf16 variants keep gnn_tpu's association of
_loop2_train_kernel_T (the dropout sits between the aggregation and w0):
agg = bf(s) contracted with adjT D wide, x3 = [drop(s) | drop(agg) | fd] in
f32, h0 = bf(x3) @ bf(w0)^T + b0, then the second layer as above:

* `train_loop2_bf16` (K12_bf16, ops/csrc/train_loop2_bf16.cu, replaces
  `_loop2_train_kernel_T` with hp false): all K iterations of residual-free
  blocks, the aggregations saved.
* `train_loop2_bwd_bf16` (K13_bf16, the same source, replaces
  `_loop2_train_bwd_kernel` with hp false): its K reverse iterations from
  the saved aggregations, dy0 = bf(dh1) @ bf(w1), dx3 = bf(dh0) @ bf(w0) and
  ds = bf(dagg) contracted with adjT; dw0, db0, dw1 and db1 sum f32
  operands node by node, a block each.

Their plain versions sum every product in a fixed order (`_seq_dot`: the
contracted index ascending), which the CUDA-core kernels follow, so on the
card such a kernel and its plain version differ only where the activations'
last bits do. K10_bf16 adds its aggregation on the tensor cores in their
own order (as gnn_tpu's MXU dots do, in an order of their own): those sums
of a destination's few arcs are exact in f32 on the sets served here, and
its dense layers keep the plain version's order, since in another order
about 2^-14 of their bf16 roundings flip and at full scale the flips
compound past Part B's one-flip bound (tools/bf16_order.py); it is held to
its plain version by Part B's gate. Against gnn_tpu's XLA products, too, an
f32 sum in another order can move a value across a bf16 rounding boundary. The f32 kernels aggregate the D-wide
state first; the bf16 ones contract bf(U_a), H1/D of those operations.

The differentiable ops are torch.autograd.Functions: `fused_propagation_loop2`
(K10, backward K11), which trains a two-layer net without dropout and
BatchNorm, `fused_train_loop2` (K12, backward K13),
`fused_train_loop2_bf16` (K12_bf16, backward K13_bf16) and
`fused_propagation_step2` (K9, a plain backward as gnn_tpu's XLA rule
`_step2_bwd`). The reverse of the two dense layers is one plain function,
`_dense2_vjp`, in every plain version.

Layout and rules as ops/fused.py: node-major blocks s [B, W, D], f
[(K,) B, W, AL], adjT [B, W(src), W(dst)], keep-masks uint8 [K, B, W, D]. Each
wrapper runs its plain PyTorch version (`*_ref`) for CPU tensors and launches
the CUDA kernel (ops/csrc/fused2.cu: K9; loop2.cu: K10, K12;
eval_loop2_bwd.cu: K11; train_loop2_bwd.cu: K13; the bf16 variants' sources
above) for CUDA tensors;
`launches` counts kernel launches. The register-tiled kernels of
ops/csrc/tile2.cuh (K9, K10, K11, K12, K13 and ops/bn.py's K14 and K15) take
every state, arc-label and hidden width (`_tile2_plan`): the first of their
staged shared-memory plans that fits (D and AL up to 64), else their wide
plan, which keeps the [C][W]- and [D][W]-sized regions in a device-memory
workspace the wrapper allocates (`_tile2_wide`, fused._Workspace). The dense
layers set these kernels' least time.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from gnn_tpu_torch.ops.fused import (_ACT_CODE, _ACTS, FUSABLE_ACTIVATIONS, SMEM_BYTES,
                                     _act_grad, _affine, _at, _check, _check_keep, _drop_args,
                                     _first_plan, _make_drop, _plan_info, _ptr, _r4, _Workspace,
                                     launch_counted, moved)

# the largest hidden width the per-node kernels that the staged plans replace
# took (the staged plans' design range: each fits every shape up to it; the
# wide plan takes the rest)
MAX_HIDDEN = 512

# the kernel each wrapper launches (C entry point gnn_<wrapper>)
_KERNEL = {"propagation_step2": "K9", "propagation_loop2": "K10",
           "propagation_loop2_bwd": "K11", "train_loop2": "K12", "train_loop2_bwd": "K13",
           "propagation_step2_bf16": "K9_bf16", "propagation_loop2_bf16": "K10_bf16",
           "propagation_loop2_bwd_bf16": "K11_bf16", "train_loop2_bf16": "K12_bf16",
           "train_loop2_bwd_bf16": "K13_bf16"}
# kernel launches since the last reset, by wrapper
launches = dict.fromkeys(_KERNEL, 0)
_launch = functools.partial(launch_counted, launches, _KERNEL)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supports_fused2(state_spec, training: bool) -> bool:
    """The two-layer eval kernels K9/K10 take the spec: two dense layers with
    kernel activations; in training no dropout and no BatchNorm (at eval
    dropout is off and the BatchNorm is an affine)."""
    if state_spec.num_layers != 2 or any(a not in FUSABLE_ACTIVATIONS
                                         for a in state_spec.activations):
        return False
    return not (training and (state_spec.dropout_rate or state_spec.batch_normalization))


def supports_fused2_train(state_spec) -> bool:
    """The two-layer training kernels K12/K13 take the spec: two dense layers
    with kernel activations, dropout only at the input, no BatchNorm."""
    return (state_spec.num_layers == 2
            and all(a in FUSABLE_ACTIVATIONS for a in state_spec.activations)
            and all(p == 0 for p in state_spec.dropout_pos)
            and not state_spec.batch_normalization)


# ------------------------------------------------------------ plain versions
def dense2(x3, w0, b0, w1, b1, act0: str, act1: str):
    """The two-layer state net on rows x3: act1(w1 @ act0(w0 @ x3 + b0) + b1)."""
    return _ACTS[act1](F.linear(_ACTS[act0](F.linear(x3, w0, b0)), w1, b1))


def _aggregate(adjT, s):
    """agg[b, dst] = sum_src adjT[b, src, dst] * s[b, src]."""
    return torch.matmul(adjT.transpose(1, 2), s)


def propagation_step2_ref(adjT, s, rT, feats, w0, b0, w1, b1, affine=None, act0: str = "tanh",
                          act1: str = "tanh"):
    """Plain PyTorch K9: one iteration, [B, W, D] -> [B, W, D]; rT is the raw
    residual aggregation [B, W, D] or None."""
    aff = _affine(affine, s.shape[-1], s)
    agg = _aggregate(adjT, s)
    if rT is not None:
        agg = agg + rT
    return dense2(torch.cat([s, agg, feats], dim=-1), w0, b0, w1, b1, act0, act1) * aff[0] + aff[1]


def propagation_loop2_ref(adjT, s0, feats, w0, b0, w1, b1, affine, nm, K: int, threshold: float,
                          act0: str = "tanh", act1: str = "tanh"):
    """Plain PyTorch K10: (traj [K, B, W, D], margins [K, B, W]); margins[k]
    is nm where the node moved before update k (s_old starting at ones)."""
    s, s_old = s0, torch.ones_like(s0)
    traj, margins = [], []
    for _ in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        s_old, s = s, propagation_step2_ref(adjT, s, None, feats, w0, b0, w1, b1, affine, act0,
                                            act1)
        traj.append(s)
    return torch.stack(traj), torch.stack(margins)


def _x3(s, agg, fd_k, ms_k, ma_k, drop):
    return torch.cat([drop(s, ms_k), drop(agg, ma_k), fd_k], dim=-1)


def train_loop2_ref(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K: int, threshold: float,
                    act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                    rate: float = 0.0):
    """Plain PyTorch K12: (traj [K, B, W, D], margins [K, B, W], agg
    [K, B, W, D] the aggregations before the dropout)."""
    drop, _ = _make_drop(alpha_drop, rate)
    s, s_old = s0, torch.ones_like(s0)
    traj, margins, aggs = [], [], []
    for k in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        agg = _aggregate(adjT, s)
        s_old, s = s, dense2(_x3(s, agg, fd[k], _at(ms, k), _at(ma, k), drop), w0, b0, w1, b1,
                             act0, act1)
        traj.append(s)
        aggs.append(agg)
    return torch.stack(traj), torch.stack(margins), torch.stack(aggs)


def _dense2_vjp(x3, w0, b0, w1, b1, g, act0: str, act1: str, affine=None,
                act_grad=_act_grad):
    """Reverse of s = act1(w1 @ act0(w0 @ x3 + b0) + b1) (* scale + shift) on
    the rows x3 [B, W, C] for the cotangent g [B, W, D] of s: (dx3 [B, W, C],
    dw0 [B, H1, C], db0 [B, H1], dw1 [B, D, H1], db1 [B, D], daff [B, 2, D]
    or None without an affine), the weight cotangents per block. act_grad
    (name, h) is the activations' derivative, taken for act1 and then act0."""
    h0 = F.linear(x3, w0, b0)
    y0 = _ACTS[act0](h0)
    h1 = F.linear(y0, w1, b1)
    daff = None
    if affine is not None:
        daff = torch.stack([torch.sum(g * _ACTS[act1](h1), dim=1), torch.sum(g, dim=1)], dim=1)
        g = g * affine[0]
    dh1 = g * act_grad(act1, h1)
    dh0 = torch.matmul(dh1, w1) * act_grad(act0, h0)
    return (torch.matmul(dh0, w0), torch.matmul(dh0.transpose(1, 2), x3), dh0.sum(1),
            torch.matmul(dh1.transpose(1, 2), y0), dh1.sum(1), daff)


def _weight_sums(s0, w0):
    """Zero per-block cotangents of w0, b0, w1, b1 for s0's blocks."""
    B, _, D = s0.shape
    H1 = w0.shape[0]
    return [s0.new_zeros((B,) + tuple(w0.shape)), s0.new_zeros((B, H1)), s0.new_zeros((B, D, H1)),
            s0.new_zeros((B, D))]


def train_loop2_bwd_ref(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj,
                        act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                        rate: float = 0.0, act_grad=_act_grad):
    """Plain PyTorch K13: the K reverse iterations of K12 for the trajectory's
    cotangent g_traj. Returns (gs [B, W, D], dw0 [B, H1, 2D + AL], db0
    [B, H1], dw1 [B, D, H1], db1 [B, D], dfd [K, B, W, AL]), the weight
    cotangents per block. act_grad as _dense2_vjp's, taken in reverse
    iteration order."""
    drop, dmask = _make_drop(alpha_drop, rate)
    D = s0.shape[-1]
    gs = torch.zeros_like(s0)
    sums = _weight_sums(s0, w0)
    dfd = [None] * traj.shape[0]
    for k in reversed(range(traj.shape[0])):
        x3 = _x3(traj[k - 1] if k else s0, agg[k], fd[k], _at(ms, k), _at(ma, k), drop)
        dx3, *parts, _ = _dense2_vjp(x3, w0, b0, w1, b1, g_traj[k] + gs, act0, act1,
                                     act_grad=act_grad)
        sums = [a + b for a, b in zip(sums, parts)]
        dfd[k] = dx3[..., 2 * D:]
        gs = (dx3[..., :D] * dmask(_at(ms, k))
              + torch.matmul(adjT, dx3[..., D:2 * D] * dmask(_at(ma, k))))
    return (gs, *sums, torch.stack(dfd))


def propagation_loop2_bwd_ref(adjT, s0, traj, feats, w0, b0, w1, b1, affine, g_traj,
                              act0: str = "tanh", act1: str = "tanh", act_grad=_act_grad):
    """Plain PyTorch K11: the K reverse iterations of K10 for the trajectory's
    cotangent g_traj, each recomputing its iteration's aggregation. Returns
    (gs [B, W, D], dw0 [B, H1, 2D + AL], db0 [B, H1], dw1 [B, D, H1], db1
    [B, D], dfeats [B, W, AL] summed over the iterations, daff [B, 2, D] or
    None without an affine), the weight and affine cotangents per block.
    act_grad as train_loop2_bwd_ref's."""
    D = s0.shape[-1]
    gs = torch.zeros_like(s0)
    sums = _weight_sums(s0, w0)
    dfeats = torch.zeros_like(feats)
    daff = None if affine is None else s0.new_zeros((s0.shape[0], 2, D))
    for k in reversed(range(traj.shape[0])):
        s_in = traj[k - 1] if k else s0
        x3 = torch.cat([s_in, _aggregate(adjT, s_in), feats], dim=-1)
        dx3, *parts, daff_k = _dense2_vjp(x3, w0, b0, w1, b1, g_traj[k] + gs, act0, act1, affine,
                                          act_grad)
        sums = [a + b for a, b in zip(sums, parts)]
        if daff is not None:
            daff = daff + daff_k
        dfeats = dfeats + dx3[..., 2 * D:]
        gs = dx3[..., :D] + torch.matmul(adjT, dx3[..., D:2 * D])
    return (gs, *sums, dfeats, daff)


def _step2_vjp(adjT, s, rT, feats, w0, b0, w1, b1, affine, g, act0: str, act1: str):
    """Plain backward of K9 (gnn_tpu's _step2_bwd, with the raw residual):
    (ds, drT, dfeats, dw0, db0, dw1, db1, daff); drT is None without rT,
    daff None without an affine. drT is the aggregation's cotangent."""
    D = s.shape[-1]
    agg = _aggregate(adjT, s)
    if rT is not None:
        agg = agg + rT
    dx3, dw0, db0, dw1, db1, daff = _dense2_vjp(torch.cat([s, agg, feats], dim=-1), w0, b0, w1,
                                                b1, g, act0, act1, affine)
    dagg = dx3[..., D:2 * D]
    return (dx3[..., :D] + torch.matmul(adjT, dagg), None if rT is None else dagg,
            dx3[..., 2 * D:], dw0.sum(0), db0.sum(0), dw1.sum(0), db1.sum(0),
            None if daff is None else daff.sum(0))


# ------------------------------------------------- bf16 adjacency: plain
def round_bf16(point: str, x):
    """bf(x): x rounded to bf16 to nearest even and used as f32. `point`
    names the rounding point (s, w20, ua, y0, w1; in the reverse dh1, dh0,
    du, w20): the plain versions look this function up at each call, so a
    check may replace it, e.g. by one that flips an entry."""
    return x.to(torch.bfloat16).to(torch.float32)


def _bf(point: str, x):
    return round_bf16(point, x)


def act64(name: str, x):
    """The activation evaluated in float64 and rounded to f32 once: the
    correctly rounded value on every device (to within float64's own last
    bit), so that the card's kernels, their plain versions and the CPU take
    the same bf16 rounding of y0."""
    return _ACTS[name](x.double()).float()


def act_grad64(name: str, h):
    """d act / d h in float64, rounded to f32 once (act64's reason)."""
    return _act_grad(name, h.double()).float()


def seq_dot(x, w):
    """x [..., C] @ w [O, C]^T summed over c ascending, one f32 add a term:
    the bf16 kernels' order, which the card and the CPU follow alike (each
    product rounded once, then added). Differentiable; the bf16 plain
    versions use `_exact_dot`."""
    acc = x[..., 0:1] * w[:, 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c:c + 1] * w[:, c]
    return acc


def _exact_dot(x, w, pairs: bool = False):
    """seq_dot of bf values, whose products are exact: one rank-1 update
    (addr_) a term, which gives the same bits whether or not a device fuses
    its multiply and add. With `pairs`, x [..., 2H] and w [O, 2H] are summed
    over unit h ascending, unit h's first-half column then its second-half
    column (H + h): the order in which the bf16 reverse kernel's hidden
    chunks take du = [dh0 | dua]."""
    C = x.shape[-1]
    x2 = x.reshape(-1, C)
    cols = [c for h in range(C // 2) for c in (h, C // 2 + h)] if pairs else range(C)
    acc = x2.new_zeros((x2.shape[0], w.shape[0]))
    for c in cols:
        acc.addr_(x2[:, c], w[:, c])
    return acc.reshape(x.shape[:-1] + (w.shape[0],))


def _adj_slots(adj):
    """The bf16 kernels' aggregation order of an adjacency adj (f32 holding
    bf16 values [B, W(src), Wd]): each destination's nonzero sources,
    ascending, one slot at a time, as (sources [B, M, Wd], weights
    [B, M, Wd]), M the most nonzero sources a destination has. A zero
    weight adds a zero, so skipping it keeps the dense sum's bits."""
    W = adj.shape[1]
    nz = adj != 0
    M = int(nz.sum(1).max()) if adj.numel() else 0
    src = torch.arange(W, device=adj.device)[None, :, None]
    order = torch.sort(torch.where(nz, src, src + W), dim=1).indices[:, :M]
    return order, adj.gather(1, order)


def _exact_adj(slots, x):
    """out[b, dst] = sum_src adj[b, src, dst] * x[b, src] over src ascending,
    x bf values [B, W, H], the adjacency as _adj_slots gives it: the bf16
    kernels' aggregation, one slot's terms added at a time."""
    order, wts = slots
    B, W, H = x.shape
    Wd = order.shape[2]
    acc = x.new_zeros((B * Wd, H))
    base = (torch.arange(B, device=x.device) * W)[:, None]
    xf = x.reshape(B * W, H)
    for m in range(order.shape[1]):
        rows = (order[:, m, :] + base).reshape(-1)
        acc.addcmul_(wts[:, m, :].reshape(-1, 1), xf.index_select(0, rows))
    return acc.reshape(B, Wd, H)


def _forward_bf16(slots, s, fT, w20, w1, b1, act0: str, rT=None):
    """One bf16 iteration up to h1: (h0 [B, W, H1], y0, h1 [B, W, D])."""
    H1 = w20.shape[0] // 2
    u = _exact_dot(_bf("s", s), _bf("w20", w20))                  # [B, W, 2H1]
    h0 = u[..., :H1] + _exact_adj(slots, _bf("ua", u[..., H1:])) + fT
    if rT is not None:
        h0 = h0 + rT
    y0 = act64(act0, h0)
    return h0, y0, _exact_dot(_bf("y0", y0), _bf("w1", w1)) + b1


def _step2_bf16(slots, s, rT, fT, w20, w1, b1, aff, act0, act1):
    _, _, h1 = _forward_bf16(slots, s, fT, w20, w1, b1, act0, rT)
    return act64(act1, h1) * aff[0] + aff[1]


def propagation_step2_bf16_ref(adjT, s, rT, fT, w20, w1, b1, affine=None, act0: str = "tanh",
                               act1: str = "tanh"):
    """Plain PyTorch K9_bf16: one iteration, [B, W, D] -> [B, W, D]; adjT
    bf16, rT the residual term through W0a [B, W, H1] or None."""
    return _step2_bf16(_adj_slots(adjT.float()), s, rT, fT, w20, w1, b1,
                       _affine(affine, s.shape[-1], s), act0, act1)


def propagation_loop2_bf16_ref(adjT, s0, fT, w20, w1, b1, affine, nm, K: int, threshold: float,
                               act0: str = "tanh", act1: str = "tanh"):
    """Plain PyTorch K10_bf16: (traj [K, B, W, D], margins [K, B, W]) as
    propagation_loop2_ref's."""
    slots, aff = _adj_slots(adjT.float()), _affine(affine, s0.shape[-1], s0)
    s, s_old = s0, torch.ones_like(s0)
    traj, margins = [], []
    for _ in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        s_old, s = s, _step2_bf16(slots, s, None, fT, w20, w1, b1, aff, act0, act1)
        traj.append(s)
    return torch.stack(traj), torch.stack(margins)


def propagation_loop2_bwd_bf16_ref(adjT, s0, traj, fT, w20, w1, b1, affine, g_traj,
                                   act0: str = "tanh", act1: str = "tanh"):
    """Plain PyTorch K11_bf16 (gnn_tpu's _loop2_bwd_kernel, hp false): the K
    reverse iterations of K10_bf16 for the trajectory's cotangent g_traj.
    Returns (gs [B, W, D], dw20 [B, 2H1, D], dw1 [B, D, H1], db1 [B, D], dfT
    [B, W, H1] summed over the iterations, daff [B, 2, D] or None without
    an affine), the weight and affine cotangents per block."""
    adj = adjT.float()
    slots, slots_t = _adj_slots(adj), _adj_slots(adj.transpose(1, 2))
    B, W, D = s0.shape
    H1 = w20.shape[0] // 2
    gs = torch.zeros_like(s0)
    dw20 = s0.new_zeros((B, 2 * H1, D))
    dw1, db1 = s0.new_zeros((B, D, H1)), s0.new_zeros((B, D))
    dfT = torch.zeros_like(fT)
    daff = None if affine is None else s0.new_zeros((B, 2, D))
    for k in reversed(range(traj.shape[0])):
        s_in = traj[k - 1] if k else s0
        h0, y0, h1 = _forward_bf16(slots, s_in, fT, w20, w1, b1, act0)
        gy = g_traj[k] + gs
        if affine is not None:
            daff = daff + torch.stack([torch.sum(gy * act64(act1, h1), dim=1),
                                       torch.sum(gy, dim=1)], dim=1)
            gy = gy * affine[0]
        dh1 = gy * act_grad64(act1, h1)                               # [B, W, D]
        db1 = db1 + dh1.sum(1)
        dw1 = dw1 + torch.matmul(dh1.transpose(1, 2), y0)
        dh0 = _exact_dot(_bf("dh1", dh1), _bf("w1", w1).t()) * act_grad64(act0, h0)
        dfT = dfT + dh0
        dua = _exact_adj(slots_t, _bf("dh0", dh0))                   # over dst, by src
        du = torch.cat([dh0, dua], dim=-1)                            # [B, W, 2H1]
        dw20 = dw20 + torch.matmul(du.transpose(1, 2), s_in)
        gs = _exact_dot(_bf("du", du), _bf("w20", w20).t(), pairs=True)
    return gs, dw20, dw1, db1, dfT, daff


def node_sum(x):
    """x [B, W, ...] summed over the block's nodes in order, one f32 add a
    node: the bf16 kernels' block sums."""
    acc = torch.zeros_like(x[:, 0])
    for n in range(x.shape[1]):
        acc = acc + x[:, n]
    return acc


def node_outer(a, b):
    """[B, P, Q] = sum over the block's nodes n in order of a[:, n] (x) b[:, n]
    (a [B, W, P], b [B, W, Q]), each product rounded, then one f32 add a node:
    the bf16 kernels' per-block weight partials of f32 operands."""
    acc = a.new_zeros((a.shape[0], a.shape[2], b.shape[2]))
    for n in range(a.shape[1]):
        acc = acc + a[:, n, :, None] * b[:, n, None, :]
    return acc


def _x3_bf16(x3, D: int):
    """bf(x3) of the two-layer training kernels' dense input [drop(s) |
    drop(agg) | fd], rounded at the points x3s, x3 (the aggregated slice,
    the one that holds a sum over the adjacency) and x3f."""
    return torch.cat([_bf("x3s", x3[..., :D]), _bf("x3", x3[..., D:2 * D]),
                      _bf("x3f", x3[..., 2 * D:])], dim=-1)


def _dense2_bf16(x3, w0, b0, w1, b1, act0: str):
    """(h0, y0, h1) of a bf16 training iteration from its f32 dense input x3:
    h0 = bf(x3) @ bf(w0)^T + b0, y0 = act0(h0), h1 = bf(y0) @ bf(w1)^T + b1
    (gnn_tpu's _mm_packed and _dense1_fm with hp false)."""
    h0 = _exact_dot(_x3_bf16(x3, w1.shape[0]), _bf("w0", w0)) + b0
    y0 = act64(act0, h0)
    return h0, y0, _exact_dot(_bf("y0", y0), _bf("w1", w1)) + b1


def train_loop2_bf16_ref(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K: int, threshold: float,
                         act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                         rate: float = 0.0):
    """Plain PyTorch K12_bf16 (gnn_tpu's _loop2_train_kernel_T with hp false):
    each iteration aggregates bf(s) D wide over the bf16 adjacency (agg, f32
    sums, saved), forms x3 = [drop(s) | drop(agg) | fd] in f32 and runs
    _dense2_bf16 on it; every sum in the kernel's order. Returns (traj
    [K, B, W, D], margins [K, B, W], agg [K, B, W, D]) as train_loop2_ref's."""
    drop, _ = _make_drop(alpha_drop, rate)
    slots = _adj_slots(adjT.float())
    s, s_old = s0, torch.ones_like(s0)
    traj, margins, aggs = [], [], []
    for k in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        agg = _exact_adj(slots, _bf("s", s))
        x3 = _x3(s, agg, fd[k], _at(ms, k), _at(ma, k), drop)
        s_old, s = s, act64(act1, _dense2_bf16(x3, w0, b0, w1, b1, act0)[2])
        traj.append(s)
        aggs.append(agg)
    return torch.stack(traj), torch.stack(margins), torch.stack(aggs)


def train_loop2_bwd_bf16_ref(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj,
                             act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                             rate: float = 0.0):
    """Plain PyTorch K13_bf16 (gnn_tpu's _loop2_train_bwd_kernel with hp
    false): the K reverse iterations of K12_bf16, each recomputing h0, y0 and
    h1 from the saved aggregation; dy0 = bf(dh1) @ bf(w1), dx3 = bf(dh0) @
    bf(w0), the aggregation's reverse over bf(dagg) (rounding points dh1,
    dh0, dagg); dw1, dw0 (of y0 and x3 unrounded), db1 and db0 summed node by
    node. Returns (gs, dw0, db0, dw1, db1, dfd) as train_loop2_bwd_ref's, the
    weight cotangents per block."""
    drop, dmask = _make_drop(alpha_drop, rate)
    slots_t = _adj_slots(adjT.float().transpose(1, 2))
    D = s0.shape[-1]
    gs = torch.zeros_like(s0)
    sums = _weight_sums(s0, w0)
    dfd = [None] * traj.shape[0]
    for k in reversed(range(traj.shape[0])):
        x3 = _x3(traj[k - 1] if k else s0, agg[k], fd[k], _at(ms, k), _at(ma, k), drop)
        h0, y0, h1 = _dense2_bf16(x3, w0, b0, w1, b1, act0)
        dh1 = (g_traj[k] + gs) * act_grad64(act1, h1)
        dh0 = _exact_dot(_bf("dh1", dh1), _bf("w1", w1).t()) * act_grad64(act0, h0)
        parts = (node_outer(dh0, x3), node_sum(dh0), node_outer(dh1, y0), node_sum(dh1))
        sums = [a + b for a, b in zip(sums, parts)]
        dx3 = _exact_dot(_bf("dh0", dh0), _bf("w0", w0).t())
        dfd[k] = dx3[..., 2 * D:]
        dagg = dx3[..., D:2 * D] * dmask(_at(ma, k))
        gs = dx3[..., :D] * dmask(_at(ms, k)) + _exact_adj(slots_t, _bf("dagg", dagg))
    return (gs, *sums, torch.stack(dfd))


def _step2_bf16_vjp(adjT, s, rT, fT, w20, w1, b1, affine, g, act0: str, act1: str):
    """Backward of K9_bf16: gnn_tpu's _step2_bwd as it is, an f32 recompute
    of the step (no rounding) with the bf16 adjacency upcast. Returns (ds,
    drT, dfT, dw20, dw1, db1, daff); drT None without rT, daff None without
    an affine."""
    adj = adjT.float()
    H1 = w20.shape[0] // 2
    u = torch.matmul(s, w20.t())                                       # [B, W, 2H1]
    h0 = u[..., :H1] + torch.matmul(adj.transpose(1, 2), u[..., H1:]) + fT
    if rT is not None:
        h0 = h0 + rT
    y0 = _ACTS[act0](h0)
    h1 = F.linear(y0, w1, b1)
    daff = None
    if affine is not None:
        daff = torch.stack([torch.sum(g * _ACTS[act1](h1), dim=(0, 1)),
                            torch.sum(g, dim=(0, 1))])
        g = g * affine[0]
    dh1 = g * _act_grad(act1, h1)
    dw1 = torch.einsum("bwd,bwh->dh", dh1, y0)
    dh0 = torch.matmul(dh1, w1) * _act_grad(act0, h0)
    du = torch.cat([dh0, torch.matmul(adj, dh0)], dim=-1)
    return (torch.matmul(du, w20), None if rT is None else dh0, dh0,
            torch.einsum("bwk,bwd->kd", du, s), dw1, dh1.sum((0, 1)), daff)


# ------------------------------------------------------------------ wrappers
# tile2.cuh's plan lists, in order of preference: (units a thread ut, y0
# tiles, keep h0, weight partials in shared memory, prefetch, adjacency list
# room E, hidden stride with S / 4 odd, w1 read from device memory). The first
# is the hidden-150 recipe's, the last fits every shape the per-node kernels
# took.
_PLANS = {
    "K10": ((4, 2, 0, 0, 0, 16, 1, 0), (4, 1, 0, 0, 0, 0, 1, 1)),             # kLoop2Plans
    "K12": ((4, 2, 0, 0, 0, 16, 1, 0), (4, 1, 0, 0, 0, 0, 1, 1)),             # kTrainLoop2Plans
    "K13": ((4, 1, 1, 1, 1, 16, 1, 0), (4, 1, 1, 1, 0, 16, 1, 0),             # kTrain2Plans
            (4, 1, 0, 0, 0, 16, 1, 0), (2, 1, 0, 0, 0, 0, 0, 1)),
    "K11": ((4, 2, 1, 1, 1, 16, 1, 0), (4, 1, 0, 0, 0, 16, 1, 0),             # kLoop2BwdPlans
            (2, 1, 0, 0, 0, 0, 0, 1)),
    "K15": ((4, 1, 0, 0, 0, 16, 1, 0), (2, 1, 0, 0, 0, 0, 0, 1)),             # kBn2BwdPlans
    "K14": ((4, 2, 0, 0, 1, 16, 1, 0), (4, 1, 0, 0, 0, 0, 0, 1)),             # kBn2FwdPlans
    "K9": ((4, 2, 0, 0, 0, 16, 1, 0), (4, 1, 0, 0, 0, 0, 0, 1)),              # kStep2Plans
}
# tile2.cuh's kTile2Wide, every tiled kernel's wide plan (after its list)
_WIDE = (4, 1, 0, 0, 0, 16, 0, 1)
# tile2.cuh::Tile2Kind of each kernel's layout: the forward, the reverse step,
# the reverse step with the aggregation again, K14's BatchNorm forward, K9's
# step
_KIND = {"K10": 0, "K12": 0, "K13": 1, "K15": 1, "K11": 2, "K14": 3, "K9": 4}


def _tile2_bytes(kind: int, W, D, AL, H1, plan):
    """Shared memory of tile2.cuh::tile2_layout: x3 [C][W], y0 tiles, the
    weights w0T [C][S], w1 [D][S] (unless read from device memory), b0 [S],
    b1, the forward's affine [2][D] (unused by K12); a reverse step's
    g/dh1/gs rows [D][W], h0 block (or a chunk of it), prefetched rows and
    weight partials; K11's second list set, its daff [2][D] and dfeats
    [AL][W] beside the partials and its scale [D]; K14's affines [4][D], then
    from a 16-byte boundary its node mask [W], row buffer [W][D | 1] and,
    with pf, keep bytes [W][C] (AL: its F) in 16-byte units; K9's affine
    [2][D], then from a 16-byte boundary its row buffer [W][D | 1]; the
    adjacency lists ([E][W] floats, W counts and E*W indices as bytes, a
    set). The widths may be ints or numpy integer arrays."""
    ut, nbuf, keep, dw, pf, E, pad, w1g = plan
    C, CH, nl = 2 * D + AL, 8 * ut, 2 if kind == 2 else 1
    S = -(-H1 // ut) * ut
    S = S + 4 * pad * ((S // 4) % 2 == 0)
    floats = C * W + nbuf * CH * W + C * S + (1 - w1g) * D * S + S + nl * E * W + D
    if kind == 0:
        floats = floats + 2 * D
    elif kind == 3:
        floats = _r4(_r4(floats + 4 * D) + W + W * (D | 1)) + pf * (W * C + 15) // 16 * 4
    elif kind == 4:
        floats = _r4(floats + 2 * D) + W * (D | 1)
    else:
        floats = floats + (D * W + (S if keep else CH) * W
                           + pf * (2 * D if kind == 2 else 3 * D + AL) * W
                           + dw * (H1 * (C + 1) + D * H1 + D))
    if kind == 2:
        floats = floats + dw * (2 * D + AL * W) + D
    return 4 * floats + nl * (W + E * W if E else 0)


def _tile2_wide(kind: int, W, D, AL, H1):
    """tile2.cuh::tile2_layout(..., wide = true) of kTile2Wide: (shared-memory
    bytes, workspace floats a block row). The workspace holds x3 [C][W], a
    reverse step's G [D][W] and dx3 [C][W], h1 [D][W], the forward's K12
    state [D][W], K14's and K9's row buffer [W][D | 1] (rounded up to 16
    bytes); shared memory the y0 tile [32][W], a reverse step's h0 tile
    [32][W], the lists ([16][W] floats, W counts and 16*W indices as bytes, a
    set) and K14's node mask [W]."""
    ut, nbuf, E = _WIDE[0], _WIDE[1], _WIDE[5]
    C, CH, nl, rev = 2 * D + AL, 8 * ut, 2 if kind == 2 else 1, kind in (1, 2)
    ws = (C * W + rev * (D * W + C * W) + D * W + (kind == 0) * D * W
          + (kind in (3, 4)) * _r4(W * (D | 1)))
    floats = nbuf * CH * W + rev * CH * W + nl * E * W + (kind == 3) * W
    return 4 * floats + nl * (W + E * W), ws


def _tile2_plan(W: int, D: int, AL: int, H1: int, kernel: str):
    """(shared-memory bytes, plan index) of the tiled kernel K9, K10, K11,
    K12, K13, K14 or K15 at this shape (AL: K14's and K15's F): the first
    staged plan that fits a CTA (D and AL up to 64), else the wide plan
    (index len(_PLANS[kernel])), which fits every shape at W <= 128."""
    kind = _KIND[kernel]
    wide = functools.partial(_tile2_wide, kind)
    if max(D, AL) <= 64:
        return _first_plan(_PLANS[kernel], functools.partial(_tile2_bytes, kind), W, D, AL, H1,
                           wide=wide)
    need = int(wide(W, D, AL, H1)[0])
    return need, (len(_PLANS[kernel]) if need <= SMEM_BYTES else None)


# the C entries of the tiled kernels, by kernel
_TILED = {"K9": "gnn_propagation_step2", "K10": "gnn_propagation_loop2",
          "K11": "gnn_propagation_loop2_bwd",
          "K12": "gnn_train_loop2", "K13": "gnn_train_loop2_bwd", "K14": "gnn_bn2_forward",
          "K15": "gnn_bn2_backward"}


def tile_info(kernel: str, W: int, D: int, AL: int, H1: int) -> dict:
    """fused._plan_info of the tiled kernel K9, K10, K11, K12, K13, K14 or
    K15 (AL: K14's and K15's F)."""
    return _plan_info(_TILED[kernel], W, D, AL, H1)


def _check_block2(adjT, H1: int):
    """The block width and hidden width the kernels take (every state,
    arc-label and hidden width has a plan at W <= 128)."""
    B, W, W2 = adjT.shape
    if W != W2 or W % 32 or not 32 <= W <= 128:
        raise ValueError(f"block width must be 32, 64, 96 or 128, got adjT {tuple(adjT.shape)}")
    if H1 < 1:
        raise ValueError(f"hidden width H1={H1} must be positive")
    if adjT.device.type != "cuda":
        raise ValueError(f"propagation kernels need CPU or CUDA tensors, got {adjT.device}")


def _check_weights(w0, b0, w1, b1, D: int, AL: int, dev):
    """w0 [H1, 2D + AL], b0 [H1], w1 [D, H1], b1 [D]."""
    H1 = w0.shape[0]
    _check("w0", w0, (H1, 2 * D + AL), dev)
    _check("b0", b0, (H1,), dev)
    _check("w1", w1, (D, H1), dev)
    _check("b1", b1, (D,), dev)


def propagation_step2(adjT, s, rT, feats, w0, b0, w1, b1, affine=None, act0: str = "tanh",
                      act1: str = "tanh"):
    """K9: one two-layer eval iteration over residual-coupled blocks.

    :param adjT: [B, W, W] transposed block adjacency, adjT[b, src, dst] = w.
    :param s: [B, W, D] node states.
    :param rT: [B, W, D] raw residual aggregation (added to agg), or None.
    :param feats: [B, W, AL] arc-label aggregation.
    :param w0, b0: [H1, 2D + AL], [H1] the first dense layer [Ws | Wa | Wf].
    :param w1, b1: [D, H1], [D] the second.
    :param affine: optional [2, D] (scale; shift) after act1.
    Returns [B, W, D].
    """
    if adjT.device.type == "cpu":
        return propagation_step2_ref(adjT, s, rT, feats, w0, b0, w1, b1, affine, act0, act1)
    B, W, _ = adjT.shape
    D, AL = s.shape[-1], feats.shape[-1]
    H1 = w0.shape[0]
    _check_block2(adjT, H1)
    dev = adjT.device
    aff = _affine(affine, D, s)
    _check("adjT", adjT, (B, W, W), dev)
    _check("s", s, (B, W, D), dev)
    if rT is not None:
        _check("rT", rT, (B, W, D), dev)
    _check("feats", feats, (B, W, AL), dev)
    _check_weights(w0, b0, w1, b1, D, AL, dev)
    _check("affine", aff, (2, D), dev)
    out = torch.empty((B, W, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    _launch("propagation_step2", dev,
            _ptr(adjT), _ptr(s), _ptr(rT), _ptr(feats), _ptr(w0), _ptr(b0), _ptr(w1), _ptr(b1),
            _ptr(aff), _ptr(out), B, W, D, AL, H1, _ACT_CODE[act0], _ACT_CODE[act1],
            _Workspace(B, W, D, AL, H1))
    return out


def propagation_loop2(adjT, s0, feats, w0, b0, w1, b1, affine, nm, K: int, threshold: float,
                      act0: str = "tanh", act1: str = "tanh"):
    """K10: all K two-layer eval iterations over residual-free blocks.

    :param adjT: [B, W, W] transposed block adjacency of the loop blocks.
    :param s0: [B, W, D] initial states; feats: [B, W, AL].
    :param w0, b0, w1, b1, affine: as propagation_step2.
    :param nm: [B, W] float node mask (1 real, 0 pad).
    Returns (traj [K, B, W, D], margins [K, B, W]).
    """
    if adjT.device.type == "cpu":
        return propagation_loop2_ref(adjT, s0, feats, w0, b0, w1, b1, affine, nm, K, threshold,
                                     act0, act1)
    B, W, _ = adjT.shape
    D, AL = s0.shape[-1], feats.shape[-1]
    H1 = w0.shape[0]
    _check_block2(adjT, H1)
    dev = adjT.device
    aff = _affine(affine, D, s0)
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    _check("feats", feats, (B, W, AL), dev)
    _check_weights(w0, b0, w1, b1, D, AL, dev)
    _check("affine", aff, (2, D), dev)
    _check("nm", nm, (B, W), dev)
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return traj, margins
    _launch("propagation_loop2", dev,
            _ptr(adjT), _ptr(s0), _ptr(feats), _ptr(w0), _ptr(b0), _ptr(w1), _ptr(b1), _ptr(aff),
            _ptr(nm), _ptr(traj), _ptr(margins), B, W, D, AL, H1, int(K), float(threshold),
            _ACT_CODE[act0], _ACT_CODE[act1], _Workspace(B, W, D, AL, H1))
    return traj, margins


def propagation_loop2_bwd(adjT, s0, traj, feats, w0, b0, w1, b1, affine, g_traj,
                          act0: str = "tanh", act1: str = "tanh"):
    """K11: the K reverse iterations of K10 over residual-free blocks.

    :param traj: [K, B, W, D] K10's trajectory; g_traj: its cotangent.
    Other arguments as propagation_loop2. Returns (gs [B, W, D], dw0
    [B, H1, 2D + AL], db0 [B, H1], dw1 [B, D, H1], db1 [B, D], dfeats
    [B, W, AL], daff [B, 2, D] or None without an affine), the weight and
    affine cotangents per block, dfeats summed over the iterations.
    """
    if adjT.device.type == "cpu":
        return propagation_loop2_bwd_ref(adjT, s0, traj, feats, w0, b0, w1, b1, affine, g_traj,
                                         act0, act1)
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, AL = s0.shape[-1], feats.shape[-1]
    H1 = w0.shape[0]
    _check_block2(adjT, H1)
    dev = adjT.device
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    _check("traj", traj, (K, B, W, D), dev)
    _check("g_traj", g_traj, (K, B, W, D), dev)
    _check("feats", feats, (B, W, AL), dev)
    _check_weights(w0, b0, w1, b1, D, AL, dev)
    if affine is not None:
        _check("affine", affine, (2, D), dev)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    gs, dfeats = out(B, W, D), out(B, W, AL)
    dw0, db0, dw1, db1 = out(B, H1, 2 * D + AL), out(B, H1), out(B, D, H1), out(B, D)
    daff = None if affine is None else out(B, 2, D)
    if B == 0 or K == 0:
        return tuple(None if t is None else t.zero_()
                     for t in (gs, dw0, db0, dw1, db1, dfeats, daff))
    _launch("propagation_loop2_bwd", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(feats), _ptr(w0), _ptr(b0), _ptr(w1),
            _ptr(b1), _ptr(affine), _ptr(g_traj), _ptr(gs), _ptr(dw0), _ptr(db0), _ptr(dw1),
            _ptr(db1), _ptr(dfeats), _ptr(daff), B, W, D, AL, H1, K, _ACT_CODE[act0],
            _ACT_CODE[act1], _Workspace(B, W, D, AL, H1))
    return gs, dw0, db0, dw1, db1, dfeats, daff


def train_loop2(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K: int, threshold: float,
                act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                rate: float = 0.0):
    """K12: all K two-layer dropout-training iterations over residual-free
    blocks.

    :param adjT: [B, W, W] transposed block adjacency of the loop blocks.
    :param s0: [B, W, D] initial states.
    :param ms / ma: uint8 [K, B, W, D] keep-masks of the state and aggregated
        slices of the dense input (None when rate == 0).
    :param fd: [K, B, W, AL] the arc-label aggregation after each iteration's
        dropout.
    :param w0, b0, w1, b1: as propagation_step2; nm: [B, W] float node mask.
    Returns (traj [K, B, W, D], margins [K, B, W], agg [K, B, W, D]).
    """
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop2_ref(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K, threshold, **kw)
    B, W, _ = adjT.shape
    D, AL = s0.shape[-1], fd.shape[-1]
    H1 = w0.shape[0]
    _check_block2(adjT, H1)
    dev = adjT.device
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    _check("fd", fd, (K, B, W, AL), dev)
    _check_weights(w0, b0, w1, b1, D, AL, dev)
    _check("nm", nm, (B, W), dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    agg = torch.empty_like(traj)
    if B == 0 or K == 0:
        return traj, margins, agg
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop2", dev,
            _ptr(adjT), _ptr(s0), _ptr(ms), _ptr(ma), _ptr(fd), _ptr(w0), _ptr(b0), _ptr(w1),
            _ptr(b1), _ptr(nm), _ptr(traj), _ptr(margins), _ptr(agg), B, W, D, AL, H1, int(K),
            float(threshold), _ACT_CODE[act0], _ACT_CODE[act1], mode, a, b,
            _Workspace(B, W, D, AL, H1))
    return traj, margins, agg


def train_loop2_bwd(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, act0: str = "tanh",
                    act1: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """K13: the K reverse iterations of K12 over residual-free blocks.

    :param traj, agg: [K, B, W, D] K12's trajectory and aggregations.
    :param g_traj: [K, B, W, D] the trajectory's cotangent.
    Other arguments as train_loop2. Returns (gs [B, W, D], dw0 [B, H1, 2D + AL],
    db0 [B, H1], dw1 [B, D, H1], db1 [B, D], dfd [K, B, W, AL]), the weight
    cotangents per block.
    """
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop2_bwd_ref(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj, **kw)
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, AL = s0.shape[-1], fd.shape[-1]
    H1 = w0.shape[0]
    _check_block2(adjT, H1)
    dev = adjT.device
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    for name, t in (("traj", traj), ("agg", agg), ("g_traj", g_traj)):
        _check(name, t, (K, B, W, D), dev)
    _check("fd", fd, (K, B, W, AL), dev)
    _check_weights(w0, b0, w1, b1, D, AL, dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    gs, dfd = out(B, W, D), out(K, B, W, AL)
    dw0, db0, dw1, db1 = out(B, H1, 2 * D + AL), out(B, H1), out(B, D, H1), out(B, D)
    if B == 0 or K == 0:
        return tuple(t.zero_() for t in (gs, dw0, db0, dw1, db1, dfd))
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop2_bwd", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(agg), _ptr(ms), _ptr(ma), _ptr(fd), _ptr(w0),
            _ptr(b0), _ptr(w1), _ptr(b1), _ptr(g_traj), _ptr(gs), _ptr(dw0), _ptr(db0),
            _ptr(dw1), _ptr(db1), _ptr(dfd), B, W, D, AL, H1, K, _ACT_CODE[act0],
            _ACT_CODE[act1], mode, a, b, _Workspace(B, W, D, AL, H1))
    return gs, dw0, db0, dw1, db1, dfd


# ------------------------------------------------- bf16 adjacency: wrappers
BF16_CHUNK = 32     # hidden units a chunk of the CUDA-core bf16 kernels (kBf16Chunk)
TWO_CTAS_BYTES = 233472 // 2 - 1024   # shared memory a CTA may take with two an SM


def pad16(x: int) -> int:
    """x rounded up to a multiple of 16, the bf16 tensor-core tiles' depth
    (ops/csrc/mma_bf16.cuh::pad16)."""
    return (x + 15) // 16 * 16


def tile_bf16(w, rows: int, cols: int):
    """bf(w) [r, c] in a zero-padded bf16 tile [rows, cols] (rows >= r, cols
    >= c): the weights of the redesigned bf16 kernels (K10_bf16, K15_bf16),
    rounded once a call in place of once a term. Its values are
    round_bf16's, its padding exact zeros, so padded hidden units and
    columns add exact zeros."""
    out = torch.zeros((rows, cols), dtype=torch.bfloat16, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
    return out


def loop2_bf16_layout(W: int, D: int, H1: int):
    """(HC, bytes) of K10_bf16's CTA (ops/csrc/loop2_bf16.cu::
    loop2_bf16_layout): the bf16 adjacency [W][W+8], bf(s) [W][pad16(D)+8],
    bf(U_a) of a chunk of HC hidden units [W][HC+8], bf(y0) of the chunk
    [W][HC] and h1's f32 sums [W][D]; HC is the widest multiple of 16, up to
    pad16(H1), that leaves two CTAs an SM (TWO_CTAS_BYTES), else that fits
    SMEM_BYTES (below 16: the widths do not fit, and bytes are those of a
    16-unit chunk)."""
    fixed = 2 * W * (W + 8 + pad16(D) + 8 + 8) + 4 * W * D
    hc = (TWO_CTAS_BYTES - fixed) // (4 * W) // 16 * 16
    if hc < 16:
        hc = max(SMEM_BYTES - fixed, 0) // (4 * W) // 16 * 16
    hc = min(hc, pad16(H1))
    return hc, fixed + 4 * W * max(hc, 16)


def bf16_smem_bytes(kernel: str, W: int, D: int, AL: int = 0) -> int:
    """Shared memory of a bf16 kernel's CTA (ops/csrc/bf16.cuh::bf16_smem,
    loop2_bf16.cu::loop2_bf16_layout, train_loop2_bf16.cu::train2_bf16_smem,
    train_loop_bf16.cu::train_bf16_smem): K10_bf16's tensor-core layout with
    the least hidden chunk, 16 units (loop2_bf16_layout), which is what its
    widths need to launch; else the bf16
    adjacency [W][W], then floats: K9_bf16's state and h1 rows [W][D] and the
    U_a and y0 chunks [W][CH]; K11_bf16 and K5_bf16 also a [W][D] gs row and
    the dh0 and dua chunks; K12_bf16 the state and h1 rows, bf(x3) [W][C] (C
    = 2D + AL) and a y0 chunk; K13_bf16 two rows [W][D], x3, bf(x3) and dx3
    [W][C] and three chunks; the one-layer dropout kernels (AL = 0, C = 2D):
    K7_bf16 the state and its successor [W][D] and bf(x2) [W][C], K8_bf16 gs
    and dh [W][D], x2 and bf(x2) [W][C], K6_bf16 the state [W][D] and
    bf(x2)."""
    if kernel == "K10_bf16":
        return loop2_bf16_layout(W, D, 16)[1]
    C = 2 * D + AL
    rows, chunks, wide = {"K11_bf16": (3, 4, 0), "K5_bf16": (3, 4, 0), "K12_bf16": (2, 1, 1),
                          "K13_bf16": (2, 3, 3), "K7_bf16": (2, 0, 1), "K8_bf16": (2, 0, 2),
                          "K6_bf16": (1, 0, 1)}.get(kernel, (2, 2, 0))
    return 2 * W * W + 4 * W * (rows * D + wide * C + chunks * BF16_CHUNK)


def _check_bf16(adjT, D: int, H1: int, kernel: str, AL: int = 0):
    """The bf16 kernels' adjacency (a contiguous bf16 [B, W, W] on the card,
    16-byte aligned), block width and the shared memory of the widths."""
    B, W, W2 = adjT.shape
    if W != W2 or W % 32 or not 32 <= W <= 128:
        raise ValueError(f"block width must be 32, 64, 96 or 128, got adjT {tuple(adjT.shape)}")
    if adjT.device.type != "cuda":
        raise ValueError(f"propagation kernels need CPU or CUDA tensors, got {adjT.device}")
    if adjT.dtype != torch.bfloat16 or not adjT.is_contiguous() or adjT.data_ptr() % 16:
        raise ValueError(f"{kernel} needs a contiguous, 16-byte aligned bf16 adjT, got "
                         f"{adjT.dtype}")
    if H1 < 1:
        raise ValueError(f"hidden width H1={H1} must be positive")
    need = bf16_smem_bytes(kernel, W, D, AL)
    if need > SMEM_BYTES:
        raise ValueError(f"{kernel} takes widths whose CTA fits {SMEM_BYTES} bytes of shared "
                         f"memory: D={D}, AL={AL} at W={W} needs {need}")


def _check_bf16_weights(w20, w1, b1, D: int, dev):
    """w20 [2H1, D] = [W0s; W0a], w1 [D, H1], b1 [D]."""
    H1 = w20.shape[0] // 2
    _check("w20", w20, (2 * H1, D), dev)
    _check("w1", w1, (D, H1), dev)
    _check("b1", b1, (D,), dev)


def propagation_step2_bf16(adjT, s, rT, fT, w20, w1, b1, affine=None, act0: str = "tanh",
                           act1: str = "tanh"):
    """K9_bf16: one two-layer eval iteration over residual-coupled blocks of
    a bf16 adjacency (gnn_tpu's _step2_kernel_T with hp false).

    :param adjT: bf16 [B, W, W] transposed block adjacency.
    :param s: [B, W, D] node states.
    :param rT: [B, W, H1] residual term through W0a, or None.
    :param fT: [B, W, H1] the f32 feature term W0fold @ feats + b0.
    :param w20: [2H1, D] the first dense layer's state and aggregation rows
        [W0s; W0a]; w1 [D, H1], b1 [D] the second.
    :param affine: optional [2, D] (scale; shift) after act1.
    Returns [B, W, D].
    """
    if adjT.device.type == "cpu":
        return propagation_step2_bf16_ref(adjT, s, rT, fT, w20, w1, b1, affine, act0, act1)
    B, W, _ = adjT.shape
    D, H1 = s.shape[-1], w20.shape[0] // 2
    _check_bf16(adjT, D, H1, "K9_bf16")
    dev = adjT.device
    aff = _affine(affine, D, s)
    _check("s", s, (B, W, D), dev)
    if rT is not None:
        _check("rT", rT, (B, W, H1), dev)
    _check("fT", fT, (B, W, H1), dev)
    _check_bf16_weights(w20, w1, b1, D, dev)
    _check("affine", aff, (2, D), dev)
    out = torch.empty((B, W, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    _launch("propagation_step2_bf16", dev,
            _ptr(adjT), _ptr(s), _ptr(rT), _ptr(fT), _ptr(w20), _ptr(w1), _ptr(b1), _ptr(aff),
            _ptr(out), B, W, D, H1, _ACT_CODE[act0], _ACT_CODE[act1])
    return out


def propagation_loop2_bf16(adjT, s0, fT, w20, w1, b1, affine, nm, K: int, threshold: float,
                           act0: str = "tanh", act1: str = "tanh"):
    """K10_bf16: all K two-layer eval iterations over residual-free blocks of
    a bf16 adjacency (gnn_tpu's _loop2_kernel_T with hp false).

    :param nm: [B, W] float node mask. Other arguments as
        propagation_step2_bf16. Returns (traj [K, B, W, D], margins [K, B, W]).
    """
    if adjT.device.type == "cpu":
        return propagation_loop2_bf16_ref(adjT, s0, fT, w20, w1, b1, affine, nm, K, threshold,
                                          act0, act1)
    B, W, _ = adjT.shape
    D, H1 = s0.shape[-1], w20.shape[0] // 2
    _check_bf16(adjT, D, H1, "K10_bf16")
    dev = adjT.device
    aff = _affine(affine, D, s0)
    _check("s0", s0, (B, W, D), dev)
    _check("fT", fT, (B, W, H1), dev)
    _check_bf16_weights(w20, w1, b1, D, dev)
    _check("affine", aff, (2, D), dev)
    _check("nm", nm, (B, W), dev)
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return traj, margins
    Dp, H1p = pad16(D), pad16(H1)
    w20t = torch.stack([tile_bf16(w20[:H1].t(), Dp, H1p), tile_bf16(w20[H1:].t(), Dp, H1p)])
    w1t = tile_bf16(w1.t(), H1p, Dp)
    _launch("propagation_loop2_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(fT), _ptr(w20t), _ptr(w1t), _ptr(b1), _ptr(aff), _ptr(nm),
            _ptr(traj), _ptr(margins), B, W, D, H1, int(K), float(threshold), _ACT_CODE[act0],
            _ACT_CODE[act1])
    return traj, margins


def propagation_loop2_bwd_bf16(adjT, s0, traj, fT, w20, w1, b1, affine, g_traj,
                               act0: str = "tanh", act1: str = "tanh"):
    """K11_bf16: the K reverse iterations of K10_bf16 over residual-free
    blocks (gnn_tpu's _loop2_bwd_kernel with hp false).

    :param traj: [K, B, W, D] K10_bf16's trajectory; g_traj: its cotangent.
    Other arguments as propagation_loop2_bf16. Returns (gs [B, W, D], dw20
    [B, 2H1, D], dw1 [B, D, H1], db1 [B, D], dfT [B, W, H1] summed over the
    iterations, daff [B, 2, D] or None without an affine), the weight and
    affine cotangents per block.
    """
    if adjT.device.type == "cpu":
        return propagation_loop2_bwd_bf16_ref(adjT, s0, traj, fT, w20, w1, b1, affine, g_traj,
                                              act0, act1)
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, H1 = s0.shape[-1], w20.shape[0] // 2
    _check_bf16(adjT, D, H1, "K11_bf16")
    dev = adjT.device
    _check("s0", s0, (B, W, D), dev)
    _check("traj", traj, (K, B, W, D), dev)
    _check("g_traj", g_traj, (K, B, W, D), dev)
    _check("fT", fT, (B, W, H1), dev)
    _check_bf16_weights(w20, w1, b1, D, dev)
    if affine is not None:
        _check("affine", affine, (2, D), dev)

    def out(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    gs, dfT = out(B, W, D), out(B, W, H1)
    dw20, dw1, db1 = out(B, 2 * H1, D), out(B, D, H1), out(B, D)
    daff = None if affine is None else out(B, 2, D)
    if B == 0 or K == 0:
        return gs, dw20, dw1, db1, dfT, daff
    _launch("propagation_loop2_bwd_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(fT), _ptr(w20), _ptr(w1), _ptr(b1),
            _ptr(affine), _ptr(g_traj), _ptr(gs), _ptr(dw20), _ptr(dw1), _ptr(db1), _ptr(dfT),
            _ptr(daff), B, W, D, H1, K, _ACT_CODE[act0], _ACT_CODE[act1])
    return gs, dw20, dw1, db1, dfT, daff


def train_loop2_bf16(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K: int, threshold: float,
                     act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                     rate: float = 0.0):
    """K12_bf16: all K two-layer dropout-training iterations over residual-free
    blocks of a bf16 adjacency (gnn_tpu's _loop2_train_kernel_T with hp
    false). Arguments and result as train_loop2's, adjT bf16 [B, W, W]."""
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop2_bf16_ref(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K, threshold, **kw)
    B, W, _ = adjT.shape
    D, AL = s0.shape[-1], fd.shape[-1]
    H1 = w0.shape[0]
    _check_bf16(adjT, D, H1, "K12_bf16", AL)
    dev = adjT.device
    _check("s0", s0, (B, W, D), dev)
    _check("fd", fd, (K, B, W, AL), dev)
    _check_weights(w0, b0, w1, b1, D, AL, dev)
    _check("nm", nm, (B, W), dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    agg = torch.empty_like(traj)
    if B == 0 or K == 0:
        return traj, margins, agg
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop2_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(ms), _ptr(ma), _ptr(fd), _ptr(w0), _ptr(b0), _ptr(w1),
            _ptr(b1), _ptr(nm), _ptr(traj), _ptr(margins), _ptr(agg), B, W, D, AL, H1, int(K),
            float(threshold), _ACT_CODE[act0], _ACT_CODE[act1], mode, a, b)
    return traj, margins, agg


def train_loop2_bwd_bf16(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj,
                         act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                         rate: float = 0.0):
    """K13_bf16: the K reverse iterations of K12_bf16 over residual-free
    blocks (gnn_tpu's _loop2_train_bwd_kernel with hp false). Arguments and
    result as train_loop2_bwd's, adjT bf16 [B, W, W]."""
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop2_bwd_bf16_ref(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, g_traj,
                                        **kw)
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, AL = s0.shape[-1], fd.shape[-1]
    H1 = w0.shape[0]
    _check_bf16(adjT, D, H1, "K13_bf16", AL)
    dev = adjT.device
    _check("s0", s0, (B, W, D), dev)
    for name, t in (("traj", traj), ("agg", agg), ("g_traj", g_traj)):
        _check(name, t, (K, B, W, D), dev)
    _check("fd", fd, (K, B, W, AL), dev)
    _check_weights(w0, b0, w1, b1, D, AL, dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")

    def out(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    gs, dfd = out(B, W, D), out(K, B, W, AL)
    dw0, db0, dw1, db1 = out(B, H1, 2 * D + AL), out(B, H1), out(B, D, H1), out(B, D)
    if B == 0 or K == 0:
        return gs, dw0, db0, dw1, db1, dfd
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop2_bwd_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(agg), _ptr(ms), _ptr(ma), _ptr(fd), _ptr(w0),
            _ptr(b0), _ptr(w1), _ptr(b1), _ptr(g_traj), _ptr(gs), _ptr(dw0), _ptr(db0),
            _ptr(dw1), _ptr(db1), _ptr(dfd), B, W, D, AL, H1, K, _ACT_CODE[act0],
            _ACT_CODE[act1], mode, a, b)
    return gs, dw0, db0, dw1, db1, dfd


# ------------------------------------------------------- differentiable ops
class _PropagationLoop2(torch.autograd.Function):
    """K10 forward, K11 backward (_loop2_fwd / _loop2_bwd)."""

    @staticmethod
    def forward(ctx, s0, feats, w0, b0, w1, b1, affine, adjT, nm, K, threshold, act0, act1):
        traj, margins = propagation_loop2(adjT, s0, feats, w0, b0, w1, b1, affine, nm, K,
                                          threshold, act0, act1)
        ctx.saved = (adjT, s0, traj, feats, w0, b0, w1, b1, affine, act0, act1)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, traj, feats, w0, b0, w1, b1, affine, act0, act1 = ctx.saved
        gs, dw0, db0, dw1, db1, dfeats, daff = propagation_loop2_bwd(
            adjT, s0, traj, feats, w0, b0, w1, b1, affine, g_traj.contiguous(), act0, act1)
        return (gs, dfeats, dw0.sum(0), db0.sum(0), dw1.sum(0), db1.sum(0),
                None if daff is None else daff.sum(0)) + (None,) * 6


class _PropagationStep2(torch.autograd.Function):
    """K9 forward, plain backward (_step2_bwd)."""

    @staticmethod
    def forward(ctx, s, rT, feats, w0, b0, w1, b1, affine, adjT, act0, act1):
        ctx.saved = (adjT, s, rT, feats, w0, b0, w1, b1, affine, act0, act1)
        return propagation_step2(adjT, s, rT, feats, w0, b0, w1, b1, affine, act0, act1)

    @staticmethod
    def backward(ctx, g):
        adjT, s, rT, feats, w0, b0, w1, b1, affine, act0, act1 = ctx.saved
        return _step2_vjp(adjT, s, rT, feats, w0, b0, w1, b1, affine, g, act0, act1) + (None,) * 3


class _TrainLoop2(torch.autograd.Function):
    """K12 forward, K13 backward (_loop2_train_fwd / _loop2_train_bwd)."""

    @staticmethod
    def forward(ctx, s0, fd, w0, b0, w1, b1, adjT, ms, ma, nm, K, threshold, act0, act1,
                alpha_drop, rate):
        kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
        traj, margins, agg = train_loop2(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K, threshold,
                                         **kw)
        ctx.saved = (adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, kw)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, kw = ctx.saved
        gs, dw0, db0, dw1, db1, dfd = train_loop2_bwd(adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1,
                                                      b1, g_traj.contiguous(), **kw)
        return (gs, dfd, dw0.sum(0), db0.sum(0), dw1.sum(0), db1.sum(0)) + (None,) * 10


def fused_propagation_loop2(adjT, s0, feats, w0, b0, w1, b1, affine, nm, K: int,
                            threshold: float, act0: str = "tanh", act1: str = "tanh"):
    """propagation_loop2 (K10) with gradients to s0, feats, w0, b0, w1, b1 and
    affine through K11. Returns (traj, margins); margins carry none."""
    return _PropagationLoop2.apply(s0, feats, w0, b0, w1, b1, affine, adjT, nm, K, threshold,
                                   act0, act1)


def fused_propagation_step2(adjT, s, rT, feats, w0, b0, w1, b1, affine=None, act0: str = "tanh",
                            act1: str = "tanh"):
    """propagation_step2 (K9) with gradients to s, rT, feats, the weights and
    affine."""
    return _PropagationStep2.apply(s, rT, feats, w0, b0, w1, b1, affine, adjT, act0, act1)


def fused_train_loop2(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K: int, threshold: float,
                      act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                      rate: float = 0.0):
    """train_loop2 (K12) with gradients to s0, fd, w0, b0, w1 and b1 through
    K13. Returns (traj, margins); margins carry none."""
    return _TrainLoop2.apply(s0, fd, w0, b0, w1, b1, adjT, ms, ma, nm, K, threshold, act0, act1,
                             alpha_drop, rate)


class _PropagationLoop2Bf16(torch.autograd.Function):
    """K10_bf16 forward, K11_bf16 backward (_loop2_fwd / _loop2_bwd, hp false)."""

    @staticmethod
    def forward(ctx, s0, fT, w20, w1, b1, affine, adjT, nm, K, threshold, act0, act1):
        traj, margins = propagation_loop2_bf16(adjT, s0, fT, w20, w1, b1, affine, nm, K,
                                               threshold, act0, act1)
        ctx.saved = (adjT, s0, traj, fT, w20, w1, b1, affine, act0, act1)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, traj, fT, w20, w1, b1, affine, act0, act1 = ctx.saved
        gs, dw20, dw1, db1, dfT, daff = propagation_loop2_bwd_bf16(
            adjT, s0, traj, fT, w20, w1, b1, affine, g_traj.contiguous(), act0, act1)
        return (gs, dfT, dw20.sum(0), dw1.sum(0), db1.sum(0),
                None if daff is None else daff.sum(0)) + (None,) * 6


class _PropagationStep2Bf16(torch.autograd.Function):
    """K9_bf16 forward, gnn_tpu's plain f32 backward (_step2_bwd)."""

    @staticmethod
    def forward(ctx, s, rT, fT, w20, w1, b1, affine, adjT, act0, act1):
        ctx.saved = (adjT, s, rT, fT, w20, w1, b1, affine, act0, act1)
        return propagation_step2_bf16(adjT, s, rT, fT, w20, w1, b1, affine, act0, act1)

    @staticmethod
    def backward(ctx, g):
        adjT, s, rT, fT, w20, w1, b1, affine, act0, act1 = ctx.saved
        return _step2_bf16_vjp(adjT, s, rT, fT, w20, w1, b1, affine, g, act0, act1) + (None,) * 3


class _TrainLoop2Bf16(torch.autograd.Function):
    """K12_bf16 forward, K13_bf16 backward (_loop2_train_fwd /
    _loop2_train_bwd, hp false); the weight partials a block each, summed in
    block order."""

    @staticmethod
    def forward(ctx, s0, fd, w0, b0, w1, b1, adjT, ms, ma, nm, K, threshold, act0, act1,
                alpha_drop, rate):
        kw = dict(act0=act0, act1=act1, alpha_drop=alpha_drop, rate=rate)
        traj, margins, agg = train_loop2_bf16(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K,
                                              threshold, **kw)
        ctx.saved = (adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, kw)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, traj, agg, ms, ma, fd, w0, b0, w1, b1, kw = ctx.saved
        gs, dw0, db0, dw1, db1, dfd = train_loop2_bwd_bf16(adjT, s0, traj, agg, ms, ma, fd, w0,
                                                           b0, w1, b1, g_traj.contiguous(), **kw)
        return (gs, dfd, dw0.sum(0), db0.sum(0), dw1.sum(0), db1.sum(0)) + (None,) * 10


def fused_train_loop2_bf16(adjT, s0, ms, ma, fd, w0, b0, w1, b1, nm, K: int, threshold: float,
                           act0: str = "tanh", act1: str = "tanh", alpha_drop: bool = True,
                           rate: float = 0.0):
    """train_loop2_bf16 (K12_bf16) with gradients to s0, fd, w0, b0, w1 and
    b1 through K13_bf16. Returns (traj, margins); margins carry none."""
    return _TrainLoop2Bf16.apply(s0, fd, w0, b0, w1, b1, adjT, ms, ma, nm, K, threshold, act0,
                                 act1, alpha_drop, rate)


def fused_propagation_loop2_bf16(adjT, s0, fT, w20, w1, b1, affine, nm, K: int,
                                 threshold: float, act0: str = "tanh", act1: str = "tanh"):
    """propagation_loop2_bf16 (K10_bf16) with gradients to s0, fT, w20, w1, b1
    and affine through K11_bf16. Returns (traj, margins); margins carry none."""
    return _PropagationLoop2Bf16.apply(s0, fT, w20, w1, b1, affine, adjT, nm, K, threshold,
                                       act0, act1)


def fused_propagation_step2_bf16(adjT, s, rT, fT, w20, w1, b1, affine=None, act0: str = "tanh",
                                 act1: str = "tanh"):
    """propagation_step2_bf16 (K9_bf16) with gradients to s, rT, fT, the
    weights and affine through gnn_tpu's f32 backward."""
    return _PropagationStep2Bf16.apply(s, rT, fT, w20, w1, b1, affine, adjT, act0, act1)
