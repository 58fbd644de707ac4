"""Propagation kernels of a one-layer state net (counterpart of
gnn_tpu/ops/pallas_fused.py): the eval kernels K3/K4 with K3's backward K5,
and the dropout-training kernels K6/K7/K8.

Eval, and training without dropout and BatchNorm. The dense layer is
reassociated through the aggregation, so one iteration on a block of W nodes is

    U = s @ [Ws; Wa]^T,   A[dst] = sum_src adjT[src, dst] * U[src, H:]
    s' = act(U[:, :H] + A + fT (+ rT)) * scale + shift

with fT = feats @ Wf^T + b hoisted out of the loop, rT the residual-arc term
(already through Wa) and (scale, shift) the inference BatchNorm.

* `propagation_loop` (K3, replaces `_loop_kernel_T`): all K iterations of
  residual-free blocks in one launch; returns the state after every iteration
  and the pre-update movement flags, from which the caller reproduces the
  reference's global early stop.
* `propagation_step` (K4, replaces `_step_kernel_T`): one iteration of
  residual-coupled blocks.
* `propagation_loop_bwd` (K5, replaces `_loop_bwd_kernel`): K3's K reverse
  iterations.

Training with input dropout and no BatchNorm. The dropout sits between the
aggregation and Wa, so an iteration aggregates the state itself:

    agg = adjT^T @ s (+ rT),  s' = act([Ws | Wa] @ [drop(s); drop(agg)] + fT)

with fT = Wf @ drop(agg_arcs) + b formed outside for every iteration.

* `train_loop` (K7, replaces `_loop_train_kernel_T`): all K iterations of
  residual-free blocks; returns the states, movement flags and pre-dropout
  aggregations.
* `train_loop_bwd` (K8, replaces `_loop_train_bwd_kernel`): K7's K reverse
  iterations, reading the saved aggregations.
* `train_step` (K6, replaces `_train_kernel_T`): one iteration of
  residual-coupled blocks; the state slice arrives dropped, rT is the raw
  residual aggregation.

On a batch whose block adjacency is bf16 (gnn_tpu's low-precision mode,
its kernels' `hp = False` branch) the eval kernels have bf16 variants in
gnn_tpu's rounding (_iter_core): U = bf(s) @ bf([Ws; Wa])^T with f32 sums,
A = bf(U_a) contracted with the bf16 adjacency, then act((U_s + A) + fT
(+ rT)) * scale + shift:

* `propagation_loop_bf16` (K3_bf16, ops/csrc/eval_loop_bf16.cu, replaces
  `_loop_kernel_T` with hp false);
* `propagation_step_bf16` (K4_bf16, the same source, replaces
  `_step_kernel_T` with hp false);
* `propagation_loop_bwd_bf16` (K5_bf16, ops/csrc/eval_loop_bwd_bf16.cu,
  replaces `_loop_bwd_kernel` with hp false): K3_bf16's K reverse
  iterations, the pre-activation recomputed with its rounding, dua =
  bf(dh) contracted with the adjacency, gs = bf([dh | dua]) @ bf(w2).

The dropout-training kernels' bf16 variants keep gnn_tpu's one-pass
rounding (_loop_train_kernel_T, _train_kernel_T with hp false): agg = bf(s)
contracted with the bf16 adjacency (+ rT), x2 = [drop(s) | drop(agg)] in
f32, h = bf(x2) @ bf([Ws | Wa])^T + fT:

* `train_loop_bf16` (K7_bf16, ops/csrc/train_loop_bf16.cu, replaces
  `_loop_train_kernel_T` with hp false): all K iterations of residual-free
  blocks, the aggregations saved;
* `train_loop_bwd_bf16` (K8_bf16, the same source, replaces
  `_loop_train_bwd_kernel` with hp false): its K reverse iterations from the
  saved aggregations, dw of x2 unrounded node by node, dx2 = bf(dh) @ bf(w)
  and ds = bf(dagg) contracted with the adjacency;
* `train_step_bf16` (K6_bf16, the same source, replaces `_train_kernel_T`
  with hp false): one iteration of residual-coupled blocks.

Their plain versions sum in the kernels' order with exact products
(ops/fused2.py's bf16 helpers), so a kernel gives their bits. They train
on a bf16 batch: the clean route through `fused_propagation_loop_bf16`
(K3_bf16, backward K5_bf16) and `fused_propagation_step_bf16` (K4_bf16,
backward gnn_tpu's f32 XLA rule on the upcast adjacency, _PropagationStep's),
the dropout route through `fused_train_loop_bf16` (K7_bf16, backward
K8_bf16) and `fused_train_step_bf16` (K6_bf16, backward _TrainStep's f32
rule on the upcast adjacency, gnn_tpu's _train_bwd_rule).

The differentiable ops are torch.autograd.Functions: `fused_propagation_loop`
(K3, backward K5), `fused_train_loop` (K7, backward K8), and
`fused_propagation_step` (K4) and `fused_train_step` (K6), whose backwards
are plain PyTorch as gnn_tpu's are XLA.

Layout: node-major blocks, s [B, W, D], fT [B, W, H], adjT [B, W(src), W(dst)],
keep-masks uint8 [.., W, D]. Each wrapper runs its plain PyTorch version
(`*_ref`) for CPU tensors and launches the CUDA kernel (ops/csrc/eval_loop.cu:
K3; fused_eval.cu: K4; eval_loop_bwd.cu, train_loop.cu, train_loop_bwd.cu) for
CUDA tensors; it never falls back from one to the other. `launches` counts
kernel launches. Each kernel takes the first of its staged shared-memory plans
that fits a CTA (K3, K5 and K8 have two, K4, K6 and K7 one: `_loop_plan`,
`_loop_bwd_plan`, `_train_bwd_plan`, `_step_plan`, `_train_step_plan`,
`_train_loop_plan`), else its wide plan, which keeps only the adjacency lists
in shared memory and takes every state width (`_loop_wide`, `_step_wide`,
`_loop_bwd_wide`, `_train_step_wide`, `_train_loop_wide`, `_train_bwd_wide`);
the wide plans of K3, K4, K5 and K8 take a device-memory workspace that the
wrapper allocates at the launch (`_Workspace`). On MUTAG-shaped blocks every
kernel's least time is set by the bytes it moves (the adjacency and the
per-iteration rows); the designs and their limits are noted in the sources.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from gnn_tpu_torch.ops import _build
from gnn_tpu_torch.ops.mlp import ALPHA_P, SELU_ALPHA, SELU_SCALE, drop_coeffs

# Activations the kernels evaluate in-kernel; selu is exp(min(x, 0)) - 1 like
# the Pallas kernels (which lack expm1), within ~1e-7 of torch.selu.
_ACTS = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "selu": lambda x: SELU_SCALE * torch.where(
        x > 0, x, SELU_ALPHA * (torch.exp(torch.clamp_max(x, 0.0)) - 1.0)),
}
FUSABLE_ACTIVATIONS = tuple(_ACTS)
_ACT_CODE = {"linear": 0, "tanh": 1, "relu": 2, "selu": 3}


def _act_grad(activation: str, h):
    """d act / d h of the kernel activations, at the pre-activation h."""
    if activation == "linear":
        return torch.ones_like(h)
    if activation == "tanh":
        t = torch.tanh(h)
        return 1.0 - t * t
    if activation == "relu":
        return (h > 0).to(h.dtype)
    if activation == "selu":
        return torch.where(h > 0, SELU_SCALE,
                           SELU_SCALE * SELU_ALPHA * torch.exp(torch.clamp_max(h, 0.0)))
    raise ValueError(activation)


def _make_drop(alpha: bool, rate: float):
    """(drop, dmask) of the training kernels' input dropout from a keep-mask
    (bool or uint8): drop(x, keep) is ops/mlp.py's dropout written as
    a * where(keep, x, ALPHA_P) + b or where(keep, a * x, 0), dmask(keep) its
    derivative a * keep; both are the identity when rate <= 0."""
    if rate <= 0.0:
        return (lambda x, keep: x), (lambda keep: 1.0)
    a, b = drop_coeffs(alpha, rate)
    if alpha:
        def drop(x, keep):
            return a * torch.where(keep.bool(), x, ALPHA_P) + b
    else:
        def drop(x, keep):
            return torch.where(keep.bool(), a * x, 0.0)

    def dmask(keep):
        return a * keep.to(torch.float32)

    return drop, dmask


def _drop_args(alpha_drop: bool, rate: float):
    """(mode, a, b) of the kernels' input dropout: 0 none, 1 alpha, 2 standard."""
    if rate <= 0.0:
        return 0, 1.0, 0.0
    a, b = drop_coeffs(alpha_drop, rate)
    return (1 if alpha_drop else 2), a, b


def supports_fused(state_spec, training: bool) -> bool:
    """The eval kernels K3/K4 take the spec: one dense layer, a kernel
    activation, and in training no dropout and no BatchNorm (K5 is K3's
    backward, K4's is plain)."""
    if state_spec.num_layers != 1 or state_spec.activations[0] not in FUSABLE_ACTIVATIONS:
        return False
    return not (training and (state_spec.dropout_rate or state_spec.batch_normalization))


def supports_fused_train(state_spec) -> bool:
    """The training kernels take the spec: one dense layer, a kernel
    activation, dropout only at the input (position 0). BatchNorm is allowed
    (the BN kernels K1/K2; without it the dropout kernels K6-K8)."""
    return (state_spec.num_layers == 1
            and state_spec.activations[0] in FUSABLE_ACTIVATIONS
            and all(p == 0 for p in state_spec.dropout_pos))


SMEM_BYTES = 232448          # shared memory a CTA may use (227 KB)

# eval_loop.cu's kLoopPlans, K3's staged shared-memory plans in order of
# preference: (threads a CTA, room of the column lists). The first is the
# flagship's; the wide plan (_loop_wide) follows them.
_LOOP_PLANS = ((256, 16), (128, 0))

# fused_eval.cu's K4 plan (kStepThreads, kStepLists): threads a CTA, room of
# the column lists; the staged plan, then the wide plan (_step_wide).
_STEP_PLAN = (256, 16)

# eval_loop_bwd.cu's kLoopBwdPlans, K5's staged shared-memory plans in order
# of preference: whether w2, dfT and the dw2 partials are staged. The first is
# the flagship's; the wide plan (_loop_bwd_wide) follows them.
_LOOP_BWD_PLANS = (1, 0)

# train_loop_bwd.cu's kTrainBwdPlans, K8's staged shared-memory plans in
# order of preference: whether the dw partials are kept in shared memory. The
# first is the flagship's; the wide plan (_train_bwd_wide) follows them.
_TRAIN_BWD_PLANS = (1, 0)

# train_loop.cu's K7 plan (kTrainLoopThreads, kTrainLoopLists): threads a CTA,
# room of the column lists; the staged plan, then the wide plan
# (_train_loop_wide).
_TRAIN_LOOP_PLAN = (256, 8)

# train_loop.cu's K6 plan (kTrainStepThreads, kTrainStepLists): threads a CTA,
# room of the column lists; the staged plan, then the wide plan
# (_train_step_wide).
_TRAIN_STEP_PLAN = (256, 16)


def _r4(n):
    """n rounded up to a multiple of 4 (a 16-byte boundary, in floats)."""
    return (n + 3) // 4 * 4


def _loop_bytes(W, D, plan):
    """Shared memory of eval_loop.cu::loop_layout: U [W][2D|1], two state
    buffers and fT [W][D|1] each, w2 transposed [D][2D rounded up to 4], the
    affine [2][D], nm [W], the column lists ([E][W] floats, then W counts and
    E*W sources as bytes); each float region a multiple of 16 bytes. The
    widths may be ints or numpy integer arrays."""
    _, E = plan
    floats = (_r4(W * ((2 * D) | 1)) + 3 * _r4(W * (D | 1)) + D * _r4(2 * D) + _r4(2 * D)
              + _r4(W) + E * W)
    return 4 * floats + (W + E * W if E else 0)


def _step_bytes(W, D, H):
    """Shared memory of fused_eval.cu::step_layout: U [W][2H|1], s [W][D|1],
    fT and rT [W][H|1] each, w2 transposed [D][2H rounded up to 4], the
    affine [2][H], the column lists ([E][W] floats, then W counts and E*W
    sources as bytes); each float region a multiple of 16 bytes. The widths
    may be ints or numpy integer arrays."""
    _, E = _STEP_PLAN
    floats = (_r4(W * ((2 * H) | 1)) + _r4(W * (D | 1)) + 2 * _r4(W * (H | 1)) + D * _r4(2 * H)
              + _r4(2 * H) + E * W)
    return 4 * floats + W + E * W


def _train_loop_bytes(W, D):
    """Shared memory of train_loop.cu::train_loop_layout: two state buffers,
    agg and fT [W][D|1] each, w_cat transposed [2D][D rounded up to 4], nm
    [W], the column lists [E][W]; then as bytes the keep bytes [2][W*D], and
    W list counts and E*W sources; each float region a multiple of 16 bytes.
    The widths may be ints or numpy integer arrays."""
    _, E = _TRAIN_LOOP_PLAN
    floats = 4 * _r4(W * (D | 1)) + 2 * D * _r4(D) + _r4(W) + E * W
    return 4 * floats + 2 * W * D + W + E * W


def _train_step_bytes(W, D, H):
    """Shared memory of train_loop.cu::train_step_layout: s, sd, agg (at
    least [2][W], the list build's counts) and rT [W][D|1] each, fT [W][H|1],
    w_cat transposed [2D][H rounded up to 4], the column lists [E][W]; then
    as bytes the keep bytes [W*D], W list counts and E*W sources; each float
    region a multiple of 16 bytes."""
    _, E = _TRAIN_STEP_PLAN
    rows = _r4(W * (D | 1))
    floats = 3 * rows + max(rows, 2 * W) + _r4(W * (H | 1)) + 2 * D * _r4(H) + E * W
    return 4 * floats + W * D + W + E * W


def _loop_bwd_bytes(W, D, st):
    """Shared memory of eval_loop_bwd.cu::bwd_layout: s_in [D][W], du
    [2D][W + 4], u [W][2D|1], gs [W][D|1], the daff partials [2][D] and the
    affine's scale [D]; staged, dfT [W][D|1], the dw2 partials [2D][D], w2
    transposed [D][2D rounded up to 4] and w2 [2D][D rounded up to 4]; the
    column and row lists ([8][W] floats each, then W counts and 8*W indices
    of each as bytes); each float region a multiple of 16 bytes. The widths
    may be ints or numpy integer arrays."""
    floats = (D * W + 2 * D * (W + 4) + _r4(W * ((2 * D) | 1)) + _r4(W * (D | 1)) + _r4(2 * D)
              + _r4(D) + 16 * W)
    if st:
        floats = (floats + _r4(W * (D | 1)) + _r4(2 * D * D) + D * _r4(2 * D)
                  + 2 * D * _r4(D))
    return 4 * floats + 18 * W


def _train_bwd_bytes(W, D, dw):
    """Shared memory of train_loop_bwd.cu::bwd_layout: x2 [2D][W], dh
    [D][W + 4], dagg and a row buffer [W][D|1] each, w_cat transposed
    [2D][D rounded up to 4]; with dw the partials [D][2D]; the row lists
    [16][W]; then as bytes the keep bytes [2][D][W], W list counts and 16*W
    destinations; each float region a multiple of 16 bytes. The widths may be
    ints or numpy integer arrays."""
    floats = (2 * D * W + D * (W + 4) + 2 * _r4(W * (D | 1)) + 2 * D * _r4(D)
              + dw * _r4(2 * D * D) + 16 * W)
    return 4 * floats + 2 * W * D + 17 * W


# The wide plans, the last of each kernel's plans, chosen only where no
# staged plan fits: (shared-memory bytes, workspace floats a block row) of
# eval_loop.cu's, fused_eval.cu's, eval_loop_bwd.cu's, train_loop.cu's two and
# train_loop_bwd.cu's wide layouts. Shared memory holds the adjacency lists
# (floats, then the counts, the indices and, for the column lists, the list
# build's counts [threads / 32][W] as bytes) and the node mask where the
# kernel reads it; the [W][D]-sized regions lie in the workspace, or, for K6
# and K7, in their outputs. The widths may be ints or numpy integer arrays.
def _loop_wide(W, D):
    """K3: nm [W] and column lists [16][W]; U [W][2D|1] in the workspace."""
    return 4 * (_r4(W) + 16 * W) + W + 16 * W + 8 * W, _r4(W * ((2 * D) | 1))


def _step_wide(W, D, H):
    """K4: column lists [16][W]; U [W][2H|1] in the workspace."""
    return 4 * 16 * W + W + 16 * W + 8 * W, _r4(W * ((2 * H) | 1))


def _loop_bwd_wide(W, D):
    """K5: column and row lists [8][W] each; s_in [D][W], du [2D][W + 4], u
    [W][2D|1], gs [W][D|1] and the daff partials [2D] in the workspace."""
    ws = (D * W + 2 * D * (W + 4) + _r4(W * ((2 * D) | 1)) + _r4(W * (D | 1))
          + _r4(2 * D))
    return 4 * 16 * W + 2 * (W + 8 * W) + 8 * W, ws


def _train_step_wide(W, D, H):
    """K6: column lists [16][W]; agg in its output, no workspace."""
    return 4 * 16 * W + W + 16 * W + 8 * W, 0


def _train_loop_wide(W, D):
    """K7: nm [W] and column lists [8][W]; the states and agg in traj and
    agg, no workspace."""
    return 4 * (_r4(W) + 8 * W) + W + 8 * W + 8 * W, 0


def _train_bwd_wide(W, D):
    """K8: row lists [16][W]; x2 [2D][W], dh [D][W + 4], dagg and the row
    buffer [W][D|1] each and the keep bytes [2][D][W] in the workspace."""
    ws = (2 * D * W + D * (W + 4) + 2 * _r4(W * (D | 1)) + _r4((2 * W * D + 3) // 4))
    return 4 * 16 * W + W + 16 * W, ws


def _first_plan(plans, nbytes, *dims, wide=None):
    """(shared-memory bytes, plan index) of the first of `plans` whose layout
    (nbytes(*dims, plan)) fits a CTA; else, given the wide plan's layout
    (wide(*dims): bytes and workspace floats), the wide plan (index
    len(plans)) where it fits; else the leanest plan's bytes and None."""
    for i, plan in enumerate(plans):
        need = int(nbytes(*dims, plan))
        if need <= SMEM_BYTES:
            return need, i
    if wide is not None and int(wide(*dims)[0]) <= SMEM_BYTES:
        return int(wide(*dims)[0]), len(plans)
    return need, None


def _check_fits(need, plan, shape: str) -> None:
    """Raise before any launch where no plan fits (plan None)."""
    if plan is None:
        raise ValueError(f"{shape} needs {need} bytes of shared memory a block, more than the "
                         f"{SMEM_BYTES} a CTA may use")


def _loop_plan(W: int, D: int):
    """(shared-memory bytes, plan index) K3 takes at this shape (_first_plan)."""
    return _first_plan(_LOOP_PLANS, _loop_bytes, W, D, wide=_loop_wide)


def _loop_bwd_plan(W: int, D: int):
    """(shared-memory bytes, plan index) K5 takes at this shape (_first_plan)."""
    return _first_plan(_LOOP_BWD_PLANS, _loop_bwd_bytes, W, D, wide=_loop_bwd_wide)


def _train_bwd_plan(W: int, D: int):
    """(shared-memory bytes, plan index) K8 takes at this shape (_first_plan)."""
    return _first_plan(_TRAIN_BWD_PLANS, _train_bwd_bytes, W, D, wide=_train_bwd_wide)


def _step_plan(W: int, D: int, H: int):
    """(shared-memory bytes, plan index) K4 takes at this shape: 0 its staged
    plan, 1 the wide plan."""
    return _first_plan((_STEP_PLAN,), lambda W, D, H, _: _step_bytes(W, D, H), W, D, H,
                       wide=_step_wide)


def _train_step_plan(W: int, D: int, H: int):
    """(shared-memory bytes, plan index) K6 takes at this shape: 0 its staged
    plan, 1 the wide plan."""
    return _first_plan((_TRAIN_STEP_PLAN,), lambda W, D, H, _: _train_step_bytes(W, D, H),
                       W, D, H, wide=_train_step_wide)


def _train_loop_plan(W: int, D: int):
    """(shared-memory bytes, plan index) K7 takes at this shape: 0 its staged
    plan, 1 the wide plan."""
    return _first_plan((_TRAIN_LOOP_PLAN,), lambda W, D, _: _train_loop_bytes(W, D), W, D,
                       wide=_train_loop_wide)


def _plan_info(entry: str, *dims) -> dict:
    """What the card reports for the kernel the C entry `entry` launches at a
    shape (W, D and the kernel's third and fourth widths, 0 where it has
    none): its plan index, shared-memory bytes, resident CTAs an SM,
    registers and local-memory bytes a thread (builds the library)."""
    out = (ctypes.c_int * 5)()
    dims = tuple(dims) + (0,) * (4 - len(dims))
    _build.check(getattr(_build.library(), entry + "_info")(*dims, out), entry + "_info")
    return dict(zip(("plan", "smem_bytes", "ctas_per_sm", "registers", "local_bytes"), out))


def train_loop_bwd_info(W: int, D: int) -> dict:
    """_plan_info of K8 (gnn_train_loop_bwd)."""
    return _plan_info("gnn_train_loop_bwd", W, D)


# the kernel each wrapper launches (C entry point gnn_<wrapper>)
_KERNEL = {"propagation_loop": "K3", "propagation_step": "K4", "propagation_loop_bwd": "K5",
           "train_step": "K6", "train_loop": "K7", "train_loop_bwd": "K8",
           "propagation_loop_bf16": "K3_bf16", "propagation_step_bf16": "K4_bf16",
           "propagation_loop_bwd_bf16": "K5_bf16", "train_loop_bf16": "K7_bf16",
           "train_loop_bwd_bf16": "K8_bf16", "train_step_bf16": "K6_bf16"}
# kernel launches since the last reset, by wrapper
launches = dict.fromkeys(_KERNEL, 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def bn_inference_affine(gamma, beta, mean, var, eps: float = 1e-3) -> torch.Tensor:
    """[2, H] (scale; shift) of the post-activation inference BatchNorm:
    scale = gamma * rsqrt(var + eps), shift = beta - mean * scale."""
    scale = gamma * torch.rsqrt(var + eps)
    return torch.stack([scale, beta - mean * scale])


def _affine(affine, H, like):
    if affine is not None:
        return affine
    return torch.stack([torch.ones(H, dtype=like.dtype, device=like.device),
                        torch.zeros(H, dtype=like.dtype, device=like.device)])


def _at(mask, k):
    return None if mask is None else mask[k]


# ------------------------------------------------------------ plain versions
def moved(s, s_old, threshold: float):
    """1.0 where a node moved, ||s - s_old|| > threshold * ||s_old||, else 0."""
    dist = torch.sqrt(torch.sum((s - s_old) ** 2, dim=-1))
    norm = torch.sqrt(torch.sum(s_old * s_old, dim=-1))
    return torch.where(dist > threshold * norm, 1.0, 0.0)


def _pre_activation(adjT, s, fT, w2):
    """The eval kernels' h = s Ws^T + adjT^T (s Wa^T) + fT."""
    H = w2.shape[0] // 2
    u = torch.matmul(s, w2.t())                                 # [B, W, 2H]
    return u[..., :H] + torch.matmul(adjT.transpose(1, 2), u[..., H:]) + fT


def propagation_step_ref(adjT, s, rT, fT, w2, affine=None, activation: str = "tanh"):
    """Plain PyTorch K4: one iteration, [B, W, D] -> [B, W, H]."""
    aff = _affine(affine, w2.shape[0] // 2, w2)
    h = _pre_activation(adjT, s, fT, w2)
    if rT is not None:
        h = h + rT
    return _ACTS[activation](h) * aff[0] + aff[1]


def propagation_loop_ref(adjT, s0, fT, w2, affine, nm, K: int, threshold: float,
                         activation: str = "tanh"):
    """Plain PyTorch K3: (traj [K, B, W, H], margins [K, B, W]); margins[k]
    is nm where the node moved before update k (s_old starting at ones),
    else 0."""
    s, s_old = s0, torch.ones_like(s0)
    traj, margins = [], []
    for _ in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        s_old, s = s, propagation_step_ref(adjT, s, None, fT, w2, affine, activation)
        traj.append(s)
    return torch.stack(traj), torch.stack(margins)


def _eval_step_vjp(adjT, s, h, g, w2, affine, activation: str):
    """Reverse of one eval iteration at pre-activation h for the output
    cotangent g (_fused_bwd_rule): (ds [B, W, D], dw2 [B, 2H, D] and daff
    [B, 2, H] per block (daff None without an affine), dh [B, W, H])."""
    daff = None
    if affine is not None:
        daff = torch.stack([torch.sum(g * _ACTS[activation](h), dim=1), torch.sum(g, dim=1)],
                           dim=1)
        g = g * affine[0]
    dh = g * _act_grad(activation, h)
    du = torch.cat([dh, torch.matmul(adjT, dh)], dim=-1)         # [B, W, 2H]
    return torch.matmul(du, w2), torch.matmul(du.transpose(1, 2), s), daff, dh


def propagation_loop_bwd_ref(adjT, s0, traj, fT, w2, affine, g_traj,
                             activation: str = "tanh"):
    """Plain PyTorch K5: the K reverse iterations of K3 for the trajectory's
    cotangent g_traj [K, B, W, H]. Returns (gs [B, W, D], dw2 [B, 2H, D],
    dfT [B, W, H], daff [B, 2, H] or None), dw2 and daff per block."""
    B, _, D = s0.shape
    H = w2.shape[0] // 2
    gs = torch.zeros_like(s0)
    dw2 = s0.new_zeros((B, 2 * H, D))
    dfT = torch.zeros_like(fT)
    daff = None if affine is None else s0.new_zeros((B, 2, H))
    for k in reversed(range(traj.shape[0])):
        s_in = traj[k - 1] if k else s0
        h = _pre_activation(adjT, s_in, fT, w2)
        gs, dw2_k, daff_k, dh = _eval_step_vjp(adjT, s_in, h, g_traj[k] + gs, w2, affine,
                                               activation)
        dw2 = dw2 + dw2_k
        dfT = dfT + dh
        if daff is not None:
            daff = daff + daff_k
    return gs, dw2, dfT, daff


def train_loop_ref(adjT, s0, ms, ma, fT, w_cat, nm, K: int, threshold: float,
                   activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """Plain PyTorch K7: (traj [K, B, W, D], margins [K, B, W], agg
    [K, B, W, D] the aggregations before the dropout)."""
    drop, _ = _make_drop(alpha_drop, rate)
    s, s_old = s0, torch.ones_like(s0)
    traj, margins, aggs = [], [], []
    for k in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        agg = torch.matmul(adjT.transpose(1, 2), s)
        x2 = torch.cat([drop(s, _at(ms, k)), drop(agg, _at(ma, k))], dim=-1)
        s_old, s = s, _ACTS[activation](F.linear(x2, w_cat) + fT[k])
        traj.append(s)
        aggs.append(agg)
    return torch.stack(traj), torch.stack(margins), torch.stack(aggs)


def train_loop_bwd_ref(adjT, s0, traj, agg, ms, ma, fT, w_cat, g_traj,
                       activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0,
                       act_grad=_act_grad):
    """Plain PyTorch K8: the K reverse iterations of K7 for the trajectory's
    cotangent g_traj. Returns (gs [B, W, D], dw [B, H, 2D] per block, dfT
    [K, B, W, H]). act_grad (name, h) is the activation's derivative."""
    drop, dmask = _make_drop(alpha_drop, rate)
    B, _, D = s0.shape
    gs = torch.zeros_like(s0)
    dw = s0.new_zeros((B, w_cat.shape[0], 2 * D))
    dfT = [None] * traj.shape[0]
    for k in reversed(range(traj.shape[0])):
        s_in = traj[k - 1] if k else s0
        x2 = torch.cat([drop(s_in, _at(ms, k)), drop(agg[k], _at(ma, k))], dim=-1)
        dh = (g_traj[k] + gs) * act_grad(activation, F.linear(x2, w_cat) + fT[k])
        dfT[k] = dh
        dw = dw + torch.matmul(dh.transpose(1, 2), x2)
        dx2 = torch.matmul(dh, w_cat)
        gs = (dx2[..., :D] * dmask(_at(ms, k))
              + torch.matmul(adjT, dx2[..., D:] * dmask(_at(ma, k))))
    return gs, dw, torch.stack(dfT)


def train_step_ref(adjT, s, sd, m, rT, fT, w_cat, activation: str = "tanh",
                   alpha_drop: bool = True, rate: float = 0.0):
    """Plain PyTorch K6: (y [B, W, H], agg [B, W, D] before the dropout)."""
    drop, _ = _make_drop(alpha_drop, rate)
    agg = torch.matmul(adjT.transpose(1, 2), s)
    if rT is not None:
        agg = agg + rT
    x2 = torch.cat([sd, drop(agg, m)], dim=-1)
    return _ACTS[activation](F.linear(x2, w_cat) + fT), agg


def _train_step_vjp(adjT, sd, m, fT, w_cat, agg, gy, activation, alpha_drop, rate):
    """Plain backward of K6 (_train_bwd_rule): h recomputed from the saved
    aggregation. Returns (ds, dsd, dagg, dfT, dw_cat); dagg is also the raw
    residual's cotangent."""
    drop, dmask = _make_drop(alpha_drop, rate)
    D = sd.shape[-1]
    x2 = torch.cat([sd, drop(agg, m)], dim=-1)
    dh = gy * _act_grad(activation, F.linear(x2, w_cat) + fT)
    dx2 = torch.matmul(dh, w_cat)
    dagg = dx2[..., D:] * dmask(m)
    return (torch.matmul(adjT, dagg), dx2[..., :D], dagg, dh,
            torch.einsum("bwh,bwc->hc", dh, x2))


# ------------------------------------------------------------------ wrappers
def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_keep(keep, shape, dev, rate, name="keep"):
    """The keep-mask a kernel reads: None without dropout, else a contiguous
    uint8 tensor of `shape` on `dev`, starting on a 16-byte boundary (the
    kernels may copy keep bytes 16 at a time)."""
    if rate <= 0.0:
        return None
    if keep is None:
        raise ValueError(f"a keep-mask {name} is required when the dropout rate is positive")
    if keep.device != dev or keep.dtype != torch.uint8 or tuple(keep.shape) != tuple(shape) \
            or not keep.is_contiguous():
        raise ValueError(f"{name} must be a contiguous uint8 tensor of shape {tuple(shape)} "
                         f"on {dev}, got {keep.dtype} {tuple(keep.shape)} on {keep.device}")
    if keep.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return keep


def _check_block(adjT, D, H):
    """The block width and the device; every state width D and H has a plan."""
    B, W, W2 = adjT.shape
    if W != W2 or W % 32 or not 32 <= W <= 128:
        raise ValueError(f"block width must be 32, 64, 96 or 128, got adjT {tuple(adjT.shape)}")
    if adjT.device.type != "cuda":
        raise ValueError(f"propagation kernels need CPU or CUDA tensors, got {adjT.device}")


def _check_loop_width(D, H):
    if H != D:
        raise ValueError(f"loop kernel needs state width H == D ({H} != {D})")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class _Workspace:
    """The device-memory workspace of a launch whose C entry takes one (its
    last argument, after the stream): `rows` block rows of the floats a block
    row that the plan the entry picks at `dims` needs (gnn_<entry>_workspace:
    0 for a staged plan, and then a null pointer), allocated on the launch's
    device and stream."""

    def __init__(self, rows: int, *dims: int):
        self.rows, self.dims = rows, tuple(dims) + (0,) * (4 - len(dims))

    def allocate(self, lib, entry: str, device) -> Optional[torch.Tensor]:
        n = getattr(lib, f"gnn_{entry}_workspace")(*self.dims)
        if n < 0:
            raise ValueError(f"gnn_{entry} has no plan for the widths {self.dims}")
        return torch.empty(self.rows * n, dtype=torch.float32, device=device) if n else None


def launch_counted(counts: dict, kernels: dict, key: str, device, *args) -> None:
    """Launch gnn_<key> on `device`'s current stream, raise on its error
    code naming the kernel kernels[key], and add the launch to counts[key].
    A last argument of type _Workspace is allocated and passed after the
    stream."""
    lib = _build.library()
    tail = ()
    if args and isinstance(args[-1], _Workspace):
        args, need = args[:-1], args[-1]
    else:
        need = None
    with torch.cuda.device(device):
        if need is not None:
            ws = need.allocate(lib, key, device)
            tail = (_ptr(ws),)
        err = getattr(lib, f"gnn_{key}")(*args, _stream(device), *tail)
    _build.check(err, f"{key} ({kernels[key]})")
    counts[key] += 1


def _launch(key: str, device, *args) -> None:
    launch_counted(launches, _KERNEL, key, device, *args)


def propagation_step(adjT, s, rT, fT, w2, affine=None, activation: str = "tanh"):
    """K4: one fused iteration over residual-coupled blocks.

    :param adjT: [B, W, W] transposed block adjacency, adjT[b, src, dst] = w.
    :param s: [B, W, D] node states.
    :param rT: [B, W, H] residual term already through Wa, or None.
    :param fT: [B, W, H] loop-invariant term feats @ Wf^T + b.
    :param w2: [2H, D] stacked rows [Ws; Wa].
    :param affine: optional [2, H] (scale; shift) after the activation.
    Returns [B, W, H].
    """
    if adjT.device.type == "cpu":
        return propagation_step_ref(adjT, s, rT, fT, w2, affine, activation)
    B, W, _ = adjT.shape
    D, H = s.shape[-1], w2.shape[0] // 2
    _check_block(adjT, D, H)
    dev = adjT.device
    aff = _affine(affine, H, w2)
    _check("adjT", adjT, (B, W, W), dev)
    _check("s", s, (B, W, D), dev)
    if rT is not None:
        _check("rT", rT, (B, W, H), dev)
    _check("fT", fT, (B, W, H), dev)
    _check("w2", w2, (2 * H, D), dev)
    _check("affine", aff, (2, H), dev)
    out = torch.empty((B, W, H), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    _launch("propagation_step", dev,
            _ptr(adjT), _ptr(s), _ptr(rT), _ptr(fT), _ptr(w2), _ptr(aff), _ptr(out),
            B, W, D, H, _ACT_CODE[activation], _Workspace(B, W, D, H))
    return out


def propagation_loop(adjT, s0, fT, w2, affine, nm, K: int, threshold: float,
                     activation: str = "tanh"):
    """K3: all K fused iterations over residual-free blocks.

    :param adjT: [B, W, W] transposed block adjacency of the loop blocks.
    :param s0: [B, W, D] initial states; fT: [B, W, D] feature term.
    :param w2: [2D, D] stacked rows [Ws; Wa] (the state width stays D).
    :param affine: optional [2, D] post-activation (scale; shift).
    :param nm: [B, W] float node mask (1 real, 0 pad).
    Returns (traj [K, B, W, D], margins [K, B, W]).
    """
    if adjT.device.type == "cpu":
        return propagation_loop_ref(adjT, s0, fT, w2, affine, nm, K, threshold, activation)
    B, W, _ = adjT.shape
    D, H = s0.shape[-1], w2.shape[0] // 2
    _check_loop_width(D, H)
    _check_fits(*_loop_plan(W, D), f"W={W}, D={D}")
    _check_block(adjT, D, H)
    dev = adjT.device
    aff = _affine(affine, H, w2)
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    _check("fT", fT, (B, W, D), dev)
    _check("w2", w2, (2 * D, D), dev)
    _check("affine", aff, (2, D), dev)
    _check("nm", nm, (B, W), dev)
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return traj, margins
    _launch("propagation_loop", dev,
            _ptr(adjT), _ptr(s0), _ptr(fT), _ptr(w2), _ptr(aff), _ptr(nm), _ptr(traj),
            _ptr(margins), B, W, D, int(K), float(threshold), _ACT_CODE[activation],
            _Workspace(B, W, D))
    return traj, margins


def propagation_loop_bwd(adjT, s0, traj, fT, w2, affine, g_traj, activation: str = "tanh"):
    """K5: the K reverse iterations of K3 over residual-free blocks.

    :param adjT, s0, fT, w2, affine: K3's operands (affine may be None).
    :param traj: [K, B, W, D] K3's trajectory; g_traj: its cotangent.
    Returns (gs [B, W, D], dw2 [B, 2D, D], dfT [B, W, D], daff [B, 2, D] or
    None), dw2 and daff per block.
    """
    if adjT.device.type == "cpu":
        return propagation_loop_bwd_ref(adjT, s0, traj, fT, w2, affine, g_traj, activation)
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, H = s0.shape[-1], w2.shape[0] // 2
    _check_loop_width(D, H)
    _check_fits(*_loop_bwd_plan(W, D), f"W={W}, D={D}")
    _check_block(adjT, D, H)
    dev = adjT.device
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    _check("traj", traj, (K, B, W, D), dev)
    _check("fT", fT, (B, W, D), dev)
    _check("w2", w2, (2 * D, D), dev)
    if affine is not None:
        _check("affine", affine, (2, D), dev)
    _check("g_traj", g_traj, (K, B, W, D), dev)
    gs = torch.empty((B, W, D), dtype=torch.float32, device=dev)
    dw2 = torch.empty((B, 2 * D, D), dtype=torch.float32, device=dev)
    dfT = torch.empty_like(gs)
    daff = None if affine is None else torch.empty((B, 2, D), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return gs.zero_(), dw2.zero_(), dfT.zero_(), None if daff is None else daff.zero_()
    _launch("propagation_loop_bwd", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(fT), _ptr(w2), _ptr(affine), _ptr(g_traj),
            _ptr(gs), _ptr(dw2), _ptr(dfT), _ptr(daff), B, W, D, K, _ACT_CODE[activation],
            _Workspace(B, W, D))
    return gs, dw2, dfT, daff


def train_loop(adjT, s0, ms, ma, fT, w_cat, nm, K: int, threshold: float,
               activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """K7: all K dropout-training iterations over residual-free blocks.

    :param adjT: [B, W, W] transposed block adjacency of the loop blocks.
    :param s0: [B, W, D] initial states.
    :param ms / ma: uint8 [K, B, W, D] keep-masks of the state and aggregated
        slices of the dense input (None when rate == 0).
    :param fT: [K, B, W, D] per-iteration feature term Wf @ drop(agg_arcs) + b.
    :param w_cat: [D, 2D] dense columns [Ws | Wa]; nm: [B, W] float node mask.
    Returns (traj [K, B, W, D], margins [K, B, W], agg [K, B, W, D]).
    """
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop_ref(adjT, s0, ms, ma, fT, w_cat, nm, K, threshold, **kw)
    B, W, _ = adjT.shape
    D, H = s0.shape[-1], w_cat.shape[0]
    _check_loop_width(D, H)
    _check_block(adjT, D, H)
    dev = adjT.device
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    _check("fT", fT, (K, B, W, D), dev)
    _check("w_cat", w_cat, (D, 2 * D), dev)
    _check("nm", nm, (B, W), dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    agg = torch.empty_like(traj)
    if B == 0 or K == 0:
        return traj, margins, agg
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop", dev,
            _ptr(adjT), _ptr(s0), _ptr(ms), _ptr(ma), _ptr(fT), _ptr(w_cat), _ptr(nm),
            _ptr(traj), _ptr(margins), _ptr(agg), B, W, D, int(K), float(threshold),
            _ACT_CODE[activation], mode, a, b)
    return traj, margins, agg


def train_loop_bwd(adjT, s0, traj, agg, ms, ma, fT, w_cat, g_traj, activation: str = "tanh",
                   alpha_drop: bool = True, rate: float = 0.0):
    """K8: the K reverse iterations of K7 over residual-free blocks.

    :param traj, agg: [K, B, W, D] K7's trajectory and aggregations.
    :param g_traj: [K, B, W, D] the trajectory's cotangent.
    Other arguments as train_loop. Returns (gs [B, W, D], dw [B, D, 2D] per
    block, dfT [K, B, W, D]).
    """
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop_bwd_ref(adjT, s0, traj, agg, ms, ma, fT, w_cat, g_traj, **kw)
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, H = s0.shape[-1], w_cat.shape[0]
    _check_loop_width(D, H)
    _check_fits(*_train_bwd_plan(W, D), f"W={W}, D={D}")
    _check_block(adjT, D, H)
    dev = adjT.device
    _check("adjT", adjT, (B, W, W), dev)
    _check("s0", s0, (B, W, D), dev)
    for name, t in (("traj", traj), ("agg", agg), ("fT", fT), ("g_traj", g_traj)):
        _check(name, t, (K, B, W, D), dev)
    _check("w_cat", w_cat, (D, 2 * D), dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")
    gs = torch.empty((B, W, D), dtype=torch.float32, device=dev)
    dw = torch.empty((B, D, 2 * D), dtype=torch.float32, device=dev)
    dfT = torch.empty_like(traj)
    if B == 0 or K == 0:
        return gs.zero_(), dw.zero_(), dfT
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop_bwd", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(agg), _ptr(ms), _ptr(ma), _ptr(fT),
            _ptr(w_cat), _ptr(g_traj), _ptr(gs), _ptr(dw), _ptr(dfT), B, W, D, K,
            _ACT_CODE[activation], mode, a, b, _Workspace(B, W, D))
    return gs, dw, dfT


def train_step(adjT, s, sd, m, rT, fT, w_cat, activation: str = "tanh", alpha_drop: bool = True,
               rate: float = 0.0):
    """K6: one dropout-training iteration over residual-coupled blocks.

    :param adjT: [B, W, W] transposed block adjacency of the dep blocks.
    :param s: [B, W, D] states (aggregated); sd: [B, W, D] the states after
        the state slice's dropout.
    :param m: uint8 [B, W, D] keep-mask of the aggregated slice (None when
        rate == 0).
    :param rT: [B, W, D] raw residual aggregation (before the dense layer and
        the dropout), or None.
    :param fT: [B, W, H] feature term; w_cat: [H, 2D] dense columns [Ws | Wa].
    Returns (y [B, W, H], agg [B, W, D] the aggregation before the dropout).
    """
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_step_ref(adjT, s, sd, m, rT, fT, w_cat, **kw)
    B, W, _ = adjT.shape
    D, H = s.shape[-1], w_cat.shape[0]
    _check_block(adjT, D, H)
    dev = adjT.device
    _check("adjT", adjT, (B, W, W), dev)
    for name, t in (("s", s), ("sd", sd), ("rT", rT)):
        if t is not None:
            _check(name, t, (B, W, D), dev)
    _check("fT", fT, (B, W, H), dev)
    _check("w_cat", w_cat, (H, 2 * D), dev)
    m = _check_keep(m, (B, W, D), dev, rate, "m")
    y = torch.empty((B, W, H), dtype=torch.float32, device=dev)
    agg = torch.empty((B, W, D), dtype=torch.float32, device=dev)
    if B == 0:
        return y, agg
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_step", dev,
            _ptr(adjT), _ptr(s), _ptr(sd), _ptr(m), _ptr(rT), _ptr(fT), _ptr(w_cat), _ptr(y),
            _ptr(agg), B, W, D, H, _ACT_CODE[activation], mode, a, b)
    return y, agg


# ------------------------------------------------------- bf16 adjacency
def _pre_activation_bf16(slots, s, fT, w2):
    """K3_bf16's / K4_bf16's h = (U_s + A) + fT (gnn_tpu's _iter_core with hp
    false): U = bf(s) @ bf(w2)^T and A the bf(U_a) rows contracted with the
    adjacency `slots`, every sum in the kernels' order (ops/fused2.py's bf16
    helpers; the rounding points s, w2 and ua)."""
    from gnn_tpu_torch.ops import fused2 as f2
    H = w2.shape[0] // 2
    u = f2._exact_dot(f2._bf("s", s), f2._bf("w2", w2))                    # [B, W, 2H]
    return u[..., :H] + f2._exact_adj(slots, f2._bf("ua", u[..., H:])) + fT


def _eval_bf16(slots, s, rT, fT, w2, aff, activation: str):
    """One iteration of K3_bf16 / K4_bf16: act(h (+ rT)) * scale + shift,
    h as _pre_activation_bf16's."""
    from gnn_tpu_torch.ops import fused2 as f2
    h = _pre_activation_bf16(slots, s, fT, w2)
    if rT is not None:
        h = h + rT
    return f2.act64(activation, h) * aff[0] + aff[1]


def propagation_step_bf16_ref(adjT, s, rT, fT, w2, affine=None, activation: str = "tanh"):
    """Plain PyTorch K4_bf16: one iteration, [B, W, D] -> [B, W, H]; adjT
    bf16, rT the residual term through Wa or None."""
    from gnn_tpu_torch.ops import fused2 as f2
    return _eval_bf16(f2._adj_slots(adjT.float()), s, rT, fT, w2,
                      _affine(affine, w2.shape[0] // 2, w2), activation)


def propagation_loop_bf16_ref(adjT, s0, fT, w2, affine, nm, K: int, threshold: float,
                              activation: str = "tanh"):
    """Plain PyTorch K3_bf16: (traj [K, B, W, D], margins [K, B, W]) as
    propagation_loop_ref's."""
    from gnn_tpu_torch.ops import fused2 as f2
    slots, aff = f2._adj_slots(adjT.float()), _affine(affine, w2.shape[0] // 2, w2)
    s, s_old = s0, torch.ones_like(s0)
    traj, margins = [], []
    for _ in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        s_old, s = s, _eval_bf16(slots, s, None, fT, w2, aff, activation)
        traj.append(s)
    return torch.stack(traj), torch.stack(margins)


def propagation_loop_bwd_bf16_ref(adjT, s0, traj, fT, w2, affine, g_traj,
                                  activation: str = "tanh"):
    """Plain PyTorch K5_bf16 (gnn_tpu's _loop_bwd_kernel with hp false): the K
    reverse iterations of K3_bf16, each recomputing the pre-activation with
    K3_bf16's rounding (_pre_activation_bf16); dua = bf(dh) contracted with
    adjT over the destinations, gs = bf([dh | dua]) @ bf(w2) (unit h's two
    rows in turn; rounding points dh and du); dw2 of s unrounded and daff
    summed node by node. Returns (gs, dw2, dfT, daff) as
    propagation_loop_bwd_ref's."""
    from gnn_tpu_torch.ops import fused2 as f2
    adj = adjT.float()
    slots, slots_t = f2._adj_slots(adj), f2._adj_slots(adj.transpose(1, 2))
    B, _, D = s0.shape
    H = w2.shape[0] // 2
    gs = torch.zeros_like(s0)
    dw2 = s0.new_zeros((B, 2 * H, D))
    dfT = torch.zeros_like(fT)
    daff = None if affine is None else s0.new_zeros((B, 2, H))
    for k in reversed(range(traj.shape[0])):
        s_in = traj[k - 1] if k else s0
        h = _pre_activation_bf16(slots, s_in, fT, w2)
        gy = g_traj[k] + gs
        if affine is not None:
            daff = daff + torch.stack([f2.node_sum(gy * f2.act64(activation, h)),
                                       f2.node_sum(gy)], dim=1)
            gy = gy * affine[0]
        dh = gy * f2.act_grad64(activation, h)
        dfT = dfT + dh
        du = torch.cat([dh, f2._exact_adj(slots_t, f2._bf("dh", dh))], dim=-1)
        dw2 = dw2 + f2.node_outer(du, s_in)
        gs = f2._exact_dot(f2._bf("du", du), f2._bf("w2", w2).t(), pairs=True)
    return gs, dw2, dfT, daff


def _dense_bf16(x2, w_cat, fT):
    """The dropout kernels' h = bf(x2) @ bf(w_cat)^T + fT (gnn_tpu's _BD with
    hp false), summed over the columns ascending; x2's slices round at the
    points x2s (the state) and agg (the aggregation, a sum of the card's
    order), w_cat at w."""
    from gnn_tpu_torch.ops import fused2 as f2
    D = w_cat.shape[1] // 2
    xb = torch.cat([f2._bf("x2s", x2[..., :D]), f2._bf("agg", x2[..., D:])], dim=-1)
    return f2._exact_dot(xb, f2._bf("w", w_cat)) + fT


def train_loop_bf16_ref(adjT, s0, ms, ma, fT, w_cat, nm, K: int, threshold: float,
                        activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """Plain PyTorch K7_bf16 (gnn_tpu's _loop_train_kernel_T with hp false):
    each iteration aggregates bf(s) over the bf16 adjacency (agg, f32 sums,
    saved), forms x2 = [drop(s) | drop(agg)] in f32 and takes act(h), h as
    _dense_bf16's; every sum in the kernel's order, the activation in
    float64 (fused2.act64). Returns (traj, margins, agg) as train_loop_ref's."""
    from gnn_tpu_torch.ops import fused2 as f2
    drop, _ = _make_drop(alpha_drop, rate)
    slots = f2._adj_slots(adjT.float())
    s, s_old = s0, torch.ones_like(s0)
    traj, margins, aggs = [], [], []
    for k in range(K):
        margins.append(moved(s, s_old, threshold) * nm)
        agg = f2._exact_adj(slots, f2._bf("s", s))
        x2 = torch.cat([drop(s, _at(ms, k)), drop(agg, _at(ma, k))], dim=-1)
        s_old, s = s, f2.act64(activation, _dense_bf16(x2, w_cat, fT[k]))
        traj.append(s)
        aggs.append(agg)
    return torch.stack(traj), torch.stack(margins), torch.stack(aggs)


def train_loop_bwd_bf16_ref(adjT, s0, traj, agg, ms, ma, fT, w_cat, g_traj,
                            activation: str = "tanh", alpha_drop: bool = True,
                            rate: float = 0.0):
    """Plain PyTorch K8_bf16 (gnn_tpu's _loop_train_bwd_kernel with hp
    false): the K reverse iterations of K7_bf16, each recomputing h from the
    saved aggregation with K7_bf16's rounding; dw the f32 products dh^T x2 of
    x2 unrounded (gnn_tpu's _BDT_HI) summed node by node, dx2 = bf(dh) @
    bf(w_cat) and the aggregation's reverse over bf(dagg) (rounding points dh
    and dagg). Returns (gs, dw, dfT) as train_loop_bwd_ref's, dw per block."""
    from gnn_tpu_torch.ops import fused2 as f2
    drop, dmask = _make_drop(alpha_drop, rate)
    slots_t = f2._adj_slots(adjT.float().transpose(1, 2))
    B, _, D = s0.shape
    gs = torch.zeros_like(s0)
    dw = s0.new_zeros((B, w_cat.shape[0], 2 * D))
    dfT = [None] * traj.shape[0]
    for k in reversed(range(traj.shape[0])):
        s_in = traj[k - 1] if k else s0
        x2 = torch.cat([drop(s_in, _at(ms, k)), drop(agg[k], _at(ma, k))], dim=-1)
        dh = (g_traj[k] + gs) * f2.act_grad64(activation, _dense_bf16(x2, w_cat, fT[k]))
        dfT[k] = dh
        dw = dw + f2.node_outer(dh, x2)
        dx2 = f2._exact_dot(f2._bf("dh", dh), f2._bf("w", w_cat).t())
        dagg = dx2[..., D:] * dmask(_at(ma, k))
        gs = dx2[..., :D] * dmask(_at(ms, k)) + f2._exact_adj(slots_t, f2._bf("dagg", dagg))
    return gs, dw, torch.stack(dfT)


def train_step_bf16_ref(adjT, s, sd, m, rT, fT, w_cat, activation: str = "tanh",
                        alpha_drop: bool = True, rate: float = 0.0):
    """Plain PyTorch K6_bf16 (gnn_tpu's _train_kernel_T with hp false): agg =
    bf(s) contracted with the bf16 adjacency (+ rT), x2 = [sd | drop(agg)],
    y = act(h), h as _dense_bf16's. Returns (y, agg) as train_step_ref's."""
    from gnn_tpu_torch.ops import fused2 as f2
    drop, _ = _make_drop(alpha_drop, rate)
    agg = f2._exact_adj(f2._adj_slots(adjT.float()), f2._bf("s", s))
    if rT is not None:
        agg = agg + rT
    x2 = torch.cat([sd, drop(agg, m)], dim=-1)
    return f2.act64(activation, _dense_bf16(x2, w_cat, fT)), agg


def propagation_step_bf16(adjT, s, rT, fT, w2, affine=None, activation: str = "tanh"):
    """K4_bf16: one eval iteration over residual-coupled blocks of a bf16
    adjacency (gnn_tpu's _step_kernel_T with hp false). Arguments as
    propagation_step's, adjT bf16 [B, W, W]. Returns [B, W, H]."""
    if adjT.device.type == "cpu":
        return propagation_step_bf16_ref(adjT, s, rT, fT, w2, affine, activation)
    from gnn_tpu_torch.ops import fused2 as f2
    B, W, _ = adjT.shape
    D, H = s.shape[-1], w2.shape[0] // 2
    f2._check_bf16(adjT, D, H, "K4_bf16")
    dev = adjT.device
    aff = _affine(affine, H, w2)
    _check("s", s, (B, W, D), dev)
    if rT is not None:
        _check("rT", rT, (B, W, H), dev)
    _check("fT", fT, (B, W, H), dev)
    _check("w2", w2, (2 * H, D), dev)
    _check("affine", aff, (2, H), dev)
    out = torch.empty((B, W, H), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    _launch("propagation_step_bf16", dev,
            _ptr(adjT), _ptr(s), _ptr(rT), _ptr(fT), _ptr(w2), _ptr(aff), _ptr(out),
            B, W, D, H, _ACT_CODE[activation])
    return out


def propagation_loop_bf16(adjT, s0, fT, w2, affine, nm, K: int, threshold: float,
                          activation: str = "tanh"):
    """K3_bf16: all K eval iterations over residual-free blocks of a bf16
    adjacency (gnn_tpu's _loop_kernel_T with hp false). Arguments as
    propagation_loop's, adjT bf16 [B, W, W]. Returns (traj [K, B, W, D],
    margins [K, B, W])."""
    if adjT.device.type == "cpu":
        return propagation_loop_bf16_ref(adjT, s0, fT, w2, affine, nm, K, threshold, activation)
    from gnn_tpu_torch.ops import fused2 as f2
    B, W, _ = adjT.shape
    D, H = s0.shape[-1], w2.shape[0] // 2
    _check_loop_width(D, H)
    f2._check_bf16(adjT, D, H, "K3_bf16")
    dev = adjT.device
    aff = _affine(affine, H, w2)
    _check("s0", s0, (B, W, D), dev)
    _check("fT", fT, (B, W, D), dev)
    _check("w2", w2, (2 * D, D), dev)
    _check("affine", aff, (2, D), dev)
    _check("nm", nm, (B, W), dev)
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return traj, margins
    _launch("propagation_loop_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(fT), _ptr(w2), _ptr(aff), _ptr(nm), _ptr(traj),
            _ptr(margins), B, W, D, int(K), float(threshold), _ACT_CODE[activation])
    return traj, margins


def propagation_loop_bwd_bf16(adjT, s0, traj, fT, w2, affine, g_traj,
                              activation: str = "tanh"):
    """K5_bf16: the K reverse iterations of K3_bf16 over residual-free blocks
    of a bf16 adjacency (gnn_tpu's _loop_bwd_kernel with hp false).
    Arguments and result as propagation_loop_bwd's, adjT bf16 [B, W, W]."""
    if adjT.device.type == "cpu":
        return propagation_loop_bwd_bf16_ref(adjT, s0, traj, fT, w2, affine, g_traj, activation)
    from gnn_tpu_torch.ops import fused2 as f2
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, H = s0.shape[-1], w2.shape[0] // 2
    _check_loop_width(D, H)
    f2._check_bf16(adjT, D, H, "K5_bf16")
    dev = adjT.device
    _check("s0", s0, (B, W, D), dev)
    _check("traj", traj, (K, B, W, D), dev)
    _check("fT", fT, (B, W, D), dev)
    _check("w2", w2, (2 * D, D), dev)
    if affine is not None:
        _check("affine", affine, (2, D), dev)
    _check("g_traj", g_traj, (K, B, W, D), dev)
    gs, dfT = (torch.zeros((B, W, D), dtype=torch.float32, device=dev) for _ in range(2))
    dw2 = torch.zeros((B, 2 * D, D), dtype=torch.float32, device=dev)
    daff = None if affine is None else torch.zeros((B, 2, D), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return gs, dw2, dfT, daff
    _launch("propagation_loop_bwd_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(fT), _ptr(w2), _ptr(affine), _ptr(g_traj),
            _ptr(gs), _ptr(dw2), _ptr(dfT), _ptr(daff), B, W, D, K, _ACT_CODE[activation])
    return gs, dw2, dfT, daff


def train_loop_bf16(adjT, s0, ms, ma, fT, w_cat, nm, K: int, threshold: float,
                    activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """K7_bf16: all K dropout-training iterations over residual-free blocks of
    a bf16 adjacency (gnn_tpu's _loop_train_kernel_T with hp false).
    Arguments and result as train_loop's, adjT bf16 [B, W, W]."""
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop_bf16_ref(adjT, s0, ms, ma, fT, w_cat, nm, K, threshold, **kw)
    from gnn_tpu_torch.ops import fused2 as f2
    B, W, _ = adjT.shape
    D, H = s0.shape[-1], w_cat.shape[0]
    _check_loop_width(D, H)
    f2._check_bf16(adjT, D, H, "K7_bf16")
    dev = adjT.device
    _check("s0", s0, (B, W, D), dev)
    _check("fT", fT, (K, B, W, D), dev)
    _check("w_cat", w_cat, (D, 2 * D), dev)
    _check("nm", nm, (B, W), dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")
    traj = torch.empty((K, B, W, D), dtype=torch.float32, device=dev)
    margins = torch.empty((K, B, W), dtype=torch.float32, device=dev)
    agg = torch.empty_like(traj)
    if B == 0 or K == 0:
        return traj, margins, agg
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(ms), _ptr(ma), _ptr(fT), _ptr(w_cat), _ptr(nm),
            _ptr(traj), _ptr(margins), _ptr(agg), B, W, D, int(K), float(threshold),
            _ACT_CODE[activation], mode, a, b)
    return traj, margins, agg


def train_loop_bwd_bf16(adjT, s0, traj, agg, ms, ma, fT, w_cat, g_traj,
                        activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """K8_bf16: the K reverse iterations of K7_bf16 over residual-free blocks
    of a bf16 adjacency (gnn_tpu's _loop_train_bwd_kernel with hp false).
    Arguments and result as train_loop_bwd's, adjT bf16 [B, W, W]."""
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_loop_bwd_bf16_ref(adjT, s0, traj, agg, ms, ma, fT, w_cat, g_traj, **kw)
    from gnn_tpu_torch.ops import fused2 as f2
    B, W, _ = adjT.shape
    K = traj.shape[0]
    D, H = s0.shape[-1], w_cat.shape[0]
    _check_loop_width(D, H)
    f2._check_bf16(adjT, D, H, "K8_bf16")
    dev = adjT.device
    _check("s0", s0, (B, W, D), dev)
    for name, t in (("traj", traj), ("agg", agg), ("fT", fT), ("g_traj", g_traj)):
        _check(name, t, (K, B, W, D), dev)
    _check("w_cat", w_cat, (D, 2 * D), dev)
    ms = _check_keep(ms, (K, B, W, D), dev, rate, "ms")
    ma = _check_keep(ma, (K, B, W, D), dev, rate, "ma")
    gs = torch.zeros((B, W, D), dtype=torch.float32, device=dev)
    dw = torch.zeros((B, D, 2 * D), dtype=torch.float32, device=dev)
    dfT = torch.zeros_like(traj)
    if B == 0 or K == 0:
        return gs, dw, dfT
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_loop_bwd_bf16", dev,
            _ptr(adjT), _ptr(s0), _ptr(traj), _ptr(agg), _ptr(ms), _ptr(ma), _ptr(fT),
            _ptr(w_cat), _ptr(g_traj), _ptr(gs), _ptr(dw), _ptr(dfT), B, W, D, K,
            _ACT_CODE[activation], mode, a, b)
    return gs, dw, dfT


def train_step_bf16(adjT, s, sd, m, rT, fT, w_cat, activation: str = "tanh",
                    alpha_drop: bool = True, rate: float = 0.0):
    """K6_bf16: one dropout-training iteration over residual-coupled blocks of
    a bf16 adjacency (gnn_tpu's _train_kernel_T with hp false). Arguments
    and result as train_step's, adjT bf16 [B, W, W]."""
    kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
    if adjT.device.type == "cpu":
        return train_step_bf16_ref(adjT, s, sd, m, rT, fT, w_cat, **kw)
    from gnn_tpu_torch.ops import fused2 as f2
    B, W, _ = adjT.shape
    D, H = s.shape[-1], w_cat.shape[0]
    f2._check_bf16(adjT, D, H, "K6_bf16")
    dev = adjT.device
    for name, t in (("s", s), ("sd", sd), ("rT", rT)):
        if t is not None:
            _check(name, t, (B, W, D), dev)
    _check("fT", fT, (B, W, H), dev)
    _check("w_cat", w_cat, (H, 2 * D), dev)
    m = _check_keep(m, (B, W, D), dev, rate, "m")
    y = torch.empty((B, W, H), dtype=torch.float32, device=dev)
    agg = torch.empty((B, W, D), dtype=torch.float32, device=dev)
    if B == 0:
        return y, agg
    mode, a, b = _drop_args(alpha_drop, rate)
    _launch("train_step_bf16", dev,
            _ptr(adjT), _ptr(s), _ptr(sd), _ptr(m), _ptr(rT), _ptr(fT), _ptr(w_cat), _ptr(y),
            _ptr(agg), B, W, D, H, _ACT_CODE[activation], mode, a, b)
    return y, agg


# ------------------------------------------------------- differentiable ops
class _PropagationLoop(torch.autograd.Function):
    """K3 forward, K5 backward (_fused_loop_fwd / _fused_loop_bwd); the
    movement flags carry no gradient."""

    @staticmethod
    def forward(ctx, s0, fT, w2, affine, adjT, nm, K, threshold, activation):
        traj, margins = propagation_loop(adjT, s0, fT, w2, affine, nm, K, threshold, activation)
        ctx.saved = (adjT, s0, fT, w2, affine, traj, activation)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, fT, w2, affine, traj, activation = ctx.saved
        gs, dw2, dfT, daff = propagation_loop_bwd(adjT, s0, traj, fT, w2, affine,
                                                  g_traj.contiguous(), activation)
        # fT is loop-invariant: K5 summed its cotangent over the iterations
        return (gs, dfT, dw2.sum(0), None if daff is None else daff.sum(0)) + (None,) * 5


class _PropagationStep(torch.autograd.Function):
    """K4 forward, plain backward (_fused_bwd_rule)."""

    @staticmethod
    def forward(ctx, s, rT, fT, w2, affine, adjT, activation):
        ctx.saved = (adjT, s, rT, fT, w2, affine, activation)
        return propagation_step(adjT, s, rT, fT, w2, affine, activation)

    @staticmethod
    def backward(ctx, g):
        adjT, s, rT, fT, w2, affine, activation = ctx.saved
        adj = adjT.float() if adjT.dtype == torch.bfloat16 else adjT   # gnn_tpu's upcast
        h = _pre_activation(adj, s, fT, w2)
        if rT is not None:
            h = h + rT
        ds, dw2, daff, dh = _eval_step_vjp(adj, s, h, g, w2, affine, activation)
        return (ds, None if rT is None else dh, dh, dw2.sum(0),
                None if daff is None else daff.sum(0), None, None)


class _TrainLoop(torch.autograd.Function):
    """K7 forward, K8 backward (_loop_train_fwd / _loop_train_bwd)."""

    @staticmethod
    def forward(ctx, s0, fT, w_cat, adjT, ms, ma, nm, K, threshold, activation, alpha_drop,
                rate):
        kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
        traj, margins, agg = train_loop(adjT, s0, ms, ma, fT, w_cat, nm, K, threshold, **kw)
        ctx.saved = (adjT, s0, traj, agg, ms, ma, fT, w_cat, kw)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, traj, agg, ms, ma, fT, w_cat, kw = ctx.saved
        gs, dw, dfT = train_loop_bwd(adjT, s0, traj, agg, ms, ma, fT, w_cat,
                                     g_traj.contiguous(), **kw)
        return (gs, dfT, dw.sum(0)) + (None,) * 9


class _TrainStep(torch.autograd.Function):
    """K6 forward, plain backward (_train_bwd_rule)."""

    @staticmethod
    def forward(ctx, s, sd, rT, fT, w_cat, adjT, m, activation, alpha_drop, rate):
        kw = (activation, alpha_drop, rate)
        y, agg = train_step(adjT, s, sd, m, rT, fT, w_cat, *kw)
        ctx.saved = (adjT, sd, m, fT, w_cat, agg, rT is not None, kw)
        return y

    @staticmethod
    def backward(ctx, gy):
        adjT, sd, m, fT, w_cat, agg, has_res, kw = ctx.saved
        adj = adjT.float() if adjT.dtype == torch.bfloat16 else adjT   # gnn_tpu's upcast
        ds, dsd, dagg, dfT, dw = _train_step_vjp(adj, sd, m, fT, w_cat, agg, gy, *kw)
        return (ds, dsd, dagg if has_res else None, dfT, dw) + (None,) * 5


def fused_propagation_loop(adjT, s0, fT, w2, affine, nm, K: int, threshold: float,
                           activation: str = "tanh"):
    """propagation_loop (K3) with gradients to s0, fT, w2 and affine through
    K5. Returns (traj, margins); margins carry none."""
    return _PropagationLoop.apply(s0, fT, w2, affine, adjT, nm, K, threshold, activation)


def fused_propagation_step(adjT, s, rT, fT, w2, affine=None, activation: str = "tanh"):
    """propagation_step (K4) with gradients to s, rT, fT, w2 and affine."""
    return _PropagationStep.apply(s, rT, fT, w2, affine, adjT, activation)


class _PropagationLoopBf16(torch.autograd.Function):
    """K3_bf16 forward, K5_bf16 backward (_fused_loop_fwd / _fused_loop_bwd,
    hp false)."""

    @staticmethod
    def forward(ctx, s0, fT, w2, affine, adjT, nm, K, threshold, activation):
        traj, margins = propagation_loop_bf16(adjT, s0, fT, w2, affine, nm, K, threshold,
                                              activation)
        ctx.saved = (adjT, s0, fT, w2, affine, traj, activation)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, fT, w2, affine, traj, activation = ctx.saved
        gs, dw2, dfT, daff = propagation_loop_bwd_bf16(adjT, s0, traj, fT, w2, affine,
                                                       g_traj.contiguous(), activation)
        return (gs, dfT, dw2.sum(0), None if daff is None else daff.sum(0)) + (None,) * 5


class _PropagationStepBf16(_PropagationStep):
    """K4_bf16 forward, gnn_tpu's f32 backward on the upcast adjacency
    (_fused_bwd_rule: _PropagationStep's)."""

    @staticmethod
    def forward(ctx, s, rT, fT, w2, affine, adjT, activation):
        ctx.saved = (adjT, s, rT, fT, w2, affine, activation)
        return propagation_step_bf16(adjT, s, rT, fT, w2, affine, activation)


def fused_propagation_loop_bf16(adjT, s0, fT, w2, affine, nm, K: int, threshold: float,
                                activation: str = "tanh"):
    """propagation_loop_bf16 (K3_bf16) with gradients to s0, fT, w2 and
    affine through K5_bf16. Returns (traj, margins); margins carry none."""
    return _PropagationLoopBf16.apply(s0, fT, w2, affine, adjT, nm, K, threshold, activation)


def fused_propagation_step_bf16(adjT, s, rT, fT, w2, affine=None, activation: str = "tanh"):
    """propagation_step_bf16 (K4_bf16) with gradients to s, rT, fT, w2 and
    affine through gnn_tpu's f32 backward."""
    return _PropagationStepBf16.apply(s, rT, fT, w2, affine, adjT, activation)


class _TrainLoopBf16(torch.autograd.Function):
    """K7_bf16 forward, K8_bf16 backward (_loop_train_fwd / _loop_train_bwd,
    hp false); the dw partials a block each, summed in block order."""

    @staticmethod
    def forward(ctx, s0, fT, w_cat, adjT, ms, ma, nm, K, threshold, activation, alpha_drop,
                rate):
        kw = dict(activation=activation, alpha_drop=alpha_drop, rate=rate)
        traj, margins, agg = train_loop_bf16(adjT, s0, ms, ma, fT, w_cat, nm, K, threshold,
                                             **kw)
        ctx.saved = (adjT, s0, traj, agg, ms, ma, fT, w_cat, kw)
        ctx.mark_non_differentiable(margins)
        return traj, margins

    @staticmethod
    def backward(ctx, g_traj, _g_margins):
        adjT, s0, traj, agg, ms, ma, fT, w_cat, kw = ctx.saved
        gs, dw, dfT = train_loop_bwd_bf16(adjT, s0, traj, agg, ms, ma, fT, w_cat,
                                          g_traj.contiguous(), **kw)
        return (gs, dfT, dw.sum(0)) + (None,) * 9


class _TrainStepBf16(_TrainStep):
    """K6_bf16 forward, _TrainStep's f32 backward on the upcast adjacency
    (gnn_tpu's _train_bwd_rule)."""

    @staticmethod
    def forward(ctx, s, sd, rT, fT, w_cat, adjT, m, activation, alpha_drop, rate):
        kw = (activation, alpha_drop, rate)
        y, agg = train_step_bf16(adjT, s, sd, m, rT, fT, w_cat, *kw)
        ctx.saved = (adjT, sd, m, fT, w_cat, agg, rT is not None, kw)
        return y


def fused_train_loop_bf16(adjT, s0, ms, ma, fT, w_cat, nm, K: int, threshold: float,
                          activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """train_loop_bf16 (K7_bf16) with gradients to s0, fT and w_cat through
    K8_bf16. Returns (traj, margins); margins carry none."""
    return _TrainLoopBf16.apply(s0, fT, w_cat, adjT, ms, ma, nm, K, threshold, activation,
                                alpha_drop, rate)


def fused_train_step_bf16(adjT, s, sd, m, rT, fT, w_cat, activation: str = "tanh",
                          alpha_drop: bool = True, rate: float = 0.0):
    """train_step_bf16 (K6_bf16) with gradients to s, sd, rT, fT and w_cat
    through gnn_tpu's f32 backward. Returns y."""
    return _TrainStepBf16.apply(s, sd, rT, fT, w_cat, adjT, m, activation, alpha_drop, rate)


def fused_train_loop(adjT, s0, ms, ma, fT, w_cat, nm, K: int, threshold: float,
                     activation: str = "tanh", alpha_drop: bool = True, rate: float = 0.0):
    """train_loop (K7) with gradients to s0, fT and w_cat through K8.
    Returns (traj, margins); margins carry none."""
    return _TrainLoop.apply(s0, fT, w_cat, adjT, ms, ma, nm, K, threshold, activation,
                            alpha_drop, rate)


def fused_train_step(adjT, s, sd, m, rT, fT, w_cat, activation: str = "tanh",
                     alpha_drop: bool = True, rate: float = 0.0):
    """train_step (K6) with gradients to s, sd, rT, fT and w_cat. Returns y."""
    return _TrainStep.apply(s, sd, rT, fT, w_cat, adjT, m, activation, alpha_drop, rate)
