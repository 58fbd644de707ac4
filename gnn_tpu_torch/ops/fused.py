"""Eval propagation kernels K3 and K4 (counterpart of gnn_tpu/ops/pallas_fused.py).

The dense layer of the state net is reassociated through the aggregation, so
one iteration on a block of W nodes is

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

Layout: node-major blocks, s [B, W, D], fT [B, W, H], adjT [B, W(src), W(dst)].
Each wrapper runs its plain PyTorch version (`*_ref`) for CPU tensors and
launches the CUDA kernel (ops/csrc/fused_eval.cu) for CUDA tensors; it never
falls back from one to the other. `launches` counts kernel launches.
On MUTAG-shaped blocks both kernels' least time is set by the bytes they move
(the adjacency dominates); the design and its limits are noted in the source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnn_tpu_torch.ops import _build

_SELU_SCALE = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772

# Activations the kernels evaluate in-kernel; selu is exp(min(x, 0)) - 1 like
# the Pallas kernels (which lack expm1), within ~1e-7 of torch.selu.
_ACTS = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "selu": lambda x: _SELU_SCALE * torch.where(
        x > 0, x, _SELU_ALPHA * (torch.exp(torch.clamp_max(x, 0.0)) - 1.0)),
}
FUSABLE_ACTIVATIONS = tuple(_ACTS)
_ACT_CODE = {"linear": 0, "tanh": 1, "relu": 2, "selu": 3}

# kernel launches since the last reset, by wrapper
launches = {"propagation_loop": 0, "propagation_step": 0}


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


# ------------------------------------------------------------ plain versions
def propagation_step_ref(adjT, s, rT, fT, w2, affine=None, activation: str = "tanh"):
    """Plain PyTorch K4: one iteration, [B, W, D] -> [B, W, H]."""
    H = w2.shape[0] // 2
    aff = _affine(affine, H, w2)
    u = torch.matmul(s, w2.t())                                 # [B, W, 2H]
    a = torch.matmul(adjT.transpose(1, 2), u[..., H:])         # [B, W, H]
    h = u[..., :H] + a + fT
    if rT is not None:
        h = h + rT
    return _ACTS[activation](h) * aff[0] + aff[1]


def propagation_loop_ref(adjT, s0, fT, w2, affine, nm, K: int, threshold: float,
                         activation: str = "tanh"):
    """Plain PyTorch K3: (traj [K, B, W, H], margins [K, B, W]); margins[k]
    is nm where the node moved before update k (||s - s_old|| > thr *
    ||s_old||, s_old starting at ones), else 0."""
    s, s_old = s0, torch.ones_like(s0)
    traj, margins = [], []
    for _ in range(K):
        dist = torch.sqrt(torch.sum((s - s_old) ** 2, dim=-1))
        norm = torch.sqrt(torch.sum(s_old * s_old, dim=-1))
        margins.append(torch.where(dist > threshold * norm, 1.0, 0.0) * nm)
        s_old, s = s, propagation_step_ref(adjT, s, None, fT, w2, affine, activation)
        traj.append(s)
    return torch.stack(traj), torch.stack(margins)


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


def _check_block(adjT, D, H):
    B, W, W2 = adjT.shape
    if W != W2 or W % 32 or not 32 <= W <= 128:
        raise ValueError(f"block width must be 32, 64, 96 or 128, got adjT {tuple(adjT.shape)}")
    if max(D, H) > 64:
        raise ValueError(f"feature widths above 64 are not supported (D={D}, H={H})")
    if adjT.device.type != "cuda":
        raise ValueError(f"propagation kernels need CPU or CUDA tensors, got {adjT.device}")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_propagation_step(
            _ptr(adjT), _ptr(s), _ptr(rT), _ptr(fT), _ptr(w2), _ptr(aff), _ptr(out),
            B, W, D, H, _ACT_CODE[activation], _stream(dev))
    _build.check(err, "propagation_step (K4)")
    launches["propagation_step"] += 1
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
    if H != D:
        raise ValueError(f"loop kernel needs state width H == D ({H} != {D})")
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
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.gnn_propagation_loop(
            _ptr(adjT), _ptr(s0), _ptr(fT), _ptr(w2), _ptr(aff), _ptr(nm), _ptr(traj),
            _ptr(margins), B, W, D, int(K), float(threshold), _ACT_CODE[activation],
            _stream(dev))
    _build.check(err, "propagation_loop (K3)")
    launches["propagation_loop"] += 1
    return traj, margins
