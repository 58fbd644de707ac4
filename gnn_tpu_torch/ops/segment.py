"""Segment aggregation over a CSR plan: K18 (counterpart of
gnn_tpu/ops/pallas_segment.py).

The state aggregation of a batch without blocks (GraphBatch.from_graph) is

    agg[n] = sum over arcs e with dst_e == n of w_e * state[src_e]   (A^T_w @ state)

gnn_tpu runs it on the TPU's matrix unit: a host plan groups the arcs into
(destination block, source block) tiles of 256-arc chunks, and each chunk is a
one-hot gather and a weighted one-hot scatter (`_agg_kernel`). The chunking,
its 8-row alignment and the block-width halving exist for the MXU and VMEM,
so the port keeps its own plan instead: a CSR layout per direction, built on
the host once per batch (`build_agg_plan`):

* forward: rows are destinations, columns sources; the transpose swaps them;
* `rowptr` [Np + 1] int32, `col` [nnz] int32, `w` [nnz] float32, the
  entries of a row in arc order;
* arcs of weight 0 are dropped: a batch's pad arcs all point at one node, and
  a weight-0 term adds exactly 0.

`segment_aggregate` runs K18 (ops/csrc/segment_agg.cu) on a plan for CUDA
tensors and its plain version for CPU tensors; `block_aggregate` is the
differentiable op, whose backward is K18 on the transpose plan (gnn_tpu's
`_ba_bwd`). `launches` counts kernel launches. K18 takes a row a group of
lanes, each lane a float4, float2 or float of the row's features by D;
`_agg_launch` mirrors the launch the C entry makes, and `launch_info` reads
it back from the library.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gnn_tpu_torch.ops import _build
from gnn_tpu_torch.ops.fused import _ptr, launch_counted

_KERNEL = {"segment_aggregate": "K18"}
# kernel launches since the last reset, by wrapper
launches = dict.fromkeys(_KERNEL, 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass(frozen=True)
class AggPlan:
    """CSR plan of one direction: out[r] = sum_{e in row r} w[e] * x[col[e]]."""
    rowptr: torch.Tensor   # [Np + 1] int32
    col: torch.Tensor      # [nnz] int32
    w: torch.Tensor        # [nnz] float32

    @property
    def num_rows(self) -> int:
        return self.rowptr.shape[0] - 1

    def to(self, device) -> "AggPlan":
        return AggPlan(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class AggPlanPair:
    fwd: AggPlan   # rows = destinations
    bwd: AggPlan   # the transpose (rows = sources), for the gradient

    def to(self, device) -> "AggPlanPair":
        return AggPlanPair(self.fwd.to(device), self.bwd.to(device))


def _csr(rows, cols, w, num_nodes: int) -> AggPlan:
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=num_nodes)
    rowptr = np.concatenate([[0], np.cumsum(counts)])

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
    return AggPlan(rowptr=t(rowptr, np.int32), col=t(cols[order], np.int32),
                   w=t(w[order], np.float32))


def build_agg_plan(src, dst, weights, num_nodes: int) -> AggPlanPair:
    """Forward and transpose CSR plans of `A^T_w @ state` (host side, once per
    batch; host tensors, moved with `.to(device)`).

    :param src / dst: int arrays [E] of node ids in [0, num_nodes).
    :param weights: [E] aggregation weights; arcs of weight 0 are dropped.
    :param num_nodes: the padded node count, the number of rows.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(weights, np.float32)
    if not src.shape == dst.shape == w.shape:
        raise ValueError(f"src, dst and weights differ in shape: {src.shape}, {dst.shape}, "
                         f"{w.shape}")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError(f"arc endpoints must lie in [0, {num_nodes})")
    if num_nodes >= 2 ** 31 or len(src) >= 2 ** 31:
        raise ValueError("the plan indexes nodes and arcs with int32")
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]
    return AggPlanPair(fwd=_csr(dst, src, w, num_nodes), bwd=_csr(src, dst, w, num_nodes))


# ------------------------------------------------------------ plain version
def segment_aggregate_ref(state: torch.Tensor, plan: AggPlan) -> torch.Tensor:
    """Plain PyTorch K18: out[r] = sum_{e in row r} w[e] * state[col[e]]."""
    n = plan.num_rows
    rows = torch.repeat_interleave(torch.arange(n, device=state.device), plan.rowptr.diff(),
                                   output_size=plan.col.shape[0])
    out = state.new_zeros((n, state.shape[1]))
    return out.index_add_(0, rows, state[plan.col] * plan.w[:, None])


# ------------------------------------------------------------------ kernel
# segment_agg.cu's kAggThreads: threads a CTA
_AGG_THREADS = 256


def _agg_launch(N: int, D: int):
    """(vector width V, lanes a row L, rows a CTA, CTAs) of
    segment_agg.cu::agg_launch over N rows of width D: float4 lanes where
    D % 4 == 0, float2 where D % 2 == 0, else floats; L the least power of
    two covering D / V vectors, at most 32."""
    V = 4 if D % 4 == 0 else 2 if D % 2 == 0 else 1
    L = 1
    while L < D // V and L < 32:
        L *= 2
    rows = _AGG_THREADS // L
    return V, L, rows, -(-N // rows)


def launch_info(N: int, D: int) -> dict:
    """What the library reports for its launch over N rows of width D
    (gnn_segment_aggregate_info; builds the library)."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().gnn_segment_aggregate_info(N, D, 0, 0, out),
                 "gnn_segment_aggregate_info")
    return dict(zip(("vector", "lanes", "rows", "ctas", "registers"), out))


def _check_plan(plan: AggPlan, state: torch.Tensor) -> None:
    dev = state.device
    nnz = plan.col.shape[0]
    for name, t, dtype, n in (("rowptr", plan.rowptr, torch.int32, state.shape[0] + 1),
                              ("col", plan.col, torch.int32, nnz),
                              ("w", plan.w, torch.float32, nnz)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"plan {name} must be a contiguous {dtype} tensor of shape ({n},) "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def segment_aggregate(state: torch.Tensor, plan: AggPlan) -> torch.Tensor:
    """K18: A^T_w @ state over a CSR plan, [Np, D] -> [Np, D].

    CPU tensors run the plain version; CUDA tensors launch the kernel, which
    takes float32 only. Every row is written: a row without entries (a pad or
    an isolated node) comes out as exact zeros."""
    if state.device.type == "cpu":
        return segment_aggregate_ref(state, plan)
    if state.device.type != "cuda":
        raise ValueError(f"segment_aggregate needs CPU or CUDA tensors, got {state.device}")
    if state.dtype != torch.float32:
        raise TypeError(f"K18 takes float32 states, got {state.dtype}")
    if state.dim() != 2 or not state.is_contiguous():
        raise ValueError(f"state must be a contiguous [Np, D] tensor, got {tuple(state.shape)}")
    if state.data_ptr() % 16:
        raise ValueError("state must be 16-byte aligned (K18 gathers rows 16 bytes at a time)")
    N, D = state.shape
    if N != plan.num_rows:
        raise ValueError(f"state has {N} rows, the plan {plan.num_rows}")
    _check_plan(plan, state)
    out = torch.empty_like(state)
    if N == 0 or D == 0:
        return out
    launch_counted(launches, _KERNEL, "segment_aggregate", state.device,
                   _ptr(plan.rowptr), _ptr(plan.col), _ptr(plan.w), _ptr(state), _ptr(out),
                   N, D)
    return out


class _BlockAggregate(torch.autograd.Function):
    """A^T_w @ state; the gradient is the same op on the transpose plan."""

    @staticmethod
    def forward(ctx, state, plans):
        ctx.plans = plans
        return segment_aggregate(state.contiguous(), plans.fwd)

    @staticmethod
    def backward(ctx, g):
        return segment_aggregate(g.contiguous(), ctx.plans.bwd), None


def block_aggregate(state: torch.Tensor, plans: AggPlanPair) -> torch.Tensor:
    """Gather and weighted segment sum, agg = A^T_w @ state [Np, D] (gnn_tpu's
    block_aggregate); differentiable through K18 on the transpose plan."""
    return _BlockAggregate.apply(state, plans)
