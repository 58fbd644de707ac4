"""Functional core of the GNN at inference: fixed-point propagation and the
focus-specific readout (counterpart of gnn_tpu/models/core.py, eval only).

Propagation iterates state <- net_state([state, sum_nbr state, sum_nbr arc
labels]) while any real node moved more than threshold * ||state_old|| and
k < max_iteration (reference GNN.py:202-242). It runs a fixed K steps with an
`active` flag, as tensor ops only, so the device never waits on the host.

Dispatch follows gnn_tpu's `aggregation='auto'` at eval:

* a batch with the loop/dep layout and a one-layer state net with a kernel
  activation takes the hybrid path: K3 (`propagation_loop`) runs every
  iteration of the residual-free blocks, K4 (`propagation_step`) one
  iteration per step of the residual-coupled blocks, and the global early
  stop is rebuilt from K3's movement flags;
* what gnn_tpu sends to its XLA body (no loop layout, activations the
  kernels do not take) runs the plain body here;
* what gnn_tpu sends to a kernel not ported yet raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.ops.aggregate import aggregate_to_nodes, pool_graphs
from gnn_tpu_torch.ops.fused import (FUSABLE_ACTIVATIONS, bn_inference_affine,
                                     propagation_loop, propagation_step)
from gnn_tpu_torch.ops.mlp import MLPSpec, mlp_apply, mlp_init

AGGREGATIONS = ("auto", "segment", "onehot", "fused", "pallas")


@dataclasses.dataclass(frozen=True)
class GNNSpec:
    """Static model description.

    :param focus: 'n' | 'a' | 'g' problem focus.
    :param state_spec / output_spec: MLP architectures of the state and output nets.
    :param state_dim: reference state_vect_dim (0 = node labels are the state).
    :param max_iteration: the most propagation steps.
    :param threshold: convergence threshold.
    :param aggregation: gnn_tpu's strategy name; 'auto' dispatches to the kernels.
    """
    focus: str
    state_spec: MLPSpec
    output_spec: MLPSpec
    state_dim: int = 0
    max_iteration: int = 5
    threshold: float = 0.01
    aggregation: str = "auto"

    def __post_init__(self):
        if self.focus not in ("n", "a", "g"):
            raise ValueError("focus must be 'n', 'a' or 'g'")
        if self.state_dim < 0 or not isinstance(self.state_dim, int):
            raise TypeError("param <state_dim> must be int>=0")
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"aggregation must be one of {AGGREGATIONS}")


def gnn_init(spec: GNNSpec, gen: torch.Generator, device="cpu"):
    """(params, bn_state) of both nets, drawn from `gen`."""
    ps, bs = mlp_init(spec.state_spec, gen, device)
    po, bo = mlp_init(spec.output_spec, gen, device)
    return {"state": ps, "output": po}, {"state": bs, "output": bo}


def check_dims(spec: GNNSpec, nl: int, al: int, dt: int) -> None:
    """Validate the nets' widths against the batch's label widths."""
    sd = spec.state_dim
    want_state_out = sd if sd > 0 else nl
    if spec.state_spec.units[-1] != want_state_out:
        raise ValueError(
            f"state net output dim {spec.state_spec.units[-1]} != "
            f"{'state_dim' if sd > 0 else 'node label dim'} ({want_state_out}); "
            f"use get_inout_dims('state', ...) to size the net")
    want_state_in = 2 * (nl + sd) + al if sd > 0 else 2 * nl + al
    if spec.state_spec.input_dim != want_state_in:
        raise ValueError(f"state net input_dim {spec.state_spec.input_dim} != expected "
                         f"{want_state_in} for node dim {nl}, arc dim {al}, state_dim {sd}")
    comp = (sd + nl) if sd > 0 else nl
    want_out_in = 2 * comp + al if spec.focus == "a" else comp
    if spec.output_spec.input_dim != want_out_in:
        raise ValueError(f"output net input_dim {spec.output_spec.input_dim} != expected "
                         f"{want_out_in} for focus {spec.focus!r}")
    if spec.output_spec.units[-1] != dt:
        raise ValueError(f"output net output dim {spec.output_spec.units[-1]} != target dim {dt}")


def _moving_mask(state, state_old, thr: float):
    """Convergence predicate ||state - old|| > thr * ||old|| per entity."""
    dist = torch.sqrt(torch.sum((state - state_old) ** 2, dim=-1))
    norm = torch.sqrt(torch.sum(state_old * state_old, dim=-1))
    return dist > thr * norm


def _uses_kernels(spec: GNNSpec, gb: GraphBatch) -> bool:
    """Static dispatch of gnn_tpu's propagate at eval (core.py:354-466)."""
    ss = spec.state_spec
    if spec.aggregation == "pallas":
        raise NotImplementedError(
            "aggregation='pallas' runs the segment kernel K18 "
            "(pallas_segment.py::_agg_kernel), which is not ported yet")
    fusable = all(a in FUSABLE_ACTIVATIONS for a in ss.activations)
    if spec.aggregation == "fused" and (ss.num_layers not in (1, 2) or not fusable):
        raise ValueError("aggregation='fused' supports 1- or 2-dense-layer state "
                         f"nets with activations in {FUSABLE_ACTIVATIONS}")
    if spec.aggregation not in ("auto", "fused"):
        return False
    if gb.adj_loop is None:
        if spec.aggregation == "fused":
            raise NotImplementedError(
                "aggregation='fused' on a batch without the loop/dep layout runs "
                "K4 over every block per step, which is not ported; build the "
                "batch with fused_layout=True")
        return False
    if ss.units[-1] != gb.nodes.shape[1] or not fusable:
        return False
    if ss.num_layers == 2:
        raise NotImplementedError(
            "two-layer state nets run the 2-layer eval kernels K9/K10 "
            "(pallas_fused.py::_step2_kernel_T/_loop2_kernel_T), not ported yet")
    return ss.num_layers == 1


def propagate(spec: GNNSpec, params_state, bn_state, gb: GraphBatch,
              training: bool = False):
    """Fixed-point propagation. Returns (iters, state): the realised
    iteration count (float 0-d tensor) and the [Np, D] node states."""
    if training:
        raise NotImplementedError(
            "training-mode propagation runs the BN training kernels K1/K2 "
            "(pallas_bn.py) or the dropout kernels K6-K8, not ported yet")
    if spec.state_dim > 0:
        raise NotImplementedError(
            "state_dim > 0 draws its initial state from the JAX PRNG and folds "
            "labels into the kernels; not ported yet")
    if _uses_kernels(spec, gb):
        return _propagate_hybrid(spec, params_state, bn_state, gb)
    return _propagate_plain(spec, params_state, bn_state, gb)


def _propagate_plain(spec, params_state, bn_state, gb):
    """Masked fixed-K loop (gnn_tpu core.py:932-951), eval mode."""
    Np = gb.n_node_pad
    nm = gb.node_mask
    thr = float(spec.threshold)
    state = gb.nodes
    state_old = torch.ones_like(state)
    active = torch.ones((), dtype=torch.bool, device=state.device)
    k = torch.zeros((), dtype=torch.float32, device=state.device)
    for _ in range(spec.max_iteration):
        # movement test before the update; padded nodes never block convergence
        active = active & (_moving_mask(state, state_old, thr) & nm).any()
        agg = aggregate_to_nodes(state[gb.src], gb.edge_w, gb.dst, Np)
        new = mlp_apply(spec.state_spec, params_state, bn_state,
                        torch.cat([state, agg, gb.agg_arcs_cache], dim=1))
        state, state_old = (torch.where(active, new, state),
                            torch.where(active, state, state_old))
        k = k + active.float()
    return k, state


def hybrid_operands(spec: GNNSpec, params_state, bn_state, gb: GraphBatch):
    """The kernels' operands on the hybrid path: (loop, dep, Wa).

    `loop` holds K3's tensor arguments (adjT, s0, fT, w2, affine, nm) for the
    loop blocks; `dep` holds K4's (adjT, s, fT, w2, affine) for the dep blocks
    at their initial states, or is None without dep blocks; `Wa` [H, D] takes
    the residual term through the aggregation weights (`residual_term`).

    The dense layer is reassociated through the aggregation: [Ws; Wa] enters
    the kernels, the loop-invariant Wf @ agg_arcs + b is computed once here and
    the residual term goes through Wa inside each dep step (all linear)."""
    W = gb.block_w
    Np, D = gb.nodes.shape
    B = Np // W
    affine = None
    if spec.state_spec.batch_normalization:
        affine = bn_inference_affine(params_state["bn"]["gamma"], params_state["bn"]["beta"],
                                     bn_state["mean"], bn_state["var"])
    w = params_state["dense_0"]["w"]                       # [H, 2D + AL]
    Wa = w[:, D:2 * D]
    w2 = torch.cat([w[:, :D], Wa], dim=0).contiguous()     # [2H, D]
    fT3 = F.linear(gb.agg_arcs_cache, w[:, 2 * D:], params_state["dense_0"]["b"])
    fT3 = fT3.reshape(B, W, D)
    s03 = gb.nodes.reshape(B, W, D)
    li = gb.loop_ids
    loop = dict(adjT=gb.adj_loop, s0=s03[li], fT=fT3[li], w2=w2, affine=affine,
                nm=gb.loop_nm)
    dep = None
    if gb.adj_dep is not None:
        di = gb.dep_ids
        dep = dict(adjT=gb.adj_dep, s=s03[di], fT=fT3[di], w2=w2, affine=affine)
    return loop, dep, Wa


def residual_term(gb: GraphBatch, sd, Wa):
    """K4's rT [Bd, W, H]: the residual arcs' weighted sources through Wa,
    summed into their destinations. Residual arcs couple dep blocks only and
    use dep-local flat node ids; padding arcs add 0 to node 0."""
    Bd, W, D = sd.shape
    vals = sd.reshape(Bd * W, D)[gb.res_src_loc] * gb.res_w[:, None]
    res = sd.new_zeros((Bd * W, Wa.shape[0])).index_add_(0, gb.res_dst_loc, vals @ Wa.t())
    return res.reshape(Bd, W, -1)


def _propagate_hybrid(spec, params_state, bn_state, gb):
    """K3 over the loop blocks, K4 per step over the dep blocks
    (gnn_tpu core.py:475-608) in node-major blocks [B, W, D]."""
    Np, D = gb.nodes.shape
    K = spec.max_iteration
    thr = float(spec.threshold)
    act = spec.state_spec.activations[0]
    loop, dep, Wa = hybrid_operands(spec, params_state, bn_state, gb)
    traj, margins = propagation_loop(**loop, K=K, threshold=thr, activation=act)
    loop_any = (margins > 0.5).flatten(1).any(dim=1)        # [K]
    if dep is not None:
        sd = dep["s"]
        nm_dep = gb.node_mask.reshape(-1, gb.block_w)[gb.dep_ids]
        sd_old = torch.ones_like(sd)
        active = torch.ones((), dtype=torch.bool, device=sd.device)
        k = torch.zeros((), dtype=torch.float32, device=sd.device)
        for it in range(K):
            moving = _moving_mask(sd, sd_old, thr) & nm_dep
            active = active & (loop_any[it] | moving.any())
            new = propagation_step(dep["adjT"], sd, residual_term(gb, sd, Wa), dep["fT"],
                                   dep["w2"], dep["affine"], act)
            sd, sd_old = torch.where(active, new, sd), torch.where(active, sd, sd_old)
            k = k + active.float()
    else:
        k = torch.cumprod(loop_any.float(), dim=0).sum()
    # the state after the realised iteration count (s0 when it is 0)
    idx = (k.long() - 1).clamp_min(0).reshape(1)
    sel = torch.where(k >= 1.0, traj.index_select(0, idx)[0], loop["s0"])
    full = torch.cat([sel, sd]) if dep is not None else sel
    return k, full[gb.block_perm].reshape(Np, D)


def gnn_forward(spec: GNNSpec, params, bn, gb: GraphBatch, training: bool = False):
    """Full inference forward. Returns a dict with
      iters:      realised propagation steps (0-d float tensor)
      state:      [Np, D] node states
      out_entity: per-entity outputs, [Np, DT] ('n'/'g') or [Ep, DT] ('a')
      out:        target-aligned rows [Tp, DT] (pooled per graph for 'g')
    """
    check_dims(spec, gb.nodes.shape[1], gb.arc_labels.shape[1], gb.targets.shape[1])
    if gb.device.type == "cuda":
        # the plain products (feature term, readout) in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
    iters, state = propagate(spec, params["state"], bn["state"], gb, training)
    if gb.focus == "a":
        arc_inp = torch.cat([state[gb.src], state[gb.dst], gb.arc_labels], dim=1)
        out_entity = mlp_apply(spec.output_spec, params["output"], bn["output"], arc_inp)
        out = out_entity[gb.out_index]
    else:
        out_entity = mlp_apply(spec.output_spec, params["output"], bn["output"], state)
        if gb.focus == "g":
            # average readout over each graph's real nodes
            out = pool_graphs(out_entity, gb.graph_ids,
                              gb.pool_w * gb.node_mask.to(out_entity.dtype),
                              gb.n_target_pad)
        else:
            out = out_entity[gb.out_index]
    return {"iters": iters, "state": state, "out_entity": out_entity, "out": out}
