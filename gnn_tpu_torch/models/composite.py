"""Composite (heterogeneous) GNN: one state net per node type (counterpart of
gnn_tpu/models/composite.py).

Nodes carry an integer type, and type t has its own state net f_w^t; the
aggregation, the convergence test and the readout are the homogeneous
model's (models/core.py). The plain body runs every type's net over all
rows and selects by type:

    state_next = sum_t 1[type == t] * f_w^t([state | agg | arc aggregation])

with each type's BatchNorm moments over its own real nodes and one dropout
keep-mask per type.

Dispatch follows gnn_tpu's (composite.py:170-196): on a batch with the
loop/dep layout, with aggregation 'auto', grad_mode 'unroll' and the state
nets' output as wide as the node labels,

* training with every per-type net a one-layer state net with the trailing
  BatchNorm and dropout only at the input runs the typed BN kernels K16/K17
  (ops/typed.py::bn_typed_train_propagate);
* eval with one-layer per-type nets runs K16 once an iteration
  (ops/typed.py::typed_eval_propagate);
* everything else runs the plain body, as it runs gnn_tpu's XLA body
  (BatchNorm-free composite training included); its state aggregation is
  the homogeneous one (core.state_aggregation), so a 'pallas' spec on a
  batch with a plan aggregates through K18.

With grad_mode='ift' the plain body gives the fixed point, computed without
a graph, and the implicit adjoint of models/ift.py differentiates it through
one plain per-type step (gnn_tpu composite.py:222-253). With state_dim > 0
the state starts at core.draw_init's draw and the labels and their
aggregation fold into the typed kernels' features, as the homogeneous
model's (ops/fold.py; gnn_tpu composite.py:139-151). Dropout keep-masks are
drawn by `draw_masks` (one state keep-mask per type, and the initial state)
or passed in. On a bf16-adjacency batch the typed routes run the bf16
variants of K16 and K17 (ops/typed.py); the plain body raises
NotImplementedError on it (core.check_adj_dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.models.core import (check_adj_dtype, check_dims, check_modes,
                                       draw_net_masks, draw_output_masks, finish_ift, finish_step,
                                       full_fp32, ift_step_input, initial_state, plain_loop,
                                       readout, state_width, weighted_loss, with_init)
from gnn_tpu_torch.ops.mlp import MLPSpec, mlp_apply, mlp_init, mlp_regularization
from gnn_tpu_torch.ops.typed import (bn_typed_train_propagate, supports_typed_bn_train,
                                     supports_typed_eval, typed_eval_propagate)
from gnn_tpu_torch.training.losses import get_loss


@dataclasses.dataclass(frozen=True)
class CompositeGNNSpec:
    """Static description of a heterogeneous GNN.

    :param focus: 'n' | 'a' | 'g' (as GNNSpec).
    :param state_specs: one MLPSpec per node type, all with the same input
        and output widths.
    :param output_spec: the readout net, shared by all types.
    :param aggregation / grad_mode / ift_backward_iters / state_dim: as GNNSpec.
    """
    focus: str
    state_specs: Tuple[MLPSpec, ...]
    output_spec: MLPSpec
    max_iteration: int = 5
    threshold: float = 0.01
    aggregation: str = "auto"
    grad_mode: str = "unroll"
    ift_backward_iters: int = 20
    state_dim: int = 0

    def __post_init__(self):
        if self.focus not in ("n", "a", "g"):
            raise ValueError("focus must be 'n', 'a' or 'g'")
        if not self.state_specs:
            raise ValueError("state_specs must contain at least one MLPSpec")
        object.__setattr__(self, "state_specs", tuple(self.state_specs))
        dims = {(s.input_dim, s.units[-1]) for s in self.state_specs}
        if len(dims) != 1:
            raise ValueError(f"all per-type state nets must share (input_dim, output_dim); "
                             f"got {sorted(dims)}")
        check_modes(self.aggregation, self.grad_mode, self.state_specs)
        if self.state_dim < 0 or not isinstance(self.state_dim, int):
            raise TypeError("param <state_dim> must be int>=0")

    @property
    def n_types(self) -> int:
        return len(self.state_specs)

    @property
    def state_spec(self) -> MLPSpec:
        """Type 0's state net: the widths every type shares (check_dims)."""
        return self.state_specs[0]


def composite_init(spec: CompositeGNNSpec, gen: torch.Generator, device="cpu"):
    """(params, bn_state): {'state': (per type ...), 'output': ...}, drawn
    from `gen`."""
    ps, bs = zip(*(mlp_init(s, gen, device) for s in spec.state_specs))
    po, bo = mlp_init(spec.output_spec, gen, device)
    return {"state": tuple(ps), "output": po}, {"state": tuple(bs), "output": bo}


def draw_masks(spec: CompositeGNNSpec, gb: GraphBatch, gen: torch.Generator) -> dict:
    """Keep-masks of one training forward, drawn on the batch's device from
    `gen`: {"state": (per type {position: bool [K, Np, width]}), "output":
    {position: bool [rows, width]}}, each type's net drawing its own; with
    state_dim > 0 also "init", the initial state (core.draw_init)."""
    lead = (spec.max_iteration, gb.n_node_pad)
    masks = {"state": tuple(draw_net_masks(s, lead, gb, gen) for s in spec.state_specs),
             "output": draw_output_masks(spec, gb, gen)}
    return with_init(masks, spec, gb, gen)


def check_node_types(glist, n_types: int) -> None:
    """Raise unless a request's graphs suit a composite model of n_types
    types: some graph carries node types (as in gnn_tpu's batch, a graph
    without them in a typed request is type 0) and every type lies in
    range(n_types), which the typed kernels index by."""
    if all(g.node_types is None for g in glist):
        raise ValueError("composite models need graphs with node_types")
    typed = [g.node_types for g in glist if g.node_types is not None and len(g.node_types)]
    lo = min((int(t.min()) for t in typed), default=0)
    hi = max((int(t.max()) for t in typed), default=0)
    if lo < 0 or hi >= n_types:
        raise ValueError(f"node types must lie in [0, {n_types}), got {lo}..{hi}")


def _route(spec: CompositeGNNSpec, gb: GraphBatch, training: bool) -> str:
    """gnn_tpu's dispatch (composite.py:170-196): 'typed_bn' (K16/K17),
    'typed_eval' (K16) or 'plain'. Every blocked batch takes the typed
    kernels, with the loop/dep layout or the all-dep one (graphs/batch.py);
    a batch without blocks (GraphBatch.from_graph) runs the plain body."""
    if (not gb.has_blocks or spec.aggregation != "auto" or spec.grad_mode == "ift"
            or spec.state_specs[0].units[-1] != state_width(spec, gb)):
        return "plain"
    if training:
        return "typed_bn" if supports_typed_bn_train(spec.state_specs) else "plain"
    return "typed_eval" if supports_typed_eval(spec.state_specs) else "plain"


def composite_propagate(spec: CompositeGNNSpec, params_state, bn_state, gb: GraphBatch,
                        training: bool = False, keep: Optional[tuple] = None,
                        init: Optional[torch.Tensor] = None):
    """Fixed-point loop with per-type state nets (the homogeneous loop's
    convergence semantics). Returns (iters, state [Np, D], new per-type
    BatchNorm statistics as a tuple).

    :param keep: in training, the per-type keep-masks (draw_masks(...)["state"]).
    :param init: the initial state [Np, state_dim] at state_dim > 0.
    """
    if gb.node_types is None:
        raise ValueError("composite models need a batch built from a Graph with node_types")
    keep = keep or tuple({} for _ in spec.state_specs)
    s0 = initial_state(spec, gb, init)
    route = _route(spec, gb, training)
    check_adj_dtype(gb, route, training, spec.grad_mode)
    if route == "typed_bn":
        return bn_typed_train_propagate(spec, params_state, bn_state, gb,
                                        [k[0] for k in keep] if keep[0] else None, init)
    if route == "typed_eval":
        return typed_eval_propagate(spec, params_state, bn_state, gb, init)
    nm = gb.node_mask
    types = gb.node_types

    def step(it, inp, bn):
        new, new_bns = 0.0, []
        for t, (ss, p, b, k) in enumerate(zip(spec.state_specs, params_state, bn, keep)):
            is_t = types == t
            o, nb = mlp_apply(ss, p, b, inp, training=training,
                              keep={pos: m[it] for pos, m in k.items()}, stat_mask=nm & is_t)
            new = new + o * is_t[:, None].to(o.dtype)
            new_bns.append(nb)
        return new, tuple(new_bns)
    if spec.grad_mode != "ift":
        return plain_loop(spec, gb, step, tuple(bn_state), s0)
    with torch.no_grad():
        k, state, bn_out = plain_loop(spec, gb, step, tuple(bn_state), s0)
    return k, finish_ift(spec, training, params_state, bn_out, gb, state, _ift_state_step), bn_out


def _ift_state_step(spec: CompositeGNNSpec, training: bool, params_state, s, consts):
    """One stationary step of the per-type state nets (gnn_tpu's
    _composite_ift_state_step, composite.py:235-251) on core.ift_step_input,
    no kernel."""
    gb = consts["gb"]
    inp = ift_step_input(s, consts)
    out = 0.0
    for t, (ss, p, b) in enumerate(zip(spec.state_specs, params_state, consts["bn"])):
        is_t = gb.node_types == t
        o, _ = mlp_apply(ss, p, b, inp, training=training, stat_mask=gb.node_mask & is_t)
        out = out + o * is_t[:, None].to(o.dtype)
    return out


def composite_forward(spec: CompositeGNNSpec, params, bn, gb: GraphBatch,
                      training: bool = False, masks: Optional[dict] = None):
    """Composite propagation, then the homogeneous model's readout. Returns
    gnn_forward's result dict; its "bn" holds the per-type statistics as a
    tuple under "state"."""
    check_dims(spec, gb.nodes.shape[1], gb.arc_labels.shape[1], gb.targets.shape[1])
    full_fp32(gb)
    masks = masks or {}
    iters, state, bn_s = composite_propagate(spec, params["state"], bn["state"], gb, training,
                                             masks.get("state"), masks.get("init"))
    return readout(spec, params, bn, gb, iters, state, bn_s, training, masks.get("output"))


def composite_regularization(spec: CompositeGNNSpec, params) -> torch.Tensor:
    reg = mlp_regularization(spec.output_spec, params["output"])
    for s, p in zip(spec.state_specs, params["state"]):
        reg = reg + mlp_regularization(s, p)
    return reg


def composite_train_step(spec: CompositeGNNSpec, params, bn, optimizer: torch.optim.Optimizer,
                         gb: GraphBatch, masks: dict, *, loss_name,
                         loss_args: Optional[dict] = None, mean: bool = True) -> dict:
    """One optimizer step on one batch (gnn_tpu's make_composite_train_step):
    the loss plus every net's regularization is differentiated, the per-type
    state nets' grads are divided by the realised iteration count when
    `mean`, and `optimizer` updates the leaves of `params` in place.
    Returns {"iters", "loss", "bn"} as device tensors."""
    optimizer.zero_grad(set_to_none=True)
    res = composite_forward(spec, params, bn, gb, training=True, masks=masks)
    loss = weighted_loss(get_loss(loss_name), loss_args or {}, gb, res["out"])
    return finish_step(params, optimizer, res["iters"],
                       loss + composite_regularization(spec, params), loss, res["bn"], mean)


def composite_full_eval(spec: CompositeGNNSpec, params, bn, gb: GraphBatch, loss_name,
                        loss_args: Optional[dict] = None, training: bool = False,
                        masks: Optional[dict] = None):
    """gnn_tpu's make_composite_full_eval contract: (iters, loss, out rows,
    state, out_entity)."""
    res = composite_forward(spec, params, bn, gb, training, masks)
    loss = weighted_loss(get_loss(loss_name), loss_args or {}, gb, res["out"])
    return res["iters"], loss, res["out"], res["state"], res["out_entity"]
