"""Functional core of the GNN: fixed-point propagation, the focus-specific
readout, the loss and the training step (counterpart of
gnn_tpu/models/core.py).

Propagation iterates state <- net_state([state, sum_nbr state, sum_nbr arc
labels]) while any real node moved more than threshold * ||state_old|| and
k < max_iteration (reference GNN.py:202-242). It runs a fixed K steps with an
`active` flag, as tensor ops only, so the device never waits on the host.

Dispatch follows gnn_tpu's `aggregation='auto'`:

* at eval, a batch with the loop/dep layout and a one-layer state net with a
  kernel activation takes the hybrid path: K3 (`propagation_loop`) runs
  every iteration of the residual-free blocks, K4 (`propagation_step`) one
  iteration per step of the residual-coupled blocks, and the global early
  stop is rebuilt from K3's movement flags; a two-layer state net (the
  hidden-150 recipe) takes the same path through K10 (`propagation_loop2`)
  and K9 (`propagation_step2`), ops/fused2.py;
* in training, a one- or two-layer spec takes one of three routes: with
  neither dropout nor BatchNorm the same hybrid path, differentiated through
  K5 (K3's backward) and K4's plain backward, or for two layers through K11
  (K10's backward, `propagation_loop2_bwd`) and K9's plain backward; with
  input dropout and no BatchNorm the dropout kernels, K7 (`train_loop`,
  backward K8) over the loop blocks and K6 (`train_step`) per step over the
  dep blocks, or for two layers K12 (`train_loop2`, backward K13) over the
  loop blocks and a plain step over the dep blocks, as gnn_tpu does; with
  the trailing BatchNorm and dropout only at the input the BN kernels K1/K2,
  or K14/K15 for two layers (ops/bn.py);
* `aggregation='fused'` on a blocked batch without the loop/dep layout
  (graphs/batch.py's all-dep layout: every block a dep block) takes the same
  routes with no loop blocks, as gnn_tpu's per-step fused path: K4 or K9
  every iteration at eval and on the clean routes, K6 per step with input
  dropout, K1/K2 or K14/K15 with BatchNorm; two-layer dropout training runs
  the plain body there, as gnn_tpu's;
* what gnn_tpu sends to its XLA body ('auto' without a loop layout,
  activations the kernels do not take, dropout inside the net, the
  aggregation names 'segment', 'onehot', 'pallas' and 'blocked' on a batch
  with blocks, and every batch without blocks, GraphBatch.from_graph) runs
  the plain body here; in it, a 'pallas' spec on a batch with a plan aggregates the state
  through the segment kernel K18 (ops/segment.py::block_aggregate, backward
  K18 on the transpose plan), as gnn_tpu's make_agg_closures does, and
  everything else through `index_add_` over the arcs;
* with grad_mode='ift' the fixed point comes from the eval kernels (K3/K4
  or K10/K9) where they take the spec in training, else from the plain body,
  computed without a graph, and the implicit adjoint of models/ift.py
  differentiates it (gnn_tpu's dispatch under 'ift'): no training kernel
  and no kernel's backward runs;
* with state_dim > 0 (the reference's separate state, GNN.py:259-267) the
  state starts at 0.1 * N(0, 1) on the real nodes and the step input is
  [state | labels | Σstate | Σlabels | Σarcs]; the kernels take it on every
  route by folding the labels and the two constant aggregations into their
  feature term (gnn_tpu core.py:490-513): state width D = state_dim, the
  dense layer's columns in the kernels' order [Ws | Wa | Wfold]
  (`kernel_columns`) and the feature rows [labels | Σlabels | Σarcs]
  (`fold_features`); the readout reads [state | labels];
* a batch whose block adjacency is bf16 (from_graphs_blocked(adj_dtype=
  torch.bfloat16), gnn_tpu's low-precision mode) runs every kernel route:
  'hybrid' through the bf16 variants of K3 and K4 (ops/fused.py), in
  training differentiated through K5's and K4's plain f32 backward; 'bn'
  through those of K1 and K2, or of K14 and K15 for a two-layer state net
  (ops/bn.py); 'hybrid2': the bf16 variants of K10 and K9 at eval and in
  clean two-layer training, differentiated through K11's bf16 variant and
  K9's plain f32 backward; 'dropout2' through those of K12 and K13
  (ops/fused2.py) and the plain f32 dep step; 'dropout' through those of K7
  and K8 over the loop blocks and K6's per step, differentiated through
  K6's plain f32 backward (on either layout); composite models' routes
  through those of K16 and K17 (models/composite.py). The plain body and
  grad_mode='ift' raise NotImplementedError on it (check_adj_dtype).

Dropout and the initial state draw no random numbers here: training takes
keep-masks and, with state_dim > 0, the initial state ("init"), which
`draw_masks` draws on the batch's device from a torch.Generator (tests pass
gnn_tpu's draws instead); at eval `draw_init` draws the initial state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.models.ift import fixed_point_ift
from gnn_tpu_torch.ops.aggregate import aggregate_to_nodes, pool_graphs
from gnn_tpu_torch.ops.bn import _affine as bn_affine
from gnn_tpu_torch.ops.bn import (bn_train_propagate, supports_fused_bn2_train,
                                  supports_fused_bn_train)
from gnn_tpu_torch.ops.fused import (FUSABLE_ACTIVATIONS, _make_drop, fused_propagation_loop,
                                     fused_propagation_loop_bf16, fused_propagation_step,
                                     fused_propagation_step_bf16, fused_train_loop,
                                     fused_train_loop_bf16, fused_train_step,
                                     fused_train_step_bf16, moved, supports_fused,
                                     supports_fused_train)
from gnn_tpu_torch.ops.fold import (fold_features, in_kernel_order, initial_state,
                                   kernel_columns, state_width)
from gnn_tpu_torch.ops.fused2 import (dense2, fused_propagation_loop2,
                                      fused_propagation_loop2_bf16, fused_propagation_step2,
                                      fused_propagation_step2_bf16, fused_train_loop2,
                                      fused_train_loop2_bf16, seq_dot,
                                      supports_fused2, supports_fused2_train)
from gnn_tpu_torch.ops.mlp import (MLPSpec, dropout_widths, mlp_apply, mlp_init,
                                   mlp_regularization)
from gnn_tpu_torch.ops.segment import block_aggregate
from gnn_tpu_torch.training.losses import get_loss

AGGREGATIONS = ("auto", "segment", "onehot", "fused", "pallas", "blocked")
GRAD_MODES = ("unroll", "ift")


@dataclasses.dataclass(frozen=True)
class GNNSpec:
    """Static model description.

    :param focus: 'n' | 'a' | 'g' problem focus.
    :param state_spec / output_spec: MLP architectures of the state and output nets.
    :param state_dim: reference state_vect_dim (0 = node labels are the state).
    :param max_iteration: the most propagation steps.
    :param threshold: convergence threshold.
    :param aggregation: gnn_tpu's strategy name; 'auto' dispatches to the kernels.
    :param grad_mode / ift_backward_iters: gnn_tpu's gradient mode ('unroll'
        differentiates the unrolled iterations, 'ift' the fixed point through
        the implicit adjoint, models/ift.py) and the adjoint's Neumann
        iterations.
    """
    focus: str
    state_spec: MLPSpec
    output_spec: MLPSpec
    state_dim: int = 0
    max_iteration: int = 5
    threshold: float = 0.01
    aggregation: str = "auto"
    grad_mode: str = "unroll"
    ift_backward_iters: int = 20

    def __post_init__(self):
        if self.focus not in ("n", "a", "g"):
            raise ValueError("focus must be 'n', 'a' or 'g'")
        if self.state_dim < 0 or not isinstance(self.state_dim, int):
            raise TypeError("param <state_dim> must be int>=0")
        check_modes(self.aggregation, self.grad_mode, (self.state_spec,))


def check_modes(aggregation: str, grad_mode: str, state_specs) -> None:
    """Validate the aggregation name and the gradient mode of a spec (as
    gnn_tpu's GNNSpec and CompositeGNNSpec do)."""
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"aggregation must be one of {AGGREGATIONS}")
    if grad_mode not in GRAD_MODES:
        raise ValueError("grad_mode must be 'unroll' or 'ift'")
    if grad_mode == "ift" and any(s.dropout_rate for s in state_specs):
        raise ValueError("grad_mode='ift' requires dropout-free state nets "
                         "(per-iteration masks make the step non-stationary)")


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
    """Convergence predicate ||state - old|| > thr * ||old|| per entity (a
    boolean: no gradient flows through it)."""
    return moved(state.detach(), state_old.detach(), thr) > 0.5


def _check_aggregation(spec: GNNSpec) -> bool:
    """Whether the spec's aggregation dispatches to the propagation kernels
    ('auto', 'fused'); raises for specs 'fused' cannot take. 'pallas' and
    'blocked' run the plain body, as gnn_tpu's XLA body
    (gnn_tpu/models/core.py:203-262): 'pallas' aggregates through K18 on a
    batch with a plan (GraphBatch.from_graph(build_plan=True)), which has no
    blocks, and through `index_add_` on any other batch."""
    ss = spec.state_spec
    if spec.aggregation == "fused" and (
            ss.num_layers not in (1, 2)
            or not all(a in FUSABLE_ACTIVATIONS for a in ss.activations)):
        raise ValueError("aggregation='fused' supports 1- or 2-dense-layer state "
                         f"nets with activations in {FUSABLE_ACTIVATIONS}")
    return spec.aggregation in ("auto", "fused")


def _kernel_layout(spec: GNNSpec, gb: GraphBatch) -> bool:
    """Whether the kernels take the batch: 'auto' needs the loop/dep layout
    (gnn_tpu sends it to its XLA body otherwise, core.py:354); 'fused' runs
    on any blocked batch, over every block per step without loop blocks (the
    all-dep layout; gnn_tpu's per-step fused path, core.py:610-643), and
    raises ValueError on a batch without blocks, as gnn_tpu (core.py:426-429)."""
    if spec.aggregation == "fused":
        if not gb.has_blocks:
            raise ValueError("aggregation='fused' needs a block-dense batch "
                             "(graphs/batch.from_graphs_blocked)")
        return True
    return gb.adj_loop is not None


def _eval_route(spec: GNNSpec, gb: GraphBatch) -> str:
    """Static dispatch of gnn_tpu's propagate at eval (core.py:354-466):
    'hybrid' (K3/K4: a one-layer state net), 'hybrid2' (K10/K9: a two-layer
    one) or 'plain' (the plain body)."""
    ss = spec.state_spec
    if not _check_aggregation(spec) or not _kernel_layout(spec, gb):
        return "plain"
    if ss.units[-1] != state_width(spec, gb):
        return "plain"
    if supports_fused(ss, training=False):
        return "hybrid"
    return "hybrid2" if supports_fused2(ss, training=False) else "plain"


def _train_route(spec: GNNSpec, gb: GraphBatch) -> str:
    """Static dispatch of gnn_tpu's propagate in training (core.py:354-474):
    'hybrid' (K3/K5 and K4: neither dropout nor BatchNorm), 'dropout' (K6-K8:
    input dropout, no BatchNorm), 'bn' (K1/K2, or K14/K15 for a two-layer
    net), 'hybrid2' (K10/K11 and K9: a two-layer net without dropout and
    BatchNorm), 'dropout2' (K12/K13: a two-layer net with input dropout, no
    BatchNorm; without loop blocks gnn_tpu runs its XLA body, core.py:457-461)
    or 'plain' (the plain body)."""
    ss = spec.state_spec
    if not _check_aggregation(spec) or not _kernel_layout(spec, gb):
        return "plain"
    fusable = all(a in FUSABLE_ACTIVATIONS for a in ss.activations)
    if ss.units[-1] != state_width(spec, gb) or not fusable:
        return "plain"
    if ss.num_layers == 1:
        if supports_fused(ss, training=True):
            return "hybrid"
        if not ss.batch_normalization and supports_fused_train(ss):
            return "dropout"
        return "bn" if supports_fused_bn_train(ss) else "plain"
    if ss.num_layers != 2:
        return "plain"
    if supports_fused2(ss, training=True):
        return "hybrid2"
    if supports_fused2_train(ss):
        return "dropout2" if gb.adj_loop is not None else "plain"
    return "bn" if supports_fused_bn2_train(ss) else "plain"


def draw_masks(spec: GNNSpec, gb: GraphBatch, gen: torch.Generator) -> dict:
    """Keep-masks of one training forward, drawn on the batch's device from
    `gen` (True = kept, with probability 1 - rate):
    {"state": {position: bool [K, Np, width]}, "output": {position: bool
    [rows, width]}}, rows being nodes, or arcs for focus 'a'; with
    state_dim > 0 also "init", the initial state (draw_init)."""
    masks = {"state": draw_net_masks(spec.state_spec, (spec.max_iteration, gb.n_node_pad), gb,
                                     gen),
             "output": draw_output_masks(spec, gb, gen)}
    return with_init(masks, spec, gb, gen)


def draw_init(spec, gb: GraphBatch, gen: torch.Generator) -> Optional[torch.Tensor]:
    """The initial state of state_dim > 0, 0.1 * N(0, 1) [Np, state_dim] on
    the real nodes, 0 on padding (gnn_tpu core.py:317-322), drawn from `gen`
    on its device and moved to the batch's; None at state_dim 0."""
    if spec.state_dim == 0:
        return None
    z = torch.randn((gb.n_node_pad, spec.state_dim), generator=gen, device=gen.device)
    return 0.1 * z.to(gb.device) * gb.node_mask[:, None].to(z.dtype)


def with_init(masks: Optional[dict], spec, gb: GraphBatch, gen: torch.Generator):
    """`masks` (None at eval) with the initial state drawn from `gen` under
    "init" where state_dim > 0; unchanged otherwise."""
    if spec.state_dim == 0:
        return masks
    return {**(masks or {}), "init": draw_init(spec, gb, gen)}


def draw_net_masks(net: MLPSpec, lead: tuple, gb: GraphBatch, gen: torch.Generator) -> dict:
    """{position: bool [*lead, width]} keep-masks of a net's dropout layers."""
    def draw(pos, w):
        rate = dict(zip(net.dropout_pos, net.dropout_rate))[pos]
        return torch.rand(lead + (w,), generator=gen, device=gb.device) < 1.0 - rate
    return {p: draw(p, w) for p, w in dropout_widths(net).items()}


def draw_output_masks(spec, gb: GraphBatch, gen: torch.Generator) -> dict:
    """The readout's keep-masks: rows are nodes, or arcs for focus 'a'."""
    rows = gb.src.shape[0] if gb.focus == "a" else gb.n_node_pad
    return draw_net_masks(spec.output_spec, (rows,), gb, gen)


def propagate(spec: GNNSpec, params_state, bn_state, gb: GraphBatch,
              training: bool = False, keep: Optional[dict] = None,
              init: Optional[torch.Tensor] = None):
    """Fixed-point propagation. Returns (iters, state, new_bn_state): the
    realised iteration count (float 0-d tensor), the [Np, D] node states and
    the state net's BatchNorm statistics (updated in training only).

    :param keep: in training, the state net's keep-masks {position: bool
        [K, Np, width]} (draw_masks(...)["state"]).
    :param init: with state_dim > 0, the initial state [Np, state_dim]
        (draw_init, or draw_masks(...)["init"]).
    """
    keep = keep or {}
    s0 = initial_state(spec, gb, init)
    route = _train_route(spec, gb) if training else _eval_route(spec, gb)
    check_adj_dtype(gb, route, training, spec.grad_mode)
    if spec.grad_mode == "ift":
        return _propagate_ift(spec, params_state, bn_state, gb, training, route, s0)
    if route == "bn":
        return bn_train_propagate(spec, params_state, bn_state, gb, keep.get(0), s0)
    if route == "plain":
        return _propagate_plain(spec, params_state, bn_state, gb, training, keep, s0)
    if route == "dropout":
        k, state = _propagate_dropout(spec, params_state, gb, keep.get(0), s0)
    elif route == "dropout2":
        k, state = _propagate_dropout2(spec, params_state, gb, keep.get(0), s0)
    elif route == "hybrid":
        k, state = _propagate_hybrid(spec, params_state, bn_state, gb, s0)
    else:
        k, state = _propagate_hybrid2(spec, params_state, bn_state, gb, s0)
    return k, state, bn_state


def check_adj_dtype(gb: GraphBatch, route: str, training: bool = False,
                    grad_mode: str = "unroll") -> None:
    """A bf16 block adjacency runs, unrolled, every kernel route: 'hybrid'
    (the bf16 K3 and K4, in training K5's), 'hybrid2' (the bf16 K10, K9 and
    K11), 'dropout' (the bf16 K7, K8 and K6), 'dropout2' (the bf16 K12 and
    K13), 'bn' (the bf16 K1 and K2, or K14 and K15 for a two-layer state
    net) and composite models' 'typed_bn' (the bf16 K16 and K17) and
    'typed_eval' (the bf16 K16). The plain body and grad_mode 'ift' raise, on
    every device, rather than cast the batch."""
    if gb.adj_dtype != torch.bfloat16 or (route != "plain" and grad_mode == "unroll"):
        return
    what = f"route {route!r}" + (" with grad_mode='ift'" if grad_mode == "ift" else "")
    raise NotImplementedError(
        f"a bf16-adjacency batch runs only the kernel routes unrolled; {what} "
        f"({'training' if training else 'eval'}) on it is not ported yet (ROADMAP Queue 1 "
        f"item 2: the plain body and IFT on bf16)")


def _propagate_plain(spec, params_state, bn_state, gb, training=False, keep=None, s0=None):
    """Masked fixed-K loop (gnn_tpu core.py:932-951); in training the
    BatchNorm statistics follow the active steps only."""
    nm = gb.node_mask

    def step(it, inp, bn):
        return mlp_apply(spec.state_spec, params_state, bn, inp, training=training,
                         keep={p: m[it] for p, m in (keep or {}).items()}, stat_mask=nm)
    return plain_loop(spec, gb, step, bn_state, s0)


def state_aggregation(spec, gb: GraphBatch):
    """The plain body's state aggregation A^T_w @ state (gnn_tpu's
    make_agg_closures agg_state): K18 for a 'pallas' spec on a batch with a
    plan, else `index_add_` over the arcs."""
    if spec.aggregation == "pallas" and gb.agg_plan is not None:
        return lambda s: block_aggregate(s, gb.agg_plan)
    return lambda s: aggregate_to_nodes(s[gb.src], gb.edge_w, gb.dst, gb.n_node_pad)


def step_constants(spec, gb: GraphBatch, agg_state=None) -> torch.Tensor:
    """The step input's loop-invariant columns after Σstate: the arc-label
    aggregation, with state_dim > 0 [Σlabels | Σarcs], Σlabels from the
    cache or else through `agg_state` (gnn_tpu core.py:323-325; K18 for a
    'pallas' spec on a plan batch)."""
    if spec.state_dim == 0:
        return gb.agg_arcs()
    agg_nodes = gb.agg_nodes_cache
    if agg_nodes is None:
        agg_nodes = (agg_state or state_aggregation(spec, gb))(gb.nodes)
    return torch.cat([agg_nodes, gb.agg_arcs()], dim=1)


def step_input(spec, gb: GraphBatch, state, agg, consts) -> torch.Tensor:
    """The state net's input [state | Σstate | consts], with state_dim > 0
    [state | labels | Σstate | consts] (gnn_tpu core.py:323-330)."""
    head = [state] if spec.state_dim == 0 else [state, gb.nodes]
    return torch.cat(head + [agg, consts], dim=1)


def plain_loop(spec, gb: GraphBatch, step, bn_state, s0=None):
    """The plain body's masked fixed-K loop from s0 (default the node
    labels): the movement test before each update (padded nodes never block
    convergence), the aggregation (state_aggregation) and the state net(s)
    `step(it, step_input, bn)` -> (new state, new BatchNorm statistics).
    Returns (iters, state, bn)."""
    agg_state = state_aggregation(spec, gb)
    consts = step_constants(spec, gb, agg_state)
    nm = gb.node_mask
    thr = float(spec.threshold)
    state = gb.nodes if s0 is None else s0
    state_old = torch.ones_like(state)
    active = torch.ones((), dtype=torch.bool, device=state.device)
    k = torch.zeros((), dtype=torch.float32, device=state.device)
    bn = bn_state
    for it in range(spec.max_iteration):
        active = active & (_moving_mask(state, state_old, thr) & nm).any()
        new, new_bn = step(it, step_input(spec, gb, state, agg_state(state), consts), bn)
        state, state_old = (torch.where(active, new, state),
                            torch.where(active, state, state_old))
        bn = _tree_where(active, new_bn, bn)
        k = k + active.float()
    return k, state, bn


def _tree_where(pred, a, b):
    """where(pred, a, b) over matching trees of dicts and tuples of tensors."""
    if isinstance(a, dict):
        return {key: _tree_where(pred, a[key], b[key]) for key in a}
    if isinstance(a, (list, tuple)):
        return tuple(_tree_where(pred, x, y) for x, y in zip(a, b))
    return torch.where(pred, a, b)


def _propagate_ift(spec, params_state, bn_state, gb, training: bool, route: str, s0):
    """grad_mode='ift' (gnn_tpu core.py:371-379, :603-607, :953-964): the
    fixed point from the eval kernels where the route is 'hybrid' (K3/K4) or
    'hybrid2' (K10/K9), else from the plain body (with batch-statistic
    BatchNorm in training), computed without a graph, so no training kernel
    and no kernel's backward runs; finish_ift installs the implicit
    adjoint."""
    with torch.no_grad():
        if route == "hybrid":
            k, state = _propagate_hybrid(spec, params_state, bn_state, gb, s0)
            bn_out = bn_state
        elif route == "hybrid2":
            k, state = _propagate_hybrid2(spec, params_state, bn_state, gb, s0)
            bn_out = bn_state
        else:
            k, state, bn_out = _propagate_plain(spec, params_state, bn_state, gb, training,
                                                s0=s0)
    return k, finish_ift(spec, training, params_state, bn_out, gb, state, ift_state_step), bn_out


def finish_ift(spec, training: bool, params_state, bn, gb: GraphBatch, state, step):
    """The fixed point `state` with the implicit adjoint installed
    (gnn_tpu's _finish_ift, core.py:283-298): its backward solves for λ with
    `step(spec, training, params_state, s, consts)` at the fixed point, the
    BatchNorm statistics `bn` and the step input's constant columns
    (step_constants) held constant."""
    consts = {"gb": gb, "bn": detach_tree(bn), "spec": spec,
              "consts": step_constants(spec, gb).detach()}

    def f(leaves, s, c):
        return step(spec, training, _unflatten(params_state, leaves), s, c)
    return fixed_point_ift(f, spec.ift_backward_iters, list(param_leaves(params_state)), state,
                           consts)


def ift_state_step(spec, training: bool, params_state, s, consts):
    """One stationary step of the state net (gnn_tpu's _ift_state_step,
    core.py:967-1000) on ift_step_input, no kernel."""
    out, _ = mlp_apply(spec.state_spec, params_state, consts["bn"], ift_step_input(s, consts),
                       training=training, stat_mask=consts["gb"].node_mask)
    return out


def ift_step_input(s, consts):
    """The IFT step's input (step_input) with the aggregation over the
    batch's arcs with `index_add_` (gnn_tpu's block product sums the
    same terms in another order). The gather is an index_select, whose
    backward is an `index_add_`: advanced indexing's backward sorts and
    serialises repeated indices (the padding arcs'), 31 ms a call on the
    H100 at full scale."""
    gb = consts["gb"]
    agg = aggregate_to_nodes(s.index_select(0, gb.src), gb.edge_w, gb.dst, gb.n_node_pad)
    return step_input(consts["spec"], gb, s, agg, consts["consts"])


def _unflatten(tree, leaves):
    """`tree` with its tensors replaced, in param_leaves order, by `leaves`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return tuple(build(v) for v in t)
        return next(it)
    return build(tree)


def hybrid_operands(spec: GNNSpec, params_state, bn_state, gb: GraphBatch,
                    init: Optional[torch.Tensor] = None):
    """The kernels' operands on the hybrid path: (loop, dep, Wa).

    `loop` holds K3's tensor arguments (adjT, s0, fT, w2, affine, nm) for the
    loop blocks, or is None without loop blocks (the all-dep layout); `dep`
    holds K4's (adjT, s, fT, w2, affine) for the dep blocks at their initial
    states, or is None without dep blocks; `Wa` [H, D] takes
    the residual term through the aggregation weights (`residual_term`).

    The dense layer is reassociated through the aggregation: [Ws; Wa] enters
    the kernels, the loop-invariant Wfold @ fold + b (fold_features) is
    computed once here and the residual term goes through Wa inside each dep
    step (all linear). On a bf16-adjacency batch fT is formed by seq_dot (the
    same bits on every device), as hybrid2_operands does. `init`: the
    initial state at state_dim > 0."""
    W = gb.block_w
    s0 = initial_state(spec, gb, init)
    Np, D = s0.shape
    B = Np // W
    affine = inference_affine(spec, params_state, bn_state, gb)
    w = in_kernel_order(params_state["dense_0"]["w"], kernel_columns(spec, gb.nodes.shape[1]))
    Wa = w[:, D:2 * D]                                     # w: [H, 2D + F] = [Ws | Wa | Wfold]
    w2 = torch.cat([w[:, :D], Wa], dim=0).contiguous()     # [2H, D]
    fold, b = fold_features(spec, gb), params_state["dense_0"]["b"]
    fT3 = (seq_dot(fold, w[:, 2 * D:]) + b if gb.adj_dtype == torch.bfloat16
           else F.linear(fold, w[:, 2 * D:], b))
    fT3 = fT3.reshape(B, W, -1)
    s03 = s0.reshape(B, W, D)
    loop = dep = None
    if gb.adj_loop is not None:
        li = gb.loop_ids
        loop = dict(adjT=gb.adj_loop, s0=s03[li], fT=fT3[li], w2=w2, affine=affine,
                    nm=gb.loop_nm)
    if gb.adj_dep is not None:
        di = gb.dep_ids
        dep = dict(adjT=gb.adj_dep, s=s03[di], fT=fT3[di], w2=w2, affine=affine)
    return loop, dep, Wa


def residual_agg(gb: GraphBatch, sd, exact: bool = False):
    """K6's rT [Bd, W, D]: the residual arcs' weighted source states summed
    into their destinations, raw (before the dense layer and the dropout).
    Residual arcs couple dep blocks only and use dep-local flat node ids;
    padding arcs add 0 to node 0. With `exact` (the bf16 routes) the sums
    run in float64 and round to f32 once, so the card, whose index_add_ adds
    in no fixed order, takes the CPU's bits: under bf16 rounding a last-bit
    difference can move a value across a rounding boundary."""
    Bd, W, D = sd.shape
    vals = sd.reshape(Bd * W, D)[gb.res_src_loc] * gb.res_w[:, None]
    if exact:
        vals = vals.double()
    return (vals.new_zeros((Bd * W, D)).index_add_(0, gb.res_dst_loc, vals).to(sd.dtype)
            .reshape(Bd, W, D))


def inference_affine(spec: GNNSpec, params_state, bn_state, gb: GraphBatch):
    """The state net's inference BatchNorm affine [2, D] (None without
    BatchNorm); on a bf16-adjacency batch evaluated in float64 and rounded
    once, the same bits on every device (ops/bn.py::_affine's `exact`)."""
    if not spec.state_spec.batch_normalization:
        return None
    return bn_affine(params_state["bn"]["gamma"], params_state["bn"]["beta"], bn_state["mean"],
                     bn_state["var"], gb.adj_dtype == torch.bfloat16)


def residual_term(gb: GraphBatch, sd, Wa):
    """K4's rT [Bd, W, H]: the raw residual aggregation (residual_agg) through
    Wa."""
    return torch.matmul(residual_agg(gb, sd), Wa.t())


def _finish_hybrid(gb: GraphBatch, thr: float, K: int, looped=None, sd=None, step=None):
    """The realised count and the [Np, D] state in global node order.

    The loop blocks ran all K iterations, looped = (traj, margins [K, Bl, W],
    s0_loop), or there are none (None: the all-dep layout); the dep blocks,
    from states sd (None without dep blocks), take their K steps
    `step(it, sd)` under the global early stop: a step runs while any loop
    node moved before it or any dep node moves. The loop blocks' state is
    the snapshot at the realised count (s0_loop when it is 0)."""
    if looped is None:
        loop_any = torch.zeros(K, dtype=torch.bool, device=gb.device)
    else:
        traj, margins, s0_loop = looped
        loop_any = (margins > 0.5).flatten(1).any(dim=1)    # [K]
    if sd is None:
        k = torch.cumprod(loop_any.float(), dim=0).sum()
    else:
        nm_dep = gb.node_mask.reshape(-1, gb.block_w)[gb.dep_ids]
        sd_old = torch.ones_like(sd)
        active = torch.ones((), dtype=torch.bool, device=sd.device)
        k = torch.zeros((), dtype=torch.float32, device=sd.device)
        for it in range(loop_any.shape[0]):
            moving = _moving_mask(sd, sd_old, thr) & nm_dep
            active = active & (loop_any[it] | moving.any())
            new = step(it, sd)
            sd, sd_old = torch.where(active, new, sd), torch.where(active, sd, sd_old)
            k = k + active.float()
    if looped is None:
        return k, sd[gb.block_perm].reshape(gb.n_node_pad, -1)
    idx = (k.long() - 1).clamp_min(0).reshape(1)
    sel = torch.where(k >= 1.0, traj.index_select(0, idx)[0], s0_loop)
    full = sel if sd is None else torch.cat([sel, sd])
    return k, full[gb.block_perm].reshape(gb.n_node_pad, -1)


def _propagate_hybrid(spec, params_state, bn_state, gb, s0=None):
    """K3 over the loop blocks, K4 per step over the dep blocks
    (gnn_tpu core.py:475-608) in node-major blocks [B, W, D]; differentiable
    through K5 and K4's plain backward. On a bf16-adjacency batch their bf16
    variants, differentiated through K5_bf16 and K4's f32 backward on the
    upcast adjacency, the residual term through Wa by seq_dot."""
    K = spec.max_iteration
    thr = float(spec.threshold)
    act = spec.state_spec.activations[0]
    loop, dep, Wa = hybrid_operands(spec, params_state, bn_state, gb, s0)
    bf16 = gb.adj_dtype == torch.bfloat16
    loop_fn, step_fn, res_fn = (
        (fused_propagation_loop_bf16, fused_propagation_step_bf16,
         lambda sd: seq_dot(residual_agg(gb, sd, exact=True), Wa)) if bf16 else
        (fused_propagation_loop, fused_propagation_step, lambda sd: residual_term(gb, sd, Wa)))
    looped = None
    if loop is not None:
        looped = (*loop_fn(**loop, K=K, threshold=thr, activation=act), loop["s0"])
    if dep is None:
        return _finish_hybrid(gb, thr, K, looped)

    def step(_, sd):
        return step_fn(dep["adjT"], sd, res_fn(sd), dep["fT"], dep["w2"], dep["affine"], act)
    return _finish_hybrid(gb, thr, K, looped, dep["s"], step)


def _dense2_weights(params_state, cols=None) -> dict:
    """The two-layer kernels' weights: w0 [H1, 2D + F] = [Ws | Wa | Wfold]
    (the dense input's columns in the kernels' order, kernel_columns), b0,
    w1 [D, H1], b1 (made contiguous)."""
    p0, p1 = params_state["dense_0"], params_state["dense_1"]
    return dict(w0=in_kernel_order(p0["w"], cols).contiguous(), b0=p0["b"],
                w1=p1["w"].contiguous(), b1=p1["b"])


def hybrid2_operands(spec: GNNSpec, params_state, bn_state, gb: GraphBatch,
                     init: Optional[torch.Tensor] = None):
    """The two-layer eval kernels' operands (gnn_tpu core.py:475-608 with
    `two`): (loop, dep). `loop` holds K10's tensor arguments (adjT, s0, feats,
    w0, b0, w1, b1, affine, nm) for the loop blocks, or is None without loop
    blocks; `dep` holds K9's (adjT, s,
    feats, the weights, affine) for the dep blocks at their initial states, or
    is None without dep blocks. feats are the raw feature rows
    (fold_features): the kernels form Wfold @ feats + b0 themselves.

    On a bf16-adjacency batch the operands are the bf16 kernels' (gnn_tpu's
    hp = False operands): fT [B, W, H1] = Wfold @ feats + b0 hoisted in f32,
    w20 [2H1, D] = [Ws; Wa], w1, b1, affine, and `dep` also Wa for the
    H1-wide residual term (residual_term)."""
    W = gb.block_w
    s0 = initial_state(spec, gb, init)
    Np, D = s0.shape
    B = Np // W
    affine = inference_affine(spec, params_state, bn_state, gb)
    wts = _dense2_weights(params_state, kernel_columns(spec, gb.nodes.shape[1]))
    s03 = s0.reshape(B, W, D)
    f3 = fold_features(spec, gb)
    if gb.adj_dtype == torch.bfloat16:
        w0 = wts.pop("w0")
        wts["w20"] = torch.cat([w0[:, :D], w0[:, D:2 * D]], dim=0).contiguous()
        f3 = seq_dot(f3, w0[:, 2 * D:]) + wts.pop("b0")      # the same bits on every device
        key = "fT"
    else:
        key = "feats"
    f3 = f3.reshape(B, W, -1)
    loop = dep = None
    if gb.adj_loop is not None:
        li = gb.loop_ids
        loop = {"adjT": gb.adj_loop, "s0": s03[li], key: f3[li], "affine": affine,
                "nm": gb.loop_nm, **wts}
    if gb.adj_dep is not None:
        di = gb.dep_ids
        dep = {"adjT": gb.adj_dep, "s": s03[di], key: f3[di], "affine": affine, **wts}
    return loop, dep


def _propagate_hybrid2(spec, params_state, bn_state, gb, s0=None):
    """K10 over the loop blocks, K9 per step over the dep blocks with the raw
    residual aggregation (gnn_tpu core.py:475-608 with `two`); differentiable
    through K11 (K10's backward) and K9's plain backward. On a bf16-adjacency
    batch their bf16 variants, the residual term H1 wide through Wa as
    gnn_tpu's."""
    K = spec.max_iteration
    thr = float(spec.threshold)
    acts = dict(zip(("act0", "act1"), spec.state_spec.activations))
    loop, dep = hybrid2_operands(spec, params_state, bn_state, gb, s0)
    bf16 = gb.adj_dtype == torch.bfloat16
    loop_fn = fused_propagation_loop2_bf16 if bf16 else fused_propagation_loop2
    looped = None
    if loop is not None:
        looped = (*loop_fn(**loop, K=K, threshold=thr, **acts), loop["s0"])
    if dep is None:
        return _finish_hybrid(gb, thr, K, looped)

    if bf16:
        Wa = dep["w20"][dep["w20"].shape[0] // 2:]                # [H1, D]

        def step(_, sd):
            return fused_propagation_step2_bf16(dep["adjT"], sd,
                                                seq_dot(residual_agg(gb, sd, exact=True), Wa),
                                                dep["fT"], dep["w20"], dep["w1"], dep["b1"],
                                                dep["affine"], **acts)
    else:
        def step(_, sd):
            return fused_propagation_step2(dep["adjT"], sd, residual_agg(gb, sd), dep["feats"],
                                           dep["w0"], dep["b0"], dep["w1"], dep["b1"],
                                           dep["affine"], **acts)
    return _finish_hybrid(gb, thr, K, looped, dep["s"], step)


def dropout_operands(spec: GNNSpec, params_state, gb: GraphBatch,
                     keep_state: Optional[torch.Tensor], init: Optional[torch.Tensor] = None):
    """The dropout kernels' operands (gnn_tpu core.py:727-798): (loop, dep, kw).

    `loop` holds K7's tensor arguments (adjT, s0, ms, ma, fT, w_cat, nm) for
    the loop blocks, or is None without loop blocks; `dep` holds K6's (adjT, s0, ms, ma, fT, w_cat) for the dep
    blocks, with the masks and fT of every iteration ([K, Bd, ...]), or is
    None without dep blocks; `kw` is (activation, alpha_drop, rate).

    The dense input [s | agg | fold] (kernel_columns' order) takes the
    step's keep-mask: the fold slice is dropped here and folded into
    fT = Wfold @ drop(fold) + b for every iteration; the state and
    aggregated slices' masks go to the kernels as uint8 blocks ms, ma
    [K, B, W, D] (None without dropout). On a bf16-adjacency batch fT is
    formed by seq_dot (the same bits on every device), as hybrid_operands
    does.

    :param keep_state: bool [K, Np, in_dim] input keep-masks in global node
        order and the reference's column order (None without input dropout).
    :param init: the initial state at state_dim > 0."""
    W = gb.block_w
    s0 = initial_state(spec, gb, init)
    Np, D = s0.shape
    B = Np // W
    K = spec.max_iteration
    ss = spec.state_spec
    cols = kernel_columns(spec, gb.nodes.shape[1])
    rate = float(dict(zip(ss.dropout_pos, ss.dropout_rate)).get(0, 0.0))
    kw = dict(activation=ss.activations[0], alpha_drop=bool(ss.alphadropout), rate=rate)
    w, b = in_kernel_order(params_state["dense_0"]["w"], cols), params_state["dense_0"]["b"]
    fold = fold_features(spec, gb)
    ms = ma = None
    if rate > 0.0:
        if keep_state is None:
            raise ValueError("a keep-mask for dropout position 0 is required in training")
        keep_state = in_kernel_order(keep_state, cols)
        keep = keep_state.reshape(K, B, W, -1)
        ms, ma = keep[..., :D].to(torch.uint8), keep[..., D:2 * D].to(torch.uint8)
        fold = _make_drop(kw["alpha_drop"], rate)[0](fold, keep_state[..., 2 * D:])
    fT = (seq_dot(fold, w[:, 2 * D:]) + b if gb.adj_dtype == torch.bfloat16
          else F.linear(fold, w[:, 2 * D:], b))
    if rate <= 0.0:
        fT = fT.expand(K, Np, -1)
    fT = fT.reshape(K, B, W, -1)
    s03 = s0.reshape(B, W, D)
    w_cat = w[:, :2 * D].contiguous()                     # [H, 2D] = [Ws | Wa]

    def rows(ids):
        return [None if x is None else x.index_select(1, ids).contiguous() for x in (ms, ma, fT)]

    loop = dep = None
    if gb.adj_loop is not None:
        li = gb.loop_ids
        loop = dict(zip(("ms", "ma", "fT"), rows(li)), adjT=gb.adj_loop, s0=s03[li],
                    w_cat=w_cat, nm=gb.loop_nm)
    if gb.adj_dep is not None:
        di = gb.dep_ids
        dep = dict(zip(("ms", "ma", "fT"), rows(di)), adjT=gb.adj_dep, s0=s03[di], w_cat=w_cat)
    return loop, dep, kw


def _propagate_dropout(spec, params_state, gb, keep_state: Optional[torch.Tensor], s0=None):
    """Dropout training without BatchNorm (gnn_tpu core.py:727-874): K7 over
    the loop blocks (K8 its backward), K6 per step over the dep blocks, which
    get their state slice dropped here and the raw residual aggregation;
    without loop blocks K6 per step over every block (gnn_tpu's per-step
    training path, core.py:880-927). On a bf16-adjacency batch the bf16
    variants of K7, K8 and K6, the residual sums exact."""
    K = spec.max_iteration
    thr = float(spec.threshold)
    loop, dep, kw = dropout_operands(spec, params_state, gb, keep_state, s0)
    bf16 = gb.adj_dtype == torch.bfloat16
    loop_fn, step_fn = ((fused_train_loop_bf16, fused_train_step_bf16) if bf16
                        else (fused_train_loop, fused_train_step))
    looped = None
    if loop is not None:
        looped = (*loop_fn(**loop, K=K, threshold=thr, **kw), loop["s0"])
    if dep is None:
        return _finish_hybrid(gb, thr, K, looped)
    drop, _ = _make_drop(kw["alpha_drop"], kw["rate"])

    def step(it, sd):
        ms, ma = (None, None) if dep["ms"] is None else (dep["ms"][it], dep["ma"][it])
        sdd = sd if ms is None else drop(sd, ms)
        return step_fn(dep["adjT"], sd, sdd, ma, residual_agg(gb, sd, exact=bf16), dep["fT"][it],
                       dep["w_cat"], **kw)
    return _finish_hybrid(gb, thr, K, looped, dep["s0"], step)


def dropout2_operands(spec: GNNSpec, params_state, gb: GraphBatch,
                      keep_state: Optional[torch.Tensor], init: Optional[torch.Tensor] = None):
    """The two-layer dropout kernels' operands (gnn_tpu core.py:727-798 with
    `two`): (loop, dep, kw).

    `loop` holds K12's tensor arguments (adjT, s0, ms, ma, fd, w0, b0, w1, b1,
    nm) for the loop blocks; `dep` holds the dep blocks' (adjT, s0, ms, ma, fd
    and the weights), with the masks and fd of every iteration ([K, Bd, ...]),
    or is None without dep blocks; `kw` is (act0, act1, alpha_drop, rate).

    The fold slice of the dense input is dropped here: fd [K, B, W, F] is the
    raw feature rows (fold_features) after each iteration's dropout, which
    the kernel takes through Wfold itself; the state and aggregated slices'
    masks go to the kernel as uint8 blocks ms, ma [K, B, W, D] (None without
    dropout).

    :param keep_state: bool [K, Np, in_dim] input keep-masks in global node
        order and the reference's column order (None without input dropout).
    :param init: the initial state at state_dim > 0."""
    W = gb.block_w
    s0 = initial_state(spec, gb, init)
    Np, D = s0.shape
    B = Np // W
    K = spec.max_iteration
    ss = spec.state_spec
    cols = kernel_columns(spec, gb.nodes.shape[1])
    rate = float(dict(zip(ss.dropout_pos, ss.dropout_rate)).get(0, 0.0))
    kw = dict(act0=ss.activations[0], act1=ss.activations[1], alpha_drop=bool(ss.alphadropout),
              rate=rate)
    feats = fold_features(spec, gb)
    ms = ma = None
    if rate > 0.0:
        if keep_state is None:
            raise ValueError("a keep-mask for dropout position 0 is required in training")
        keep_state = in_kernel_order(keep_state, cols)
        keep = keep_state.reshape(K, B, W, -1)
        ms, ma = keep[..., :D].to(torch.uint8), keep[..., D:2 * D].to(torch.uint8)
        fd = _make_drop(kw["alpha_drop"], rate)[0](feats, keep_state[..., 2 * D:])
    else:
        fd = feats.expand(K, Np, -1)
    fd = fd.reshape(K, B, W, -1)
    s03 = s0.reshape(B, W, D)
    wts = _dense2_weights(params_state, cols)

    def rows(ids):
        return [None if x is None else x.index_select(1, ids).contiguous() for x in (ms, ma, fd)]

    li = gb.loop_ids
    loop = dict(zip(("ms", "ma", "fd"), rows(li)), adjT=gb.adj_loop, s0=s03[li], nm=gb.loop_nm,
                **wts)
    dep = None
    if gb.adj_dep is not None:
        di = gb.dep_ids
        dep = dict(zip(("ms", "ma", "fd"), rows(di)), adjT=gb.adj_dep, s0=s03[di], **wts)
    return loop, dep, kw


def _propagate_dropout2(spec, params_state, gb, keep_state: Optional[torch.Tensor], s0=None):
    """Two-layer dropout training without BatchNorm (gnn_tpu core.py:727-874
    with `two`): K12 over the loop blocks (K13 its backward); the dep blocks
    take a plain step, as gnn_tpu's (core.py:815-845), which has no per-step
    two-layer training kernel: the state and aggregated slices masked, fd
    pre-dropped, dense0, act0, dense1, act1. On a bf16-adjacency batch K12's
    and K13's bf16 variants, and the dep step in f32 on the upcast adjacency
    (gnn_tpu's, `hp_dep` false), the residual sums exact."""
    K = spec.max_iteration
    thr = float(spec.threshold)
    loop, dep, kw = dropout2_operands(spec, params_state, gb, keep_state, s0)
    bf16 = gb.adj_dtype == torch.bfloat16
    loop_fn = fused_train_loop2_bf16 if bf16 else fused_train_loop2
    looped = (*loop_fn(**loop, K=K, threshold=thr, **kw), loop["s0"])
    if dep is None:
        return _finish_hybrid(gb, thr, K, looped)
    drop, _ = _make_drop(kw["alpha_drop"], kw["rate"])
    adjT = dep["adjT"].float() if bf16 else dep["adjT"]

    def step(it, sd):
        agg = torch.matmul(adjT.transpose(1, 2), sd) + residual_agg(gb, sd, exact=bf16)
        if dep["ms"] is not None:
            sd, agg = drop(sd, dep["ms"][it]), drop(agg, dep["ma"][it])
        return dense2(torch.cat([sd, agg, dep["fd"][it]], dim=-1), dep["w0"], dep["b0"],
                      dep["w1"], dep["b1"], kw["act0"], kw["act1"])
    return _finish_hybrid(gb, thr, K, looped, dep["s0"], step)


def _entity_mask(gb: GraphBatch) -> torch.Tensor:
    """set_mask and output_mask at entity level (GNN.py:275), padding excluded."""
    real = gb.edge_mask if gb.focus == "a" else gb.node_mask
    return gb.set_mask & gb.output_mask & real


def gnn_forward(spec: GNNSpec, params, bn, gb: GraphBatch, training: bool = False,
                masks: Optional[dict] = None):
    """Full forward. Returns a dict with
      iters:      realised propagation steps (0-d float tensor)
      state:      [Np, D] node states
      out_entity: per-entity outputs, [Np, DT] ('n'/'g') or [Ep, DT] ('a')
      out:        target-aligned rows [Tp, DT] (pooled per graph for 'g')
      bn:         the BatchNorm statistics after the forward

    :param training: dropout from `masks` (draw_masks; needed when a net has
        dropout) and batch-statistic BatchNorm.
    :param masks: with state_dim > 0 also at eval, for its "init" (draw_init).
    """
    check_dims(spec, gb.nodes.shape[1], gb.arc_labels.shape[1], gb.targets.shape[1])
    full_fp32(gb)
    masks = masks or {}
    iters, state, bn_s = propagate(spec, params["state"], bn["state"], gb, training,
                                   masks.get("state"), masks.get("init"))
    return readout(spec, params, bn, gb, iters, state, bn_s, training, masks.get("output"))


def full_fp32(gb: GraphBatch) -> None:
    """On the card, the plain products (feature term, readout) in full fp32."""
    if gb.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def readout(spec, params, bn, gb: GraphBatch, iters, state, bn_state, training: bool,
            keep_output: Optional[dict]):
    """The output net on the states by focus (arc rows [state_src |
    state_dst | arc labels] for 'a', node rows otherwise, averaged per graph
    for 'g'; with state_dim > 0 a node's row is [state | labels], gnn_tpu
    core.py:1021-1031): gnn_forward's result dict, bn_state the state nets'
    statistics."""
    out_kw = dict(training=training, keep=keep_output, stat_mask=_entity_mask(gb))
    comp = state if spec.state_dim == 0 else torch.cat([state, gb.nodes], dim=1)
    if gb.focus == "a":
        arc_inp = torch.cat([comp[gb.src], comp[gb.dst], gb.arc_labels], dim=1)
        out_entity, bn_o = mlp_apply(spec.output_spec, params["output"], bn["output"], arc_inp,
                                     **out_kw)
        out = out_entity[gb.out_index]
    else:
        out_entity, bn_o = mlp_apply(spec.output_spec, params["output"], bn["output"], comp,
                                     **out_kw)
        if gb.focus == "g":
            # average readout over each graph's real nodes; its gradient is the
            # gather by graph id of gnn_tpu's _pool_csum
            out = pool_graphs(out_entity, gb.graph_ids,
                              gb.pool_w * gb.node_mask.to(out_entity.dtype),
                              gb.n_target_pad)
        else:
            out = out_entity[gb.out_index]
    return {"iters": iters, "state": state, "out_entity": out_entity, "out": out,
            "bn": {"state": bn_state, "output": bn_o}}


# ----------------------------------------------------------------------- loss
def weighted_loss(loss_fn, loss_args: dict, gb: GraphBatch, out_rows: torch.Tensor):
    """Sum over the selected rows of loss(target, out) * sample weight
    (GNN.py:196-199)."""
    per_row = loss_fn(gb.targets, out_rows, **loss_args)
    return torch.sum(per_row * gb.sample_weights * gb.sel_mask.to(per_row.dtype))


def regularization(spec: GNNSpec, params) -> torch.Tensor:
    return (mlp_regularization(spec.state_spec, params["state"])
            + mlp_regularization(spec.output_spec, params["output"]))


def evaluate_single(spec: GNNSpec, params, bn, gb: GraphBatch, loss_name,
                    loss_args: dict, training: bool = False, masks: Optional[dict] = None):
    """(iters, loss, forward result) for one graph batch (reference
    evaluate_single_graph, GNN.py:180-199)."""
    res = gnn_forward(spec, params, bn, gb, training, masks)
    return res["iters"], weighted_loss(get_loss(loss_name), loss_args, gb, res["out"]), res


# ---------------------------------------------------------------- train step
def param_leaves(tree):
    """The tensors of a nested parameter tree of dicts and per-type tuples
    (composite models), in key order."""
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list, tuple)):
            yield from param_leaves(v)
        else:
            yield v


def train_step(spec: GNNSpec, params, bn, optimizer: torch.optim.Optimizer, gb: GraphBatch,
               masks: dict, *, loss_name, loss_args: Optional[dict] = None,
               mean: bool = True) -> dict:
    """One optimizer step on one batch (gnn_tpu's _train_step_body): the loss
    plus the regularization terms is differentiated, the state net's grads
    are divided by the realised iteration count when `mean`
    (GNN_BaseClass.py:239-241), and `optimizer`, which holds the leaves of
    `params`, updates them in place. Their .grad keep this step's grads.

    Returns {"iters", "loss", "bn"}: device tensors, so nothing waits on
    the device."""
    optimizer.zero_grad(set_to_none=True)
    iters, loss, res = evaluate_single(spec, params, bn, gb, loss_name, loss_args or {},
                                       training=True, masks=masks)
    return finish_step(params, optimizer, iters, loss + regularization(spec, params), loss,
                       res["bn"], mean)


def finish_step(params, optimizer, iters, total, loss, new_bn, mean: bool) -> dict:
    """Backward of `total`, the state nets' grads divided by the realised
    count when `mean`, the optimizer step; train_step's result."""
    total.backward()
    if mean:
        divide_state_grads(params["state"], iters)
    optimizer.step()
    return {"iters": iters, "loss": loss.detach(), "bn": detach_tree(new_bn)}


def divide_state_grads(params_state, iters) -> None:
    """The state net's grads divided in place by the realised count
    (at least 1), GNN_BaseClass.py:239-241."""
    denom = torch.clamp_min(iters, 1.0)
    for p in param_leaves(params_state):
        if p.grad is not None:
            p.grad.div_(denom)


def detach_tree(tree):
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(detach_tree(v) for v in tree)
    return tree.detach()
