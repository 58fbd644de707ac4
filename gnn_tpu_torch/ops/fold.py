"""The separate state of state_dim > 0 on the kernels' routes (gnn_tpu
core.py:490-513, :667-690; pallas_bn.py:975-1010).

With state_dim > 0 the state net's input is, in the reference's column
order, [state | labels | Σstate | Σlabels | Σarcs] (GNN.py:259-267). The
labels and the two aggregations are loop-invariant, so the kernels, which
take [state | Σstate | features] with state width D and feature width F,
take them as features: D = state_dim, the feature rows [labels | Σlabels |
Σarcs] (F = 2 * NL + AL) and the dense layer's columns permuted to
[Ws | Wa | Wfold], gnn_tpu's w1T_k. At state_dim 0 the state is the labels,
the features are Σarcs and the orders agree.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_tpu_torch.graphs.batch import GraphBatch


def initial_state(spec, gb: GraphBatch, init: Optional[torch.Tensor]) -> torch.Tensor:
    """The propagation's initial state [Np, D]: the node labels at
    state_dim 0, else `init` (draw_init's draw, or gnn_tpu's in tests)."""
    if spec.state_dim == 0:
        return gb.nodes
    if init is None:
        raise ValueError("state_dim > 0 needs its initial state: pass masks['init'] "
                         "(core.draw_masks or core.draw_init)")
    if tuple(init.shape) != (gb.n_node_pad, spec.state_dim):
        raise ValueError(f"initial state of shape {tuple(init.shape)}, expected "
                         f"{(gb.n_node_pad, spec.state_dim)}")
    return init


def state_width(spec, gb: GraphBatch) -> int:
    """The state's width D: state_dim, or the node-label width at 0."""
    return spec.state_dim or gb.nodes.shape[1]


def kernel_columns(spec, nl: int) -> Optional[torch.Tensor]:
    """The dense input's columns in the kernels' order [state | Σstate |
    labels | Σlabels | Σarcs] (gnn_tpu's w1T_k, core.py:667-690) from the
    reference order [state | labels | Σstate | Σlabels | Σarcs] at
    state_dim > 0; None at state_dim 0, where the orders agree."""
    sd = spec.state_dim
    if sd == 0:
        return None
    cols = (list(range(sd)) + list(range(sd + nl, 2 * sd + nl)) + list(range(sd, sd + nl))
            + list(range(2 * sd + nl, spec.state_spec.input_dim)))
    return torch.tensor(cols, dtype=torch.int64)


def in_kernel_order(x, cols: Optional[torch.Tensor], dim: int = -1):
    """x with its dense-input axis `dim` in the kernels' column order."""
    return x if cols is None else x.index_select(dim, cols.to(x.device))


def fold_features(spec, gb: GraphBatch) -> torch.Tensor:
    """The rows the kernels' feature term takes [Np, F]: the arc-label
    aggregation at state_dim 0, else [labels | Σlabels | Σarcs]."""
    if spec.state_dim == 0:
        return gb.agg_arcs()
    return torch.cat([gb.nodes, gb.agg_nodes(), gb.agg_arcs()], dim=1)
