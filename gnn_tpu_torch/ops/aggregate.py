"""Neighbourhood aggregation and graph pooling (counterpart of
gnn_tpu/ops/aggregate.py).

The reference's sparse products A^T @ state, ArcNode^T @ arc_labels and the
NodeGraph pooling are all weighted segment sums:

    agg[n] = sum over arcs e with dst_e == n of w_e * values[e]

written here as `index_add_`. On the card `index_add_` adds with atomics,
so the last bits of a sum can differ from run to run.
"""

from __future__ import annotations

import torch


def aggregate_to_nodes(values: torch.Tensor, weights: torch.Tensor,
                       dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """agg[n] = sum_{e: dst_e = n} w_e * values[e]; values [E, D], weights
    [E] (0 on padded arcs), dst [E] int64."""
    out = values.new_zeros((num_nodes, values.shape[1]))
    return out.index_add_(0, dst, values * weights[:, None])


def pool_graphs(node_values: torch.Tensor, graph_ids: torch.Tensor,
                pool_w: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """Graph readout: out[g] = sum_{n in g} pool_w_n * node_values[n] (the
    reference's NodeGraph^T @ out, NodeGraph holding 1/n_g per node)."""
    return aggregate_to_nodes(node_values, pool_w, graph_ids, num_graphs)
