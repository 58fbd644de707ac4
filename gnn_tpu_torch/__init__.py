"""gnn_tpu_torch: the GNN of gnn_tpu in PyTorch, served and trained on an
NVIDIA H100.

The fixed-point propagation runs in hand-written CUDA kernels for Hopper
(ops/csrc/*.cu), built with nvcc on first use: one- and two-layer state nets
at inference and in training, and composite models' per-type state nets
(ops/csrc/bn_typed.cu). The rest is plain PyTorch. Entry points run on the
card unless the caller passes device='cpu'. Module layout mirrors gnn_tpu's.
"""

from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.models.gnn import (CompositeGNNedgeBased, CompositeGNNgraphBased,
                                      CompositeGNNnodeBased, GNNedgeBased, GNNgraphBased,
                                      GNNnodeBased)
from gnn_tpu_torch.ops.mlp import MLPSpec, get_inout_dims
from gnn_tpu_torch.serving import PendingPrediction, Predictor

__all__ = ["Graph", "GNNnodeBased", "GNNedgeBased", "GNNgraphBased", "CompositeGNNnodeBased",
           "CompositeGNNedgeBased", "CompositeGNNgraphBased", "MLPSpec", "get_inout_dims",
           "Predictor", "PendingPrediction"]
