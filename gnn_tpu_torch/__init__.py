"""gnn_tpu_torch: the GNN of gnn_tpu in PyTorch, served on an NVIDIA H100.

The fixed-point propagation of a one-layer state net runs in hand-written
CUDA kernels for Hopper (ops/csrc/fused_eval.cu, built with nvcc on first
use); the rest is plain PyTorch. Entry points run on the card unless the
caller passes device='cpu'. Module layout mirrors gnn_tpu's.
"""

from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.models.gnn import GNNedgeBased, GNNgraphBased, GNNnodeBased
from gnn_tpu_torch.ops.mlp import MLPSpec, get_inout_dims
from gnn_tpu_torch.serving import PendingPrediction, Predictor

__all__ = ["Graph", "GNNnodeBased", "GNNedgeBased", "GNNgraphBased", "MLPSpec",
           "get_inout_dims", "Predictor", "PendingPrediction"]
