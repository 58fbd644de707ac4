"""gnn_tpu_torch: the GNN of gnn_tpu in PyTorch, served and trained on an
NVIDIA H100.

The fixed-point propagation runs in hand-written CUDA kernels for Hopper
(ops/csrc/*.cu), built with nvcc on first use: one- and two-layer state nets
at inference and in training, and composite models' per-type state nets
(ops/csrc/bn_typed.cu). The rest is plain PyTorch, numpy and scipy: the
training engine (models/engine.py), metrics, checkpoints, event files and
dataset utilities need no scikit-learn, pandas or matplotlib (matplotlib
only to draw ROC / precision-recall figures). Entry points run on the card
unless the caller passes device='cpu'. Module layout mirrors gnn_tpu's:
models/lgnn.py stacks the models into gnn_tpu's LGNN, and models/ift.py
gives grad_mode='ift' its implicit adjoint.
"""

from gnn_tpu_torch import metrics
from gnn_tpu_torch.config import floatx
from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.graphs.generator import GraphDataGenerator, SingleGraphDataGenerator
from gnn_tpu_torch.graphs.graph import Graph, GraphObject
from gnn_tpu_torch.models.gnn import (CompositeGNNedgeBased, CompositeGNNgraphBased,
                                      CompositeGNNnodeBased, GNNedgeBased, GNNgraphBased,
                                      GNNnodeBased)
from gnn_tpu_torch.models.lgnn import LGNN
from gnn_tpu_torch.ops.mlp import MLPSpec, get_inout_dims
from gnn_tpu_torch.serving import PendingPrediction, Predictor

__all__ = ["Graph", "GraphObject", "GraphBatch", "GraphDataGenerator",
           "SingleGraphDataGenerator", "GNNnodeBased", "GNNedgeBased", "GNNgraphBased",
           "CompositeGNNnodeBased", "CompositeGNNedgeBased", "CompositeGNNgraphBased", "LGNN",
           "MLPSpec",
           "get_inout_dims", "floatx", "metrics", "Predictor", "PendingPrediction"]
