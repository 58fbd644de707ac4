"""starter: config-as-python example assembling GNN and LGNN models
(counterpart of gnn_tpu's starter.py).

Edit the constants block, then run it or use its objects `gnn`, `lgnn`,
`gTr`, `gVa`, `gTe` and `graphs`:

    python -m gnn_tpu_torch.starter

    from gnn_tpu_torch.starter import gnn, gTr, gVa, gTe
    gnn.train(gTr, epochs=200, gVa=gVa, update_freq=10, max_fails=10)
    gnn.test(gTe, rocdir='roc/')

The models run on the card; set GNN_TPU_TORCH_CPU=1 to run them on the CPU.
The objects are built at their first use (importing the module builds
nothing), from the constants as they stand then.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np

from gnn_tpu_torch import (LGNN, GNNedgeBased, GNNgraphBased, GNNnodeBased, Graph, MLPSpec,
                           get_inout_dims)
from gnn_tpu_torch import metrics as mt
from gnn_tpu_torch.graphs import utils
from gnn_tpu_torch.graphs.datasets import load_mutag, random_graph

#######################################################################################
# SCRIPT OPTIONS - modify the parameters to adapt the execution to the problem ########
#######################################################################################

# MUTAG option - if True, gnn/lgnn is trained on the real-world MUTAG dataset
# (problem set automatically to graph classification).
use_MUTAG: bool = True
MUTAG_path: str = os.environ.get("MUTAG_PATH", "MUTAG_raw/")

# GENERIC GRAPH PARAMETERS (random dataset; see datasets.random_graph)
focus: str = "n"                 # 'n' node | 'a' arc | 'g' graph focused
addressed_problem: str = "c"     # 'c' classification | 'r' regression
graphs_number: int = 100
min_nodes_number: int = 15
max_nodes_number: int = 40
dim_node_label: int = 3
dim_arc_label: int = 1
dim_target: int = 2
density: float = 0.7
aggregation_mode: str = "average"   # 'average' | 'normalized' | 'sum'

# LEARNING SETS PARAMETERS
perc_Train: float = 0.7
perc_Valid: float = 0.2
batch_size: int = 32
normalize: bool = True
seed: Optional[int] = None
norm_nodes_range: Optional[tuple] = None    # e.g. (-1, 1)
norm_arcs_range: Optional[tuple] = None     # e.g. (0, 1)

# NET STATE PARAMETERS
activations_net_state: str = "selu"
kernel_init_net_state: str = "lecun_normal"
bias_init_net_state: str = "lecun_normal"
dropout_rate_st: float = 0.1
dropout_pos_st: Union[list, int] = 0
hidden_units_net_state: Optional[Union[list, int]] = None
batch_norm_net_state: bool = True

# NET OUTPUT PARAMETERS
activations_net_output: str = "softmax"
kernel_init_net_output: str = "glorot_normal"
bias_init_net_output: str = "glorot_normal"
dropout_rate_out: float = 0.1
dropout_pos_out: Union[list, int] = 0
hidden_units_net_output: Optional[Union[list, int]] = None
# NOTE: the reference defaults to BatchNormalization after the softmax layer
# (MLP.py:13,63) which breaks probability semantics (rows stop summing to 1 —
# degenerate for 2-class CE). Default off here; set True for strict parity.
batch_norm_net_output: bool = False

# GNN PARAMETERS
dim_state: int = 0
max_iter: int = 5
state_threshold: float = 0.01

# LGNN PARAMETERS
layers: int = 5
get_state: bool = False
get_output: bool = True

# TRAINING PARAMETERS
path_writer: str = "writer/"
optimizer: dict = {"name": "adam", "kwargs": {"learning_rate": 0.001}}
lossF: str = "categorical_crossentropy"
lossArguments: Optional[dict] = {"from_logits": False}
extra_metrics: Optional[dict] = {i: mt.Metrics[i] for i in
                                 ["Acc", "Bacc", "Tpr", "Tnr", "Fpr", "Fnr", "Ck",
                                  "Js", "Prec", "Rec", "Fs"]}
metrics_args: Optional[dict] = {i: {"average": "weighted", "zero_division": 0}
                                for i in ["Fs", "Prec", "Rec", "Js"]}

#######################################################################################
# SCRIPT #############################################################################
#######################################################################################

_BUILT = ("graphs", "gTr", "gVa", "gTe", "gnn", "lgnn")
_built: dict = {}


def build() -> dict:
    """The dataset, its splits and the models from the constants above
    (gnn_tpu's starter.py:120-177): {"graphs", "gTr", "gVa", "gTe", "gnn",
    "lgnn"}."""
    device = "cpu" if os.environ.get("GNN_TPU_TORCH_CPU") else None
    problem, fcs = addressed_problem, focus

    ### LOAD DATASET
    if use_MUTAG:
        problem, fcs = "c", "g"
        graphs = load_mutag(MUTAG_path)
    else:
        rng = np.random.default_rng(seed)
        graphs = [random_graph(nodes_number=int(rng.integers(min_nodes_number, max_nodes_number)),
                               dim_node_label=dim_node_label, dim_arc_label=dim_arc_label,
                               dim_target=dim_target, density=density,
                               normalize_features=False, aggregation_mode=aggregation_mode,
                               focus=fcs, rng=rng)
                  for _ in range(graphs_number)]

    ### PREPROCESSING — split / batch / merge
    iTr, iTe, iVa = utils.getindices(len(graphs), perc_Train, perc_Valid, seed=seed)
    gTr = utils.getbatches([graphs[i] for i in iTr], focus=fcs,
                           aggregation_mode=aggregation_mode, batch_size=batch_size)
    gVa = Graph.merge([graphs[i] for i in iVa], focus=fcs, aggregation_mode=aggregation_mode)
    gTe = Graph.merge([graphs[i] for i in iTe], focus=fcs, aggregation_mode=aggregation_mode)
    gGen = gTr[0]
    if normalize:
        utils.normalize_graphs(gTr, gVa, gTe, based_on="gTr",
                               norm_rangeN=norm_nodes_range, norm_rangeA=norm_arcs_range)

    ### MODELS — per-layer MLP shape inference (reference starter.py:135-162)
    nets_St, nets_Out = [], []
    for i in range(layers):
        dims = dict(layer=i, get_state=get_state, get_output=get_output)
        in_s, layers_s = get_inout_dims("state", gGen.DIM_NODE_LABEL, gGen.DIM_ARC_LABEL,
                                        gGen.DIM_TARGET, fcs, dim_state,
                                        hidden_units_net_state, **dims)
        nets_St.append(MLPSpec(
            input_dim=in_s, units=tuple(layers_s), activations=activations_net_state,
            kernel_initializer=kernel_init_net_state, bias_initializer=bias_init_net_state,
            dropout_rate=(dropout_rate_st,), dropout_pos=(dropout_pos_st,),
            alphadropout=(activations_net_state == "selu"),
            batch_normalization=batch_norm_net_state))
        in_o, layers_o = get_inout_dims("output", gGen.DIM_NODE_LABEL, gGen.DIM_ARC_LABEL,
                                        gGen.DIM_TARGET, fcs, dim_state,
                                        hidden_units_net_output, **dims)
        nets_Out.append(MLPSpec(
            input_dim=in_o, units=tuple(layers_o), activations=activations_net_output,
            kernel_initializer=kernel_init_net_output, bias_initializer=bias_init_net_output,
            dropout_rate=(dropout_rate_out,), dropout_pos=(dropout_pos_out,),
            batch_normalization=batch_norm_net_output))

    gnntype = {"n": GNNnodeBased, "a": GNNedgeBased, "g": GNNgraphBased}[fcs]
    gnns = [gnntype(net_state=st, net_output=out, optimizer=dict(optimizer),
                    loss_function=lossF, loss_arguments=lossArguments,
                    state_vect_dim=dim_state, max_iteration=max_iter,
                    threshold=state_threshold, addressed_problem=problem,
                    extra_metrics=extra_metrics, extra_metrics_arguments=metrics_args,
                    path_writer=f"{path_writer}GNN{idx}", device=device)
            for idx, st, out in zip(range(layers), nets_St, nets_Out)]

    # SINGLE GNN
    gnn = gnns[0].copy(path_writer=f"{path_writer}GNN_single", copy_weights=True)
    # LGNN
    lgnn = LGNN(gnns=gnns, get_state=get_state, get_output=get_output,
                optimizer=dict(optimizer), loss_function=lossF,
                loss_arguments=lossArguments, addressed_problem=problem,
                extra_metrics=extra_metrics, extra_metrics_arguments=metrics_args,
                path_writer=f"{path_writer}LGNN", namespace="LGNN")
    return dict(graphs=graphs, gTr=gTr, gVa=gVa, gTe=gTe, gnn=gnn, lgnn=lgnn)


def __getattr__(name):
    """`gnn`, `lgnn`, `gTr`, `gVa`, `gTe` and `graphs`, built at the first
    access."""
    if name not in _BUILT:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if not _built:
        _built.update(build())
    return _built[name]


if __name__ == "__main__":
    objs = build()
    gnn, lgnn = objs["gnn"], objs["lgnn"]
    print(f"dataset: {len(objs['graphs'])} graphs | batches: {len(objs['gTr'])} | "
          f"focus={gnn.spec.focus} problem={gnn.addressed_problem}")
    print(f"gnn: {type(gnn).__name__} | lgnn: {lgnn.LAYERS} layers | device: {gnn.device}")
