"""User-facing GNN models for inference: node / edge / graph focused
(counterpart of gnn_tpu/models/gnn.py, eval only).

A model holds its spec, its parameters and its BatchNorm statistics on one
device. `load` reads gnn_tpu's save folder (config.json, params.npz, bn.npz),
so a model trained with gnn_tpu serves here unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from gnn_tpu_torch.config import resolve_device
from gnn_tpu_torch.convert import load_npz, params_from_jax
from gnn_tpu_torch.graphs.batch import GraphBatch, from_graphs_blocked
from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.models.core import GNNSpec, gnn_forward, gnn_init
from gnn_tpu_torch.ops.mlp import MLPSpec


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape)) for k, v in tree.items()}


class GNNnodeBased:
    """GNN for node-focused problems (reference GNN.py:18-280).

    :param net_state / net_output: MLPSpec (or its config dict) of the state
        and output nets.
    :param state_vect_dim: reference state_vect_dim; only 0 is ported.
    :param max_iteration / threshold: the convergence loop's bounds.
    :param aggregation: gnn_tpu's aggregation name ('auto' uses the kernels).
    :param seed: seed of the torch.Generator drawing the initial weights.
    :param device: None means the card ('cuda'); pass 'cpu' for the CPU.
    """

    _focus = "n"

    def __init__(self, net_state: Union[MLPSpec, dict], net_output: Union[MLPSpec, dict],
                 *, state_vect_dim: int = 0, max_iteration: int = 5,
                 threshold: float = 0.01, aggregation: str = "auto",
                 seed: Optional[int] = None, device=None) -> None:
        self.device = resolve_device(device)
        if isinstance(net_state, dict):
            net_state = MLPSpec.from_config(net_state)
        if isinstance(net_output, dict):
            net_output = MLPSpec.from_config(net_output)
        self.spec = GNNSpec(focus=self._focus, state_spec=net_state, output_spec=net_output,
                            state_dim=int(state_vect_dim), max_iteration=int(max_iteration),
                            threshold=float(threshold), aggregation=aggregation)
        gen = torch.Generator()
        gen.manual_seed(int(np.random.randint(2 ** 31)) if seed is None else int(seed))
        self.params, self.bn = gnn_init(self.spec, gen, self.device)

    def set_weights(self, params_np: dict, bn_np: dict) -> None:
        """Install gnn_tpu (params, bn) pytrees given as nested numpy dicts."""
        params, bn = params_from_jax(params_np, bn_np, self.device)
        if _shapes(params) != _shapes(self.params) or _shapes(bn) != _shapes(self.bn):
            raise ValueError(f"weights {_shapes(params)}, {_shapes(bn)} do not fit the "
                             f"model's {_shapes(self.params)}, {_shapes(self.bn)}")
        self.params, self.bn = params, bn

    @classmethod
    def load(cls, path: str, device=None):
        """Load a gnn_tpu save folder: config.json + params.npz + bn.npz."""
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        klass = {"GNNnodeBased": GNNnodeBased, "GNNedgeBased": GNNedgeBased,
                 "GNNgraphBased": GNNgraphBased}.get(config.get("model_class"), cls)
        if config.get("state_dtype") not in (None, "float32"):
            raise NotImplementedError(f"state_dtype={config['state_dtype']!r} is not ported")
        model = klass(net_state=config["net_state"], net_output=config["net_output"],
                      state_vect_dim=config.get("state_vect_dim", 0),
                      max_iteration=config["max_iteration"], threshold=config["threshold"],
                      aggregation=config.get("aggregation", "auto"), seed=0, device=device)
        model.set_weights(load_npz(os.path.join(path, "params.npz")),
                          load_npz(os.path.join(path, "bn.npz")))
        return model

    def to_batch(self, graphs: Union[Graph, Sequence[Graph]], block_w: int = 128) -> GraphBatch:
        """Pack graphs into one fused-layout batch on the model's device."""
        glist = [graphs] if isinstance(graphs, Graph) else list(graphs)
        if any(g.focus != self._focus for g in glist):
            raise ValueError(f"graph focus does not match model focus {self._focus!r}")
        return from_graphs_blocked(glist, block_w=block_w, focus=self._focus,
                                   fused_layout=True).to(self.device)

    def forward(self, gb: GraphBatch) -> dict:
        """gnn_forward on a batch already on the model's device."""
        with torch.no_grad():
            return gnn_forward(self.spec, self.params, self.bn, gb)

    def Loop(self, g: Union[Graph, GraphBatch]):
        """(iters, state, out) for one graph or batch; `out` holds the
        selected target rows (host numpy), as gnn_tpu's Loop."""
        gb = g if isinstance(g, GraphBatch) else self.to_batch(g)
        res = self.forward(gb)
        sel = gb.sel_mask.cpu().numpy()
        return (float(res["iters"]), res["state"].cpu().numpy(),
                res["out"].cpu().numpy()[sel])

    def __call__(self, g: Union[Graph, GraphBatch]):
        return self.Loop(g)[-1]


class GNNedgeBased(GNNnodeBased):
    """GNN for edge-focused problems: readout on [state_src, state_dst, arc label]."""

    _focus = "a"


class GNNgraphBased(GNNnodeBased):
    """GNN for graph-focused problems: node outputs averaged per graph."""

    _focus = "g"
