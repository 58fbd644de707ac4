"""User-facing GNN models: node / edge / graph focused (counterpart of
gnn_tpu/models/gnn.py).

A model holds its spec, its parameters, its BatchNorm statistics, its
optimizer and one torch.Generator for dropout masks, all on one device.
`load` reads gnn_tpu's save folder (config.json, params.npz, bn.npz) and
`save` writes one, so a model trained in either package serves in both.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from gnn_tpu_torch.config import resolve_device
from gnn_tpu_torch.convert import flatten, load_npz, params_from_jax, params_to_jax
from gnn_tpu_torch.graphs.batch import GraphBatch, from_graphs_blocked
from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.models.core import (GNNSpec, draw_masks, gnn_forward, gnn_init,
                                       param_leaves, train_step)
from gnn_tpu_torch.ops.mlp import MLPSpec
from gnn_tpu_torch.training.optimizers import make_optimizer, optimizer_config


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape)) for k, v in tree.items()}


class GNNnodeBased:
    """GNN for node-focused problems (reference GNN.py:18-280).

    :param net_state / net_output: MLPSpec (or its config dict) of the state
        and output nets.
    :param optimizer: an optimizer name or config (training/optimizers.py).
    :param loss_function / loss_arguments: a loss name of training/losses.py
        and its keyword arguments.
    :param addressed_problem: 'c' (classification) or 'r' (regression).
    :param state_vect_dim: reference state_vect_dim; only 0 is ported.
    :param max_iteration / threshold: the convergence loop's bounds.
    :param aggregation: gnn_tpu's aggregation name ('auto' uses the kernels).
    :param seed: seed of the torch.Generators drawing the initial weights and
        the dropout masks.
    :param device: None means the card ('cuda'); pass 'cpu' for the CPU.
    """

    _focus = "n"

    def __init__(self, net_state: Union[MLPSpec, dict], net_output: Union[MLPSpec, dict],
                 optimizer="adam", loss_function: str = "categorical_crossentropy",
                 loss_arguments: Optional[dict] = None, *, addressed_problem: str = "c",
                 state_vect_dim: int = 0, max_iteration: int = 5, threshold: float = 0.01,
                 aggregation: str = "auto", seed: Optional[int] = None, device=None) -> None:
        self.device = resolve_device(device)
        if addressed_problem not in ("c", "r"):
            raise ValueError("param <addressed_problem> not in ['c','r']")
        if isinstance(net_state, dict):
            net_state = MLPSpec.from_config(net_state)
        if isinstance(net_output, dict):
            net_output = MLPSpec.from_config(net_output)
        self.spec = GNNSpec(focus=self._focus, state_spec=net_state, output_spec=net_output,
                            state_dim=int(state_vect_dim), max_iteration=int(max_iteration),
                            threshold=float(threshold), aggregation=aggregation)
        self.optimizer_config = (optimizer_config(optimizer) if isinstance(optimizer, str)
                                 else optimizer)
        self.loss_function = loss_function
        self.loss_args = dict(loss_arguments or {})
        self.addressed_problem = addressed_problem
        seed = int(np.random.randint(2 ** 31)) if seed is None else int(seed)
        gen = torch.Generator().manual_seed(seed)
        # dropout masks are drawn on the device, never on the host per step
        self.mask_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        params, bn = gnn_init(self.spec, gen, self.device)
        self._install(params, bn)

    def _install(self, params, bn) -> None:
        for p in param_leaves(params):
            p.requires_grad_(True)
        self.params, self.bn = params, bn
        self._opt = make_optimizer(self.optimizer_config, param_leaves(params))

    def set_weights(self, params_np: dict, bn_np: dict) -> None:
        """Install gnn_tpu (params, bn) pytrees given as nested numpy dicts;
        the optimizer starts afresh."""
        params, bn = params_from_jax(params_np, bn_np, self.device)
        if _shapes(params) != _shapes(self.params) or _shapes(bn) != _shapes(self.bn):
            raise ValueError(f"weights {_shapes(params)}, {_shapes(bn)} do not fit the "
                             f"model's {_shapes(self.params)}, {_shapes(self.bn)}")
        self._install(params, bn)

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
                      optimizer=config.get("optimizer", "adam"),
                      loss_function=config.get("loss_function", "categorical_crossentropy"),
                      loss_arguments=config.get("loss_arguments"),
                      addressed_problem=config.get("addressed_problem", "c"),
                      state_vect_dim=config.get("state_vect_dim", 0),
                      max_iteration=config["max_iteration"], threshold=config["threshold"],
                      aggregation=config.get("aggregation", "auto"), seed=0, device=device)
        model.set_weights(load_npz(os.path.join(path, "params.npz")),
                          load_npz(os.path.join(path, "bn.npz")))
        return model

    def save(self, path: str) -> None:
        """Save to a folder in gnn_tpu's format (reference GNN.py:93-111):
        config.json + params.npz + bn.npz, dense weights as [in, out]."""
        os.makedirs(path, exist_ok=True)
        config = {"model_class": type(self).__name__,
                  "net_state": self.spec.state_spec.to_config(),
                  "net_output": self.spec.output_spec.to_config(),
                  "optimizer": self.optimizer_config,
                  "loss_function": self.loss_function, "loss_arguments": self.loss_args,
                  "max_iteration": self.spec.max_iteration, "threshold": self.spec.threshold,
                  "addressed_problem": self.addressed_problem,
                  "state_vect_dim": self.spec.state_dim, "aggregation": self.spec.aggregation,
                  "grad_mode": "unroll", "ift_backward_iters": 20, "state_dtype": None}
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
        params_np, bn_np = params_to_jax(self.params, self.bn)
        np.savez(os.path.join(path, "params.npz"), **flatten(params_np))
        np.savez(os.path.join(path, "bn.npz"), **flatten(bn_np))

    def to_batch(self, graphs: Union[Graph, Sequence[Graph]], block_w: int = 128) -> GraphBatch:
        """Pack graphs into one fused-layout batch on the model's device."""
        glist = [graphs] if isinstance(graphs, Graph) else list(graphs)
        if any(g.focus != self._focus for g in glist):
            raise ValueError(f"graph focus does not match model focus {self._focus!r}")
        return from_graphs_blocked(glist, block_w=block_w, focus=self._focus,
                                   fused_layout=True).to(self.device)

    def forward(self, gb: GraphBatch) -> dict:
        """Inference gnn_forward on a batch already on the model's device."""
        with torch.no_grad():
            return gnn_forward(self.spec, self.params, self.bn, gb)

    def training_step(self, gb: GraphBatch, mean: bool = True,
                      masks: Optional[dict] = None) -> dict:
        """One optimizer step on a batch on the model's device (gnn_tpu
        GNN.training_step): dropout masks are drawn from the model's generator
        unless `masks` (core.draw_masks's structure) is given. The moving
        BatchNorm statistics are updated. Returns {"iters", "loss"} as device
        tensors; the parameters' .grad hold the step's grads."""
        if masks is None:
            masks = draw_masks(self.spec, gb, self.mask_gen)
        res = train_step(self.spec, self.params, self.bn, self._opt, gb, masks,
                         loss_name=self.loss_function, loss_args=self.loss_args, mean=mean)
        self.bn = res["bn"]
        return {"iters": res["iters"], "loss": res["loss"]}

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
