"""User-facing GNN models: node / edge / graph focused, homogeneous and
composite (counterpart of gnn_tpu/models/gnn.py).

A model holds its spec, its parameters, its BatchNorm statistics, its
optimizer and one torch.Generator for dropout masks, all on one device.
`load` reads gnn_tpu's save folder (config.json, params.npz, bn.npz) and
`save` writes one, so a model trained in either package serves in both. A
composite model (Composite*Based) has one state net per node type: its
config names them `net_states`, and its params and statistics keep them as
a tuple under "state".
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
from gnn_tpu_torch.models import composite
from gnn_tpu_torch.models.core import (GNNSpec, draw_masks, gnn_forward, gnn_init,
                                       param_leaves, train_step)
from gnn_tpu_torch.ops.mlp import MLPSpec
from gnn_tpu_torch.training.optimizers import make_optimizer, optimizer_config


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree.shape)


def _spec(net: Union[MLPSpec, dict]) -> MLPSpec:
    return MLPSpec.from_config(net) if isinstance(net, dict) else net


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
    :param grad_mode / ift_backward_iters: gnn_tpu's gradient mode and its
        implicit adjoint's iterations, kept for save; a model with
        grad_mode='ift' serves but does not train (models/ift.py is not
        ported).
    :param seed: seed of the torch.Generators drawing the initial weights and
        the dropout masks.
    :param device: None means the card ('cuda'); pass 'cpu' for the CPU.
    """

    _focus = "n"
    _forward = staticmethod(gnn_forward)
    _train_step = staticmethod(train_step)
    _draw_masks = staticmethod(draw_masks)

    def __init__(self, net_state: Union[MLPSpec, dict], net_output: Union[MLPSpec, dict],
                 optimizer="adam", loss_function: str = "categorical_crossentropy",
                 loss_arguments: Optional[dict] = None, *, addressed_problem: str = "c",
                 state_vect_dim: int = 0, max_iteration: int = 5, threshold: float = 0.01,
                 aggregation: str = "auto", grad_mode: str = "unroll",
                 ift_backward_iters: int = 20, seed: Optional[int] = None, device=None) -> None:
        spec = GNNSpec(focus=self._focus, state_spec=_spec(net_state),
                       output_spec=_spec(net_output),
                       state_dim=int(state_vect_dim), max_iteration=int(max_iteration),
                       threshold=float(threshold), aggregation=aggregation, grad_mode=grad_mode,
                       ift_backward_iters=int(ift_backward_iters))
        self._setup(spec, gnn_init, optimizer, loss_function, loss_arguments, addressed_problem,
                    seed, device)

    def _setup(self, spec, init, optimizer, loss_function, loss_arguments, addressed_problem,
               seed, device) -> None:
        self.device = resolve_device(device)
        if addressed_problem not in ("c", "r"):
            raise ValueError("param <addressed_problem> not in ['c','r']")
        self.spec = spec
        self.optimizer_config = (optimizer_config(optimizer) if isinstance(optimizer, str)
                                 else optimizer)
        self.loss_function = loss_function
        self.loss_args = dict(loss_arguments or {})
        self.addressed_problem = addressed_problem
        seed = int(np.random.randint(2 ** 31)) if seed is None else int(seed)
        gen = torch.Generator().manual_seed(seed)
        # dropout masks are drawn on the device, never on the host per step
        self.mask_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        params, bn = init(self.spec, gen, self.device)
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
        """Load a gnn_tpu save folder: config.json + params.npz + bn.npz; the
        model class (homogeneous or composite) is the one the config names."""
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        klass = MODEL_CLASSES.get(config.get("model_class"), cls)
        if config.get("state_dtype") not in (None, "float32"):
            raise NotImplementedError(f"state_dtype={config['state_dtype']!r} is not ported")
        common = dict(optimizer=config.get("optimizer", "adam"),
                      loss_function=config.get("loss_function", "categorical_crossentropy"),
                      loss_arguments=config.get("loss_arguments"),
                      addressed_problem=config.get("addressed_problem", "c"),
                      max_iteration=config["max_iteration"], threshold=config["threshold"],
                      aggregation=config.get("aggregation", "auto"),
                      grad_mode=config.get("grad_mode", "unroll"),
                      ift_backward_iters=config.get("ift_backward_iters", 20), seed=0,
                      device=device)
        model = klass(**klass._config_args(config), **common)
        model.set_weights(load_npz(os.path.join(path, "params.npz")),
                          load_npz(os.path.join(path, "bn.npz")))
        return model

    @staticmethod
    def _config_args(config: dict) -> dict:
        return dict(net_state=config["net_state"], net_output=config["net_output"],
                    state_vect_dim=config.get("state_vect_dim", 0))

    def _config(self) -> dict:
        return {"net_state": self.spec.state_spec.to_config(),
                "net_output": self.spec.output_spec.to_config(),
                "state_vect_dim": self.spec.state_dim, "state_dtype": None}

    def save(self, path: str) -> None:
        """Save to a folder in gnn_tpu's format (reference GNN.py:93-111):
        config.json + params.npz + bn.npz, dense weights as [in, out]."""
        os.makedirs(path, exist_ok=True)
        config = {"model_class": type(self).__name__, **self._config(),
                  "optimizer": self.optimizer_config,
                  "loss_function": self.loss_function, "loss_arguments": self.loss_args,
                  "max_iteration": self.spec.max_iteration, "threshold": self.spec.threshold,
                  "addressed_problem": self.addressed_problem,
                  "aggregation": self.spec.aggregation, "grad_mode": self.spec.grad_mode,
                  "ift_backward_iters": self.spec.ift_backward_iters}
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
            return self._forward(self.spec, self.params, self.bn, gb)

    def training_step(self, gb: GraphBatch, mean: bool = True,
                      masks: Optional[dict] = None) -> dict:
        """One optimizer step on a batch on the model's device (gnn_tpu
        GNN.training_step): dropout masks are drawn from the model's generator
        unless `masks` (core.draw_masks's structure) is given. The moving
        BatchNorm statistics are updated. Returns {"iters", "loss"} as device
        tensors; the parameters' .grad hold the step's grads."""
        if masks is None:
            masks = self._draw_masks(self.spec, gb, self.mask_gen)
        res = self._train_step(self.spec, self.params, self.bn, self._opt, gb, masks,
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


class CompositeGNNnodeBased(GNNnodeBased):
    """Composite GNN for node-focused problems: one state net per node type
    (models/composite.py), gnn_tpu's CompositeGNNnodeBased. Its graphs carry
    `node_types`.

    :param net_states: one MLPSpec (or config dict) per node type.
    :param state_dim: only 0 is ported. Other arguments as GNNnodeBased.
    """

    _focus = "n"
    _forward = staticmethod(composite.composite_forward)
    _train_step = staticmethod(composite.composite_train_step)
    _draw_masks = staticmethod(composite.draw_masks)

    def __init__(self, net_states: Sequence[Union[MLPSpec, dict]],
                 net_output: Union[MLPSpec, dict], optimizer="adam",
                 loss_function: str = "categorical_crossentropy",
                 loss_arguments: Optional[dict] = None, *, addressed_problem: str = "c",
                 max_iteration: int = 5, threshold: float = 0.01, aggregation: str = "auto",
                 grad_mode: str = "unroll", ift_backward_iters: int = 20, state_dim: int = 0,
                 seed: Optional[int] = None, device=None) -> None:
        spec = composite.CompositeGNNSpec(
            focus=self._focus, state_specs=tuple(_spec(s) for s in net_states),
            output_spec=_spec(net_output), max_iteration=int(max_iteration),
            threshold=float(threshold), aggregation=aggregation, grad_mode=grad_mode,
            ift_backward_iters=int(ift_backward_iters), state_dim=int(state_dim))
        self._setup(spec, composite.composite_init, optimizer, loss_function, loss_arguments,
                    addressed_problem, seed, device)

    def to_batch(self, graphs: Union[Graph, Sequence[Graph]], block_w: int = 128) -> GraphBatch:
        """Pack graphs carrying node types into one fused-layout batch on the
        model's device."""
        glist = [graphs] if isinstance(graphs, Graph) else list(graphs)
        composite.check_node_types(glist, self.spec.n_types)
        return super().to_batch(glist, block_w)

    @staticmethod
    def _config_args(config: dict) -> dict:
        return dict(net_states=config["net_states"], net_output=config["net_output"],
                    state_dim=config.get("state_dim", 0))

    def _config(self) -> dict:
        return {"net_states": [s.to_config() for s in self.spec.state_specs],
                "net_output": self.spec.output_spec.to_config(),
                "state_dim": self.spec.state_dim}


class CompositeGNNedgeBased(CompositeGNNnodeBased):
    """Composite GNN for edge-focused problems: readout on [state_src,
    state_dst, arc label]."""

    _focus = "a"


class CompositeGNNgraphBased(CompositeGNNnodeBased):
    """Composite GNN for graph-focused problems: node outputs averaged per
    graph."""

    _focus = "g"


MODEL_CLASSES = {c.__name__: c for c in (GNNnodeBased, GNNedgeBased, GNNgraphBased,
                                         CompositeGNNnodeBased, CompositeGNNedgeBased,
                                         CompositeGNNgraphBased)}
