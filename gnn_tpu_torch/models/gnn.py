"""User-facing GNN models: node / edge / graph focused, homogeneous and
composite (counterpart of gnn_tpu/models/gnn.py).

A model holds its spec, its parameters, its BatchNorm statistics, its
optimizer and one torch.Generator for dropout masks, all on one device; the
engine (models/engine.py::BaseModel) trains, evaluates, tests, checkpoints
and cross-validates it. `load` reads gnn_tpu's save folder (config.json,
params.npz, bn.npz) and `save` writes one, so a model trained in either
package serves in both. `get_weights` / `set_weights` move the weights as
gnn_tpu's do (host numpy in gnn_tpu's layout, the optimizer's state kept);
`set_params` installs gnn_tpu pytrees with a fresh optimizer. A composite
model (Composite*Based) has one state net per node type: its config names
them `net_states`, and its params and statistics keep them as a tuple under
"state".
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
from gnn_tpu_torch.graphs.graph import Graph, split_graphs
from gnn_tpu_torch.models import composite
from gnn_tpu_torch.models.core import (GNNSpec, draw_masks, gnn_forward, gnn_init,
                                       param_leaves, train_step, weighted_loss, with_init)
from gnn_tpu_torch.models.engine import BaseModel
from gnn_tpu_torch.ops.mlp import MLPSpec
from gnn_tpu_torch.training.losses import get_loss
from gnn_tpu_torch.training.optimizers import make_optimizer


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree.shape)


def _spec(net: Union[MLPSpec, dict]) -> MLPSpec:
    return MLPSpec.from_config(net) if isinstance(net, dict) else net


def _keystr_leaves(tree, prefix: str = ""):
    """[(jax.tree_util.keystr name, array)] of a nested dict / tuple tree in
    jax's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _keystr_leaves(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _keystr_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


class GNNnodeBased(BaseModel):
    """GNN for node-focused problems (reference GNN.py:18-280).

    :param net_state / net_output: MLPSpec (or its config dict) of the state
        and output nets.
    :param optimizer: an optimizer name or config (training/optimizers.py).
    :param loss_function / loss_arguments: a loss name of training/losses.py
        and its keyword arguments.
    :param addressed_problem: 'c' (classification) or 'r' (regression).
    :param extra_metrics / extra_metrics_arguments: {name: metric function}
        (e.g. metrics.Metrics' entries) the engine reports, and {name:
        keyword arguments}.
    :param path_writer / namespace: the folder of the engine's JSONL and
        TensorBoard logs (cleared at the model's first train()) and their
        namespace.
    :param state_vect_dim: reference state_vect_dim: 0 makes the node labels
        the state, > 0 a separate state of that width, drawn at 0.1 * N(0, 1)
        from the model's generator (core.draw_init) at every forward.
    :param max_iteration / threshold: the convergence loop's bounds.
    :param aggregation: gnn_tpu's aggregation name ('auto' uses the kernels).
    :param grad_mode / ift_backward_iters: gnn_tpu's gradient mode ('unroll',
        or 'ift': the implicit adjoint of models/ift.py) and the adjoint's
        Neumann iterations.
    :param seed: seed of the torch.Generators drawing the initial weights, the
        dropout masks and the initial states.
    :param device: None means the card ('cuda'); pass 'cpu' for the CPU.
    """

    _focus = "n"
    _namespace = "GNN"
    _forward = staticmethod(gnn_forward)
    _train_step = staticmethod(train_step)
    _draw_masks = staticmethod(draw_masks)

    def __init__(self, net_state: Union[MLPSpec, dict], net_output: Union[MLPSpec, dict],
                 optimizer="adam", loss_function: str = "categorical_crossentropy",
                 loss_arguments: Optional[dict] = None, *, addressed_problem: str = "c",
                 extra_metrics: Optional[dict] = None,
                 extra_metrics_arguments: Optional[dict] = None, path_writer: str = "writer/",
                 namespace: str = "GNN", state_vect_dim: int = 0, max_iteration: int = 5,
                 threshold: float = 0.01, aggregation: str = "auto", grad_mode: str = "unroll",
                 ift_backward_iters: int = 20, seed: Optional[int] = None, device=None) -> None:
        BaseModel.__init__(self, optimizer, loss_function, loss_arguments, addressed_problem,
                           extra_metrics, extra_metrics_arguments, path_writer, namespace)
        spec = GNNSpec(focus=self._focus, state_spec=_spec(net_state),
                       output_spec=_spec(net_output),
                       state_dim=int(state_vect_dim), max_iteration=int(max_iteration),
                       threshold=float(threshold), aggregation=aggregation, grad_mode=grad_mode,
                       ift_backward_iters=int(ift_backward_iters))
        self._setup(spec, gnn_init, seed, device)

    def _setup(self, spec, init, seed, device) -> None:
        self.device = resolve_device(device)
        self.spec = spec
        seed = int(np.random.randint(2 ** 31)) if seed is None else int(seed)
        gen = torch.Generator().manual_seed(seed)
        # dropout masks and initial states are drawn on the device, never on
        # the host per step
        self.mask_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        params, bn = init(self.spec, gen, self.device)
        self._install(params, bn)

    def _install(self, params, bn) -> None:
        for p in param_leaves(params):
            p.requires_grad_(True)
        self.params, self.bn = params, bn
        self._opt = make_optimizer(self.optimizer_config, param_leaves(params))

    # --------------------------------------------------------------- config
    @property
    def state_vect_dim(self) -> int:
        return self.spec.state_dim

    @property
    def max_iteration(self) -> int:
        return self.spec.max_iteration

    @property
    def state_threshold(self) -> float:
        return self.spec.threshold

    # -------------------------------------------------------------- weights
    def _tensors(self, params_np: dict, bn_np: dict):
        params, bn = params_from_jax(params_np, bn_np, self.device)
        if _shapes(params) != _shapes(self.params) or _shapes(bn) != _shapes(self.bn):
            raise ValueError(f"weights {_shapes(params)}, {_shapes(bn)} do not fit the "
                             f"model's {_shapes(self.params)}, {_shapes(self.bn)}")
        return params, bn

    def set_params(self, params_np: dict, bn_np: dict) -> None:
        """Install gnn_tpu (params, bn) pytrees given as nested numpy dicts;
        the optimizer starts afresh."""
        self._install(*self._tensors(params_np, bn_np))

    def get_weights(self):
        """([(state params, state BN statistics)], [(output params, output
        BN statistics)]): host numpy trees in gnn_tpu's layout."""
        p, b = params_to_jax(self.params, self.bn)
        return [(p["state"], b["state"])], [(p["output"], b["output"])]

    def set_weights(self, weights_state, weights_output) -> None:
        """Copy get_weights' lists into the model's tensors; the optimizer
        keeps its state, as gnn_tpu's set_weights keeps opt_state."""
        if not len(weights_state) == len(weights_output) == 1:
            raise ValueError("set_weights takes get_weights' lists: one entry each")
        (ps, bs), (po, bo) = weights_state[0], weights_output[0]
        params, bn = self._tensors({"state": ps, "output": po}, {"state": bs, "output": bo})
        new = flatten(params)
        with torch.no_grad():
            for key, leaf in flatten(self.params).items():
                leaf.copy_(new[key])
        self.bn = bn

    def trainable_variables(self):
        return [self.params["state"]], [self.params["output"]]

    def _weight_summaries(self):
        params = params_to_jax(self.params, self.bn)[0]
        return [(self.namespace[0], code, _keystr_leaves(params[net]))
                for net, code in (("state", "N1"), ("output", "N2"))]

    # ------------------------------------------------------------ copy/save/load
    def _copy_args(self) -> dict:
        return dict(net_state=self.spec.state_spec, net_output=self.spec.output_spec,
                    state_vect_dim=self.spec.state_dim)

    def copy(self, *, path_writer: str = "", namespace: str = "", copy_weights: bool = True):
        """A model of the same configuration on the same device, writing to
        path_writer (default: this one's with "_copied"); with copy_weights,
        this model's weights and BatchNorm statistics and a fresh optimizer."""
        new = self.__class__(
            **self._copy_args(), optimizer=dict(self.optimizer_config),
            loss_function=self.loss_function, loss_arguments=self.loss_args,
            max_iteration=self.spec.max_iteration, threshold=self.spec.threshold,
            addressed_problem=self.addressed_problem, extra_metrics=self.extra_metrics,
            extra_metrics_arguments=self.mt_args,
            path_writer=path_writer or self.path_writer[:-1] + "_copied/",
            namespace=namespace or self._namespace, aggregation=self.spec.aggregation,
            grad_mode=self.spec.grad_mode, ift_backward_iters=self.spec.ift_backward_iters,
            device=self.device)
        if copy_weights:
            new.set_params(*params_to_jax(self.params, self.bn))
        return new

    @classmethod
    def load(cls, path: str, path_writer: Optional[str] = None, namespace: Optional[str] = None,
             extra_metrics: Optional[dict] = None,
             extra_metrics_arguments: Optional[dict] = None, device=None):
        """Load a gnn_tpu save folder: config.json + params.npz + bn.npz; the
        model class (homogeneous or composite) is the one the config names.
        path_writer defaults to the folder's "writer"."""
        if path[-1] != "/":
            path += "/"
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
                      ift_backward_iters=config.get("ift_backward_iters", 20),
                      extra_metrics=extra_metrics, extra_metrics_arguments=extra_metrics_arguments,
                      path_writer=f"{path}writer" if path_writer is None else path_writer,
                      namespace=namespace or klass._namespace, seed=0, device=device)
        model = klass(**klass._config_args(config), **common)
        model.set_params(load_npz(os.path.join(path, "params.npz")),
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

    # ----------------------------------------------------------- device work
    def to_batch(self, graphs: Union[Graph, Sequence[Graph]], block_w: int = 128,
                 adj_dtype=None) -> GraphBatch:
        """Pack graphs into one fused-layout batch on the model's device; a
        graph-focus Graph that merges several graphs (Graph.merge) is packed
        as its graphs, so each pools on its own. `adj_dtype=torch.bfloat16`
        stores the block adjacencies in bf16 (graphs/batch.py)."""
        glist = [graphs] if isinstance(graphs, Graph) else list(graphs)
        if any(g.focus != self._focus for g in glist):
            raise ValueError(f"graph focus does not match model focus {self._focus!r}")
        glist = [h for g in glist for h in split_graphs(g)]
        return from_graphs_blocked(glist, block_w=block_w, focus=self._focus,
                                   fused_layout=True, adj_dtype=adj_dtype).to(self.device)

    def _eval_masks(self, gb: GraphBatch) -> Optional[dict]:
        """An eval forward's draws: the initial state at state_dim > 0, from
        the model's generator, else None."""
        return with_init(None, self.spec, gb, self.mask_gen)

    def forward(self, gb: GraphBatch) -> dict:
        """Inference gnn_forward on a batch already on the model's device."""
        with torch.no_grad():
            return self._forward(self.spec, self.params, self.bn, gb, masks=self._eval_masks(gb))

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

    def evaluate_single_graph(self, gb: Union[Graph, GraphBatch], training: bool) -> tuple:
        """(iters, loss, targets, outputs) of one batch, the selected target
        rows as host numpy (gnn_tpu's evaluate_single_graph). With training,
        dropout masks from the model's generator and batch-statistic
        BatchNorm; the moving statistics are not updated."""
        gb = gb if isinstance(gb, GraphBatch) else self.to_batch(gb)
        with torch.no_grad():
            masks = (self._draw_masks(self.spec, gb, self.mask_gen) if training
                     else self._eval_masks(gb))
            res = self._forward(self.spec, self.params, self.bn, gb, training=training,
                                masks=masks)
            loss = weighted_loss(get_loss(self.loss_function), self.loss_args, gb, res["out"])
        sel = gb.sel_mask.cpu().numpy()
        return (float(res["iters"]), float(loss), gb.targets.cpu().numpy()[sel],
                res["out"].cpu().numpy()[sel])

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
    :param state_dim: as GNNnodeBased's state_vect_dim. Other arguments as
        GNNnodeBased.
    """

    _focus = "n"
    _namespace = "CompositeGNN"
    _forward = staticmethod(composite.composite_forward)
    _train_step = staticmethod(composite.composite_train_step)
    _draw_masks = staticmethod(composite.draw_masks)

    def __init__(self, net_states: Sequence[Union[MLPSpec, dict]],
                 net_output: Union[MLPSpec, dict], optimizer="adam",
                 loss_function: str = "categorical_crossentropy",
                 loss_arguments: Optional[dict] = None, *, addressed_problem: str = "c",
                 extra_metrics: Optional[dict] = None,
                 extra_metrics_arguments: Optional[dict] = None, path_writer: str = "writer/",
                 namespace: str = "CompositeGNN", max_iteration: int = 5,
                 threshold: float = 0.01, aggregation: str = "auto", grad_mode: str = "unroll",
                 ift_backward_iters: int = 20, state_dim: int = 0, seed: Optional[int] = None,
                 device=None) -> None:
        BaseModel.__init__(self, optimizer, loss_function, loss_arguments, addressed_problem,
                           extra_metrics, extra_metrics_arguments, path_writer, namespace)
        spec = composite.CompositeGNNSpec(
            focus=self._focus, state_specs=tuple(_spec(s) for s in net_states),
            output_spec=_spec(net_output), max_iteration=int(max_iteration),
            threshold=float(threshold), aggregation=aggregation, grad_mode=grad_mode,
            ift_backward_iters=int(ift_backward_iters), state_dim=int(state_dim))
        self._setup(spec, composite.composite_init, seed, device)

    def to_batch(self, graphs: Union[Graph, Sequence[Graph]], block_w: int = 128,
                 adj_dtype=None) -> GraphBatch:
        """Pack graphs carrying node types into one fused-layout batch on the
        model's device."""
        glist = [graphs] if isinstance(graphs, Graph) else list(graphs)
        composite.check_node_types(glist, self.spec.n_types)
        return super().to_batch(glist, block_w, adj_dtype)

    @staticmethod
    def _config_args(config: dict) -> dict:
        return dict(net_states=config["net_states"], net_output=config["net_output"],
                    state_dim=config.get("state_dim", 0))

    def _config(self) -> dict:
        return {"net_states": [s.to_config() for s in self.spec.state_specs],
                "net_output": self.spec.output_spec.to_config(),
                "state_dim": self.spec.state_dim}

    def _copy_args(self) -> dict:
        return dict(net_states=self.spec.state_specs, net_output=self.spec.output_spec,
                    state_dim=self.spec.state_dim)

    def trainable_variables(self):
        return [list(self.params["state"])], [self.params["output"]]

    def _weight_summaries(self):
        params = params_to_jax(self.params, self.bn)[0]
        return ([(self.namespace[0], f"N1T{t}", _keystr_leaves(p))
                 for t, p in enumerate(params["state"])]
                + [(self.namespace[0], "N2", _keystr_leaves(params["output"]))])


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
