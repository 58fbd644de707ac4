"""Layered GNN (LGNN): a stack of GNNs in which each layer sees the original
graph with the previous layer's state and/or output appended to its labels
(counterpart of gnn_tpu/models/lgnn.py).

* Forward: layer l runs on the ORIGINAL batch augmented (not cumulatively)
  with layer l-1's state (get_state) and its outputs, zero outside the
  supervised entities (get_output; arc labels for focus 'a', node labels
  otherwise). A layer is a GNNSpec or a CompositeGNNSpec and runs on the
  routes its spec and the batch select (models/core.py, composite.py): the
  kernels see each layer's widths, and layer l's params get the loss
  gradient of the layers above through the routes' gradients into their
  initial state.
* Training modes: 'parallel' (the mean over layers of the per-layer losses),
  'residual' (the loss of the mean over layers of the outputs), 'serial'
  (each layer trained on its own in turn by its GNN's train, on batches
  augmented by the layers below). Each layer's state-net grads are divided
  by that layer's realised iteration count.
* Dropout keep-masks come from the model's generator, one draw_masks
  structure a layer (tests pass gnn_tpu's masks instead).

Multi-device training (data-, edge- and node-parallel steps) belongs to
gnn_tpu's parallel/ package, not ported yet (M11): those entry points raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.models import composite, core
from gnn_tpu_torch.models.engine import BaseModel
from gnn_tpu_torch.models.gnn import GNNedgeBased, GNNgraphBased, GNNnodeBased
from gnn_tpu_torch.training.losses import get_loss
from gnn_tpu_torch.training.optimizers import make_optimizer

TRAINING_MODES = ("parallel", "serial", "residual")


def update_graph_batch(gb: GraphBatch, state, out_entity, *, get_state: bool,
                       get_output: bool, focus: str) -> GraphBatch:
    """`gb` with the previous layer's state and/or its outputs (zero outside
    set_mask & output_mask, gnn_tpu's scatter) appended to the node labels,
    or for focus 'a' the outputs to the arc labels (gnn_tpu lgnn.py:39-57).
    Where labels were appended, their aggregation is computed on use
    (agg_arcs_cache, agg_nodes_cache None, as gnn_tpu always does);
    otherwise they are unchanged and so is their cached aggregation."""
    nodeplus, arcplus = [], []
    if get_state:
        nodeplus.append(state)
    if get_output:
        scattered = out_entity * core._entity_mask(gb).to(out_entity.dtype)[:, None]
        (arcplus if focus == "a" else nodeplus).append(scattered)
    nodes = torch.cat([gb.nodes] + nodeplus, dim=1) if nodeplus else gb.nodes
    arcs = torch.cat([gb.arc_labels] + arcplus, dim=1) if arcplus else gb.arc_labels
    return dataclasses.replace(gb, nodes=nodes, arc_labels=arcs,
                               agg_arcs_cache=None if arcplus else gb.agg_arcs_cache,
                               agg_nodes_cache=None if nodeplus else gb.agg_nodes_cache)


def _kind(spec):
    """The module of a layer's spec: composite.py for a CompositeGNNSpec,
    core.py otherwise (gnn_tpu lgnn.py:60-72)."""
    return composite if isinstance(spec, composite.CompositeGNNSpec) else core


def forward_any(spec, params, bn, gb: GraphBatch, training: bool = False,
                masks: Optional[dict] = None) -> dict:
    """gnn_forward or composite_forward, as the layer's spec is."""
    if isinstance(spec, composite.CompositeGNNSpec):
        return composite.composite_forward(spec, params, bn, gb, training, masks)
    return core.gnn_forward(spec, params, bn, gb, training, masks)


def _regularization(spec, params) -> torch.Tensor:
    if isinstance(spec, composite.CompositeGNNSpec):
        return composite.composite_regularization(spec, params)
    return core.regularization(spec, params)


def draw_masks(specs, gb: GraphBatch, gen: torch.Generator) -> list:
    """One draw_masks structure a layer, drawn from `gen` in layer order (the
    layers' batches share gb's rows)."""
    return [_kind(s).draw_masks(s, gb, gen) for s in specs]


def draw_inits(specs, gb: GraphBatch, gen: torch.Generator) -> list:
    """An eval forward's draws a layer, in layer order: {"init": the
    initial state} for a layer with state_dim > 0 (core.draw_init), else
    None."""
    return [core.with_init(None, s, gb, gen) for s in specs]


def lgnn_forward(specs, params, bns, gb: GraphBatch, training: bool, get_state: bool,
                 get_output: bool, masks: Optional[Sequence[dict]] = None):
    """The layer stack (gnn_tpu lgnn.py:83-101). Returns (iters list, outs
    list of target-aligned rows [Tp, DT], the last layer's state, the
    layers' new BatchNorm statistics as a tuple).

    :param masks: in training, one keep-mask structure a layer (draw_masks);
        at eval draw_inits' list where a layer has state_dim > 0."""
    iters, outs, new_bns = [], [], []
    gtmp, state = gb, None
    for idx, spec in enumerate(specs):
        res = forward_any(spec, params[idx], bns[idx], gtmp, training,
                          masks[idx] if masks else None)
        iters.append(res["iters"])
        outs.append(res["out"])
        new_bns.append(res["bn"])
        state = res["state"]
        if idx + 1 < len(specs):
            gtmp = update_graph_batch(gb, state, res["out_entity"], get_state=get_state,
                                      get_output=get_output, focus=spec.focus)
    return iters, outs, state, tuple(new_bns)


def lgnn_loss(loss_name: str, loss_args: dict, gb: GraphBatch, outs, training_mode: str):
    """gnn_tpu's _lgnn_loss (lgnn.py:104-113): 'residual' takes the loss of
    the layers' mean output, any other mode the mean of the layers' losses
    (the evaluation loss too); weighted and summed over the selected rows."""
    lf = get_loss(loss_name)
    if training_mode == "residual":
        per = lf(gb.targets, torch.mean(torch.stack(outs), dim=0), **loss_args)
    else:
        per = torch.mean(torch.stack([lf(gb.targets, o, **loss_args) for o in outs]), dim=0)
    return torch.sum(per * gb.sample_weights * gb.sel_mask.to(per.dtype))


def lgnn_train_step(specs, params, bns, optimizer: torch.optim.Optimizer, gb: GraphBatch,
                    masks: Sequence[dict], *, loss_name: str, loss_args: Optional[dict] = None,
                    mean: bool = True, get_state: bool = False, get_output: bool = True,
                    training_mode: str = "parallel") -> dict:
    """One optimizer step of the stack (gnn_tpu lgnn.py:116-143): the loss
    plus every layer's regularization is differentiated, each layer's
    state-net grads are divided by that layer's realised count when `mean`,
    and `optimizer`, over every layer's leaves, updates them in place.
    Returns {"iters" [L], "loss", "bn" (a tuple a layer)} as device tensors."""
    optimizer.zero_grad(set_to_none=True)
    iters, outs, _, new_bns = lgnn_forward(specs, params, bns, gb, True, get_state, get_output,
                                           masks)
    loss = lgnn_loss(loss_name, loss_args or {}, gb, outs, training_mode)
    total = loss + sum(_regularization(s, p) for s, p in zip(specs, params))
    total.backward()
    if mean:
        for p, it in zip(params, iters):
            core.divide_state_grads(p["state"], it)
    optimizer.step()
    return {"iters": torch.stack(iters), "loss": loss.detach(), "bn": core.detach_tree(new_bns)}


def lgnn_eval(specs, params, bns, gb: GraphBatch, *, loss_name: str, loss_args: dict,
              training: bool, get_state: bool, get_output: bool, training_mode: str,
              masks: Optional[Sequence[dict]] = None):
    """gnn_tpu's _lgnn_eval_impl (lgnn.py:144-152): (iters [L], loss, outs,
    last state); the loss is 'parallel' at eval."""
    iters, outs, state, _ = lgnn_forward(specs, params, bns, gb, training, get_state,
                                         get_output, masks)
    loss = lgnn_loss(loss_name, loss_args, gb, outs, training_mode if training else "parallel")
    return torch.stack(iters), loss, outs, state


def _multi_device(what: str):
    raise NotImplementedError(
        f"{what}: multi-device LGNN training belongs to gnn_tpu's parallel/ package "
        "(ROADMAP Queue 1, M11), not ported yet")


def make_lgnn_edge_sharded_train_step(*args, **kwargs):
    """gnn_tpu's edge-sharded LGNN step (M11, not ported): raises."""
    _multi_device("make_lgnn_edge_sharded_train_step")


def make_lgnn_dp_train_step(*args, **kwargs):
    """gnn_tpu's data-parallel LGNN step (M11, not ported): raises."""
    _multi_device("make_lgnn_dp_train_step")


_GNNS_TYPE = {GNNnodeBased: "n", GNNedgeBased: "a", GNNgraphBased: "g"}


class LGNN(BaseModel):
    """A stack of L GNNs of one class (reference LGNN.py:13, gnn_tpu's LGNN).

    :param gnns: the layers, GNN*Based or Composite*Based models of one
        class on one device (their widths from get_inout_dims(..., layer=l,
        get_state=..., get_output=...)).
    :param get_state / get_output: what a layer appends to the next layer's
        labels.
    Other arguments as GNNnodeBased. Each layer writes to
    "{path_writer}{namespace} - GNN{i}/" under namespace "{namespace} - GNN{i}".
    """

    def __init__(self, gnns: List[GNNnodeBased], get_state: bool, get_output: bool,
                 optimizer="adam", loss_function: str = "categorical_crossentropy",
                 loss_arguments: Optional[dict] = None, addressed_problem: str = "c",
                 extra_metrics: Optional[dict] = None,
                 extra_metrics_arguments: Optional[dict] = None,
                 path_writer: str = "writer/", namespace: str = "LGNN") -> None:
        gnns_type = set(type(i) for i in gnns)
        if len(gnns_type) != 1:
            raise TypeError("parameter <gnn> must contain gnns of the same type")
        if len({g.device for g in gnns}) != 1:
            raise ValueError("the layers of an LGNN must be on one device")
        super().__init__(optimizer, loss_function, loss_arguments, addressed_problem,
                         extra_metrics, extra_metrics_arguments, path_writer, namespace)
        self.get_state = bool(get_state)
        self.get_output = bool(get_output)
        self.gnns = list(gnns)
        self.LAYERS = len(gnns)
        self.GNNS_TYPE = list(gnns_type)[0]
        self.device = self.gnns[0].device
        self.namespace = [f"{namespace} - GNN{i}" for i in range(self.LAYERS)]
        self.training_mode: Optional[str] = None
        for gnn, name in zip(self.gnns, self.namespace):
            gnn.namespace = [name]
            gnn.path_writer = f"{self.path_writer}{name}/"
        self.mask_gen = torch.Generator(device=self.device).manual_seed(
            int(np.random.randint(2 ** 31)))
        self._install_optimizer()

    def _install_optimizer(self) -> None:
        """A fresh optimizer over every layer's leaves (the layers' own
        optimizers train them in serial mode)."""
        self._opt = make_optimizer(self.optimizer_config, core.param_leaves(self._params()))

    # ------------------------------------------------------------- plumbing
    @property
    def _specs(self):
        return tuple(g.spec for g in self.gnns)

    def _params(self):
        return tuple(g.params for g in self.gnns)

    def _bns(self):
        return tuple(g.bn for g in self.gnns)

    @property
    def focus(self) -> str:
        return self.gnns[0].spec.focus

    def to_batch(self, g: Union[Graph, Sequence[Graph]], block_w: int = 128,
                 adj_dtype=None) -> GraphBatch:
        return self.gnns[0].to_batch(g, block_w, adj_dtype)

    def _mode(self) -> str:
        return self.training_mode or "parallel"

    # ----------------------------------------------------------------- copy
    def copy(self, *, path_writer: str = "", namespace: str = "",
             copy_weights: bool = True) -> "LGNN":
        """A stack of copies of the layers (with their weights when
        copy_weights) and a fresh optimizer, writing to path_writer (default:
        this one's with "_copied")."""
        return self.__class__(
            gnns=[g.copy(copy_weights=copy_weights) for g in self.gnns],
            get_state=self.get_state, get_output=self.get_output,
            optimizer=dict(self.optimizer_config), loss_function=self.loss_function,
            loss_arguments=self.loss_args, addressed_problem=self.addressed_problem,
            extra_metrics=self.extra_metrics, extra_metrics_arguments=self.mt_args,
            path_writer=path_writer or self.path_writer[:-1] + "_copied/",
            namespace=namespace or "LGNN")

    # ------------------------------------------------------------ save/load
    def save(self, path: str) -> None:
        """gnn_tpu's folder (reference LGNN.py:83-101): GNN{i}/ a layer and
        config.json; the layers must be GNN*Based (gnn_tpu's gnns_type)."""
        if self.GNNS_TYPE not in _GNNS_TYPE:
            raise ValueError(f"gnn_tpu's LGNN folder holds GNNnodeBased, GNNedgeBased or "
                             f"GNNgraphBased layers, not {self.GNNS_TYPE.__name__}")
        if path[-1] != "/":
            path += "/"
        os.makedirs(path, exist_ok=True)
        for i, gnn in enumerate(self.gnns):
            gnn.save(f"{path}GNN{i}/")
        config = {"get_state": self.get_state, "get_output": self.get_output,
                  "loss_function": self.loss_function, "loss_arguments": self.loss_args,
                  "optimizer": self.optimizer_config,
                  "addressed_problem": self.addressed_problem,
                  "gnns_type": _GNNS_TYPE[self.GNNS_TYPE]}
        with open(f"{path}config.json", "w") as f:
            json.dump(config, f)

    @classmethod
    def load(cls, path: str, path_writer: Optional[str] = None, namespace: str = "LGNN",
             extra_metrics: Optional[dict] = None,
             extra_metrics_arguments: Optional[dict] = None, device=None) -> "LGNN":
        """Load gnn_tpu's folder (reference LGNN.py:104-141): the layers from
        its GNN* folders in sorted order, as gnn_tpu reads them."""
        if path[-1] != "/":
            path += "/"
        if path_writer is None:
            path_writer = f"{path}writer"
        with open(f"{path}config.json") as f:
            config = json.load(f)
        klass = {v: k for k, v in _GNNS_TYPE.items()}[config.pop("gnns_type")]
        layer_dirs = sorted(d for d in os.listdir(path)
                            if os.path.isdir(os.path.join(path, d)) and d.startswith("GNN"))
        gnns = [klass.load(f"{path}{d}", path_writer=f"{path_writer}{namespace} - {d}/",
                           namespace="GNN", device=device) for d in layer_dirs]
        return cls(gnns=gnns, optimizer=config.pop("optimizer"),
                   loss_function=config.pop("loss_function"),
                   loss_arguments=config.pop("loss_arguments"),
                   addressed_problem=config.pop("addressed_problem"),
                   get_state=config.pop("get_state"), get_output=config.pop("get_output"),
                   extra_metrics=extra_metrics, extra_metrics_arguments=extra_metrics_arguments,
                   path_writer=path_writer, namespace=namespace)

    # -------------------------------------------------------------- weights
    def trainable_variables(self):
        return ([g.params["state"] for g in self.gnns],
                [g.params["output"] for g in self.gnns])

    def get_weights(self):
        """([per layer (state params, state BN statistics)], [per layer
        (output params, output BN statistics)]): host numpy trees."""
        ws, wo = [], []
        for g in self.gnns:
            s, o = g.get_weights()
            ws.append(s[0])
            wo.append(o[0])
        return ws, wo

    def set_weights(self, weights_state, weights_output) -> None:
        """Copy get_weights' lists into the layers; the optimizers keep their
        state."""
        if not len(weights_state) == len(weights_output) == self.LAYERS:
            raise ValueError(f"set_weights takes get_weights' lists: {self.LAYERS} entries each")
        for g, ws, wo in zip(self.gnns, weights_state, weights_output):
            g.set_weights([ws], [wo])

    def _weight_summaries(self):
        return [(ns, net, leaves) for g, ns in zip(self.gnns, self.namespace)
                for _, net, leaves in g._weight_summaries()]

    # ------------------------------------------------------------ checkpoint
    def _ckpt_params(self):
        return self._params()

    def _ckpt_bn(self):
        return self._bns()

    def _ckpt_restore(self, params_np, bn_np) -> None:
        """Install gnn_tpu's per-layer (params, bn) trees (tuples a layer, or
        for BatchNorm-free layers an empty bn) and a fresh optimizer."""
        for i, g in enumerate(self.gnns):
            g.set_params(params_np[i], bn_np[i] if isinstance(bn_np, tuple) else {})
        self._install_optimizer()

    # ----------------------------------------------------------- prediction
    def _eval(self, gb: GraphBatch, training: bool):
        with torch.no_grad():
            masks = (draw_masks if training else draw_inits)(self._specs, gb, self.mask_gen)
            return lgnn_eval(self._specs, self._params(), self._bns(), gb,
                             loss_name=self.loss_function, loss_args=self.loss_args,
                             training=training, get_state=self.get_state,
                             get_output=self.get_output, training_mode=self._mode(),
                             masks=masks)

    def Loop(self, g: Union[Graph, GraphBatch], *, training: bool = False):
        """(iters list, last state, outs list of the selected target rows)
        (reference LGNN.py:263-290), host numpy."""
        gb = g if isinstance(g, GraphBatch) else self.to_batch(g)
        iters, _, outs, state = self._eval(gb, training)
        sel = gb.sel_mask.cpu().numpy()
        return ([float(i) for i in iters.cpu()], state.cpu().numpy(),
                [o.cpu().numpy()[sel] for o in outs])

    def __call__(self, g):
        return self.Loop(g)[-1][-1]

    def predict(self, g, idx: Union[int, list, range, str] = -1):
        """Selected layers' outputs at eval (reference LGNN.py:172-198): one
        layer's for an int, a list for a list, range or 'all'."""
        all_layers = range(self.LAYERS)
        if isinstance(idx, int):
            if idx not in list(all_layers) + [-1]:
                raise ValueError(f"param <idx> {idx} not in range(self.LAYERS) or -1")
        elif isinstance(idx, (list, range)):
            if not all(i in all_layers for i in idx):
                raise ValueError(f"param <idx> {list(idx)} not in range(self.LAYERS)")
            idx = sorted(idx)
        elif idx == "all":
            idx = list(all_layers)
        else:
            raise ValueError("param <idx> must be 1.int; 2.list of ordered ints "
                             "in range(self.LAYERS); 3. str 'all'")
        out = self.Loop(g)[-1]
        return out[idx] if isinstance(idx, int) else [out[i] for i in idx]

    def evaluate_single_graph(self, gb: Union[Graph, GraphBatch], training: bool) -> tuple:
        """(iters list, loss, targets, the last layer's outputs) of one
        batch, the selected rows as host numpy."""
        gb = gb if isinstance(gb, GraphBatch) else self.to_batch(gb)
        iters, loss, outs, _ = self._eval(gb, training)
        sel = gb.sel_mask.cpu().numpy()
        return ([float(i) for i in iters.cpu()], float(loss), gb.targets.cpu().numpy()[sel],
                outs[-1].cpu().numpy()[sel])

    # ------------------------------------------------------------ train step
    def training_step(self, gb: GraphBatch, mean: bool = True,
                      masks: Optional[Sequence[dict]] = None) -> dict:
        """One optimizer step of the stack in the model's training mode
        ('parallel' until train() sets it): masks drawn from the model's
        generator unless `masks` (one draw_masks structure a layer) is given.
        Returns {"iters" [L], "loss"} as device tensors."""
        if masks is None:
            masks = draw_masks(self._specs, gb, self.mask_gen)
        res = lgnn_train_step(self._specs, self._params(), self._bns(), self._opt, gb, masks,
                              loss_name=self.loss_function, loss_args=self.loss_args,
                              mean=mean, get_state=self.get_state, get_output=self.get_output,
                              training_mode=self._mode())
        for g, b in zip(self.gnns, res["bn"]):
            g.bn = b
        return {"iters": res["iters"], "loss": res["loss"]}

    def training_step_dp(self, *args, **kwargs):
        _multi_device("LGNN.training_step_dp")

    def _shard_for(self, *args, **kwargs):
        _multi_device("LGNN._shard_for")

    def training_step_sharded(self, *args, **kwargs):
        _multi_device("LGNN.training_step_sharded")

    # ----------------------------------------------------------------- train
    def train(self, gTr, epochs: int, gVa=None, update_freq: int = 10,
              max_fails: int = 10, observed_metric: str = "Loss", policy: str = "min",
              *, mean: bool = True, training_mode: str = "parallel",
              verbose: int = 3, profile_dir: Optional[str] = None,
              nan_policy: str = "none", mesh=None,
              mesh_axis: Optional[str] = None, mesh_strategy: str = "data") -> None:
        """gnn_tpu's LGNN.train (lgnn.py:545-586): 'parallel' and 'residual'
        run the engine's loop on the stack's step; 'serial' trains each
        layer's GNN in turn (its own optimizer and writer folder), then
        augments the batches with that layer's eval outputs for the next.
        The mode is sticky once set."""
        if training_mode not in TRAINING_MODES:
            raise ValueError(f"param <training_mode> not in {list(TRAINING_MODES)}")
        if self.training_mode is not None and self.training_mode != training_mode:
            raise ValueError("LGNN training_mode is sticky once set (reference LGNN.py:313-316)")
        self.training_mode = training_mode
        gTr = self.checktype(gTr)
        gVa = self.checktype(gVa)
        if training_mode != "serial":
            super().train(gTr, epochs, gVa, update_freq, max_fails, observed_metric, policy,
                          mean=mean, verbose=verbose, profile_dir=profile_dir,
                          nan_policy=nan_policy, mesh=mesh, mesh_axis=mesh_axis,
                          mesh_strategy=mesh_strategy)
            return
        gTr1 = list(gTr)
        gVa1 = list(gVa) if gVa is not None else None
        for idx, gnn in enumerate(self.gnns):
            if verbose in (1, 3):
                print(f"\n\n------------------- GNN{idx} -------------------\n")
            gnn.train(gTr1, epochs, gVa1, update_freq, max_fails, observed_metric, policy,
                      mean=mean, verbose=verbose, nan_policy=nan_policy, mesh=mesh,
                      mesh_axis=mesh_axis, mesh_strategy=mesh_strategy)
            gTr1 = [self._augment(gnn, base, cur) for base, cur in zip(gTr, gTr1)]
            if gVa:
                gVa1 = [self._augment(gnn, base, cur) for base, cur in zip(gVa, gVa1)]

    def _augment(self, gnn: GNNnodeBased, base: GraphBatch, cur: GraphBatch) -> GraphBatch:
        """The ORIGINAL batch augmented with one layer's eval state/outputs on
        its own (already augmented) batch (LGNN.py:336-340)."""
        with torch.no_grad():
            res = forward_any(gnn.spec, gnn.params, gnn.bn, cur, masks=gnn._eval_masks(cur))
            return update_graph_batch(base, res["state"], res["out_entity"],
                                      get_state=self.get_state, get_output=self.get_output,
                                      focus=gnn.spec.focus)
