"""Training engine: the epoch loop with early stopping, history, metrics,
test reports, Leave-K-Out cross-validation, checkpoints and scalar logging
(counterpart of gnn_tpu/models/engine.py).

`BaseModel.train` is gnn_tpu's loop: a training step per batch, every
`update_freq` epochs the training and validation metrics into `history`,
early stopping on `observed_metric` under `policy` with the best weights
restored, the divergence guard `nan_policy`, and the per-epoch counters
`EpochSeconds` / `EdgesPerSecond`. On a CUDA model the epoch clock reads
after one torch.cuda.synchronize(), so the counters measure the card's
work, not its dispatch. `ScalarWriter` writes gnn_tpu's JSONL lines and
TensorBoard event files.

Two points differ from gnn_tpu on purpose: the writer folder `path_writer`
is cleared when the model's first train() opens it, not when the model is
built (a model built and never trained leaves the folder alone), and
`mesh` (data-, edge- or node-parallel training) is not ported yet.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from gnn_tpu_torch import metrics as mt
from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.graphs.generator import GraphDataGenerator, SingleGraphDataGenerator
from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.training.optimizers import optimizer_config

_PRETTY = {"Acc": "Accuracy", "Bacc": "Balanced Accuracy", "Ck": "Cohen's Kappa",
           "Js": "Jaccard Score", "Fs": "F1-Score", "Prec": "Precision Score",
           "Rec": "Recall Score", "Tpr": "TPR", "Tnr": "TNR", "Fpr": "FPR",
           "Fnr": "FNR", "Loss": "Loss", "It": "Iteration @ Convergence"}

_NAMESCOPES = {**{i: "Accuracy & Loss" for i in ["Acc", "Bacc", "It", "Loss"]},
               **{i: "F-Score, Precision and Recall" for i in ["Fs", "Prec", "Rec"]},
               **{i: "Positive and Negative Rates" for i in ["Tpr", "Tnr", "Fpr", "Fnr"]},
               **{i: "Other Scores" for i in ["Ck", "Js"]}}


class ScalarWriter:
    """Scalars and weight summaries of one writer: one JSON object a line in
    `path`, and (with `tb`) TensorBoard event records in the run folder
    beside it (`path` without ".jsonl"), tagged "<scope>/<name>"."""

    def __init__(self, path: str, tb: bool = True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.tb = None
        if tb:
            from gnn_tpu_torch.training.tb_events import TBEventFile
            self.tb = TBEventFile(path[:-6] if path.endswith(".jsonl") else path + ".tb")

    def write_scalars(self, metrics: dict, step: int) -> None:
        if not isinstance(metrics, dict):
            raise TypeError("type of param <metrics> must be dict")
        with open(self.path, "a") as f:
            for k, v in metrics.items():
                f.write(json.dumps({"step": step, "scope": _NAMESCOPES.get(k, "Other Scores"),
                                    "name": _PRETTY.get(k, k), "value": float(v)}) + "\n")
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.scalar(f"{_NAMESCOPES.get(k, 'Other Scores')}/{_PRETTY.get(k, k)}",
                               float(v), step)
            self.tb.flush()

    def write_weights(self, namespace: str, net_name: str, leaves: list, step: int) -> None:
        """Per-layer moments (JSONL) and histograms (TB), scoped
        '<namespace>: Weights|Biases / <net> <layer>'."""
        with open(self.path, "a") as f:
            for name, arr in leaves:
                a = np.asarray(arr)
                f.write(json.dumps({
                    "step": step, "scope": f"{namespace}: {net_name}", "name": name,
                    "mean": float(a.mean()), "std": float(a.std()),
                    "min": float(a.min()), "max": float(a.max())}) + "\n")
        if self.tb is not None:
            kinds = (("['w']", "Weights"), ("['gamma']", "Weights"),
                     ("['b']", "Biases"), ("['beta']", "Biases"))
            for name, arr in leaves:
                for suffix, kind in kinds:
                    if name.endswith(suffix):
                        scope, stem = f"{namespace}: {kind}", name[:-len(suffix)]
                        break
                else:
                    scope, stem = f"{namespace}: Params", name
                layer = stem.replace("']['", "/").strip("[]'") or net_name
                self.tb.histogram(f"{scope}/{net_name} {layer}", np.asarray(arr), step)
            self.tb.flush()

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()


def history_table(history: dict) -> str:
    """The history as pandas' DataFrame.to_string(index=False) lays it out:
    right-aligned columns, floats to the fewest of 6 significant digits
    that every value of a column shows."""
    cols = []
    for name, vals in history.items():
        cells = _format_column(vals)
        width = max([len(name)] + [len(c) for c in cells])
        cols.append([name.rjust(width)] + [c.rjust(width) for c in cells])
    rows = max((len(c) for c in cols), default=0)
    return "\n".join(" ".join(c[i] if i < len(c) else "" for c in cols).rstrip()
                     for i in range(rows))


def _format_column(vals) -> list:
    if all(isinstance(v, (bool, np.bool_)) for v in vals):
        return [str(bool(v)) for v in vals]
    if all(isinstance(v, (int, np.integer)) for v in vals):
        return [str(int(v)) for v in vals]
    x = np.asarray(vals, dtype=np.float64)
    finite = np.abs(x[np.isfinite(x) & (x != 0)])
    if finite.size and (finite.max() >= 1e6 or finite.min() < 1e-4):
        return [f"{v:.6e}" for v in x]
    digits = max([1] + [len(f"{v:.6g}".partition(".")[2]) for v in x[np.isfinite(x)]])
    return [f"{v:.{digits}f}" for v in x]


def history_csv(history: dict) -> str:
    """The history as pandas' DataFrame.to_csv(index=False) writes it: a
    header line, then one line an epoch; a column of ints prints ints, any
    other column floats in repr form."""
    names = list(history)
    cols = [[str(v) for v in vals] if all(isinstance(v, (bool, np.bool_)) for v in vals)
            else [str(int(v)) for v in vals]
            if all(isinstance(v, (int, np.integer)) for v in vals)
            else [repr(float(v)) for v in vals] for vals in history.values()]
    rows = max((len(c) for c in cols), default=0)
    lines = [",".join(_csv_quote(n) for n in names)]
    lines += [",".join(c[i] if i < len(c) else "" for c in cols) for i in range(rows)]
    return "\n".join(lines) + "\n"


def _csv_quote(s: str) -> str:
    return f'"{s}"' if any(c in s for c in ',"\n') else s


class BaseModel(ABC):
    """The engine of every model class; subclasses define the device work
    (training_step, evaluate_single_graph) and the weights' access."""

    def __init__(self, optimizer, loss_function, loss_arguments: Optional[dict],
                 addressed_problem: str, extra_metrics: Optional[dict] = None,
                 extra_metrics_arguments: Optional[dict] = None,
                 path_writer: str = "writer/", namespace: str = "GNN") -> None:
        if addressed_problem not in ("c", "r"):
            raise ValueError("param <addressed_problem> not in ['c','r']")
        if not isinstance(extra_metrics, (dict, type(None))):
            raise TypeError("type of param <extra_metrics> must be None or dict")
        self.optimizer_config = (optimizer_config(optimizer) if isinstance(optimizer, str)
                                 else optimizer)
        self.loss_function = loss_function
        self.loss_args = dict(loss_arguments or {})
        self.addressed_problem = addressed_problem
        self.extra_metrics = dict() if extra_metrics is None else extra_metrics
        self.mt_args = dict() if extra_metrics_arguments is None else extra_metrics_arguments
        if path_writer[-1] != "/":
            path_writer += "/"
        self.path_writer = path_writer
        self.namespace = namespace if isinstance(namespace, list) else [namespace]
        self.history = dict()
        self._writer_opened = False

    # ------------------------------------------------------------- abstract
    @abstractmethod
    def copy(self, *, path_writer: str = "", namespace: str = "", copy_weights: bool = True):
        ...

    @abstractmethod
    def save(self, path: str) -> None:
        ...

    @abstractmethod
    def get_weights(self):
        """(weights_state, weights_output): lists with one entry a layer."""

    @abstractmethod
    def set_weights(self, weights_state, weights_output) -> None:
        ...

    @abstractmethod
    def evaluate_single_graph(self, gb: GraphBatch, training: bool) -> tuple:
        """(iters, loss, targets, outputs): host numpy rows of the selected
        targets."""

    @abstractmethod
    def training_step(self, gb: GraphBatch, mean: bool = True, masks=None):
        ...

    @abstractmethod
    def _weight_summaries(self):
        """[(namespace, net name, [(leaf name, array), ...]), ...]."""

    # ------------------------------------------------------------- history
    def printHistory(self) -> None:
        print("\n", history_table(self.history), end="\n\n")

    def saveHistory_csv(self, path: str) -> None:
        if path[-4:] != ".csv":
            path += ".csv"
        with open(path, "w") as f:
            f.write(history_csv(self.history))

    def saveHistory_txt(self, path: str) -> None:
        if path[-4:] != ".txt":
            path += ".txt"
        with open(path, "w") as txt:
            txt.write(history_table(self.history))

    # ------------------------------------------------------------ checktype
    def checktype(self, elem) -> Optional[list]:
        """A Graph, a GraphBatch or a list of them as a list of GraphBatches
        on the model's device. Batches without blocks are grown to one
        common shape."""
        if elem is None:
            return None
        if isinstance(elem, (Graph, GraphBatch)):
            elem = [elem]
        if not (isinstance(elem, (list, tuple))
                and all(isinstance(g, (Graph, GraphBatch)) for g in elem)):
            raise TypeError("Error - <gTr> and/or <gVa> are not Graph/GraphBatch or "
                            "LIST/TUPLE of Graphs/GraphBatches")
        out = [self.to_batch(g) if isinstance(g, Graph) else g.to(self.device) for g in elem]
        if (len(out) > 1 and len({b.pad_shapes() for b in out}) > 1
                and not any(b.has_blocks for b in out)):
            np_, ep_, tp_ = (max(s) for s in zip(*(b.pad_shapes() for b in out)))
            out = [b.repad(np_, ep_, tp_) for b in out]
        return out

    # ------------------------------------------------------------- evaluate
    def evaluate(self, g) -> tuple:
        """(metrics, y_true, y_pred, targets, y_score) over the batches: the
        extra metrics on the argmax labels ('c') or the values ('r'), the
        mean iteration count 'It' and the mean loss 'Loss'."""
        g = self.checktype(g)
        iters, losses, targets, outs = zip(*[self.evaluate_single_graph(b, training=False)
                                             for b in g])
        targets = np.concatenate(targets, axis=0)
        y_score = np.concatenate(outs, axis=0)
        if self.addressed_problem == "c":
            y_true, y_pred = np.argmax(targets, axis=1), np.argmax(y_score, axis=1)
        else:
            y_true, y_pred = targets, y_score
        metrics = {k: self.extra_metrics[k](y_true, y_pred, **self.mt_args.get(k, dict()))
                   for k in self.extra_metrics}
        metrics = {k: float(np.mean(metrics[k])) for k in metrics}
        flat_iters = [i for it in iters for i in (it if isinstance(it, (list, tuple)) else [it])]
        metrics["It"] = int(np.mean(flat_iters))
        metrics["Loss"] = float(np.mean(losses))
        return metrics, y_true, y_pred, targets, y_score

    # ---------------------------------------------------------------- train
    def _open_writer(self) -> None:
        """Clear path_writer at the model's first train(), as gnn_tpu clears
        it at construction."""
        if not self._writer_opened:
            if os.path.exists(self.path_writer):
                shutil.rmtree(self.path_writer)
            self._writer_opened = True
        os.makedirs(self.path_writer, exist_ok=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, gTr, epochs: int, gVa=None, update_freq: int = 10,
              max_fails: int = 10, observed_metric: str = "Loss", policy: str = "min",
              *, mean: bool = True, verbose: int = 3,
              profile_dir: Optional[str] = None,
              nan_policy: str = "none", mesh=None,
              mesh_axis: Optional[str] = None,
              mesh_strategy: str = "data") -> None:
        """gnn_tpu's train (engine.py::BaseModel.train).

        :param gTr / gVa: Graphs, GraphBatches, lists of them, or (gTr) a
            GraphDataGenerator / SingleGraphDataGenerator, listed anew each
            epoch.
        :param profile_dir: a torch.profiler trace of the first epoch's
            batch loop is written there (trace.json, Chrome's format).
        :param nan_policy: 'none' (non-finite losses propagate), 'raise'
            (FloatingPointError on a non-finite training loss at an update
            epoch) or 'restore' (stop and restore the best-validation
            weights, or without gVa the weights before training).
        :param mesh / mesh_axis / mesh_strategy: multi-device training, not
            ported: a mesh raises NotImplementedError.
        """
        if verbose not in range(4):
            raise ValueError("param <verbose> not in [0,1,2,3]")
        if nan_policy not in ("none", "raise", "restore"):
            raise ValueError("param <nan_policy> not in ['none', 'raise', 'restore']")
        if mesh_strategy not in ("data", "edge", "node"):
            raise ValueError("param <mesh_strategy> not in ['data', 'edge', 'node']")
        if mesh is not None or mesh_strategy != "data":
            raise NotImplementedError(
                "train(mesh=...): data-, edge- and node-parallel training belong to gnn_tpu's "
                "parallel/ package (ROADMAP Queue 1, M11), not ported yet")

        def update_history(name, val):
            for key in val:
                self.history[f"{key} {name}"].append(val[key])

        def reset_validation(new_best):
            wst, wout = self.get_weights()
            return new_best, 0, wst, wout

        generator = None
        if isinstance(gTr, (GraphDataGenerator, SingleGraphDataGenerator)):
            generator = gTr
            gTr = self.checktype(list(generator))
        else:
            gTr = self.checktype(gTr)
        gVa = self.checktype(gVa)

        self._open_writer()
        if not self.history:
            keys = ["Epoch"] + [i + j for i in ["It", "Loss"] + list(self.extra_metrics)
                                for j in ([" Tr", " Va"] if gVa else [" Tr"])]
            if gVa:
                keys += ["Fail", f"Best {observed_metric} Va"]
            self.history.update({i: list() for i in keys})

        netS_writer = ScalarWriter(f"{self.path_writer}Net - State.jsonl")
        netO_writer = ScalarWriter(f"{self.path_writer}Net - Output.jsonl")
        training_writer = ScalarWriter(f"{self.path_writer}Training.jsonl")
        if gVa:
            if policy not in ("min", "max"):
                raise ValueError("param <policy> not in ['min', 'max']")
            best_valid_key = f"Best {observed_metric} Va"
            policy_function, valid_new = (np.less, 1e30) if policy == "min" else (np.greater, -1e30)
            if self.history.get(best_valid_key):
                valid_new = self.history[best_valid_key][-1]
            valid_best, valid_fails, ws, wo = reset_validation(valid_new)
            validation_writer = ScalarWriter(f"{self.path_writer}Validation.jsonl")
        if nan_policy == "restore" and not gVa:
            guard_ws, guard_wo = self.get_weights()

        initial_epoch = self.history["Epoch"][-1] + 1 if self.history["Epoch"] else 0
        epochs += initial_epoch
        edges_per_epoch = sum(int(b.n_real[1]) for b in gTr)

        e = initial_epoch
        try:
            for e in range(initial_epoch, epochs):
                prof = None
                if profile_dir and e == initial_epoch:
                    prof = self._start_profile()
                if generator is not None and e > initial_epoch:
                    gTr = self.checktype(list(generator))
                self._sync()
                t0 = time.perf_counter()
                for i, elem in enumerate(gTr):
                    self.training_step(elem, mean=mean)
                    if verbose > 2:
                        print(f" > Epoch {e:4d}/{epochs} \t\t> Batch {i + 1:4d}/{len(gTr)}",
                              end="\r")
                self._sync()
                dt = time.perf_counter() - t0
                training_writer.write_scalars(
                    {"EpochSeconds": dt, "EdgesPerSecond": edges_per_epoch / max(dt, 1e-9)}, e)
                if prof is not None:
                    prof.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

                if e % update_freq == 0:
                    metricsTr, *_ = self.evaluate(gTr)
                    self.history["Epoch"].append(e)
                    update_history("Tr", metricsTr)
                    training_writer.write_scalars(metricsTr, e)
                    for ns, net, leaves in self._weight_summaries():
                        (netS_writer if net == "N1" else netO_writer).write_weights(
                            ns, net, leaves, e)
                    tr_nonfinite = not np.isfinite(metricsTr["Loss"])

                if (e % update_freq == 0) and gVa:
                    metricsVa, *_ = self.evaluate(gVa)
                    valid_new = metricsVa[observed_metric]
                    if policy_function(valid_new, valid_best):
                        valid_best, valid_fails, ws, wo = reset_validation(valid_new)
                    else:
                        valid_fails += 1
                    self.history[best_valid_key].append(valid_best)
                    self.history["Fail"].append(valid_fails)
                    update_history("Va", metricsVa)
                    validation_writer.write_scalars(metricsVa, e)
                    if valid_fails >= max_fails:
                        if verbose in (1, 3):
                            self.printHistory()
                        print("\r Validation Stop")
                        break

                # after the validation block, so a stop never leaves the
                # history's columns of unequal lengths
                if (e % update_freq == 0) and nan_policy != "none" and tr_nonfinite:
                    msg = f"non-finite training loss at epoch {e}"
                    if nan_policy == "raise":
                        raise FloatingPointError(msg)
                    if not gVa:
                        self.set_weights(guard_ws, guard_wo)
                    if verbose > 0:
                        which = "best-validation" if gVa else "pre-training"
                        print(f"\r Divergence Stop ({msg}; {which} weights restored)")
                    break

                if (e % update_freq == 0) and verbose in (1, 3):
                    self.printHistory()
            else:
                if verbose > 0:
                    print("\r End of Epochs Stop")

            if gVa:
                self.set_weights(ws, wo)
            for ns, net, leaves in self._weight_summaries():
                (netS_writer if net == "N1" else netO_writer).write_weights(ns, net, leaves, e)
        finally:
            for w in (netS_writer, netO_writer, training_writer):
                w.close()
            if gVa:
                validation_writer.close()

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    # ----------------------------------------------------------------- test
    def test(self, gTe, *, rocdir: str = "", micro_and_macro: bool = False,
             prisofsdir: str = "", pos_label=0) -> dict:
        """Metrics over gTe; ROC and precision-recall figures saved to rocdir
        and prisofsdir when given."""
        metricsTe, y_true, y_pred, targets, y_score = self.evaluate(gTe)
        if rocdir:
            mt.ROC(targets, y_score, rocdir, micro_and_macro, pos_label=pos_label)
        if prisofsdir:
            mt.PRISOFS(targets, y_score, prisofsdir, pos_label=pos_label)
        return metricsTe

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path: str) -> None:
        """The whole training state in gnn_tpu's checkpoint folder: params,
        BatchNorm statistics, the optimizer's state under optax's names, the
        history, and the dropout-mask generator's state (so resumed training
        draws the masks an uninterrupted run would have drawn)."""
        from gnn_tpu_torch.convert import opt_state_to_jax, params_to_jax
        from gnn_tpu_torch.training.checkpoint import save_checkpoint
        params_np, bn_np = params_to_jax(self._ckpt_params(), self._ckpt_bn())
        save_checkpoint(path, params=params_np, bn=bn_np,
                        opt_state=opt_state_to_jax(self._opt, self._ckpt_params()),
                        history=self.history, mask_gen=self.mask_gen)

    def load_checkpoint(self, path: str) -> None:
        """Restore a save_checkpoint folder, the port's or gnn_tpu's, into this
        model. A gnn_tpu folder's JAX PRNG key cannot drive torch's
        generator and is ignored; the port's generator state is restored on
        a model of the same device type."""
        from gnn_tpu_torch.convert import opt_state_from_jax
        from gnn_tpu_torch.training.checkpoint import load_checkpoint
        params_np, bn_np, opt_state, history, gen_state, _ = load_checkpoint(path)
        self._ckpt_restore(params_np, bn_np)
        opt_state_from_jax(self._opt, self._ckpt_params(), opt_state)
        self.history = history
        if gen_state is not None and gen_state["device"] == self.mask_gen.device.type:
            self.mask_gen.set_state(torch.tensor(gen_state["state"], dtype=torch.uint8))

    # the trees a checkpoint holds (gnn_tpu engine.py:490-513): a model's
    # params and statistics, an LGNN's tuples of its layers'
    def _ckpt_params(self):
        return self.params

    def _ckpt_bn(self):
        return self.bn

    def _ckpt_restore(self, params_np, bn_np) -> None:
        """Install gnn_tpu's (params, bn) trees and a fresh optimizer."""
        self.set_params(params_np, bn_np)

    # ------------------------------------------------------------------ LKO
    def LKO(self, batches, epochs: int = 500, training_mode=None, update_freq: int = 10,
            max_fails: int = 10, observed_metric: str = "Loss", policy: str = "min",
            mean: bool = True, verbose: int = 3) -> dict:
        """Leave-K-Out: for each fold of prepare_LKO_data's (gTRs, gTEs, gVAs)
        a fresh copy of this model trains and is tested; {metric: [per fold]}."""
        metrics = {i: list() for i in list(self.extra_metrics) + ["It", "Loss"]}
        kwargs = {"training_mode": training_mode} if training_mode else {}
        n = len(batches[0])
        for i, (gTr, gTe, gVa) in enumerate(zip(*batches)):
            print(f"\nBATCH K-OUT {i + 1}/{n}")
            temp = self.copy(copy_weights=False, path_writer=f"{self.path_writer}{i}",
                             namespace=f"Batch {i + 1}-{n}")
            temp.train(gTr, epochs, gVa, update_freq, max_fails, observed_metric, policy,
                       mean=mean, verbose=verbose, **kwargs)
            res = temp.test(gTe)
            for m in res:
                metrics[m].append(res[m])
            if verbose > 1:
                print(f"\nRESULTS BATCH {i + 1}/{n}\n" + "\n".join(
                    f"{k:>24} {v}" for k, v in res.items()))
        return metrics
