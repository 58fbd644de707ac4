"""The port's training engine (models/engine.py) against gnn_tpu's on the
CPU: the same graphs and initial weights (gnn_tpu's, carried across), nets
without dropout (tanh), trained by both packages' `train`.

Tolerances: the history's Epoch, It and Fail columns and the stop epoch
exactly; losses rtol 1e-5 (the port's plain kernels against gnn_tpu's XLA
body, float32); metrics equal; the restored weights within 1e-5. JSONL and
TensorBoard records are compared byte for byte with time.time pinned."""

import glob
import json
import os
import struct
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from gnn_tpu import GNNgraphBased as JGraphBased, GNNnodeBased as JNodeBased
from gnn_tpu import MLPSpec as JSpec, get_inout_dims
from gnn_tpu import metrics as jmt
from gnn_tpu.graphs.generator import GraphDataGenerator as JGen
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu.models import engine as jengine
from gnn_tpu_torch import GNNgraphBased, GNNnodeBased, MLPSpec
from gnn_tpu_torch import metrics as tmt
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs.generator import GraphDataGenerator as TGen
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import engine as tengine

torch.set_num_threads(1)
METRICS = ("Acc", "Fs")


def _data(focus, seed=0):
    """(gnn_tpu graphs, port graphs): 18 small graphs."""
    rng = np.random.default_rng(seed)
    if focus == "g":
        ts = tdata.mutag_shaped(seed=seed, n_graphs=18)
    else:
        ts = [tdata.random_graph(int(rng.integers(8, 14)), 3, 1, 2, 0.5, focus="n", rng=rng)
              for _ in range(18)]
    js = [JGraph(arcs=g.arcs, nodes=g.nodes, targets=g.targets, focus=g.focus,
                 node_graph=g.NodeGraph) for g in ts]
    return js, ts


def _split(gs, merge):
    """(gTr, gVa, gTe): two merged training batches, a validation and a test graph."""
    tr = [merge(gs[:6]), merge(gs[6:12])]
    return tr, merge(gs[12:15]), merge(gs[15:])


def _models(tmp_path, focus="g", bn=False, optimizer="adam", tag=""):
    nl, al = (14, 3) if focus == "g" else (3, 1)
    in_s, l_s = get_inout_dims("state", nl, al, 2, focus, 0, None)
    in_o, l_o = get_inout_dims("output", nl, al, 2, focus, 0, None)
    sk = dict(input_dim=in_s, units=tuple(l_s), activations="tanh", batch_normalization=bn)
    ok = dict(input_dim=in_o, units=tuple(l_o), activations="softmax",
              batch_normalization=False)
    kw = dict(optimizer=optimizer, max_iteration=4, threshold=0.01)
    J, T = (JGraphBased, GNNgraphBased) if focus == "g" else (JNodeBased, GNNnodeBased)
    jm = J(JSpec(**sk), JSpec(**ok), **kw, path_writer=str(tmp_path / f"jw{tag}"), seed=0,
           extra_metrics={k: jmt.Metrics[k] for k in METRICS})
    tm = T(MLPSpec(**sk), MLPSpec(**ok), **kw, path_writer=str(tmp_path / f"tw{tag}"), seed=0,
           device="cpu", extra_metrics={k: tmt.Metrics[k] for k in METRICS})
    tm.set_params(*jax.tree_util.tree_map(np.asarray, (jm.params, jm.bn)))
    return jm, tm


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _flat(tree[k], f"{prefix}['{k}']").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree) for k2, v in _flat(x, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(tree)}


def same_history(got, want):
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        if k in ("Epoch", "Fail") or k.startswith("It "):
            assert got[k] == want[k], k
        elif k.startswith(METRICS):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def same_opt_state(got, want):
    """Optimizer states under optax's names: counts equal, moments (running
    grads) within the grads' bound, rtol 2e-4 with a floor of 2e-5 of each
    tensor's largest entry."""
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k].dtype == np.int32:
            assert int(got[k]) == int(want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=2e-5 * float(np.abs(want[k]).max()), err_msg=k)


def same_weights(tm, jm, atol=1e-5):
    got, want = _flat(tm.get_weights()), _flat(jm.get_weights())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("focus,bn,observed,policy", [
    ("g", False, "Loss", "max"), ("g", True, "Loss", "min"), ("g", True, "Acc", "max"),
    ("n", False, "Loss", "min")])
def test_train_matches_gnn_tpu(focus, bn, observed, policy, tmp_path):
    js, ts = _data(focus)
    jm, tm = _models(tmp_path, focus, bn)
    (jtr, jva, _), (ttr, tva, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    kw = dict(update_freq=1, max_fails=2, observed_metric=observed, policy=policy, verbose=0)
    jm.train(jtr, 6, jva, **kw)
    tm.train(ttr, 6, tva, **kw)
    same_history(tm.history, jm.history)
    if policy == "max" and observed == "Loss":
        assert len(jm.history["Epoch"]) < 6      # a validation stop
    same_weights(tm, jm)                         # the best-validation weights
    for name in ("Net - State.jsonl", "Net - Output.jsonl", "Training.jsonl",
                 "Validation.jsonl"):
        assert os.path.exists(os.path.join(tm.path_writer, name))
    # history columns of equal length; the engine's evaluate reproduces the best loss
    assert len({len(v) for v in tm.history.values()}) == 1
    best = tm.evaluate(tva)[0][observed]
    assert abs(best - tm.history[f"Best {observed} Va"][-1]) <= 1e-6 * abs(best)


def test_update_freq_and_resume_numbering(tmp_path):
    js, ts = _data("g", seed=1)
    jm, tm = _models(tmp_path)
    (jtr, _, _), (ttr, _, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    for m, tr in ((jm, jtr), (tm, ttr)):
        m.train(tr, 5, update_freq=2, verbose=0)
        m.train(tr, 3, update_freq=2, verbose=0)     # resumes at epoch 5 (the last + 1)
    assert tm.history["Epoch"] == jm.history["Epoch"] == [0, 2, 4, 6]
    same_history(tm.history, jm.history)
    same_weights(tm, jm)


def test_generator_input_is_listed_each_epoch(tmp_path):
    js, ts = _data("g", seed=2)
    jm, tm = _models(tmp_path)
    jm.train(JGen(js[:12], batch_size=5, rng=3), 3, update_freq=1, verbose=0)
    tm.train(TGen(ts[:12], batch_size=5, rng=3), 3, update_freq=1, verbose=0)
    same_history(tm.history, jm.history)
    same_weights(tm, jm)


def _poison(jm, tm):
    w = np.asarray(jm.params["state"]["dense_0"]["w"]).copy()
    w[0, 0] = np.nan
    jm.params["state"]["dense_0"]["w"] = jax.numpy.asarray(w)
    with torch.no_grad():
        tm.params["state"]["dense_0"]["w"][0, 0] = float("nan")


@pytest.mark.parametrize("policy", ("none", "raise", "restore", "restore_va"))
def test_nan_policy_matches(policy, tmp_path):
    js, ts = _data("g", seed=3)
    jm, tm = _models(tmp_path)
    _poison(jm, tm)
    (jtr, jva, _), (ttr, tva, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    kw = dict(update_freq=1, verbose=0, nan_policy=policy.replace("_va", ""))
    runs = ((jm, jtr, jva if policy == "restore_va" else None),
            (tm, ttr, tva if policy == "restore_va" else None))
    if policy == "raise":
        for m, tr, va in runs:
            with pytest.raises(FloatingPointError, match="non-finite"):
                m.train(tr, 3, va, **kw)
        return
    snap = tm.get_weights()
    for m, tr, va in runs:
        m.train(tr, 3, va, **kw)
    assert tm.history["Epoch"] == jm.history["Epoch"]
    assert len({len(v) for v in tm.history.values()}) == 1
    if policy == "restore":
        assert tm.history["Epoch"] == [0]
        got, want = _flat(tm.get_weights()), _flat(snap)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    if policy == "none":
        assert len(tm.history["Epoch"]) == 3


def test_copy_and_test(tmp_path):
    js, ts = _data("g", seed=4)
    jm, tm = _models(tmp_path)
    (jtr, _, jte), (ttr, _, tte) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    jm.train(jtr, 2, update_freq=1, verbose=0)
    tm.train(ttr, 2, update_freq=1, verbose=0)
    for m in (jm, tm):
        c = m.copy()
        assert c.path_writer == m.path_writer[:-1] + "_copied/"
        assert c.namespace == ["GNN"] and c.history == {}
        assert c.extra_metrics is m.extra_metrics and c.optimizer_config == m.optimizer_config
        assert (c.state_vect_dim, c.max_iteration, c.state_threshold) == (0, 4, 0.01)
        assert m.copy(path_writer=str(tmp_path / "x"), namespace="N").namespace == ["N"]
    c = tm.copy()
    same_weights(c, jm)
    assert c._opt.state == {} and c._opt.param_groups[0]["count"] == 0
    fresh = tm.copy(copy_weights=False)
    assert any(not np.allclose(a, b) for a, b in zip(_flat(fresh.get_weights()).values(),
                                                       _flat(tm.get_weights()).values()))
    want = jm.test(jte)
    got = tm.test(tte, rocdir=str(tmp_path / "roc.png"), prisofsdir=str(tmp_path / "pr.png"),
                  micro_and_macro=True)
    assert list(got) == list(want) and got["It"] == want["It"]
    np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=1e-5)
    assert all(got[k] == want[k] for k in METRICS)
    assert os.path.getsize(tmp_path / "roc.png") > 0 and os.path.getsize(tmp_path / "pr.png") > 0
    # evaluate_single_graph: the selected rows, host numpy
    it, loss, targs, outs = tm.evaluate_single_graph(tte, training=False)
    assert targs.shape == outs.shape == (3, 2) and isinstance(loss, float)
    assert tm.trainable_variables()[0][0] is tm.params["state"]


def test_lko_folds(tmp_path):
    from gnn_tpu_torch.graphs.utils import prepare_LKO_data
    _, ts = _data("g", seed=5)
    _, tm = _models(tmp_path)
    folds = prepare_LKO_data(ts, focus="g", number_of_batches=3, useVa=True, seed=5)
    res = tm.LKO(folds, epochs=2, update_freq=1, verbose=0)
    assert sorted(res) == sorted(METRICS + ("It", "Loss"))
    assert all(len(v) == 3 and np.all(np.isfinite(v)) for v in res.values())
    for i in range(3):
        assert os.path.isdir(f"{tm.path_writer}{i}/")


def _records(path):
    """(payloads) of a TFRecord file."""
    data, out, i = open(path, "rb").read(), [], 0
    while i < len(data):
        n = struct.unpack("<Q", data[i:i + 8])[0]
        out.append(data[i + 12:i + 12 + n])
        i += 12 + n + 4
    return out


def test_writers_write_gnn_tpus_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    rng = np.random.default_rng(6)
    leaves = [("['bn']['beta']", rng.random(3).astype(np.float32)),
              ("['dense_0']['b']", rng.random(3).astype(np.float32)),
              ("['dense_0']['w']", rng.random((4, 3)).astype(np.float32)),
              ("['odd']", np.full((2,), 0.5, np.float32))]
    for mod, name in ((jengine, "j"), (tengine, "t")):
        w = mod.ScalarWriter(str(tmp_path / name / "Training.jsonl"))
        w.write_scalars({"Loss": 0.125, "Acc": 0.5, "EpochSeconds": 1.5, "X": 2}, 3)
        w.write_weights("GNN", "N1", leaves, 3)
        w.close()
    assert (tmp_path / "t" / "Training.jsonl").read_text() == \
        (tmp_path / "j" / "Training.jsonl").read_text()
    (jf,), (tf,) = (glob.glob(str(tmp_path / n / "Training" / "events.out.tfevents.*"))
                    for n in ("j", "t"))
    assert _records(tf) == _records(jf) and len(_records(tf)) == 9


def test_train_logs_the_same_records(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    js, ts = _data("g", seed=7)
    jm, tm = _models(tmp_path, bn=True)
    (jtr, jva, _), (ttr, tva, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    jm.train(jtr, 2, jva, update_freq=1, verbose=0)
    tm.train(ttr, 2, tva, update_freq=1, verbose=0)
    for name in ("Net - State.jsonl", "Net - Output.jsonl", "Training.jsonl",
                 "Validation.jsonl"):
        got = [json.loads(x) for x in open(os.path.join(tm.path_writer, name))]
        want = [json.loads(x) for x in open(os.path.join(jm.path_writer, name))]
        assert [(r["step"], r["scope"], r["name"]) for r in got] == \
            [(r["step"], r["scope"], r["name"]) for r in want], name
        for a, b in zip(got, want):
            if a["name"] in ("EpochSeconds", "EdgesPerSecond"):
                continue
            for k in set(a) - {"step", "scope", "name"}:
                assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (name, a, b)
    edges = sum(g.n_arcs for g in ts[:12])
    secs = [r for r in map(json.loads, open(os.path.join(tm.path_writer, "Training.jsonl")))
            if r["name"] in ("EpochSeconds", "EdgesPerSecond")]
    for s, e in zip(secs[::2], secs[1::2]):
        assert s["value"] > 0 and abs(e["value"] * s["value"] - edges) <= 1e-6 * edges


def test_history_files_match_pandas(tmp_path):
    js, ts = _data("g", seed=8)
    _, tm = _models(tmp_path)
    (_, _, _), (ttr, tva, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    tm.train(ttr, 3, tva, update_freq=1, verbose=0)
    tm.history["Flag"] = [True, False, True]
    tm.saveHistory_csv(str(tmp_path / "h"))
    assert (tmp_path / "h.csv").read_text() == pd.DataFrame(tm.history).to_csv(index=False)
    tm.saveHistory_txt(str(tmp_path / "h"))
    got = (tmp_path / "h.txt").read_text().splitlines()
    want = pd.DataFrame(tm.history).to_string(index=False).splitlines()
    assert got[0].split() == want[0].split()
    for a, b in zip(got[1:], want[1:]):
        for x, y in zip(a.split(), b.split()):
            if y in ("True", "False"):
                assert x == y
            else:
                assert abs(float(x) - float(y)) <= 5e-6 * max(1.0, abs(float(y)))
    tm.printHistory()


def test_mesh_and_profile(tmp_path):
    js, ts = _data("g", seed=9)
    _, tm = _models(tmp_path)
    (_, _, _), (ttr, _, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    for kw in ({"mesh": object()}, {"mesh_strategy": "edge"}):
        with pytest.raises(NotImplementedError, match="M11"):
            tm.train(ttr, 1, verbose=0, **kw)
    with pytest.raises(ValueError, match="mesh_strategy"):
        tm.train(ttr, 1, verbose=0, mesh_strategy="ring")
    tm.train(ttr, 2, verbose=0, profile_dir=str(tmp_path / "prof"))
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


def test_path_writer_cleared_at_the_first_train(tmp_path):
    """gnn_tpu clears path_writer when a model is built; the port when the
    model's first train() opens it (ROADMAP "Not faults")."""
    js, ts = _data("g", seed=10)
    _, tm = _models(tmp_path)
    os.makedirs(tm.path_writer, exist_ok=True)
    stale = os.path.join(tm.path_writer, "stale.jsonl")
    open(stale, "w").close()
    _models(tmp_path, tag="")                       # another model on the same folder
    assert os.path.exists(stale)
    (_, _, _), (ttr, _, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    tm.train(ttr, 1, verbose=0)
    assert not os.path.exists(stale)
    n = len(open(os.path.join(tm.path_writer, "Training.jsonl")).readlines())
    tm.train(ttr, 1, verbose=0)                     # a second train appends
    assert len(open(os.path.join(tm.path_writer, "Training.jsonl")).readlines()) > n
