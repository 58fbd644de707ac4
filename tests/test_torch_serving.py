"""gnn_tpu_torch's Predictor on the CPU against gnn_tpu's Predictor: the same
graphs and weights must give the same per-graph outputs (atol 3e-5, gnn_tpu's
bound for its kernels' hi/lo f32 emulation) and the batch cache must count
its hits."""

import jax
import numpy as np
import pytest
import torch

import gnn_tpu
from gnn_tpu.graphs import datasets as jdata
from gnn_tpu.serving import Predictor as JPredictor
import gnn_tpu_torch
from gnn_tpu_torch import Predictor
from gnn_tpu_torch.graphs import datasets as tdata

torch.set_num_threads(1)
ATOL = 3e-5


def _models(tmp_path, focus, act="tanh", bn=False, nl=3, al=1, dt=2):
    in_s, l_s = gnn_tpu.get_inout_dims("state", nl, al, dt, focus, 0, None)
    in_o, l_o = gnn_tpu.get_inout_dims("output", nl, al, dt, focus, 0, None)
    spec = dict(input_dim=in_s, units=tuple(l_s), activations=act, batch_normalization=bn)
    ospec = dict(input_dim=in_o, units=tuple(l_o), activations="softmax",
                 batch_normalization=False)
    klass = {"n": "GNNnodeBased", "a": "GNNedgeBased", "g": "GNNgraphBased"}[focus]
    jm = getattr(gnn_tpu, klass)(
        net_state=gnn_tpu.MLPSpec(**spec), net_output=gnn_tpu.MLPSpec(**ospec),
        optimizer={"name": "adam", "kwargs": {"learning_rate": 1e-3}},
        loss_function="categorical_crossentropy", loss_arguments={"from_logits": False},
        max_iteration=4, threshold=0.01, path_writer=str(tmp_path / "w"), seed=0)
    tm = getattr(gnn_tpu_torch, klass)(gnn_tpu_torch.MLPSpec(**spec),
                                       gnn_tpu_torch.MLPSpec(**ospec), max_iteration=4,
                                       threshold=0.01, device="cpu")
    tm.set_params(*jax.tree_util.tree_map(np.asarray, (jm.params, jm.bn)))
    return jm, tm


def _graphs(seed, focus, n, nl=3, al=1, big=False):
    out = []
    for mod in (jdata, tdata):
        rng = np.random.default_rng(seed)
        gs = [mod.random_graph(int(rng.integers(10, 25)), nl, al, 2, 0.6, focus=focus, rng=rng)
              for _ in range(n)]
        if big:
            gs.append(mod.random_graph(75, nl, al, 2, 0.1, focus=focus, rng=rng))
        out.append(gs)
    return out


@pytest.mark.parametrize("focus", ["n", "a", "g"])
def test_predict_matches_gnn_tpu(tmp_path, focus):
    jm, tm = _models(tmp_path, focus)
    jgs, tgs = _graphs(0, focus, 5, big=True)
    jp, tp = JPredictor(jm, block_w=32), Predictor(tm, block_w=32, device="cpu")
    want, got = jp.predict(jgs), tp.predict(tgs)
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)
    # single-graph requests, including the one spanning several blocks
    for i in (0, 5):
        w, g = jp.predict(jgs[i]), tp.predict(tgs[i])
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)
    np.testing.assert_allclose(tp.predict(tgs, split=False),
                               np.concatenate(got, axis=0), atol=0)


def test_predict_with_batchnorm_selu(tmp_path):
    jm, tm = _models(tmp_path, "g", act="selu", bn=True, nl=5, al=3)
    jgs, tgs = _graphs(1, "g", 8, nl=5, al=3, big=True)
    want = JPredictor(jm, block_w=32).predict(jgs)
    got = Predictor(tm, block_w=32, device="cpu").predict(tgs)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_batch_cache_and_buckets(tmp_path):
    _, tm = _models(tmp_path, "n")
    _, tgs = _graphs(2, "n", 6)
    pred = Predictor(tm, block_w=32, device="cpu")
    assert pred.warmup([tgs[:3]]) == 1
    assert pred.stats["buckets"] == 1 and pred.stats["last_cold_s"] is not None
    first = pred.predict(tgs[:3])
    assert pred.stats["batch_cache_hits"] == 1 and pred.stats["bucket_hits"] == 1
    assert pred.stats["last_ms"] is not None and pred.stats["last_iters"] is not None
    again = pred.predict(tgs[:3])
    assert pred.stats["batch_cache_hits"] == 2 and pred.stats["requests"] == 2
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    pred.predict(tgs[3:])                       # new graphs: a miss, same bucket
    assert pred.stats["batch_cache_hits"] == 2 and pred.stats["bucket_hits"] == 3
    pending = pred.predict_async(tgs[3:])
    for a, b in zip(pending.result(), pred.predict(tgs[3:])):
        np.testing.assert_array_equal(a, b)

    small = Predictor(tm, block_w=32, cache_batches=2, device="cpu")
    for req in (tgs[:1], tgs[1:2], tgs[2:3], tgs[:1]):
        small.predict(req)
    assert small.stats["batch_cache_hits"] == 0 and len(small._batch_cache) == 2
    off = Predictor(tm, block_w=32, cache_batches=0, device="cpu")
    off.predict(tgs[:2])
    off.predict(tgs[:2])
    assert off.stats["batch_cache_hits"] == 0 and len(off._batch_cache) == 0


def test_bad_requests_raise(tmp_path):
    _, tm = _models(tmp_path, "n")
    pred = Predictor(tm, block_w=32, device="cpu")
    with pytest.raises(ValueError, match="empty request"):
        pred.predict([])
    g = tdata.random_graph(12, 3, 1, 2, 0.5, focus="g", rng=0)
    with pytest.raises(ValueError, match="focus"):
        pred.predict(g)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor(tm)
