"""Checkpoints across the packages: a gnn_tpu checkpoint resumed by the port
and a port checkpoint resumed by gnn_tpu give the same next two epochs as
the package that wrote it (params within 1e-5, history as
test_torch_engine holds it), for gnn_tpu's seven optimizers and Adam on a
cosine schedule. The optimizer state's names and shapes equal optax's
(convert.opt_state_to_jax), and the port's dropout-mask generator resumes
where it stopped."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu.training.optimizers import make_optimizer, optimizer_config
from gnn_tpu_torch.convert import opt_state_from_jax, opt_state_to_jax
from gnn_tpu_torch.graphs.graph import Graph as TGraph

from test_torch_engine import (_data, _models, _split, same_history, same_opt_state,
                               same_weights)

torch.set_num_threads(1)

COSINE = {"name": "cosine_decay", "kwargs": {"init_value": 1e-2, "decay_steps": 6}}
CONFIGS = {name: optimizer_config(name) for name in
           ("adam", "adamw", "sgd", "rmsprop", "adagrad", "lamb", "lion")}
CONFIGS["adam_cosine"] = optimizer_config("adam", learning_rate=COSINE)


@pytest.mark.parametrize("writer", ("gnn_tpu", "port"))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_resume_from_the_other_package(name, writer, tmp_path):
    js, ts = _data("g", seed=11)
    cfg = CONFIGS[name]
    jm, tm = _models(tmp_path, bn=True, optimizer=cfg)
    (jtr, jva, _), (ttr, tva, _) = _split(js, JGraph.merge), _split(ts, TGraph.merge)
    kw = dict(update_freq=1, max_fails=10, verbose=0)
    first, second = (jm, tm) if writer == "gnn_tpu" else (tm, jm)
    first.train(jtr if first is jm else ttr, 2, jva if first is jm else tva, **kw)
    first.save_checkpoint(str(tmp_path / "ck"))
    second.load_checkpoint(str(tmp_path / "ck"))
    assert second.history == json.loads(json.dumps(first.history))
    same_weights(tm, jm, atol=0.0)
    jm.train(jtr, 2, jva, **kw)
    tm.train(ttr, 2, tva, **kw)
    assert tm.history["Epoch"] == [0, 1, 2, 3]
    same_history(tm.history, jm.history)
    same_weights(tm, jm)
    same_opt_state(opt_state_to_jax(tm._opt, tm.params), _jax_flat(jm.opt_state))


def _jax_flat(state):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(state)}


VARIANTS = [("adam", {}), ("adamw", {}), ("sgd", {}), ("sgd", {"momentum": 0.9}),
            ("sgd", {"momentum": 0.9, "nesterov": True}), ("rmsprop", {}),
            ("rmsprop", {"centered": True}), ("rmsprop", {"momentum": 0.9}),
            ("rmsprop", {"bias_correction": True, "initial_scale": 0.5}),
            ("adagrad", {"initial_accumulator_value": 0.3}), ("lamb", {}), ("lion", {})]


@pytest.mark.parametrize("schedule", (False, True))
@pytest.mark.parametrize("name,kw", VARIANTS)
def test_optimizer_state_names_match_optax(name, kw, schedule, tmp_path):
    if schedule:
        kw = dict(kw, learning_rate=COSINE)
    cfg = optimizer_config(name, **kw)
    jm, tm = _models(tmp_path, bn=True, optimizer=cfg)
    want = _jax_flat(make_optimizer(cfg).init(jm.params))
    got = opt_state_to_jax(tm._opt, tm.params)     # before any step: initial values
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    # a state with values round-trips through the port's optimizer
    rng = np.random.default_rng(0)
    filled = {k: (np.asarray(7, np.int32) if v.dtype == np.int32
                  else rng.random(v.shape).astype(np.float32)) for k, v in want.items()}
    opt_state_from_jax(tm._opt, tm.params, filled)
    back = opt_state_to_jax(tm._opt, tm.params)
    for k in want:
        np.testing.assert_array_equal(back[k], filled[k])


def test_mask_generator_resumes_and_gnn_tpu_keys_are_ignored(tmp_path):
    _, ts = _data("g", seed=12)
    from gnn_tpu_torch import GNNgraphBased, MLPSpec, get_inout_dims
    in_s, l_s = get_inout_dims("state", 14, 3, 2, "g", 0, None)
    in_o, l_o = get_inout_dims("output", 14, 3, 2, "g", 0, None)
    specs = (MLPSpec(input_dim=in_s, units=tuple(l_s), activations="selu",
                     dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=True),
             MLPSpec(input_dim=in_o, units=tuple(l_o), activations="softmax",
                     dropout_rate=(0.1,), dropout_pos=(0,)))

    def model(seed, w):
        return GNNgraphBased(*specs, seed=seed, device="cpu", path_writer=str(tmp_path / w))
    a = model(0, "a")
    gb = a.to_batch(ts[:6])
    a.train(gb, 2, update_freq=1, verbose=0)
    a.save_checkpoint(str(tmp_path / "ck"))
    b = model(1, "b")
    b.load_checkpoint(str(tmp_path / "ck"))
    drawn = {}
    for m in (a, b):
        def record(spec, g, gen, _m=m):
            masks = type(_m)._draw_masks(spec, g, gen)
            drawn.setdefault(id(_m), []).append(masks)
            return masks
        m._draw_masks = record
        m.train(gb, 1, update_freq=1, verbose=0)
    (ma,), (mb,) = drawn[id(a)], drawn[id(b)]
    for net in ("state", "output"):
        for pos in ma[net]:
            assert torch.equal(ma[net][pos], mb[net][pos])
    for (k, p), (_, q) in zip(a.get_weights()[0][0][0]["dense_0"].items(),
                              b.get_weights()[0][0][0]["dense_0"].items()):
        np.testing.assert_allclose(p, q, atol=1e-6)
    # a gnn_tpu manifest's JAX key is ignored; the model's generator stays as it was
    man = json.load(open(tmp_path / "ck" / "manifest.json"))
    assert man["torch_mask_generator"]["device"] == "cpu"
    man.pop("torch_mask_generator")
    man["rng_key_data"], man["rng_impl"] = [0, 42], "fry"
    json.dump(man, open(tmp_path / "ck" / "manifest.json", "w"))
    c = model(2, "c")
    state = c.mask_gen.get_state().clone()
    c.load_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(c.mask_gen.get_state(), state)
    assert os.path.exists(tmp_path / "ck" / "opt_state.npz")
