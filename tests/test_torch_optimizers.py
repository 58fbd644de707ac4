"""The port's optimizers and learning-rate schedules (gnn_tpu_torch/training/
optimizers.py) against optax 0.2.6, which gnn_tpu's make_optimizer builds.

Each of the seven names takes 5 steps of one seeded gradient sequence on
tensors shaped like the flagship's leaves, from gnn_tpu's config (its
defaults), from a config that leaves every key but the learning rate out
(optax's defaults) and from configs that set optax's other keys; params after
every step and the optimizer states after the last agree to rtol 1e-6. Each
of the five schedules is held to optax's at counts 0..40; a schedule dict
drives make_optimizer; a flagship GNNgraphBased with adamw and with lion
takes 2 training steps as gnn_tpu's make_train_step does with the same
config and JAX-drawn masks; save/load keeps a schedule config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.models import core as jcore
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from gnn_tpu_torch.training import optimizers as topt
from test_torch_training import _graphs, _jax_masks, _spec_kw

torch.set_num_threads(1)
# leaves shaped like the flagship's: a state net (14 x 31, 14), its BatchNorm
# (14), a readout (2 x 14, 2)
SHAPES = {"w0": (14, 31), "b0": (14,), "gamma": (14,), "w1": (2, 14), "b1": (2,)}

CONFIGS = [(n, jopt.optimizer_config(n)) for n in sorted(jopt._DEFAULTS)]
CONFIGS += [(n + " (optax defaults)", {"name": n, "kwargs": {"learning_rate": 3e-3}})
            for n in sorted(jopt._DEFAULTS)]
CONFIGS += [
    ("adam nesterov", jopt.optimizer_config("adam", nesterov=True, eps_root=1e-9)),
    ("sgd momentum", jopt.optimizer_config("sgd", momentum=0.9)),
    ("sgd nesterov", jopt.optimizer_config("sgd", momentum=0.8, nesterov=True)),
    ("rmsprop centered", jopt.optimizer_config("rmsprop", centered=True, momentum=0.5,
                                               initial_scale=0.1)),
    ("rmsprop eps outside", jopt.optimizer_config("rmsprop", eps_in_sqrt=False,
                                                  bias_correction=True)),
    ("adagrad", jopt.optimizer_config("adagrad", initial_accumulator_value=0.0, eps=1e-3)),
    ("lamb decayed", jopt.optimizer_config("lamb", weight_decay=0.01, b2=0.99)),
    ("lion", jopt.optimizer_config("lion", b1=0.8, b2=0.9, weight_decay=0.0)),
]

# the state fields of optax's states (by name) and the port's per-tensor keys
STATE_KEYS = {"mu": "mu", "nu": "nu", "sum_of_squares": "sum", "trace": "trace"}


def _grads(seed=1, steps=5):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1, s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    grads[1]["b1"][:] = 0.0      # a zero gradient leaf (lamb's unit trust ratio)
    return p0, grads


def _optax_states(state, out=None):
    """{field: pytree} of the moment fields in an optax state."""
    out = {} if out is None else out
    if hasattr(state, "_fields"):
        for f in state._fields:
            v = getattr(state, f)
            if f in STATE_KEYS and isinstance(v, dict):
                out.setdefault(f, v)
            else:
                _optax_states(v, out)
    elif isinstance(state, (tuple, list)):
        for v in state:
            _optax_states(v, out)
    return out


def _run_both(cfg, steps=5):
    p0, grads = _grads(steps=steps)
    opt = jopt.make_optimizer(cfg)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(pj)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt_ = topt.make_optimizer(cfg, pt.values())
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, v in pt.items():
            v.grad = torch.from_numpy(g[k])
        topt_.step()
        for k in p0:
            np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    return pt, topt_, state


@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_optimizer_matches_optax(label, cfg):
    pt, topt_, state = _run_both(cfg)
    fields = _optax_states(state)
    assert fields or cfg["name"] == "sgd" and "momentum" not in cfg["kwargs"]
    for field, tree in fields.items():
        for k, p in pt.items():
            np.testing.assert_allclose(topt_.state[p][STATE_KEYS[field]].numpy(),
                                       np.asarray(tree[k]), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{field} {k}")
    assert topt_.param_groups[0]["count"] == 5


SCHEDULES = [
    ("cosine_decay", dict(init_value=1e-3, decay_steps=30)),
    ("cosine_decay", dict(init_value=2e-3, decay_steps=25, alpha=0.1, exponent=2.0)),
    ("exponential_decay", dict(init_value=1e-2, transition_steps=7, decay_rate=0.5)),
    ("exponential_decay", dict(init_value=1e-2, transition_steps=5, decay_rate=0.8,
                               transition_begin=3, staircase=True, end_value=4e-3)),
    ("warmup_cosine", dict(init_value=0.0, peak_value=1e-3, warmup_steps=5, decay_steps=30,
                           end_value=1e-5)),
    ("linear", dict(init_value=1e-3, end_value=1e-4, transition_steps=20)),
    ("linear", dict(init_value=0.0, end_value=1e-2, transition_steps=10, transition_begin=4)),
    ("constant", dict(value=5e-4)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in
                                                    enumerate(SCHEDULES)])
def test_schedule_matches_optax(name, kw):
    spec = {"name": name, "kwargs": kw}
    js, ts = jopt.make_schedule(spec), topt.make_schedule(spec)
    for count in range(41):
        np.testing.assert_allclose(float(ts(count)), float(js(count)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")
    assert topt.make_schedule(ts) is ts
    assert sorted(topt._SCHEDULES) == sorted(jopt._SCHEDULES)


@pytest.mark.parametrize("name", ["adam", "sgd", "lion"])
def test_schedule_dict_drives_make_optimizer(name):
    """The learning rate of each update is the schedule at optax's count."""
    cfg = jopt.optimizer_config(name, learning_rate={
        "name": "warmup_cosine", "kwargs": dict(init_value=0.0, peak_value=1e-2,
                                                warmup_steps=2, decay_steps=6)})
    pt, topt_, _ = _run_both(cfg, steps=6)
    assert callable(topt_.param_groups[0]["lr"])


def test_every_gnn_tpu_optimizer_is_built():
    """Nothing gnn_tpu's make_optimizer builds raises here; a name it does not
    know is refused by both."""
    p = [torch.zeros(3, requires_grad=True)]
    assert topt._DEFAULTS == jopt._DEFAULTS
    for name in jopt._DEFAULTS:
        assert isinstance(topt.make_optimizer(name, p), torch.optim.Optimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.optimizer_config("nadam")
    with pytest.raises(TypeError, match="unexpected"):
        topt.make_optimizer({"name": "adam", "kwargs": {"learning_rate": 1e-3, "beta": 1}}, p)


def _flagship(cfg, K=4):
    """(gnn_tpu's exact spec, params, BatchNorm state and batch; the port's
    batch and model with the same weights, optimizer `cfg`): the flagship's
    nets at small width (test_torch_training._spec_kw)."""
    jgs, tgs = _graphs(0)
    sk, ok = _spec_kw(0.15)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=0.01, aggregation="blocked")
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    jp, _ = jcore.gnn_init(js, jax.random.key(0))
    jbn = {"state": {"mean": jnp.full((5,), 0.1), "var": jnp.full((5,), 0.7)}, "output": {}}
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=cfg, max_iteration=K,
                          threshold=0.01, seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    return js, jp, jbn, jb, tb, model


@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_flagship_steps_match_gnn_tpu(name):
    """Two training steps of the flagship GNNgraphBased (the BatchNorm route)
    with adamw and with lion match gnn_tpu's make_train_step with the same
    config and JAX-drawn masks: params after each step."""
    cfg = jopt.optimizer_config(name, learning_rate=3e-3)
    js, jp, jbn, jb, tb, model = _flagship(cfg)
    step = jcore.make_train_step(js, "categorical_crossentropy", {}, cfg, mean=True)
    opt_state = jopt.make_optimizer(cfg).init(jp)
    for i in range(2):
        rng = jax.random.key(10 + i)
        with jax.default_matmul_precision("highest"):
            jp, jbn, opt_state, _ = step(jp, jbn, opt_state, jb, rng)
        model.training_step(tb, mean=True, masks=_jax_masks(js, tb.n_node_pad, rng))
        for net in ("state", "output"):
            for lname, leaves in model.params[net].items():
                for k, p in leaves.items():
                    got = p.detach().numpy()
                    got = got.T if k == "w" else got
                    np.testing.assert_allclose(got, np.asarray(jp[net][lname][k]), atol=2e-5,
                                               err_msg=f"step {i} {net}/{lname}/{k}")


def test_save_load_keeps_a_schedule(tmp_path):
    sched = {"name": "cosine_decay", "kwargs": {"init_value": 1e-3, "decay_steps": 100}}
    cfg = topt.optimizer_config("adamw", learning_rate=sched)
    model = _flagship(cfg)[-1]
    model.save(str(tmp_path / "m"))
    loaded = GNNgraphBased.load(str(tmp_path / "m"), device="cpu")
    assert loaded.optimizer_config == cfg
    assert callable(loaded._opt.param_groups[0]["lr"])
    assert loaded._opt.param_groups[0]["lr"](100) == topt.make_schedule(sched)(100)
