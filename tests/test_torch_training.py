"""gnn_tpu_torch's training step against gnn_tpu's, on the CPU.

The same graphs and weights (drawn by gnn_tpu, carried across with
convert.params_from_jax) go through one optimizer step in both packages.
Dropout keep-masks are drawn with jax.random along gnn_tpu's own key chain
and passed to the port, which cannot reproduce JAX's PRNG. The port runs the
BN training kernels' plain versions through gnn_tpu's dispatch.

Tolerances (ROADMAP "Exactness contract", tests/test_fused.py): realised
iteration counts equal; states atol 3e-5; grads rtol 2e-4 (atol 1e-6 for
entries near 0); BatchNorm statistics atol 1e-5; the loss rtol 1e-5; the
params after one Adam step atol 2e-6, since a first Adam step moves a param
by lr * g / (|g| + eps) and so turns a grad's relative error into at most
lr times it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs import datasets as jdata
from gnn_tpu.models import core as jcore
from gnn_tpu.models.gnn import GNNgraphBased as JGraph
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.training import losses as jlosses
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from gnn_tpu_torch.training import losses as tlosses
from gnn_tpu_torch.training import optimizers as topt

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("name,kw", [
    ("categorical_crossentropy", {}), ("categorical_crossentropy", {"from_logits": True}),
    ("binary_crossentropy", {}), ("binary_crossentropy", {"from_logits": True}),
    ("mse", {}), ("mae", {}), ("huber", {"delta": 0.7}), ("hinge", {})])
def test_losses_match(name, kw):
    rng = np.random.default_rng(0)
    target = rng.random((9, 3)).astype(np.float32)
    if "from_logits" in kw or name in ("mse", "mae", "huber", "hinge"):
        out = rng.standard_normal((9, 3)).astype(np.float32)
    else:
        out = rng.random((9, 3)).astype(np.float32)
        # rows far from probabilities: about-zero and negative sums (a BN
        # after the softmax), where the clip comes before the renormalisation
        out[0] = [1e-9, -0.3, 2e-9]
        out[1] = [-0.2, -0.1, 0.05]
    want = jlosses.get_loss(name)(jnp.asarray(target), jnp.asarray(out), **kw)
    got = tlosses.get_loss(name)(torch.from_numpy(target), torch.from_numpy(out), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert sorted(tlosses.LOSSES) == sorted(jlosses.LOSSES)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("cfg", [jopt.optimizer_config("adam"),
                                 jopt.optimizer_config("adam", lr=3e-3, beta_1=0.8),
                                 {"name": "adam", "kwargs": {"learning_rate": 1e-3}}])
def test_adam_matches_optax(cfg):
    assert topt.optimizer_config("adam") == jopt.optimizer_config("adam")
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-8, 1, v.shape))
              .astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    opt = jopt.make_optimizer(cfg)
    pj, state = {k: jnp.asarray(v) for k, v in p0.items()}, None
    state = opt.init(pj)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt_ = topt.make_optimizer(cfg, pt.values())
    for g in grads:
        for k, v in pt.items():
            v.grad = torch.from_numpy(g[k])
        topt_.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=1e-6,
                                   atol=1e-7)


def test_unported_optimizers_raise():
    """(The name is from when only Adam was ported.) sgd, adamw and rmsprop
    build and take a step (tests/test_torch_optimizers.py holds every name to
    optax); an unknown name is still refused."""
    p = [torch.zeros(2, requires_grad=True)]
    for name in ("sgd", "adamw", "rmsprop"):
        opt = topt.make_optimizer(name, p)
        p[0].grad = torch.ones(2)
        opt.step()
        assert torch.isfinite(p[0]).all() and (p[0] != 0).all()
        with torch.no_grad():
            p[0].zero_()
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.optimizer_config("nadam")


# ------------------------------------------------------------ train step
def _graphs(seed):
    """Both packages' graphs from one seed: 12 small graphs and one 70-node
    graph, which spans several 32-node blocks (residual arcs, dep blocks)."""
    out = []
    for mod in (jdata, tdata):
        rng = np.random.default_rng(seed)
        gs = [mod.random_graph(int(rng.integers(8, 30)), 5, 3, 2, 0.5, focus="g", rng=rng)
              for _ in range(12)]
        gs.insert(3, mod.random_graph(70, 5, 3, 2, 0.2, focus="g", rng=rng))
        out.append(gs)
    return out


def _spec_kw(state_drop=0.15):
    """The flagship's nets at small width: selu state net with AlphaDropout at
    the input and the trailing BatchNorm; softmax readout with dropout."""
    sdrop = dict(dropout_rate=(state_drop,), dropout_pos=(0,), alphadropout=True) \
        if state_drop else {}
    sk = dict(input_dim=13, units=(5,), activations="selu", kernel_initializer="lecun_normal",
              bias_initializer="lecun_normal", batch_normalization=True, **sdrop)
    ok = dict(input_dim=5, units=(2,), activations="softmax", kernel_initializer="glorot_normal",
              bias_initializer="glorot_normal", dropout_rate=(0.1,), dropout_pos=(0,),
              batch_normalization=False)
    return sk, ok


def _jax_masks(js, Np, rng):
    """The keep-masks gnn_tpu draws in one training forward, along its key
    chain: gnn_forward splits (rng, rng_prop, rng_out) (core.py:1017);
    propagate splits rng_prop into (rng, rng_init, rng_loop) (:316) and
    rng_loop into K step keys (:338); each dropout layer takes
    split(key)[1] (mlp.py:252-256; pallas_bn.py:1044-1049)."""
    _, rng_prop, rng_out = jax.random.split(rng, 3)
    _, _, rng_loop = jax.random.split(rng_prop, 3)
    steps = jax.random.split(rng_loop, js.max_iteration)

    def keep(key, spec, rows):
        rate = spec.dropout_rate[0]
        return np.asarray(jax.random.bernoulli(jax.random.split(key)[1], 1.0 - rate,
                                               (rows, spec.input_dim)))

    masks = {"state": {}, "output": {0: torch.tensor(keep(rng_out, js.output_spec, Np))}}
    if js.state_spec.dropout_rate:
        masks["state"][0] = torch.tensor(np.stack([keep(k, js.state_spec, Np) for k in steps]))
    return masks


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("threshold,state_drop", [(0.01, 0.15), (0.4, 0.15), (1.5, 0.15),
                                                  (1e9, 0.15), (0.01, 0.0)])
def test_training_step_matches_gnn_tpu(threshold, state_drop):
    """One step of the port's flagship-shaped model (dispatched to K1/K2,
    plain versions on the CPU) against gnn_tpu's make_train_step on its exact
    f32 body (aggregation='blocked', highest matmul precision), which draws
    the same masks; and gnn_tpu's own K1/K2 path, in interpret mode, against
    the port within gnn_tpu's bound for those kernels against that body
    (states atol 2e-4, tests/test_fused.py:749): its bf16 hi/lo emulation
    alone is 3.6e-5 off f32 on this batch."""
    K = 4
    jgs, tgs = _graphs(0)
    sk, ok = _spec_kw(state_drop)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=threshold, aggregation="auto")
    exact = dataclasses.replace(js, aggregation="blocked")
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    assert tb.adj_dep is not None and tb.n_node_pad == jb.n_node_pad
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    jbn = {"state": {"mean": jnp.full((5,), 0.1), "var": jnp.full((5,), 0.7)}, "output": {}}
    rng = jax.random.key(3)
    opt_cfg = jopt.optimizer_config("adam")

    with jax.default_matmul_precision("highest"):
        # the grads as _train_step_body forms them, then the jitted step
        @jax.jit
        def grads_fn(p):
            def f(p):
                iters, loss, res = jcore.evaluate_single(exact, p, jbn, jb, rng, LOSS, {},
                                                         training=True)
                return loss + jcore.regularization(exact, p), (iters, loss, res)
            return jax.grad(f, has_aux=True)(p)

        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
        step = jcore.make_train_step(exact, LOSS, {}, opt_cfg, mean=True)
        p_j, bn_j, _, iters_s = step(jp, jbn, jopt.make_optimizer(opt_cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    kern = jax.jit(lambda p: jcore.gnn_forward(js, p, jbn, jb, rng, training=True))(jp)
    assert float(iters_s) == float(iters_j) == float(kern["iters"])

    # the port, same weights and masks
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=opt_cfg, max_iteration=K,
                          threshold=threshold, seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    masks = _jax_masks(js, tb.n_node_pad, rng)
    with torch.no_grad():
        iters_t, loss_t, res_t = tcore.evaluate_single(model.spec, model.params, model.bn, tb,
                                                       LOSS, {}, training=True, masks=masks)
    assert tcore._train_route(model.spec, tb) == "bn"                     # the K1/K2 route
    tbn.reset_launches()
    out = model.training_step(tb, mean=True, masks=masks)
    assert not any(tbn.launches.values())   # plain on the CPU

    assert float(out["iters"]) == float(iters_t) == float(iters_j)
    if threshold == 1e9:
        assert float(iters_j) == 0.0
    np.testing.assert_allclose(_np(res_t["state"]), np.asarray(res_j["state"]), atol=3e-5)
    np.testing.assert_allclose(_np(res_t["state"]), np.asarray(kern["state"]), atol=2e-4)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(_np(model.bn["state"][key]), np.asarray(bn_j["state"][key]),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(model.bn["state"][key]),
                                   np.asarray(kern["bn"]["state"][key]), atol=1e-5)
    for net in ("state", "output"):
        for name, leaves in model.params[net].items():
            for k, p in leaves.items():
                flip = (lambda a: a.T) if k == "w" else (lambda a: a)
                np.testing.assert_allclose(flip(_np(p.grad)), np.asarray(g_j[net][name][k]),
                                           rtol=2e-4, atol=1e-6, err_msg=f"grad {net}/{name}/{k}")
                np.testing.assert_allclose(flip(_np(p)), np.asarray(p_j[net][name][k]),
                                           atol=2e-6, err_msg=f"param {net}/{name}/{k}")


def test_training_step_draws_masks_on_the_model_device():
    """Without explicit masks a step draws them from the model's generator:
    the same seed gives the same step, another seed another."""
    _, tgs = _graphs(1)
    sk, ok = _spec_kw()
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    losses = []
    for seed in (5, 5, 6):
        model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=3, seed=seed, device="cpu")
        losses.append(float(model.training_step(tb)["loss"]))
    assert losses[0] == losses[1] != losses[2]
    masks = tcore.draw_masks(model.spec, tb, torch.Generator().manual_seed(0))
    assert masks["state"][0].shape == (3, tb.n_node_pad, 13)
    assert masks["output"][0].shape == (tb.n_node_pad, 5)
    assert 0.8 < float(masks["state"][0].float().mean()) < 0.9   # keep rate 1 - 0.15


def test_save_loads_in_gnn_tpu(tmp_path):
    """A model trained in the port saves in gnn_tpu's format: gnn_tpu's
    GNNgraphBased.load reads the same weights, statistics and config back."""
    jgs, tgs = _graphs(2)
    sk, ok = _spec_kw()
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer="adam", max_iteration=3,
                          threshold=0.05, seed=1, device="cpu")
    tb = model.to_batch(tgs, block_w=32)
    for _ in range(2):
        model.training_step(tb)
    model.save(str(tmp_path / "m"))
    jm = JGraph.load(str(tmp_path / "m"), path_writer=str(tmp_path / "writer"))
    assert jm.spec.state_spec.to_config() == TSpec(**sk).to_config()
    assert (jm.spec.max_iteration, jm.spec.threshold) == (3, 0.05)
    assert jm.optimizer_config == model.optimizer_config and jm.loss_function == LOSS
    np.testing.assert_array_equal(np.asarray(jm.params["state"]["dense_0"]["w"]),
                                  _np(model.params["state"]["dense_0"]["w"]).T)
    np.testing.assert_array_equal(np.asarray(jm.params["output"]["dense_0"]["b"]),
                                  _np(model.params["output"]["dense_0"]["b"]))
    for k in ("mean", "var"):
        np.testing.assert_array_equal(np.asarray(jm.bn["state"][k]), _np(model.bn["state"][k]))
    # and the port loads it back: the same eval outputs
    back = GNNgraphBased.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(back.Loop(tb)[2], model.Loop(tb)[2])
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    rj = jcore.gnn_forward(jm.spec, jm.params, jm.bn, jb, jax.random.key(0))
    np.testing.assert_allclose(model.forward(tb)["out"].numpy(), np.asarray(rj["out"]),
                               atol=3e-5)
