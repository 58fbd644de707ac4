"""BatchNorm-free training in gnn_tpu_torch against gnn_tpu, on the CPU.

Two routes of models/core.py::propagate train a state net without BatchNorm:
input dropout runs the dropout kernels (K7 and its backward K8 over the loop
blocks, K6 per step over the dep blocks); a clean net (no dropout) runs the
eval kernels (K3 and its backward K5, K4 with a plain backward). One
optimizer step of each, on a batch with loop and dep blocks, is held against
gnn_tpu's make_train_step on its exact f32 body (aggregation='blocked',
highest matmul precision) with the keep-masks gnn_tpu draws, at the
tolerances of tests/test_torch_training.py: iteration counts equal, states
atol 3e-5, the loss rtol 1e-5, grads rtol 2e-4 (atol 1e-6), params after one
Adam step atol 2e-6; and against gnn_tpu's own kernel route
(aggregation='auto', Pallas in interpret mode) at gnn_tpu's 2e-4.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.models import core as jcore
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_training import _graphs, _jax_masks

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
K = 4
KERNELS = ("train_loop", "train_loop_bwd", "train_step", "propagation_loop",
           "propagation_loop_bwd", "propagation_step")


def _spec_kw(route, act="selu"):
    """The flagship's nets at small width without the state net's BatchNorm:
    AlphaDropout at its input ('dropout') or no dropout ('hybrid')."""
    sdrop = dict(dropout_rate=(0.15,), dropout_pos=(0,), alphadropout=True) \
        if route == "dropout" else {}
    sk = dict(input_dim=13, units=(5,), activations=act, kernel_initializer="lecun_normal",
              bias_initializer="lecun_normal", batch_normalization=False, **sdrop)
    ok = dict(input_dim=5, units=(2,), activations="softmax", kernel_initializer="glorot_normal",
              bias_initializer="glorot_normal", dropout_rate=(0.1,), dropout_pos=(0,),
              batch_normalization=False)
    return sk, ok


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("threshold", [0.01, 0.4, 1.5, 1e9])
@pytest.mark.parametrize("route", ["dropout", "hybrid"])
def test_training_step_matches_gnn_tpu(route, threshold):
    jgs, tgs = _graphs(0)
    sk, ok = _spec_kw(route)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=threshold, aggregation="auto")
    exact = dataclasses.replace(js, aggregation="blocked")
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    assert tb.adj_dep is not None and tb.adj_loop.shape[0] > 2
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    assert jbn == {"state": {}, "output": {}}
    rng = jax.random.key(3)
    opt_cfg = jopt.optimizer_config("adam")

    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                iters, loss, res = jcore.evaluate_single(exact, p, jbn, jb, rng, LOSS, {},
                                                         training=True)
                return loss + jcore.regularization(exact, p), (iters, loss, res)
            return jax.grad(f, has_aux=True)(p)

        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
        step = jcore.make_train_step(exact, LOSS, {}, opt_cfg, mean=True)
        p_j, _, _, iters_s = step(jp, jbn, jopt.make_optimizer(opt_cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    kern = jax.jit(lambda p: jcore.gnn_forward(js, p, jbn, jb, rng, training=True))(jp)
    assert float(iters_s) == float(iters_j) == float(kern["iters"])

    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=opt_cfg, max_iteration=K,
                          threshold=threshold, seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    masks = _jax_masks(js, tb.n_node_pad, rng)
    assert tcore._train_route(model.spec, tb) == route
    with torch.no_grad():
        _, _, res_t = tcore.evaluate_single(model.spec, model.params, model.bn, tb, LOSS, {},
                                            training=True, masks=masks)
    tf.reset_launches()
    out = model.training_step(tb, mean=True, masks=masks)
    assert not any(tf.launches.values())                    # plain versions on the CPU

    assert float(out["iters"]) == float(iters_j)
    if threshold == 1e9:
        assert float(iters_j) == 0.0
    np.testing.assert_allclose(_np(res_t["state"]), np.asarray(res_j["state"]), atol=3e-5)
    np.testing.assert_allclose(_np(res_t["state"]), np.asarray(kern["state"]), atol=2e-4)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    assert model.bn == {"state": {}, "output": {}}
    for net in ("state", "output"):
        for name, leaves in model.params[net].items():
            for k, p in leaves.items():
                flip = (lambda a: a.T) if k == "w" else (lambda a: a)
                np.testing.assert_allclose(flip(_np(p.grad)), np.asarray(g_j[net][name][k]),
                                           rtol=2e-4, atol=1e-6, err_msg=f"grad {net}/{name}/{k}")
                np.testing.assert_allclose(flip(_np(p)), np.asarray(p_j[net][name][k]),
                                           atol=2e-6, err_msg=f"param {net}/{name}/{k}")


@pytest.mark.parametrize("route,rate,alpha", [("dropout", 0.15, True),
                                              ("dropout", 0.2, False), ("hybrid", 0.0, True)])
def test_routes_launch_their_kernels(monkeypatch, route, rate, alpha):
    """A training step runs each kernel wrapper of its route (on the CPU the
    plain versions): the dropout route K7 and K8 once and K6 once per step,
    the clean route K3 and K5 once and K4 once per step; autograd through
    the plain body gives the same grads."""
    _, tgs = _graphs(1)
    sk, ok = _spec_kw(route)
    if route == "dropout":
        sk.update(dropout_rate=(rate,), alphadropout=alpha)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    for name in KERNELS:
        monkeypatch.setattr(tf, name, counted(name, getattr(tf, name)))
    grads = []
    for aggregation in ("auto", "segment"):
        model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01,
                              aggregation=aggregation, seed=2, device="cpu")
        masks = tcore.draw_masks(model.spec, tb, torch.Generator().manual_seed(3))
        model.training_step(tb, masks=masks)
        grads.append([p.grad for p in tcore.param_leaves(model.params)])
        if aggregation == "auto":
            want = (dict(train_loop=1, train_loop_bwd=1, train_step=K) if route == "dropout"
                    else dict(propagation_loop=1, propagation_loop_bwd=1, propagation_step=K))
            assert dict(calls) == want
            calls.clear()
    assert not calls                                        # the plain body runs no kernel
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=1e-6)
