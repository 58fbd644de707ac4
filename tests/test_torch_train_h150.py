"""Two-layer state nets (the hidden-150 accuracy recipe's shape) in
gnn_tpu_torch against gnn_tpu, on the CPU.

At eval a two-layer net runs K10 (`propagation_loop2`) over the loop blocks
and K9 (`propagation_step2`) per step over the dep blocks; trained without
dropout and BatchNorm it runs the same kernels, differentiated through K11
(`propagation_loop2_bwd`) and K9's plain backward ('hybrid2'); with input
dropout and no BatchNorm it runs K12 (`train_loop2`, backward K13) over the
loop blocks and a plain step over the dep blocks ('dropout2'); with the
trailing BatchNorm K14/K15 (`bn2_forward_step`, `bn2_backward_step`) K times
each over every block row ('bn'). Each is held against gnn_tpu's exact f32
body (aggregation='blocked', highest matmul precision) on
tests/test_fused.py's hybrid_workload2 shape (a hidden width of 16), with the
keep-masks gnn_tpu draws: iteration counts equal, states and outputs atol
3e-5, the loss rtol 1e-5, grads rtol 2e-4 (atol 1e-6), params and moving
BatchNorm statistics after one Adam step atol 1e-5.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnn_tpu
from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.models import core as jcore
from gnn_tpu.models.gnn import GNNgraphBased as JGraph
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.serving import Predictor as JPredictor
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased, Predictor
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_training import _graphs, _jax_masks

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
ATOL = 3e-5
K = 4
KERNELS2 = ("propagation_loop2", "propagation_loop2_bwd", "propagation_step2", "train_loop2",
            "train_loop2_bwd")
KERNELS1 = ("propagation_loop", "propagation_step", "propagation_loop_bwd", "train_loop",
            "train_loop_bwd", "train_step")
KERNELS_BN = ("bn_forward_step", "bn_backward_step", "bn2_forward_step", "bn2_backward_step")


def _spec_kw(drop=0.1, bn=False, acts=("selu", "tanh")):
    """hybrid_workload2's nets: a 13 -> 16 -> 5 state net (AlphaDropout at its
    input unless drop is 0) and, as in the recipe, a two-layer softmax
    readout with dropout at its input."""
    sdrop = dict(dropout_rate=(drop,), dropout_pos=(0,), alphadropout=True) if drop else {}
    sk = dict(input_dim=13, units=(16, 5), activations=acts, kernel_initializer="lecun_normal",
              bias_initializer="lecun_normal", batch_normalization=bn, **sdrop)
    ok = dict(input_dim=5, units=(16, 2), activations=("selu", "softmax"),
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    return sk, ok


def _np(t):
    return t.detach().numpy()


def _batches(seed):
    jgs, tgs = _graphs(seed)
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    assert tb.adj_dep is not None and tb.adj_loop.shape[0] > 2
    return jgs, tgs, jb, tb


def _counted(monkeypatch, names=KERNELS2 + KERNELS1 + KERNELS_BN):
    calls = collections.Counter()
    for name in names:
        mod = tf2 if name in KERNELS2 else tbn if name in KERNELS_BN else tf
        fn = getattr(mod, name)

        def wrapper(*args, _name=name, _fn=fn, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapper)
    return calls


@pytest.mark.parametrize("threshold,bn", [(0.4, False), (1.5, False), (1e9, False),
                                          (0.01, True)])
def test_eval_forward_matches_gnn_tpu(monkeypatch, threshold, bn):
    """The hybrid2 eval path (K10, K9 per step; with BatchNorm its inference
    affine) against gnn_tpu's exact body; coarse thresholds realise fewer
    than max_iteration steps (global early stop)."""
    _, _, jb, tb = _batches(0)
    sk, ok = _spec_kw(bn=bn)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=6, threshold=threshold, aggregation="blocked")
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    if bn:
        jbn = {"state": {"mean": jnp.full((5,), 0.1), "var": jnp.full((5,), 0.8)}, "output": {}}
    with jax.default_matmul_precision("highest"):
        rj = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(1))
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=6, threshold=threshold, seed=0,
                          device="cpu")
    model.set_weights(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    assert tcore._eval_route(model.spec, tb) == "hybrid2"
    calls = _counted(monkeypatch)
    tf2.reset_launches()
    rt = model.forward(tb)
    assert not any(tf2.launches.values())                   # plain versions on the CPU
    assert dict(calls) == {"propagation_loop2": 1, "propagation_step2": 6}
    assert float(rt["iters"]) == float(rj["iters"])
    if threshold == 1e9:
        assert float(rj["iters"]) == 0.0
    np.testing.assert_allclose(_np(rt["state"]), np.asarray(rj["state"]), atol=ATOL)
    np.testing.assert_allclose(_np(rt["out"]), np.asarray(rj["out"]), atol=ATOL)


def _step_against_gnn_tpu(monkeypatch, sk, ok, threshold, route, expect, jbn=None):
    """One optimizer step of the port's model (route `route`, the wrappers
    `expect` called so often) against gnn_tpu's make_train_step on its exact
    body, with the masks gnn_tpu draws."""
    _, _, jb, tb = _batches(0)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=threshold, aggregation="blocked")
    jp, jbn0 = jcore.gnn_init(js, jax.random.key(0))
    jbn = jbn or jbn0
    rng = jax.random.key(3)
    opt_cfg = jopt.optimizer_config("adam")
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                iters, loss, res = jcore.evaluate_single(js, p, jbn, jb, rng, LOSS, {},
                                                         training=True)
                return loss + jcore.regularization(js, p), (iters, loss, res)
            return jax.grad(f, has_aux=True)(p)

        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
        step = jcore.make_train_step(js, LOSS, {}, opt_cfg, mean=True)
        p_j, bn_j, _, iters_s = step(jp, jbn, jopt.make_optimizer(opt_cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    assert float(iters_s) == float(iters_j)
    if threshold == 1e9:
        assert float(iters_j) == 0.0

    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=opt_cfg, max_iteration=K,
                          threshold=threshold, seed=0, device="cpu")
    model.set_weights(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    masks = _jax_masks(js, tb.n_node_pad, rng)
    assert tcore._train_route(model.spec, tb) == route
    with torch.no_grad():
        _, _, res_t = tcore.evaluate_single(model.spec, model.params, model.bn, tb, LOSS, {},
                                            training=True, masks=masks)
    calls = _counted(monkeypatch)
    out = model.training_step(tb, mean=True, masks=masks)
    assert dict(calls) == expect
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(_np(res_t["state"]), np.asarray(res_j["state"]), atol=ATOL)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for key, v in model.bn["state"].items():
        np.testing.assert_allclose(_np(v), np.asarray(bn_j["state"][key]), atol=1e-5)
    for net in ("state", "output"):
        for name, leaves in model.params[net].items():
            for k, p in leaves.items():
                flip = (lambda a: a.T) if k == "w" else (lambda a: a)
                np.testing.assert_allclose(flip(_np(p.grad)), np.asarray(g_j[net][name][k]),
                                           rtol=2e-4, atol=1e-6, err_msg=f"grad {net}/{name}/{k}")
                np.testing.assert_allclose(flip(_np(p)), np.asarray(p_j[net][name][k]),
                                           atol=1e-5, err_msg=f"param {net}/{name}/{k}")


@pytest.mark.parametrize("threshold", [0.01, 0.4])
def test_dropout2_training_step_matches_gnn_tpu(monkeypatch, threshold):
    """One optimizer step of the dropout2 route (K12/K13 over the loop blocks,
    plain dep steps) against gnn_tpu's make_train_step on its exact body,
    with the masks gnn_tpu draws."""
    sk, ok = _spec_kw(acts=("selu", "selu"))
    _step_against_gnn_tpu(monkeypatch, sk, ok, threshold, "dropout2",
                          {"train_loop2": 1, "train_loop2_bwd": 1})


@pytest.mark.parametrize("threshold", [0.01, 0.4, 1e9])
def test_clean2_training_step_matches_gnn_tpu(monkeypatch, threshold):
    """One optimizer step of a two-layer state net without dropout and
    BatchNorm (the recipe's dropout-free run): K10 and its backward K11 over
    the loop blocks, K9 per step over the dep blocks, against gnn_tpu's exact
    body; a threshold of 1e9 realises no step."""
    sk, ok = _spec_kw(drop=0.0)
    _step_against_gnn_tpu(monkeypatch, sk, ok, threshold, "hybrid2",
                          {"propagation_loop2": 1, "propagation_loop2_bwd": 1,
                           "propagation_step2": K})


@pytest.mark.parametrize("drop", [0.1, 0.0])
def test_bn2_training_step_matches_gnn_tpu(monkeypatch, drop):
    """One optimizer step of a two-layer state net with the trailing
    BatchNorm (the reference's default net with a hidden layer), with and
    without AlphaDropout at its input: K14 and K15 K times each over every
    block row, against gnn_tpu's exact body with non-trivial moving
    statistics; the moving statistics after the step agree too."""
    sk, ok = _spec_kw(drop=drop, bn=True)
    jbn = {"state": {"mean": jnp.full((5,), 0.1), "var": jnp.full((5,), 0.8)}, "output": {}}
    _step_against_gnn_tpu(monkeypatch, sk, ok, 0.01, "bn",
                          {"bn2_forward_step": K, "bn2_backward_step": K}, jbn=jbn)


def test_dropout2_grads_match_the_plain_body():
    """A dropout2 step through the kernels' plain versions gives the grads
    autograd gives through the plain body (aggregation='segment') on the same
    masks drawn by the port."""
    _, tgs = _graphs(1)
    sk, ok = _spec_kw(drop=0.2)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    grads = []
    for aggregation in ("auto", "segment"):
        model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01,
                              aggregation=aggregation, seed=2, device="cpu")
        masks = tcore.draw_masks(model.spec, tb, torch.Generator().manual_seed(3))
        assert tcore._train_route(model.spec, tb) == ("dropout2" if aggregation == "auto"
                                                      else "plain")
        model.training_step(tb, masks=masks)
        grads.append([p.grad for p in tcore.param_leaves(model.params)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=1e-6)


def test_two_layer_routes_not_ported_raise():
    """No two-layer training route raises any more: gnn_tpu's dispatch gives
    'hybrid2' (K10/K11) without dropout and BatchNorm, 'bn' (K14/K15) with
    BatchNorm with and without input dropout, and the plain body for dropout
    between the dense layers; each trains a finite step and serves."""
    _, _, _, tb = _batches(2)
    for kw, route in ((dict(drop=0.0), "hybrid2"), (dict(bn=True), "bn"),
                      (dict(drop=0.0, bn=True), "bn"), (dict(pos=(1,)), "plain")):
        pos = kw.pop("pos", None)
        sk, ok = _spec_kw(**kw)
        if pos:
            sk.update(dropout_pos=pos)
        model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, seed=0, device="cpu")
        assert tcore._train_route(model.spec, tb) == route
        assert torch.isfinite(model.training_step(tb)["loss"])
        assert tcore._eval_route(model.spec, tb) == "hybrid2"
        assert torch.isfinite(model.forward(tb)["out"]).all()


def test_two_layer_model_saves_and_loads_both_ways(tmp_path):
    """A two-layer model trained in the port loads in gnn_tpu (dense_1
    included) with the same eval outputs, and one saved by gnn_tpu loads in
    the port."""
    jgs, tgs, jb, tb = _batches(3)
    sk, ok = _spec_kw()
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer="adam", max_iteration=K,
                          threshold=0.05, seed=1, device="cpu")
    model.training_step(tb)
    model.save(str(tmp_path / "m"))
    jm = JGraph.load(str(tmp_path / "m"), path_writer=str(tmp_path / "writer"))
    for name in ("dense_0", "dense_1"):
        np.testing.assert_array_equal(np.asarray(jm.params["state"][name]["w"]),
                                      _np(model.params["state"][name]["w"]).T)
    with jax.default_matmul_precision("highest"):
        rj = jcore.gnn_forward(dataclasses.replace(jm.spec, aggregation="blocked"), jm.params,
                               jm.bn, jb, jax.random.key(0))
    np.testing.assert_allclose(_np(model.forward(tb)["out"]), np.asarray(rj["out"]), atol=ATOL)

    jm.save(str(tmp_path / "j"))
    back = GNNgraphBased.load(str(tmp_path / "j"), device="cpu")
    for name in ("dense_0", "dense_1"):
        np.testing.assert_array_equal(_np(back.params["state"][name]["b"]),
                                      np.asarray(jm.params["state"][name]["b"]))
    np.testing.assert_array_equal(back.Loop(tb)[2], model.Loop(tb)[2])


def test_two_layer_bn_model_saves_and_loads_both_ways(tmp_path):
    """A two-layer BatchNorm model trained in the port (K14/K15) loads in
    gnn_tpu with the same weights, moving statistics and eval outputs, and
    one saved by gnn_tpu loads in the port."""
    jgs, tgs, jb, tb = _batches(5)
    sk, ok = _spec_kw(bn=True)
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer="adam", max_iteration=K,
                          threshold=0.05, seed=1, device="cpu")
    for _ in range(2):
        model.training_step(tb)
    model.save(str(tmp_path / "m"))
    jm = JGraph.load(str(tmp_path / "m"), path_writer=str(tmp_path / "writer"))
    assert jm.spec.state_spec.to_config() == TSpec(**sk).to_config()
    for name in ("dense_0", "dense_1"):
        np.testing.assert_array_equal(np.asarray(jm.params["state"][name]["w"]),
                                      _np(model.params["state"][name]["w"]).T)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(np.asarray(jm.bn["state"][k]), _np(model.bn["state"][k]))
    with jax.default_matmul_precision("highest"):
        rj = jcore.gnn_forward(dataclasses.replace(jm.spec, aggregation="blocked"), jm.params,
                               jm.bn, jb, jax.random.key(0))
    np.testing.assert_allclose(_np(model.forward(tb)["out"]), np.asarray(rj["out"]), atol=ATOL)

    jm.save(str(tmp_path / "j"))
    back = GNNgraphBased.load(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(_np(back.params["state"]["bn"]["gamma"]),
                                  np.asarray(jm.params["state"]["bn"]["gamma"]))
    np.testing.assert_array_equal(back.Loop(tb)[2], model.Loop(tb)[2])


def test_predictor_serves_two_layer_model(tmp_path):
    """Predictor(device='cpu') serves the two-layer model as gnn_tpu's
    Predictor does."""
    jgs, tgs, _, _ = _batches(4)
    sk, ok = _spec_kw()
    jm = gnn_tpu.GNNgraphBased(net_state=JSpec(**sk), net_output=JSpec(**ok), optimizer="adam",
                               loss_function=LOSS, max_iteration=K, threshold=0.01,
                               path_writer=str(tmp_path / "w"), seed=0)
    tm = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01, device="cpu")
    tm.set_weights(*jax.tree_util.tree_map(np.asarray, (jm.params, jm.bn)))
    want = JPredictor(jm, block_w=32).predict(jgs)
    got = Predictor(tm, block_w=32, device="cpu").predict(tgs)
    assert len(got) == len(want) == len(tgs)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL)
