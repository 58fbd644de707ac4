"""The wide plans of the one-layer kernels K1-K8 (the last plan of each,
chosen only where no staged shared-memory plan fits; ops/bn.py::_bn_fwd_wide,
_bn_bwd_wide, ops/fused.py::_loop_wide, _step_wide, _loop_bwd_wide,
_train_step_wide, _train_loop_wide, _train_bwd_wide), on the CPU: the staged
plans stay the ones chosen wherever they fit (the flagship's bytes as before),
the wide plan is chosen exactly where none fits, it fits a CTA at every state
width up to 1024, and its workspace is the sum of the regions the sources
place there. One-layer models of state width 128 match gnn_tpu's exact f32
body on every route (serving; the clean, dropout and BatchNorm training
steps), their wrappers running their plain versions, at the tolerances of
tests/test_torch_wide_routes.py. chip_smoke.py holds the mirrors to the
library's gnn_*_info and gnn_*_workspace entries and the wide plans to the
staged plans bit for bit on the card."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.models import core as jcore
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_training import _jax_masks
from test_torch_wide_routes import ATOL, LOSS, _batches, _net_kw, _np

SMEM = tf.SMEM_BYTES
K = 4
r4 = tf._r4

# kernel: (staged plans, staged bytes (W, D, X, plan), wide layout (W, D, X),
# the plan the wrapper takes (W, D, X)); X is F for K1/K2, H for K4/K6,
# unused otherwise
KERNELS = {
    "K1": (tbn._BN_FWD_PLANS, tbn._bn_fwd_bytes, tbn._bn_fwd_wide,
           lambda W, D, X: tbn._bn_plan("K1", W, D, X)),
    "K2": (tbn._BN_BWD_PLANS, tbn._bn_bwd_bytes, tbn._bn_bwd_wide,
           lambda W, D, X: tbn._bn_plan("K2", W, D, X)),
    "K3": (tf._LOOP_PLANS, lambda W, D, X, p: tf._loop_bytes(W, D, p),
           lambda W, D, X: tf._loop_wide(W, D), lambda W, D, X: tf._loop_plan(W, D)),
    "K4": ((tf._STEP_PLAN,), lambda W, D, X, p: tf._step_bytes(W, D, X), tf._step_wide,
           tf._step_plan),
    "K5": (tf._LOOP_BWD_PLANS, lambda W, D, X, p: tf._loop_bwd_bytes(W, D, p),
           lambda W, D, X: tf._loop_bwd_wide(W, D), lambda W, D, X: tf._loop_bwd_plan(W, D)),
    "K6": ((tf._TRAIN_STEP_PLAN,), lambda W, D, X, p: tf._train_step_bytes(W, D, X),
           tf._train_step_wide, tf._train_step_plan),
    "K7": ((tf._TRAIN_LOOP_PLAN,), lambda W, D, X, p: tf._train_loop_bytes(W, D),
           lambda W, D, X: tf._train_loop_wide(W, D), lambda W, D, X: tf._train_loop_plan(W, D)),
    "K8": (tf._TRAIN_BWD_PLANS, lambda W, D, X, p: tf._train_bwd_bytes(W, D, p),
           lambda W, D, X: tf._train_bwd_wide(W, D), lambda W, D, X: tf._train_bwd_plan(W, D)),
}
WIDTHS = (32, 64, 96, 128)


def _third(kernel, D):
    """The third widths a kernel's plan is checked at: F 0, 3, 20 and 64 for
    K1/K2, H = D and two others for K4/K6, none otherwise."""
    if kernel in ("K1", "K2"):
        return (0, 3, 20, 64)
    if kernel in ("K4", "K6"):
        return (D, 1, 64)
    return (0,)


def _staged_plan(kernel, W, D, X):
    """The staged plan the kernel took before the wide plans: the first that
    fits a CTA, or None (fused._first_plan without a wide plan)."""
    plans, nbytes, _, _ = KERNELS[kernel]
    return tf._first_plan(plans, nbytes, W, D, X)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_staged_plans_stay_where_they_fit(kernel):
    """At every shape the kernels took before (W 32..128, D up to 64, the
    third widths of _third) the plan and bytes chosen are the staged plans'
    as before; at the flagship's widths and at D 64 (W 128) they are the
    bytes the plan tests pin."""
    for W, D in itertools.product(WIDTHS, range(1, 65)):
        for X in _third(kernel, D):
            before = _staged_plan(kernel, W, D, X)
            if before[1] is not None:
                assert KERNELS[kernel][3](W, D, X) == before, (W, D, X)
    flagship = {"K1": (41696, 0), "K2": (69632, 0), "K3": (50448, 0), "K4": (49936, 0),
                "K5": (67760, 0), "K6": (52352, 0), "K7": (41856, 0), "K8": (54400, 0)}
    at64 = {"K1": (163840, 0), "K2": (169728, 1), "K3": (210048, 0), "K4": (209536, 0),
            "K5": (210944, 1), "K6": (217728, 0), "K7": (188032, 0), "K8": (225408, 1)}
    X = 3 if kernel in ("K1", "K2") else 14
    assert KERNELS[kernel][3](128, 14, X) == flagship[kernel]
    assert KERNELS[kernel][3](128, 64, 3 if X == 3 else 64) == at64[kernel]


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wide_plan_exactly_where_no_staged_plan_fits(kernel):
    """Over W 32..128 and D 1..1024 (the third widths of _third, and F up to
    200 for K1/K2) the wide plan (index len(staged plans)) is chosen exactly
    where no staged plan fits, and every shape has a plan: the wrappers'
    _check_fits never fires."""
    plans, nbytes, wide, choose = KERNELS[kernel]
    thirds = (0, 3, 64, 200) if kernel in ("K1", "K2") else None
    for W, D in itertools.product(WIDTHS, list(range(1, 130)) + list(range(130, 1025, 37))):
        for X in thirds or _third(kernel, D) + ((1024,) if kernel in ("K4", "K6") else ()):
            need, plan = choose(W, D, X)
            fits = [int(nbytes(W, D, X, p)) <= SMEM for p in plans]
            assert plan is not None, (W, D, X)
            if any(fits):
                assert plan == fits.index(True) and need == int(nbytes(W, D, X, plans[plan]))
            else:
                assert plan == len(plans) and need == int(wide(W, D, X)[0])
            tf._check_fits(need, plan, f"W={W}, D={D}")


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wide_plan_fits_every_width(kernel):
    """The wide plan's shared memory does not grow with D (nor with F or H):
    at W 32..128 it fits a CTA at every D up to 1024, with room for at least
    eight CTAs an SM at W 128."""
    wide = KERNELS[kernel][2]
    D = np.arange(1, 1025)
    for W in WIDTHS:
        for X in (0, 3, 64, 1024):
            need = np.broadcast_to(np.asarray(wide(W, D, X)[0]), D.shape)
            assert (need <= SMEM).all() and len(set(need.tolist())) == 1
    assert 8 * (int(np.max(wide(128, D, 3)[0])) + 1024) <= 228 * 1024


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_workspace_is_the_sum_of_its_regions(kernel):
    """The wide plan's workspace, in floats a block row, is the regions the
    source places there, each rounded to 16 bytes (K6 and K7 keep their rows
    in their outputs and take none); at W 128, D 128 on the training batch's
    1214 block rows (K1/K2, F 3) or 1104 loop rows (K3, K5, K8) and 110 dep
    rows (K4) it is the bytes PERF.md records."""
    wide = KERNELS[kernel][2]
    for W, D, X in itertools.product(WIDTHS, (1, 14, 65, 128, 200, 1024), (0, 3, 64)):
        C1 = 2 * D + X
        want = {"K1": r4(C1 * W) + r4(W * (D | 1)),
                "K2": r4(C1 * W) + r4(D * W) + r4(W * (D | 1)),
                "K3": r4(W * ((2 * D) | 1)),
                "K4": r4(W * ((2 * X) | 1)),
                "K5": D * W + 2 * D * (W + 4) + r4(W * ((2 * D) | 1)) + r4(W * (D | 1))
                + r4(2 * D),
                "K6": 0, "K7": 0,
                "K8": 2 * D * W + D * (W + 4) + 2 * r4(W * (D | 1)) + r4((2 * W * D + 3) // 4),
                }[kernel]
        assert wide(W, D, X)[1] == want and want % 4 == 0


def _models(width, drop, bn, threshold):
    """(gnn_tpu spec 'blocked', its params and bn, the port's 'auto' model
    with the same weights) of a one-layer state net of `width`."""
    sk, ok = _net_kw(width, 3, drop=drop, bn=bn)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=threshold, aggregation="blocked")
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    if bn:
        jbn = {"state": {"mean": jnp.full((width,), 0.1), "var": jnp.full((width,), 0.7)},
               "output": {}}
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=jopt.optimizer_config("adam"),
                          max_iteration=K, threshold=threshold, aggregation="auto", seed=0,
                          device="cpu")
    model.set_weights(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    return js, jp, jbn, model


@pytest.mark.parametrize("bn,threshold", [(True, 0.01), (False, 0.4)])
def test_width_128_serving_matches_gnn_tpu(bn, threshold):
    """A one-layer model of state width 128 serves through the 'hybrid' route
    (K3/K4's wrappers) on a fused-layout batch within 3e-5 of gnn_tpu's exact
    body, iterations equal."""
    jb, tb = _batches(128, 3, block_w=128)
    js, jp, jbn, model = _models(128, 0.1, bn, threshold)
    assert tcore._eval_route(model.spec, tb) == "hybrid"
    with jax.default_matmul_precision("highest"):
        body = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(1))
    rt = model.forward(tb)
    assert float(rt["iters"]) == float(body["iters"])
    for key in ("state", "out"):
        np.testing.assert_allclose(_np(rt[key]), np.asarray(body[key]), atol=ATOL)


@pytest.mark.parametrize("drop,bn,route", [(0.0, False, "hybrid"), (0.15, False, "dropout"),
                                           (0.15, True, "bn")])
def test_width_128_training_step_matches_gnn_tpu(drop, bn, route):
    """One optimizer step of a one-layer model of state width 128 on a
    fused-layout batch, on the clean (K3/K5/K4), dropout (K7/K8/K6) and
    BatchNorm (K1/K2) routes, matches gnn_tpu's make_train_step on its exact
    body with gnn_tpu's masks: iteration count, states, loss, grads, params
    and moving statistics."""
    jb, tb = _batches(128, 3, block_w=128)
    js, jp, jbn, model = _models(128, drop, bn, 0.01)
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
        p_j, bn_j, _, _ = step(jp, jbn, jopt.make_optimizer(opt_cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    masks = _jax_masks(js, tb.n_node_pad, rng)
    assert tcore._train_route(model.spec, tb) == route
    with torch.no_grad():
        _, _, res_t = tcore.evaluate_single(model.spec, model.params, model.bn, tb, LOSS, {},
                                            training=True, masks=masks)
    out = model.training_step(tb, mean=True, masks=masks)
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
