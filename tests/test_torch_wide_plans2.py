"""The wide plans of the two-layer and typed kernels K9-K17 (ops/csrc/tile2.cuh
kTile2Wide, bn_typed.cu kBnTFwdWide / kBnTBwdWide), which take every state,
arc-label and hidden width and every number of node types:

* their Python mirrors (ops/fused2.py::_tile2_plan, _tile2_wide; ops/typed.py
  ::_bnT_fwd_plan, _bnT_bwd_plan and their wide layouts) keep the staged
  plans where they fit, at the recipes' shapes and on a grid of shapes, and
  take the wide plan exactly where no staged plan does; the wide plan fits
  every width at W 32 and 128 (D, AL and F 65, 80, 128, 200; H1 513, 1024;
  T 33, 300), and its workspace is the sum of its regions;
* the wide plan tuples are the sources' (read from the .cu files);
* on the CPU (the wrappers' plain versions) a two-layer BatchNorm model of
  state width 80 (K14/K15's route) trains one step as gnn_tpu's exact body
  does, and composite models of state width 80 with 3 node types and of 33
  node types serve and train one step as gnn_tpu does: iterations equal,
  states 3e-5, grads rtol 2e-4, params and moving statistics 1e-5.
"""

import itertools
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

import test_torch_composite as tc
from gnn_tpu.models import composite as jcomp
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops import typed as ttyped
from gnn_tpu_torch.ops.fused import _r4
from test_torch_wide_routes import test_width_80_training_step_matches_gnn_tpu as step_w80

torch.set_num_threads(1)
SMEM = tf2.SMEM_BYTES
CSRC = pathlib.Path(tf2.__file__).parent / "csrc"
TILED = ("K9", "K10", "K11", "K12", "K13", "K14", "K15")
WIDTHS = (65, 80, 128, 200)


def _source_tuple(path, name):
    """The brace-initialised int tuple `name = {...};` of a kernel source."""
    m = re.search(rf"{name} = \{{([^{{}}]*)\}};", (CSRC / path).read_text())
    return tuple(int(v) for v in re.findall(r"-?\d+", m.group(1)))


def test_wide_plan_tuples_are_the_sources():
    assert tf2._WIDE == _source_tuple("tile2.cuh", "constexpr Tile2Plan kTile2Wide")
    for plan, name in ((ttyped._BNT_FWD_WIDE, "BnTFwdPlan kBnTFwdWide"),
                       (ttyped._BNT_BWD_WIDE, "BnTBwdPlan kBnTBwdWide")):
        assert plan == _source_tuple("bn_typed.cu", "constexpr " + name)


@pytest.mark.parametrize("kernel", TILED)
def test_tiled_staged_plans_stay_at_the_recipes(kernel):
    """At the hidden-150 recipe (W 128, D 14, AL 3, H1 150) and at D = AL = 64
    (W 64, H1 40) every tiled kernel keeps a staged plan, its bytes the staged
    layout's."""
    for W, D, AL, H1 in ((128, 14, 3, 150), (64, 64, 64, 40), (32, 5, 7, 13)):
        need, plan = tf2._tile2_plan(W, D, AL, H1, kernel)
        assert plan is not None and plan < len(tf2._PLANS[kernel]), (W, D, AL, H1)
        assert need == tf2._tile2_bytes(tf2._KIND[kernel], W, D, AL, H1,
                                        tf2._PLANS[kernel][plan])
    assert tf2._tile2_plan(128, 14, 3, 150, kernel)[1] == 0


@pytest.mark.parametrize("kernel", TILED)
@pytest.mark.parametrize("W", [32, 128])
def test_tiled_wide_plan_exactly_where_no_staged_plan_fits(kernel, W):
    """On a grid of D, AL in {1, 14, 33, 64, 65, 80, 128, 200} and H1 in {1,
    150, 512, 513, 1024}, the mirror takes the wide plan exactly where D or AL
    is above 64 or no staged plan fits, and the first staged plan that fits
    otherwise; the wide plan fits every one of them."""
    kind, plans, wide = tf2._KIND[kernel], tf2._PLANS[kernel], len(tf2._PLANS[kernel])
    widths = (1, 14, 33, 64) + WIDTHS
    for D, AL, H1 in itertools.product(widths, widths, (1, 150, 512, 513, 1024)):
        need, plan = tf2._tile2_plan(W, D, AL, H1, kernel)
        fits = [i for i, p in enumerate(plans)
                if tf2._tile2_bytes(kind, W, D, AL, H1, p) <= SMEM]
        if max(D, AL) > 64 or not fits:
            assert plan == wide and need == tf2._tile2_wide(kind, W, D, AL, H1)[0] <= SMEM, \
                (D, AL, H1)
        else:
            assert plan == fits[0], (D, AL, H1)


@pytest.mark.parametrize("kernel", TILED)
def test_tiled_wide_workspace_is_the_sum_of_its_regions(kernel):
    """The wide plan's workspace a block row (floats) and shared memory
    (bytes), region by region, as tile2.cuh::tile2_layout(..., wide = true)
    lays them out."""
    kind = tf2._KIND[kernel]
    for W, D, AL, H1 in ((128, 80, 3, 150), (32, 200, 65, 1024), (96, 65, 128, 513)):
        C = 2 * D + AL
        regions = [C * W, D * W]                          # x3, h1
        if kernel in ("K11", "K13", "K15"):
            regions += [D * W, C * W]                     # G, dx3
        if kernel in ("K10", "K12"):
            regions += [D * W]                            # K12's undropped state
        if kernel in ("K9", "K14"):
            regions += [_r4(W * (D | 1))]                 # the row buffer
        nl = 2 if kernel == "K11" else 1
        tiles = 32 * W * (2 if kernel in ("K11", "K13", "K15") else 1)
        floats = tiles + nl * 16 * W + (W if kernel == "K14" else 0)
        assert tf2._tile2_wide(kind, W, D, AL, H1) == (4 * floats + nl * 17 * W, sum(regions))


def test_typed_plans_stay_at_the_recipe_and_widen_past_it():
    """K16/K17 keep their staged plans at the composite recipe (W 128, D 14,
    F 3, T 4) and at T 32, D 64; the wide plan (index 3) at D above 64, more
    than MAX_TYPES types, or where no staged plan fits, and it fits every
    width and type count at W 32 and 128."""
    for plan_of in (ttyped._bnT_fwd_plan, ttyped._bnT_bwd_plan):
        assert plan_of(128, 14, 3, 4)[1] == 0
        assert plan_of(64, 64, 3, 32)[1] in (1, 2)
        for W, D, F, T in itertools.product((32, 128), (14, 64) + WIDTHS, (0, 3, 65, 200),
                                            (1, 4, 32, 33, 300)):
            need, plan = plan_of(W, D, F, T)
            if D > 64 or T > ttyped.MAX_TYPES:
                assert plan == 3 and need <= SMEM, (W, D, F, T)
            assert plan is not None and need <= SMEM


def test_typed_wide_workspace_is_the_sum_of_its_regions():
    for W, D, F, T in ((128, 80, 3, 3), (32, 14, 3, 300), (64, 200, 65, 33)):
        C1 = 2 * D + F
        fwd = _r4(C1 * W) + _r4(W * (D | 1)) + _r4(T + 1)         # x3, row buffer, starts
        bwd = _r4(C1 * W) + _r4(D * W) + 2 * _r4(W * (D | 1)) + _r4(T + 1)   # + dh, dagg, ds
        smem = 4 * (_r4(W) + 2 * W)                               # nm, types, order
        assert ttyped._bnT_fwd_wide(W, D, F, T) == (smem + 4 * 16 * W + 17 * W + 8 * W, fwd)
        assert ttyped._bnT_bwd_wide(W, D, F, T) == (smem + 4 * 8 * W + 9 * W, bwd)


# ------------------------------------------------------------- the CPU routes
def test_width_80_two_layer_bn_step_matches_gnn_tpu(monkeypatch):
    """One step of a two-layer state net with input dropout and the trailing
    BatchNorm at state width 80 (the 'bn' route: K14/K15's wrappers, their
    plain versions here) against gnn_tpu's make_train_step on its exact
    body with gnn_tpu's masks (test_torch_wide_routes's check)."""
    step_w80(monkeypatch, 2, 0.1, True)


@pytest.mark.parametrize("T,nl,optimizer", [(3, 80, "adam"), (33, 5, "sgd")])
def test_wide_composite_serves_and_trains_as_gnn_tpu(monkeypatch, T, nl, optimizer):
    """A composite model with T node types at state width nl serves through
    K16 (its plain version here) as gnn_tpu's XLA body does, and one training
    step through K16/K17 matches gnn_tpu's make_composite_train_step with its
    masks. With 33 types the step is SGD's: the state nets' biases feed the
    trailing BatchNorm, so their true gradient is 0, and Adam's first step
    turns the rounding noise of a type with few nodes (within the grads'
    bound) into an update of up to its learning rate."""
    monkeypatch.setattr(tc, "NL", nl)
    jgs, tgs = tc.typed_graphs(12, T)
    js, ts = tc.composite_specs(T)
    (jp, jbn), (tp, tbn_) = tc.composite_weights(js)
    jb, tb = tc.batches(jgs, tgs)
    assert (tcomp._route(ts, tb, False), tcomp._route(ts, tb, True)) == ("typed_eval",
                                                                        "typed_bn")
    got = tcomp.composite_forward(ts, tp, tbn_, tb)
    monkeypatch.setenv("GNN_TPU_FUSED_BN", "0")
    with jax.default_matmul_precision("highest"):
        body = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(0))
    assert float(got["iters"]) == float(body["iters"])
    for key in ("state", "out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(body[key]), atol=3e-5)
    tc.check_step_against_gnn_tpu(js, jp, jbn, jb, ts, tb, jax.random.key(5),
                                  expect_route="typed_bn", optimizer=optimizer)
