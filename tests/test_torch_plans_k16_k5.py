"""The shared-memory plans of the redesigned K16 (ops/csrc/bn_typed.cu's
kBnTFwdPlans, mirrored by ops/typed.py::_BNT_FWD_PLANS, _bnT_fwd_bytes and
_bnT_fwd_plan) and K5 (ops/csrc/eval_loop_bwd.cu's kLoopBwdPlans, mirrored by
ops/fused.py::_LOOP_BWD_PLANS, _loop_bwd_bytes and _loop_bwd_plan), on the
CPU: the mirrors' plan lists against the sources, their bytes at the
composite recipe's and the flagship's widths against the layouts summed by
hand, the plans' fit in a CTA and the CTAs an SM they leave room for, every
shape the per-node kernels took taken by some plan, K16's ValueError beyond
its leanest plan, raised on meta tensors before any launch, and K5's wide
plan (ops/fused.py::_loop_bwd_wide) beyond its leanest staged plan.
chip_smoke.py holds the mirrors to the library's own gnn_bnT_forward_info /
gnn_propagation_loop_bwd_info on the card."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tpu_torch.ops import fused as tfused
from gnn_tpu_torch.ops import typed as ttyped

SMEM = tfused.SMEM_BYTES
SM_BYTES = 228 * 1024     # an SM's shared memory; each CTA keeps 1 KB of it
CSRC = Path(tfused.__file__).resolve().parent / "csrc"


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def _per_node_k16_bytes(W, D, F, T):
    """Shared memory a CTA of the per-node K16 took without the stacked
    weights (it read them through the caches where they did not fit): the
    adjacency [W][W + 1], x3 rows of odd stride, a row buffer [W][D | 1], the
    per-type affines [4][T][D], the node mask, types and order [W] each, the
    types' starts and the keep bytes (bn_typed.cu's Layout before the
    redesign); the widths may be numpy arrays."""
    C = 2 * D + F + 1
    return 4 * (W * (W + 1) + W * ((C - 1) | 1) + W * (D | 1) + 4 * T * D + 3 * W + T + 1
                + (W * (C - 1) + 3) // 4)


def _per_node_k5_bytes(W, D):
    """Shared memory a CTA of the per-node K5 took, one thread a node: the
    resident adjacency [W][W + 1], s_in [W][D | 1], a staging buffer
    [W][2D | 1], w2 [2D][D] and the affine's scale [D] (eval_loop_bwd.cu's
    bwd_smem before the redesign); D may be a numpy array."""
    return 4 * (W * (W + 1) + W * (D | 1) + W * ((2 * D) | 1) + 2 * D * D + D)


def _k16_checks(W, D, F, T):
    """K16's wrapper checks (bnT_forward_step's _check_typed) on meta tensors
    of this shape, without loop rows: (Bl, W, T)."""
    return ttyped._check_typed(None, _meta(2, W, W), 2, D, F, _meta(2, W, dtype=torch.int32),
                               _meta(T * D, 2 * D + F + 1), ("selu",) * T)


def _k5_launch(W, D, K=2, affine=False):
    """K5's wrapper (fused.propagation_loop_bwd) on meta tensors of this
    shape."""
    B = 2
    return tfused.propagation_loop_bwd(_meta(B, W, W), _meta(B, W, D), _meta(K, B, W, D),
                                       _meta(B, W, D), _meta(2 * D, D),
                                       _meta(2, D) if affine else None, _meta(K, B, W, D),
                                       "selu")


def _source_plans(path, name):
    """The plan tuples of the constexpr array `name` in a kernel source."""
    text = (CSRC / path).read_text()
    body = re.search(rf"{name}\[\] = \{{(.*?)\}};", text, re.S).group(1)
    return tuple(tuple(int(v) for v in re.findall(r"-?\d+", p))
                 for p in re.findall(r"\{([^{}]*)\}", body))


@pytest.mark.parametrize("kernel", ["K16", "K5"])
def test_mirrored_plan_lists_match_the_sources(kernel):
    """The Python plan lists are the sources' lists, in order; the first
    stages everything, the leanest (K16: 128 threads without lists) stages
    nothing optional."""
    if kernel == "K16":
        plans = ttyped._BNT_FWD_PLANS
        assert _source_plans("bn_typed.cu", "kBnTFwdPlans") == plans
        assert plans[0] == (256, 16, 1, 1) and plans[-1] == (128, 0, 0, 0)
    else:
        plans = tfused._LOOP_BWD_PLANS
        assert tuple(p for (p,) in _source_plans("eval_loop_bwd.cu", "kLoopBwdPlans")) == plans
        assert plans == (1, 0)


@pytest.mark.parametrize("kernel", ["K16", "K5"])
def test_k16_and_k5_plans_at_the_recipes(kernel):
    """At the composite recipe (W 128, D 14, F 3, T 4) K16 takes plan 0: x3
    31x128, the weights 4x32x16, the affines 4x4x14, nm, types and order
    3x128, the starts 8, the row buffer 128x15, the keep bytes in 992
    floats, lists 16x128: 11,592 floats, and 128 counts, 2,048 sources and
    the list build's 8x128 counts as bytes: 49,568 bytes, four CTAs an SM by
    shared memory against the per-node kernel's two (103,188 bytes with its
    staged weights). At the flagship's widths (W 128, D 14) K5 takes plan 0:
    s_in 14x128, du 28x132, u 128x29, gs 128x15, the daff partials 28, the
    scale 16, dfT 128x15, the dw2 partials 28x14, w2 transposed 14x28 and w2
    28x16, two list sets 8x128 each: 16,364 floats, and 2 x (128 + 1,024)
    bytes: 67,760 bytes, three CTAs an SM against the per-node kernel's two
    (90,200 bytes). The leanest plans drop the lists, the keep bytes and the
    weights (K16), and w2, dfT and the dw2 partials (K5, its lists kept)."""
    if kernel == "K16":
        need, plan = ttyped._bnT_fwd_plan(128, 14, 3, 4)
        floats = (31 * 128 + 4 * 32 * 16 + 4 * 4 * 14 + 3 * 128 + 8 + 128 * 15 + 992
                  + 16 * 128)
        assert floats == 11592
        assert (need, plan) == (4 * floats + 128 + 2048 + 8 * 128, 0) == (49568, 0)
        assert 4 * (need + 1024) <= SM_BYTES
        per_node = int(_per_node_k16_bytes(128, 14, 3, 4)) + 4 * 4 * 14 * 32
        assert per_node == 103188 and 2 * (per_node + 1024) <= SM_BYTES < 3 * (per_node + 1024)
        lean = ttyped._bnT_fwd_bytes(128, 14, 3, 4, ttyped._BNT_FWD_PLANS[-1])
        assert lean == 4 * (floats - 4 * 32 * 16 - 992 - 16 * 128) == 26016
        second = ttyped._bnT_fwd_bytes(128, 14, 3, 4, ttyped._BNT_FWD_PLANS[1])
        assert second == need - 4 * 4 * 32 * 16
    else:
        need, plan = tfused._loop_bwd_plan(128, 14)
        floats = (14 * 128 + 28 * 132 + 128 * 29 + 128 * 15 + 28 + 16 + 128 * 15 + 28 * 14
                  + 14 * 28 + 28 * 16 + 2 * 8 * 128)
        assert floats == 16364
        assert (need, plan) == (4 * floats + 2 * (128 + 1024), 0) == (67760, 0)
        assert 3 * (need + 1024) <= SM_BYTES < 4 * (need + 1024)
        per_node = int(_per_node_k5_bytes(128, np.array(14)))
        assert per_node == 90200 and 2 * (per_node + 1024) <= SM_BYTES < 3 * (per_node + 1024)
        lean = tfused._loop_bwd_bytes(128, 14, tfused._LOOP_BWD_PLANS[-1])
        assert lean == need - 4 * (128 * 15 + 28 * 14 + 14 * 28 + 28 * 16) == 55152


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k16_plans_take_every_shape_the_per_node_kernel_took(W):
    """Over every D in 1..64, F in 0..64 and T in 1..MAX_TYPES, each shape
    whose per-node K16 layout fitted 227 KB without the stacked weights fits
    K16's leanest plan (and so one of its plans), and the wrapper's checks
    pass on the 16 taken shapes that leave the least room and on D in {1, 5,
    14, 64}, F in {0, 3, 64}, T in {1, 4, 8, 32}."""
    D, F, T = np.meshgrid(np.arange(1, 65), np.arange(0, 65), np.arange(1, ttyped.MAX_TYPES + 1),
                          indexing="ij")
    took = _per_node_k16_bytes(W, D, F, T) <= SMEM
    lean = ttyped._bnT_fwd_bytes(W, D, F, T, ttyped._BNT_FWD_PLANS[-1])
    least = np.min([ttyped._bnT_fwd_bytes(W, D, F, T, p) for p in ttyped._BNT_FWD_PLANS], axis=0)
    refused = took & (lean > SMEM)
    assert not refused.any(), (
        f"{int(refused.sum())} shapes refused, e.g. (D, F, T) = "
        f"{tuple(int(v[refused][0]) for v in (D, F, T))}")
    assert (least <= lean).all() and took.sum() > 1000
    room = np.where(took, SMEM - least, np.iinfo(np.int64).max).ravel()
    for i in np.argsort(room, kind="stable")[:16]:
        d, f, t = (int(v.ravel()[i]) for v in (D, F, T))
        assert _k16_checks(W, d, f, t) == (0, W, t)
    for d, f, t in itertools.product((1, 5, 14, 64), (0, 3, 64), (1, 4, 8, 32)):
        if _per_node_k16_bytes(W, d, f, t) <= SMEM:
            assert _k16_checks(W, d, f, t) == (0, W, t)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k5_plans_take_every_shape_the_per_node_kernel_took(W):
    """Every state width D in 1..64 the per-node K5 took fits one of K5's
    plans (the leanest, which stages nothing optional, in fact), and the
    wrapper passes its plan check at each, with and without the affine, and
    stops only at the meta tensors' device."""
    D = np.arange(1, 65)
    took = _per_node_k5_bytes(W, D) <= SMEM
    assert took.all()
    assert (tfused._loop_bwd_bytes(W, D, tfused._LOOP_BWD_PLANS[-1]) <= SMEM).all()
    for d, affine in itertools.product(D.tolist(), (False, True)):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k5_launch(W, d, affine=affine)


@pytest.mark.parametrize("W,D,F,T,plan", [(128, 14, 3, 4, 0), (96, 64, 3, 8, 1),
                                          (128, 64, 64, 32, 1), (128, 64, 120, 32, 2),
                                          (32, 1, 0, 2, 0)])
def test_k16_plan_order(W, D, F, T, plan):
    """K16 takes the first plan that fits: the weights staged at the
    composite recipe and at a narrow block, read through the caches where
    eight or 32 wide types do not fit beside the rows, and the leanest plan
    only where the lists and keep bytes no longer fit either, at shapes the
    per-node K16 refused."""
    need, got = ttyped._bnT_fwd_plan(W, D, F, T)
    assert got == plan and need <= SMEM
    for earlier in ttyped._BNT_FWD_PLANS[:plan]:
        assert ttyped._bnT_fwd_bytes(W, D, F, T, earlier) > SMEM
    if plan == len(ttyped._BNT_FWD_PLANS) - 1:
        assert _per_node_k16_bytes(W, D, F, T) > SMEM


def test_k16_raises_above_its_last_plan():
    """(The name is from when such shapes were refused.) A shape that not
    even K16's leanest staged plan fits (W 128, D 64, T 32, the least such F)
    takes the wide plan (index 3, its bytes) and passes the wrapper's checks
    before any launch; one feature column fewer takes the leanest staged
    plan."""
    last = ttyped._BNT_FWD_PLANS[-1]
    f = next(f for f in range(0, 1024) if ttyped._bnT_fwd_bytes(128, 64, f, 32, last) > SMEM)
    need, plan = ttyped._bnT_fwd_plan(128, 64, f, 32)
    assert f > 64 and plan == 3 and need == ttyped._bnT_fwd_wide(128, 64, f, 32)[0] <= SMEM
    assert ttyped._bnT_fwd_plan(128, 64, f - 1, 32)[1] == 2
    assert _k16_checks(128, 64, f, 32) == (0, 128, 32)
    assert _k16_checks(128, 64, f - 1, 32) == (0, 128, 32)


def test_k5_raises_above_its_last_plan():
    """A state width that not even K5's leanest staged plan fits at W 128
    takes the wide plan (index 2, its bytes), as every width up to 1024
    does; one column fewer fits the leanest staged plan. Both pass every
    check of the wrapper, with and without the affine, and stop only at the
    meta device."""
    last = tfused._LOOP_BWD_PLANS[-1]
    d = next(d for d in range(1, 512) if tfused._loop_bwd_bytes(128, d, last) > SMEM)
    need, plan = tfused._loop_bwd_plan(128, d)
    assert d > 64 and plan == len(tfused._LOOP_BWD_PLANS)
    assert need == tfused._loop_bwd_wide(128, d)[0] <= SMEM
    assert tfused._loop_bwd_plan(128, d - 1)[1] == len(tfused._LOOP_BWD_PLANS) - 1
    assert all(tfused._loop_bwd_plan(128, w)[1] == plan for w in range(d, 1025))
    for width, affine in itertools.product((d, d - 1), (False, True)):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k5_launch(128, width, affine=affine)
