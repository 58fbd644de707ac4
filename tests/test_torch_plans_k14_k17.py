"""The shared-memory plans of the redesigned K14 (ops/csrc/bn2_fwd.cu on
tile2.cuh's kBn2FwdPlans, mirrored by ops/fused2.py::_PLANS["K14"] and
_tile2_bytes) and K17 (ops/csrc/bn_typed.cu's kBnTBwdPlans, mirrored by
ops/typed.py::_BNT_BWD_PLANS and _bnT_bwd_bytes), on the CPU: the mirrors'
bytes at the recipes against the layouts summed by hand, the plans' fit in a
CTA and the CTAs an SM they leave room for, every shape the per-node kernels
took taken by some plan (the leanest, at the latest), and the wrappers'
ValueError beyond the leanest plan. chip_smoke.py holds the mirrors to the
library's own gnn_bn2_forward_info / gnn_bnT_backward_info on the card."""

import itertools

import numpy as np
import pytest
import torch

from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops import typed as ttyped

SMEM = tf2.SMEM_BYTES


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def _per_node_k14_bytes(W, D, F, H1):
    """Shared memory a CTA of the per-node K14 took, one thread a node: x3 rows
    of odd stride, a row buffer [W][D | 1], a [32][W + 1] adjacency slab, the
    weights w0 [H1][C], b0, w1T [H1][D], b1, the two affines [4][D] and the node
    mask (bn2_train.cu's fwd2_smem); the widths may be numpy arrays."""
    C = 2 * D + F
    return 4 * (W * (C | 1) + W * (D | 1) + 32 * (W + 1) + H1 * (C + D + 1) + 5 * D + W)


def _per_node_k17_bytes(W, D, F, T):
    """Shared memory a CTA of the per-node K17 took without the stacked
    weights (it read them through the caches where they did not fit): the
    adjacency [W][W + 1], x3 rows of odd stride, two row buffers [W][D | 1],
    bnv [T][9][D], the node mask, types and order [W] each, the types' starts
    and the keep bytes (bn_typed.cu's Layout at 9 coefficient rows); the
    widths may be numpy arrays."""
    C = 2 * D + F + 1
    return 4 * (W * (W + 1) + W * ((C - 1) | 1) + 2 * W * (D | 1) + 9 * T * D + 3 * W + T + 1
                + (W * (C - 1) + 3) // 4)


def _k14_checks(W, D, F, H1):
    """K14's wrapper checks (bn2_forward_step's _check_two_layer) on meta
    tensors of this shape, without loop rows: (Bl, W, H1)."""
    return tbn._check_two_layer(None, _meta(2, W, W), 2, D, F, _meta(H1, 2 * D + F + 1),
                                _meta(D, H1), _meta(D))


def _k17_checks(W, D, F, T):
    """K17's wrapper checks (bnT_backward_step's _check_typed) on meta tensors
    of this shape, without loop rows: (Bl, W, T)."""
    return ttyped._check_typed(None, _meta(2, W, W), 2, D, F, _meta(2, W, dtype=torch.int32),
                               _meta(T * D, 2 * D + F + 1), ("selu",) * T)


def test_k14_and_k17_plans_at_their_recipes():
    """K14 at the hidden-150 recipe (W 128, D 14, F 3, H1 150) takes plan 0:
    x3 31x128, two y0 tiles 32x128, w0T 31x156 and w1 14x156 (156 = 152 padded
    so that S / 4 is odd), b0 156, lists 16x128, b1 14, the affines 4x14, then
    the node mask 128 and the row buffer 128x15 from a 16-byte boundary and
    the keep bytes 128x31 in 992 floats, 24,496 floats, and the lists' counts
    and sources, 128 + 2048 bytes: 100,160 bytes, two CTAs an SM. K17 at the
    composite recipe (W 128, D 14, F 3, T 4) takes plan 0: x3 31x128, dh
    14x128, the weights 4x32x16, bnv 4x9x14, nm, types and order 3x128, the
    starts 8, y_prev 128x14, the keep bytes in 992 floats, the late region
    3x128x14, lists 8x128, 17,920 floats, and 128 + 1024 bytes: 72,704 bytes,
    three CTAs of 256 threads an SM."""
    need, plan = tf2._tile2_plan(128, 14, 3, 150, "K14")
    assert (need, plan) == (4 * 24496 + 128 + 2048, 0) == (100160, 0)
    assert 2 * (need + 1024) <= 228 * 1024
    need, plan = ttyped._bnT_bwd_plan(128, 14, 3, 4)
    floats = (31 * 128 + 14 * 128 + 4 * 32 * 16 + 4 * 9 * 14 + 3 * 128 + 8 + 128 * 14 + 992
              + 3 * 128 * 14 + 8 * 128)
    assert (need, plan) == (4 * floats + 128 + 1024, 0) == (72704, 0)
    assert 3 * (need + 1024) <= 228 * 1024
    assert ttyped._BNT_BWD_PLANS[0][0] == 256 and ttyped._BNT_BWD_PLANS[-1][:3] == (128, 0, 0)
    # the leanest plans stage nothing optional
    assert tf2._PLANS["K14"][-1] == (4, 1, 0, 0, 0, 0, 0, 1)
    assert ttyped._BNT_BWD_PLANS[-1] == (128, 0, 0, 0)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k14_plans_take_every_shape_the_per_node_kernel_took(W):
    """Over every D in 1..64, F in 0..64 and H1 in 1..MAX_HIDDEN, each shape
    whose per-node K14 layout fitted 227 KB fits one of K14's plans (reckoned
    on the whole grid at once), and the wrapper's checks pass on the 16 taken
    shapes that leave the least room and on D in {1, 5, 14, 17, 64}, F in {0,
    3, 64}, H1 in {1, 150, 512}."""
    D, F, H1 = np.meshgrid(np.arange(1, 65), np.arange(0, 65), np.arange(1, tf2.MAX_HIDDEN + 1),
                           indexing="ij")
    took = _per_node_k14_bytes(W, D, F, H1) <= SMEM
    least = np.min([tf2._tile2_bytes(3, W, D, F, H1, p) for p in tf2._PLANS["K14"]], axis=0)
    refused = took & (least > SMEM)
    assert not refused.any(), (
        f"{int(refused.sum())} shapes refused, e.g. (D, F, H1) = "
        f"{tuple(int(v[refused][0]) for v in (D, F, H1))}")
    assert took.sum() > 1000
    room = np.where(took, SMEM - least, np.iinfo(np.int64).max).ravel()
    for i in np.argsort(room, kind="stable")[:16]:
        d, f, h1 = (int(v.ravel()[i]) for v in (D, F, H1))
        assert _k14_checks(W, d, f, h1) == (0, W, h1)
    for d, f, h1 in itertools.product((1, 5, 14, 17, 64), (0, 3, 64), (1, 150, 512)):
        if _per_node_k14_bytes(W, d, f, h1) <= SMEM:
            assert _k14_checks(W, d, f, h1) == (0, W, h1)


def test_k14_raises_above_its_last_plan():
    """(The name is from when such shapes were refused.) A shape that not
    even K14's leanest staged plan fits (W 128, D = F = 64, the least such
    H1) takes the wide plan (index 2, its bytes) and passes the wrapper's
    checks before any launch; one hidden unit fewer takes the leanest staged
    plan."""
    last = tf2._PLANS["K14"][-1]
    h1 = next(h for h in range(1, tf2.MAX_HIDDEN + 1)
              if tf2._tile2_bytes(3, 128, 64, 64, h, last) > SMEM)
    need, plan = tf2._tile2_plan(128, 64, 64, h1, "K14")
    assert plan == 2 and need == tf2._tile2_wide(3, 128, 64, 64, h1)[0] <= SMEM
    assert tf2._tile2_plan(128, 64, 64, h1 - 1, "K14")[1] == 1
    assert _k14_checks(128, 64, 64, h1) == (0, 128, h1)
    assert _k14_checks(128, 64, 64, h1 - 1) == (0, 128, h1 - 1)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k17_plans_take_every_shape_the_per_node_kernel_took(W):
    """Over every D in 1..64, F in 0..64 and T in 1..MAX_TYPES, each shape
    whose per-node K17 layout fitted 227 KB (without the stacked weights,
    which it read through the caches where they did not fit) fits one of
    K17's plans, and the wrapper's checks pass on the 16 taken
    shapes that leave the least room and on D in {1, 5, 14, 64}, F in {0, 3,
    64}, T in {1, 4, 8, 32}."""
    D, F, T = np.meshgrid(np.arange(1, 65), np.arange(0, 65), np.arange(1, ttyped.MAX_TYPES + 1),
                          indexing="ij")
    took = _per_node_k17_bytes(W, D, F, T) <= SMEM
    least = np.min([ttyped._bnT_bwd_bytes(W, D, F, T, p) for p in ttyped._BNT_BWD_PLANS], axis=0)
    refused = took & (least > SMEM)
    assert not refused.any(), (
        f"{int(refused.sum())} shapes refused, e.g. (D, F, T) = "
        f"{tuple(int(v[refused][0]) for v in (D, F, T))}")
    assert took.sum() > 1000
    room = np.where(took, SMEM - least, np.iinfo(np.int64).max).ravel()
    for i in np.argsort(room, kind="stable")[:16]:
        d, f, t = (int(v.ravel()[i]) for v in (D, F, T))
        assert _k17_checks(W, d, f, t) == (0, W, t)
    for d, f, t in itertools.product((1, 5, 14, 64), (0, 3, 64), (1, 4, 8, 32)):
        if _per_node_k17_bytes(W, d, f, t) <= SMEM:
            assert _k17_checks(W, d, f, t) == (0, W, t)


def test_k17_raises_above_its_last_plan():
    """(The name is from when such shapes were refused.) A shape that not
    even K17's leanest staged plan fits (W 128, D = F = 64, the least such T)
    takes the wide plan (index 3, its bytes) and passes the wrapper's checks
    before any launch; one type fewer takes the leanest staged plan."""
    last = ttyped._BNT_BWD_PLANS[-1]
    t = next(t for t in range(1, ttyped.MAX_TYPES + 1)
             if ttyped._bnT_bwd_bytes(128, 64, 64, t, last) > SMEM)
    need, plan = ttyped._bnT_bwd_plan(128, 64, 64, t)
    assert plan == 3 and need == ttyped._bnT_bwd_wide(128, 64, 64, t)[0] <= SMEM
    assert ttyped._bnT_bwd_plan(128, 64, 64, t - 1)[1] == 2
    assert _k17_checks(128, 64, 64, t) == (0, 128, t)
    assert _k17_checks(128, 64, 64, t - 1) == (0, 128, t - 1)
