"""The shared-memory plans of the redesigned K1 (ops/csrc/bn_fwd.cu's
kBnFwdPlans, mirrored by ops/bn.py::_BN_FWD_PLANS, _bn_fwd_bytes and
_bn_plan) and K8 (ops/csrc/train_loop_bwd.cu's kTrainBwdPlans, mirrored by
ops/fused.py::_TRAIN_BWD_PLANS, _train_bwd_bytes and _train_bwd_plan), on
the CPU: the
mirrors' bytes at the flagship's widths against the layouts summed by hand,
the plans' fit in a CTA and the CTAs an SM they leave room for, every shape
the per-node kernels took taken by some plan (the leanest, at the latest), and
the wide plans (ops/bn.py::_bn_fwd_wide, ops/fused.py::_train_bwd_wide) beyond
the leanest staged plan, which the wrappers take with no ValueError.
chip_smoke.py holds the mirrors to the library's own gnn_bn_forward_info /
gnn_train_loop_bwd_info on the card."""

import itertools

import numpy as np
import pytest
import torch

from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tfused

SMEM = tfused.SMEM_BYTES
SM_BYTES = 228 * 1024     # an SM's shared memory; each CTA keeps 1 KB of it


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def _per_node_k1_bytes(W, D, F):
    """Shared memory a CTA of the per-node K1 took, one thread a node: the
    resident adjacency [W][W + 1], x3 rows of odd stride, two row buffers
    [W][D | 1], w_aug [D][C], the affines in a [9][D] block, the node mask
    [W] and the keep bytes (bn_train.cu's Layout before the redesign); the
    widths may be numpy arrays."""
    C1 = 2 * D + F
    return 4 * (W * (W + 1) + W * (C1 | 1) + 2 * W * (D | 1) + D * (C1 + 1) + 9 * D + W
                + (W * C1 + 3) // 4)


def _per_node_k8_bytes(W, D):
    """Shared memory a CTA of the per-node K8 took: the resident adjacency
    [W][W + 1], x2 rows [W][2D | 1], a row buffer [W][D | 1] and w_cat
    [D][2D] (train_loop.cu's bwd_smem before the redesign)."""
    return 4 * (W * (W + 1) + W * ((2 * D) | 1) + W * (D | 1) + 2 * D * D)


def _k1_launch(W, D, F):
    """K1's wrapper checks (bn._launch_forward) on meta tensors of this shape,
    with two loop rows and a residual term."""
    R = 2
    rows = [_meta(R, W, D) for _ in range(2)]
    return tbn._launch_forward(_meta(R, W, W), None, *rows, _meta(2, 2, D), None,
                               _meta(R, W, D), _meta(R, W, F), _meta(D, 2 * D + F + 1),
                               _meta(R, W), activation="selu", alpha_drop=True, rate=0.0,
                               threshold=0.01)


def _k8_launch(W, D, K=2):
    """K8's wrapper (fused.train_loop_bwd) on meta tensors of this shape."""
    B = 2
    rows = [_meta(K, B, W, D) for _ in range(4)]
    return tfused.train_loop_bwd(_meta(B, W, W), _meta(B, W, D), rows[0], rows[1], None, None,
                                 rows[2], _meta(D, 2 * D), rows[3], activation="selu",
                                 alpha_drop=True, rate=0.0)


@pytest.mark.parametrize("kernel", ["K1", "K8"])
def test_k1_and_k8_plans_at_the_flagship(kernel):
    """At the flagship's widths (W 128, D 14, F 3) K1 takes plan 0: x3 31x128,
    w_aug transposed 32x16, the affines 4x14 (56 floats), nm 128, the row
    buffer 128x15, the keep bytes 128x31 in 992 floats, lists 16x128: 9,624
    floats, and 128 counts, 2,048 sources and the list build's 8x128 counts as
    bytes: 41,696 bytes, three CTAs of 256 threads an SM with room to spare,
    against the per-node kernel's two. K8 takes plan 0: x2 28x128, dh
    14x132, dagg and the row buffer 128x15 each, w_cat transposed 28x16, the
    dw partials 14x28, lists 16x128: 12,160 floats, and the keep bytes
    2x128x14, 128 list counts and 2,048 destinations: 54,400 bytes, three CTAs
    of 256 threads an SM (the per-node kernel took 90,144, two); its second
    plan leaves the partials in device memory."""
    if kernel == "K1":
        need, plan = tbn._bn_plan("K1", 128, 14, 3)
        floats = 31 * 128 + 32 * 16 + 56 + 128 + 128 * 15 + 992 + 16 * 128
        assert (need, plan) == (4 * floats + 128 + 2048 + 8 * 128, 0) == (41696, 0)
        assert 3 * (need + 1024) <= SM_BYTES
        assert 2 * (_per_node_k1_bytes(128, 14, 3) + 1024) <= SM_BYTES < 3 * (
            _per_node_k1_bytes(128, 14, 3) + 1024)
        assert tbn._BN_FWD_PLANS[0] == (256, 16, 1) and tbn._BN_FWD_PLANS[-1] == (128, 0, 0)
    else:
        need, plan = tfused._train_bwd_plan(128, 14)
        floats = 28 * 128 + 14 * 132 + 2 * 128 * 15 + 28 * 16 + 14 * 28 + 16 * 128
        assert (need, plan) == (4 * floats + 2 * 128 * 14 + 128 + 2048, 0) == (54400, 0)
        assert 3 * (need + 1024) <= SM_BYTES
        assert 2 * (_per_node_k8_bytes(128, 14) + 1024) <= SM_BYTES < 3 * (
            _per_node_k8_bytes(128, 14) + 1024)
        assert tfused._train_bwd_bytes(128, 14, tfused._TRAIN_BWD_PLANS[-1]) == need - 4 * 14 * 28
        assert tfused._TRAIN_BWD_PLANS == (1, 0)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k1_plans_take_every_shape_the_per_node_kernel_took(W):
    """Over every D in 1..64 and F in 0..64, each shape whose per-node K1
    layout fitted 227 KB fits one of K1's plans (reckoned on the whole grid at
    once), and the wrapper's checks pass on the 16 taken shapes that leave the
    least room and on D in {1, 5, 14, 16, 17, 33, 64}, F in {0, 3, 20, 64}
    (the check _launch_forward makes before any launch)."""
    D, F = np.meshgrid(np.arange(1, 65), np.arange(0, 65), indexing="ij")
    took = _per_node_k1_bytes(W, D, F) <= SMEM
    least = np.min([tbn._bn_fwd_bytes(W, D, F, p) for p in tbn._BN_FWD_PLANS], axis=0)
    refused = took & (least > SMEM)
    assert not refused.any(), (
        f"{int(refused.sum())} shapes refused, e.g. (D, F) = "
        f"{tuple(int(v[refused][0]) for v in (D, F))}")
    assert took.sum() > 100
    room = np.where(took, SMEM - least, np.iinfo(np.int64).max).ravel()
    tight = np.argsort(room, kind="stable")[:16]
    shapes = [(int(D.ravel()[i]), int(F.ravel()[i])) for i in tight]
    shapes += [s for s in itertools.product((1, 5, 14, 16, 17, 33, 64), (0, 3, 20, 64))
               if _per_node_k1_bytes(W, *s) <= SMEM]
    for d, f in shapes:
        tbn._check_bn_plan("K1", W, d, f)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k8_plans_take_every_shape_the_per_node_kernel_took(W):
    """Every D in 1..64 (K8's state width, H == D) the per-node K8 took fits
    one of K8's plans, and the wrapper passes its plan check at each and
    stops only at the meta tensors' device; plan 0 takes the flagship's
    widths at every W."""
    D = np.arange(1, 65)
    took = _per_node_k8_bytes(W, D) <= SMEM
    least = np.min([tfused._train_bwd_bytes(W, D, p) for p in tfused._TRAIN_BWD_PLANS], axis=0)
    assert took.all() and (least <= SMEM).all()
    for d in D.tolist():
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k8_launch(W, d)
    assert tfused._train_bwd_plan(W, 14)[1] == 0


def test_k1_raises_above_its_last_plan(monkeypatch):
    """A shape that not even K1's leanest staged plan fits (W 128, D 64, the
    least such F) is the wide plan's (index 2, its bytes; one arc-label
    column fewer the leanest staged plan's): the wrapper's checks pass on
    meta tensors and stop only where the library would be loaded for the
    launch; no ValueError names the shared memory, which the wide plan keeps
    at the lists."""
    last = tbn._BN_FWD_PLANS[-1]
    f = next(f for f in range(0, 512) if tbn._bn_fwd_bytes(128, 64, f, last) > SMEM)
    need, plan = tbn._bn_plan("K1", 128, 64, f)
    assert plan == len(tbn._BN_FWD_PLANS) and need == tbn._bn_fwd_wide(128, 64, f)[0] <= SMEM
    assert tbn._bn_plan("K1", 128, 64, f - 1)[1] == len(tbn._BN_FWD_PLANS) - 1

    def no_library():
        raise ValueError("launch reached")
    monkeypatch.setattr(tbn._build, "library", no_library)
    for width in (f, f - 1):
        with pytest.raises(ValueError, match="launch reached"):
            _k1_launch(128, 64, width)
        tbn._check_bn_plan("K1", 128, 64, width)


def test_k8_raises_above_its_last_plan():
    """A state width that not even K8's leanest staged plan fits at W 128
    takes the wide plan (index 2, its bytes), and so does every width up to
    1024; one column fewer fits the leanest staged plan. Both pass every
    check of the wrapper and stop only at the meta device (no kernel takes
    meta tensors)."""
    last = tfused._TRAIN_BWD_PLANS[-1]
    d = next(d for d in range(1, 512) if tfused._train_bwd_bytes(128, d, last) > SMEM)
    need, plan = tfused._train_bwd_plan(128, d)
    assert d > 64 and plan == len(tfused._TRAIN_BWD_PLANS)
    assert need == tfused._train_bwd_wide(128, d)[0] <= SMEM
    assert tfused._train_bwd_plan(128, d - 1)[1] == len(tfused._TRAIN_BWD_PLANS) - 1
    assert all(tfused._train_bwd_plan(128, w)[1] == plan for w in range(d, 1025))
    for width in (d, d - 1):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k8_launch(128, width)
