"""The shared-memory plans of the redesigned K3 (ops/csrc/eval_loop.cu's
kLoopPlans, mirrored by ops/fused.py::_LOOP_PLANS, _loop_bytes and _loop_plan)
and K9 (ops/csrc/tile2.cuh's kStep2Plans and layout kind kStep2, mirrored by
ops/fused2.py::_PLANS["K9"], _KIND["K9"], _tile2_bytes and _tile2_plan), on
the CPU: the mirrors' plan lists against the sources, their bytes at the
flagship's and the hidden-150 recipe's widths against the layouts summed by
hand, the plans' fit in a CTA and the CTAs an SM they leave room for, every
shape the per-node kernels took taken by some plan, K3's wide plan
(ops/fused.py::_loop_wide) beyond its leanest staged plan, and K9's
ValueError beyond its leanest plan, raised before any launch. chip_smoke.py
holds the mirrors to the library's own gnn_propagation_loop_info /
gnn_propagation_step2_info on the card."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tpu_torch.ops import fused as tfused
from gnn_tpu_torch.ops import fused2 as tf2

SMEM = tfused.SMEM_BYTES
SM_BYTES = 228 * 1024     # an SM's shared memory; each CTA keeps 1 KB of it
CSRC = Path(tfused.__file__).resolve().parent / "csrc"


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _per_node_k3_bytes(W, D):
    """Shared memory a CTA of the per-node K3 took, one thread a node: the
    resident adjacency [W][W], U[:, D:] and a staging tile [W][MAXF] each
    (MAXF = D's register width, 16, 32 or 64), w2 [2D][D] and the affine
    [2][D] (fused_eval.cu's smem_floats before the redesign); D may be a numpy
    array."""
    maxf = np.where(D <= 16, 16, np.where(D <= 32, 32, 64))
    return 4 * (W * W + 2 * W * maxf + 2 * D * D + 2 * D)


def _per_node_k9_bytes(W, D, AL, H1):
    """Shared memory a CTA of the per-node K9 took, one thread a node: the
    resident adjacency [W][W + 1], the state rows [W][D | 1], a staging tile
    [W][max(D, AL) | 1], w0 [H1][C], b0 [H1], w1 transposed [H1][D], b1 and
    the affine (fused2.cu's fwd_smem before the redesign); the widths may be
    numpy arrays."""
    C = 2 * D + AL
    return 4 * (W * (W + 1) + W * (D | 1) + W * (np.maximum(D, AL) | 1) + H1 * (C + D + 1)
                + 3 * D)


def _k3_launch(W, D, K=2):
    """K3's wrapper (fused.propagation_loop) on meta tensors of this shape."""
    B = 2
    return tfused.propagation_loop(_meta(B, W, W), _meta(B, W, D), _meta(B, W, D),
                                   _meta(2 * D, D), None, _meta(B, W), K, 0.01, "selu")


def _k9_launch(W, D, AL, H1):
    """K9's wrapper (fused2.propagation_step2) on meta tensors of this shape,
    with a residual term."""
    B = 2
    return tf2.propagation_step2(_meta(B, W, W), _meta(B, W, D), _meta(B, W, D),
                                 _meta(B, W, AL), _meta(H1, 2 * D + AL), _meta(H1),
                                 _meta(D, H1), _meta(D))


def _source_plans(path, name):
    """The plan tuples of the constexpr array `name` in a kernel source."""
    text = (CSRC / path).read_text()
    body = re.search(rf"{name}\[\] = \{{(.*?)\}};", text, re.S).group(1)
    return tuple(tuple(int(v) for v in re.findall(r"-?\d+", p))
                 for p in re.findall(r"\{([^{}]*)\}", body))


@pytest.mark.parametrize("kernel", ["K3", "K9"])
def test_mirrored_plan_lists_match_the_sources(kernel):
    """The Python plan lists are the sources' lists, in order, and K9's
    layout kind is tile2.cuh's kStep2."""
    if kernel == "K3":
        assert _source_plans("eval_loop.cu", "kLoopPlans") == tfused._LOOP_PLANS
    else:
        assert _source_plans("tile2.cuh", "kStep2Plans") == tf2._PLANS["K9"]
        kinds = (CSRC / "tile2.cuh").read_text()
        assert re.search(rf"\bkStep2 = {tf2._KIND['K9']}\b", kinds)


@pytest.mark.parametrize("kernel", ["K3", "K9"])
def test_k3_and_k9_plans_at_the_recipes(kernel):
    """At the flagship's widths (W 128, D 14) K3 takes plan 0: U 128x29, two
    state buffers and fT 128x15 each, w2 transposed 14x28, the affine 28, nm
    128, lists 16x128: 12,068 floats, and 128 counts and 2,048 sources as
    bytes: 50,448 bytes, four CTAs of 256 threads an SM by shared memory
    against the per-node kernel's two; its leanest plan drops the lists. At
    the hidden-150 recipe (W 128, D 14, AL 3, H1 150) K9 takes plan 0: x3
    31x128, two y0 tiles 2x32x128, w0 transposed 31x156 and w1 14x156 (the
    hidden stride 150 padded to 156, 156 / 4 odd), b0 156, lists 16x128, b1
    14, the affine 28, rounded to 21,428, then the row buffer 128x15: 23,348
    floats, and the list bytes: 95,568 bytes, two CTAs an SM as the per-node
    kernel's 109,176; its leanest plan (one y0 tile, no lists, w1 read from
    device memory, the hidden stride 152) takes 59,568."""
    if kernel == "K3":
        need, plan = tfused._loop_plan(128, 14)
        floats = 128 * 29 + 3 * 128 * 15 + 14 * 28 + 28 + 128 + 16 * 128
        assert (need, plan) == (4 * floats + 128 + 2048, 0) == (50448, 0)
        assert 4 * (need + 1024) <= SM_BYTES
        per_node = int(_per_node_k3_bytes(128, np.array(14)))
        assert per_node == 83600 and 2 * (per_node + 1024) <= SM_BYTES < 3 * (per_node + 1024)
        lean = tfused._loop_bytes(128, 14, tfused._LOOP_PLANS[-1])
        assert lean == 4 * (floats - 16 * 128) == 40080
        assert tfused._LOOP_PLANS == ((256, 16), (128, 0))
    else:
        need, plan = tf2._tile2_plan(128, 14, 3, 150, "K9")
        floats = 31 * 128 + 2 * 32 * 128 + 31 * 156 + 14 * 156 + 156 + 16 * 128 + 14 + 28
        assert floats == 21426
        assert (need, plan) == (4 * (21428 + 128 * 15) + 128 + 2048, 0) == (95568, 0)
        assert 2 * (need + 1024) <= SM_BYTES < 3 * (need + 1024)
        per_node = int(_per_node_k9_bytes(128, 14, 3, 150))
        assert per_node == 109176 and 2 * (per_node + 1024) <= SM_BYTES
        lean = tf2._tile2_bytes(tf2._KIND["K9"], 128, 14, 3, 150, tf2._PLANS["K9"][-1])
        assert lean == 4 * (31 * 128 + 32 * 128 + 31 * 152 + 152 + 14 + 28 + 2 + 128 * 15) == 59568


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k3_plans_take_every_shape_the_per_node_kernel_took(W):
    """Every state width D in 1..64 the per-node K3 took fits one of K3's
    plans (plan 0, in fact), and the wrapper passes its plan check at each and
    stops only at the meta tensors' device."""
    D = np.arange(1, 65)
    took = _per_node_k3_bytes(W, D) <= SMEM
    least = np.min([tfused._loop_bytes(W, D, p) for p in tfused._LOOP_PLANS], axis=0)
    assert took.all() and (least <= SMEM).all()
    assert (tfused._loop_bytes(W, D, tfused._LOOP_PLANS[0]) <= SMEM).all()
    for d in D.tolist():
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k3_launch(W, d)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k9_plans_take_every_shape_the_per_node_kernel_took(W):
    """Over every D, AL in 1..64 and H1 in 1..MAX_HIDDEN, each shape whose
    per-node K9 layout fitted 227 KB fits one of K9's plans (reckoned on the
    whole grid at once); the wrapper's checks pass on D, AL in {1, 5, 14, 16,
    17, 32, 33, 64}, H1 in {1, 7, 150, 512} and on the 16 taken shapes that
    leave the least room, and stop only at the meta tensors' device."""
    D, AL, H1 = np.meshgrid(np.arange(1, 65), np.arange(1, 65),
                            np.arange(1, tf2.MAX_HIDDEN + 1), indexing="ij")
    took = _per_node_k9_bytes(W, D, AL, H1) <= SMEM
    least = np.min([tf2._tile2_bytes(tf2._KIND["K9"], W, D, AL, H1, p)
                    for p in tf2._PLANS["K9"]], axis=0)
    refused = took & (least > SMEM)
    assert not refused.any(), (
        f"{int(refused.sum())} shapes refused, e.g. (D, AL, H1) = "
        f"{tuple(int(v[refused][0]) for v in (D, AL, H1))}")
    widths = (1, 5, 14, 16, 17, 32, 33, 64)
    shapes = [s for s in itertools.product(widths, widths, (1, 7, 150, 512))
              if _per_node_k9_bytes(W, *s) <= SMEM]
    assert len(shapes) > 100
    room = np.where(took, SMEM - least, np.iinfo(np.int64).max).ravel()
    shapes += [tuple(int(v.ravel()[i]) for v in (D, AL, H1))
               for i in np.argsort(room, kind="stable")[:16]]
    for d, al, h1 in shapes:
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k9_launch(W, d, al, h1)


def test_k3_raises_above_its_last_plan():
    """A state width that not even K3's leanest staged plan fits at W 128
    takes the wide plan (index 2, its bytes), as every width up to 1024
    does; one column fewer fits the leanest staged plan. Both pass every
    check of the wrapper, with no ValueError on the width or the shared
    memory, and stop only at the meta device."""
    last = tfused._LOOP_PLANS[-1]
    d = next(d for d in range(1, 512) if tfused._loop_bytes(128, d, last) > SMEM)
    need, plan = tfused._loop_plan(128, d)
    assert d > 64 and plan == len(tfused._LOOP_PLANS) and need == tfused._loop_wide(128, d)[0]
    assert tfused._loop_plan(128, d - 1)[1] == len(tfused._LOOP_PLANS) - 1
    assert all(tfused._loop_plan(128, w)[1] == plan for w in range(d, 1025))
    for width in (d, d - 1):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k3_launch(128, width)


def test_k9_raises_above_its_last_plan():
    """(The name is from when such shapes were refused.) A shape that not
    even K9's leanest staged plan fits (W 128, D = AL = 64, the least such
    H1) takes the wide plan (index 2, its bytes) and passes every check of
    the wrapper, stopping only at the meta device; one hidden unit fewer
    takes the leanest staged plan."""
    bytes_at = [tf2._tile2_bytes(tf2._KIND["K9"], 128, 64, 64, h1, tf2._PLANS["K9"][-1])
                for h1 in range(1, tf2.MAX_HIDDEN + 1)]
    h1 = next(h for h, b in enumerate(bytes_at, 1) if b > SMEM)
    need, plan = tf2._tile2_plan(128, 64, 64, h1, "K9")
    assert plan == 2 and need == tf2._tile2_wide(tf2._KIND["K9"], 128, 64, 64, h1)[0] <= SMEM
    assert tf2._tile2_plan(128, 64, 64, h1 - 1, "K9")[1] == 1
    with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
        _k9_launch(128, 64, 64, h1)
    with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
        _k9_launch(128, 64, 64, h1 - 1)
