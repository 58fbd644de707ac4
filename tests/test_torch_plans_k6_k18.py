"""The shared-memory plan of K6 (ops/csrc/train_loop.cu's kTrainStepThreads
and kTrainStepLists, mirrored by ops/fused.py::_TRAIN_STEP_PLAN and
_train_step_bytes) and the launch of K18 (ops/csrc/segment_agg.cu's
kAggThreads and agg_launch, mirrored by ops/segment.py::_AGG_THREADS and
_agg_launch), on the CPU: the mirrors against the sources, K6's bytes at the
flagship's widths and at its largest and smallest shapes against the layout
summed by hand, the CTAs an SM it leaves room for, every shape the per-node K6
took taken by its staged plan, the wide plan beyond it (no ValueError on the
widths), its wrapper's ValueError on a misaligned operand, raised on meta
tensors before any launch; K18's groups
of lanes covering every row and feature once. chip_smoke.py holds the mirrors
to the library's own gnn_train_step_info / gnn_segment_aggregate_info on the
card."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tpu_torch.ops import fused as tfused
from gnn_tpu_torch.ops import segment as tseg

SMEM = tfused.SMEM_BYTES
SM_BYTES = 228 * 1024     # an SM's shared memory; each CTA keeps 1 KB of it
CSRC = Path(tfused.__file__).resolve().parent / "csrc"


def _meta(*shape, dtype=torch.float32, offset=0):
    """A meta tensor of `shape`, starting `offset` elements into its storage
    (a misaligned operand where the offset is not a multiple of 16 bytes)."""
    n = int(np.prod(shape))
    return torch.empty(n + offset, device="meta", dtype=dtype)[offset:].view(shape)


def _per_node_k6_bytes(W, D, H):
    """Shared memory a CTA of the per-node K6 took, one thread a node: the
    resident adjacency [W][W + 1], a staging buffer [W][max(D, H) | 1], x2
    rows [W][2D | 1] and w_cat [H][2D] (train_loop.cu's step_smem before the
    redesign); the widths may be numpy arrays."""
    return 4 * (W * (W + 1) + W * (np.maximum(D, H) | 1) + W * ((2 * D) | 1) + 2 * H * D)


def _k6_launch(W, D, H, rate=0.1, res=True, bad=None):
    """K6's wrapper (fused.train_step) on meta tensors of this shape; the
    operand named `bad` starts one element past a 16-byte boundary."""
    B = 2

    def t(name, *shape, dtype=torch.float32):
        return _meta(*shape, dtype=dtype, offset=int(name == bad))
    return tfused.train_step(t("adjT", B, W, W), t("s", B, W, D), t("sd", B, W, D),
                             t("m", B, W, D, dtype=torch.uint8),
                             t("rT", B, W, D) if res else None, t("fT", B, W, H),
                             t("w_cat", H, 2 * D), "selu", alpha_drop=True, rate=rate)


@pytest.fixture
def launched(monkeypatch):
    """The wrapper's checks run on meta tensors as on CUDA ones: the block
    check passes any device, and a launch is recorded (by its C entry's
    name) in place of being made."""
    seen = []
    monkeypatch.setattr(tfused, "_check_block", lambda adjT, D, H: None)
    monkeypatch.setattr(tfused, "_launch", lambda key, device, *args: seen.append(key))
    return seen


def test_k6_mirrored_plan_matches_the_source():
    """The Python plan is the source's staged plan: 256 threads, column lists
    of 16; the source's second plan is the wide plan (a template
    instantiation, no plan list), which its force entry can choose; none of
    the per-node kernel's helpers remain."""
    text = (CSRC / "train_loop.cu").read_text()
    m = re.search(r"constexpr int kTrainStepThreads = (\d+), kTrainStepLists = (\d+);", text)
    assert (int(m.group(1)), int(m.group(2))) == tfused._TRAIN_STEP_PLAN == (256, 16)
    assert "gnn_train_step_info" in text and "gnn_train_step_force_plan" in text
    assert "train_step_kernel<true>" in text and "Plans[]" not in text
    common = (CSRC / "common.cuh").read_text()
    for gone in ("dense_acc", "step_smem", "launch_step", "stage_adj", "stage_in", "stage_out",
                 "aggregate_col"):
        assert gone not in text and gone not in common, gone


def test_k6_plan_at_the_flagship():
    """At the flagship's widths (W 128, D = H = 14) K6's plan takes s, sd,
    agg, rT and fT 5x128x15, w_cat transposed 28x16, lists 16x128: 12,096
    floats, and the keep bytes 128x14, 128 counts and 2,048 sources as bytes:
    52,352 bytes, four CTAs an SM against the per-node kernel's two (90,144
    bytes)."""
    need = tfused._train_step_bytes(128, 14, 14)
    floats = 5 * 128 * 15 + 28 * 16 + 16 * 128
    assert floats == 12096
    assert need == 4 * floats + 128 * 14 + 128 + 2048 == 52352
    assert 4 * (need + 1024) <= SM_BYTES < 5 * (need + 1024)
    per_node = int(_per_node_k6_bytes(128, np.array(14), np.array(14)))
    assert per_node == 90144 and 2 * (per_node + 1024) <= SM_BYTES < 3 * (per_node + 1024)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k6_plan_takes_every_shape_the_per_node_kernel_took(W):
    """Every (D, H) in 1..64 x 1..64 the per-node K6 took fits K6's one
    plan, and the wrapper passes its checks with and without dropout and rT
    at the shapes that leave the least room and at D, H in {1, 14, 33, 64},
    stopping only at the meta tensors' device."""
    D, H = np.meshgrid(np.arange(1, 65), np.arange(1, 65), indexing="ij")
    assert (_per_node_k6_bytes(W, D, H) <= SMEM).all()
    need = np.vectorize(tfused._train_step_bytes)(W, D, H)
    assert (need <= SMEM).all()
    room = (SMEM - need).ravel()
    shapes = {(int(D.ravel()[i]), int(H.ravel()[i])) for i in np.argsort(room, kind="stable")[:8]}
    shapes |= set(itertools.product((1, 14, 33, 64), repeat=2))
    for (d, h), rate, res in itertools.product(sorted(shapes), (0.0, 0.1), (True, False)):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k6_launch(W, d, h, rate=rate, res=res)


@pytest.mark.parametrize("W,D,H", [(128, 64, 64), (32, 1, 1), (64, 6, 9), (128, 64, 5)])
def test_k6_plan_summed_by_hand(W, D, H):
    """At the largest shape the per-node kernel took (W 128, D = H = 64), at
    the smallest (W 32, D = H = 1, where agg's region is widened to the list
    build's counts [8][W] as bytes) and at D != H both ways, the plan's bytes
    are its layout summed by hand, within a CTA's limit."""
    r4, E = tfused._r4, tfused._TRAIN_STEP_PLAN[1]
    rows = r4(W * (D | 1))
    floats = 3 * rows + max(rows, 2 * W) + r4(W * (H | 1)) + 2 * D * r4(H) + E * W
    got = tfused._train_step_bytes(W, D, H)
    assert got == 4 * floats + W * D + W + E * W <= SMEM
    if (W, D, H) == (128, 64, 64):
        assert got == 217728
    if (W, D, H) == (32, 1, 1):
        assert max(rows, 2 * W) == 2 * W > rows


def test_k6_raises_beyond_the_widths_its_plan_takes(monkeypatch):
    """K6 takes every width: a width read or written of 65, and the first
    width read the staged plan no longer fits at W 128 and H 64 (the wide
    plan's, index 1), pass the block check and stop only at the meta device;
    with the device check lifted they pass every check and reach the launch.
    Only a block width the kernel does not take raises the wrapper's
    ValueError."""
    d = next(d for d in range(1, 1024) if tfused._train_step_bytes(128, d, 64) > SMEM)
    assert d > 65
    assert tfused._train_step_plan(128, d, 64) == (tfused._train_step_wide(128, d, 64)[0], 1)
    assert tfused._train_step_plan(128, 65, 14)[1] == tfused._train_step_plan(128, 14, 65)[1] == 0
    shapes = ((65, 14), (14, 65), (d, 64))
    for D, H in shapes:
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k6_launch(128, D, H)
    with pytest.raises(ValueError, match="block width must be 32, 64, 96 or 128"):
        _k6_launch(48, 14, 14)
    seen = []
    monkeypatch.setattr(tfused, "_check_block", lambda adjT, D, H: None)
    monkeypatch.setattr(tfused, "_launch", lambda key, device, *args: seen.append(key))
    for D, H in shapes:
        y, agg = _k6_launch(128, D, H)
        assert y.shape == (2, 128, H) and agg.shape == (2, 128, D)
    assert seen == ["train_step"] * 3


@pytest.mark.parametrize("bad", ["adjT", "s", "sd", "m", "rT", "fT", "w_cat"])
def test_k6_raises_on_a_misaligned_operand(bad, launched):
    """An operand that does not start on a 16-byte boundary (the kernel
    copies the keep bytes 16 bytes at a time and reads the adjacency so)
    raises the wrapper's ValueError naming it, and nothing is launched;
    without dropout the keep bytes are not read and not checked, and the
    launch is made."""
    with pytest.raises(ValueError, match=f"{bad} must be 16-byte aligned"):
        _k6_launch(128, 14, 14, bad=bad)
    assert launched == []
    if bad == "m":
        _k6_launch(128, 14, 14, rate=0.0, bad=bad)
        assert launched == ["train_step"]


@pytest.mark.parametrize("rate,res", [(0.0, True), (0.1, True), (0.1, False)])
def test_k6_aligned_operands_reach_the_launch(rate, res, launched):
    """With every operand aligned the checks pass and the wrapper makes its
    one launch, with and without dropout and rT, at D != H."""
    y, agg = _k6_launch(96, 6, 9, rate=rate, res=res)
    assert y.shape == (2, 96, 9) and agg.shape == (2, 96, 6) and launched == ["train_step"]


def test_k18_mirrored_launch_matches_the_source():
    """The Python launch is the source's: 256 threads a CTA, float4 lanes
    where D % 4 == 0, float2 where D % 2 == 0, else floats, L the least power
    of two covering D / V vectors, at most 32; at the widths chip_smoke.py
    checks it takes these (V, L)."""
    text = (CSRC / "segment_agg.cu").read_text()
    m = re.search(r"constexpr int kAggThreads = (\d+);", text)
    assert int(m.group(1)) == tseg._AGG_THREADS == 256
    assert "a.V = D % 4 == 0 ? 4 : D % 2 == 0 ? 2 : 1;" in text
    assert "while (a.L < nvec && a.L < 32) a.L *= 2;" in text
    assert "a.rows = kAggThreads / a.L;" in text
    want = {1: (1, 1), 2: (2, 1), 4: (4, 1), 8: (4, 2), 14: (2, 8), 31: (1, 32), 37: (1, 32),
            64: (4, 16), 150: (2, 32), 256: (4, 32)}
    for D, (V, L) in want.items():
        assert tseg._agg_launch(196608, D) == (V, L, 256 // L, -(-196608 // (256 // L)))


@pytest.mark.parametrize("D", list(range(1, 70)) + [127, 128, 129, 150, 300])
def test_k18_lanes_cover_every_row_and_feature_once(D):
    """The kernel's index arithmetic (a group of L lanes a row, lane g's
    vectors v0 + g for v0 = 0, L, 2L, ... below D / V) on the mirrored launch:
    every (row, feature) of N rows is written exactly once, by a V-wide
    vector starting on a multiple of V, and no lane reads past its row."""
    N = 53
    V, L, rows, ctas = tseg._agg_launch(N, D)
    assert D % V == 0 and L & (L - 1) == 0 and 1 <= L <= 32 and rows * L == tseg._AGG_THREADS
    hits = np.zeros((N, D), np.int64)
    for t in range(ctas * tseg._AGG_THREADS):
        r, g = t // L, t % L      # blockIdx * rows + threadIdx / L, lane within the group
        if r >= N:
            continue
        for v0 in range(0, D // V, L):
            if v0 + g < D // V:
                f0 = (v0 + g) * V
                hits[r, f0:f0 + V] += 1
    assert (hits == 1).all()
    assert ctas * rows >= N > (ctas - 1) * rows
