"""The shared-memory plans of the redesigned K7 (ops/csrc/train_loop.cu's
kTrainLoopThreads and kTrainLoopLists, mirrored by
ops/fused.py::_TRAIN_LOOP_PLAN and _train_loop_bytes) and K4
(ops/csrc/fused_eval.cu's kStepThreads and kStepLists, mirrored by
ops/fused.py::_STEP_PLAN and _step_bytes), on the CPU: the mirrors against
the sources, their bytes at the flagship's widths against the layouts summed
by hand, the CTAs an SM the plans leave room for, every shape the per-node
kernels took taken by each kernel's staged plan, the wide plan beyond it (no
ValueError on the widths), and the wrappers' ValueError on a misaligned
operand, raised on meta tensors before any launch. chip_smoke.py holds the mirrors to
the library's own gnn_train_loop_info / gnn_propagation_step_info on the
card."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tpu_torch.ops import fused as tfused

SMEM = tfused.SMEM_BYTES
SM_BYTES = 228 * 1024     # an SM's shared memory; each CTA keeps 1 KB of it
CSRC = Path(tfused.__file__).resolve().parent / "csrc"


def _meta(*shape, dtype=torch.float32, offset=0):
    """A meta tensor of `shape`, starting `offset` elements into its storage
    (a misaligned operand where the offset is not a multiple of 16 bytes)."""
    n = int(np.prod(shape))
    return torch.empty(n + offset, device="meta", dtype=dtype)[offset:].view(shape)


def _per_node_k7_bytes(W, D):
    """Shared memory a CTA of the per-node K7 took, one thread a node: the
    resident adjacency [W][W + 1], the state and a staging buffer [W][D | 1]
    each, x2 rows [W][2D | 1] and w_cat [D][2D] (train_loop.cu's loop_smem
    before the redesign); D may be a numpy array."""
    return 4 * (W * (W + 1) + 2 * W * (D | 1) + W * ((2 * D) | 1) + 2 * D * D)


def _per_node_k4_bytes(W, D, H):
    """Shared memory a CTA of the per-node K4 took, one thread a node: the
    resident adjacency [W][W], U[:, H:] and a staging tile [W][MAXF] each
    (MAXF = the register width of max(D, H), 16, 32 or 64), w2 [2H][D] and
    the affine [2][H] (fused_eval.cu's smem_floats before the redesign); the
    widths may be numpy arrays."""
    F = np.maximum(D, H)
    maxf = np.where(F <= 16, 16, np.where(F <= 32, 32, 64))
    return 4 * (W * W + 2 * W * maxf + 2 * H * D + 2 * H)


def _k7_launch(W, D, K=2, rate=0.1, bad=None):
    """K7's wrapper (fused.train_loop) on meta tensors of this shape; the
    operand named `bad` starts one element past a 16-byte boundary."""
    B = 2

    def t(name, *shape, dtype=torch.float32):
        return _meta(*shape, dtype=dtype, offset=int(name == bad))
    return tfused.train_loop(t("adjT", B, W, W), t("s0", B, W, D),
                             t("ms", K, B, W, D, dtype=torch.uint8),
                             t("ma", K, B, W, D, dtype=torch.uint8), t("fT", K, B, W, D),
                             t("w_cat", D, 2 * D), t("nm", B, W), K, 0.01, "selu",
                             alpha_drop=True, rate=rate)


def _k4_launch(W, D, H, res=True, bad=None):
    """K4's wrapper (fused.propagation_step) on meta tensors of this shape,
    with the affine; the operand named `bad` starts one element past a
    16-byte boundary."""
    B = 2

    def t(name, *shape):
        return _meta(*shape, offset=int(name == bad))
    return tfused.propagation_step(t("adjT", B, W, W), t("s", B, W, D),
                                   t("rT", B, W, H) if res else None, t("fT", B, W, H),
                                   t("w2", 2 * H, D), t("affine", 2, H), "selu")


@pytest.fixture
def launched(monkeypatch):
    """The wrappers' checks run on meta tensors as on CUDA ones: the block
    check passes any device, and a launch is recorded (by its C entry's
    name) in place of being made."""
    seen = []
    monkeypatch.setattr(tfused, "_check_block", lambda adjT, D, H: None)
    monkeypatch.setattr(tfused, "_launch", lambda key, device, *args: seen.append(key))
    return seen


def _source_plan(path, threads, lists):
    """(threads, list room) of a kernel source's constexpr plan constants."""
    text = (CSRC / path).read_text()
    m = re.search(rf"constexpr int {threads} = (\d+), {lists} = (\d+);", text)
    return int(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("kernel", ["K7", "K4"])
def test_mirrored_plans_match_the_sources(kernel):
    """The Python plans are the sources' staged plans: 256 threads, with
    column lists (8 for K7, 16 for K4); each source's second plan is its
    wide plan (a template instantiation, no plan list), which its force
    entry can choose."""
    if kernel == "K7":
        path, plan = "train_loop.cu", tfused._TRAIN_LOOP_PLAN
        assert _source_plan(path, "kTrainLoopThreads", "kTrainLoopLists") == plan == (256, 8)
        entry = "gnn_train_loop"
    else:
        path, plan = "fused_eval.cu", tfused._STEP_PLAN
        assert _source_plan(path, "kStepThreads", "kStepLists") == plan == (256, 16)
        entry = "gnn_propagation_step"
    text = (CSRC / path).read_text()
    assert f"{entry}_info" in text and f"{entry}_force_plan" in text
    assert "Plans[]" not in text.split("// K6's design")[0]
    assert ("train_loop_kernel<true>" if kernel == "K7" else "step_kernel<true>") in text


@pytest.mark.parametrize("kernel", ["K7", "K4"])
def test_k7_and_k4_plans_at_the_flagship(kernel):
    """At the flagship's widths (W 128, D = H = 14) K7's plan takes two
    state buffers, agg and fT 4x128x15, w_cat transposed 28x16, nm 128,
    lists 8x128: 9,280 floats, and the keep bytes 2x128x14, 128 counts and
    1,024 sources as bytes: 41,856 bytes, five CTAs an SM against the
    per-node kernel's two (97,824 bytes). K4's takes U 128x29, s, fT and rT
    128x15 each, w2 transposed 14x28, the affine 28, lists 16x128: 11,940
    floats, and 128 counts and 2,048 sources: 49,936 bytes, four CTAs an SM
    against the per-node kernel's two (83,600 bytes)."""
    if kernel == "K7":
        need = tfused._train_loop_bytes(128, 14)
        floats = 4 * 128 * 15 + 28 * 16 + 128 + 8 * 128
        assert floats == 9280
        assert need == 4 * floats + 2 * 128 * 14 + 128 + 1024 == 41856
        assert 5 * (need + 1024) <= SM_BYTES < 6 * (need + 1024)
        per_node = int(_per_node_k7_bytes(128, np.array(14)))
        assert per_node == 97824 and 2 * (per_node + 1024) <= SM_BYTES < 3 * (per_node + 1024)
    else:
        need = tfused._step_bytes(128, 14, 14)
        floats = 128 * 29 + 3 * 128 * 15 + 14 * 28 + 28 + 16 * 128
        assert floats == 11940
        assert need == 4 * floats + 128 + 2048 == 49936
        assert 4 * (need + 1024) <= SM_BYTES < 5 * (need + 1024)
        per_node = int(_per_node_k4_bytes(128, np.array(14), np.array(14)))
        assert per_node == 83600 and 2 * (per_node + 1024) <= SM_BYTES < 3 * (per_node + 1024)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k7_plan_takes_every_shape_the_per_node_kernel_took(W):
    """Every state width D in 1..64 the per-node K7 took fits K7's one plan,
    and the wrapper passes its checks at each, with and without dropout,
    stopping only at the meta tensors' device."""
    D = np.arange(1, 65)
    assert (_per_node_k7_bytes(W, D) <= SMEM).all()
    assert (tfused._train_loop_bytes(W, D) <= SMEM).all()
    for d, rate in itertools.product(D.tolist(), (0.0, 0.1)):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k7_launch(W, d, rate=rate)


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_k4_plan_takes_every_shape_the_per_node_kernel_took(W):
    """Every (D, H) in 1..64 x 1..64 the per-node K4 took fits K4's one
    plan, and the wrapper passes its checks, with and without rT, at the
    shapes that leave the least room and at D, H in {1, 14, 33, 64},
    stopping only at the meta tensors' device."""
    D, H = np.meshgrid(np.arange(1, 65), np.arange(1, 65), indexing="ij")
    assert (_per_node_k4_bytes(W, D, H) <= SMEM).all()
    need = tfused._step_bytes(W, D, H)
    assert (need <= SMEM).all()
    room = (SMEM - need).ravel()
    shapes = {(int(D.ravel()[i]), int(H.ravel()[i])) for i in np.argsort(room, kind="stable")[:8]}
    shapes |= set(itertools.product((1, 14, 33, 64), repeat=2))
    for (d, h), res in itertools.product(sorted(shapes), (True, False)):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k4_launch(W, d, h, res=res)


@pytest.mark.parametrize("kernel,W,D,H", [("K7", 128, 64, 0), ("K7", 32, 1, 0),
                                          ("K4", 128, 64, 64), ("K4", 32, 1, 1)])
def test_the_plans_at_the_largest_and_smallest_shapes(kernel, W, D, H):
    """At the largest shape the per-node kernels took (W 128, D = H = 64)
    and at the smallest (W 32, D = H = 1) each plan's bytes are its layout
    summed by hand, within a CTA's limit: K7 four [W][D|1] row buffers,
    w_cat transposed, nm, the keep bytes and the lists; K4 U, s, fT and rT,
    w2 transposed, the affine and the lists."""
    DP, r4 = D | 1, tfused._r4
    if kernel == "K7":
        E = tfused._TRAIN_LOOP_PLAN[1]
        rows = 4 * r4(W * DP) + 2 * D * r4(D) + r4(W)
        want = 4 * (rows + E * W) + 2 * W * D + W + E * W
        got = tfused._train_loop_bytes(W, D)
    else:
        E = tfused._STEP_PLAN[1]
        rows = r4(W * ((2 * H) | 1)) + r4(W * DP) + 2 * r4(W * (H | 1)) + D * r4(2 * H) + r4(2 * H)
        want = 4 * (rows + E * W) + W + E * W
        got = tfused._step_bytes(W, D, H)
    assert got == want <= SMEM
    if (W, D) == (128, 64):
        assert got == (188032 if kernel == "K7" else 209536)


def test_k7_raises_beyond_the_widths_its_plan_takes(monkeypatch):
    """K7 takes every state width: D 65 (its staged plan, index 0) and the
    first width the staged plan no longer fits at W 128 (the wide plan,
    index 1) pass the block check and stop only at the meta device; with
    the device check lifted they reach the launch. Only a block width the
    kernel does not take raises the wrapper's ValueError."""
    d = next(d for d in range(1, 512) if tfused._train_loop_bytes(128, d) > SMEM)
    assert d > 65
    assert tfused._train_loop_plan(128, 65)[1] == 0
    assert tfused._train_loop_plan(128, d) == (tfused._train_loop_wide(128, d)[0], 1)
    for width in (65, d):
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k7_launch(128, width)
    with pytest.raises(ValueError, match="block width must be 32, 64, 96 or 128"):
        _k7_launch(160, 14)
    seen = []
    monkeypatch.setattr(tfused, "_check_block", lambda adjT, D, H: None)
    monkeypatch.setattr(tfused, "_launch", lambda key, device, *args: seen.append(key))
    for width in (65, d):
        traj, margins, agg = _k7_launch(128, width)
        assert traj.shape[-1] == agg.shape[-1] == width
    assert seen == ["train_loop"] * 2


def test_k4_raises_beyond_the_widths_its_plan_takes(monkeypatch):
    """K4 takes every width: a width read or written of 65 (its staged plan)
    and the first width read the staged plan no longer fits at W 128 and H
    64 (the wide plan, index 1) pass the block check and stop only at the
    meta device; with the device check lifted they reach the launch. Only a
    block width the kernel does not take raises the wrapper's ValueError."""
    d = next(d for d in range(1, 1024) if tfused._step_bytes(128, d, 64) > SMEM)
    assert d > 65
    assert tfused._step_plan(128, 65, 14)[1] == tfused._step_plan(128, 14, 65)[1] == 0
    assert tfused._step_plan(128, d, 64) == (tfused._step_wide(128, d, 64)[0], 1)
    shapes = ((65, 14), (14, 65), (d, 64))
    for D, H in shapes:
        with pytest.raises(ValueError, match="need CPU or CUDA tensors"):
            _k4_launch(128, D, H)
    with pytest.raises(ValueError, match="block width must be 32, 64, 96 or 128"):
        _k4_launch(48, 14, 14)
    seen = []
    monkeypatch.setattr(tfused, "_check_block", lambda adjT, D, H: None)
    monkeypatch.setattr(tfused, "_launch", lambda key, device, *args: seen.append(key))
    for D, H in shapes:
        assert _k4_launch(128, D, H).shape == (2, 128, H)
    assert seen == ["propagation_step"] * 3


@pytest.mark.parametrize("bad", ["adjT", "s0", "ms", "ma", "fT", "w_cat", "nm"])
def test_k7_raises_on_a_misaligned_operand(bad, launched):
    """An operand that does not start on a 16-byte boundary (the kernel
    copies rows, the node mask and the keep bytes 16 bytes at a time and
    reads the adjacency so) raises the wrapper's ValueError naming it, and
    nothing is launched; without dropout the keep bytes are not read and not
    checked, and the launch is made."""
    with pytest.raises(ValueError, match=f"{bad} must be 16-byte aligned"):
        _k7_launch(128, 14, bad=bad)
    assert launched == []
    if bad in ("ms", "ma"):
        _k7_launch(128, 14, rate=0.0, bad=bad)
        assert launched == ["train_loop"]


@pytest.mark.parametrize("bad", ["adjT", "s", "rT", "fT", "w2", "affine"])
def test_k4_raises_on_a_misaligned_operand(bad, launched):
    """An operand of K4 that does not start on a 16-byte boundary raises the
    wrapper's ValueError naming it, and nothing is launched."""
    with pytest.raises(ValueError, match=f"{bad} must be 16-byte aligned"):
        _k4_launch(128, 14, 14, bad=bad)
    assert launched == []


@pytest.mark.parametrize("kernel,option", [("K7", 0.0), ("K7", 0.1), ("K4", True),
                                           ("K4", False)])
def test_aligned_operands_reach_the_launch(kernel, option, launched):
    """With every operand aligned the wrappers' checks pass and each makes
    its one launch, K7 with and without dropout, K4 with and without rT."""
    if kernel == "K7":
        traj, margins, agg = _k7_launch(96, 14, K=3, rate=option)
        assert traj.shape == agg.shape == (3, 2, 96, 14) and margins.shape == (3, 2, 96)
        assert launched == ["train_loop"]
    else:
        out = _k4_launch(96, 6, 9, res=option)
        assert out.shape == (2, 96, 9) and launched == ["propagation_step"]
