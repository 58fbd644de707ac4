#!/usr/bin/env python3
"""Time the redesigned kernels of two or more kernel source trees against each
other on one CUDA card: K10 and K12 (the two-layer forward loops), the
register-tiled reverse kernels K13, K11 and K15, the BatchNorm step K1 and its
reverse K2, the two-layer BatchNorm step K14 and the typed reverse K17.

Each tree's source that holds a kernel's C entry (a kernel may move between
files: K12 lies in fused2.cu in older trees, in loop2.cu in newer ones) is
built alone with the port's nvcc flags, all at once, into a library of its own
under build/tiled_ab/; a tree without the entry is skipped for that kernel. On
chip_smoke.py's full-set operands (the MUTAG-shaped set: K10 at the h150
serving path's shapes, K12 and K13 at the h150 training route's, K11 at
h150_clean's, K14 and K15 at h150_bn's, K1 and K2 at the flagship's BatchNorm
route's, K17 at composite_bn's) every tree's outputs are held to the first
tree's, bit for bit for K13, K10, K1, K14 and K17 (the same sums in every tree),
reported for the others, and each tree's largest per-node difference from the plain
version is printed; then each kernel is timed with CUDA events as
chip_smoke.py times it, the trees in turn and back (a, b, b, a), and, for
K11, K15, K12, K2, K14 and K17, at each plan of the current plan lists
(ops/fused2.py::_PLANS, ops/bn.py::_BN_BWD_PLANS,
ops/typed.py::_BNT_BWD_PLANS) through the tree's gnn_*_force_plan entry,
where it has one and the plan fits.
ptxas's report of each build goes to build/tiled_ab/ptxas.log.

Usage, from the repository root, with a parent checkout unpacked under build/:
    python3 tools/tiled_ab.py parent=build/parent/gnn_tpu_torch/ops/csrc \\
        new=gnn_tpu_torch/ops/csrc
"""

import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel: its C entry, and whether every tree must give the same bits
KERNELS = {"K10": ("gnn_propagation_loop2", True), "K12": ("gnn_train_loop2", False),
           "K13": ("gnn_train_loop2_bwd", True), "K11": ("gnn_propagation_loop2_bwd", False),
           "K15": ("gnn_bn2_backward", False), "K1": ("gnn_bn_forward", True),
           "K2": ("gnn_bn_backward", False), "K14": ("gnn_bn2_forward", True),
           "K17": ("gnn_bnT_backward", True)}


def source_of(tree, entry):
    """The .cu file of `tree` that defines the C entry, or None."""
    for f in sorted(os.listdir(tree)):
        if f.endswith(".cu") and re.search(rf"\bint {entry}\(",
                                           open(os.path.join(tree, f)).read()):
            return os.path.join(tree, f)
    return None


def main():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.ops import _build, bn, fused2, typed
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = dict(a.split("=", 1) for a in sys.argv[1:])
    if len(trees) < 2:
        cs.fail("name two or more source trees as name=path")
    out_dir = os.path.join(ROOT, "build", "tiled_ab")
    os.makedirs(out_dir, exist_ok=True)
    srcs = {(t, k): source_of(path, entry) for t, path in trees.items()
            for k, (entry, _) in KERNELS.items()}
    jobs = sorted({(t, src) for (t, _), src in srcs.items() if src is not None})
    so_of = {job: os.path.join(out_dir, f"lib_{job[0]}_{os.path.basename(job[1])[:-3]}.so")
             for job in jobs}

    def nvcc(job):
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so_of[job],
                            job[1]], capture_output=True, text=True)
        return r.returncode, r.stdout + r.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(nvcc, jobs))
    cs.say(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        for (t, src), (rc, log) in zip(jobs, built):
            f.write(f"==== {t} {src} rc={rc}\n{log}\n")
            if rc:
                cs.fail(f"{t} {src}: nvcc failed\n{log[-3000:]}")
    loaded = {job: _build.bind(ctypes.CDLL(so_of[job])) for job in jobs}
    libs = {key: loaded[key[0], src] for key, src in srcs.items() if src is not None}

    class One:
        """The library the wrappers launch through: one tree's, for one kernel."""

        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

    graphs = mutag_shaped(seed=cs.SEED)
    model = cs.flagship(torch, "cuda")
    gb = Predictor(model).build_batch(graphs).to("cuda")
    gb_train = model.to_batch(graphs)
    with torch.no_grad():
        _, k10, k12, k13 = cs.two_layer_kernel_inputs(torch, gb, gb_train)
        k11, x14, kw14, x15 = cs.two_layer_train_kernel_inputs(torch, gb_train)
        comp = cs.composite_model(torch, "cuda")
        typed_gs = cs.typed_graphs(graphs)
        _, _, x17, kw17, _ = cs.typed_kernel_inputs(
            torch, comp, comp.to_batch(typed_gs), Predictor(comp).build_batch(typed_gs).to("cuda"))
        (_, x1), kw1, x2, kw2 = cs.train_kernel_inputs(torch, model, gb_train)
        runs = {"K10": (fused2, "propagation_loop2", k10), "K12": (fused2, "train_loop2", k12),
                "K13": (fused2, "train_loop2_bwd", k13),
                "K11": (fused2, "propagation_loop2_bwd", k11),
                "K15": (bn, "bn2_backward_step", x15),
                "K1": (bn, "bn_forward_step", dict(x1, **kw1)),
                "K2": (bn, "bn_backward_step", dict(x2, **kw2)),
                "K14": (bn, "bn2_forward_step", dict(x14, **kw14)),
                "K17": (typed, "bnT_backward_step", dict(x17, **kw17))}
        plan_lists = {"K11": fused2._PLANS["K11"], "K15": fused2._PLANS["K15"],
                      "K12": fused2._PLANS["K12"], "K2": bn._BN_BWD_PLANS,
                      "K14": fused2._PLANS["K14"], "K17": typed._BNT_BWD_PLANS}
        dims = {"K11": (k11["adjT"].shape[1], k11["s0"].shape[-1], k11["feats"].shape[-1],
                        k11["w0"].shape[0]),
                "K15": (x15["adj_loop"].shape[1], x15["y_prev"].shape[-1],
                        x15["feats"].shape[-1], x15["w0_aug"].shape[0]),
                "K12": (k12["adjT"].shape[1], k12["s0"].shape[-1], k12["fd"].shape[-1],
                        k12["w0"].shape[0]),
                "K2": (x2["adj_loop"].shape[1], x2["y_prev"].shape[-1], x2["feats"].shape[-1]),
                "K14": (x14["adj_loop"].shape[1], x14["y1"].shape[-1], x14["feats"].shape[-1],
                        x14["w0_aug"].shape[0]),
                "K17": (x17["adj_loop"].shape[1], x17["y_prev"].shape[-1],
                        x17["feats"].shape[-1], comp.spec.n_types)}

        def fits(k, plan):
            if k == "K2":
                return bn._bn_bwd_bytes(*dims[k], plan) <= fused2.SMEM_BYTES
            if k == "K17":
                return typed._bnT_bwd_bytes(*dims[k], plan) <= fused2.SMEM_BYTES
            return fused2._tile2_bytes(fused2._KIND[k], *dims[k], plan) <= fused2.SMEM_BYTES

        failed = []
        try:
            for k, (mod, name, x) in runs.items():
                fn = getattr(mod, name)
                names = [t for t in trees if (t, k) in libs]
                outs = {}
                want = getattr(mod, name + "_ref")(**x)
                for t in names:
                    _build._lib = One(libs[t, k])
                    outs[t] = fn(**x)
                    torch.cuda.synchronize()
                    cs.say(f"{k} {t}: largest per-node difference from the plain version "
                           f"{float((outs[t][0] - want[0]).abs().max()):.3e}")
                for t in names[1:]:
                    diff = [(i, int((a != b).sum()), float((a - b).abs().max()))
                            for i, (a, b) in enumerate(zip(outs[t], outs[names[0]]))
                            if a is not None and not torch.equal(a.view(torch.int32),
                                                                 b.view(torch.int32))]
                    cs.say(f"{k}: {t} bit-identical to {names[0]}: {not diff}"
                           + "".join(f"; output {i}: {n} entries differ, by up to {d:.3e}"
                                     for i, n, d in diff))
                    if KERNELS[k][1] and diff:   # one design in every tree: the same sums
                        failed.append(f"{k}: {t} differs from {names[0]}")
                plans = [None] + list(range(len(plan_lists.get(k, ()))))
                for plan in plans:
                    if plan is not None and not fits(k, plan_lists[k][plan]):
                        continue
                    times = []
                    for t in names + names[::-1]:
                        lib = libs[t, k]
                        force = getattr(lib, KERNELS[k][0] + "_force_plan", None)
                        if plan is not None and force is None:
                            continue
                        _build._lib = One(lib)
                        if plan is not None:
                            force(plan)
                        try:
                            times.append((t, round(cs.timed_ms(torch, lambda: fn(**x)), 4)))
                        finally:
                            if plan is not None:
                                force(-1)
                    if times:
                        cs.say(f"{k} {'default plan' if plan is None else f'plan {plan} forced'}, "
                               f"ms in turn: {times}")
        finally:
            _build._lib = None
    if failed:
        cs.fail("; ".join(failed))
    cs.say(f"done {cs.elapsed()}")


if __name__ == "__main__":
    main()
