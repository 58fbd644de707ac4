#!/usr/bin/env python3
"""Time the register-tiled reverse kernels of two or more kernel source trees
against each other on one CUDA card.

Each tree's train_loop2_bwd.cu (K13), eval_loop2_bwd.cu (K11) and
bn2_train.cu (K15) is built alone with the port's nvcc flags, all at once,
into a library of its own under build/tiled_ab/; a tree that lacks a source
is skipped for that kernel. On chip_smoke.py's full-set operands (the
MUTAG-shaped set, K13 at the h150 training route's shapes, K11 at
h150_clean's, K15 at h150_bn's) every tree's K13 outputs must be
bit-identical to the first tree's (K11's and K15's are reported); then each
kernel is timed with CUDA events as chip_smoke.py
times it, the trees in turn and back (a, b, b, a), and, for K11 and K15, at
each shared-memory plan of the current plan lists (ops/fused2.py::_PLANS)
through the tree's gnn_*_force_plan entry, where it has one; every such plan
must fit the full-set shapes.
ptxas's report of each build goes to build/tiled_ab/ptxas.log.

Usage, from the repository root, with a parent checkout unpacked under build/:
    python3 tools/tiled_ab.py parent=build/parent/gnn_tpu_torch/ops/csrc \\
        new=gnn_tpu_torch/ops/csrc
"""

import ctypes
import importlib.util
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {"K13": "train_loop2_bwd.cu", "K11": "eval_loop2_bwd.cu", "K15": "bn2_train.cu"}


def main():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.ops import _build, bn, fused2
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = dict(a.split("=", 1) for a in sys.argv[1:])
    if len(trees) < 2:
        cs.fail("name two or more source trees as name=path")
    out_dir = os.path.join(ROOT, "build", "tiled_ab")
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(t, k, os.path.join(path, f), os.path.join(out_dir, f"lib_{t}_{k}.so"))
            for t, path in trees.items() for k, f in FILES.items()
            if os.path.isfile(os.path.join(path, f))]

    def nvcc(job):
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", job[3], job[2]],
                           capture_output=True, text=True)
        return r.returncode, r.stdout + r.stderr

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(nvcc, jobs))
    cs.say(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        for (t, k, src, _), (rc, log) in zip(jobs, built):
            f.write(f"==== {t} {k} {src} rc={rc}\n{log}\n")
            if rc:
                cs.fail(f"{t} {k}: nvcc failed\n{log[-3000:]}")

    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = {"K13": ("gnn_train_loop2_bwd", [p_] * 18 + [i_] * 9 + [f_, f_, p_]),
           "K11": ("gnn_propagation_loop2_bwd", [p_] * 17 + [i_] * 8 + [p_]),
           "K15": ("gnn_bn2_backward", [p_] * 21 + [i_] * 9 + [f_, f_, p_])}
    libs = {}
    for t, k, _, so in jobs:
        lib = ctypes.CDLL(so)
        entry, argtypes = sig[k]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = i_
        force = getattr(lib, entry + "_force_plan", None)
        if force is not None:
            force.argtypes, force.restype = [i_], None
        libs[t, k] = (lib, force)

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
        k13 = cs.two_layer_kernel_inputs(torch, gb, gb_train)[3]
        k11, _, _, x15 = cs.two_layer_train_kernel_inputs(torch, gb_train)
        runs = {"K13": (fused2.train_loop2_bwd, k13), "K11": (fused2.propagation_loop2_bwd, k11),
                "K15": (bn.bn2_backward_step, x15)}
        try:
            for k, (fn, x) in runs.items():
                names = [t for t in trees if (t, k) in libs]
                outs = {}
                for t in names:
                    _build._lib = One(libs[t, k][0])
                    outs[t] = fn(**x)
                for t in names[1:]:
                    same = all(a is None or torch.equal(a.view(torch.int32), b.view(torch.int32))
                               for a, b in zip(outs[t], outs[names[0]]))
                    cs.say(f"{k}: {t} bit-identical to {names[0]}: {same}")
                    if k == "K13" and not same:   # one design in both trees: the same sums
                        cs.fail(f"{k}: {t} differs from {names[0]}")
                plans = [None] + (list(range(len(fused2._PLANS[k]))) if k != "K13" else [])
                for plan in plans:
                    times = []
                    for t in names + names[::-1]:
                        lib, force = libs[t, k]
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
                    cs.say(f"{k} {'default plan' if plan is None else f'plan {plan} forced'}, "
                           f"ms in turn: {times}")
        finally:
            _build._lib = None
    cs.say(f"done {cs.elapsed()}")


if __name__ == "__main__":
    main()
