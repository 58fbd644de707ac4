#!/usr/bin/env python3
"""Time the redesigned kernels of two or more kernel source trees against each
other on one CUDA card: K10 and K12 (the two-layer forward loops), the
register-tiled reverse kernels K13, K11 and K15, the BatchNorm step K1 and its
reverse K2, the dropout loop's reverse K8, the two-layer BatchNorm step K14
and the typed reverse K17.

Each tree's source that holds a kernel's C entry (a kernel may move between
files: K12 lies in fused2.cu in older trees, in loop2.cu in newer ones) is
built alone with the port's nvcc flags, all at once, into a library of its own
under build/tiled_ab/; a tree without the entry is skipped for that kernel. On
chip_smoke.py's full-set operands (the MUTAG-shaped set: K10 at the h150
serving path's shapes, K12 and K13 at the h150 training route's, K11 at
h150_clean's, K14 and K15 at h150_bn's, K1 and K2 at the flagship's BatchNorm
route's, K8 at the flagship's dropout route's, K17 at composite_bn's) every
tree's outputs are held to the first tree's, bit for bit for K13, K10, K1, K8,
K14 and K17 (the same sums in every tree), reported for the others, and each
tree's largest per-node difference from the plain version is printed; then
each kernel is timed with CUDA events as chip_smoke.py times it, the trees in
turn and back (a, b, b, a), and, for K11, K15, K12, K1, K2, K8, K14 and K17,
at each plan of the current plan lists (ops/fused2.py::_PLANS,
ops/bn.py::_BN_FWD_PLANS and _BN_BWD_PLANS, ops/fused.py::_TRAIN_BWD_PLANS,
ops/typed.py::_BNT_BWD_PLANS) through the tree's gnn_*_force_plan entry,
where it has one and the plan fits. `only=K1,K8` limits the run (builds,
operands, checks and times) to those kernels.
ptxas's report of each build goes to build/tiled_ab/ptxas.log.

Usage, from the repository root, with a parent checkout unpacked under build/:
    python3 tools/tiled_ab.py [only=K1,K8] parent=build/parent/gnn_tpu_torch/ops/csrc \\
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
           "K2": ("gnn_bn_backward", False), "K8": ("gnn_train_loop_bwd", True),
           "K14": ("gnn_bn2_forward", True), "K17": ("gnn_bnT_backward", True)}


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
    from gnn_tpu_torch.ops import _build, bn, fused, fused2, typed
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    only = args.pop("only", ",".join(KERNELS)).split(",")
    kernels = {k: v for k, v in KERNELS.items() if k in only}
    trees = args
    if len(trees) < 2:
        cs.fail("name two or more source trees as name=path")
    out_dir = os.path.join(ROOT, "build", "tiled_ab")
    os.makedirs(out_dir, exist_ok=True)
    srcs = {(t, k): source_of(path, entry) for t, path in trees.items()
            for k, (entry, _) in kernels.items()}
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
    cache = {}

    def once(key, build):
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def two():
        return once("two", lambda: cs.two_layer_kernel_inputs(torch, gb, gb_train))

    def two_train():
        return once("two_train", lambda: cs.two_layer_train_kernel_inputs(torch, gb_train))

    def bn_train():
        return once("bn", lambda: cs.train_kernel_inputs(torch, model, gb_train))

    def k8():
        return once("k8", lambda: cs.bnfree_kernel_inputs(torch, gb_train)[3])

    def k17():
        def build():
            comp = cs.composite_model(torch, "cuda")
            typed_gs = cs.typed_graphs(graphs)
            _, _, x17, kw17, _ = cs.typed_kernel_inputs(
                torch, comp, comp.to_batch(typed_gs),
                Predictor(comp).build_batch(typed_gs).to("cuda"))
            return dict(x17, **kw17), comp.spec.n_types
        return once("k17", build)

    # kernel: (module, wrapper, operands, plan list or None, the plan bytes' widths)
    setups = {
        "K10": lambda: (fused2, "propagation_loop2", two()[1], None, None),
        "K12": lambda: (fused2, "train_loop2", two()[2], fused2._PLANS["K12"],
                        dims2(two()[2], "s0", "fd", "w0")),
        "K13": lambda: (fused2, "train_loop2_bwd", two()[3], None, None),
        "K11": lambda: (fused2, "propagation_loop2_bwd", two_train()[0], fused2._PLANS["K11"],
                        dims2(two_train()[0], "s0", "feats", "w0")),
        "K15": lambda: (bn, "bn2_backward_step", two_train()[3], fused2._PLANS["K15"],
                        dims2(two_train()[3], "y_prev", "feats", "w0_aug")),
        "K14": lambda: (bn, "bn2_forward_step", dict(two_train()[1], **two_train()[2]),
                        fused2._PLANS["K14"], dims2(two_train()[1], "y1", "feats", "w0_aug")),
        "K1": lambda: (bn, "bn_forward_step", dict(bn_train()[0][1], **bn_train()[1]),
                       bn._BN_FWD_PLANS, dims2(bn_train()[0][1], "y1", "feats")),
        "K2": lambda: (bn, "bn_backward_step", dict(bn_train()[2], **bn_train()[3]),
                       bn._BN_BWD_PLANS, dims2(bn_train()[2], "y_prev", "feats")),
        "K8": lambda: (fused, "train_loop_bwd", k8(), fused._TRAIN_BWD_PLANS, dims2(k8(), "s0")),
        "K17": lambda: (typed, "bnT_backward_step", k17()[0], typed._BNT_BWD_PLANS,
                        dims2(k17()[0], "y_prev", "feats") + (k17()[1],)),
    }
    nbytes = {"K1": bn._bn_fwd_bytes, "K2": bn._bn_bwd_bytes, "K8": fused._train_bwd_bytes,
              "K17": typed._bnT_bwd_bytes}

    def dims2(x, rows, f=None, w0=None):
        """(W, D[, F or AL[, H1]]) of a kernel's operands."""
        adj = next(x[a] for a in ("adjT", "adj_loop", "adj_dep") if x.get(a) is not None)
        out = (adj.shape[1], x[rows].shape[-1])
        out += () if f is None else (x[f].shape[-1],)
        return out + (() if w0 is None else (x[w0].shape[0],))

    def fits(k, plan, dims):
        if k in nbytes:
            return nbytes[k](*dims, plan) <= fused2.SMEM_BYTES
        return fused2._tile2_bytes(fused2._KIND[k], *dims, plan) <= fused2.SMEM_BYTES

    with torch.no_grad():
        failed = []
        try:
            for k in kernels:
                mod, name, x, plan_list, dims = setups[k]()
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
                    if kernels[k][1] and diff:   # one design in every tree: the same sums
                        failed.append(f"{k}: {t} differs from {names[0]}")
                plans = [None] + list(range(len(plan_list or ())))
                for plan in plans:
                    if plan is not None and not fits(k, plan_list[plan], dims):
                        continue
                    times = []
                    for t in names + names[::-1]:
                        lib = libs[t, k]
                        force = getattr(lib, kernels[k][0] + "_force_plan", None)
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
