#!/usr/bin/env python3
"""Time the redesigned kernels of two or more kernel source trees against each
other on one CUDA card: K10 and K12 (the two-layer forward loops), the
register-tiled reverse kernels K13, K11 and K15, the BatchNorm step K1 and its
reverse K2, the dropout loop's reverse K8, the two-layer BatchNorm step K14,
the typed reverse K17, the flagship's eval loop K3, the two-layer eval step
K9, the typed BatchNorm step K16, the clean route's eval-loop reverse K5, the
dropout route's training loop K7, the dep blocks' eval step K4, the dep
blocks' dropout-training step K6 and the CSR segment aggregation K18.

Each tree's source that holds a kernel's C entry (a kernel may move between
files: K12 lies in fused2.cu in older trees, in loop2.cu in newer ones) is
built alone (with its X_wide.cu and X_64.cu beside it where the tree has them) with the
port's nvcc flags, all at once, into a library of its own under
build/tiled_ab/; a tree without the entry is skipped for that kernel. On
chip_smoke.py's full-set operands (the MUTAG-shaped set: K10 at the h150
serving path's shapes, K12 and K13 at the h150 training route's, K11 at
h150_clean's, K14 and K15 at h150_bn's, K1 and K2 at the flagship's BatchNorm
route's, K8 at the flagship's dropout route's, K17 at composite_bn's, K3 at
the flagship serving batch's loop rows, K9 at the h150 serving batch's dep
rows and at the flat layout's 1536 rows, with and without its residual term,
K16 at composite_bn's 1214 training rows (iteration 2) and the composite
serving path's 1550 rows, K5 at the clean route's 1104 loop rows with and
without an affine, K7 at the dropout route's 1104 loop rows, K4 at the
flagship serving batch's 110 dep rows and at the flat layout's 1536 rows,
with and without its residual term, K6 at the dropout route's 110 dep rows
and the flat layout's 1194 rows, K18 on the whole set's plan (forward and
transpose) at D 14, 64 and 150 and on a ragged plan with a hub of 6000
in-arcs, and K3, K9, K16, K5, K7, K4 and K6 also at the edges of their
design, chip_smoke.py's, K7 and K6 in each dropout mode, K6 with and without
rT, K18 also at D 1, 31 and 37) every tree's outputs are held to the first
tree's, bit for bit for K13, K10, K1, K8, K14, K17, K3, K9, K16, K5, K7, K4,
K6 and K18 (the same sums in every tree),
reported for the others, and each tree's largest per-node difference from
the plain version is printed; K3, K9, K16, K5, K1, K2, K8, K7, K4 and K6 are
held so at every plan of every tree that has their gnn_*_force_plan entry,
forced in turn, and, in a tree whose kernel has a wide plan (K1-K17's,
chosen where no staged plan fits), at its wide
plan forced too; K10, K12, K13, K11, K14, K15 and K17 at every plan and the
wide plan forced likewise; K1, K2 and K8 also at D 64 (W 128) beside the full
set, so that each wide plan is held bit for bit at D 14 and 64 to the staged
plan of every tree (a parent's too). A tree whose typed kernels (K16, K17)
take node types as bytes and the activation codes packed in one 64-bit
argument (the older interface) is called through that interface on the same
operands.
Then each kernel is timed with CUDA events as chip_smoke.py times it (K3, K9,
K16, K5, K7, K4, K6 and K18 also by the profiler's device time a call, which a
launch-sized call's host work does not enter), on its full-set cases, the
trees in turn and back (a, b, b, a), and, for K11, K15, K12, K1, K2, K8, K14,
K17, K3, K9, K16 and K5, at each plan of the current plan lists
(ops/fused2.py::_PLANS, ops/bn.py::_BN_FWD_PLANS and _BN_BWD_PLANS,
ops/fused.py::_TRAIN_BWD_PLANS, _LOOP_PLANS and _LOOP_BWD_PLANS,
ops/typed.py::_BNT_BWD_PLANS and _BNT_FWD_PLANS) through the tree's
gnn_*_force_plan entry, where it has one and the plan fits. `only=K6,K18` limits the run (builds,
operands, checks and times) to those kernels.
ptxas's report of each build goes to build/tiled_ab/ptxas.log.

The bf16 variants on tensor-core tiles (K10_bf16, K15_bf16;
`only=K10_bf16,K15_bf16`) are called in each tree through that tree's own
Python wrapper (its ops/fused2.py or ops/bn.py beside csrc/, which forms the
weights its kernel takes) and held instead by chip_smoke.py's Part B gate
against the current tree's plain version, every output unsummed, and a
repeat launch bit for bit, at their main paths' full-set operands (K15_bf16
at three operand seeds) and at the widest and narrowest widths the
CUDA-core layouts took, and timed a, b, b, a by CUDA events and by the
profiler's device time a call beside their bound.

Usage, from the repository root, with a parent checkout unpacked under build/:
    python3 tools/tiled_ab.py [only=K6,K18] parent=build/parent/gnn_tpu_torch/ops/csrc \\
        new=gnn_tpu_torch/ops/csrc
"""

import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel: its C entry, and whether every tree must give the same bits
KERNELS = {"K10": ("gnn_propagation_loop2", True), "K12": ("gnn_train_loop2", False),
           "K13": ("gnn_train_loop2_bwd", True), "K11": ("gnn_propagation_loop2_bwd", False),
           "K15": ("gnn_bn2_backward", False), "K1": ("gnn_bn_forward", True),
           "K2": ("gnn_bn_backward", False), "K8": ("gnn_train_loop_bwd", True),
           "K14": ("gnn_bn2_forward", True), "K17": ("gnn_bnT_backward", True),
           "K3": ("gnn_propagation_loop", True), "K9": ("gnn_propagation_step2", True),
           "K16": ("gnn_bnT_forward", True), "K5": ("gnn_propagation_loop_bwd", True),
           "K7": ("gnn_train_loop", True), "K4": ("gnn_propagation_step", True),
           "K6": ("gnn_train_step", True), "K18": ("gnn_segment_aggregate", True)}
# the kernels timed by device time too, and those held at every plan forced
# (where a tree can force them)
PLANNED = ("K3", "K9", "K16", "K5", "K7", "K4", "K6", "K18")
FORCED = PLANNED + ("K1", "K2", "K8", "K10", "K12", "K13", "K11", "K14", "K15", "K17")
# the kernels with a wide plan after their staged plans, in a tree whose
# source holds one
WIDE = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12", "K13",
        "K14", "K15", "K16", "K17")
# the typed entries' argument positions of the node types and of the
# activation codes (the same in both interfaces)
TYPED_ARGS = {"gnn_bnT_forward": (5, 22), "gnn_bnT_backward": (5, 24)}
# the bf16 variants on tensor-core tiles, held to their plain versions by
# chip_smoke.py's Part B gate (not bit for bit across trees): kernel: (C
# entry, the wrapper's module, the wrapper)
BF16_TILED = {"K10_bf16": ("gnn_propagation_loop2_bf16", "fused2", "propagation_loop2_bf16"),
              "K15_bf16": ("gnn_bn2_backward_bf16", "bn", "bn2_backward_step_bf16")}


def has_wide(src):
    """Whether a kernel source holds a wide plan (its kernel templated on it)."""
    return src is not None and "bool WIDE" in open(src).read()


def packed_types(src):
    """Whether a typed kernel source takes the node types as bytes and the
    activation codes packed in one 64-bit argument (the older interface)."""
    return src is not None and "unsigned long long acts" in open(src).read()


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
    from gnn_tpu_torch.ops import _build, bn, fused, fused2, segment, typed
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    only = args.pop("only", ",".join(list(KERNELS) + list(BF16_TILED))).split(",")
    kernels = {k: v for k, v in KERNELS.items() if k in only}
    kernels.update({k: (v[0], False) for k, v in BF16_TILED.items() if k in only})
    ops = {"fused2": fused2, "bn": bn}
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
        """The source's library, with its wide plans' and its register-width-64
        plans' sources beside it where the tree has them (X_wide.cu, X_64.cu:
        instantiations X.cu's C entries launch)."""
        srcs_ = [job[1]] + [s for s in (job[1][:-3] + "_wide.cu", job[1][:-3] + "_64.cu")
                            if os.path.exists(s)]
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so_of[job],
                            *srcs_], capture_output=True, text=True)
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

    case = {}   # the typed operands of the call in flight (node types, activations)

    class One:
        """The library the wrappers launch through: one tree's, for one kernel
        (a tree without wide plans has no gnn_*_workspace entries: its staged
        plans need no workspace; a tree with packed typed arguments is called
        with the node types as bytes and the codes packed, 2 bits a type)."""

        def __init__(self, lib, packed=False):
            self.lib, self.packed = lib, packed

        def __getattr__(self, name):
            if name.endswith("_workspace") and not hasattr(self.lib, name):
                return lambda *dims: 0
            fn = getattr(self.lib, name)
            if not (self.packed and name in TYPED_ARGS):
                return fn
            ti, ai = TYPED_ARGS[name]

            def call(*args):
                types8 = case["types"].to(torch.uint8)
                codes = sum(fused._ACT_CODE[a] << (2 * t)
                            for t, a in enumerate(case["activations"]))
                args = list(args)
                args[ti], args[ai] = types8.data_ptr(), codes
                return fn(*args)
            return call

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

    def typed_full():
        def build():
            comp = cs.composite_model(torch, "cuda")
            typed_gs = cs.typed_graphs(graphs)
            return cs.typed_kernel_inputs(torch, comp, comp.to_batch(typed_gs),
                                          Predictor(comp).build_batch(typed_gs).to("cuda"))
        return once("typed", build)

    def k17():
        _, _, x17, kw17, _ = typed_full()
        return dict(x17, **kw17), x17["bnv"].shape[0]

    gen = torch.Generator().manual_seed(cs.SEED + 40)

    def k3_cases():
        """K3 at the flagship serving batch's loop rows, then at chip_smoke.py's
        edges of its design."""
        spec = model.spec
        kw = dict(K=spec.max_iteration, threshold=float(spec.threshold),
                  activation=spec.state_spec.activations[0])
        cases = [("full set", dict(cs.kernel_inputs(model, gb)[0], **kw), True)]
        for B, W, D, K, act, edge in ((4, 32, 1, 3, "tanh", "W 32, D 1"),
                                      (2, 128, 64, 2, "selu", "D 64"),
                                      (3, 96, 14, 4, "relu", "W 96"),
                                      (3, 128, 14, 3, "selu", "a dense block"),
                                      (3, 128, 14, 3, "tanh", "a destination of 40 arcs"),
                                      (3, 128, 14, 1, "selu", "K 1")):
            x = cs.random_inputs(torch, gen, B, W, D, D, "cuda", res=False)
            adjT = (cs.random_adj(torch, gen, B, W, "cuda", dense=True)
                    if edge == "a dense block" else x["adjT"])
            if edge == "a destination of 40 arcs":
                adjT[:, :40, 5] = 0.05
            nm = (torch.rand(B, W, generator=gen) < 0.8).float().to("cuda")
            cases.append((edge, dict(adjT=adjT, s0=x["s"], fT=x["fT"], w2=x["w2"],
                                     affine=x["affine"], nm=nm, K=K, threshold=0.05,
                                     activation=act), False))
        return cases

    def k9_cases():
        """K9 at the h150 serving batch's dep rows and at the flat layout's
        every block, with and without the residual term, then at chip_smoke.py's
        tiling edges that the per-node kernel took."""
        from gnn_tpu_torch.models import core
        h150 = cs.flagship(torch, "cuda", "flat_h150")
        gbf = Predictor(h150, fused_layout=False).build_batch(graphs).to("cuda")
        with torch.no_grad():
            _, dep = core.hybrid2_operands(h150.spec, h150.params["state"], h150.bn["state"], gbf)
        flat = dict(dep, rT=core.residual_agg(gbf, dep["s"]),
                    **dict(zip(("act0", "act1"), h150.spec.state_spec.activations)))
        cases = []
        for label, x in (("dep rows", two()[0]), ("flat layout", flat)):
            cases += [(label, x, True), (label + ", res=False", dict(x, rT=None), False)]
        for B, W, D, AL, H1, acts, dense in ((3, 128, 14, 3, 1, ("selu", "selu"), False),
                                             (3, 128, 14, 3, 7, ("tanh", "selu"), False),
                                             (3, 96, 14, 3, 33, ("selu", "tanh"), False),
                                             (2, 128, 14, 3, 512, ("selu", "selu"), False),
                                             (4, 32, 1, 1, 16, ("tanh", "tanh"), False),
                                             (2, 64, 64, 64, 150, ("selu", "tanh"), False),
                                             (3, 128, 14, 3, 150, ("selu", "selu"), True),
                                             (2, 32, 15, 59, 511, ("tanh", "selu"), False)):
            x = cs.random_two_layer_inputs(torch, gen, B, W, D, AL, H1, 2, acts, 0.0, True,
                                           "cuda", dense=dense)[0]
            if H1 == 7:     # a destination of 40 arcs
                x["adjT"][:, :40, 5] = 0.05
            label = f"edge W={W} D={D} AL={AL} H1={H1}{' dense' if dense else ''}"
            cases += [(label, x, False), (label + ", res=False", dict(x, rT=None), False)]
        return cases

    def k16_cases():
        """K16 at composite_bn's training rows (iteration 2) and the composite
        serving path's rows, then at chip_smoke.py's edges of its design that
        the per-node kernel took."""
        (_, x1), kw, _, _, (ev, kwe) = typed_full()
        cases = [(f"training rows ({x1['y1'].shape[0]})", dict(x1, **kw), True),
                 (f"serving rows ({ev['y1'].shape[0]})", dict(ev, **kwe), True)]
        for R, Bl, W, D, F, acts, rate, res, edge in (
                (3, 1, 32, 1, 3, ("tanh", "selu"), 0.1, True, "W 32, D 1"),
                (3, 2, 128, 64, 3, ("selu", "tanh"), 0.1, True, "D 64"),
                (3, 2, 128, 14, 3, ("selu",) * 4, 0.1, True, "a dense block"),
                (3, 2, 128, 14, 3, ("selu", "relu", "tanh"), 0.1, True, "a destination of 40 arcs"),
                (3, 2, 128, 14, 3, ("selu",), 0.1, True, "T 1"),
                (3, 2, 128, 14, 3, ("selu", "tanh", "relu", "linear") * 2, 0.1, True,
                 "T 8, mixed activations"),
                (3, 2, 128, 14, 3, ("selu",) * 4, 0.0, False, "no dropout, no rT"),
                (3, 2, 128, 64, 3, ("selu",) * 8, 0.1, True, "weights read through the caches")):
            f, _, k = cs.random_typed_inputs(torch, gen, R, Bl, W, D, F, acts, rate, True, res,
                                             None, "cuda")
            if edge == "a dense block":
                f = dict(f, adj_loop=cs.random_adj(torch, gen, Bl, W, "cuda", dense=True),
                         adj_dep=cs.random_adj(torch, gen, R - Bl, W, "cuda", dense=True))
            if edge == "a destination of 40 arcs":
                for a in (f["adj_loop"], f["adj_dep"]):
                    a[:, :40, 5] = 0.05
            cases.append((edge, dict(f, **k, threshold=0.05), False))
        return cases

    def k5_cases():
        """K5 at the clean route's loop rows without and with an affine, then
        at chip_smoke.py's edges of its design, with and without the affine."""
        x5 = cs.bnfree_kernel_inputs(torch, gb_train)[0]
        D = x5["s0"].shape[-1]
        aff = torch.stack([torch.rand(D, generator=gen) + 0.5,
                           0.1 * torch.randn(D, generator=gen)]).to("cuda")
        cases = [(f"loop rows ({x5['adjT'].shape[0]})", x5, True),
                 (f"loop rows ({x5['adjT'].shape[0]}), affine", dict(x5, affine=aff), True)]
        for B, W, D, K, act, edge in ((4, 32, 1, 3, "tanh", "W 32, D 1"),
                                      (2, 64, 64, 2, "selu", "D 64 at W 64"),
                                      (2, 128, 64, 2, "selu", "D 64"),
                                      (3, 128, 14, 3, "selu", "a dense block"),
                                      (3, 128, 14, 3, "relu", "a node of 40 arcs each way"),
                                      (3, 128, 14, 1, "selu", "K 1"),
                                      (3, 128, 14, 5, "tanh", "K 5")):
            x = cs.random_bnfree_inputs(torch, gen, B, W, D, D, K, 0.0, True, act, "cuda",
                                        dense=edge == "a dense block",
                                        line=edge == "a node of 40 arcs each way",
                                        column=edge == "a node of 40 arcs each way")[0]
            cases += [(edge + ", affine", x, False), (edge, dict(x, affine=None), False)]
        return cases

    def k7_cases():
        """K7 at the dropout route's loop rows, then at chip_smoke.py's edges of
        its design, each in the three dropout modes."""
        x7 = cs.bnfree_kernel_inputs(torch, gb_train)[2]
        cases = [(f"loop rows ({x7['adjT'].shape[0]})", x7, True)]
        for B, W, D, K, act, edge in ((4, 32, 1, 3, "tanh", "W 32, D 1"),
                                      (2, 128, 64, 2, "selu", "D 64"),
                                      (3, 96, 14, 4, "relu", "W 96"),
                                      (3, 128, 14, 3, "selu", "a dense block"),
                                      (3, 128, 14, 3, "tanh", "a destination of 40 arcs"),
                                      (3, 128, 14, 1, "selu", "K 1")):
            for rate, alpha in ((0.1, True), (0.1, False), (0.0, True)):
                x = cs.random_bnfree_inputs(torch, gen, B, W, D, D, K, rate, alpha, act, "cuda",
                                            dense=edge == "a dense block",
                                            column=edge == "a destination of 40 arcs")[2]
                cases.append((f"{edge}, rate={rate} alpha={alpha}", x, False))
        return cases

    def k4_cases():
        """K4 at the flagship serving batch's dep rows and at the flat layout's
        every block, with and without the residual term, then at
        chip_smoke.py's edges of its design, with and without it."""
        act = model.spec.state_spec.activations[0]
        flat = cs.flagship(torch, "cuda", "flat_bn")
        gbf = Predictor(flat, fused_layout=False).build_batch(graphs).to("cuda")
        cases = []
        for label, x in ((f"dep rows ({gb.adj_dep.shape[0]})", cs.kernel_inputs(model, gb)[1]),
                         (f"flat layout ({gbf.adj_dep.shape[0]})", cs.kernel_inputs(flat, gbf)[1])):
            x = dict(x, activation=act)
            cases += [(label, x, True), (label + ", res=False", dict(x, rT=None), True)]
        for B, W, D, H, act_r, edge in ((4, 32, 1, 1, "tanh", "W 32, D = H = 1"),
                                        (2, 128, 64, 64, "selu", "D = H = 64"),
                                        (3, 96, 14, 14, "relu", "W 96"),
                                        (3, 128, 14, 14, "selu", "a dense block"),
                                        (3, 128, 14, 14, "tanh", "a destination of 40 arcs"),
                                        (3, 64, 6, 9, "relu", "D 6, H 9"),
                                        (2, 128, 64, 5, "selu", "D 64, H 5")):
            x = dict(cs.random_inputs(torch, gen, B, W, D, H, "cuda", res=True), activation=act_r)
            if edge == "a dense block":
                x["adjT"] = cs.random_adj(torch, gen, B, W, "cuda", dense=True)
            if edge == "a destination of 40 arcs":
                x["adjT"][:, :40, 5] = 0.05
            cases += [(edge, x, False), (edge + ", res=False", dict(x, rT=None), False)]
        return cases

    def k6_cases():
        """K6 at the dropout route's dep rows and the flat layout's every
        block, then at chip_smoke.py's edges of its design, each in the three
        dropout modes, with and without rT."""
        from gnn_tpu_torch.graphs.batch import from_graphs_blocked
        x6 = cs.bnfree_kernel_inputs(torch, gb_train)[1]
        gbf = from_graphs_blocked(graphs, block_w=128, focus="g").to("cuda")
        flat = cs.dep_step_operands(torch, cs.flagship(torch, "cuda", "flat_dropout"), gbf,
                                    cs.SEED + 31)
        cases = []
        for label, x in ((f"dep rows ({x6['adjT'].shape[0]})", x6),
                         (f"flat layout ({flat['adjT'].shape[0]})", flat)):
            cases += [(label, x, True), (label + ", res=False", dict(x, rT=None), False)]
        for B, W, D, H, act, edge in ((4, 32, 1, 1, "tanh", "W 32, D = H = 1"),
                                      (2, 128, 64, 64, "selu", "D = H = 64"),
                                      (3, 96, 14, 14, "relu", "W 96"),
                                      (3, 128, 14, 14, "selu", "a dense block"),
                                      (3, 128, 14, 14, "tanh", "a destination of 40 arcs"),
                                      (3, 64, 6, 9, "relu", "D 6, H 9"),
                                      (2, 128, 64, 5, "selu", "D 64, H 5")):
            for rate, alpha in ((0.1, True), (0.1, False), (0.0, True)):
                x = cs.random_bnfree_inputs(torch, gen, B, W, D, H, 2, rate, alpha, act, "cuda",
                                            dense=edge == "a dense block",
                                            column=edge == "a destination of 40 arcs")[1]
                label = f"{edge}, rate={rate} alpha={alpha}"
                cases += [(label, x, False), (label + ", res=False", dict(x, rT=None), False)]
        return cases

    def k18_cases():
        """K18 on the whole set's plan, forward and transpose, at D 14, 64 and
        150 (timed) and 1 and 31, and on chip_smoke.py's ragged plan (a hub,
        an isolated node, unsorted arcs, weight-0 pads) at D 14 (timed: the
        hub's chain) and 37."""
        from gnn_tpu_torch.graphs.generator import GraphDataGenerator
        gbp = next(iter(GraphDataGenerator(graphs, batch_size=len(graphs), shuffle=False,
                                           build_plan=True))).to("cuda")
        src, dst, w, N = cs.ragged_plan(torch, gen)
        ragged = segment.build_agg_plan(src, dst, w, N).to("cuda")
        cases = []
        for D in (14, 64, 150, 1, 31):
            x = torch.randn(gbp.n_node_pad, D, generator=gen).cuda()
            for d, plan in (("forward", gbp.agg_plan.fwd), ("transpose", gbp.agg_plan.bwd)):
                cases.append((f"whole set, {d}, D={D}", dict(state=x, plan=plan), D in (14, 64, 150)))
        for D in (14, 37):
            x = torch.randn(N, D, generator=gen).cuda()
            for d, plan in (("forward", ragged.fwd), ("transpose", ragged.bwd)):
                cases.append((f"ragged plan, {d}, D={D}", dict(state=x, plan=plan),
                              D == 14 and d == "forward"))
        return cases

    def full(x):
        return [("full set", x, True)]

    def d64(k, x):
        """K1's, K2's or K8's full-set case, then one at D 64 (W 128) in the
        full set's dropout mode."""
        if k == "K8":
            edge = cs.random_bnfree_inputs(torch, gen, 2, 128, 64, 64, 2, x["rate"],
                                           x["alpha_drop"], "selu", "cuda")[3]
        else:
            f, b = cs.random_bn_inputs(torch, gen, 3, 2, 128, 64, 3, x["rate"], True, "cuda")
            kw = {a: x[a] for a in ("activation", "alpha_drop", "rate")}
            edge = dict(f, **kw, threshold=0.05) if k == "K1" else dict(b, **kw)
        return full(x) + [("D 64", edge, False)]

    # kernel: (module, wrapper, cases [(label, operands, timed)], plan list or
    # None, the plan bytes' widths of an operand set)
    setups = {
        "K10": lambda: (fused2, "propagation_loop2", full(two()[1]), fused2._PLANS["K10"],
                        lambda x: dims2(x, "s0", "feats", "w0")),
        "K12": lambda: (fused2, "train_loop2", full(two()[2]), fused2._PLANS["K12"],
                        lambda x: dims2(x, "s0", "fd", "w0")),
        "K13": lambda: (fused2, "train_loop2_bwd", full(two()[3]), fused2._PLANS["K13"],
                        lambda x: dims2(x, "s0", "fd", "w0")),
        "K11": lambda: (fused2, "propagation_loop2_bwd", full(two_train()[0]),
                        fused2._PLANS["K11"], lambda x: dims2(x, "s0", "feats", "w0")),
        "K15": lambda: (bn, "bn2_backward_step", full(two_train()[3]), fused2._PLANS["K15"],
                        lambda x: dims2(x, "y_prev", "feats", "w0_aug")),
        "K14": lambda: (bn, "bn2_forward_step", full(dict(two_train()[1], **two_train()[2])),
                        fused2._PLANS["K14"], lambda x: dims2(x, "y1", "feats", "w0_aug")),
        "K1": lambda: (bn, "bn_forward_step",
                       d64("K1", dict(bn_train()[0][1], **bn_train()[1])),
                       bn._BN_FWD_PLANS, lambda x: dims2(x, "y1", "feats")),
        "K2": lambda: (bn, "bn_backward_step", d64("K2", dict(bn_train()[2], **bn_train()[3])),
                       bn._BN_BWD_PLANS, lambda x: dims2(x, "y_prev", "feats")),
        "K8": lambda: (fused, "train_loop_bwd", d64("K8", k8()), fused._TRAIN_BWD_PLANS,
                       lambda x: dims2(x, "s0")),
        "K17": lambda: (typed, "bnT_backward_step", full(k17()[0]), typed._BNT_BWD_PLANS,
                        lambda x: dims2(x, "y_prev", "feats") + (k17()[1],)),
        "K3": lambda: (fused, "propagation_loop", k3_cases(), fused._LOOP_PLANS,
                       lambda x: dims2(x, "s0")),
        "K9": lambda: (fused2, "propagation_step2", k9_cases(), fused2._PLANS["K9"],
                       lambda x: dims2(x, "s", "feats", "w0")),
        "K16": lambda: (typed, "bnT_forward_step", k16_cases(), typed._BNT_FWD_PLANS,
                        lambda x: dims2(x, "y1", "feats") + (x["aff"].shape[2],)),
        "K5": lambda: (fused, "propagation_loop_bwd", k5_cases(), fused._LOOP_BWD_PLANS,
                       lambda x: dims2(x, "s0")),
        "K7": lambda: (fused, "train_loop", k7_cases(), (fused._TRAIN_LOOP_PLAN,),
                       lambda x: dims2(x, "s0")),
        "K4": lambda: (fused, "propagation_step", k4_cases(), (fused._STEP_PLAN,),
                       lambda x: dims2(x, "s", "fT")),
        "K6": lambda: (fused, "train_step", k6_cases(), (fused._TRAIN_STEP_PLAN,),
                       lambda x: dims2(x, "s", "fT")),
        "K18": lambda: (segment, "segment_aggregate", k18_cases(), None, None),
    }
    nbytes = {"K1": bn._bn_fwd_bytes, "K2": bn._bn_bwd_bytes, "K8": fused._train_bwd_bytes,
              "K17": typed._bnT_bwd_bytes, "K3": fused._loop_bytes, "K16": typed._bnT_fwd_bytes,
              "K5": fused._loop_bwd_bytes,
              "K7": lambda W, D, p: fused._train_loop_bytes(W, D),
              "K4": lambda W, D, H, p: fused._step_bytes(W, D, H),
              "K6": lambda W, D, H, p: fused._train_step_bytes(W, D, H)}

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

    def outputs(r):
        return r if isinstance(r, tuple) else (r,)

    def bf16_adj(g, B, W):
        arcs = torch.rand(B, W, W, generator=g) < 0.05
        return (arcs / arcs.sum(1, keepdim=True).clamp_min(1)).to(torch.bfloat16).to("cuda")

    def bf16_tiled(k):
        """K10_bf16 at the bf16 h150 serving batch's 1440 loop rows; K15_bf16
        at the bf16 h150_bn training batch's 1214 block rows (iteration 2's
        reverse), its operands at three seeds (weights, masks and
        cotangents; chip_smoke.SEED 0, 1, 2); then each at random operands
        of the widest and narrowest widths the CUDA-core layouts took (K10_bf16
        D 163 at W 128, and a hidden width in two chunks; K15_bf16 7D + F =
        326 at W 128 both ways, and W 32 at D 1, F 0), untimed: [(label,
        operands, outputs, rounding point, grads, timed)]."""
        bf16 = torch.bfloat16
        g = torch.Generator().manual_seed(cs.SEED + 50)

        def r(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=g)).to("cuda")

        def mask(*shape):
            return (torch.rand(*shape, generator=g) < 0.85).float().to("cuda")
        if k == "K10_bf16":
            gb16 = Predictor(cs.flagship(torch, "cpu", "h150"), adj_dtype=bf16).build_batch(
                graphs).to("cuda")
            gbt16 = cs.flagship(torch, "cuda", "h150_clean").to_batch(graphs, adj_dtype=bf16)
            k10 = cs.bf16_kernel_inputs(torch, gb16, gbt16)[1]
            out = [(f"loop rows ({k10['adjT'].shape[0]})", k10, True)]
            for B, W, D, H1, K, acts in ((3, 128, 163, 150, 2, ("tanh", "tanh")),
                                         (3, 128, 14, 1000, 2, ("selu", "selu")),
                                         (4, 32, 5, 7, 3, ("relu", "selu"))):
                x = dict(adjT=bf16_adj(g, B, W), s0=r(B, W, D, scale=0.5),
                         fT=r(B, W, H1, scale=0.3), w20=r(2 * H1, D, scale=D ** -0.5),
                         w1=r(D, H1, scale=H1 ** -0.5), b1=r(D, scale=0.1),
                         affine=torch.stack([1 + r(D, scale=0.1), r(D, scale=0.1)]),
                         nm=mask(B, W), K=K, threshold=0.01, act0=acts[0], act1=acts[1])
                out.append((f"W {W}, D {D}, H1 {H1} (hidden chunk "
                            f"{fused2.loop2_bf16_layout(W, D, H1)[0]})", x, False))
            return [(label, x, ("traj", "margins"), "ua", False, timed) for label, x, timed in out]
        out, seed = [], cs.SEED
        try:
            for cs.SEED in (0, 1, 2):
                m = cs.flagship(torch, "cuda", "h150_bn")
                gbt16 = m.to_batch(graphs, adj_dtype=bf16)
                _, _, x15, kwb = cs.train_kernel_inputs(torch, m, gbt16)
                out.append((f"block rows ({gbt16.adj_loop.shape[0] + gbt16.adj_dep.shape[0]}), "
                            f"seed {cs.SEED}", dict(x15, **kwb), True))
        finally:
            cs.SEED = seed
        for R, Bl, W, D, F, H1 in ((3, 2, 128, 46, 4, 150), (3, 2, 128, 1, 319, 33),
                                   (3, 1, 32, 1, 0, 20)):
            C = 2 * D + F + 1
            adj = bf16_adj(g, R, W)
            x = dict(adj_loop=adj[:Bl].contiguous(), adj_dep=adj[Bl:].contiguous(),
                     y_prev=r(R, W, D), y_k=r(R, W, D), agg=r(R, W, D),
                     keep=(torch.rand(R, W, C - 1, generator=g) > 0.1).to(torch.uint8).cuda(),
                     feats=r(R, W, F, scale=0.5), w0_aug=r(H1, C, scale=0.6 / C ** 0.5),
                     w1=r(D, H1, scale=H1 ** -0.5), b1=r(D, scale=0.1),
                     ds_in=r(R, W, D, scale=0.1), gsel=r(R, W, D, scale=0.1),
                     bnv=0.5 + r(9, D).abs(), flag=torch.ones((), device="cuda"), nm=mask(R, W),
                     act0="selu", act1="tanh", alpha_drop=True, rate=0.1)
            out.append((f"W {W}, D {D}, F {F}, H1 {H1} (layout "
                        f"{bn.bn2_bf16_layout(W, D, F)})", x, False))
        return [(label, x, ("ds", "dw0", "dw1", "db1", "dagg", "red"), "dh0", True, timed)
                for label, x, timed in out]

    def tree_wrapper(t, k):
        """Tree t's own Python wrapper of bf16 kernel k (the tree's
        ops/fused2.py or ops/bn.py, loaded as a module of its own; it launches
        through _build._lib) beside the current tree's plain version."""
        _, mod, name = BF16_TILED[k]
        path = os.path.join(os.path.dirname(os.path.abspath(trees[t])), mod + ".py")
        spec = importlib.util.spec_from_file_location(f"tiled_ab_{t}_{mod}", path)
        m = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = m     # dataclasses look their module up there
        spec.loader.exec_module(m)
        return types.SimpleNamespace(**{name: getattr(m, name),
                                        name + "_ref": getattr(ops[mod], name + "_ref")})

    def run_bf16_tiled(failed):
        """Each tree's bf16 tile kernel held to the plain version by Part B's
        gate (chip_smoke.check_bf16_kernels) and a repeat launch bit for bit
        (a tree that fails goes into `failed`, and the others go on), then
        timed in turn (a, b, b, a) by CUDA events and by the profiler's device
        time a call."""
        for k in BF16_TILED:
            if k not in kernels:
                continue
            name = BF16_TILED[k][2]
            names = [t for t in trees if (t, k) in libs]
            wrappers = {t: tree_wrapper(t, k) for t in names}
            for label, x, outs_, point, grads, timed in bf16_tiled(k):

                def use(t):
                    _build._lib = One(libs[t, k])
                    return getattr(wrappers[t], name)
                for t in names:
                    fn = use(t)
                    cs.say(f"{k} {label}, {t}:")
                    try:
                        err = cs.check_bf16_kernels(
                            torch, [(k, wrappers[t], name, x, outs_, point, (), grads)])[k]
                        cs.check_repeat(torch, f"{k} {t}", fn, x, label)
                    except SystemExit:   # chip_smoke.fail: this tree fails, the others go on
                        failed.append(f"{k} {label}: {t} fails against the plain version")
                        continue
                    cs.say(f"{k} {label}, {t}: largest difference from the plain version "
                           f"{err:.3e}; a repeat launch bit-identical")
                if not timed:
                    continue
                times = []
                for t in names + names[::-1]:
                    fn = use(t)
                    times.append((t, round(cs.timed_ms(torch, lambda: fn(**x)), 4)))
                    times.append((t + " device",
                                  round(cs.device_ms(torch, lambda: fn(**x), 1, runs=20), 4)))
                b, by = cs.bf16_bounds({k: x})[k]
                cs.say(f"{k} {label}, ms in turn: {times}; bound {b:.4f} ms ({by}); {cs.CARD}")

    with torch.no_grad():
        failed = []
        try:
            run_bf16_tiled(failed)
            for k in kernels:
                if k in BF16_TILED:
                    continue
                mod, name, cases, plan_list, dims_of = setups[k]()
                fn = getattr(mod, name)
                entry, exact = kernels[k]
                names = [t for t in trees if (t, k) in libs]
                for label, x, timed in cases:
                    dims = None if plan_list is None else dims_of(x)
                    case.clear()
                    case.update({a: x[a] for a in ("types", "activations") if a in x})
                    outs = {}
                    want = outputs(getattr(mod, name + "_ref")(**x))
                    for t in names:
                        _build._lib = One(libs[t, k], packed_types(srcs[t, k]))
                        outs[t] = outputs(fn(**x))
                        torch.cuda.synchronize()
                        cs.say(f"{k} {label}, {t}: largest per-node difference from the plain "
                               f"version {float((outs[t][0] - want[0]).abs().max()):.3e}")
                    if k in FORCED:   # every plan of every tree that forces them
                        for t in names:
                            force = getattr(libs[t, k], entry + "_force_plan", None)
                            staged = list(plan_list or ()) if force else []
                            forced = [i for i, plan in enumerate(staged) if fits(k, plan, dims)]
                            if force and k in WIDE and has_wide(srcs[t, k]):
                                forced.append(len(staged))   # the wide plan fits every shape
                            for i in forced:
                                _build._lib = One(libs[t, k], packed_types(srcs[t, k]))
                                force(i)
                                try:
                                    what = "wide plan" if i == len(staged) else f"plan {i}"
                                    outs[f"{t} {what} forced"] = outputs(fn(**x))
                                finally:
                                    force(-1)
                        torch.cuda.synchronize()
                    for t in list(outs)[1:]:
                        diff = [(i, int((a != b).sum()), float((a - b).abs().max()))
                                for i, (a, b) in enumerate(zip(outs[t], outs[names[0]]))
                                if a is not None and not torch.equal(a.view(torch.int32),
                                                                     b.view(torch.int32))]
                        cs.say(f"{k} {label}: {t} bit-identical to {names[0]}: {not diff}"
                               + "".join(f"; output {i}: {n} entries differ, by up to {d:.3e}"
                                         for i, n, d in diff))
                        if exact and diff:   # one design in every tree: the same sums
                            failed.append(f"{k} {label}: {t} differs from {names[0]}")
                    if not timed:
                        continue
                    for plan in [None] + list(range(len(plan_list or ()))):
                        if plan is not None and (len(plan_list) == 1
                                                 or not fits(k, plan_list[plan], dims)):
                            continue
                        times = []
                        for t in names + names[::-1]:
                            lib = libs[t, k]
                            force = getattr(lib, entry + "_force_plan", None)
                            if plan is not None and force is None:
                                continue
                            _build._lib = One(lib, packed_types(srcs[t, k]))
                            if plan is not None:
                                force(plan)
                            try:
                                times.append((t, round(cs.timed_ms(torch, lambda: fn(**x)), 4)))
                                if k in PLANNED:   # and the profiler's device time a call
                                    times.append((t + " device",
                                                  round(cs.device_ms(torch, lambda: fn(**x), 1), 4)))
                            finally:
                                if plan is not None:
                                    force(-1)
                        if times:
                            cs.say(f"{k} {label}, "
                                   f"{'default plan' if plan is None else f'plan {plan} forced'}, "
                                   f"ms in turn: {times}")
        finally:
            _build._lib = None
    if failed:
        cs.fail("; ".join(failed))
    cs.say(f"done {cs.elapsed()}")


if __name__ == "__main__":
    main()
