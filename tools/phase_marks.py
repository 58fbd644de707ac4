#!/usr/bin/env python3
"""Phase breakdown of one kernel on one CUDA card, from a marked copy of its source.

The kernel's source (found in the tree by its C entry, as tools/tiled_ab.py finds
it) is copied to build/phase_marks/<name>/ with a clock64 mark by thread 0 after
every __syncthreads() written in the kernel's own body; each mark adds the cycles
since the previous mark to its own slot, so a barrier inside a loop sums over the
iterations, and barriers inside called helpers fall into the enclosing segment.
The copy and the unmarked source of every tree are built alone with the port's nvcc
flags, all at once, and the kernel's wrapper runs each on chip_smoke.py's full-set
operands (K1 and K2 at the flagship's BatchNorm route, K8 at its dropout route, K12
at the h150 training route, K14 at the h150_bn route, K16 (iteration 2) and K17 at
the composite_bn route, K3 at the flagship serving batch's loop rows, K9 at the
h150 serving batch's dep rows, K5 at the clean route's loop rows, K7 at the
dropout route's loop rows, K4 at the flagship serving batch's dep rows, K6 at
the dropout route's dep rows, K18 on the whole set's plan at D = 14; K18 has
no barrier, so its one segment is the whole kernel).
With width=D (K1-K8) the operands are the same routes' at state width D, on
the MUTAG-shaped set's graphs and arcs with seeded D-wide node labels
(chip_smoke.py::relabelled): from D 80 on at W 128 the kernels take their wide
plans, whose phases (staging, the list build, U or the dense layer, the
aggregation and the epilogue) are the same barriers' segments. With force=i
every build launches plan i (gnn_*_force_plan; the wide plan is the last
index), e.g. the wide plan at the flagship's width (K1-K9, K12, K14; K16's and
K17's wide instantiations lie in bn_typed_wide.cu, built beside the copy
without marks of their own, so their phases are not read here).
Printed: the instrumented and the unmarked launch's times (the marks' cost), then
each segment's share of the cycles summed over the CTAs and its cycles a CTA, named
by the source lines of the barriers that end it.

Usage, from the repository root (a tree defaults to gnn_tpu_torch/ops/csrc):
    python3 tools/phase_marks.py K1|K2|K3|K4|K5|K6|K7|K8|K9|K12|K14|K16|K17|K18 \\
        [width=D] [force=i] [name=tree ...]
"""

import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel: its C entry and the __global__ functions that may implement it
KERNELS = {"K1": ("gnn_bn_forward", ("bn_fwd_kernel",)),
           "K2": ("gnn_bn_backward", ("bn_bwd_kernel",)),
           "K8": ("gnn_train_loop_bwd", ("train_bwd_kernel", "train_loop_bwd_kernel")),
           "K12": ("gnn_train_loop2", ("train_loop2_kernel", "loop2_tile_kernel")),
           "K14": ("gnn_bn2_forward", ("bn2_fwd_tile_kernel", "bn2_fwd_kernel")),
           "K17": ("gnn_bnT_backward", ("bnT_bwd_kernel",)),
           "K3": ("gnn_propagation_loop", ("loop_kernel",)),
           "K9": ("gnn_propagation_step2", ("step2_tile_kernel", "step2_kernel")),
           "K16": ("gnn_bnT_forward", ("bnT_fwd_kernel",)),
           "K5": ("gnn_propagation_loop_bwd", ("loop_bwd_kernel",)),
           "K7": ("gnn_train_loop", ("train_loop_kernel",)),
           "K4": ("gnn_propagation_step", ("step_kernel",)),
           "K6": ("gnn_train_step", ("train_step_kernel",)),
           "K18": ("gnn_segment_aggregate", ("segment_agg_kernel",))}
HEAD = """
namespace {
__device__ unsigned long long* g_phase;
__device__ int g_nph;
}
#define PHASE_MARK(i)                                                              \\
  do {                                                                             \\
    if (threadIdx.x == 0) {                                                        \\
      const long long now_ = clock64();                                            \\
      g_phase[(size_t)blockIdx.x * g_nph + (i)] += now_ - phase_last_;             \\
      phase_last_ = now_;                                                          \\
    }                                                                              \\
  } while (0)
"""
TAIL = """
#ifndef GNN_WIDE_TU
extern "C" int phase_marks_set(unsigned long long* p, int n) {
  cudaMemcpyToSymbol(g_phase, &p, sizeof(p));
  cudaMemcpyToSymbol(g_nph, &n, sizeof(int));
  return cudaGetLastError();
}
#endif
"""


def marked(src, names):
    """(source with marks, [line of the barrier ending each segment]) of the first
    kernel of `names` defined in src."""
    for name in names:
        m = re.search(rf"__global__[^;{{]*?\b{name}\s*\(", src)
        if m:
            break
    else:
        raise SystemExit(f"none of {names} is defined")
    start = src.index("{", src.index(")", m.end()))
    depth, end = 0, start
    for end in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    body, lines = src[start + 1:end], []
    base = src[:start].count("\n") + 1

    def mark(b):
        lines.append(base + body[:b.start()].count("\n"))
        return f"__syncthreads(); PHASE_MARK({len(lines) - 1});"
    body = re.sub(r"__syncthreads\(\);", mark, body)
    lines.append(src[:end].count("\n") + 1)
    body = ("\n  long long phase_last_ = clock64();" + body
            + f"  __syncthreads(); PHASE_MARK({len(lines) - 1});\n")
    inc = src.index("\n", src.index("#include")) + 1
    out = src[:inc] + HEAD + src[inc:start + 1] + body + src[end:] + TAIL
    return out, lines


def main():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.ops import _build, bn, fused, fused2, segment, typed
    kernel = sys.argv[1]
    entry, names = KERNELS[kernel]
    trees = dict(a.split("=", 1) for a in sys.argv[2:])
    width = int(trees.pop("width", 14))
    force = int(trees.pop("force", -1))
    trees = trees or {"tree": str(_build.CSRC)}
    if width != 14 and kernel not in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"):
        cs.fail(f"width={width}: only the one-layer kernels K1-K8 take other state widths")
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs = mutag_shaped(seed=cs.SEED)
    if width != 14:
        graphs = cs.relabelled(graphs, width, cs.SEED + 61)
    model = cs.flagship(torch, "cuda", f"w{width}_bn")
    gb_train = model.to_batch(graphs)
    with torch.no_grad():
        if kernel == "K1":
            (_, x), kw, _, _ = cs.train_kernel_inputs(torch, model, gb_train)
            fn, x, rows = bn.bn_forward_step, dict(x, **kw), x["y1"].shape[0]
        elif kernel == "K2":
            _, _, x, kw = cs.train_kernel_inputs(torch, model, gb_train)
            fn, x, rows = bn.bn_backward_step, dict(x, **kw), x["y_prev"].shape[0]
        elif kernel == "K8":
            x = cs.bnfree_kernel_inputs(torch, gb_train, width)[3]
            fn, rows = fused.train_loop_bwd, x["adjT"].shape[0]
        elif kernel == "K14":
            _, x, kw, _ = cs.two_layer_train_kernel_inputs(torch, gb_train)
            fn, x, rows = bn.bn2_forward_step, dict(x, **kw), x["y1"].shape[0]
        elif kernel in ("K16", "K17"):
            comp = cs.composite_model(torch, "cuda")
            typed_gs = cs.typed_graphs(graphs)
            gb_typed = Predictor(comp).build_batch(typed_gs).to("cuda")
            (_, x1), kw1, x, kw, _ = cs.typed_kernel_inputs(torch, comp, comp.to_batch(typed_gs),
                                                            gb_typed)
            if kernel == "K16":
                fn, x, rows = typed.bnT_forward_step, dict(x1, **kw1), x1["y1"].shape[0]
            else:
                fn, x, rows = typed.bnT_backward_step, dict(x, **kw), x["y_prev"].shape[0]
        elif kernel in ("K5", "K6", "K7"):
            x = cs.bnfree_kernel_inputs(torch, gb_train, width)[{"K5": 0, "K6": 1,
                                                                 "K7": 2}[kernel]]
            fn = {"K5": fused.propagation_loop_bwd, "K6": fused.train_step,
                  "K7": fused.train_loop}[kernel]
            rows = x["adjT"].shape[0]
        elif kernel == "K18":
            from gnn_tpu_torch.graphs.generator import GraphDataGenerator
            gbp = next(iter(GraphDataGenerator(graphs, batch_size=len(graphs), shuffle=False,
                                               build_plan=True))).to("cuda")
            gen = torch.Generator().manual_seed(cs.SEED)
            x = dict(state=torch.randn(gbp.n_node_pad, 14, generator=gen).cuda(),
                     plan=gbp.agg_plan.fwd)
            fn, rows = segment.segment_aggregate, segment._agg_launch(gbp.n_node_pad, 14)[3]
        elif kernel == "K4":
            gb = Predictor(model).build_batch(graphs).to("cuda")
            x = dict(cs.kernel_inputs(model, gb)[1],
                     activation=model.spec.state_spec.activations[0])
            fn, rows = fused.propagation_step, x["adjT"].shape[0]
        elif kernel == "K3":
            gb = Predictor(model).build_batch(graphs).to("cuda")
            spec = model.spec
            x = dict(cs.kernel_inputs(model, gb)[0], K=spec.max_iteration,
                     threshold=float(spec.threshold), activation=spec.state_spec.activations[0])
            fn, rows = fused.propagation_loop, x["adjT"].shape[0]
        else:
            gb = Predictor(model).build_batch(graphs).to("cuda")
            x = cs.two_layer_kernel_inputs(torch, gb, gb_train)[0 if kernel == "K9" else 2]
            fn = fused2.propagation_step2 if kernel == "K9" else fused2.train_loop2
            rows = x["adjT"].shape[0]

    class One:
        """The library the wrapper launches through (a tree without wide plans
        has no gnn_*_workspace entries: its staged plans need none)."""

        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            if name.endswith("_workspace") and not hasattr(self.lib, name):
                return lambda *dims: 0
            return getattr(self.lib, name)

    # every tree's marked and unmarked copies, built all at once
    jobs, plan = [], {}
    for tname, tree in trees.items():
        src_path = next(os.path.join(tree, f) for f in sorted(os.listdir(tree))
                        if f.endswith(".cu")
                        and re.search(rf"\bint {entry}\(", open(os.path.join(tree, f)).read()))
        out_dir = os.path.join(ROOT, "build", "phase_marks", tname)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.copytree(tree, out_dir)
        src, lines = marked(open(src_path).read(), names)
        copy = os.path.join(out_dir, os.path.basename(src_path))
        with open(copy, "w") as f:
            f.write(src)
        plan[tname] = (src_path, lines)
        jobs += [(tname, label, path, tree, os.path.join(out_dir, f"lib_{label}.so"))
                 for label, path in (("marked", copy), ("unmarked", src_path))]

    def nvcc(job):
        """The copy's library, with its wide plans' and register-width-64 plans'
        sources beside it where the tree has them (X_wide.cu and X_64.cu
        include X.cu: the marked copy for the marked library, whose
        instantiations there keep no marks of their own)."""
        tname, label, path, tree, so = job
        extra = [s for s in (path[:-3] + "_wide.cu", path[:-3] + "_64.cu") if os.path.exists(s)]
        return subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", tree, "-shared", "-o", so,
                               path, *extra], capture_output=True, text=True)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(nvcc, jobs))
    libs_of = {}
    for (tname, label, _, _, so), r in zip(jobs, built):
        if r.returncode:
            cs.fail(f"{tname} {label}: nvcc failed\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
        libs_of.setdefault(tname, {})[label] = lib = _build.bind(ctypes.CDLL(so))
        if force >= 0:
            getattr(lib, entry + "_force_plan")(force)
    for tname, (src_path, lines) in plan.items():
        libs = libs_of[tname]
        n = len(lines)
        slots = torch.zeros(rows * n, dtype=torch.int64, device="cuda")
        libs["marked"].phase_marks_set(ctypes.c_void_p(slots.data_ptr()), n)
        try:
            with torch.no_grad():
                ms = {}
                for label in ("unmarked", "marked", "marked", "unmarked"):
                    _build._lib = One(libs[label])
                    ms.setdefault(label, []).append(round(cs.timed_ms(torch, lambda: fn(**x)), 4))
                _build._lib = One(libs["marked"])
                slots.zero_()
                fn(**x)
                torch.cuda.synchronize()
        finally:
            _build._lib = None
        seg = slots.view(rows, n).double().sum(0)
        total = float(seg.sum())
        cs.say(f"{kernel} {tname} ({os.path.basename(src_path)}, state width {width}"
               f"{f', plan {force} forced' if force >= 0 else ''}): ms {ms}")
        prev = None
        for i, (line, v) in enumerate(zip(lines, seg.tolist())):
            span = f"lines {prev}-{line}" if prev else f"to line {line}"
            cs.say(f"  segment {i:2d} {span:16s} {100 * v / total:6.2f}%  {v / rows:10.0f} cycles a CTA")
            prev = line
    cs.say(f"done {cs.elapsed()}")


if __name__ == "__main__":
    main()
