#!/usr/bin/env python3
"""Smoke run of gnn_tpu_torch on one NVIDIA GPU.

1. Device: needs CUDA; prints the card's name and power limit (nvidia-smi)
   and the torch and nvcc versions.
2. Build: compiles the CUDA kernels from gnn_tpu_torch/ops/csrc with nvcc.
3. Kernels: runs K3 (propagation_loop) and K4 (propagation_step) at the
   shapes the serving path gives them on the full MUTAG-shaped set and at
   ragged small shapes, holds each against its plain PyTorch version on the
   same CUDA tensors (states within 1e-5, movement flags equal) and times
   both with CUDA events.
4. Main path: serves the flagship graph-focus GNN (MUTAG widths 14/3/2,
   selu state net with BatchNorm, softmax readout, K=5, threshold 0.01,
   seeded random weights) through Predictor: warmup, then 8 requests. Every
   kernel must have launched; every response must match the same model run
   on the CPU (outputs within 1e-5, iteration counts equal).

Prints a JSON line of per-kernel numbers, then as its last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that.

Usage, from the repository root: python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

TOL = 1e-5              # kernel vs plain version, card vs CPU
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
SEED = 0


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    from gnn_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{nvcc.stdout.strip().splitlines()[-1]}; device {torch.cuda.get_device_name(0)}")


def phase_build():
    from gnn_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    say(f"build: {time.perf_counter() - t0:.2f} s -> {_build.LIB_PATH}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")


def timed_ms(torch, fn, runs=20, reps=5):
    """Median over `runs` of the per-call device time of `reps` back-to-back
    calls, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def kernel_inputs(model, gb):
    """K3/K4 operands as the serving path forms them (the first dep step's)."""
    from gnn_tpu_torch.models import core
    loop, dep, Wa = core.hybrid_operands(model.spec, model.params["state"],
                                         model.bn["state"], gb)
    return loop, dict(dep, rT=core.residual_term(gb, dep["s"], Wa))


def random_inputs(torch, gen, B, W, D, H, dev, res=True):
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    arcs = torch.rand(B, W, W, generator=gen) < 0.05
    adjT = (arcs / arcs.sum(1, keepdim=True).clamp_min(1)).float().to(dev)
    aff = torch.stack([torch.rand(H, generator=gen) + 0.5, 0.1 * torch.randn(H, generator=gen)])
    return dict(adjT=adjT, s=r(B, W, D), rT=r(B, W, H, scale=0.3) if res else None,
                fT=r(B, W, H, scale=0.3), w2=r(2 * H, D, scale=0.7 / D ** 0.5),
                affine=aff.to(dev),
                nm=(torch.rand(B, W, generator=gen) < 0.8).float().to(dev))


def _nnz(adjT):
    return int((adjT != 0).sum())


def check_loop(torch, fused, x, K, thr, act, label):
    traj, marg = fused.propagation_loop(x["adjT"], x["s0"], x["fT"], x["w2"], x["affine"],
                                        x["nm"], K, thr, act)
    torch.cuda.synchronize()
    traj_r, marg_r = fused.propagation_loop_ref(x["adjT"], x["s0"], x["fT"], x["w2"],
                                                x["affine"], x["nm"], K, thr, act)
    err = float((traj - traj_r).abs().max())
    flips = int((marg != marg_r).sum())
    say(f"K3 {label}: adjT {tuple(x['adjT'].shape)} D={x['s0'].shape[-1]} K={K} {act}: "
        f"max|traj - plain| = {err:.3e}, margins differing: {flips} of {marg.numel()}")
    if not torch.isfinite(traj).all():
        fail(f"K3 {label}: non-finite trajectory")
    if err > TOL or flips:
        fail(f"K3 {label} disagrees with its plain version")
    return err


def check_step(torch, fused, x, act, label):
    out = fused.propagation_step(x["adjT"], x["s"], x["rT"], x["fT"], x["w2"], x["affine"], act)
    torch.cuda.synchronize()
    ref = fused.propagation_step_ref(x["adjT"], x["s"], x["rT"], x["fT"], x["w2"],
                                     x["affine"], act)
    err = float((out - ref).abs().max())
    say(f"K4 {label}: adjT {tuple(x['adjT'].shape)} D={x['s'].shape[-1]} "
        f"H={x['w2'].shape[0] // 2} res={x['rT'] is not None} {act}: "
        f"max|out - plain| = {err:.3e}")
    if not torch.isfinite(out).all():
        fail(f"K4 {label}: non-finite output")
    if err > TOL:
        fail(f"K4 {label} disagrees with its plain version")
    return err


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, model, gb):
    """Each kernel against its plain version, at the main path's full-set
    shapes and at ragged small shapes; times and bounds at the full set."""
    from gnn_tpu_torch.ops import fused
    K, thr = model.spec.max_iteration, float(model.spec.threshold)
    act = model.spec.state_spec.activations[0]
    loop, step = kernel_inputs(model, gb)
    gen = torch.Generator().manual_seed(SEED)
    dev = gb.device

    err3 = check_loop(torch, fused, loop, K, thr, act, "full set")
    # ragged shapes, one per register width the kernels are built for (16, 32, 64)
    for B, W, D, act_r in ((13, 96, 5, "tanh"), (7, 128, 24, "selu"), (4, 64, 48, "relu")):
        small = random_inputs(torch, gen, B, W, D, D, dev)
        check_loop(torch, fused, dict(small, s0=small["s"]), 3, 0.05, act_r, "ragged")
    err4 = check_step(torch, fused, step, act, "full set")
    for B, W, D, H, act_r, res in ((5, 64, 6, 9, "relu", True), (3, 32, 3, 3, "linear", False),
                                   (6, 128, 24, 24, "selu", True), (4, 96, 48, 40, "tanh", True),
                                   (3, 128, 20, 64, "selu", True)):
        check_step(torch, fused, random_inputs(torch, gen, B, W, D, H, dev, res=res), act_r,
                   "ragged")

    def run3(f):
        return lambda: f(loop["adjT"], loop["s0"], loop["fT"], loop["w2"], loop["affine"],
                         loop["nm"], K, thr, act)

    def run4(f):
        return lambda: f(step["adjT"], step["s"], step["rT"], step["fT"], step["w2"],
                         step["affine"], act)

    Bi, W, _ = loop["adjT"].shape
    D = loop["s0"].shape[-1]
    rows3, f4 = Bi * W, 4
    bytes3 = f4 * (Bi * W * W + 2 * rows3 * D + 2 * D * D + 2 * D + rows3
                   + K * rows3 * D + K * rows3)
    flops3 = K * (4 * D * D * rows3 + 2 * D * _nnz(loop["adjT"]) + 5 * D * rows3 + 4 * D * rows3)
    Bd = step["adjT"].shape[0]
    rows4 = Bd * W
    bytes4 = f4 * (Bd * W * W + 4 * rows4 * D + 2 * D * D + 2 * D)
    flops4 = 4 * D * D * rows4 + 2 * D * _nnz(step["adjT"]) + 6 * D * rows4
    b3, by3 = bound(bytes3, flops3)
    b4, by4 = bound(bytes4, flops4)
    out = {
        "K3": dict(name="K3 propagation_loop", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/fused_eval.cu",
                   replaces="gnn_tpu/ops/pallas_fused.py:236", max_abs_err=err3,
                   ms=timed_ms(torch, run3(fused.propagation_loop)),
                   plain_ms=timed_ms(torch, run3(fused.propagation_loop_ref)),
                   bound_ms=b3, bound_by=by3, library_ms=None),
        "K4": dict(name="K4 propagation_step", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/fused_eval.cu",
                   replaces="gnn_tpu/ops/pallas_fused.py:219", max_abs_err=err4,
                   ms=timed_ms(torch, run4(fused.propagation_step)),
                   plain_ms=timed_ms(torch, run4(fused.propagation_step_ref)),
                   bound_ms=b4, bound_by=by4, library_ms=None),
    }
    for k, v in out.items():
        say(f"{k} timing at {('adjT ' + str(tuple((loop if k == 'K3' else step)['adjT'].shape)))}: "
            f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']})")
    return out


def phase_profile(torch, fwd, runs=5):
    """Device time by kernel over `runs` full-set forwards (torch.profiler),
    and the device's busy share of the host-clock window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fwd()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: an aten op's own row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(r[0] for r in rows)
    if not total:
        say("profile: the profiler recorded no device time")
        return
    say(f"profile over {runs} full-set forwards: device busy {total / runs / 1e3:.3f} ms of "
        f"{wall_us / runs / 1e3:.3f} ms per forward ({100 * total / wall_us:.1f}% busy)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        say(f"  {dev_us / runs / 1e3:9.4f} ms/forward  {count // runs:4d} calls  {key[:90]}")


def flagship(torch, device):
    from gnn_tpu_torch import GNNgraphBased, MLPSpec, get_inout_dims
    in_s, l_s = get_inout_dims("state", 14, 3, 2, "g", 0, None)
    in_o, l_o = get_inout_dims("output", 14, 3, 2, "g", 0, None)
    ss = MLPSpec(input_dim=in_s, units=tuple(l_s), activations="selu",
                 kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
                 dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=True)
    so = MLPSpec(input_dim=in_o, units=tuple(l_o), activations="softmax",
                 kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
                 dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    model = GNNgraphBased(ss, so, max_iteration=5, threshold=0.01, seed=SEED, device=device)
    gen = torch.Generator().manual_seed(SEED + 1)    # non-trivial inference BN statistics
    d = l_s[-1]
    model.bn["state"] = {"mean": (0.1 * torch.randn(d, generator=gen)).to(device),
                         "var": (0.5 + torch.rand(d, generator=gen)).to(device)}
    return model


def main():
    import torch
    phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.ops import fused

    t0 = time.perf_counter()
    graphs = mutag_shaped(seed=SEED)
    n_nodes = sum(g.n_nodes for g in graphs)
    n_arcs = sum(g.n_arcs for g in graphs)
    big = [i for i, g in enumerate(graphs) if g.n_nodes > 128]
    say(f"data: {len(graphs)} graphs, {n_nodes} nodes, {n_arcs} arcs, {len(big)} graphs "
        f"over 128 nodes ({time.perf_counter() - t0:.2f} s)")
    model = flagship(torch, "cuda")
    model_cpu = flagship(torch, "cpu")
    pred = Predictor(model)
    pred_cpu = Predictor(model_cpu, device="cpu")

    largest = max(range(len(graphs)), key=lambda i: graphs[i].n_nodes)
    requests = [("all", graphs), ("32a", graphs[0:32]), ("32b", graphs[32:64]),
                ("32c", graphs[64:96]), ("big", graphs[big[0]]), ("largest", graphs[largest]),
                ("small", graphs[1]), ("32a again", graphs[0:32])]

    t0 = time.perf_counter()
    full_host = pred.build_batch(graphs)
    gb = full_host.to("cuda")
    say(f"full-set batch: {gb.n_node_pad // gb.block_w} blocks, {gb.adj_loop.shape[0]} loop, "
        f"{0 if gb.adj_dep is None else gb.adj_dep.shape[0]} dep "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    if gb.adj_dep is None:
        fail("the full set has no residual-coupled blocks: K4 would not run")
    kernels = phase_kernels(torch, model, gb)

    # ---- main path: Predictor warmup + requests, counting kernel launches
    fused.reset_launches()
    t0 = time.perf_counter()
    warmed = pred.warmup([r for _, r in requests])
    say(f"warmup: {warmed} buckets in {time.perf_counter() - t0:.2f} s")
    served = []
    for name, req in requests:
        before = dict(fused.launches)
        t0 = time.perf_counter()
        out = pred.predict(req)
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: fused.launches[k] - before[k] for k in before}
        served.append((name, req, out, pred.stats["last_iters"]))
        n = 1 if not isinstance(req, list) else len(req)
        say(f"request {name!r}: {n} graphs, {ms:.3f} ms (predict), last_ms "
            f"{pred.stats['last_ms']}, iters {pred.stats['last_iters']}, launches {launched}")
    launches = dict(fused.launches)
    say(f"main path launches: {launches}")
    for key in ("propagation_loop", "propagation_step"):
        if launches[key] == 0:
            fail(f"{key} never launched on the serving path")

    # ---- served outputs against the same model on the CPU
    worst = 0.0
    for name, req, out, iters in served:
        ref = pred_cpu.predict(req)
        outs, refs = ([out], [ref]) if not isinstance(req, list) else (out, ref)
        if len(outs) != len(refs):
            fail(f"request {name!r}: {len(outs)} outputs, CPU gave {len(refs)}")
        for o, r in zip(outs, refs):
            if o.shape != r.shape or not (abs(o - r) <= TOL).all() or not (o == o).all():
                fail(f"request {name!r}: output differs from the CPU run")
            worst = max(worst, float(abs(o - r).max()))
        if iters != pred_cpu.stats["last_iters"]:
            fail(f"request {name!r}: iters {iters} on the card, "
                 f"{pred_cpu.stats['last_iters']} on the CPU")
    say(f"served outputs vs CPU: max abs diff {worst:.3e} over {len(served)} requests")

    # ---- full-set forward time and propagation throughput
    def fwd():
        r = model.forward(gb)
        torch.cuda.synchronize()
        return r
    iters = float(fwd()["iters"])
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fwd()
        times.append(time.perf_counter() - t0)
    times.sort()
    t_med = times[len(times) // 2]
    say(f"full-set forward: {t_med * 1e3:.3f} ms median of 10 (host clock, synchronized), "
        f"iters {iters}, {n_arcs * iters / t_med:.4e} edges/s")
    phase_profile(torch, fwd)

    for k, v in kernels.items():
        v["launches"] = launches["propagation_loop" if k == "K3" else "propagation_step"]
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: v[k] for k in order} for v in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "gnn_tpu_torch")):
        fail(f"gnn_tpu_torch not found beside {os.path.basename(__file__)}: "
             "run from a checkout of the repository")
    sys.path.insert(0, here)
    main()
