#!/usr/bin/env python3
"""Smoke run of gnn_tpu_torch on one NVIDIA GPU.

1. Device: needs CUDA; prints the card's name and power limit (nvidia-smi)
   and the torch and nvcc versions.
2. Build: compiles the CUDA kernels from gnn_tpu_torch/ops/csrc with nvcc,
   one nvcc per source, all at once.
3. Serving kernels: runs K3 (propagation_loop) and K4 (propagation_step) at
   the shapes the serving path gives them on the full MUTAG-shaped set and
   at ragged small shapes, holds each against its plain PyTorch version on
   the same CUDA tensors (states within 1e-5, movement flags equal) and
   times both with CUDA events.
4. Serving path: serves the flagship graph-focus GNN (MUTAG widths 14/3/2,
   selu state net with BatchNorm, softmax readout, K=5, threshold 0.01,
   seeded random weights) through Predictor: warmup, then 8 requests. K3 and
   K4 must have launched; every response must match the same model run on
   the CPU (outputs within 1e-5, iteration counts equal).
5. Training kernels: runs K1 (bn_forward_step) and K2 (bn_backward_step) at
   the shapes the training step gives them on the full set and at ragged
   shapes of every register width the kernels are built for, against their
   plain versions (per-node outputs within 1e-5, movement flags equal, sums
   over nodes within rtol 1e-4 with a floor of 1e-4 of the largest entry),
   and times both.
6. BN-free training kernels: runs K5 (propagation_loop_bwd, with and
   without the affine), K6 (train_step), K7 (train_loop) and K8
   (train_loop_bwd) at the shapes the two BN-free training routes give them
   on the full set and at ragged shapes of every register width, against
   their plain versions in the same way, and times them.
7. Training paths, each on one batch of the whole set (softmax readout with
   dropout 0.1, categorical cross-entropy, Adam lr 1e-3):
   - the flagship (AlphaDropout 0.1 on the state net's input, BatchNorm):
     5 training_steps, K1 and K2 each launched K=5 times per step;
   - the flagship without BatchNorm: 5 steps, K7 and K8 once per step and
     K6 K times;
   - the flagship without BatchNorm and state-net dropout: 3 steps, K3 and
     K5 once per step and K4 K times.
   No other kernel may launch on a path. The same model on the CPU, fed the
   card's dropout masks, must agree: equal iteration counts, losses within
   rtol 1e-5, moving BatchNorm statistics within 1e-5, the first step's
   grads within rtol 2e-4 (floor 2e-5 of each tensor's largest entry), the
   params after the last common step within 1e-5.

Prints a JSON line of per-kernel numbers (K1-K8), then as its last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that.

Usage, from the repository root: python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

TOL = 1e-5              # kernel vs plain version, card vs CPU
SUM_RTOL = 1e-4         # sums over nodes, kernel vs plain version
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


def random_adj(torch, gen, B, W, dev):
    """B sparse 'average'-mode block adjacencies adjT [B, W, W], ~5% arcs."""
    arcs = torch.rand(B, W, W, generator=gen) < 0.05
    return (arcs / arcs.sum(1, keepdim=True).clamp_min(1)).float().to(dev)


def random_inputs(torch, gen, B, W, D, H, dev, res=True):
    """Ragged K4 operands (K3 takes s as s0, with H == D and a node mask)."""
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    aff = torch.stack([torch.rand(H, generator=gen) + 0.5, 0.1 * torch.randn(H, generator=gen)])
    return dict(adjT=random_adj(torch, gen, B, W, dev), s=r(B, W, D),
                rT=r(B, W, H, scale=0.3) if res else None, fT=r(B, W, H, scale=0.3),
                w2=r(2 * H, D, scale=0.7 / D ** 0.5), affine=aff.to(dev))


def _nnz(adjT):
    return int((adjT != 0).sum())


def against_plain(torch, module, name, x):
    """(kernel outputs, plain outputs) of the wrapper `name` of `module` and
    its plain version `name`_ref on the same inputs x."""
    got = getattr(module, name)(**x)
    torch.cuda.synchronize()
    return got, getattr(module, name + "_ref")(**x)


def check_loop(torch, fused, x, K, thr, act, label):
    B, W, _ = x["adjT"].shape
    return check_plain(torch, f"K3 {label}: adjT ({B}, {W}, {W}) D={x['s0'].shape[-1]} K={K} {act}",
                       *against_plain(torch, fused, "propagation_loop",
                                      dict(x, K=K, threshold=thr, activation=act)),
                       ("traj", "margins"), exact=("margins",))


def check_step(torch, fused, x, act, label):
    B, W, _ = x["adjT"].shape
    got, want = against_plain(torch, fused, "propagation_step", dict(x, activation=act))
    return check_plain(torch, f"K4 {label}: adjT ({B}, {W}, {W}) D={x['s'].shape[-1]} "
                       f"H={x['w2'].shape[0] // 2} res={x['rT'] is not None} {act}",
                       (got,), (want,), ("out",))


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
        small = random_inputs(torch, gen, B, W, D, D, dev, res=False)
        nm = (torch.rand(B, W, generator=gen) < 0.8).float().to(dev)
        check_loop(torch, fused, dict(adjT=small["adjT"], s0=small["s"], fT=small["fT"],
                                      w2=small["w2"], affine=small["affine"], nm=nm),
                   3, 0.05, act_r, "ragged")
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


def phase_profile(torch, fwd, runs=5, what="full-set forward"):
    """Device time by kernel over `runs` calls of fwd (torch.profiler), and
    the device's busy share of the host-clock window."""
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
    say(f"profile over {runs} x {what}: device busy {total / runs / 1e3:.3f} ms of "
        f"{wall_us / runs / 1e3:.3f} ms per call ({100 * total / wall_us:.1f}% busy)")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        say(f"  {dev_us / runs / 1e3:9.4f} ms/call  {count // runs:4d} launches  {key[:90]}")


# the training paths: the flagship's state net with its BatchNorm ("bn"),
# without it ("dropout"), and without BatchNorm and dropout ("clean"); the
# kernel wrappers each path launches, and how often a step ("K": once per
# iteration)
ROUTES = {"bn": {"bn_forward_step": "K", "bn_backward_step": "K"},
          "dropout": {"train_loop": 1, "train_loop_bwd": 1, "train_step": "K"},
          "clean": {"propagation_loop": 1, "propagation_loop_bwd": 1, "propagation_step": "K"}}


def flagship(torch, device, variant="bn"):
    from gnn_tpu_torch import GNNgraphBased, MLPSpec, get_inout_dims
    in_s, l_s = get_inout_dims("state", 14, 3, 2, "g", 0, None)
    in_o, l_o = get_inout_dims("output", 14, 3, 2, "g", 0, None)
    drop = (dict(dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=True)
            if variant != "clean" else {})
    ss = MLPSpec(input_dim=in_s, units=tuple(l_s), activations="selu",
                 kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
                 batch_normalization=variant == "bn", **drop)
    so = MLPSpec(input_dim=in_o, units=tuple(l_o), activations="softmax",
                 kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
                 dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    model = GNNgraphBased(ss, so, max_iteration=5, threshold=0.01, seed=SEED, device=device)
    if variant == "bn":
        gen = torch.Generator().manual_seed(SEED + 1)    # non-trivial inference BN statistics
        d = l_s[-1]
        model.bn["state"] = {"mean": (0.1 * torch.randn(d, generator=gen)).to(device),
                             "var": (0.5 + torch.rand(d, generator=gen)).to(device)}
    return model


def close_sum(torch, got, want, label):
    """Block-summed partials: within SUM_RTOL of the plain version, with a
    floor of SUM_RTOL times the largest entry (a sum can cancel far below
    its terms). Returns the max abs difference."""
    err = (got - want).abs()
    bound = SUM_RTOL * (want.abs() + want.abs().max())
    if not bool((err <= bound).all()):
        fail(f"{label}: sum over nodes off by {float(err.max()):.3e}")
    return float(err.max())


def check_bn_forward(torch, bn, x, kw, label):
    R, W, D = x["y1"].shape
    return check_plain(torch, f"K1 {label}: R={R} (Bl={x['adj_loop'].shape[0]}) W={W} D={D} "
                       f"F={x['feats'].shape[-1]} {kw['activation']} rate={kw['rate']} "
                       f"res={x['rT'] is not None}",
                       *against_plain(torch, bn, "bn_forward_step", dict(x, **kw)),
                       ("y", "agg", "flags", "msum"), summed=("msum",), exact=("flags",))


def check_bn_backward(torch, bn, x, kw, label):
    R, W, D = x["y_prev"].shape
    return check_plain(torch, f"K2 {label}: R={R} W={W} D={D} {kw['activation']} "
                       f"rate={kw['rate']} flag={float(x['flag'])}",
                       *against_plain(torch, bn, "bn_backward_step", dict(x, **kw)),
                       ("ds", "dw", "dagg", "red"), summed=("dw", "red"))


def random_bn_inputs(torch, gen, R, Bl, W, D, F, rate, res, dev):
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    adj = random_adj(torch, gen, R, W, dev)
    aff = torch.stack([torch.stack([torch.rand(D, generator=gen) + 0.5,
                                    0.1 * torch.randn(D, generator=gen)]) for _ in range(2)])
    keep = ((torch.rand(R, W, 2 * D + F, generator=gen) > rate).to(torch.uint8).to(dev)
            if rate else None)
    fwd = dict(adj_loop=adj[:Bl].contiguous(), adj_dep=adj[Bl:].contiguous() if Bl < R else None,
               y1=r(R, W, D), y2=r(R, W, D), aff=aff.to(dev), keep=keep,
               rT=r(R, W, D, scale=0.3) if res else None, feats=r(R, W, F, scale=0.5),
               w_aug=r(D, 2 * D + F + 1, scale=0.5 / D ** 0.5),
               nm=(torch.rand(R, W, generator=gen) < 0.8).float().to(dev))
    bwd = dict(adj_loop=fwd["adj_loop"], adj_dep=fwd["adj_dep"], y_prev=fwd["y1"], y_k=r(R, W, D),
               agg=r(R, W, D), keep=keep, feats=fwd["feats"], w_aug=fwd["w_aug"],
               ds_in=r(R, W, D, scale=0.1), gsel=r(R, W, D, scale=0.1),
               bnv=(0.5 + torch.rand(9, D, generator=gen)).to(dev),
               flag=torch.tensor(1.0, device=dev), nm=fwd["nm"])
    return fwd, bwd


def train_kernel_inputs(torch, model, gb):
    """K1's operands of iterations 1 and 2 and K2's of the reverse of
    iteration 2, as the training step forms them on the full set (masks from
    a seeded generator, a readout-like state cotangent)."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn
    dev = gb.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    masks = core.draw_masks(model.spec, gb, gen)
    with torch.no_grad():
        s0, w_aug, op = bn.bn_loop_operands(model.spec, model.params["state"], gb,
                                            masks["state"].get(0))
        gamma, beta = model.params["state"]["bn"]["gamma"], model.params["state"]["bn"]["beta"]
        ident = bn._ident_aff(s0.shape[-1], s0)
        cnt = op.nm.sum().clamp_min(1.0)
        kw = dict(op.step_kw(), threshold=op.threshold)
        x0 = dict(adj_loop=op.adj_loop, adj_dep=op.adj_dep, y1=s0, y2=torch.ones_like(s0),
                  aff=torch.stack([ident, ident]), keep=op.keep_k(0),
                  rT=bn._res_term(s0, ident, op.res), feats=op.feats, w_aug=w_aug, nm=op.nm)
        y0, agg0, _, _ = bn.bn_forward_step_ref(**x0, **kw)

        def moments(y):
            m = (y * op.nm[..., None]).sum((0, 1)) / cnt
            v = ((y - m) ** 2 * op.nm[..., None]).sum((0, 1)) / cnt
            return m, torch.rsqrt(v + 1e-3), bn._affine(gamma, beta, m, v)

        m0, r0, a0 = moments(y0)
        x1 = dict(x0, y1=y0, y2=s0, aff=torch.stack([a0, ident]), keep=op.keep_k(1),
                  rT=bn._res_term(y0, a0, op.res))
        y1, agg1, _, _ = bn.bn_forward_step_ref(**x1, **kw)
        m1, r1, _ = moments(y1)
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        gsel = 0.03 * torch.randn(y1.shape, generator=g, device=dev) * op.nm[..., None]
        s1 = gsel.sum((0, 1))
        s2 = (gsel * (y1 - m1) * r1).sum((0, 1))
        a = gamma * r1
        bnv = torch.stack([a0[0], a0[1], m1, r1, a, a * s1 / cnt, a * s2 / cnt, m0, r0])
        x2 = dict(adj_loop=op.adj_loop, adj_dep=op.adj_dep, y_prev=y0, y_k=y1, agg=agg1,
                  keep=op.keep_k(1), feats=op.feats, w_aug=w_aug,
                  ds_in=0.01 * torch.randn(y1.shape, generator=g, device=dev), gsel=gsel,
                  bnv=bnv.contiguous(), flag=torch.tensor(1.0, device=dev), nm=op.nm)
    return (x0, x1), kw, x2, op.step_kw()


def bn_bounds(x_f, x_b):
    """(K1, K2) least times and what sets them: inputs read once, outputs
    written once; operations on the arcs present and the dense layer."""
    adjs = [a for a in (x_f["adj_loop"], x_f["adj_dep"]) if a is not None]
    nnz = sum(_nnz(a) for a in adjs)
    R, W, D = x_f["y1"].shape
    F = x_f["feats"].shape[-1]
    C = 2 * D + F + 1
    n = R * W
    f4 = 4
    keep_b = 0 if x_f["keep"] is None else n * (C - 1)
    adj_b = f4 * sum(a.numel() for a in adjs)
    shared = adj_b + keep_b + f4 * (n * F + D * C + n)          # adjacency, keep, feats, w, nm
    rt_b = 0 if x_f["rT"] is None else f4 * n * D
    bytes1 = shared + f4 * (2 * n * D + 4 * D) + rt_b + f4 * (2 * n * D + n + R * D)
    flops1 = 2 * D * nnz + 2 * D * C * n + 12 * D * n
    bytes2 = shared + f4 * (5 * n * D + 9 * D + 1) + f4 * (2 * n * D + R * D * C + 2 * R * D)
    flops2 = 2 * D * nnz + 2 * D * C * n * 2 + 4 * D * D * n + 14 * D * n
    return bound(bytes1, flops1), bound(bytes2, flops2)


def phase_train_kernels(torch, model, gb):
    """K1/K2 against their plain versions at the training step's full-set
    shapes and at ragged shapes of each register width (16, 32, 64); times
    and bounds at the full set."""
    from gnn_tpu_torch.ops import bn
    (x0, x1), kw, x2, kwb = train_kernel_inputs(torch, model, gb)
    check_bn_forward(torch, bn, x0, kw, "full set, iteration 1")
    err1 = check_bn_forward(torch, bn, x1, kw, "full set, iteration 2")
    err2 = check_bn_backward(torch, bn, x2, kwb, "full set, reverse of iteration 2")
    gen = torch.Generator().manual_seed(SEED + 4)
    dev = gb.device
    for R, Bl, W, D, F, act, alpha, rate, res in (
            (6, 4, 32, 5, 3, "selu", True, 0.1, True), (5, 5, 96, 14, 3, "selu", True, 0.1, True),
            (5, 3, 64, 24, 5, "relu", False, 0.2, True), (4, 2, 128, 48, 2, "tanh", True, 0.1, True),
            (3, 3, 64, 64, 1, "linear", False, 0.0, False)):
        f, b = random_bn_inputs(torch, gen, R, Bl, W, D, F, rate, res, dev)
        k = dict(activation=act, alpha_drop=alpha, rate=rate)
        check_bn_forward(torch, bn, f, dict(k, threshold=0.05), "ragged")
        check_bn_backward(torch, bn, b, k, "ragged")
    (b1, by1), (b2, by2) = bn_bounds(x1, x2)
    out = {
        "K1": dict(name="K1 bn_forward_step", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/bn_train.cu",
                   replaces="gnn_tpu/ops/pallas_bn.py:97", max_abs_err=err1,
                   ms=timed_ms(torch, lambda: bn.bn_forward_step(**x1, **kw)),
                   plain_ms=timed_ms(torch, lambda: bn.bn_forward_step_ref(**x1, **kw)),
                   bound_ms=b1, bound_by=by1, library_ms=None),
        "K2": dict(name="K2 bn_backward_step", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/bn_train.cu",
                   replaces="gnn_tpu/ops/pallas_bn.py:203", max_abs_err=err2,
                   ms=timed_ms(torch, lambda: bn.bn_backward_step(**x2, **kwb)),
                   plain_ms=timed_ms(torch, lambda: bn.bn_backward_step_ref(**x2, **kwb)),
                   bound_ms=b2, bound_by=by2, library_ms=None),
    }
    shape = (x1["y1"].shape[0], x1["adj_loop"].shape[0])
    for k, v in out.items():
        say(f"{k} timing at {shape[0]} block rows ({shape[1]} loop): kernel {v['ms']:.4f} ms, "
            f"plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']})")
    return out


def check_plain(torch, label, got, want, names, summed=(), exact=()):
    """A kernel's outputs against its plain version's on the same inputs:
    per-node outputs within TOL, flags (`exact`) equal, per-block partials
    (`summed`) summed over the blocks within close_sum. Returns the largest
    per-node difference."""
    worst, parts = 0.0, []
    for name, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        if not bool(torch.isfinite(a).all()):
            fail(f"{label}: non-finite {name}")
        if name in exact:
            flips = int((a != b).sum())
            parts.append(f"{name} differing {flips} of {a.numel()}")
            if flips:
                fail(f"{label}: {name} disagrees with its plain version")
        elif name in summed:
            parts.append(f"summed {name} {close_sum(torch, a.sum(0), b.sum(0), f'{label} {name}'):.3e}")
        else:
            err = float((a - b).abs().max())
            worst = max(worst, err)
            parts.append(f"max|{name} - plain| {err:.3e}")
            if err > TOL:
                fail(f"{label}: {name} disagrees with its plain version")
    say(f"{label}: " + ", ".join(parts))
    return worst


def readout_like(torch, traj, nm, seed):
    """A cotangent of the trajectory as the readout gives it: nonzero only on
    the returned snapshot (here the last) and on real nodes."""
    g = torch.zeros_like(traj)
    gen = torch.Generator(device=traj.device).manual_seed(seed)
    g[-1] = 0.03 * torch.randn(traj.shape[1:], generator=gen, device=traj.device) * nm[..., None]
    return g


def bnfree_kernel_inputs(torch, gb):
    """K5-K8 operands as the BN-free training paths form them on the full set:
    K7/K8 and K6 (the first dep step) from the flagship without BatchNorm with
    masks from a seeded generator, K5 from the clean flagship; the forward
    trajectories from the plain versions and readout-like cotangents."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused
    drop_m, clean = flagship(torch, "cuda", "dropout"), flagship(torch, "cuda", "clean")
    K, thr = drop_m.spec.max_iteration, float(drop_m.spec.threshold)
    masks = core.draw_masks(drop_m.spec, gb, torch.Generator(device=gb.device).manual_seed(SEED + 5))
    with torch.no_grad():
        loop, dep, kw = core.dropout_operands(drop_m.spec, drop_m.params["state"], gb,
                                              masks["state"][0])
        k7 = dict(loop, K=K, threshold=thr, **kw)
        traj, _, agg = fused.train_loop_ref(**k7)
        k8 = dict(adjT=loop["adjT"], s0=loop["s0"], traj=traj, agg=agg, ms=loop["ms"],
                  ma=loop["ma"], fT=loop["fT"], w_cat=loop["w_cat"],
                  g_traj=readout_like(torch, traj, loop["nm"], SEED + 6), **kw)
        drop, _ = fused._make_drop(kw["alpha_drop"], kw["rate"])
        s = dep["s0"]
        k6 = dict(adjT=dep["adjT"], s=s, sd=drop(s, dep["ms"][0]), m=dep["ma"][0],
                  rT=core.residual_agg(gb, s), fT=dep["fT"][0], w_cat=dep["w_cat"], **kw)
        l3, _, _ = core.hybrid_operands(clean.spec, clean.params["state"], clean.bn["state"], gb)
        act = clean.spec.state_spec.activations[0]
        traj3, _ = fused.propagation_loop_ref(**l3, K=K, threshold=thr, activation=act)
        k5 = dict(adjT=l3["adjT"], s0=l3["s0"], traj=traj3, fT=l3["fT"], w2=l3["w2"],
                  affine=None, g_traj=readout_like(torch, traj3, l3["nm"], SEED + 7),
                  activation=act)
    return k5, k6, k7, k8


def random_bnfree_inputs(torch, gen, B, W, D, H, K, rate, alpha, act, dev):
    """Ragged K5-K8 operands: a sparse 'average' adjacency, keep bits and
    weights that keep the states O(1); K8's and K5's trajectories from the
    plain forwards. K6 is H wide, the loops D wide."""
    from gnn_tpu_torch.ops import fused

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def keep(*shape):
        return (torch.rand(*shape, generator=gen) > rate).to(torch.uint8).to(dev) if rate else None
    adjT = random_adj(torch, gen, B, W, dev)
    nm = (torch.rand(B, W, generator=gen) < 0.8).float().to(dev)
    kw = dict(activation=act, alpha_drop=alpha, rate=rate)
    k7 = dict(adjT=adjT, s0=r(B, W, D), ms=keep(K, B, W, D), ma=keep(K, B, W, D),
              fT=r(K, B, W, D, scale=0.3), w_cat=r(D, 2 * D, scale=0.5 / D ** 0.5), nm=nm, K=K,
              threshold=0.05, **kw)
    traj, _, agg = fused.train_loop_ref(**k7)
    k8 = dict(adjT=adjT, s0=k7["s0"], traj=traj, agg=agg, ms=k7["ms"], ma=k7["ma"],
              fT=k7["fT"], w_cat=k7["w_cat"], g_traj=r(K, B, W, D, scale=0.1), **kw)
    k6 = dict(adjT=adjT, s=r(B, W, D), sd=r(B, W, D), m=keep(B, W, D), rT=r(B, W, D, scale=0.3),
              fT=r(B, W, H, scale=0.3), w_cat=r(H, 2 * D, scale=0.5 / D ** 0.5), **kw)
    w2 = r(2 * D, D, scale=0.5 / D ** 0.5)
    aff = torch.stack([torch.rand(D, generator=gen) + 0.5, 0.1 * torch.randn(D, generator=gen)])
    traj3, _ = fused.propagation_loop_ref(adjT, k7["s0"], k7["fT"][0], w2, aff.to(dev), nm, K,
                                          0.05, act)
    k5 = dict(adjT=adjT, s0=k7["s0"], traj=traj3, fT=k7["fT"][0], w2=w2, affine=aff.to(dev),
              g_traj=r(K, B, W, D, scale=0.1), activation=act)
    return k5, k6, k7, k8


def check_bnfree(torch, k5, k6, k7, k8, label):
    """K5-K8 against their plain versions. Returns their largest per-node
    differences."""
    from gnn_tpu_torch.ops import fused

    def run(name, x):
        return against_plain(torch, fused, name, x)
    B, W, D = k7["s0"].shape
    shape = f"B={B} W={W} D={D} K={k7['K']} {k7['activation']} rate={k7['rate']}"
    return {
        "K5": check_plain(torch, f"K5 {label} ({shape}, affine={k5['affine'] is not None})",
                          *run("propagation_loop_bwd", k5), ("gs", "dw2", "dfT", "daff"),
                          summed=("dw2", "daff")),
        "K6": check_plain(torch, f"K6 {label} (Bd={k6['adjT'].shape[0]}, H={k6['fT'].shape[-1]}, "
                          f"res={k6['rT'] is not None})", *run("train_step", k6), ("y", "agg")),
        "K7": check_plain(torch, f"K7 {label} ({shape})", *run("train_loop", k7),
                          ("traj", "margins", "agg"), exact=("margins",)),
        "K8": check_plain(torch, f"K8 {label} ({shape})", *run("train_loop_bwd", k8),
                          ("gs", "dw", "dfT"), summed=("dw",)),
    }


def bnfree_bounds(k5, k6, k7, k8):
    """(K5, K6, K7, K8) least times and what sets them: each input read once
    (the trajectories' last iteration is not an input of a reverse step),
    each output written once; operations on the arcs present plus the dense
    layer (4*D*D a node and iteration), its reverse and the elementwise work."""
    f4 = 4
    B, W, D = k7["s0"].shape
    K = k7["K"]
    n = B * W
    adj, nnz = f4 * k7["adjT"].numel(), _nnz(k7["adjT"])
    masks = 0 if k7["ms"] is None else 2 * K * n * D
    w = f4 * 2 * D * D
    bytes7 = adj + f4 * n * D + masks + f4 * K * n * D + w + f4 * n + f4 * K * n * (2 * D + 1)
    flops7 = K * (2 * D * nnz + 4 * D * D * n + 12 * D * n)
    bytes8 = (adj + f4 * n * D + f4 * (K - 1) * n * D + masks + f4 * 3 * K * n * D + w
              + f4 * n * D + f4 * B * 2 * D * D + f4 * K * n * D)
    flops8 = K * (2 * D * nnz + 12 * D * D * n + 16 * D * n)
    Bd, H = k6["fT"].shape[0], k6["fT"].shape[-1]
    nd = Bd * W
    bytes6 = (f4 * k6["adjT"].numel() + f4 * 3 * nd * D + (0 if k6["m"] is None else nd * D)
              + f4 * nd * H + f4 * 2 * H * D + f4 * nd * (H + D))
    flops6 = 2 * D * _nnz(k6["adjT"]) + 4 * D * H * nd + 8 * D * nd
    B5 = k5["adjT"].shape[0]
    n5 = B5 * W
    aff = 0 if k5["affine"] is None else f4 * (2 * D + B5 * 2 * D)
    bytes5 = (f4 * k5["adjT"].numel() + f4 * n5 * D * (K + 1) + w + f4 * K * n5 * D
              + f4 * 2 * n5 * D + f4 * B5 * 2 * D * D + aff)
    flops5 = K * (4 * D * _nnz(k5["adjT"]) + 12 * D * D * n5 + 10 * D * n5)
    return (bound(bytes5, flops5), bound(bytes6, flops6), bound(bytes7, flops7),
            bound(bytes8, flops8))


def phase_bnfree_kernels(torch, gb):
    """K5-K8 against their plain versions at the BN-free training paths'
    full-set shapes (K5 with and without the affine) and at ragged shapes of
    each register width (16, 32, 64); times and bounds at the full set."""
    from gnn_tpu_torch.ops import fused
    k5, k6, k7, k8 = bnfree_kernel_inputs(torch, gb)
    errs = check_bnfree(torch, k5, k6, k7, k8, "full set")
    gen = torch.Generator().manual_seed(SEED + 8)
    aff = torch.stack([torch.rand(k5["s0"].shape[-1], generator=gen) + 0.5,
                       0.1 * torch.randn(k5["s0"].shape[-1], generator=gen)]).to(gb.device)
    check_plain(torch, "K5 full set, affine", fused.propagation_loop_bwd(**dict(k5, affine=aff)),
                fused.propagation_loop_bwd_ref(**dict(k5, affine=aff)), ("gs", "dw2", "dfT", "daff"),
                summed=("dw2", "daff"))
    for B, W, D, H, K, rate, alpha, act in (
            (5, 32, 5, 7, 3, 0.2, True, "selu"), (3, 96, 14, 14, 4, 0.15, False, "tanh"),
            (4, 64, 24, 20, 3, 0.1, True, "relu"), (2, 128, 48, 40, 2, 0.0, True, "linear"),
            (3, 64, 64, 64, 2, 0.1, False, "selu")):
        check_bnfree(torch, *random_bnfree_inputs(torch, gen, B, W, D, H, K, rate, alpha, act,
                                                  gb.device), "ragged")
    bounds = bnfree_bounds(k5, k6, k7, k8)
    out = {}
    for (k, name, src, line), x, (b, by) in zip(
            (("K5", "propagation_loop_bwd", "eval_loop_bwd.cu", 517),
             ("K6", "train_step", "train_loop.cu", 662),
             ("K7", "train_loop", "train_loop.cu", 849),
             ("K8", "train_loop_bwd", "train_loop.cu", 992)), (k5, k6, k7, k8), bounds):
        kernel, plain = getattr(fused, name), getattr(fused, name + "_ref")
        out[k] = dict(name=f"{k} {name}", route="cuda", source=f"gnn_tpu_torch/ops/csrc/{src}",
                      replaces=f"gnn_tpu/ops/pallas_fused.py:{line}", max_abs_err=errs[k],
                      ms=timed_ms(torch, lambda: kernel(**x)),
                      plain_ms=timed_ms(torch, lambda: plain(**x)),
                      bound_ms=b, bound_by=by, library_ms=None)
        say(f"{k} timing at adjT {tuple(x['adjT'].shape)}: kernel {out[k]['ms']:.4f} ms, plain "
            f"{out[k]['plain_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    return out


def close_rel(torch, got, want, rtol, floor, label):
    err = (got - want).abs()
    if not bool((err <= rtol * want.abs() + floor * want.abs().max()).all()):
        fail(f"{label}: card and CPU differ by {float(err.max()):.3e}")
    return float(err.max())


def phase_training(torch, gb, n_arcs, variant, steps):
    """A training path on the card, counted (ROUTES[variant] launches, no
    other kernel), then the same steps on the CPU with the card's masks;
    step time and profile. Returns the launch counts of the steps."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn, fused
    model = flagship(torch, "cuda", variant)
    cpu = flagship(torch, "cpu", variant)
    gb_cpu = gb.to("cpu")
    K = model.spec.max_iteration
    say(f"---- training path '{variant}'")

    # ---- main path: training steps, counting kernel launches
    masks, log, grads0 = [], [], None
    times = []
    bn.reset_launches()
    fused.reset_launches()
    for i in range(steps):
        m = core.draw_masks(model.spec, gb, model.mask_gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.training_step(gb, masks=m)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        masks.append(m)
        log.append((out["iters"], out["loss"], {k: v.clone() for k, v in model.bn["state"].items()}))
        if i == 0:
            grads0 = {f"{net}/{name}/{k}": p.grad.clone() for net in model.params
                      for name, leaves in model.params[net].items() for k, p in leaves.items()}
    launches = {**bn.launches, **fused.launches}
    say(f"training path '{variant}' launches over {steps} steps: {launches}")
    for key, n in launches.items():
        per_step = ROUTES[variant].get(key, 0)
        want = steps * (K if per_step == "K" else per_step)
        if n != want:
            fail(f"'{variant}' path: {key} launched {n} times in {steps} steps, expected {want}")
    for p in core.param_leaves(model.params):
        if not bool(torch.isfinite(p).all()):
            fail(f"'{variant}' path: non-finite parameters after training")
    med = sorted(times)[len(times) // 2]
    iters = float(log[-1][0])
    say(f"training step '{variant}': {med * 1e3:.3f} ms median of {steps} (host clock, "
        f"synchronized; each {[round(t * 1e3, 3) for t in times]} ms), iters "
        f"{[float(r[0]) for r in log]}, losses {[round(float(r[1]), 4) for r in log]}, "
        f"{n_arcs * iters / med:.4e} edges/s")

    # ---- the same steps on the CPU with the card's masks
    t0 = time.perf_counter()
    worst = {"loss": 0.0, "bn": 0.0, "grad": 0.0}
    for i in range(steps):
        m = {net: {p: v.cpu() for p, v in d.items()} for net, d in masks[i].items()}
        out = cpu.training_step(gb_cpu, masks=m)
        it, loss, stats = log[i]
        if float(out["iters"]) != float(it):
            fail(f"'{variant}' step {i}: iters {float(it)} on the card, "
                 f"{float(out['iters'])} on the CPU")
        worst["loss"] = max(worst["loss"], close_rel(torch, loss.cpu(), out["loss"], 1e-5, 0.0,
                                                     f"'{variant}' step {i} loss"))
        for k in stats:
            err = float((stats[k].cpu() - cpu.bn["state"][k]).abs().max())
            worst["bn"] = max(worst["bn"], err)
            if err > TOL:
                fail(f"'{variant}' step {i}: moving {k} differs from the CPU by {err:.3e}")
        if i == 0:
            for net in cpu.params:
                for name, leaves in cpu.params[net].items():
                    for k, p in leaves.items():
                        key = f"{net}/{name}/{k}"
                        worst["grad"] = max(worst["grad"], close_rel(
                            torch, grads0[key].cpu(), p.grad, 2e-4, 2e-5, f"grad {key}"))
    perr = 0.0
    for a, b in zip(core.param_leaves(model.params), core.param_leaves(cpu.params)):
        perr = max(perr, float((a.detach().cpu() - b.detach()).abs().max()))
    if perr > TOL:
        fail(f"'{variant}' params after {steps} steps differ from the CPU by {perr:.3e}")
    say(f"'{variant}' training vs CPU over {steps} steps ({time.perf_counter() - t0:.1f} s): "
        f"iters equal, max loss diff {worst['loss']:.3e}, moving stats {worst['bn']:.3e}, "
        f"first-step grads {worst['grad']:.3e}, params after the last step {perr:.3e}")

    def step():
        model.training_step(gb)
        torch.cuda.synchronize()
    phase_profile(torch, step, runs=3, what=f"'{variant}' training step")
    return launches


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
    with torch.no_grad():   # the model's params are trainable leaves
        kernels = phase_kernels(torch, model, gb)

    # ---- serving path: Predictor warmup + requests, counting kernel launches
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
    say(f"serving path launches: {launches}")
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

    # ---- training: one batch of the whole set for every path
    t0 = time.perf_counter()
    gb_train = flagship(torch, "cuda").to_batch(graphs)
    say(f"training batch: {gb_train.n_node_pad // gb_train.block_w} blocks, "
        f"{gb_train.adj_loop.shape[0]} loop rows, {gb_train.adj_dep.shape[0]} dep "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    kernels.update(phase_train_kernels(torch, flagship(torch, "cuda"), gb_train))
    kernels.update(phase_bnfree_kernels(torch, gb_train))
    counted = {variant: phase_training(torch, gb_train, n_arcs, variant, steps)
               for variant, steps in (("bn", 5), ("dropout", 5), ("clean", 3))}
    for k, (variant, key) in {"K1": ("bn", "bn_forward_step"), "K2": ("bn", "bn_backward_step"),
                              "K5": ("clean", "propagation_loop_bwd"),
                              "K6": ("dropout", "train_step"), "K7": ("dropout", "train_loop"),
                              "K8": ("dropout", "train_loop_bwd")}.items():
        kernels[k]["launches"] = counted[variant][key]
    say(f"clean training path: K3 {counted['clean']['propagation_loop']} and K4 "
        f"{counted['clean']['propagation_step']} launches (the JSON line counts the serving path's)")
    kernels = {k: kernels[k] for k in sorted(kernels)}
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
