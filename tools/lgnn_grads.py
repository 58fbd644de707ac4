#!/usr/bin/env python3
"""Where an LGNN step's grads on one CUDA card differ from float64, and why.

Runs chip_smoke.py's phase-21 stacks (chip_smoke.py::lgnn_model: the 5-layer
hidden-150 stack in a parallel step, a residual step and a serial epoch, then
the starter's stack in a parallel step) on the MUTAG-shaped set's training
batch, from the same seeded weights with the same masks, four ways: on the
card through its kernels, on the card with every kernel replaced by its
plain version (chip_smoke.py::plain_versions), on the CPU in float32, and in
float64 on the card through the plain versions (chip_smoke.py::stack_twin;
for the parallel step also on the CPU, to show the two float64 runs agree).
Each float32 run records its readouts' pre-activations
(chip_smoke.py::readout_units); the selu units on the other side of the kink
than float64's are that run's own derivative branches, and the float64 twin
is run again with those units switched. The float64 twin is also run with
every state-net selu unit within the card's float32 rounding of the kink on
its other branch (chip_smoke.py::kinks_switched; the rounding taken as the
largest distance between the card's readout pre-activations and float64's):
how far the gradient's set of values reaches at this scale.

For each parameter tensor it prints the largest float64 entry and, for each
float32 run, its norm-wise distance from float64 over float64's norm, the
count of entries outside chip_smoke.py's grads bound (rtol 2e-4, floor 2e-5
of the largest entry) against float64 and, for the card and the CPU, against
the float64 twin along their own readout branches; then the same count for
the near-kink twin. Then the verdict of chip_smoke.py::hold_stack on the
card against the CPU.

Usage, from the repository root:
    python3 tools/lgnn_grads.py
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from gnn_tpu_torch.convert import flatten
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.models import lgnn as tlgnn
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build(force=False)
    gb = cs.flagship(torch, "cuda").to_batch(mutag_shaped(seed=cs.SEED))
    gb_cpu = gb.to("cpu")
    tmp = tempfile.mkdtemp(prefix="lgnn_grads_")

    def bound_misses(x, w):
        e = (x - w).abs()
        return int((e > 2e-4 * w.abs() + 2e-5 * w.abs().max()).sum())

    def norm(x, w):
        return float(torch.linalg.norm(x - w) / torch.linalg.norm(w))

    def flips(pre, base):
        return [(a.to(b.device) > 0) != (b > 0) if n == "selu"
                else torch.zeros_like(b, dtype=torch.bool) for (n, a), (_, b) in zip(pre, base)]

    def selu_counts(f, pre):
        return [int(x.sum()) for x, (n, _) in zip(f, pre) if n == "selu"]
    for name, starter, mode in (("hidden-150 parallel step", False, "parallel"),
                                ("hidden-150 residual step", False, "residual"),
                                ("hidden-150 serial epoch", False, "serial"),
                                ("starter parallel step", True, "parallel")):
        def make(device):
            return cs.lgnn_model(torch, device, tmp + "/w/", starter=starter)
        masks = tlgnn.draw_masks(make("cuda")._specs, gb, make("cuda").mask_gen)

        def run(model, batch, masks=masks):
            if mode == "serial":
                model.train(batch, 1, update_freq=1, training_mode="serial", verbose=0)
            else:
                model.training_mode = mode
                model.training_step(batch, masks=cs.tree_map(
                    lambda v: None if v is None else v.to(batch.nodes.device), masks))

        def float32(device, plain=False):
            model = make(device)
            with cs.readout_units(torch) as pre:
                if plain:
                    with cs.plain_versions():
                        run(model, gb)
                else:
                    run(model, gb if device == "cuda" else gb_cpu)
            flat = flatten(model._params())
            return {"grads": {k: p.grad.detach().cpu().double() for k, p in flat.items()},
                    "params": {k: p.detach().cpu() for k, p in flat.items()}, "pre": pre}
        runs = {"kernels": float32("cuda"), "plain on the card": float32("cuda", plain=True),
                "CPU float32": float32("cpu")}
        twin = cs.stack_twin(torch, make, gb, run)
        g64 = twin["grads"]
        print(f"---- {name}, {cs.CARD}", flush=True)
        if name == "hidden-150 parallel step":
            g64c = cs.stack_twin(torch, make, gb_cpu, run)["grads"]
            print("float64 on the card vs on the CPU: largest norm-wise distance "
                  f"{max(norm(g64[k], g64c[k]) for k in g64):.3e}", flush=True)
        switched = {}
        for label in ("kernels", "CPU float32"):
            f = flips(runs[label]["pre"], twin["pre"])
            print(f"{label}: readout selu units on the other side of the kink than float64's, "
                  f"by call: {selu_counts(f, twin['pre'])}", flush=True)
            switched[label] = (cs.stack_twin(torch, make, gb, run, f)["grads"]
                               if any(bool(x.any()) for x in f) else g64)
        f = flips(runs["plain on the card"]["pre"], twin["pre"])
        print(f"plain on the card: by call {selu_counts(f, twin['pre'])}", flush=True)
        band = max(float((a.to(b.device).double() - b).abs().max())
                   for (_, a), (_, b) in zip(runs["kernels"]["pre"], twin["pre"]))
        near = cs.stack_twin(torch, make, gb, run, band=band)
        print(f"near-kink twin: {near['switched']} state-net selu units within {band:.3e} of the "
              f"kink switched", flush=True)
        for k, w in g64.items():
            row = [f"{k:32s} max|g| {float(w.abs().max()):.3e}"]
            for label, r in runs.items():
                x = r["grads"][k]
                cell = f"{label}: norm {norm(x, w):.2e} outside {bound_misses(x, w)}"
                if label in switched:
                    cell += f" (own branches {bound_misses(x, switched[label][k])})"
                row.append(cell)
            row.append(f"near-kink twin: norm {norm(near['grads'][k], w):.2e} outside "
                       f"{bound_misses(near['grads'][k], w)}")
            print(" | ".join(row), flush=True)
        card, cpu = runs["kernels"], runs["CPU float32"]
        try:
            cs.hold_stack(torch, f"{name}:", {"grads": card["grads"], "params": card["params"]},
                          {"grads": {k: v.float() for k, v in cpu["grads"].items()},
                           "params": cpu["params"]}, card["pre"],
                          lambda sw, band=None: cs.stack_twin(torch, make, gb, run, sw, band),
                          serial=mode == "serial")
            print(f"{name}: hold_stack passes", flush=True)
        except SystemExit:
            print(f"{name}: hold_stack fails (message above)", flush=True)


if __name__ == "__main__":
    main()
