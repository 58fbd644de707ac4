#!/usr/bin/env python3
"""Spread of a training path's params on one CUDA card against float32 and float64 on the CPU.

Runs chip_smoke.py's flagship variant (default 'h150_bn') for `steps` training
steps on the MUTAG-shaped set's training batch `runs` times on the card, each
run from the same seeded weights with the same seeded dropout masks, then the
same steps on the CPU in float32 and in float64 (chip_smoke.py::steps64) with
the first run's masks. Printed: each param tensor's largest distance of the
CPU's float32 from float64, then for every card run each tensor's largest
distance from the CPU's float32 and from float64, and whether the card's
first-step grads of the tensor meet chip_smoke.py's grads bound against the
float64 grads (rtol 2e-4, floor 2e-5 of the largest entry; '+' they do, '-'
they do not). The spread between card runs comes from the plain PyTorch parts
of a step; the kernels repeat bit for bit. It shows how far apart two float32
computations of the same steps may land where the gradient is set-valued
(chip_smoke.py::check_params64).

Usage, from the repository root:
    python3 tools/params_spread.py [variant=h150_bn] [steps=3] [runs=8]
"""

import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def leaves(tree):
    """The tensors of a tree of dicts and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def main():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from gnn_tpu_torch.convert import flatten
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    variant = args.pop("variant", "h150_bn")
    steps, runs = int(args.pop("steps", 3)), int(args.pop("runs", 8))
    if args:
        cs.fail(f"unknown arguments {sorted(args)}")
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    graphs = mutag_shaped(seed=cs.SEED)
    gb = cs.flagship(torch, "cuda", variant).to_batch(graphs)
    gb_cpu = gb.to("cpu")

    card = []
    for _ in range(runs):
        model = cs.flagship(torch, "cuda", variant)
        masks, g0 = [], None
        for _ in range(steps):
            m = model._draw_masks(model.spec, gb, model.mask_gen)
            model.training_step(gb, masks=m)
            masks.append(cs.tree_map(lambda v: v.cpu(), m))
            if g0 is None:
                g0 = {k: p.grad.detach().cpu().double() for k, p in flatten(model.params).items()}
        card.append(({k: p.detach().cpu() for k, p in flatten(model.params).items()}, g0, masks))
    masks = card[0][2]
    cpu = cs.flagship(torch, "cpu", variant)
    for m in masks:
        cpu.training_step(gb_cpu, masks=m)
    m64, g64 = cs.steps64(torch, variant, gb_cpu, masks)
    p32 = {k: p.detach() for k, p in flatten(cpu.params).items()}
    p64 = {k: p.detach() for k, p in flatten(m64.params).items()}

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())

    print(f"'{variant}', {steps} steps, {runs} card runs ({torch.cuda.get_device_name(0)})")
    for k in p32:
        print(f"  {k}: CPU float32 vs float64 {dist(p32[k], p64[k]):.3e}")
    for r, (params, g0, m) in enumerate(card):
        same = all(torch.equal(a, b) for a, b in zip(leaves(m), leaves(masks)))
        cells = []
        for k in p32:
            ok, gerr = cs.grads_close(g0[k], g64[k])
            cells.append(f"{k} CPU {dist(params[k], p32[k]):.2e} f64 {dist(params[k], p64[k]):.2e} "
                         f"g{'+' if ok else '-'}{gerr:.1e}")
        worst = max(dist(params[k], p32[k]) for k in p32)
        print(f"run {r}: card vs CPU {worst:.3e}{'' if same else ' (other masks)'} | "
              + "; ".join(cells))
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
