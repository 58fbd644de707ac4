#!/usr/bin/env python3
"""chip_smoke.py's later phases alone, after the build: 21 (LGNN), 22
(the implicit adjoint), 23 (state_dim > 0 and the bf16 adjacency of the
hidden-150 recipe), 24 (the flagship on the bf16 adjacency), 25
(training on the bf16 adjacency: the recipe with its dropout and the clean
flagship), 26 (the flagship's BatchNorm-free dropout route on the bf16
adjacency) and 27 (the two-layer BatchNorm route and composite models on
the bf16 adjacency); the bf16 variants' f32 twins' times, which the earlier
phases measure, are not taken here. On the MUTAG-shaped set. The output and the checks are
chip_smoke.py's; its last-line contract is not. The kernels are built
unless the build folder holds a current library.

Usage, from the repository root:
    python3 tools/smoke_phases.py [phases=lgnn,ift,state_bf16,flagship_bf16,train_bf16,
                                          dropout_bf16,bn2_typed_bf16]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    phases = args.pop("phases", "lgnn,ift").split(",")
    if args or not set(phases) <= {"lgnn", "ift", "state_bf16", "flagship_bf16", "train_bf16",
                                   "dropout_bf16", "bn2_typed_bf16"}:
        cs.fail(f"unknown arguments {sorted(args)} or phases {phases}")
    cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build(force=False)
    graphs = mutag_shaped(seed=cs.SEED)
    n_arcs = sum(g.n_arcs for g in graphs)
    requests = [(name, graphs[i]) for name, i in cs.request_picks(graphs)]
    gb_train = cs.flagship(torch, "cuda").to_batch(graphs)
    if "lgnn" in phases:
        cs.phase_lgnn(torch, graphs, requests, gb_train, n_arcs)
    if "ift" in phases:
        cs.phase_ift(torch, gb_train, n_arcs)
    if "state_bf16" in phases:
        from gnn_tpu_torch import Predictor
        model = cs.flagship(torch, "cuda")
        gb = Predictor(model).build_batch(graphs).to("cuda")
        comp = cs.composite_model(torch, "cuda")
        gb_train_typed = comp.to_batch(cs.typed_graphs(graphs))
        twins = {k: {"ms": None, "replaces": f"gnn_tpu/ops/pallas_fused.py ({k})"}
                 for k in ("K9", "K10", "K11")}
        for entry in cs.phase_state_bf16(torch, graphs, requests, gb, gb_train, gb_train_typed,
                                         n_arcs, twins).values():
            cs.say(str(entry))
    if "flagship_bf16" in phases:
        twins = {k: {"ms": None, "replaces": f"gnn_tpu/ops/pallas_*.py ({k})"}
                 for k in ("K1", "K2", "K3", "K4")}
        for entry in cs.phase_flagship_bf16(torch, graphs, requests, n_arcs, twins).values():
            cs.say(str(entry))
    if "train_bf16" in phases:
        twins = {k: {"ms": None, "replaces": f"gnn_tpu/ops/pallas_fused.py ({k})"}
                 for k in ("K5", "K12", "K13")}
        for entry in cs.phase_train_bf16(torch, graphs, n_arcs, twins).values():
            cs.say(str(entry))
    if "dropout_bf16" in phases:
        twins = {k: {"ms": None, "replaces": f"gnn_tpu/ops/pallas_fused.py ({k})"}
                 for k in ("K6", "K7", "K8")}
        for entry in cs.phase_dropout_bf16(torch, graphs, n_arcs, twins).values():
            cs.say(str(entry))
    if "bn2_typed_bf16" in phases:
        twins = {k: {"ms": None, "replaces": f"gnn_tpu/ops/pallas_*.py ({k})"}
                 for k in ("K14", "K15", "K16", "K17")}
        for entry in cs.phase_bn2_typed_bf16(torch, graphs, n_arcs, twins).values():
            cs.say(str(entry))
    cs.say(f"done ({cs.elapsed()})")


if __name__ == "__main__":
    main()
