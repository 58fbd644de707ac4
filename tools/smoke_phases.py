#!/usr/bin/env python3
"""chip_smoke.py's later phases alone, after the build: 21 (LGNN) and 22
(the implicit adjoint), on the MUTAG-shaped set. The output and the checks
are chip_smoke.py's; its last-line contract is not. The kernels are built
unless the build folder holds a current library.

Usage, from the repository root:
    python3 tools/smoke_phases.py [phases=lgnn,ift]
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
    if args or not set(phases) <= {"lgnn", "ift"}:
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
    cs.say(f"done ({cs.elapsed()})")


if __name__ == "__main__":
    main()
