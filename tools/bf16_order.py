#!/usr/bin/env python3
"""How far another f32 summation order moves the bf16 kernels' plain versions
at full scale, against Part B's gate: K10_bf16's (the bf16 h150 serving
batch's 1440 loop rows, K = 5) and K15_bf16's (the bf16 h150_bn training
batch's 1214 block rows, iteration 2's reverse), on chip_smoke.py's full-set
operands, on the CPU.

For each product of a plain version (K10_bf16: U, the aggregation A, h1;
K15_bf16: h0, h1, dy0, dx2, the contraction A), and for sets of them
(K15_bf16: dy0, dx2 and A together, and those with h1), the plain version
runs with those products' sums in another
order (the terms in reverse, two at a time; the arcs in reverse), the others
as they are, and its outputs (K15_bf16: all six, the per-block partials
unsummed) are held to the plain version's by chip_smoke.py's gate: the share of entries within
the tolerance (1e-5; grads rtol 2e-4 with a floor of 2e-5 of the largest),
the largest difference, the one-flip bound (the plain version with one
flip at the kernel's rounding point an iteration) and the entries beyond
both. A tensor-core tile adds in an order of its own, so a product whose
reordering passes no gate cannot run on the tiles and keep the gate; a
product whose sums are exact in f32 in any order (0 entries differ) can.

Usage, from the repository root: python3 tools/bf16_order.py [K10] [K15]
(about 4 minutes on 8 CPU cores).
"""

import contextlib
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn, fused2
    which = sys.argv[1:] or ["K10", "K15"]
    graphs = mutag_shaped(seed=cs.SEED)
    exact_dot, exact_adj = fused2._exact_dot, fused2._exact_adj

    def reversed_dot(x, w, pairs=False):
        """_exact_dot with the terms in reverse, two at a time."""
        C = x.shape[-1]
        x2, acc = x.reshape(-1, C), None
        for c in range(C - 1, -1, -2):
            t = x2[:, c:c + 1] * w[:, c]
            if c > 0:
                t = t + x2[:, c - 1:c] * w[:, c - 1]
            acc = t if acc is None else acc + t
        return acc.reshape(x.shape[:-1] + (w.shape[0],))

    @contextlib.contextmanager
    def reordered(products, tag_of):
        """Within: the sums of each of `products` ("U+A": several; "A": every
        aggregation, else the dense product tag_of names by its widths) in
        the other order."""
        products = products.split("+")

        def dot(x, w, pairs=False):
            f = reversed_dot if tag_of(x.shape[-1], w.shape[0]) in products else exact_dot
            return f(x, w, pairs)

        def adj(slots, x):
            order, wts = slots
            return exact_adj((order.flip(1), wts.flip(1)) if "A" in products else slots, x)
        fused2._exact_dot, fused2._exact_adj = dot, adj
        try:
            yield
        finally:
            fused2._exact_dot, fused2._exact_adj = exact_dot, exact_adj

    def gate(label, got, want, flipped, grads):
        got, want, flipped = (np.asarray(t, np.float64) for t in (got, want, flipped))
        tol = (2e-4 * np.abs(want) + 2e-5 * np.abs(want).max()) if grads else 1e-5
        err = np.abs(got - want)
        bound = float(np.abs(flipped - want).max())
        beyond = int(((err > tol) & (err > bound)).sum())
        cs.say(f"{label}: {float(np.mean(err <= tol)):.6f} of {err.size} within the tolerance, "
               f"{int((err > 0).sum())} differ, largest {float(err.max()):.3e}, one-flip bound "
               f"{bound:.3e}, {beyond} beyond both: {'passes' if beyond == 0 and np.mean(err <= tol) >= 0.99 else 'FAILS'}")

    with torch.no_grad():
        if "K10" in which:
            m = cs.flagship(torch, "cpu", "h150")
            gb = Predictor(m, adj_dtype=torch.bfloat16, device="cpu").build_batch(graphs)
            loop, _ = core.hybrid2_operands(m.spec, m.params["state"], m.bn["state"], gb)
            x = dict(loop, K=m.spec.max_iteration, threshold=float(m.spec.threshold),
                     **dict(zip(("act0", "act1"), m.spec.state_spec.activations)))
            D = x["s0"].shape[-1]
            want = fused2.propagation_loop2_bf16_ref(**x)
            with cs.one_flip(torch, x["adjT"], "ua"):
                flipped = fused2.propagation_loop2_bf16_ref(**x)
            for product in ("U", "A", "h1"):
                with reordered(product, lambda c, o: "U" if c == D else "h1"):
                    got = fused2.propagation_loop2_bf16_ref(**x)
                gate(f"K10_bf16, {product} reordered, traj", got[0], want[0], flipped[0], False)
                cs.say(f"K10_bf16, {product} reordered: {int((got[1] != want[1]).sum())} "
                       f"movement flags differ")
        if "K15" in which:
            m = cs.flagship(torch, "cpu", "h150_bn")
            gbt = m.to_batch(graphs, adj_dtype=torch.bfloat16)
            _, _, x15, kw = cs.train_kernel_inputs(torch, m, gbt)
            x = dict(x15, **kw)
            D, H1 = x["w1"].shape
            C = x["w0_aug"].shape[1]
            tags = {(C, H1): "h0", (H1, D): "h1", (D, H1): "dy0", (H1, 2 * D): "dx2"}
            want = bn.bn2_backward_step_bf16_ref(**x)
            with cs.one_flip(torch, cs.bf16_flip_adj(torch, x), "dh0"):
                flipped = bn.bn2_backward_step_bf16_ref(**x)
            for product in ("h0", "h1", "dy0", "dx2", "A", "dy0+dx2+A", "h1+dy0+dx2+A"):
                with reordered(product, lambda c, o: tags.get((c, o))):
                    got = bn.bn2_backward_step_bf16_ref(**x)
                for i, name in enumerate(("ds", "dw0", "dw1", "db1", "dagg", "red")):
                    gate(f"K15_bf16, {product} reordered, {name}", got[i], want[i], flipped[i],
                         True)


if __name__ == "__main__":
    main()
