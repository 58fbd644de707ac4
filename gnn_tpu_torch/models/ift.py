"""Implicit-function-theorem gradients for the fixed-point propagation
(counterpart of gnn_tpu/models/ift.py).

With `grad_mode='ift'` the loss is not differentiated through the unrolled
iterations. At the fixed point s* = f(s*, θ),

    dL/dθ = λᵀ ∂f/∂θ  with  λ = (I − ∂f/∂sᵀ)⁻¹ ∂L/∂s*,

and λ comes from the Neumann iteration λ ← ∂L/∂s* + (∂f/∂s)ᵀ λ, run for
`ift_backward_iters` steps: one forward of f at s* and one vector-Jacobian
product a step, so the backward's memory does not grow with the iteration
count. f must be stationary (no dropout in the state net); BatchNorm
statistics are the ones at the fixed point.

gnn_tpu computes this adjoint in XLA, outside its Pallas kernels, so it is
plain PyTorch here: `f` is the plain body's step, and no kernel's autograd
Function runs in the Neumann loop.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def fixed_point_ift(f: Callable, n_backward: int, params: List[torch.Tensor],
                    s_star: torch.Tensor, consts):
    """Identity on `s_star` whose backward is the implicit adjoint.

    :param f: f(params, s, consts) -> the next state, one stationary step.
    :param n_backward: Neumann iterations of the adjoint solve.
    :param params: f's differentiable parameters, a flat list of tensors.
    :param s_star: the fixed point, already computed (its own graph is not
        used: it carries no gradient).
    :param consts: what else f reads; it gets no gradient, as gnn_tpu's zero
        cotangents.
    """
    return _FixedPointIFT.apply(f, int(n_backward), consts, s_star.detach(), *params)


class _FixedPointIFT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, n_backward, consts, s_star, *params):
        ctx.f, ctx.n_backward, ctx.consts = f, n_backward, consts
        ctx.save_for_backward(s_star, *params)
        return s_star.clone()

    @staticmethod
    def backward(ctx, ct):
        s_star, *params = ctx.saved_tensors
        wanted = list(ctx.needs_input_grad[4:])
        with torch.enable_grad():
            s = s_star.detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(w) for p, w in zip(params, wanted)]
            out = ctx.f(ps, s, ctx.consts)
            lam = ct
            for _ in range(ctx.n_backward):
                (js,) = torch.autograd.grad(out, s, lam, retain_graph=True)
                lam = ct + js
            inputs = [p for p, w in zip(ps, wanted) if w]
            got = iter(torch.autograd.grad(out, inputs, lam, allow_unused=True)
                       if inputs else ())
        grads = [next(got) if w else None for w in wanted]
        grads = [torch.zeros_like(p) if w and g is None else g
                 for p, w, g in zip(params, wanted, grads)]
        return (None, None, None, None, *grads)
