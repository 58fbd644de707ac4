"""Loss function registry (counterpart of gnn_tpu/training/losses.py).

Losses are named functions of (target, output) returning a per-row vector;
the model multiplies by sample weights and sums (reference GNN.py:198-199).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-7  # keras backend epsilon


def categorical_crossentropy(target, output, from_logits: bool = False, axis: int = -1):
    """-sum t * log p per row. With from_logits=False the outputs are clipped
    to [eps, 1 - eps] BEFORE the renormalisation (Keras normalises first):
    identical for probability rows, and no division by zero for rows that sum
    to about 0 (a BatchNorm after the softmax)."""
    if from_logits:
        log_p = torch.log_softmax(output, dim=axis)
    else:
        output = torch.clamp(output, _EPS, 1.0 - _EPS)
        output = output / torch.sum(output, dim=axis, keepdim=True)
        log_p = torch.log(torch.clamp(output, _EPS, 1.0 - _EPS))
    return -torch.sum(target * log_p, dim=axis)


def binary_crossentropy(target, output, from_logits: bool = False, axis: int = -1):
    if from_logits:
        bce = (torch.clamp_min(output, 0) - output * target
               + torch.log1p(torch.exp(-torch.abs(output))))
    else:
        p = torch.clamp(output, _EPS, 1.0 - _EPS)
        bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return torch.mean(bce, dim=axis)


def mean_squared_error(target, output, axis: int = -1):
    return torch.mean(torch.square(output - target), dim=axis)


def mean_absolute_error(target, output, axis: int = -1):
    return torch.mean(torch.abs(output - target), dim=axis)


def huber(target, output, delta: float = 1.0, axis: int = -1):
    abs_err = torch.abs(output - target)
    quad = torch.clamp_max(abs_err, delta)
    return torch.mean(0.5 * quad * quad + delta * (abs_err - quad), dim=axis)


def hinge(target, output, axis: int = -1):
    return torch.mean(F.relu(1.0 - target * output), dim=axis)


LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
    "huber": huber,
    "hinge": hinge,
}


def get_loss(name):
    """Resolve a loss by registry name (callables pass through)."""
    if callable(name):
        return name
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(set(LOSSES))}")
    return LOSSES[name]
