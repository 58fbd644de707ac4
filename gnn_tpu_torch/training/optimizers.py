"""Optimizer configs and factory (counterpart of gnn_tpu/training/optimizers.py).

A config is the same serialisable {"name", "kwargs"} dict as gnn_tpu's, with
its defaults and Keras-style aliases (Adam's eps is 1e-7, torch's default is
1e-8), so a saved config means the same optimizer in both packages. Only
Adam is mapped to a torch optimizer so far; every other name raises until a
test holds it against optax.
"""

from __future__ import annotations

import torch

_DEFAULTS = {
    "adam": dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-7),
    "adamw": dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-7, weight_decay=4e-3),
    "sgd": dict(learning_rate=1e-2),
    "rmsprop": dict(learning_rate=1e-3, decay=0.9, eps=1e-7),
    "adagrad": dict(learning_rate=1e-3),
    "lamb": dict(learning_rate=1e-3),
    "lion": dict(learning_rate=1e-4),
}

_ALIASES = {  # Keras-style kwarg names
    "lr": "learning_rate", "beta_1": "b1", "beta_2": "b2", "epsilon": "eps",
}


def optimizer_config(name: str = "adam", **kwargs) -> dict:
    """Build a serialisable optimizer config dict."""
    name = name.lower()
    if name not in _DEFAULTS:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_DEFAULTS)}")
    cfg = dict(_DEFAULTS[name])
    cfg.update({_ALIASES.get(k, k): v for k, v in kwargs.items()})
    return {"name": name, "kwargs": cfg}


def make_optimizer(config, params) -> torch.optim.Optimizer:
    """A torch optimizer over the tensors `params` from a config dict (or a
    name). Adam maps to torch.optim.Adam with optax's update rule
    (bias-corrected moments, eps added outside the square root)."""
    if isinstance(config, str):
        config = optimizer_config(config)
    name, kwargs = config["name"], dict(config.get("kwargs", {}))
    if name != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; only 'adam' is")
    lr = kwargs.pop("learning_rate")
    if not isinstance(lr, (int, float)):
        raise NotImplementedError("learning-rate schedules are not ported yet")
    # a config that leaves a key out gets optax.adam's default, as in gnn_tpu
    b1, b2, eps = kwargs.pop("b1", 0.9), kwargs.pop("b2", 0.999), kwargs.pop("eps", 1e-8)
    if kwargs:
        raise NotImplementedError(f"adam options {sorted(kwargs)} are not ported yet")
    return torch.optim.Adam(list(params), lr=float(lr), betas=(float(b1), float(b2)),
                            eps=float(eps))
