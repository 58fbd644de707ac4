"""Optimizer configs, optimizers and learning-rate schedules (counterpart of
gnn_tpu/training/optimizers.py).

A config is the same serialisable {"name", "kwargs"} dict as gnn_tpu's, with
its defaults and Keras-style aliases (Adam's eps is 1e-7, optax's default is
1e-8), so a saved config means the same optimizer in both packages. Each of
the seven names is `OptaxRule`, a torch optimizer whose step is the optax
0.2.6 chain that gnn_tpu's `make_optimizer` builds for it, in plain tensor
ops in optax's order: its moments, bias corrections (1 - b**count in
float32), eps placements and initial accumulators, and optax's own default
for any key a config leaves out. torch.optim's classes differ from optax in
some of these (rmsprop's eps inside the square root, adagrad's accumulator
starting at 0.1, lamb's per-tensor trust ratio, lion), so none is used. A
`learning_rate` given as a schedule dict ({"name": ..., "kwargs": ...},
`make_schedule`) is read at the update count, which starts at 0, as optax's
scale_by_schedule reads it.

gnn_tpu's `freeze_config` / `thaw_config` are not ported: they make a config
hashable for jax.jit's static arguments, and nothing here is jitted.
"""

from __future__ import annotations

import math

import numpy as np
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

# optax 0.2.6's defaults of the keys each optimizer takes (learning_rate has
# none: every config carries one)
_OPTAX = {
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False),
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4,
                  nesterov=False),
    "sgd": dict(momentum=None, nesterov=False),
    "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True, centered=False,
                    momentum=None, nesterov=False, bias_correction=False),
    "adagrad": dict(initial_accumulator_value=0.1, eps=1e-7),
    "lamb": dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0),
    "lion": dict(b1=0.9, b2=0.99, weight_decay=1e-3),
}
# keys optax takes that a JSON config cannot mean here (a dtype, a mask
# pytree) other than at their default None
_NONE_ONLY = ("mu_dtype", "accumulator_dtype", "mask")


def optimizer_config(name: str = "adam", **kwargs) -> dict:
    """Build a serialisable optimizer config dict."""
    name = name.lower()
    if name not in _DEFAULTS:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_DEFAULTS)}")
    cfg = dict(_DEFAULTS[name])
    cfg.update({_ALIASES.get(k, k): v for k, v in kwargs.items()})
    return {"name": name, "kwargs": cfg}


# ------------------------------------------------------------------ schedules
_F = np.float32


def _cosine_decay(init_value, decay_steps, alpha=0.0, exponent=1.0):
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count):
        c = min(_F(count), _F(decay_steps))
        cosine = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * c / _F(decay_steps)))
        return _F(init_value) * ((_F(1) - _F(alpha)) * cosine ** _F(exponent) + _F(alpha))
    return schedule


def _exponential_decay(init_value, transition_steps, decay_rate, transition_begin=0,
                       staircase=False, end_value=None):
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: _F(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        dc = _F(count - transition_begin)
        p = dc / _F(transition_steps)
        if staircase:
            p = np.floor(p)
        v = _F(init_value) if dc <= 0 else _F(init_value) * np.power(_F(decay_rate), p)
        if end_value is not None:
            v = (max if decay_rate < 1.0 else min)(v, _F(end_value))
        return _F(v)
    return schedule


def _linear(init_value, end_value, transition_steps, transition_begin=0):
    if transition_steps <= 0:
        return lambda count: _F(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = _F(min(max(count - transition_begin, 0), transition_steps))
        frac = _F(1) - c / _F(transition_steps)
        return (_F(init_value) - _F(end_value)) * frac + _F(end_value)
    return schedule


def _warmup_cosine(init_value, peak_value, warmup_steps, decay_steps, end_value=0.0,
                   exponent=1.0):
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear(init_value, peak_value, warmup_steps)
    cos = _cosine_decay(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warm(count) if count < warmup_steps else cos(count - warmup_steps)


def _constant(value):
    return lambda count: _F(value)


# gnn_tpu's _SCHEDULES, with optax's argument names
_SCHEDULES = {
    "cosine_decay": _cosine_decay,
    "exponential_decay": _exponential_decay,
    "warmup_cosine": _warmup_cosine,
    "linear": _linear,
    "constant": _constant,
}


def make_schedule(spec):
    """A learning-rate schedule, a function of the update count (from 0), from
    a spec {"name": "cosine_decay", "kwargs": {"init_value": 1e-3,
    "decay_steps": 1000}} (or a callable, returned as it is)."""
    if callable(spec):
        return spec
    return _SCHEDULES[spec["name"]](**spec.get("kwargs", {}))


# ----------------------------------------------------------------- optimizer
def _bias_correction(decay: float, count: int) -> torch.Tensor:
    """1 - decay**count in float32, as optax forms it."""
    return 1.0 - torch.tensor(decay, dtype=torch.float32) ** count


def _trace(state, u, decay, nesterov):
    """optax.trace: t = u + decay * t; the update t (nesterov: u + decay * t)."""
    t = state.get("trace")
    t = u if t is None else u + decay * t
    state["trace"] = t
    return u + decay * t if nesterov else t


class OptaxRule(torch.optim.Optimizer):
    """The optax update of optimizer `name` (keys `hyper`, optax's defaults
    filled in) with learning rate `lr`, a number or a function of the update
    count. The count, optax's shared step counter, lives in the param group
    and so in state_dict()."""

    def __init__(self, params, name: str, lr, hyper: dict):
        super().__init__(params, dict(lr=lr, count=0, **hyper))
        self.name = name

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            count = group["count"]
            lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
            step_size = torch.tensor(-float(lr), dtype=torch.float32)
            for p in group["params"]:
                if p.grad is not None:
                    st = self.state[p]
                    u = getattr(self, "_" + self.name)(p, p.grad, st, group, count)
                    u = u * step_size.to(p.device)
                    if self.name == "rmsprop" and group["momentum"] is not None:
                        u = _trace(st, u, group["momentum"], group["nesterov"])
                    p.add_(u)
            group["count"] = count + 1
        return loss

    # each returns the update before the learning rate (optax's chain up to
    # scale_by_learning_rate); step() scales it and adds rmsprop's momentum
    # trace after it, as optax chains them (sgd's trace comes before)
    def _adam_moments(self, g, st, h, count):
        b1, b2 = h["b1"], h["b2"]
        mu = (1 - b1) * g + b1 * st["mu"] if "mu" in st else (1 - b1) * g
        nu = (1 - b2) * g ** 2 + b2 * st["nu"] if "nu" in st else (1 - b2) * g ** 2
        st["mu"], st["nu"] = mu, nu
        c = count + 1
        if h.get("nesterov"):
            mu_hat = (b1 * (mu / _bias_correction(b1, c + 1).to(g.device))
                      + (1 - b1) * (g / _bias_correction(b1, c).to(g.device)))
        else:
            mu_hat = mu / _bias_correction(b1, c).to(g.device)
        nu_hat = nu / _bias_correction(b2, c).to(g.device)
        return mu_hat / (torch.sqrt(nu_hat + h["eps_root"]) + h["eps"])

    def _adam(self, p, g, st, h, count):
        return self._adam_moments(g, st, h, count)

    def _adamw(self, p, g, st, h, count):
        return self._adam_moments(g, st, h, count) + h["weight_decay"] * p

    def _lamb(self, p, g, st, h, count):
        u = self._adam_moments(g, st, h, count) + h["weight_decay"] * p
        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / un)
        return u * ratio

    def _lion(self, p, g, st, h, count):
        b1, b2 = h["b1"], h["b2"]
        mu = st.get("mu", torch.zeros_like(g))
        u = torch.sign((1.0 - b1) * g + b1 * mu)
        st["mu"] = (1 - b2) * g + b2 * mu
        return u + h["weight_decay"] * p

    def _adagrad(self, p, g, st, h, count):
        acc = st.get("sum", torch.full_like(g, h["initial_accumulator_value"]))
        acc = g * g + acc
        st["sum"] = acc
        return torch.where(acc > 0, torch.rsqrt(acc + h["eps"]), 0.0) * g

    def _rmsprop(self, p, g, st, h, count):
        decay, eps = h["decay"], h["eps"]
        nu = (1 - decay) * g ** 2 + decay * st.get("nu", torch.full_like(g, h["initial_scale"]))
        st["nu"] = nu
        mu = None
        if h["centered"]:
            mu = (1 - decay) * g + decay * st.get("mu", torch.zeros_like(g))
            st["mu"] = mu
        if h["bias_correction"]:
            bc = _bias_correction(decay, count + 1).to(g.device)
            nu = nu / bc
            mu = None if mu is None else mu / bc
        var = nu if mu is None else nu - mu * mu
        scale = torch.rsqrt(var + eps) if h["eps_in_sqrt"] else 1 / (torch.sqrt(var) + eps)
        return scale * g

    def _sgd(self, p, g, st, h, count):
        return g if h["momentum"] is None else _trace(st, g, h["momentum"], h["nesterov"])


def make_optimizer(config, params) -> torch.optim.Optimizer:
    """A torch optimizer over the tensors `params` from a config dict (or a
    name): optax's update rule of the name (OptaxRule), learning_rate a
    number or a schedule dict (make_schedule)."""
    if isinstance(config, str):
        config = optimizer_config(config)
    name, kwargs = config["name"], dict(config.get("kwargs", {}))
    if name not in _OPTAX:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_OPTAX)}")
    lr = kwargs.pop("learning_rate")
    if isinstance(lr, dict):
        lr = make_schedule(lr)
    for key in _NONE_ONLY:
        if kwargs.pop(key, None) is not None:
            raise NotImplementedError(f"{name}: a {key} other than None has no meaning in a "
                                      f"serialised config")
    unknown = sorted(set(kwargs) - set(_OPTAX[name]))
    if unknown:
        raise TypeError(f"{name}() got unexpected keyword arguments {unknown}")
    hyper = dict(_OPTAX[name])
    hyper.update(kwargs)
    return OptaxRule(list(params), name, lr, hyper)
