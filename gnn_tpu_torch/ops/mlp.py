"""MLP description, initialisation, apply and regularization (counterpart of
gnn_tpu/ops/mlp.py).

`MLPSpec` is the same static architecture record as gnn_tpu's (dense stack,
activations, initializers, dropout positions, trailing BatchNorm), so saved
configs load unchanged. Parameters are plain dicts of tensors; a dense
weight is stored as [out, in] and applied with `F.linear`.

At inference dropout is inactive and BatchNorm uses its running statistics
(eps 1e-3). In training, dropout applies keep-masks the caller draws (torch
cannot reproduce gnn_tpu's PRNG, so tests hand both packages the same
masks) and BatchNorm uses masked batch moments with momentum 0.99.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "linear": lambda x: x,
    None: lambda x: x,
    "relu": F.relu,
    "selu": F.selu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "swish": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "softmax": lambda x: torch.softmax(x, dim=-1),
}

# (kind, scale, mode) of the variance-scaling initializers; the normal ones
# draw from a normal truncated at 2 std, like jax.nn.initializers.
_VARIANCE_SCALING = {
    "lecun_normal": ("normal", 1.0, "fan_in"),
    "lecun_uniform": ("uniform", 1.0, "fan_in"),
    "glorot_normal": ("normal", 1.0, "fan_avg"),
    "glorot_uniform": ("uniform", 1.0, "fan_avg"),
    "he_normal": ("normal", 2.0, "fan_in"),
    "he_uniform": ("uniform", 2.0, "fan_in"),
}
_INITIALIZERS = tuple(_VARIANCE_SCALING) + ("zeros", "ones", "random_normal",
                                            "random_uniform")

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
# SELU alpha-dropout constants (Klambauer et al.; Keras AlphaDropout)
SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805
ALPHA_P = -SELU_ALPHA * SELU_SCALE   # the value dropped units saturate to


def _as_tuple(x, n):
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError("Dense parameters must have the same length to be correctly processed")
        return tuple(x)
    return tuple([x] * n)


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static architecture description (same fields as gnn_tpu's MLPSpec).

    :param input_dim: input feature dimension.
    :param units: per-dense-layer output widths (last = MLP output dim).
    :param activations: name or list of names from the activation registry.
    :param kernel_initializer / bias_initializer: name(s) from the registry.
    :param kernel_regularizer / bias_regularizer: kept for config parity.
    :param dropout_rate / dropout_pos: dropout before dense[pos] in training.
    :param alphadropout: AlphaDropout instead of Dropout in training.
    :param batch_normalization: trailing BatchNormalization layer.
    """
    input_dim: int
    units: Tuple[int, ...]
    activations: Union[str, Tuple[Optional[str], ...]] = "linear"
    kernel_initializer: Union[str, Tuple[str, ...]] = "glorot_normal"
    bias_initializer: Union[str, Tuple[str, ...]] = "zeros"
    kernel_regularizer: Union[None, str, tuple] = None
    bias_regularizer: Union[None, str, tuple] = None
    dropout_rate: Tuple[float, ...] = ()
    dropout_pos: Tuple[int, ...] = ()
    alphadropout: bool = False
    batch_normalization: bool = True

    def __post_init__(self):
        object.__setattr__(self, "units", tuple(int(u) for u in (
            self.units if isinstance(self.units, (list, tuple)) else [self.units])))
        n = len(self.units)
        object.__setattr__(self, "activations", _as_tuple(self.activations, n))
        object.__setattr__(self, "kernel_initializer", _as_tuple(self.kernel_initializer, n))
        object.__setattr__(self, "bias_initializer", _as_tuple(self.bias_initializer, n))
        dp, dr = self.dropout_pos, self.dropout_rate
        dp = (dp,) if isinstance(dp, int) else tuple(dp or ())
        dr = tuple([dr] * len(dp)) if isinstance(dr, float) else tuple(dr or ())
        if len(dp) != len(dr):
            raise ValueError("Dropout parameters must have the same length to be correctly processed")
        object.__setattr__(self, "dropout_pos", dp)
        object.__setattr__(self, "dropout_rate", dr)
        for a in self.activations:
            if a not in _ACTIVATIONS:
                raise ValueError(f"unknown activation {a!r}")
        for i in self.kernel_initializer + self.bias_initializer:
            if i not in _INITIALIZERS:
                raise ValueError(f"unknown initializer {i!r}")

    @property
    def num_layers(self) -> int:
        return len(self.units)

    def to_config(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_config(cls, d: dict) -> "MLPSpec":
        d = dict(d)
        for k in ("units", "activations", "kernel_initializer", "bias_initializer",
                  "dropout_rate", "dropout_pos", "kernel_regularizer", "bias_regularizer"):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        return cls(**d)


def _init_tensor(name: str, shape, fan_in: int, fan_out: int, gen: torch.Generator):
    if name == "zeros":
        return torch.zeros(shape)
    if name == "ones":
        return torch.ones(shape)
    if name == "random_normal":
        return 0.05 * torch.randn(shape, generator=gen)
    if name == "random_uniform":
        return (torch.rand(shape, generator=gen) * 2 - 1) * 0.05
    kind, scale, mode = _VARIANCE_SCALING[name]
    fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
    var = scale / max(fan, 1)
    if kind == "uniform":
        lim = math.sqrt(3 * var)
        return (torch.rand(shape, generator=gen) * 2 - 1) * lim
    # std of a unit normal truncated to [-2, 2] is 0.87962566103423978
    std = math.sqrt(var) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std,
                                       b=2 * std, generator=gen)


def mlp_init(spec: MLPSpec, gen: torch.Generator, device="cpu"):
    """(params, bn_state): dense weights [out, in] and biases [out]; a bias
    under a variance-scaling initializer uses fan_in = fan_out = its width,
    the Keras rank-1 rule gnn_tpu follows. BatchNorm starts at gamma 1,
    beta 0, mean 0, var 1."""
    params, fan_in = {}, spec.input_dim
    for i, units in enumerate(spec.units):
        w = _init_tensor(spec.kernel_initializer[i], (units, fan_in), fan_in, units, gen)
        b = _init_tensor(spec.bias_initializer[i], (units,), units, units, gen)
        params[f"dense_{i}"] = {"w": w.to(device), "b": b.to(device)}
        fan_in = units
    bn_state = {}
    if spec.batch_normalization:
        d = spec.units[-1]
        params["bn"] = {"gamma": torch.ones(d, device=device), "beta": torch.zeros(d, device=device)}
        bn_state = {"mean": torch.zeros(d, device=device), "var": torch.ones(d, device=device)}
    return params, bn_state


def dropout_widths(spec: MLPSpec):
    """{position: width} of the spec's active dropout layers: dropout at
    position i < num_layers acts on the input of dense i, at num_layers on
    the output."""
    ins = (spec.input_dim,) + spec.units
    return {p: ins[p] for p, r in zip(spec.dropout_pos, spec.dropout_rate) if r > 0.0}


def drop_coeffs(alpha: bool, rate: float):
    """(a, b) with dropout(x, keep) = a * where(keep, x, ALPHA_P) + b (alpha
    mode) or where(keep, a * x, 0) (standard mode, b = 0)."""
    if alpha:
        a = ((1.0 - rate) * (1.0 + rate * ALPHA_P ** 2)) ** -0.5
        return a, -a * ALPHA_P * rate
    return 1.0 / (1.0 - rate), 0.0


def _dropout(x, rate: float, keep, alpha: bool):
    """gnn_tpu's _dropout applied with a given boolean keep-mask."""
    if not alpha:
        return torch.where(keep, x / (1.0 - rate), 0.0)
    a, b = drop_coeffs(alpha, rate)
    return a * torch.where(keep, x, ALPHA_P) + b


def _batchnorm(params, bn_state, x, training: bool, stat_mask=None):
    """Trailing BatchNorm: training uses the two-pass moments over the rows of
    `stat_mask` (all rows when None) and returns the momentum-updated moving
    statistics; eval uses the moving statistics. Returns (y, new_state)."""
    gamma, beta = params["gamma"], params["beta"]
    if training:
        if stat_mask is None:
            n = float(x.shape[0])
            mean = torch.sum(x, dim=0) / n
            var = torch.sum(torch.square(x - mean), dim=0) / n
        else:
            w = stat_mask.to(x.dtype)[:, None]
            cnt = torch.clamp_min(torch.sum(w), 1.0)
            mean = torch.sum(x * w, dim=0) / cnt
            var = torch.sum(torch.square(x - mean) * w, dim=0) / cnt
        # moving statistics carry no gradient (gnn_tpu returns them as aux)
        mean_d, var_d = mean.detach(), var.detach()
        new_state = {"mean": bn_state["mean"] * BN_MOMENTUM + mean_d * (1.0 - BN_MOMENTUM),
                     "var": bn_state["var"] * BN_MOMENTUM + var_d * (1.0 - BN_MOMENTUM)}
    else:
        mean, var = bn_state["mean"], bn_state["var"]
        new_state = bn_state
    return (x - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta, new_state


def mlp_apply(spec: MLPSpec, params, bn_state, x: torch.Tensor, *, training: bool = False,
              keep: Optional[dict] = None, stat_mask=None):
    """Apply the MLP: dense and activation per layer, dropout where the spec
    puts it (training only) and the trailing BatchNorm. Returns
    (y, new_bn_state).

    :param training: dropout on and batch-statistic BatchNorm.
    :param keep: {dropout position: bool keep-mask of that layer's input
        shape}, required for each active dropout layer in training.
    :param stat_mask: optional bool [rows], the rows in the BN moments.
    """
    drop = dict(zip(spec.dropout_pos, spec.dropout_rate))

    def maybe_drop(h, i):
        if training and drop.get(i, 0.0) > 0.0:
            if keep is None or i not in keep:
                raise ValueError(f"a keep-mask for dropout position {i} is required in training")
            h = _dropout(h, drop[i], keep[i], spec.alphadropout)
        return h

    h = x
    for i in range(spec.num_layers):
        h = maybe_drop(h, i)
        p = params[f"dense_{i}"]
        h = _ACTIVATIONS[spec.activations[i]](F.linear(h, p["w"], p["b"]))
    h = maybe_drop(h, spec.num_layers)
    if spec.batch_normalization:
        h, bn_state = _batchnorm(params["bn"], bn_state, h, training, stat_mask)
    return h, bn_state


def _reg(kind, value):
    if kind is None:
        return 0.0
    name, coeff = kind if isinstance(kind, (tuple, list)) else (kind, 0.01)  # Keras default
    if name == "l2":
        return coeff * torch.sum(torch.square(value))
    if name == "l1":
        return coeff * torch.sum(torch.abs(value))
    raise ValueError(f"unknown regularizer {name!r}")


def mlp_regularization(spec: MLPSpec, params) -> torch.Tensor:
    """Sum of the kernel/bias regularizer terms over the dense layers, added to
    the loss (reference GNN_BaseClass.py:223-228)."""
    total = torch.zeros((), device=params["dense_0"]["w"].device)
    for i in range(spec.num_layers):
        p = params[f"dense_{i}"]
        total = total + _reg(spec.kernel_regularizer, p["w"]) + _reg(spec.bias_regularizer, p["b"])
    return total


def get_inout_dims(net_name: str, dim_node_label: int, dim_arc_label: int,
                   dim_target: int, focus: Optional[str] = None, dim_state: int = 0,
                   hidden_units=None, *, layer: int = 0, get_state: bool = False,
                   get_output: bool = False) -> Tuple[int, list]:
    """Input/output widths of the state or output net (reference MLP.py:68-122,
    including the LGNN layer>=1 label-growth rules)."""
    if layer < 0 or dim_state < 0 or focus not in ("a", "n", "g"):
        raise ValueError("need layer >= 0, dim_state >= 0 and focus in 'a', 'n', 'g'")
    DS, NL, AL, T = dim_state, dim_node_label, dim_arc_label, dim_target
    if layer > 0:
        GS, GO = get_state, get_output
        if DS != 0:
            NL = NL + DS * GS + T * (focus != "a") * GO
        else:
            NL = NL + layer * NL * GS + ((layer - 1) * GS + 1) * T * (focus != "a") * GO
        AL = AL + T * (focus == "a") * GO
    if net_name == "state":
        input_shape, output_shape = AL + 2 * (NL + DS), (DS if DS else NL)
    elif net_name == "output":
        input_shape, output_shape = (focus == "a") * (NL + AL + DS) + NL + dim_state, T
    else:
        raise ValueError(":param net_name: not in ['state', 'output']")
    if hidden_units is None or (isinstance(hidden_units, int) and hidden_units <= 0):
        hidden_units = []
    if isinstance(hidden_units, (list, tuple)):
        layers = list(hidden_units) + [output_shape]
    else:
        layers = [hidden_units, output_shape]
    return input_shape, layers
