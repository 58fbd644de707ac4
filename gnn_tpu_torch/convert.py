"""Weights carried across from gnn_tpu.

gnn_tpu keeps parameters as pytrees of nested dicts ({"state": {"dense_0":
{"w": [in, out], "b": [out]}, "bn": {"gamma", "beta"}}, "output": {...}}) and
BatchNorm statistics as {"state": {"mean", "var"}, "output": {...}}. Its save
folder flattens them into .npz files keyed by tree paths such as
"['state']['dense_0']['w']" (models/engine.py::tree_to_npz). The port keeps
the same nesting with dense weights stored [out, in], PyTorch's convention.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^'\]]*)'\]")


def parse_key(key: str) -> tuple:
    """"['state']['dense_0']['w']" -> ('state', 'dense_0', 'w')."""
    parts = _KEY_PART.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a tree path key: {key!r}")
    return tuple(parts)


def nest(flat: dict) -> dict:
    """Nested dicts from a {tree path key: array} mapping."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *head, leaf = parse_key(key)
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return out


def load_npz(path: str) -> dict:
    """Nested numpy dicts from a gnn_tpu tree_to_npz file."""
    with np.load(path) as data:
        return nest({k: data[k] for k in data.files})


def params_from_jax(params_np: dict, bn_np: dict, device="cpu"):
    """(params, bn) of tensors from gnn_tpu's (params, bn) pytrees given as
    nested dicts of arrays (or flat tree path keys); dense weights are
    transposed to [out, in]."""
    if any(isinstance(k, str) and k.startswith("[") for k in params_np):
        params_np = nest(params_np)
    if any(isinstance(k, str) and k.startswith("[") for k in bn_np):
        bn_np = nest(bn_np)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    params = {}
    for net in ("state", "output"):
        layers = {}
        for name, leaves in params_np.get(net, {}).items():
            if name.startswith("dense_"):
                layers[name] = {"w": t(np.asarray(leaves["w"]).T), "b": t(leaves["b"])}
            else:
                layers[name] = {k: t(v) for k, v in leaves.items()}
        params[net] = layers
    bn = {net: {k: t(v) for k, v in bn_np.get(net, {}).items()} for net in ("state", "output")}
    return params, bn
