"""Weights carried across from gnn_tpu.

gnn_tpu keeps parameters as pytrees of nested dicts ({"state": {"dense_0":
{"w": [in, out], "b": [out]}, "bn": {"gamma", "beta"}}, "output": {...}}) and
BatchNorm statistics as {"state": {"mean", "var"}, "output": {...}}. Its save
folder flattens them into .npz files keyed by tree paths such as
"['state']['dense_0']['w']" (models/engine.py::tree_to_npz). A composite
model's per-type state nets are a tuple, whose entries are keyed by index:
"['state'][0]['dense_0']['w']"; an LGNN's checkpoint holds a tuple of its
layers' trees: "[0]['state']['dense_0']['w']". The port keeps the same nesting with dense
weights stored [out, in], PyTorch's convention. `params_to_jax` and
`flatten` go the other way, for saves gnn_tpu can load.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^'\]]*)'\]|\[(\d+)\]")


def _part(p) -> str:
    return f"[{p}]" if isinstance(p, int) else f"['{p}']"


def parse_key(key: str) -> tuple:
    """"['state'][0]['dense_0']['w']" -> ('state', 0, 'dense_0', 'w'):
    dict keys as strings, sequence indices as ints."""
    parts = tuple(name if idx == "" else int(idx) for name, idx in _KEY_PART.findall(key))
    if not parts or "".join(_part(p) for p in parts) != key:
        raise ValueError(f"not a tree path key: {key!r}")
    return parts


def _sequences(node):
    """Nodes keyed 0..n-1 by index become tuples (gnn_tpu's per-type trees)."""
    if not isinstance(node, dict):
        return node
    node = {k: _sequences(v) for k, v in node.items()}
    keys = list(node)
    if keys and all(isinstance(k, int) for k in keys):
        if sorted(keys) != list(range(len(keys))):
            raise ValueError(f"sequence indices {sorted(keys)} are not 0..{len(keys) - 1}")
        return tuple(node[i] for i in range(len(keys)))
    return node


def nest(flat: dict) -> dict:
    """Nested dicts (and tuples, for index parts) from a {tree path key:
    array} mapping."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *head, leaf = parse_key(key)
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return _sequences(out)


def load_npz(path: str) -> dict:
    """Nested numpy dicts from a gnn_tpu tree_to_npz file."""
    with np.load(path) as data:
        return nest({k: data[k] for k in data.files})


def params_from_jax(params_np: dict, bn_np: dict, device="cpu"):
    """(params, bn) of tensors from gnn_tpu's (params, bn) pytrees given as
    nested dicts of arrays (or flat tree path keys); dense weights are
    transposed to [out, in]. Tuples of such trees (an LGNN's layers) give
    tuples."""
    if any(isinstance(k, str) and k.startswith("[") for k in params_np):
        params_np = nest(params_np)
    if any(isinstance(k, str) and k.startswith("[") for k in bn_np):
        bn_np = nest(bn_np)
    if isinstance(params_np, (list, tuple)):
        bns = bn_np if isinstance(bn_np, (list, tuple)) else [{}] * len(params_np)
        return _unzip(params_from_jax(p, b, device) for p, b in zip(params_np, bns))

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    def layers(tree):
        return {name: ({"w": t(np.asarray(leaves["w"]).T), "b": t(leaves["b"])}
                       if name.startswith("dense_") else {k: t(v) for k, v in leaves.items()})
                for name, leaves in tree.items()}

    def stats(tree):
        return {k: t(v) for k, v in tree.items()}

    params, bn = {}, {}
    for net in ("state", "output"):
        p, b = params_np.get(net, {}), bn_np.get(net, {})
        per_type = isinstance(p, (list, tuple))
        params[net] = tuple(map(layers, p)) if per_type else layers(p)
        # BatchNorm-free per-type nets save no statistics: () per type
        bn[net] = tuple(stats(x) for x in (b or [{}] * len(p))) if per_type else stats(b)
    return params, bn


def params_to_jax(params: dict, bn: dict):
    """gnn_tpu's (params, bn) pytrees as nested dicts of numpy arrays from the
    port's tensors: the inverse of params_from_jax (dense weights back to
    [in, out]); tuples of trees (an LGNN's layers) give tuples."""
    if isinstance(params, (list, tuple)):
        return _unzip(params_to_jax(p, b) for p, b in zip(params, bn))
    def a(t):
        return t.detach().cpu().numpy().astype(np.float32)

    def layers(tree):
        return {name: ({"w": a(leaves["w"]).T.copy(), "b": a(leaves["b"])}
                       if name.startswith("dense_") else {k: a(v) for k, v in leaves.items()})
                for name, leaves in tree.items()}

    def stats(tree):
        return {k: a(v) for k, v in tree.items()}

    def per_net(fn, tree):
        return tuple(map(fn, tree)) if isinstance(tree, (list, tuple)) else fn(tree)

    return ({net: per_net(layers, p) for net, p in params.items()},
            {net: per_net(stats, b) for net, b in bn.items()})


def _unzip(pairs):
    params, bn = zip(*pairs)
    return tuple(params), tuple(bn)


def flatten(tree, prefix: str = "") -> dict:
    """{tree path key: leaf} of nested dicts and tuples, keyed as gnn_tpu's
    tree_to_npz keys them ("['state']['dense_0']['w']", "['state'][0]...")."""
    flat = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = prefix + _part(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


# ------------------------------------------------------------- optimizer state
def _opt_layout(opt) -> tuple:
    """([(state key, optax tree prefix, initial value)], [count keys]) of an
    OptaxRule: where optax 0.2.6's chain for the optimizer keeps each moment
    and its step counts (gnn_tpu's make_optimizer), e.g. Adam's mu at
    "[0].mu" and, with a schedule, scale_by_schedule's count at "[1].count"."""
    h, name = opt.param_groups[0], opt.name
    if name in ("adam", "adamw", "lamb", "lion"):
        slots = [("mu", "[0].mu", 0.0)] + ([] if name == "lion" else [("nu", "[0].nu", 0.0)])
        counts = ["[0].count"]
        lr_at = {"adam": 1, "adamw": 2, "lamb": 3, "lion": 2}[name]
    elif name == "sgd":
        slots = [] if h["momentum"] is None else [("trace", "[0].trace", 0.0)]
        counts, lr_at = [], 1
    elif name == "rmsprop":
        slots = (([("mu", "[0].mu", 0.0)] if h["centered"] else [])
                 + [("nu", "[0].nu", h["initial_scale"])]
                 + ([("trace", "[2].trace", 0.0)] if h["momentum"] is not None else []))
        counts, lr_at = (["[0].count"] if h["bias_correction"] else []), 1
    elif name == "adagrad":
        slots = [("sum", "[0].sum_of_squares", h["initial_accumulator_value"])]
        counts, lr_at = [], 1
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if callable(h["lr"]):
        counts.append(f"[{lr_at}].count")
    return slots, counts


def _leaves(params):
    """(tree path key, tensor, whether stored transposed) of each parameter."""
    for key, t in flatten(params).items():
        parts = parse_key(key)
        yield key, t, parts[-1] == "w" and str(parts[-2]).startswith("dense_")


def opt_state_to_jax(opt, params) -> dict:
    """The state of `opt` (an OptaxRule over the leaves of `params`) as
    gnn_tpu's optax state flattened under jax.tree_util.keystr names, e.g.
    "[0].count" and "[0].mu['state']['dense_0']['w']" (dense moments
    [in, out], as params_to_jax stores weights), or for an LGNN's tuple of
    layers "[0].mu[1]['state']['dense_0']['w']". Moments not yet created
    (before the first step) are their initial values."""
    slots, counts = _opt_layout(opt)
    flat = {c: np.asarray(opt.param_groups[0]["count"], dtype=np.int32) for c in counts}
    for key, p, transposed in _leaves(params):
        st = opt.state.get(p, {})
        for name, prefix, init in slots:
            v = (st[name].detach().cpu().numpy().astype(np.float32) if name in st
                 else np.full(tuple(p.shape), init, dtype=np.float32))
            flat[prefix + key] = v.T.copy() if transposed else v
    return flat


def opt_state_from_jax(opt, params, flat) -> None:
    """Install gnn_tpu's flattened optax state (opt_state_to_jax's layout) into
    `opt`, an OptaxRule over the leaves of `params`; the update count is the
    state's count (0 where the chain keeps none)."""
    slots, counts = _opt_layout(opt)
    for key, p, transposed in _leaves(params):
        st = opt.state[p]
        for name, prefix, _ in slots:
            v = np.asarray(flat[prefix + key], dtype=np.float32)
            st[name] = torch.as_tensor(v.T.copy() if transposed else v, device=p.device)
    opt.param_groups[0]["count"] = int(flat[counts[0]]) if counts else 0
