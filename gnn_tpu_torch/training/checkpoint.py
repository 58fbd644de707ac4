"""Training-state checkpoints in gnn_tpu's folder format (counterpart of
gnn_tpu/training/checkpoint.py): params.npz, bn.npz and opt_state.npz keyed
by jax.tree_util.keystr paths, and manifest.json with the history. Each
package reads the other's folders.

The port's dropout masks come from a torch.Generator, whose state goes
under the manifest key "torch_mask_generator" ({"device": "cpu" | "cuda",
"state": [bytes]}). gnn_tpu's "rng_key_data" is a JAX PRNG key, which torch
cannot replay: `load_checkpoint` ignores it, and gnn_tpu ignores the port's
key.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from gnn_tpu_torch.convert import flatten, load_npz


def save_checkpoint(path: str, *, params: dict, bn: dict, opt_state: dict,
                    history: Optional[dict] = None, mask_gen=None,
                    extra: Optional[dict] = None) -> None:
    """Write a resumable checkpoint folder.

    :param params / bn: gnn_tpu's pytrees as nested numpy dicts
        (convert.params_to_jax).
    :param opt_state: the optimizer state flattened under optax's names
        (convert.opt_state_to_jax).
    :param mask_gen: the torch.Generator drawing the dropout masks.
    """
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **flatten(params))
    np.savez(os.path.join(path, "bn.npz"), **flatten(bn))
    np.savez(os.path.join(path, "opt_state.npz"), **opt_state)
    manifest = {"history": history or {}, "extra": extra or {}}
    if mask_gen is not None:
        manifest["torch_mask_generator"] = {"device": mask_gen.device.type,
                                            "state": mask_gen.get_state().tolist()}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str):
    """(params, bn, opt_state, history, mask generator state or None, extra)
    of a checkpoint folder, the first two as nested numpy dicts, opt_state
    as {optax name: array}."""
    with np.load(os.path.join(path, "opt_state.npz")) as data:
        opt_state = {k: data[k] for k in data.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return (load_npz(os.path.join(path, "params.npz")), load_npz(os.path.join(path, "bn.npz")),
            opt_state, manifest.get("history", {}), manifest.get("torch_mask_generator"),
            manifest.get("extra", {}))
