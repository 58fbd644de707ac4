"""Global configuration: default float dtype, padding buckets and device
resolution (counterpart of gnn_tpu/config.py).

The port computes in float32 throughout; `floatx` is kept so host graph code
reads like its JAX counterpart. Padding buckets follow the same arithmetic so
both packages build identical batches from identical graphs.
"""

from __future__ import annotations

import numpy as np
import torch

_FLOATX = np.float32

# Padding buckets: sizes round up to a multiple of PAD_MULTIPLE, then to a
# power-of-two bucket (with a 3/4 midpoint) beyond PAD_POW2_FROM.
PAD_MULTIPLE = 128
PAD_POW2_FROM = 1024


def floatx():
    """Default floating dtype of host arrays (numpy dtype object)."""
    return _FLOATX


def pad_size(n: int, multiple: int = PAD_MULTIPLE, pow2_from: int = PAD_POW2_FROM) -> int:
    """Bucketed padded size >= max(n, 1)."""
    n = max(int(n), 1)
    m = -(-n // multiple) * multiple
    if m <= pow2_from:
        return m
    p = pow2_from
    while p < m:
        p *= 2
    half = p // 2 + p // 4
    if m <= half:
        return half
    return p


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU. Raises when a CUDA device is requested (or defaulted to) and none
    is present, so a missing card never silently becomes a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
