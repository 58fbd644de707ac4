"""Per-type node-label widths for composite (heterogeneous) GNNs, numpy only
(counterpart of gnn_tpu/graphs/typed.py).

The composite state propagates in one common label space (labels are the
state, models/composite.py), so per-type feature widths are embedded into a
fixed-width matrix when the dataset is built. Two layouts:

* 'block' (default): type t's features occupy their own column range
  [offset_t, offset_t + D_t); total width = sum of D_t. Types never share
  columns, so a type's state net sees zeros for foreign features.
* 'overlay': all types share columns [0, max(D_t)); total width = max D_t.
  Column j means different things per type (each type's net sees only its
  own rows).

Build the node matrix with pack_typed_labels, size the nets with
composite_get_inout_dims, and construct Graph(nodes=packed, node_types=types).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from gnn_tpu_torch.config import floatx

_LAYOUTS = ("block", "overlay")


def typed_label_offsets(type_label_dims: Sequence[int],
                        layout: str = "block") -> Tuple[Tuple[int, ...], int]:
    """(per-type column offsets, packed width) for a layout."""
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}")
    dims = [int(d) for d in type_label_dims]
    if not dims or any(d <= 0 for d in dims):
        raise ValueError("type_label_dims must be positive ints, one per type")
    if layout == "block":
        offs = np.concatenate([[0], np.cumsum(dims[:-1])]).astype(int)
        return tuple(offs.tolist()), int(sum(dims))
    return tuple([0] * len(dims)), int(max(dims))


def pack_typed_labels(node_types, features: Sequence, type_label_dims: Sequence[int],
                      layout: str = "block") -> np.ndarray:
    """Pack ragged per-node features into one dense [N, W] label matrix.

    :param node_types: [N] int type id per node.
    :param features: length-N sequence; features[i] is node i's label vector,
        whose length must equal type_label_dims[node_types[i]].
    :param type_label_dims: feature width per type.
    :param layout: 'block' | 'overlay' (see the module docstring).
    """
    types = np.asarray(node_types, dtype=np.int32)
    dims = [int(d) for d in type_label_dims]
    if types.size and types.max() >= len(dims):
        raise ValueError(f"node type {types.max()} has no entry in "
                         f"type_label_dims (len {len(dims)})")
    offs, W = typed_label_offsets(dims, layout)
    out = np.zeros((len(types), W), dtype=floatx())
    for t in range(len(dims)):
        rows = np.nonzero(types == t)[0]
        if not rows.size:
            continue
        block = np.stack([np.asarray(features[i], dtype=np.float64).ravel() for i in rows])
        if block.shape[1] != dims[t]:
            raise ValueError(f"type {t} features have width {block.shape[1]}, "
                             f"expected {dims[t]}")
        out[rows, offs[t]:offs[t] + dims[t]] = block
    return out


def composite_get_inout_dims(net_name: str, type_label_dims: Sequence[int], dim_arc_label: int,
                             dim_target: int, focus: str, hidden_units=None,
                             layout: str = "block"):
    """Widths of the composite nets over packed typed labels, the
    heterogeneous counterpart of get_inout_dims (state_dim = 0).

    Returns (input_shape, layers): every per-type state net consumes
    [state | sum of neighbour states | sum of incoming arc labels] over the
    packed width and emits the packed width; the shared output net follows
    the focus rule.
    """
    if focus not in ("a", "n", "g"):
        raise ValueError("focus must be 'a', 'n' or 'g'")
    _, W = typed_label_offsets(type_label_dims, layout)
    if net_name == "state":
        input_shape, output_shape = dim_arc_label + 2 * W, W
    elif net_name == "output":
        input_shape = (2 * W + dim_arc_label) if focus == "a" else W
        output_shape = dim_target
    else:
        raise ValueError("net_name must be 'state' or 'output'")
    if hidden_units is None or (isinstance(hidden_units, int) and hidden_units <= 0):
        hidden_units = []
    if not isinstance(hidden_units, list):
        hidden_units = [hidden_units]
    return input_shape, hidden_units + [output_shape]
