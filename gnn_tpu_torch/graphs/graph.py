"""Host-side graph container, numpy only (counterpart of gnn_tpu/graphs/graph.py).

A graph is an arc list [src, dst, arc label...], a node label matrix and
targets. Aggregation weights per arc follow the reference's three modes:
'sum' (w = 1), 'normalized' (w = 1/E) and 'average' (w = 1/indeg(dst)).
`merge` is the disjoint-union batching of the reference (node ids offset per
graph, block-diagonal NodeGraph pooling matrix).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gnn_tpu_torch.config import floatx

AGGREGATIONS = ("average", "normalized", "sum")


class Graph:
    """A single (possibly merged) directed labelled graph.

    :param arcs: (E, 2+AL) matrix, arcs[i] = [src id, dst id, arc label...].
    :param nodes: (N, NL) node label matrix.
    :param targets: (T, DT) target matrix (T = N', E' or G by focus).
    :param focus: 'n' node-based | 'a' arc-based | 'g' graph-based.
    :param set_mask / output_mask: bool (N,) or (E,); default all True.
    :param sample_weights: scalar or (T,) per-target loss weights.
    :param node_graph: optional (N, G) pooling matrix (reference NodeGraph).
    :param aggregation_mode: 'average' | 'normalized' | 'sum'.
    """

    def __init__(self, arcs, nodes, targets, focus: str = "n",
                 set_mask=None, output_mask=None, sample_weights=1,
                 node_graph=None, aggregation_mode: str = "average"):
        if focus not in ("n", "a", "g"):
            raise ValueError("focus must be 'n', 'a' or 'g'")
        if aggregation_mode not in AGGREGATIONS:
            raise ValueError("ERROR: Unknown aggregation mode")
        dt = floatx()
        arcs = np.asarray(arcs)
        if arcs.ndim != 2 or arcs.shape[1] < 2:
            raise ValueError("arcs must be (E, 2+AL)")
        self.arcs = arcs.astype(dt)
        self.nodes = np.asarray(nodes).astype(dt)
        self.targets = np.asarray(targets).astype(dt)
        self.sample_weights = (np.asarray(sample_weights, dtype=np.float64)
                               * np.ones(self.targets.shape[0])).astype(dt)
        self.DIM_NODE_LABEL = self.nodes.shape[1]
        self.DIM_ARC_LABEL = self.arcs.shape[1] - 2
        self.DIM_TARGET = self.targets.shape[1]
        self.focus = focus
        self.aggregation_mode = aggregation_mode

        n_mask = self.arcs.shape[0] if focus == "a" else self.nodes.shape[0]
        self.set_mask = (np.ones(n_mask, dtype=bool) if set_mask is None
                         else np.asarray(set_mask).astype(bool).reshape(-1))
        self.output_mask = (np.ones(len(self.set_mask), dtype=bool) if output_mask is None
                            else np.asarray(output_mask).astype(bool).reshape(-1))
        if len(self.set_mask) != len(self.output_mask):
            raise ValueError("Error - len(<set_mask>) != len(<output_mask>)")

        self.NodeGraph = None
        if node_graph is not None:
            self.NodeGraph = np.asarray(node_graph).astype(dt)
            if self.NodeGraph.ndim == 1:
                self.NodeGraph = self.NodeGraph[:, None]
        elif focus == "g":
            n = self.nodes.shape[0]
            self.NodeGraph = np.full((n, 1), 1.0 / max(n, 1), dtype=dt)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_arcs(self) -> int:
        return self.arcs.shape[0]

    # src/dst/edge_weights/graph_ids/pool_weights are cached per instance
    # (batch builders call them repeatedly); treat the arrays as read-only.
    def _cached(self, name, build):
        c = self.__dict__.get(name)
        if c is None:
            c = build()
            self.__dict__[name] = c
        return c

    @property
    def src(self) -> np.ndarray:
        return self._cached("_src", lambda: np.ascontiguousarray(self.arcs[:, 0], dtype=np.int32))

    @property
    def dst(self) -> np.ndarray:
        return self._cached("_dst", lambda: np.ascontiguousarray(self.arcs[:, 1], dtype=np.int32))

    @property
    def arc_labels(self) -> np.ndarray:
        return self.arcs[:, 2:]

    def edge_weights(self) -> np.ndarray:
        """Per-arc aggregation weights w_e: the aggregate of q_e into node n
        is sum over arcs e with dst_e == n of w_e * q_e."""
        cached = self.__dict__.get("_ew")
        if cached is not None and cached[0] == self.aggregation_mode:
            return cached[1]
        E = self.n_arcs
        w = np.ones(E, dtype=floatx())
        if self.aggregation_mode == "normalized":
            w *= np.float64(1.0 / E) if E else 0.0
        elif self.aggregation_mode == "average":
            # 1 / in-degree of the destination node (duplicate arcs all count)
            _, inv, counts = np.unique(self.dst, return_inverse=True, return_counts=True)
            w = w / counts[inv]
        w = w.astype(floatx())
        self.__dict__["_ew"] = (self.aggregation_mode, w)
        return w

    def graph_ids(self) -> np.ndarray:
        """Per-node graph membership (int32, all zeros when not graph-focused)."""
        def build():
            if self.NodeGraph is None:
                return np.zeros(self.n_nodes, dtype=np.int32)
            return np.argmax(self.NodeGraph != 0, axis=1).astype(np.int32)
        return self._cached("_gid", build)

    def pool_weights(self) -> np.ndarray:
        """Per-node pooling weight (NodeGraph nonzero per row: 1/n_g)."""
        def build():
            if self.NodeGraph is None:
                return np.zeros(self.n_nodes, dtype=floatx())
            return self.NodeGraph[np.arange(self.n_nodes), self.graph_ids()].astype(floatx())
        return self._cached("_pw", build)

    @classmethod
    def merge(cls, glist: Sequence["Graph"], focus: Optional[str] = None,
              aggregation_mode: Optional[str] = None) -> "Graph":
        """Disjoint-union batching: node ids offset per graph, masks/targets/
        weights concatenated, NodeGraph block-diagonal."""
        if not glist:
            raise ValueError("merge requires a non-empty list of graphs")
        focus = focus or glist[0].focus
        aggregation_mode = aggregation_mode or glist[0].aggregation_mode
        arcs_list, offset = [], 0
        for g in glist:
            a = g.arcs.copy()
            a[:, :2] += offset
            offset += g.n_nodes
            arcs_list.append(a)
        node_graph = None
        if focus == "g":
            blocks = [g.NodeGraph if g.NodeGraph is not None
                      else np.full((g.n_nodes, 1), 1.0 / max(g.n_nodes, 1), dtype=floatx())
                      for g in glist]
            node_graph = np.zeros((sum(b.shape[0] for b in blocks),
                                   sum(b.shape[1] for b in blocks)), dtype=floatx())
            r = c = 0
            for b in blocks:
                node_graph[r:r + b.shape[0], c:c + b.shape[1]] = b
                r += b.shape[0]
                c += b.shape[1]
        return cls(arcs=np.concatenate(arcs_list, axis=0),
                   nodes=np.concatenate([g.nodes for g in glist], axis=0),
                   targets=np.concatenate([g.targets for g in glist], axis=0),
                   focus=focus,
                   set_mask=np.concatenate([g.set_mask for g in glist], axis=0),
                   output_mask=np.concatenate([g.output_mask for g in glist], axis=0),
                   sample_weights=np.concatenate([g.sample_weights for g in glist], axis=0),
                   node_graph=node_graph, aggregation_mode=aggregation_mode)

    def __repr__(self) -> str:
        return (f"Graph(N={self.n_nodes}, E={self.n_arcs}, "
                f"focus={self.focus!r}, agg={self.aggregation_mode!r}, "
                f"NL={self.DIM_NODE_LABEL}, AL={self.DIM_ARC_LABEL}, DT={self.DIM_TARGET})")
