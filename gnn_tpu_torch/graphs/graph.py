"""Host-side graph container, numpy only (counterpart of gnn_tpu/graphs/graph.py).

A graph is an arc list [src, dst, arc label...], a node label matrix and
targets. Aggregation weights per arc follow the reference's three modes:
'sum' (w = 1), 'normalized' (w = 1/E) and 'average' (w = 1/indeg(dst)).
`merge` is the disjoint-union batching of the reference (node ids offset per
graph, block-diagonal NodeGraph pooling matrix). `save`/`load` (.npy) and
`savetxt`/`load_txt` (.txt) folders are gnn_tpu's: the same files, written
only when not at their default, so a folder moves between the packages.
"""

from __future__ import annotations

import os
import shutil
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
    :param node_types: optional (N,) int node types of a composite model
        (one state net per type).
    :param problem_based / NodeGraph / ArcNode: the reference's names for
        focus and node_graph; ArcNode is derived from the arcs, never kept.
    """

    def __init__(self, arcs, nodes, targets, focus: str = "n",
                 set_mask=None, output_mask=None, sample_weights=1,
                 node_graph=None, aggregation_mode: str = "average", node_types=None,
                 problem_based: Optional[str] = None, NodeGraph=None, ArcNode=None):
        if problem_based is not None:
            focus = problem_based
        if NodeGraph is not None and node_graph is None:
            node_graph = NodeGraph
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

        self.node_types = None
        if node_types is not None:
            self.node_types = np.asarray(node_types, dtype=np.int32).reshape(-1)
            if len(self.node_types) != self.nodes.shape[0]:
                raise ValueError("len(node_types) != number of nodes")

    @property
    def problem_based(self) -> str:
        """The reference's name of focus."""
        return self.focus

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_arcs(self) -> int:
        return self.arcs.shape[0]

    @property
    def n_graphs(self) -> int:
        return 1 if self.NodeGraph is None else self.NodeGraph.shape[1]

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

    def set_aggregation(self, aggregation_mode: str) -> None:
        """Switch the aggregation mode (reference setAggregation)."""
        if aggregation_mode not in AGGREGATIONS:
            raise ValueError("ERROR: Unknown aggregation mode")
        self.aggregation_mode = aggregation_mode

    setAggregation = set_aggregation

    def getAdjacency(self):
        """N x N scipy COO adjacency, ADJ[src, dst] = w_e (duplicate arcs
        accumulate)."""
        from scipy.sparse import coo_matrix
        n = self.n_nodes
        return coo_matrix((self.edge_weights(), (self.src, self.dst)), shape=(n, n),
                          dtype=floatx())

    def getArcNode(self):
        """E x N scipy COO incidence, A[e, dst_e] = w_e."""
        from scipy.sparse import coo_matrix
        e = self.n_arcs
        return coo_matrix((self.edge_weights(), (np.arange(e), self.dst)),
                          shape=(e, self.n_nodes), dtype=floatx())

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

    def copy(self) -> "Graph":
        """Deep copy."""
        return Graph(arcs=self.arcs.copy(), nodes=self.nodes.copy(), targets=self.targets.copy(),
                     focus=self.focus, set_mask=self.set_mask.copy(),
                     output_mask=self.output_mask.copy(),
                     sample_weights=self.sample_weights.copy(),
                     node_graph=None if self.NodeGraph is None else self.NodeGraph.copy(),
                     aggregation_mode=self.aggregation_mode,
                     node_types=None if self.node_types is None else self.node_types.copy())

    @classmethod
    def fromGraphTensor(cls, gb, aggregation_mode: Optional[str] = None) -> "Graph":
        """The host Graph of a GraphBatch (GraphBatch.to_graph)."""
        return gb.to_graph(aggregation_mode=aggregation_mode)

    @classmethod
    def merge(cls, glist: Sequence["Graph"], focus: Optional[str] = None,
              aggregation_mode: Optional[str] = None,
              problem_based: Optional[str] = None) -> "Graph":
        """Disjoint-union batching: node ids offset per graph, masks/targets/
        weights and node types (0 for a graph without them) concatenated,
        NodeGraph block-diagonal."""
        if not glist:
            raise ValueError("merge requires a non-empty list of graphs")
        focus = focus or problem_based or glist[0].focus
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
        node_types = None
        if any(g.node_types is not None for g in glist):
            node_types = np.concatenate([g.node_types if g.node_types is not None
                                         else np.zeros(g.n_nodes, np.int32) for g in glist])
        return cls(arcs=np.concatenate(arcs_list, axis=0),
                   nodes=np.concatenate([g.nodes for g in glist], axis=0),
                   targets=np.concatenate([g.targets for g in glist], axis=0),
                   focus=focus,
                   set_mask=np.concatenate([g.set_mask for g in glist], axis=0),
                   output_mask=np.concatenate([g.output_mask for g in glist], axis=0),
                   sample_weights=np.concatenate([g.sample_weights for g in glist], axis=0),
                   node_graph=node_graph, aggregation_mode=aggregation_mode,
                   node_types=node_types)

    # ------------------------------------------------------------------- I/O
    def _folder_files(self):
        """(name, array, fmt) of the files a save writes: the optional ones
        only when not at their default."""
        files = [("arcs", self.arcs, None), ("nodes", self.nodes, None),
                 ("targets", self.targets, None)]
        if not all(self.set_mask):
            files.append(("set_mask", self.set_mask, None))
        if not all(self.output_mask):
            files.append(("output_mask", self.output_mask, None))
        if np.any(self.sample_weights != 1):
            files.append(("sample_weights", self.sample_weights, None))
        if self.NodeGraph is not None and self.targets.shape[0] > 1:
            files.append(("NodeGraph", self.NodeGraph, None))
        if self.node_types is not None:
            files.append(("node_types", self.node_types, "%d"))
        return files

    @staticmethod
    def _new_folder(folder: str) -> str:
        folder = folder if folder.endswith("/") else folder + "/"
        if os.path.exists(folder):
            shutil.rmtree(folder)
        os.makedirs(folder)
        return folder

    def save(self, folder: str) -> None:
        """Save as a .npy folder (replacing it)."""
        folder = self._new_folder(folder)
        for name, arr, _ in self._folder_files():
            np.save(folder + name + ".npy", arr)

    def savetxt(self, folder: str, fmt: str = "%.10g") -> None:
        """Save as a .txt folder (replacing it)."""
        folder = self._new_folder(folder)
        for name, arr, own in self._folder_files():
            np.savetxt(folder + name + ".txt", arr, fmt=own or fmt)

    @classmethod
    def load(cls, folder: str, focus: Optional[str] = None, aggregation_mode: str = "average",
             problem_based: Optional[str] = None) -> "Graph":
        """Load a .npy graph folder."""
        folder = folder if folder.endswith("/") else folder + "/"
        params = {f.rsplit(".", 1)[0]: np.load(folder + f) for f in os.listdir(folder)
                  if f.endswith(".npy")}
        return cls(focus=focus or problem_based or "n", aggregation_mode=aggregation_mode,
                   **params)

    @classmethod
    def load_txt(cls, folder: str, focus: Optional[str] = None,
                 aggregation_mode: str = "average",
                 problem_based: Optional[str] = None) -> "Graph":
        """Load a .txt graph folder."""
        folder = folder if folder.endswith("/") else folder + "/"
        params = {f.rsplit(".", 1)[0]: np.loadtxt(folder + f, ndmin=2) for f in os.listdir(folder)
                  if f.endswith(".txt")}
        for key in ("set_mask", "output_mask", "sample_weights", "node_types"):
            if key in params:
                params[key] = params[key].reshape(-1)
        return cls(focus=focus or problem_based or "n", aggregation_mode=aggregation_mode,
                   **params)

    # ---------------------------------------------------------- reference getters
    def getArcs(self):
        return self.arcs.copy()

    def getNodes(self):
        return self.nodes.copy()

    def getTargets(self):
        return self.targets.copy()

    def getSetMask(self):
        return self.set_mask.copy()

    def getOutputMask(self):
        return self.output_mask.copy()

    def getSampleWeights(self):
        return self.sample_weights.copy()

    def getNodeGraph(self):
        return None if self.NodeGraph is None else self.NodeGraph.copy()

    def __repr__(self) -> str:
        return (f"Graph(N={self.n_nodes}, E={self.n_arcs}, "
                f"focus={self.focus!r}, agg={self.aggregation_mode!r}, "
                f"NL={self.DIM_NODE_LABEL}, AL={self.DIM_ARC_LABEL}, DT={self.DIM_TARGET})")


GraphObject = Graph   # the reference's class name


def split_graphs(g: Graph) -> list:
    """The graphs a graph-focus Graph merges (Graph.merge), each with its
    nodes, arcs (ids from 0), masks, node types, target row, sample weight
    and pooling column; [g] when g is not graph-focused or holds one graph."""
    if g.focus != "g" or g.n_graphs <= 1:
        return [g]
    G, gid = g.n_graphs, g.graph_ids()
    if len(gid) and gid.max() >= G:
        raise ValueError("NodeGraph has rows outside its columns")
    egid = gid[g.src]
    if np.any(egid != gid[g.dst]):
        raise ValueError("an arc joins two graphs of a merged graph")
    norder = np.argsort(gid, kind="stable")
    ncount = np.bincount(gid, minlength=G)
    nstart = np.concatenate([[0], np.cumsum(ncount)])
    local = np.empty(g.n_nodes, dtype=np.int64)
    local[norder] = np.arange(g.n_nodes) - np.repeat(nstart[:-1], ncount)
    eorder = np.argsort(egid, kind="stable")
    estart = np.concatenate([[0], np.cumsum(np.bincount(egid, minlength=G))])
    pool = g.pool_weights()
    out = []
    for k in range(G):
        nodes = norder[nstart[k]:nstart[k + 1]]
        arcs = g.arcs[eorder[estart[k]:estart[k + 1]]].copy()
        arcs[:, :2] = local[arcs[:, :2].astype(np.int64)]
        out.append(Graph(arcs=arcs, nodes=g.nodes[nodes], targets=g.targets[k:k + 1],
                         focus="g", set_mask=g.set_mask[nodes], output_mask=g.output_mask[nodes],
                         sample_weights=g.sample_weights[k:k + 1],
                         node_graph=pool[nodes][:, None], aggregation_mode=g.aggregation_mode,
                         node_types=None if g.node_types is None else g.node_types[nodes]))
    return out
