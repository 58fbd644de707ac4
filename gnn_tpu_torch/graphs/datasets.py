"""Dataset generators (counterpart of gnn_tpu/graphs/datasets.py).

* random_graph — synthetic undirected graphs with mirrored arc labels and
  clustering-derived pseudo-targets (reference GNN_utils.randomGraph).
* simple_graph — the 4-node/8-arc deterministic debug fixture.
* load_mutag — the TU-format Mutagenicity parser (reference load_MUTAG.py).
* mutag_shaped — a synthetic set with the shapes of Mutagenicity (4337
  molecule graphs, 131,488 nodes, 266,894 directed arcs, one-hot labels of
  width 14/3/2), built from a seed: the real files are not shipped.
"""

from __future__ import annotations

import heapq
import os
from typing import List, Optional

import numpy as np

from gnn_tpu_torch.graphs.graph import Graph


def ward_labels(feats, n_clusters: int) -> np.ndarray:
    """Cluster labels of scikit-learn's AgglomerativeClustering(n_clusters)
    at its defaults (Ward linkage, the full tree), from scipy's Ward tree:
    sklearn's _hc_cut pops the latest merges off a heap until n_clusters
    nodes remain and numbers each node's leaves in heap order."""
    from scipy.cluster import hierarchy
    x = np.asarray(feats, dtype=np.float64)
    n = len(x)
    if n_clusters > n:
        raise ValueError(f"Cannot extract more clusters than samples: {n_clusters} clusters "
                         f"were given for a tree with {n} leaves.")
    children = hierarchy.ward(x)[:, :2].astype(np.intp)
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        a, b = children[-nodes[0] - n]
        heapq.heappush(nodes, -a)
        heapq.heappushpop(nodes, -b)
    labels = np.zeros(n, dtype=np.intp)
    for i, node in enumerate(nodes):
        stack, leaves = [-node], []
        while stack:
            j = stack.pop()
            if j < n:
                leaves.append(j)
            else:
                stack.extend(children[j - n])
        labels[leaves] = i
    return labels


def random_graph(nodes_number: int, dim_node_label: int, dim_arc_label: int,
                 dim_target: int, density: float, *, normalize_features: bool = False,
                 aggregation_mode: str = "average", focus: str = "n",
                 problem_based: Optional[str] = None, rng=None) -> Graph:
    """Random undirected graph: each sampled arc (i, j) is mirrored as (j, i)
    with the same label; targets come from Ward clustering of labels
    ('n'/'a' focus, `ward_labels`) or a random one-hot ('g'). Draws the same
    numbers and targets as gnn_tpu's random_graph for the same rng."""
    if problem_based is not None:
        focus = problem_based
    rng = np.random.default_rng(rng)
    nodes = 2 * rng.random((nodes_number, dim_node_label)) - 1

    arcs_number = round(density * nodes_number * (nodes_number - 1) / 2)
    sources = rng.choice(np.arange(nodes_number - 1), max(arcs_number // 2, 1))
    max_diff = nodes_number - sources - 1
    destination = sources + np.ceil(max_diff * rng.random(len(sources)))

    arcs_ascend = np.unique(np.stack([sources, destination], axis=1), axis=0)
    arcs_ids = np.concatenate((arcs_ascend, np.flip(arcs_ascend, axis=1)))
    arcs_label = 2 * rng.random((arcs_ascend.shape[0], dim_arc_label)) - 1
    arcs_label = np.concatenate((arcs_label, arcs_label))
    arcs = np.unique(np.concatenate((arcs_ids, arcs_label), axis=1), axis=0)

    if focus not in ("n", "a", "g"):
        raise ValueError("focus must be 'n', 'a' or 'g'")
    target_number = {"n": nodes.shape[0], "a": arcs.shape[0], "g": 1}[focus]
    targs = np.zeros((target_number, dim_target))
    if focus in ("a", "n"):
        feats = arcs[:, 2:] if focus == "a" else nodes
        targs[np.arange(target_number), ward_labels(feats, dim_target)] = 1
    else:
        targs[0, rng.integers(0, dim_target)] = 1

    if normalize_features:
        nodes = nodes / np.max(nodes, axis=0)
        arcs[:, 2:] = arcs[:, 2:] / np.max(arcs[:, 2:], axis=0)
    return Graph(arcs=arcs, nodes=nodes, targets=targs, focus=focus,
                 aggregation_mode=aggregation_mode)


def simple_graph(focus: str = "n", aggregation_mode: str = "average") -> Graph:
    """Deterministic 4-node debug fixture (reference GNN_utils.py:88-105)."""
    nodes = np.array([[11, 21], [12, 22], [13, 23], [14, 24]], dtype=float)
    arcs = np.array([[0, 1, 10], [0, 2, 40], [1, 0, 10], [1, 2, 20],
                     [2, 0, 40], [2, 1, 20], [2, 3, 30], [3, 2, 30]], dtype=float)
    tn = {"n": nodes.shape[0], "a": arcs.shape[0], "g": 1}[focus]
    targs = np.zeros((tn, 2))
    if focus in ("a", "n"):
        feats = arcs[:, 2:] if focus == "a" else nodes
        targs[np.arange(tn), ward_labels(feats, 2)] = 1
    else:
        targs[0, 1] = 1
    return Graph(arcs=arcs, nodes=nodes, targets=targs, focus=focus,
                 aggregation_mode=aggregation_mode)


def load_mutag(path: str = "MUTAG_raw/", aggregation_mode: str = "average") -> List[Graph]:
    """Parse TU-format Mutagenicity files (Mutagenicity_edges.txt,
    _edge_labels, _node_labels, _graph_indicator, _graph_labels) into
    graph-focused Graphs, as gnn_tpu's load_mutag: integer labels one-hot,
    duplicate arcs dropped, node ids renumbered from 0 per graph."""
    j = os.path.join
    edges_ids = np.loadtxt(j(path, "Mutagenicity_edges.txt"), dtype=int, delimiter=",")
    edges_l = np.loadtxt(j(path, "Mutagenicity_edge_labels.txt"), dtype=int)
    nodes_l = np.loadtxt(j(path, "Mutagenicity_node_labels.txt"), dtype=int)
    gids_nodes = np.loadtxt(j(path, "Mutagenicity_graph_indicator.txt"), dtype=int)
    gtargs = np.loadtxt(j(path, "Mutagenicity_graph_labels.txt"), dtype=int)

    def onehot(labels):
        out = np.zeros((len(labels), len(np.unique(labels))), dtype=np.float32)
        out[np.arange(len(labels)), labels] = 1
        return out

    # node ids are 1-based and contiguous per graph
    node_onehot = onehot(nodes_l)
    _, starts = np.unique(gids_nodes, return_index=True)
    bounds = np.concatenate([starts, [len(gids_nodes)]])
    # the first of each run of equal (src, dst) pairs, in sorted order
    order = np.lexsort((edges_ids[:, 1], edges_ids[:, 0]))
    se = edges_ids[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = np.any(se[1:] != se[:-1], axis=1)
    keep = order[first]
    e_ids = edges_ids[keep]
    e_onehot = np.zeros((len(keep), len(np.unique(edges_l))), dtype=np.float32)
    e_onehot[np.arange(len(keep)), edges_l[keep]] = 1
    e_graph = gids_nodes[e_ids[:, 0] - 1]
    targ_onehot = onehot(gtargs)

    graph_ids = np.unique(gids_nodes)
    e_sorted = np.argsort(e_graph, kind="stable")
    e_ptr = np.concatenate([np.searchsorted(e_graph[e_sorted], graph_ids, side="left"),
                            [len(e_graph)]])
    graphs = []
    for gi in range(len(graph_ids)):
        lo, hi = bounds[gi], bounds[gi + 1]
        rows = e_sorted[e_ptr[gi]: e_ptr[gi + 1]]
        ids = e_ids[rows] - 1 - lo
        arcs = np.concatenate([ids.astype(np.float32), e_onehot[rows]], axis=1)
        graphs.append(Graph(arcs=arcs, nodes=node_onehot[lo:hi],
                            targets=targ_onehot[gi][None, :], focus="g",
                            aggregation_mode=aggregation_mode))
    return graphs


# Mutagenicity's atom-type frequencies are heavily skewed (carbon dominates);
# a geometric-like profile over the 14 node types keeps that character.
_NODE_TYPE_P = np.array([0.45, 0.2, 0.12, 0.07, 0.05, 0.03, 0.02, 0.015, 0.012,
                         0.01, 0.008, 0.006, 0.005, 0.004])
_NODE_TYPE_P = _NODE_TYPE_P / _NODE_TYPE_P.sum()
_MUTAG_DIMS = (14, 3, 2)      # node label, arc label and target widths
_MUTAG_BIG_SHARE = 0.01       # share of graphs drawn at 129-417 nodes


def _molecule(rng, n: int) -> Graph:
    """One molecule-like graph: a random tree whose parent links reach at most
    4 nodes back (chains with branches) plus ~2% ring closures, every bond
    mirrored in both directions with one shared one-hot bond label."""
    nl, al, dt = _MUTAG_DIMS
    child = np.arange(1, n)
    parent = rng.integers(np.maximum(child - 4, 0), child)
    n_ring = int(round(0.02 * n)) + 1
    a = rng.integers(0, n, n_ring)
    b = rng.integers(0, n, n_ring)
    keep = a != b
    und = np.concatenate([np.stack([parent, child], 1),
                          np.stack([np.minimum(a, b), np.maximum(a, b)], 1)[keep]])
    und = np.unique(np.sort(und, axis=1), axis=0)
    lab = np.zeros((len(und), al))
    lab[np.arange(len(und)), rng.integers(0, al, len(und))] = 1
    ids = np.concatenate([und, und[:, ::-1]])
    arcs = np.concatenate([ids, np.concatenate([lab, lab])], axis=1)
    nodes = np.zeros((n, nl))
    nodes[np.arange(n), rng.choice(nl, n, p=_NODE_TYPE_P)] = 1
    targs = np.zeros((1, dt))
    targs[0, rng.integers(0, dt)] = 1
    return Graph(arcs=arcs, nodes=nodes, targets=targs, focus="g",
                 aggregation_mode="average")


def mutag_shaped(seed: int = 0, n_graphs: int = 4337) -> List[Graph]:
    """Synthetic graph-classification set shaped like Mutagenicity.

    Most graphs have 10-46 nodes (mean 28); 1% of them (at least one) have
    129-417 nodes, so a 128-node block packing has graphs that span
    several blocks, i.e. residual arcs and residual-coupled blocks. At the
    default size the set has about 131k nodes and about 2.04 directed arcs per
    node, like the 131,488 nodes and 266,894 arcs of the real set."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(10, 47, n_graphs)
    n_big = max(1, int(round(_MUTAG_BIG_SHARE * n_graphs))) if n_graphs else 0
    big = rng.choice(n_graphs, n_big, replace=False)
    sizes[big] = rng.integers(129, 418, n_big)
    return [_molecule(rng, int(n)) for n in sizes]
