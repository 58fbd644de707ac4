"""Dataset utilities: splitting, batching, normalisation and Leave-K-Out
folds (counterpart of gnn_tpu/graphs/utils.py).

The same seeds give gnn_tpu's splits and folds: `getindices` shuffles with
np.random.default_rng(seed) and `prepare_LKO_data` draws from numpy's global
generator in gnn_tpu's order. `normalize_graphs` is scikit-learn's
MinMaxScaler in numpy (fit on the training graphs' node labels and arc
labels, the id columns untouched).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from gnn_tpu_torch.graphs.graph import Graph


def progressbar(percent: float, width: int = 30) -> None:
    """In-place textual progress indicator."""
    filled = round(width * percent / 100)
    print(f"\r[{('#' * filled).ljust(width)}] {percent:.1f}%", end="", flush=True)


def getindices(len_dataset: int, perc_Train: float = 0.7, perc_Valid: float = 0.1,
               seed=None) -> Tuple[list, list, list]:
    """Shuffled (train, test, validation) index split.

    :param seed: a number shuffles deterministically, None with fresh
        entropy, False keeps the dataset order. Test and validation sizes are
        rounded; train takes the rest.
    """
    if perc_Train < 0 or perc_Valid < 0 or perc_Train + perc_Valid > 1:
        raise ValueError("Error - percentage must stay in [0-1] and their sum must be <= 1")
    order = np.arange(len_dataset)
    if seed is not False:
        np.random.default_rng(seed).shuffle(order)
    n_test = round(len_dataset * (1 - perc_Train - perc_Valid))
    n_valid = round(len_dataset * perc_Valid)
    test_idx, valid_idx, train_idx = np.split(order, [n_test, n_test + n_valid])
    return train_idx.tolist(), test_idx.tolist(), valid_idx.tolist()


def getSet(glist: Sequence[str], set_indices: Sequence[int], focus: str,
           aggregation_mode: str, verbose: bool = False) -> List[Graph]:
    """Load the saved graph folders glist[i] for i in set_indices."""
    chosen = []
    for i, elem in enumerate(set_indices):
        chosen.append(glist[elem])
        if verbose:
            progressbar((i + 1) * 100 / len(set_indices))
    return [Graph.load(p, focus=focus, aggregation_mode=aggregation_mode) for p in chosen]


def getbatches(glist: List[Graph], focus: Optional[str] = None,
               aggregation_mode: Optional[str] = None, batch_size: int = 32,
               number_of_batches: Optional[int] = None, one_graph_per_batch: bool = True,
               problem_based: Optional[str] = None, block_w: Optional[int] = None):
    """Chunk a graph list into batches of batch_size graphs (or into
    number_of_batches near-equal ones); each chunk is merged into one graph
    when one_graph_per_batch. With block_w, each chunk becomes a host
    GraphBatch of graph-aligned blocks (graphs/batch.py::from_graphs_blocked)."""
    if focus is None:
        focus = problem_based if problem_based is not None else glist[0].focus
    if aggregation_mode is None:
        aggregation_mode = glist[0].aggregation_mode
    if number_of_batches is None:
        batches = [glist[i:i + batch_size] for i in range(0, len(glist), batch_size)]
    else:
        splits = np.array_split(np.arange(len(glist)), number_of_batches)
        batches = [[glist[j] for j in s] for s in splits]
    if block_w is not None:
        from gnn_tpu_torch.graphs.batch import from_graphs_blocked
        for b in batches:
            for g in b:
                g.aggregation_mode = aggregation_mode
        return [from_graphs_blocked(b, block_w=block_w, focus=focus,
                                    aggregation_mode=aggregation_mode) for b in batches]
    if one_graph_per_batch:
        batches = [Graph.merge(b, focus=focus, aggregation_mode=aggregation_mode)
                   for b in batches]
    return batches


def _float(x) -> np.ndarray:
    x = np.asarray(x)
    return x if x.dtype in (np.float32, np.float64) else x.astype(np.float64)


class _MinMax:
    """scikit-learn's MinMaxScaler(feature_range) fit on the rows of x, in
    x's float dtype: a column whose range is below 10 machine epsilons is
    scaled by 1 (shifted to the range's low end)."""

    def __init__(self, x, feature_range=(0, 1)):
        if feature_range[0] >= feature_range[1]:
            raise ValueError("Minimum of desired feature range must be smaller than maximum. "
                             f"Got {tuple(feature_range)}.")
        x = _float(x)
        lo, hi = (np.asarray(v, dtype=x.dtype) for v in feature_range)
        dmin, dmax = np.nanmin(x, axis=0), np.nanmax(x, axis=0)
        span = dmax - dmin
        span[span < 10 * np.finfo(span.dtype).eps] = 1.0
        self.scale = (hi - lo) / span
        self.min = lo - dmin * self.scale

    def transform(self, x):
        x = _float(x).copy()
        x *= self.scale
        x += self.min
        return x


def normalize_graphs(gTr, gVa, gTe, based_on: str = "gTr",
                     norm_rangeN: Optional[Tuple[float, float]] = None,
                     norm_rangeA: Optional[Tuple[float, float]] = None) -> None:
    """In-place MinMax scaling of node labels and arc labels (the id columns
    are left alone), fit on the training graphs (based_on='gTr') or on all
    of them ('all'). Normalise before batching."""

    def check(g, name):
        if g is None:
            return []
        if isinstance(g, Graph):
            return [g]
        if isinstance(g, list) and all(isinstance(x, Graph) for x in g):
            return g
        raise TypeError(f"type of param <{name}> must be Graph or list of Graphs")

    gTr, gVa, gTe = check(gTr, "gTr"), check(gVa, "gVa"), check(gTe, "gTe")
    if based_on not in ("gTr", "all"):
        raise ValueError("param <based_on> must be 'gTr' or 'all'")
    G = Graph.merge(gTr, focus="n", aggregation_mode="sum")
    if based_on == "all":
        G = Graph.merge([G] + gTe + gVa, focus="n", aggregation_mode="sum")
    node_scaler = _MinMax(G.nodes, norm_rangeN or (0, 1))
    arc_scaler = _MinMax(G.arcs[:, 2:], norm_rangeA or (0, 1)) if G.arcs.shape[1] > 2 else None
    for g in gTr + gVa + gTe:
        g.nodes = node_scaler.transform(g.nodes).astype(g.nodes.dtype)
        if arc_scaler is not None:
            g.arcs[:, 2:] = arc_scaler.transform(g.arcs[:, 2:]).astype(g.arcs.dtype)


def prepare_LKO_data(dataset, focus: Optional[str] = None, number_of_batches: int = 10,
                     useVa: bool = False, seed: Optional[float] = None,
                     normalize_method: str = "gTr", aggregation_mode: str = "average",
                     problem_based: Optional[str] = None):
    """Leave-K-Out folds: (gTRs, gTEs, gVAs), gTRs[i] the training graphs of
    fold i (for a single graph, the graph with the fold's training set mask),
    gTEs[i] its test graph, gVAs[i] its validation graph or None. Pass the
    tuple to model.LKO(). A seed seeds numpy's global generator, as
    gnn_tpu's does, so the same seed gives the same folds."""
    if focus is None:
        focus = problem_based if problem_based is not None else "n"
    assert number_of_batches > 1 + useVa
    if seed:
        np.random.seed(seed)
    gTRs, gTEs, gVAs = [], [], []

    if isinstance(dataset, Graph):
        # one graph: folds differ only in their set masks
        zero_mask = np.zeros(len(dataset.set_mask), dtype=bool)
        if normalize_method:
            normalize_graphs(dataset, None, None, based_on=normalize_method)
        idx = np.arange(len(zero_mask))
        np.random.shuffle(idx)
        masks = np.array_split(idx, number_of_batches)

        def with_mask(ids):
            g = dataset.copy()
            g.set_mask = zero_mask.copy()
            g.set_mask[ids] = True
            return g

        for i in range(len(masks)):
            M = list(masks)
            gTe = with_mask(M.pop(i))
            gVa = with_mask(M.pop(-1)) if useVa else None
            gTRs.append(with_mask(np.concatenate(M)))
            gTEs.append(gTe)
            gVAs.append(gVa)

    elif isinstance(dataset, list):
        # graphs, or lists of graphs (one list per class, stratified)
        if all(isinstance(i, Graph) for i in dataset):
            dataset = [dataset]
        assert all(len(i) > number_of_batches for i in dataset)
        assert all(isinstance(i, list) for i in dataset)
        assert all(isinstance(j, Graph) for i in dataset for j in i)
        for i in dataset:
            np.random.shuffle(i)
        dataset_batches = [getbatches(elem, focus, aggregation_mode, -1, number_of_batches,
                                      False) for elem in dataset]
        folds = [[g for db in dataset_batches for g in db[j]] for j in range(number_of_batches)]
        for i in folds:
            np.random.shuffle(i)
        merged = [Graph.merge(i, focus=focus, aggregation_mode=aggregation_mode) for i in folds]
        for i in range(len(merged)):
            gTr = list(merged)
            gTe = gTr.pop(i)
            gVa = gTr.pop(-1) if useVa else None
            if normalize_method:
                normalize_graphs(gTr, gTe, gVa, based_on=normalize_method)
            gTRs.append(gTr)
            gTEs.append(gTe)
            gVAs.append(gVa)
    else:
        raise TypeError("param <dataset> must be a Graph, list of Graphs or list of lists of "
                        "Graphs")
    return gTRs, gTEs, gVAs
