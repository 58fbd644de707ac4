"""Minibatch generators over host graphs (counterpart of
gnn_tpu/graphs/generator.py).

* GraphDataGenerator: merged-graph batches over a graph list, shuffled
  anew each epoch.
* SingleGraphDataGenerator: minibatches of ONE big graph, each the same
  padded batch with another set of supervised entities in its set mask.

Both build batches without blocks (GraphBatch.from_graph) on the host; with
`build_plan=True` each carries the segment kernel's plan, which a spec with
aggregation='pallas' runs on. Shuffles draw from np.random.default_rng(rng),
so the same seed gives gnn_tpu's batch order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.graphs.graph import Graph


class GraphDataGenerator:
    """Iterable over merged GraphBatches with optional epoch-start shuffling."""

    def __init__(self, graphs: Sequence[Graph], batch_size: int = 32, shuffle: bool = True,
                 focus: Optional[str] = None, aggregation_mode: Optional[str] = None, rng=None,
                 build_plan: bool = False):
        if not graphs:
            raise ValueError("graphs must be non-empty")
        self.graphs = list(graphs)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.focus = focus or graphs[0].focus
        self.aggregation_mode = aggregation_mode or graphs[0].aggregation_mode
        self.build_plan = build_plan
        self._rng = np.random.default_rng(rng)

    def __len__(self) -> int:
        return -(-len(self.graphs) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = [self.graphs[j] for j in order[i:i + self.batch_size]]
            merged = Graph.merge(chunk, focus=self.focus, aggregation_mode=self.aggregation_mode)
            yield GraphBatch.from_graph(merged, build_plan=self.build_plan)


class SingleGraphDataGenerator:
    """Minibatches of one big graph through rotating set masks: every batch
    shares the padded arrays; only set_mask and sel_mask change."""

    def __init__(self, graph: Graph, batch_size: int = 1024, shuffle: bool = True, rng=None,
                 build_plan: bool = False):
        if graph.focus == "g":
            raise ValueError("single-graph minibatching applies to node/edge focus")
        self.graph = graph
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(rng)
        # edge focus keeps the original arc order, so with_set_mask's
        # original-order masks line up with the batch's entity axis
        self._base = GraphBatch.from_graph(graph, build_plan=build_plan,
                                           sort_edges=(graph.focus != "a"))
        # supervised entities eligible for batching: set and output masked
        self._eligible = np.nonzero(graph.set_mask & graph.output_mask)[0]

    def __len__(self) -> int:
        return max(-(-len(self._eligible) // self.batch_size), 1)

    def __iter__(self):
        idx = self._eligible.copy()
        if self.shuffle:
            self._rng.shuffle(idx)
        n_ent = len(self.graph.set_mask)
        for i in range(0, len(idx), self.batch_size):
            mask = np.zeros(n_ent, dtype=bool)
            mask[idx[i:i + self.batch_size]] = True
            yield self._base.with_set_mask(mask)
