"""Inference serving: shape-bucketed batches and a packed-batch cache
(counterpart of gnn_tpu/serving.py, `Predictor` only).

Requests of any size are packed onto a few block-count / arc / target
buckets (the same log-spaced buckets as gnn_tpu); with `blocked=False` a
request is merged into one Graph and padded to config.pad_size buckets
without blocks (GraphBatch.from_graph, no plan, as gnn_tpu), which the plain
body aggregates with `index_add_`. PyTorch runs eagerly, so a
bucket needs no compile; `warmup` runs one forward per bucket so the kernel
build and CUDA start-up happen before traffic. Weights are copied to the
device once, at construction; per request only the packed batch goes up and
the selected target rows come back. An LGNN is served as a whole stack at
eval, with its last layer's target rows (gnn_tpu serving.py:62-78).
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from typing import List, Sequence, Union

import numpy as np
import torch

from gnn_tpu_torch.config import pad_size, resolve_device
from gnn_tpu_torch.graphs.batch import GraphBatch, from_graphs_blocked, packed_block_count
from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.models.composite import CompositeGNNSpec, check_node_types
from gnn_tpu_torch.models.core import with_init

_TOKEN_COUNTER = itertools.count()
INIT_SEED = 0   # the seed of every request's initial-state draw (state_dim > 0)


class PendingPrediction:
    """In-flight request from :meth:`Predictor.predict_async`: the forward has
    been enqueued on the device; `result()` copies the rows to the host (the
    only blocking step) and splits them per graph."""

    def __init__(self, out, iters, sel, glist, single: bool, split: bool, t0: float):
        self._out, self._iters, self._sel = out, iters, sel
        self._glist, self._single, self._split = glist, single, split
        self.t0 = t0        # perf_counter() when the forward was dispatched
        self.iters = None   # realised iteration count (a list a layer for an LGNN)

    def result(self):
        rows = self._out.cpu().numpy()[self._sel]      # device -> host barrier
        it = self._iters.cpu()
        self.iters = float(it) if it.dim() == 0 else [float(i) for i in it]
        if not self._split:
            return rows
        # targets are concatenated in request order and sel filters in order:
        # graph i's rows end at the count of selected targets up to its end
        ends = np.cumsum([g.targets.shape[0] for g in self._glist])
        kept = np.concatenate([[0], np.cumsum(self._sel)])[ends]
        parts: List[np.ndarray] = np.split(rows, kept[:-1])
        return parts[0] if self._single else parts


class Predictor:
    """Serve a model: ``Predictor(model).predict(graphs)``.

    :param model: a GNNnodeBased / GNNedgeBased / GNNgraphBased, one of
        their composite twins (Composite*Based) or an LGNN of them; its
        weights are copied at construction.
    :param blocked: pack block-dense batches (the kernels' path); False
        builds batches without blocks on config.pad_size buckets.
    :param block_w: block width of the packed batches.
    :param fused_layout: give blocked batches the loop/dep layout, so
        aggregation='auto' specs run the propagation kernels.
    :param bucket_multiple: block-count bucket granularity.
    :param cache_batches: size of the packed-batch LRU (0 disables it).
    :param adj_dtype: torch.bfloat16 packs blocked batches with a bf16
        adjacency (graphs/batch.py); None keeps it f32.
    :param device: None means the card ('cuda'); pass 'cpu' for the CPU.

    A model with state_dim > 0 starts each request from an initial state
    drawn from a CPU generator seeded to INIT_SEED on every call, as
    gnn_tpu's fixed key(0): a request's answer depends neither on earlier
    requests nor on the device.
    """

    def __init__(self, model, *, blocked: bool = True, block_w: int = 128,
                 fused_layout: bool = True, bucket_multiple: int = 8,
                 cache_batches: int = 256, adj_dtype=None, device=None):
        self.device = resolve_device(device)
        self._forward, params, bn, self._spec = _forward_callable(model)
        self._params = _copy_to(params, self.device)
        self._bn = _copy_to(bn, self.device)
        self._focus = self._spec.focus
        self._blocked = bool(blocked)
        self._block_w = int(block_w)
        self._fused = bool(fused_layout)
        self._adj_dtype = adj_dtype
        self._bucket_multiple = int(bucket_multiple)
        self._warm: set = set()
        # packed-batch LRU keyed by per-Graph identity tokens: a served Graph
        # is treated as immutable (mutating it in place serves stale results
        # until eviction; build a new Graph instead)
        self._batch_cache: "OrderedDict" = OrderedDict()
        self._cache_cap = int(cache_batches)
        # last_ms: dispatch to host rows of a request on a warm bucket (None on
        # a cold bucket, whose first forward is last_cold_s); last_pack_ms:
        # host pack + upload of a cache miss
        self.stats = {"requests": 0, "buckets": 0, "bucket_hits": 0,
                      "batch_cache_hits": 0, "last_ms": None, "last_pack_ms": None,
                      "last_cold_s": None, "last_iters": None}

    @staticmethod
    def _graph_token(g: Graph) -> int:
        tok = getattr(g, "_predictor_token", None)
        if tok is None:
            tok = next(_TOKEN_COUNTER)
            g._predictor_token = tok
        return tok

    def _check(self, glist: Sequence[Graph]) -> None:
        if not glist:
            raise ValueError("empty request: predict needs at least one Graph")
        for g in glist:
            if g.focus != self._focus:
                raise ValueError(f"graph focus {g.focus!r} does not match "
                                 f"model focus {self._focus!r}")
        if isinstance(self._spec, CompositeGNNSpec):
            check_node_types(glist, self._spec.n_types)

    def _buckets(self, glist):
        ep = pad_size(sum(g.n_arcs for g in glist), multiple=256, pow2_from=256)
        tp = pad_size(sum(g.targets.shape[0] for g in glist), multiple=128, pow2_from=128)
        bb = pad_size(packed_block_count(glist, self._block_w),
                      multiple=self._bucket_multiple, pow2_from=self._bucket_multiple)
        return bb, ep, tp

    def build_batch(self, glist: Sequence[Graph]) -> GraphBatch:
        """Pack a request onto its shape bucket (host tensors)."""
        self._check(glist)
        if not self._blocked:
            g = glist[0] if len(glist) == 1 else Graph.merge(
                list(glist), focus=self._focus, aggregation_mode=glist[0].aggregation_mode)
            return GraphBatch.from_graph(g)
        bb, ep, tp = self._buckets(glist)
        return from_graphs_blocked(list(glist), block_w=self._block_w, focus=self._focus,
                                   edge_pad=ep, target_pad=tp, min_blocks=bb,
                                   fused_layout=self._fused, adj_dtype=self._adj_dtype)

    def _cached_batch(self, glist: Sequence[Graph]):
        """(device batch, host sel mask, bucket) of a request, LRU-cached by
        the request's graph identities."""
        key = tuple(self._graph_token(g) for g in glist)
        hit = self._batch_cache.get(key) if self._cache_cap > 0 else None
        if hit is not None:
            self._batch_cache.move_to_end(key)
            self.stats["batch_cache_hits"] += 1
            return hit
        t0 = time.perf_counter()
        host = self.build_batch(glist)
        # a batch without blocks is shaped by from_graph's own pads
        bucket = self._buckets(glist) if self._blocked else host.pad_shapes()
        entry = (host.to(self.device), host.sel_mask.numpy(), bucket)
        self.stats["last_pack_ms"] = (time.perf_counter() - t0) * 1e3
        if self._cache_cap > 0:
            self._batch_cache[key] = entry
            if len(self._batch_cache) > self._cache_cap:
                self._batch_cache.popitem(last=False)
        return entry

    def _run(self, gb: GraphBatch):
        with torch.no_grad():
            return self._forward(self._params, self._bn, gb)

    def warmup(self, requests: Sequence[Union[Graph, Sequence[Graph]]]) -> int:
        """Run one forward per bucket the sample lands on (kernel build, CUDA
        start-up). Returns the number of buckets warmed."""
        n = 0
        for req in requests:
            glist = [req] if isinstance(req, Graph) else list(req)
            gb, _, bucket = self._cached_batch(glist)
            if bucket not in self._warm:
                t0 = time.perf_counter()
                out, _ = self._run(gb)
                out.cpu()
                self.stats["last_cold_s"] = time.perf_counter() - t0
                self._warm.add(bucket)
                self.stats["buckets"] += 1
                n += 1
        return n

    def predict(self, graphs: Union[Graph, Sequence[Graph]], split: bool = True):
        """Outputs for a request: one [Ti, DT] array per input graph (split)
        or the concatenated selected rows."""
        pending, cold = self._dispatch(graphs, split)
        res = pending.result()
        dt = time.perf_counter() - pending.t0
        if cold:
            self.stats["last_cold_s"], self.stats["last_ms"] = dt, None
        else:
            self.stats["last_ms"] = dt * 1e3
        self.stats["last_iters"] = pending.iters
        return res

    def predict_async(self, graphs: Union[Graph, Sequence[Graph]],
                      split: bool = True) -> PendingPrediction:
        """Enqueue a request without waiting for the device; the returned
        handle's `result()` gives what `predict` would."""
        return self._dispatch(graphs, split)[0]

    def _dispatch(self, graphs, split):
        single = isinstance(graphs, Graph)
        glist = [graphs] if single else list(graphs)
        gb, sel, bucket = self._cached_batch(glist)
        cold = bucket not in self._warm
        if cold:
            self._warm.add(bucket)
            self.stats["buckets"] += 1
        else:
            self.stats["bucket_hits"] += 1
        t0 = time.perf_counter()
        out, iters = self._run(gb)
        self.stats["requests"] += 1
        return PendingPrediction(out, iters, sel, glist, single, split, t0), cold

    def __call__(self, graphs):
        return self.predict(graphs)


def _forward_callable(model):
    """(fn, params, bn, the first layer's spec) with fn(params, bn, gb) ->
    (target-aligned output rows [Tp, DT], realised iteration count(s)) at
    eval (gnn_tpu serving.py:62-78): an LGNN's whole stack with its last
    layer's rows, else the model's forward. The initial states of
    state_dim > 0 come from a CPU generator seeded to INIT_SEED at each call
    (gnn_tpu's fixed key(0), serving.py:64-68)."""
    from gnn_tpu_torch.models.lgnn import LGNN, draw_inits, lgnn_forward
    if isinstance(model, LGNN):
        specs, gs, go = model._specs, model.get_state, model.get_output

        def fn(params, bns, gb):
            inits = draw_inits(specs, gb, torch.Generator().manual_seed(INIT_SEED))
            iters, outs, _, _ = lgnn_forward(specs, params, bns, gb, False, gs, go, inits)
            return outs[-1], torch.stack(iters)
        return fn, model._params(), model._bns(), specs[0]
    spec, forward = model.spec, model._forward

    def fn(params, bn, gb):
        masks = with_init(None, spec, gb, torch.Generator().manual_seed(INIT_SEED))
        res = forward(spec, params, bn, gb, masks=masks)
        return res["out"], res["iters"]
    return fn, model.params, model.bn, spec


def _copy_to(tree, device):
    """A copy on `device` of a tree of dicts and per-type tuples of tensors."""
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_copy_to(v, device) for v in tree)
    return tree.detach().to(device).clone()

