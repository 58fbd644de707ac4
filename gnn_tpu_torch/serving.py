"""Inference serving: shape-bucketed batches and a packed-batch cache
(counterpart of gnn_tpu/serving.py, `Predictor` only).

Requests of any size are packed onto a few block-count / arc / target
buckets (the same log-spaced buckets as gnn_tpu). PyTorch runs eagerly, so a
bucket needs no compile; `warmup` runs one forward per bucket so the kernel
build and CUDA start-up happen before traffic. Weights are copied to the
device once, at construction; per request only the packed batch goes up and
the selected target rows come back.
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
from gnn_tpu_torch.models.core import gnn_forward

_TOKEN_COUNTER = itertools.count()


class PendingPrediction:
    """In-flight request from :meth:`Predictor.predict_async`: the forward has
    been enqueued on the device; `result()` copies the rows to the host (the
    only blocking step) and splits them per graph."""

    def __init__(self, out, iters, sel, glist, single: bool, split: bool, t0: float):
        self._out, self._iters, self._sel = out, iters, sel
        self._glist, self._single, self._split = glist, single, split
        self.t0 = t0        # perf_counter() when the forward was dispatched
        self.iters = None   # realised iteration count, set by result()

    def result(self):
        rows = self._out.cpu().numpy()[self._sel]      # device -> host barrier
        self.iters = float(self._iters)
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

    :param model: a GNNnodeBased / GNNedgeBased / GNNgraphBased; its weights
        are copied at construction.
    :param block_w: block width of the packed batches.
    :param bucket_multiple: block-count bucket granularity.
    :param cache_batches: size of the packed-batch LRU (0 disables it).
    :param device: None means the card ('cuda'); pass 'cpu' for the CPU.
    """

    def __init__(self, model, *, block_w: int = 128, bucket_multiple: int = 8,
                 cache_batches: int = 256, device=None):
        self.device = resolve_device(device)
        self._spec = model.spec
        self._params = _copy_to(model.params, self.device)
        self._bn = _copy_to(model.bn, self.device)
        self._focus = model.spec.focus
        self._block_w = int(block_w)
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

    def _buckets(self, glist):
        ep = pad_size(sum(g.n_arcs for g in glist), multiple=256, pow2_from=256)
        tp = pad_size(sum(g.targets.shape[0] for g in glist), multiple=128, pow2_from=128)
        bb = pad_size(packed_block_count(glist, self._block_w),
                      multiple=self._bucket_multiple, pow2_from=self._bucket_multiple)
        return bb, ep, tp

    def build_batch(self, glist: Sequence[Graph]) -> GraphBatch:
        """Pack a request onto its shape bucket (host tensors)."""
        self._check(glist)
        bb, ep, tp = self._buckets(glist)
        return from_graphs_blocked(list(glist), block_w=self._block_w, focus=self._focus,
                                   edge_pad=ep, target_pad=tp, min_blocks=bb,
                                   fused_layout=True)

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
        entry = (host.to(self.device), host.sel_mask.numpy(), self._buckets(glist))
        self.stats["last_pack_ms"] = (time.perf_counter() - t0) * 1e3
        if self._cache_cap > 0:
            self._batch_cache[key] = entry
            if len(self._batch_cache) > self._cache_cap:
                self._batch_cache.popitem(last=False)
        return entry

    def _run(self, gb: GraphBatch):
        with torch.no_grad():
            res = gnn_forward(self._spec, self._params, self._bn, gb)
        return res["out"], res["iters"]

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


def _copy_to(tree, device):
    return {k: (_copy_to(v, device) if isinstance(v, dict) else v.detach().to(device).clone())
            for k, v in tree.items()}

