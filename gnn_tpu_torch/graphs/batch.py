"""Padded graph batch of tensors (counterpart of gnn_tpu/graphs/batch.py).

`from_graphs_blocked` packs graphs into W-node blocks so that no graph
straddles a block unless it has more than W nodes (those get a dedicated run
of blocks; their block-crossing arcs are "residual" arcs). Arcs inside a block
form a dense W x W block adjacency.

With `fused_layout=True` the blocks are split for the eval propagation
kernels (ops/fused.py):

* "loop" blocks touch no residual arc, so all K iterations of a block run
  inside one kernel launch (K3) on its adjacency, loaded once;
* "dep" blocks are coupled by residual arcs and iterate one step per launch
  (K4) with the residual term added between steps.

Without that layout (`fused_layout=False`, the default, or a batch in which
every block touches a residual arc) the batch gets the all-dep layout: every
block is a dep block (adj_dep holds all B adjacencies, dep_ids = arange(B),
block_perm the identity, the residual arcs in global node ids) and adj_loop
stays None, so `aggregation='fused'` runs K4/K9 (or the BatchNorm and typed
kernels) over every block each iteration, as gnn_tpu's per-step fused path
does, while `'auto'` still finds no loop layout and runs the plain body. It
costs 4 * W * W bytes a block (64 KiB at W = 128), as gnn_tpu's adj_blocks.

Block adjacencies are stored transposed, adjT[b, src, dst] = w, in float32:
a kernel thread per destination node then reads a row of adjT at
consecutive addresses. With `adj_dtype=torch.bfloat16` (gnn_tpu's
low-precision mode) adj_loop and adj_dep hold the f32 weights rounded to
nearest even bf16, 2 * W * W bytes a block, and only the bf16 two-layer
kernels take the batch (models/core.py); the residual and arc weights stay
f32. The field values (ids, masks, loop-block padding, block permutation,
residual ids, a bf16 adjacency's bits) equal gnn_tpu's batch exactly.

`GraphBatch.from_graph` builds a batch without blocks from one (merged)
Graph, padded to config.pad_size buckets, as gnn_tpu's does: the plain body
aggregates it over the arc arrays, and with `build_plan=True` through the
segment kernel K18 on a CSR plan (ops/segment.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnn_tpu_torch.config import floatx, pad_size
from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.ops.aggregate import aggregate_to_nodes
from gnn_tpu_torch.ops.segment import AggPlanPair, build_agg_plan


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    # --- node level (padded to Np = B * W) ---
    nodes: torch.Tensor          # [Np, NL] float32
    node_mask: torch.Tensor      # [Np] bool, True for real nodes
    graph_ids: torch.Tensor      # [Np] int64 graph membership
    pool_w: torch.Tensor         # [Np] float32 pooling weight 1/n_g (0 on pad)
    # --- arc level (padded to Ep, sorted by destination) ---
    src: torch.Tensor            # [Ep] int64
    dst: torch.Tensor            # [Ep] int64 (pad arcs point at the last node)
    arc_labels: torch.Tensor     # [Ep, AL]
    edge_w: torch.Tensor         # [Ep] aggregation weight (0 on pad)
    edge_mask: torch.Tensor      # [Ep] bool
    # --- supervision (entity level: nodes for 'n'/'g', arcs for 'a') ---
    set_mask: torch.Tensor
    output_mask: torch.Tensor
    # --- targets (padded to Tp; for 'g' the graph axis is also Tp) ---
    targets: torch.Tensor        # [Tp, DT]
    sample_weights: torch.Tensor  # [Tp]
    out_index: torch.Tensor      # [Tp] int64 entity (or graph) row per target
    sel_mask: torch.Tensor       # [Tp] bool
    # --- loop-invariant arc-label aggregation, sum_e w_e * label_e per dst;
    # None where the labels changed after packing (an LGNN layer's batch) ---
    agg_arcs_cache: Optional[torch.Tensor]  # [Np, AL]
    # --- the node-label aggregation A^T_w @ nodes (read with state_dim > 0),
    # None where the node labels changed after packing ---
    agg_nodes_cache: Optional[torch.Tensor] = None  # [Np, NL]
    res_w: Optional[torch.Tensor] = None   # [Er] residual arc weights (0 on pad); blocked only
    # --- fused layout: the loop fields are None unless fused_layout=True and a
    # loop block exists; the dep fields then hold the dep blocks, else (the
    # all-dep layout of a blocked batch) every block ---
    adj_loop: Optional[torch.Tensor] = None     # [Bi, W, W] adjT of loop blocks
    loop_ids: Optional[torch.Tensor] = None     # [Bi] global block ids (pad -> 0)
    loop_nm: Optional[torch.Tensor] = None      # [Bi, W] float node mask
    adj_dep: Optional[torch.Tensor] = None      # [Bd, W, W] adjT of dep blocks
    dep_ids: Optional[torch.Tensor] = None      # [Bd]
    res_src_loc: Optional[torch.Tensor] = None  # [Er] dep-local flat node ids
    res_dst_loc: Optional[torch.Tensor] = None  # [Er]
    # global block b sits at row block_perm[b] of cat([loop blocks, dep blocks])
    block_perm: Optional[torch.Tensor] = None   # [B]
    # --- composite models: node type per node (0 on pad), None without types ---
    node_types: Optional[torch.Tensor] = None   # [Np] int64
    # --- segment-kernel plan (from_graph(build_plan=True) only) ---
    agg_plan: Optional[AggPlanPair] = None
    # --- static ---
    focus: str = "n"
    block_w: int = 128                         # 0: from_graph, no blocks
    n_real: Tuple[int, int, int] = (0, 0, 0)   # (nodes, arcs, targets)
    edges_sorted: bool = True                  # arcs stored sorted by destination

    @property
    def n_node_pad(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_edge_pad(self) -> int:
        return self.src.shape[0]

    @property
    def n_target_pad(self) -> int:
        return self.targets.shape[0]

    @property
    def has_blocks(self) -> bool:
        """Built by from_graphs_blocked (gnn_tpu's adj_blocks is not None)."""
        return self.block_w > 0

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def agg_arcs(self) -> torch.Tensor:
        """The arc-label aggregation A^T_w @ arc_labels [Np, AL]: the cache, or
        without one (gnn_tpu's propagate, core.py:314-315) computed on the
        batch's device, differentiable in the labels."""
        if self.agg_arcs_cache is not None:
            return self.agg_arcs_cache
        return aggregate_to_nodes(self.arc_labels, self.edge_w, self.dst, self.n_node_pad)

    def agg_nodes(self) -> torch.Tensor:
        """The node-label aggregation A^T_w @ nodes [Np, NL]: the cache, or
        without one computed on the batch's device over the arcs,
        differentiable in the labels."""
        if self.agg_nodes_cache is not None:
            return self.agg_nodes_cache
        return aggregate_to_nodes(self.nodes[self.src], self.edge_w, self.dst, self.n_node_pad)

    @property
    def adj_dtype(self) -> torch.dtype:
        """The block adjacencies' dtype: float32, or bfloat16 (from_graphs_blocked's
        adj_dtype)."""
        adj = self.adj_loop if self.adj_loop is not None else self.adj_dep
        return torch.float32 if adj is None else adj.dtype

    def pad_shapes(self) -> Tuple[int, int, int]:
        return (self.n_node_pad, self.n_edge_pad, self.n_target_pad)

    def to(self, device) -> "GraphBatch":
        """Copy of this batch with every tensor, the plan's too, on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), (torch.Tensor, AggPlanPair))}
        return dataclasses.replace(self, **moved)

    # ------------------------------------------------------------ from_graph
    @classmethod
    def from_graph(cls, g: Graph, *, node_pad: Optional[int] = None,
                   edge_pad: Optional[int] = None, target_pad: Optional[int] = None,
                   sort_edges: bool = True, build_plan: bool = False) -> "GraphBatch":
        """A host batch without blocks from one Graph (gnn_tpu's from_graph):
        pads are config.pad_size buckets unless given. With `sort_edges` the
        arcs are stably sorted by destination, every arc-ordered field
        permuted with them, and pad arcs point at node N - 1 (weight 0);
        without, pad arcs point at node 0. `build_plan` adds K18's CSR plan
        (ops/segment.py), which `aggregation='pallas'` runs on.

        Left out of gnn_tpu's batch: pool_starts/pool_ends (the port pools
        with ops/aggregate.pool_graphs)."""
        dt = floatx()
        N, E, T = g.n_nodes, g.n_arcs, g.targets.shape[0]
        Np = node_pad or pad_size(N)
        Ep = edge_pad or pad_size(E)
        Tp = target_pad or pad_size(T)
        if Np < N or Ep < E or Tp < T:
            raise ValueError(f"pad sizes ({Np},{Ep},{Tp}) below real sizes ({N},{E},{T})")

        # perm maps a stored position to the original arc, inv the reverse
        perm = np.argsort(g.dst, kind="stable") if sort_edges else np.arange(E)
        inv = np.empty(E, dtype=np.int64)
        inv[perm] = np.arange(E)
        src = _pad(g.src[perm].astype(np.int64), Ep)
        dst = _pad(g.dst[perm].astype(np.int64), Ep, fill=(N - 1) if sort_edges else 0)
        arc_labels = _pad(g.arc_labels[perm].astype(dt), Ep)
        edge_w = _pad(g.edge_weights()[perm].astype(dt), Ep)

        if g.focus == "a":
            set_mask = _pad(g.set_mask[perm], Ep, False)
            output_mask = _pad(g.output_mask[perm], Ep, False)
        else:
            set_mask = _pad(g.set_mask, Np, False)
            output_mask = _pad(g.output_mask, Np, False)

        if g.focus == "g":
            # target row t <-> pooled graph t
            out_index = np.arange(Tp, dtype=np.int64)
            sel = _pad(np.ones(T, dtype=bool), Tp, False)
        else:
            # target rows follow the output-masked entities in order
            ent_idx = np.nonzero(g.output_mask)[0]
            if len(ent_idx) != T:
                raise ValueError(
                    f"targets rows ({T}) != output-masked entities ({len(ent_idx)})")
            sel = _pad(g.set_mask[ent_idx], Tp, False)
            if g.focus == "a":
                ent_idx = inv[ent_idx]
            out_index = _pad(ent_idx.astype(np.int64), Tp)

        nodes = _pad(g.nodes.astype(dt), Np)
        return cls(
            nodes=_t(nodes),
            node_mask=_t(_pad(np.ones(N, bool), Np, False)),
            graph_ids=_ix(_pad(g.graph_ids(), Np)),
            pool_w=_t(_pad(g.pool_weights().astype(dt), Np)),
            src=_t(src), dst=_t(dst), arc_labels=_t(arc_labels), edge_w=_t(edge_w),
            edge_mask=_t(_pad(np.ones(E, bool), Ep, False)),
            set_mask=_t(set_mask), output_mask=_t(output_mask),
            targets=_t(_pad(g.targets.astype(dt), Tp)),
            sample_weights=_t(_pad(g.sample_weights.astype(dt), Tp)),
            out_index=_t(out_index), sel_mask=_t(sel),
            agg_arcs_cache=_t(_host_agg(arc_labels, edge_w, dst, Np)),
            agg_nodes_cache=_t(_host_agg(nodes[np.minimum(src, Np - 1)], edge_w, dst, Np)),
            node_types=(None if g.node_types is None else _ix(_pad(g.node_types, Np))),
            agg_plan=build_agg_plan(src, dst, edge_w, Np) if build_plan else None,
            focus=g.focus, block_w=0, n_real=(N, E, T), edges_sorted=bool(sort_edges))

    # ------------------------------------------------------------- utilities
    def with_set_mask(self, set_mask) -> "GraphBatch":
        """The batch with another set mask (gnn_tpu's with_set_mask, LKO
        single-graph folds): sel_mask is recomputed for the new split."""
        sm = np.zeros(self.set_mask.shape[0], dtype=bool)
        sm[: len(set_mask)] = np.asarray(set_mask, dtype=bool)
        if self.focus == "g":
            sel = self.sel_mask
        else:
            oi = self.out_index.cpu().numpy()
            sel = _t(sm[oi] & (np.arange(len(oi)) < self.n_real[2])).to(self.device)
        return dataclasses.replace(self, set_mask=_t(sm).to(self.device), sel_mask=sel)

    def to_graph(self, aggregation_mode: Optional[str] = None) -> Graph:
        """The host Graph of this batch (gnn_tpu's to_graph): padding
        stripped, arcs in the stored order; a blocked batch's node ids are
        compressed over its node mask. The aggregation mode is read from the
        weights unless given."""
        N, E, T = self.n_real

        def h(x):
            return x.detach().cpu().numpy()
        src, dst = h(self.src)[:E], h(self.dst)[:E]
        if self.has_blocks:
            nm = h(self.node_mask)
            new_id = np.cumsum(nm) - 1          # padded id -> compact id
            src, dst = new_id[src], new_id[dst]
            node_rows = np.nonzero(nm)[0]
        else:
            node_rows = np.arange(N)
        arcs = np.concatenate([src.astype(np.float64)[:, None], dst.astype(np.float64)[:, None],
                               h(self.arc_labels)[:E]], axis=1)
        nodes = h(self.nodes)[node_rows]
        targets, sample_weights = h(self.targets)[:T], h(self.sample_weights)[:T]
        rows = slice(None, E) if self.focus == "a" else node_rows
        set_mask, output_mask = h(self.set_mask)[rows], h(self.output_mask)[rows]
        if self.focus == "a" and T:
            # targets are in original arc order, the arcs in stored order
            order = np.argsort(h(self.out_index)[:T], kind="stable")
            targets, sample_weights = targets[order], sample_weights[order]
        if aggregation_mode is None:
            w = h(self.edge_w)[:E].astype(np.float64)
            if E == 0 or np.allclose(w, 1.0):
                aggregation_mode = "sum"
            elif np.allclose(w, 1.0 / E):
                aggregation_mode = "normalized"
            else:
                aggregation_mode = "average"
        node_graph = None
        if self.focus == "g":
            gid = h(self.graph_ids)[node_rows].astype(np.int64)
            node_graph = np.zeros((N, T), dtype=nodes.dtype)
            node_graph[np.arange(N), gid] = h(self.pool_w)[node_rows]
        return Graph(arcs=arcs, nodes=nodes, targets=targets, focus=self.focus,
                     set_mask=set_mask, output_mask=output_mask, sample_weights=sample_weights,
                     node_graph=node_graph, aggregation_mode=aggregation_mode,
                     node_types=(None if self.node_types is None
                                 else h(self.node_types)[node_rows]))

    def repad(self, node_pad: int, edge_pad: int, target_pad: int) -> "GraphBatch":
        """The batch grown to the given pads (shrinking raises), to put a
        list of batches on one shape; the plan is rebuilt for the new node
        count. Blocked batches are built at their final shape."""
        if self.has_blocks:
            raise ValueError("blocked batches are built at their final shape — "
                             "pass target/edge pads to from_graphs_blocked")
        Np0, Ep0, Tp0 = self.pad_shapes()
        if node_pad < Np0 or edge_pad < Ep0 or target_pad < Tp0:
            raise ValueError("repad cannot shrink padded shapes")
        if (node_pad, edge_pad, target_pad) == (Np0, Ep0, Tp0):
            return self

        def grow(x, size, fill=0):
            return None if x is None else _t(_pad(x.cpu().numpy(), size, fill)).to(x.device)

        dst_fill = (self.n_real[0] - 1) if self.edges_sorted else 0
        ent_pad = edge_pad if self.focus == "a" else node_pad
        new = dataclasses.replace(
            self,
            nodes=grow(self.nodes, node_pad), node_mask=grow(self.node_mask, node_pad, False),
            graph_ids=grow(self.graph_ids, node_pad), pool_w=grow(self.pool_w, node_pad),
            src=grow(self.src, edge_pad), dst=grow(self.dst, edge_pad, dst_fill),
            arc_labels=grow(self.arc_labels, edge_pad), edge_w=grow(self.edge_w, edge_pad),
            edge_mask=grow(self.edge_mask, edge_pad, False),
            set_mask=grow(self.set_mask, ent_pad, False),
            output_mask=grow(self.output_mask, ent_pad, False),
            targets=grow(self.targets, target_pad),
            sample_weights=grow(self.sample_weights, target_pad),
            out_index=grow(self.out_index, target_pad),
            sel_mask=grow(self.sel_mask, target_pad, False),
            agg_arcs_cache=grow(self.agg_arcs_cache, node_pad),
            agg_nodes_cache=grow(self.agg_nodes_cache, node_pad),
            node_types=grow(self.node_types, node_pad))
        if self.agg_plan is not None:
            plan = build_agg_plan(new.src.cpu().numpy(), new.dst.cpu().numpy(),
                                  new.edge_w.cpu().numpy(), node_pad)
            new = dataclasses.replace(new, agg_plan=plan.to(self.device))
        return new


def _pack_offsets(sizes, W: int):
    """Greedy node offsets for block packing (no graph straddles a W-node
    block; graphs larger than W get a dedicated span of ceil(s/W) blocks).
    Returns (offsets, padded node count)."""
    offsets, cursor = [], 0
    for s in sizes:
        if s > W:
            if cursor % W:
                cursor += W - cursor % W
            offsets.append(cursor)
            cursor += -(-s // W) * W
        else:
            if cursor % W and (cursor % W) + s > W:
                cursor += W - cursor % W
            offsets.append(cursor)
            cursor += s
    return offsets, -(-cursor // W) * W


def packed_block_count(glist, block_w: int = 128) -> int:
    """Block count from_graphs_blocked would produce for `glist` (without
    min_blocks), from the packing arithmetic alone."""
    _, Np = _pack_offsets([g.n_nodes for g in glist], int(block_w))
    return Np // int(block_w)


def _pad(x, size, fill=0):
    """x padded along its first axis to `size` rows of `fill`."""
    x = np.asarray(x)
    out = np.full((size,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _host_agg(values, weights, dst, num_nodes):
    out = np.zeros((num_nodes, values.shape[1]), dtype=values.dtype)
    np.add.at(out, dst, values * weights[:, None])
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ix(x):
    return _t(np.asarray(x, dtype=np.int64))


def from_graphs_blocked(glist, *, block_w: int = 128, focus: Optional[str] = None,
                        aggregation_mode: Optional[str] = None,
                        target_pad: Optional[int] = None, edge_pad: Optional[int] = None,
                        min_blocks: Optional[int] = None,
                        fused_layout: bool = False, adj_dtype=None) -> GraphBatch:
    """Build a host (CPU) GraphBatch with graph-aligned node packing; move it
    with `.to(device)`. Supervision semantics equal Graph.merge: padding slots
    are excluded everywhere by the masks. `fused_layout=True` splits the
    blocks into loop and dep blocks where a loop block exists; otherwise the
    batch carries the all-dep layout (module docstring), 64 KiB a block at
    W = 128. `adj_dtype=torch.bfloat16` stores the block adjacencies in bf16
    (32 KiB a block at W = 128); None or torch.float32 keeps them f32."""
    if adj_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"adj_dtype must be None, torch.float32 or torch.bfloat16, "
                         f"got {adj_dtype!r}")
    adt = torch.float32 if adj_dtype is None else adj_dtype
    dt = floatx()
    W = int(block_w)
    focus = focus or glist[0].focus
    aggregation_mode = aggregation_mode or glist[0].aggregation_mode

    offsets, Np = _pack_offsets([g.n_nodes for g in glist], W)
    if min_blocks is not None:
        Np = max(Np, int(min_blocks) * W)
    B = Np // W

    NL = glist[0].DIM_NODE_LABEL
    nodes = np.zeros((Np, NL), dtype=dt)
    node_mask = np.zeros(Np, dtype=bool)
    graph_ids = np.zeros(Np, dtype=np.int64)
    pool_w = np.zeros(Np, dtype=dt)
    node_types = (np.zeros(Np, dtype=np.int64)
                  if any(g.node_types is not None for g in glist) else None)
    for gi, (g, off) in enumerate(zip(glist, offsets)):
        s = g.n_nodes
        nodes[off:off + s] = g.nodes
        node_mask[off:off + s] = True
        graph_ids[off:off + s] = gi
        if focus == "g":
            pool_w[off:off + s] = g.pool_weights()
        if node_types is not None and g.node_types is not None:
            node_types[off:off + s] = g.node_types

    AL = glist[0].DIM_ARC_LABEL
    src = np.concatenate([np.add(g.src, off, dtype=np.int64) for g, off in zip(glist, offsets)])
    dst = np.concatenate([np.add(g.dst, off, dtype=np.int64) for g, off in zip(glist, offsets)])
    E = len(src)
    # weights follow the requested mode with Graph.merge semantics: 'normalized'
    # is 1/E over the union; 'average' and 'sum' are union-invariant
    if aggregation_mode == "normalized":
        w = np.full(E, 1.0 / max(E, 1), dtype=dt)
    elif aggregation_mode == "sum":
        w = np.ones(E, dtype=dt)
    else:
        w_all = []
        for g in glist:
            if g.aggregation_mode == "average":
                w_all.append(g.edge_weights())
            else:
                _, inv, counts = np.unique(g.dst, return_inverse=True, return_counts=True)
                w_all.append(1.0 / counts[inv])
        w = np.concatenate(w_all).astype(dt, copy=False)
    labs = (np.concatenate([g.arc_labels for g in glist]).astype(dt, copy=False) if AL
            else np.zeros((E, 0), dt))

    intra = (src // W) == (dst // W)
    r_src = src[~intra]
    r_dst = dst[~intra]
    r_w = w[~intra]
    Er = max(-(-len(r_src) // 128) * 128, 128)
    res_w = np.zeros(Er, dt)
    res_w[:len(r_w)] = r_w

    fl = {}
    dep_set = np.unique(np.concatenate([r_src // W, r_dst // W])).astype(np.int64)
    loop_ids_np = np.setdiff1d(np.arange(B, dtype=np.int64), dep_set)
    Bi = len(loop_ids_np)
    si, di, wi = src[intra], dst[intra], w[intra]
    adjT = np.zeros((B, W, W), dtype=np.float32)
    np.add.at(adjT, (di // W, si % W, di % W), wi)

    def adj(x):      # torch rounds f32 to bf16 to nearest even, as gnn_tpu's ml_dtypes
        return _t(x).to(adt)
    if not (fused_layout and Bi > 0):
        # the all-dep layout: every block a dep block, residual arcs in global ids
        fl.update(adj_dep=adj(adjT), dep_ids=_t(np.arange(B, dtype=np.int64)),
                  res_src_loc=_ix(np.pad(r_src, (0, Er - len(r_src)))),
                  res_dst_loc=_ix(np.pad(r_dst, (0, Er - len(r_dst)))),
                  block_perm=_t(np.arange(B, dtype=np.int64)))
    else:
        # loop-block count padding of gnn_tpu's batch (its kernel grid groups);
        # padded rows carry node mask 0 and block_perm never points at them
        GRP = 24 if Bi > 24 else 8
        Bi_pad = -(-Bi // GRP) * GRP if Bi > 8 else Bi
        adj_loop = np.zeros((Bi_pad, W, W), np.float32)
        adj_loop[:Bi] = adjT[loop_ids_np]
        ids_pad = np.zeros(Bi_pad, np.int64)
        ids_pad[:Bi] = loop_ids_np
        loop_nm = np.zeros((Bi_pad, W), np.float32)
        loop_nm[:Bi] = node_mask.reshape(B, W)[loop_ids_np]
        perm = np.zeros(B, np.int64)
        perm[loop_ids_np] = np.arange(Bi)
        fl.update(adj_loop=adj(adj_loop), loop_ids=_t(ids_pad), loop_nm=_t(loop_nm))
        if len(dep_set):
            perm[dep_set] = Bi_pad + np.arange(len(dep_set))
            # residual arcs in dep-local flat ids; pad rows land on 0 with weight 0
            loc_src = np.searchsorted(dep_set, r_src // W) * W + r_src % W
            loc_dst = np.searchsorted(dep_set, r_dst // W) * W + r_dst % W
            fl.update(adj_dep=adj(adjT[dep_set]), dep_ids=_t(dep_set),
                      res_src_loc=_ix(np.pad(loc_src, (0, Er - len(loc_src)))),
                      res_dst_loc=_ix(np.pad(loc_dst, (0, Er - len(loc_dst)))))
        fl["block_perm"] = _t(perm)

    # full arc arrays (arc-label aggregation, plain body, arc readout), dst-sorted
    order = np.argsort(dst, kind="stable")
    Ep = edge_pad or pad_size(E)

    src_p = _pad(src[order], Ep)
    dst_p = _pad(dst[order], Ep, fill=Np - 1)
    labs_p = _pad(labs[order], Ep)
    w_p = _pad(w[order], Ep)

    targets = np.concatenate([g.targets for g in glist]).astype(dt)
    sample_weights = np.concatenate([g.sample_weights for g in glist]).astype(dt)
    T = targets.shape[0]
    Tp = target_pad or pad_size(T)
    if focus == "a":
        # arc supervision: masks follow the dst sort; target rows map to
        # output-masked arcs in the original concatenated arc order
        set_all = np.concatenate([g.set_mask for g in glist])
        out_all = np.concatenate([g.output_mask for g in glist])
        set_mask = _pad(set_all[order], Ep, False)
        output_mask = _pad(out_all[order], Ep, False)
        inv = np.empty(E, np.int64)
        inv[order] = np.arange(E)
        orig_idx = np.nonzero(out_all)[0]
        if len(orig_idx) != T:
            raise ValueError(f"targets rows ({T}) != output-masked entities ({len(orig_idx)})")
        out_index = _pad(inv[orig_idx], Tp)
        sel = _pad(set_all[orig_idx], Tp, False)
    else:
        set_mask = np.zeros(Np, bool)
        output_mask = np.zeros(Np, bool)
        for g, off in zip(glist, offsets):
            set_mask[off:off + g.n_nodes] = g.set_mask
            output_mask[off:off + g.n_nodes] = g.output_mask
        if focus == "g":
            out_index = np.arange(Tp, dtype=np.int64)
            sel = _pad(np.ones(T, bool), Tp, False)
        else:
            ent_idx = np.nonzero(output_mask)[0]
            if len(ent_idx) != T:
                raise ValueError(f"targets rows ({T}) != output-masked entities ({len(ent_idx)})")
            out_index = _pad(ent_idx, Tp)
            sel = _pad(set_mask[ent_idx], Tp, False)

    return GraphBatch(
        nodes=_t(nodes), node_mask=_t(node_mask), graph_ids=_t(graph_ids),
        pool_w=_t(pool_w), src=_ix(src_p), dst=_ix(dst_p), arc_labels=_t(labs_p),
        edge_w=_t(w_p), edge_mask=_t(_pad(np.ones(E, bool), Ep, False)),
        set_mask=_t(set_mask), output_mask=_t(output_mask),
        targets=_t(_pad(targets, Tp)), sample_weights=_t(_pad(sample_weights, Tp)),
        out_index=_ix(out_index), sel_mask=_t(sel),
        agg_arcs_cache=_t(_host_agg(labs_p, w_p, dst_p, Np)),
        agg_nodes_cache=_t(_host_agg(nodes[np.minimum(src_p, Np - 1)], w_p, dst_p, Np)),
        res_w=_t(res_w),
        node_types=None if node_types is None else _t(node_types),
        focus=focus, block_w=W, n_real=(int(node_mask.sum()), E, T), **fl)
