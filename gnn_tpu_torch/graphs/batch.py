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

Block adjacencies are stored transposed, adjT[b, src, dst] = w, in float32:
a kernel thread per destination node then reads a row of adjT at
consecutive addresses. The field values (ids, masks, loop-block padding,
block permutation, residual ids) equal gnn_tpu's batch exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnn_tpu_torch.config import floatx, pad_size


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
    # --- loop-invariant arc-label aggregation, sum_e w_e * label_e per dst ---
    agg_arcs_cache: torch.Tensor  # [Np, AL]
    res_w: torch.Tensor          # [Er] residual arc weights (0 on pad)
    # --- fused layout (None unless fused_layout=True and a loop block exists) ---
    adj_loop: Optional[torch.Tensor] = None     # [Bi, W, W] adjT of loop blocks
    loop_ids: Optional[torch.Tensor] = None     # [Bi] global block ids (pad -> 0)
    loop_nm: Optional[torch.Tensor] = None      # [Bi, W] float node mask
    adj_dep: Optional[torch.Tensor] = None      # [Bd, W, W] adjT of dep blocks
    dep_ids: Optional[torch.Tensor] = None      # [Bd]
    res_src_loc: Optional[torch.Tensor] = None  # [Er] dep-local flat node ids
    res_dst_loc: Optional[torch.Tensor] = None  # [Er]
    # global block b sits at row block_perm[b] of cat([loop blocks, dep blocks])
    block_perm: Optional[torch.Tensor] = None   # [B]
    # --- static ---
    focus: str = "n"
    block_w: int = 128
    n_real: Tuple[int, int, int] = (0, 0, 0)   # (nodes, arcs, targets)

    @property
    def n_node_pad(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_target_pad(self) -> int:
        return self.targets.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def to(self, device) -> "GraphBatch":
        """Copy of this batch with every tensor on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


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
                        fused_layout: bool = False) -> GraphBatch:
    """Build a host (CPU) GraphBatch with graph-aligned node packing; move it
    with `.to(device)`. Supervision semantics equal Graph.merge: padding slots
    are excluded everywhere by the masks."""
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
    for gi, (g, off) in enumerate(zip(glist, offsets)):
        s = g.n_nodes
        nodes[off:off + s] = g.nodes
        node_mask[off:off + s] = True
        graph_ids[off:off + s] = gi
        if focus == "g":
            pool_w[off:off + s] = g.pool_weights()

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
    if fused_layout and Bi > 0:
        si, di, wi = src[intra], dst[intra], w[intra]
        adjT = np.zeros((B, W, W), dtype=np.float32)
        np.add.at(adjT, (di // W, si % W, di % W), wi)
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
        fl.update(adj_loop=_t(adj_loop), loop_ids=_t(ids_pad), loop_nm=_t(loop_nm))
        if len(dep_set):
            perm[dep_set] = Bi_pad + np.arange(len(dep_set))
            # residual arcs in dep-local flat ids; pad rows land on 0 with weight 0
            loc_src = np.searchsorted(dep_set, r_src // W) * W + r_src % W
            loc_dst = np.searchsorted(dep_set, r_dst // W) * W + r_dst % W
            fl.update(adj_dep=_t(adjT[dep_set]), dep_ids=_t(dep_set),
                      res_src_loc=_ix(np.pad(loc_src, (0, Er - len(loc_src)))),
                      res_dst_loc=_ix(np.pad(loc_dst, (0, Er - len(loc_dst)))))
        fl["block_perm"] = _t(perm)

    # full arc arrays (arc-label aggregation, plain body, arc readout), dst-sorted
    order = np.argsort(dst, kind="stable")
    Ep = edge_pad or pad_size(E)

    def padf(x, size, fill=0):
        out = np.full((size,) + x.shape[1:], fill, dtype=x.dtype)
        out[: x.shape[0]] = x
        return out

    src_p = padf(src[order], Ep)
    dst_p = padf(dst[order], Ep, fill=Np - 1)
    labs_p = padf(labs[order], Ep)
    w_p = padf(w[order], Ep)

    targets = np.concatenate([g.targets for g in glist]).astype(dt)
    sample_weights = np.concatenate([g.sample_weights for g in glist]).astype(dt)
    T = targets.shape[0]
    Tp = target_pad or pad_size(T)
    if focus == "a":
        # arc supervision: masks follow the dst sort; target rows map to
        # output-masked arcs in the original concatenated arc order
        set_all = np.concatenate([g.set_mask for g in glist])
        out_all = np.concatenate([g.output_mask for g in glist])
        set_mask = padf(set_all[order], Ep, False)
        output_mask = padf(out_all[order], Ep, False)
        inv = np.empty(E, np.int64)
        inv[order] = np.arange(E)
        orig_idx = np.nonzero(out_all)[0]
        if len(orig_idx) != T:
            raise ValueError(f"targets rows ({T}) != output-masked entities ({len(orig_idx)})")
        out_index = padf(inv[orig_idx], Tp)
        sel = padf(set_all[orig_idx], Tp, False)
    else:
        set_mask = np.zeros(Np, bool)
        output_mask = np.zeros(Np, bool)
        for g, off in zip(glist, offsets):
            set_mask[off:off + g.n_nodes] = g.set_mask
            output_mask[off:off + g.n_nodes] = g.output_mask
        if focus == "g":
            out_index = np.arange(Tp, dtype=np.int64)
            sel = padf(np.ones(T, bool), Tp, False)
        else:
            ent_idx = np.nonzero(output_mask)[0]
            if len(ent_idx) != T:
                raise ValueError(f"targets rows ({T}) != output-masked entities ({len(ent_idx)})")
            out_index = padf(ent_idx, Tp)
            sel = padf(set_mask[ent_idx], Tp, False)

    return GraphBatch(
        nodes=_t(nodes), node_mask=_t(node_mask), graph_ids=_t(graph_ids),
        pool_w=_t(pool_w), src=_ix(src_p), dst=_ix(dst_p), arc_labels=_t(labs_p),
        edge_w=_t(w_p), edge_mask=_t(padf(np.ones(E, bool), Ep, False)),
        set_mask=_t(set_mask), output_mask=_t(output_mask),
        targets=_t(padf(targets, Tp)), sample_weights=_t(padf(sample_weights, Tp)),
        out_index=_ix(out_index), sel_mask=_t(sel),
        agg_arcs_cache=_t(_host_agg(labs_p, w_p, dst_p, Np)), res_w=_t(res_w),
        focus=focus, block_w=W, n_real=(int(node_mask.sum()), E, T), **fl)
