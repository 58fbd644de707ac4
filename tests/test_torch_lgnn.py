"""gnn_tpu_torch's LGNN (models/lgnn.py) against gnn_tpu's, on the CPU.

Both packages build the same graphs from one numpy seed; the port's layers
take gnn_tpu's initial weights (convert.params_from_jax) and the keep-masks
gnn_tpu draws along its key chain (one key a layer, lgnn.py:87). gnn_tpu runs
its exact f32 body (aggregation='blocked', highest matmul precision); the
port runs the route its spec and the fused-layout batch select, the kernels'
plain versions on the CPU. Tolerances are ROADMAP's: realised iteration
counts equal, states and outputs within atol 3e-5, the loss rtol 1e-5, grads
rtol 2e-4 (atol 1e-6), params after one Adam step atol 1e-5.

A two-layer stack with get_output trains layer 0 through layer 1's initial
state, so each case below holds one route's gradient into its initial state
(its `ds`) against gnn_tpu: K3/K5 and K4 ('hybrid'), K7/K8 and K6
('dropout'), K1/K2 ('bn'), K10/K11 and K9 ('hybrid2'), K12/K13 ('dropout2'),
K14/K15 ('bn' two-layer), the plain body and a composite stack.
"""

import collections
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnn_tpu
from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs import datasets as jdata
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu.models import composite as jcomp
from gnn_tpu.models import core as jcore
from gnn_tpu.models import lgnn as jlgnn
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.serving import Predictor as JPredictor
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import (LGNN, CompositeGNNgraphBased, GNNedgeBased, GNNgraphBased,
                           GNNnodeBased, Predictor, get_inout_dims)
from gnn_tpu_torch.convert import flatten
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.models import lgnn as tlgnn
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
ATOL = 3e-5
K = 4
NL, AL, DT = 5, 3, 2
JCLASS = {"n": gnn_tpu.GNNnodeBased, "a": gnn_tpu.GNNedgeBased, "g": gnn_tpu.GNNgraphBased}
TCLASS = {"n": GNNnodeBased, "a": GNNedgeBased, "g": GNNgraphBased}


def graphs(seed, focus, nl=NL, n=6):
    """Both packages' graphs from one seed: n graphs of 8-19 nodes and a
    70-node one spanning several 32-node blocks (dep blocks, residual arcs)."""
    out = []
    for mod in (jdata, tdata):
        rng = np.random.default_rng(seed)
        gs = [mod.random_graph(int(rng.integers(8, 20)), nl, AL, DT, 0.5, focus=focus, rng=rng)
              for _ in range(n)]
        gs.insert(2, mod.random_graph(70, nl, AL, DT, 0.15, focus=focus, rng=rng))
        out.append(gs)
    return out


def batches(jgs, tgs, focus):
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus=focus, fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus=focus, fused_layout=True)
    assert tb.adj_loop is not None and tb.adj_dep is not None
    return jb, tb


# the state nets of each route: (hidden units, dropout rate, BatchNorm)
ROUTE_NETS = {"hybrid": ((), 0.0, False), "dropout": ((), 0.1, False), "bn": ((), 0.1, True),
              "hybrid2": ((7,), 0.0, False), "dropout2": ((7,), 0.1, False),
              "bn2": ((7,), 0.1, True), "plain": ((), 0.1, False)}
WANT_ROUTE = {"bn2": "bn", "plain": "plain"}


def layer_kw(route, focus, layer, get_state, get_output, nl=NL, act="selu"):
    """(state net kwargs, output net kwargs) of one layer."""
    hidden, rate, bn = ROUTE_NETS[route]
    dims = dict(layer=layer, get_state=get_state, get_output=get_output)
    in_s, u_s = get_inout_dims("state", nl, AL, DT, focus, 0, list(hidden) or None, **dims)
    in_o, u_o = get_inout_dims("output", nl, AL, DT, focus, 0, None, **dims)
    drop = dict(dropout_rate=(rate,), dropout_pos=(0,), alphadropout=True) if rate else {}
    sk = dict(input_dim=in_s, units=tuple(u_s), activations=act,
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=bn, **drop)
    ok = dict(input_dim=in_o, units=tuple(u_o), activations="softmax",
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    return sk, ok


def composite_layer_kw(focus, layer, get_state, get_output, T=3):
    in_s, u_s = get_inout_dims("state", NL, AL, DT, focus, 0, None, layer=layer,
                               get_state=get_state, get_output=get_output)
    in_o, u_o = get_inout_dims("output", NL, AL, DT, focus, 0, None, layer=layer,
                               get_state=get_state, get_output=get_output)
    sks = [dict(input_dim=in_s, units=tuple(u_s), activations=("selu", "tanh", "relu")[t],
                batch_normalization=False) for t in range(T)]
    ok = dict(input_dim=in_o, units=tuple(u_o), activations="softmax",
              dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    return sks, ok


class Stack:
    """One LGNN in both packages: gnn_tpu's specs (exact body), params and
    statistics, and the port's LGNN holding the same weights."""

    def __init__(self, route, focus, layers, get_state, get_output, nl=NL, threshold=0.01,
                 composite=False, act="selu", optimizer="adam"):
        self.focus, self.gs, self.go = focus, get_state, get_output
        self.opt_cfg = jopt.optimizer_config(optimizer)
        self.js, self.jp, self.jbn, gnns = [], [], [], []
        for layer in range(layers):
            common = dict(focus=focus, max_iteration=K, threshold=threshold)
            if composite:
                sks, ok = composite_layer_kw(focus, layer, get_state, get_output)
                js = jcomp.CompositeGNNSpec(state_specs=tuple(JSpec(**s) for s in sks),
                                            output_spec=JSpec(**ok), **common)
                p, b = jcomp.composite_init(js, jax.random.key(layer))
                model = CompositeGNNgraphBased([TSpec(**s) for s in sks], TSpec(**ok),
                                               optimizer=self.opt_cfg, max_iteration=K,
                                               threshold=threshold, seed=layer, device="cpu")
            else:
                sk, ok = layer_kw(route, focus, layer, get_state, get_output, nl, act)
                js = jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                                   aggregation="blocked", **common)
                p, b = jcore.gnn_init(js, jax.random.key(layer))
                if sk["batch_normalization"]:
                    d = sk["units"][-1]
                    b = {"state": {"mean": jnp.full((d,), 0.05 * (layer + 1)),
                                   "var": jnp.full((d,), 0.7 + 0.1 * layer)}, "output": {}}
                model = TCLASS[focus](TSpec(**sk), TSpec(**ok), optimizer=self.opt_cfg,
                                      max_iteration=K, threshold=threshold, seed=layer,
                                      aggregation="segment" if route == "plain" else "auto",
                                      device="cpu")
            model.set_params(*jax.tree_util.tree_map(np.asarray, (p, b)))
            self.js.append(js)
            self.jp.append(p)
            self.jbn.append(b)
            gnns.append(model)
        self.js, self.jp, self.jbn = tuple(self.js), tuple(self.jp), tuple(self.jbn)
        self.model = LGNN(gnns, get_state, get_output, optimizer=self.opt_cfg,
                          loss_function=LOSS, path_writer="writer/")

    def masks(self, rng, Np, rows_out):
        """gnn_tpu's keep-masks of one training forward of the stack: one key a
        layer (lgnn.py:87), then each layer's gnn_forward chain."""
        return [jax_masks(js, Np, rows_out, key)
                for js, key in zip(self.js, jax.random.split(rng, len(self.js)))]


def jax_masks(js, Np, rows_out, rng):
    """The keep-masks gnn_tpu draws in one layer's training forward:
    (rng, rng_prop, rng_out), then (rng, rng_init, rng_loop) and K step keys;
    a composite net's type t takes fold_in(step key, t); each dropout layer
    split(key)[1] (mlp.py:252-256)."""
    _, rng_prop, rng_out = jax.random.split(rng, 3)
    _, _, rng_loop = jax.random.split(rng_prop, 3)
    steps = jax.random.split(rng_loop, js.max_iteration)

    def keep(key, spec, rows):
        return np.asarray(jax.random.bernoulli(jax.random.split(key)[1],
                                               1.0 - spec.dropout_rate[0],
                                               (rows, spec.input_dim)))

    def state_masks(spec, fold=None):
        if not spec.dropout_rate:
            return {}
        keys = steps if fold is None else [jax.random.fold_in(k, fold) for k in steps]
        return {0: torch.tensor(np.stack([keep(k, spec, Np) for k in keys]))}
    if isinstance(js, jcomp.CompositeGNNSpec):
        state = tuple(state_masks(s, t) for t, s in enumerate(js.state_specs))
    else:
        state = state_masks(js.state_spec)
    out = ({0: torch.tensor(keep(rng_out, js.output_spec, rows_out))}
           if js.output_spec.dropout_rate else {})
    return {"state": state, "output": out}


def rows_out(tb):
    return tb.n_edge_pad if tb.focus == "a" else tb.n_node_pad


def _np(t):
    return t.detach().numpy()


def flip(key, a):
    return a.T if key.endswith("['w']") and "dense_" in key else a


def jax_flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("focus,gs,go", [("n", False, True), ("n", True, False),
                                         ("n", True, True), ("g", True, True),
                                         ("a", False, True), ("a", True, True)])
def test_update_graph_batch_matches_gnn_tpu(focus, gs, go):
    """Widths, the masked output scatter (zero outside set & output masks)
    and the arc augmentation of focus 'a' against gnn_tpu's
    update_graph_batch; the arc-label aggregation is computed on use where
    arc labels were appended (gnn_tpu's always is), the batch's cache kept
    otherwise, and it equals gnn_tpu's agg of the augmented labels."""
    jgs, tgs = graphs(1, focus)
    rng = np.random.default_rng(2)
    for g in jgs + tgs:
        g.set_mask = np.arange(g.set_mask.shape[0]) % 3 != 0
    jb, tb = batches(jgs, tgs, focus)
    state = rng.standard_normal((tb.n_node_pad, NL)).astype(np.float32)
    out = rng.standard_normal((rows_out(tb), DT)).astype(np.float32)
    jn = jlgnn.update_graph_batch(jb, jnp.asarray(state), jnp.asarray(out), get_state=gs,
                                  get_output=go, focus=focus)
    tn = tlgnn.update_graph_batch(tb, torch.tensor(state), torch.tensor(out), get_state=gs,
                                  get_output=go, focus=focus)
    extra_n = NL * gs + DT * go * (focus != "a")
    assert tn.nodes.shape[1] == NL + extra_n and tn.arc_labels.shape[1] == AL + DT * go * (
        focus == "a")
    np.testing.assert_array_equal(_np(tn.nodes), np.asarray(jn.nodes))
    np.testing.assert_array_equal(_np(tn.arc_labels), np.asarray(jn.arc_labels))
    assert jn.agg_arcs_cache is None
    if focus == "a" and go:
        assert tn.agg_arcs_cache is None
    else:
        assert tn.agg_arcs_cache is tb.agg_arcs_cache is not None
    ent = _np(tcore._entity_mask(tb))
    aug = _np(tn.arc_labels)[:, AL:] if focus == "a" else _np(tn.nodes)[:, NL + NL * gs:]
    if go:
        assert (aug[~ent] == 0).all() and np.array_equal(aug[ent], out[ent])
    agg_j = jcore.make_agg_closures(jcore.GNNSpec(
        focus=focus, state_spec=JSpec(input_dim=1, units=(1,)),
        output_spec=JSpec(input_dim=1, units=(1,)), aggregation="segment"), jn)[1]
    np.testing.assert_allclose(_np(tn.agg_arcs()), np.asarray(agg_j(jn.arc_labels)), atol=1e-6)


def _jax_forward(st, jb, rng, training):
    with jax.default_matmul_precision("highest"):
        return jlgnn.lgnn_forward(st.js, st.jp, st.jbn, jb, rng, training, st.gs, st.go)


@pytest.mark.parametrize("route,focus,gs,go,layers", [
    ("hybrid", "n", False, True, 3), ("bn", "g", True, True, 3), ("plain", "a", True, True, 2)])
def test_lgnn_forward_matches_gnn_tpu(route, focus, gs, go, layers):
    """lgnn_forward at eval, layer by layer: realised counts, outputs and the
    last state against gnn_tpu's on the same weights."""
    jgs, tgs = graphs(3, focus)
    jb, tb = batches(jgs, tgs, focus)
    st = Stack(route, focus, layers, gs, go)
    iters_j, outs_j, state_j, _ = _jax_forward(st, jb, jax.random.key(0), False)
    with torch.no_grad():
        iters_t, outs_t, state_t, _ = tlgnn.lgnn_forward(st.model._specs, st.model._params(),
                                                         st.model._bns(), tb, False, gs, go)
    assert [float(i) for i in iters_t] == [float(i) for i in iters_j]
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(_np(state_t), np.asarray(state_j), atol=ATOL)


def _counted(monkeypatch):
    names = {tf: ("propagation_loop", "propagation_step", "propagation_loop_bwd", "train_loop",
                  "train_loop_bwd", "train_step"),
             tf2: ("propagation_loop2", "propagation_step2", "propagation_loop2_bwd",
                   "train_loop2", "train_loop2_bwd"),
             tbn: ("bn_forward_step", "bn_backward_step", "bn2_forward_step",
                   "bn2_backward_step")}
    calls = collections.Counter()
    for mod, fns in names.items():
        for name in fns:
            fn = getattr(mod, name)

            def wrapper(*args, _name=name, _fn=fn, **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)
            monkeypatch.setattr(mod, name, wrapper)
    return calls


# the wrappers each route calls a training step, a layer
ROUTE_CALLS = {"hybrid": {"propagation_loop": 1, "propagation_loop_bwd": 1, "propagation_step": K},
               "dropout": {"train_loop": 1, "train_loop_bwd": 1, "train_step": K},
               "bn": {"bn_forward_step": K, "bn_backward_step": K},
               "hybrid2": {"propagation_loop2": 1, "propagation_loop2_bwd": 1,
                           "propagation_step2": K},
               "dropout2": {"train_loop2": 1, "train_loop2_bwd": 1},
               "bn2": {"bn2_forward_step": K, "bn2_backward_step": K},
               "plain": {}}


def step_against_gnn_tpu(monkeypatch, st, jb, tb, mode, calls_per_layer=None, seed=5,
                         whole_step=False):
    """One step of the port's stack in `mode` against gnn_tpu on the same
    weights and masks: the grads of gnn_tpu's stack loss (_lgnn_train_impl's
    loss_fn) divided by each layer's count, then its optimizer's update, or
    with `whole_step` gnn_tpu's _lgnn_train_impl itself; the moving
    BatchNorm statistics too. Returns the port's grads by (layer, key)."""
    rng = jax.random.key(seed)
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                iters, outs, _, bns = jlgnn.lgnn_forward(st.js, p, st.jbn, jb, rng, True, st.gs,
                                                         st.go)
                loss = jlgnn._lgnn_loss(st.js, LOSS, {}, jb, outs, mode)
                return loss + sum(jlgnn._reg_any(s, pi) for s, pi in zip(st.js, p)), (
                    iters, loss, outs, bns)
            return jax.grad(f, has_aux=True)(p)
        g_j, (iters_j, loss_j, outs_j, bn_j) = grads_fn(st.jp)
    g_j = tuple({**g, "state": jax.tree_util.tree_map(lambda x, it=it: x / max(float(it), 1.0),
                                                     g["state"])}
                for g, it in zip(g_j, iters_j))
    opt = jopt.make_optimizer(st.opt_cfg)
    if whole_step:
        # gnn_tpu's own step (one more compile): its grads' division and update
        with jax.default_matmul_precision("highest"):
            p_j, bn_j, _, iters_s = jlgnn._lgnn_train_impl(
                st.js, st.jp, st.jbn, opt.init(st.jp), jb, rng, loss_name=LOSS,
                loss_args_t=(), optimizer=jopt.freeze_config(st.opt_cfg), mean=True,
                get_state=st.gs, get_output=st.go, training_mode=mode)
        assert [float(i) for i in iters_s] == [float(i) for i in iters_j]
    else:
        updates, _ = opt.update(g_j, opt.init(st.jp), st.jp)
        p_j = jax.tree_util.tree_map(lambda a, b: a + b, st.jp, updates)
    masks = st.masks(rng, tb.n_node_pad, rows_out(tb))
    m = st.model
    m.training_mode = mode
    with torch.no_grad():
        iters_f, outs_f, _, _ = tlgnn.lgnn_forward(m._specs, m._params(), m._bns(), tb, True,
                                                   st.gs, st.go, masks)
    for o_t, o_j in zip(outs_f, outs_j):
        np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=ATOL)
    calls = _counted(monkeypatch)
    out = m.training_step(tb, masks=masks)
    if calls_per_layer is not None:
        want = collections.Counter()
        for c in calls_per_layer:
            want.update(c)
        assert dict(calls) == dict(want)
    assert [float(i) for i in out["iters"]] == [float(i) for i in iters_j]
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    grads = {}
    for layer, (g, jg, jpl) in enumerate(zip(m.gnns, g_j, p_j)):
        want_g, want_p = jax_flat(jg), jax_flat(jpl)
        for key, p in flatten(g.params).items():
            grads[(layer, key)] = p.grad
            np.testing.assert_allclose(flip(key, _np(p.grad)), want_g[key], rtol=2e-4, atol=1e-6,
                                       err_msg=f"layer {layer} grad {key}")
            np.testing.assert_allclose(flip(key, _np(p)), want_p[key], atol=1e-5,
                                       err_msg=f"layer {layer} param {key}")
        want_b = jax_flat(bn_j[layer])
        for key, v in flatten(g.bn).items():
            np.testing.assert_allclose(_np(v), want_b[key], atol=1e-5,
                                       err_msg=f"layer {layer} moving {key}")
    return grads


@pytest.mark.parametrize("route,focus,mode", [
    ("hybrid", "n", "parallel"), ("hybrid", "a", "residual"), ("dropout", "g", "parallel"),
    ("bn", "g", "parallel"), ("hybrid2", "n", "residual"), ("dropout2", "g", "parallel"),
    ("bn2", "g", "residual"), ("plain", "a", "parallel")])
def test_two_layer_stack_trains_each_route_through_its_initial_state(monkeypatch, route,
                                                                       focus, mode):
    """One step of a two-layer stack whose layers take `route`, against
    gnn_tpu: layer 0's grads reach it only through layer 1's initial state
    (the route's gradient into its state, `ds`, and the dep blocks' plain
    backward and block_perm gathers) and its own loss term; each layer calls
    its route's wrappers once a step."""
    jgs, tgs = graphs(4, focus)
    jb, tb = batches(jgs, tgs, focus)
    st = Stack(route, focus, 2, False, True)
    aug = tlgnn.update_graph_batch(tb, None, torch.zeros(rows_out(tb), DT), get_state=False,
                                   get_output=True, focus=focus)
    for model, gb in zip(st.model.gnns, (tb, aug)):
        assert tcore._train_route(model.spec, gb) == WANT_ROUTE.get(route, route)
    grads = step_against_gnn_tpu(monkeypatch, st, jb, tb, mode, [ROUTE_CALLS[route]] * 2,
                                 whole_step=route == "bn")
    assert all(bool(g.abs().sum() > 0) for (layer, _), g in grads.items() if layer == 0)


def test_edge_focus_bn_route_gives_augmented_arc_labels_no_state_gradient(monkeypatch):
    """Focus 'a' with get_output on the BatchNorm route: the augmented arc
    labels enter the state net's feature term without a gradient in both
    packages (gnn_tpu's BN loop returns a zero cotangent for its features,
    pallas_bn.py:538; the port's _BNTrainLoop none). gnn_tpu's exact body is
    held to that by a batch whose arc-label aggregation is cached with its
    gradient stopped, which the readout's arc labels keep."""
    jgs, tgs = graphs(6, "a")
    jb, tb = batches(jgs, tgs, "a")
    st = Stack("bn", "a", 2, False, True)
    update = jlgnn.update_graph_batch

    def stopped(gb, *args, **kwargs):
        new = update(gb, *args, **kwargs)
        agg = jcore.make_agg_closures(st.js[0], new)[1]
        return new.replace(agg_arcs_cache=jax.lax.stop_gradient(agg(new.arc_labels)))
    monkeypatch.setattr(jlgnn, "update_graph_batch", stopped)
    step_against_gnn_tpu(monkeypatch, st, jb, tb, "parallel", [ROUTE_CALLS["bn"]] * 2)


@pytest.mark.parametrize("mode", ["parallel", "residual"])
def test_composite_stack_matches_gnn_tpu(monkeypatch, mode):
    """A stack of composite layers (three node types, BatchNorm-free: the
    plain body in both packages) against gnn_tpu, per-type masks drawn along
    gnn_tpu's chain."""
    rng = np.random.default_rng(7)
    jgs, tgs = [], []
    for i in range(5):
        g = tdata.random_graph(int(rng.integers(8, 20)) if i != 2 else 70, NL, AL, DT,
                               0.5 if i != 2 else 0.15, focus="g", rng=rng)
        types = rng.integers(0, 3, g.n_nodes).astype(np.int32)
        jgs.append(JGraph(g.arcs, g.nodes, g.targets, focus="g", node_types=types))
        tgs.append(TGraph(g.arcs, g.nodes, g.targets, focus="g", node_types=types))
    jb, tb = batches(jgs, tgs, "g")
    st = Stack(None, "g", 2, True, True, composite=True)
    step_against_gnn_tpu(monkeypatch, st, jb, tb, mode)


def test_stack_crossing_width_64_matches_gnn_tpu(monkeypatch):
    """get_state and get_output grow the labels 30 -> 62 -> 94: the last
    layer takes the kernels' wide plans on the card; here its route's plain
    versions against gnn_tpu's exact body."""
    nl = 30
    jgs, tgs = graphs(8, "g", nl=nl, n=4)
    jb, tb = batches(jgs, tgs, "g")
    st = Stack("hybrid", "g", 3, True, True, nl=nl, act="tanh")
    assert [m.spec.state_spec.units[-1] for m in st.model.gnns] == [30, 62, 94]
    step_against_gnn_tpu(monkeypatch, st, jb, tb, "parallel", [ROUTE_CALLS["hybrid"]] * 3)


@pytest.mark.parametrize("focus", ["n", "a", "g"])
def test_serial_epoch_matches_gnn_tpu(tmp_path, focus):
    """training_mode='serial': each layer's GNN trains an epoch with its own
    optimizer and writer folder (namespace 'LGNN - GNN{i}'), the next layer
    on the batch augmented by its eval outputs (arc labels for focus 'a'),
    against gnn_tpu's LGNN.train (dropout-free nets, so no masks)."""
    jgs, tgs = graphs(9, focus)
    jb, tb = batches(jgs, tgs, focus)
    jgnns, tgnns = [], []
    for layer in range(3):
        sk, ok = layer_kw("hybrid", focus, layer, False, True)
        ok.pop("dropout_rate"), ok.pop("dropout_pos")
        jm = JCLASS[focus](JSpec(**sk), JSpec(**ok), loss_function=LOSS, max_iteration=K,
                           aggregation="blocked", seed=layer,
                           path_writer=str(tmp_path / f"j{layer}"))
        tm = TCLASS[focus](TSpec(**sk), TSpec(**ok), loss_function=LOSS, max_iteration=K,
                           seed=layer, device="cpu", path_writer=str(tmp_path / f"t{layer}"))
        tm.set_params(*jax.tree_util.tree_map(np.asarray, (jm.params, jm.bn)))
        jgnns.append(jm)
        tgnns.append(tm)
    jl = gnn_tpu.LGNN(jgnns, False, True, loss_function=LOSS, path_writer=str(tmp_path / "jw"))
    tl = LGNN(tgnns, False, True, loss_function=LOSS, path_writer=str(tmp_path / "tw"))
    with jax.default_matmul_precision("highest"):
        jl.train(jb, 2, update_freq=1, training_mode="serial", verbose=0)
    tl.train(tb, 2, update_freq=1, training_mode="serial", verbose=0)
    for jm, tm in zip(jgnns, tgnns):
        want = jax_flat(jm.params)
        for key, p in flatten(tm.params).items():
            np.testing.assert_allclose(flip(key, _np(p)), want[key], atol=1e-5, err_msg=key)
        np.testing.assert_allclose(tm.history["Loss Tr"], jm.history["Loss Tr"], rtol=1e-5)
        assert tm.namespace == jm.namespace and tm.path_writer.endswith(
            f"tw/{tm.namespace[0]}/")
        assert os.path.exists(os.path.join(tm.path_writer, "Training.jsonl"))
    assert tl.training_mode == "serial"


# ------------------------------------------------------------------- model
def small_stack(tmp_path, focus="g", seed=0):
    jgs, tgs = graphs(10 + seed, focus)
    st = Stack("dropout", focus, 3, False, True)
    st.model.path_writer = str(tmp_path / "w") + "/"
    return jgs, tgs, st


def test_predict_sticky_mode_mixed_types_and_copy(tmp_path):
    """predict(idx) returns the layers' eval rows; the training mode is
    sticky once train() set it; layers of mixed classes are refused; copy
    keeps the weights and the configuration."""
    jgs, tgs, st = small_stack(tmp_path)
    m = st.model
    tb = m.to_batch(tgs, block_w=32)
    outs = m.predict(tb, "all")
    assert len(outs) == 3 and np.array_equal(m.predict(tb, 1), outs[1])
    assert np.array_equal(m.predict(tb), outs[-1]) and np.array_equal(m(tb), outs[-1])
    assert [np.array_equal(a, b) for a, b in zip(m.predict(tb, [2, 0]), (outs[0], outs[2]))] \
        == [True, True]
    for bad in (3, [0, 5], "some"):
        with pytest.raises(ValueError):
            m.predict(tb, bad)
    m.train(tb, 1, update_freq=1, training_mode="residual", verbose=0)
    with pytest.raises(ValueError, match="sticky"):
        m.train(tb, 1, training_mode="parallel", verbose=0)
    with pytest.raises(ValueError, match="training_mode"):
        m.train(tb, 1, training_mode="other", verbose=0)
    with pytest.raises(TypeError, match="same type"):
        LGNN([m.gnns[0], GNNnodeBased(m.gnns[1].spec.state_spec, m.gnns[1].spec.output_spec,
                                      device="cpu")], False, True)
    c = m.copy(path_writer=str(tmp_path / "c"))
    assert c.namespace == ["LGNN - GNN0", "LGNN - GNN1", "LGNN - GNN2"]
    for a, b in zip(c.predict(tb, "all"), m.predict(tb, "all")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="M11"):
        m.train(tb, 1, training_mode="residual", verbose=0, mesh=object())
    with pytest.raises(NotImplementedError, match="M11"):
        tlgnn.make_lgnn_dp_train_step(m._specs, LOSS, {}, {}, None)


def test_save_loads_in_gnn_tpu_and_back(tmp_path):
    """The port's save folder loads in gnn_tpu's LGNN with the same weights
    and eval outputs, and gnn_tpu's loads in the port."""
    jgs, tgs, st = small_stack(tmp_path)
    m = st.model
    tb = m.to_batch(tgs, block_w=32)
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    m.training_step(tb)
    m.save(str(tmp_path / "m"))
    jm = gnn_tpu.LGNN.load(str(tmp_path / "m"), path_writer=str(tmp_path / "jw"))
    assert [sorted(os.listdir(tmp_path / "m"))] == [["GNN0", "GNN1", "GNN2", "config.json"]]
    with jax.default_matmul_precision("highest"):
        specs = tuple(dataclasses.replace(s, aggregation="blocked") for s in jm._specs)
        _, outs_j, _, _ = jlgnn.lgnn_forward(specs, jm._params(), jm._bns(), jb,
                                             jax.random.key(0), False, False, True)
    _, _, outs_t = m.Loop(tb)
    sel = _np(tb.sel_mask)
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_allclose(o_t, np.asarray(o_j)[sel], atol=ATOL)
    jm.save(str(tmp_path / "j"))
    back = LGNN.load(str(tmp_path / "j"), path_writer=str(tmp_path / "bw"), device="cpu")
    assert back.namespace == m.namespace and back.get_output and not back.get_state
    for a, b in zip(back.Loop(tb)[2], outs_t):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "j" / "config.json") as f:
        assert json.load(f)["gnns_type"] == "g"


def test_checkpoints_cross_both_ways(tmp_path):
    """An LGNN checkpoint holds the layers' tuple and the stack optimizer's
    state in gnn_tpu's layout: the port's loads in gnn_tpu's LGNN (params,
    Adam moments) and gnn_tpu's in the port; a resumed port model takes the
    step an uninterrupted one takes."""
    jgs, tgs, st = small_stack(tmp_path)
    m = st.model
    tb = m.to_batch(tgs, block_w=32)
    m.training_step(tb)
    m.save_checkpoint(str(tmp_path / "ck"))
    jm = gnn_tpu.LGNN([gnn_tpu.GNNgraphBased(JSpec.from_config(s.state_spec.to_config()),
                                             JSpec.from_config(s.output_spec.to_config()),
                                             max_iteration=K, path_writer=str(tmp_path / "x"))
                       for s in m._specs], False, True, path_writer=str(tmp_path / "jw"))
    jm.load_checkpoint(str(tmp_path / "ck"))
    want = jax_flat(jm._params())
    for key, p in flatten(m._params()).items():
        np.testing.assert_array_equal(flip(key, _np(p)), want[key])
    mu = jax_flat(jm.opt_state[0].mu)
    for key, p in flatten(m._params()).items():
        np.testing.assert_array_equal(flip(key, _np(m._opt.state[p]["mu"])), mu[key])
    assert int(jm.opt_state[0].count) == 1
    jm.save_checkpoint(str(tmp_path / "jck"))
    fresh = small_stack(tmp_path, seed=1)[2].model
    fresh.load_checkpoint(str(tmp_path / "jck"))
    for key, p in flatten(fresh._params()).items():
        np.testing.assert_array_equal(_np(p), _np(flatten(m._params())[key]))
    masks = tlgnn.draw_masks(m._specs, tb, torch.Generator().manual_seed(0))
    m.training_step(tb, masks=masks)
    fresh.training_step(tb, masks=masks)
    for key, p in flatten(fresh._params()).items():
        np.testing.assert_allclose(_np(p), _np(flatten(m._params())[key]), atol=1e-7)


def test_predictor_serves_an_lgnn_as_gnn_tpu():
    """Predictor(lgnn) gives gnn_tpu's Predictor's rows (the last layer's),
    split per graph, for a request and a single graph; last_iters lists the
    layers' counts."""
    jgs, tgs = graphs(12, "g")
    st = Stack("hybrid2", "g", 3, False, True)
    jm = gnn_tpu.LGNN([gnn_tpu.GNNgraphBased(JSpec.from_config(s.state_spec.to_config()),
                                             JSpec.from_config(s.output_spec.to_config()),
                                             max_iteration=K, path_writer="writer/")
                       for s in st.model._specs], False, True, path_writer="writer/")
    for g, p, b in zip(jm.gnns, st.jp, st.jbn):
        g.params, g.bn = p, b
    want = JPredictor(jm, block_w=32).predict(jgs)
    pred = Predictor(st.model, block_w=32, device="cpu")
    got = pred.predict(tgs)
    assert len(got) == len(want) == len(tgs)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=ATOL)
    assert len(pred.stats["last_iters"]) == 3
    np.testing.assert_allclose(pred.predict(tgs[2]), want[2], atol=ATOL)


def test_lko_passes_the_training_mode(tmp_path, monkeypatch):
    """LKO(training_mode=...) trains each fold's fresh copy in that mode and
    tests it: one entry a fold, finite."""
    from gnn_tpu_torch.graphs.utils import prepare_LKO_data
    _, tgs, st = small_stack(tmp_path)
    modes = []
    train = LGNN.train

    def record(self, *args, **kwargs):
        modes.append(kwargs.get("training_mode"))
        return train(self, *args, **kwargs)
    monkeypatch.setattr(LGNN, "train", record)
    folds = prepare_LKO_data(tgs, focus="g", number_of_batches=3, useVa=True, seed=0)
    res = st.model.LKO(folds, epochs=1, training_mode="serial", update_freq=1, verbose=0)
    assert modes == ["serial"] * 3
    assert all(len(v) == 3 and np.all(np.isfinite(v)) for v in res.values())


def test_starter_random_graph_branch(monkeypatch, tmp_path):
    """gnn_tpu_torch/starter.py with use_MUTAG = False on the CPU: the random
    dataset gnn_tpu's starter draws for the same seed, its splits and
    batches, the single GNN and the 5-layer LGNN (the reference's default
    state net: selu, AlphaDropout 0.1 and BatchNorm, softmax readout with
    dropout), which trains a step and serves; the objects are built at
    their first access, not at import."""
    import gnn_tpu_torch.starter as starter
    monkeypatch.setenv("GNN_TPU_TORCH_CPU", "1")
    for name, value in (("use_MUTAG", False), ("graphs_number", 12), ("seed", 3),
                        ("batch_size", 4), ("path_writer", str(tmp_path) + "/"),
                        ("_built", {})):
        monkeypatch.setattr(starter, name, value)
    lgnn, gTr, gnn = starter.lgnn, starter.gTr, starter.gnn
    assert starter._built["lgnn"] is lgnn and lgnn.LAYERS == 5 and len(gTr) == 3
    rng = np.random.default_rng(3)
    want = [jdata.random_graph(int(rng.integers(15, 40)), 3, 1, 2, 0.7, focus="n", rng=rng)
            for _ in range(12)]
    for g, w in zip(starter.graphs, want):
        np.testing.assert_array_equal(g.arcs, w.arcs)
        np.testing.assert_array_equal(g.targets, w.targets)
    assert gnn.device.type == "cpu" and gnn.path_writer == f"{tmp_path}/GNN_single/"
    assert [m.spec.state_spec.input_dim for m in lgnn.gnns] == [7, 11, 11, 11, 11]
    out = lgnn.training_step(lgnn.to_batch(gTr[0]))
    assert torch.isfinite(out["loss"]) and out["iters"].shape == (5,)
    assert lgnn.predict(starter.gTe).shape[1] == 2


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case,passes", [("close", True), ("norm_within", True),
                                         ("norm_beyond", False), ("no_cpu_miss", False),
                                         ("param_tiny_grad", True), ("param_large_grad", False),
                                         ("not_fed", False), ("serial_other_layer", False),
                                         ("switched", True), ("switched_no_flip", False),
                                         ("kink_witness", True), ("param_replay", True),
                                         ("param_replay_off", False)])
def test_chip_smoke_holds_a_stack_to_float64(case, passes):
    """chip_smoke.py::hold_stack, which adjudicates the card's LGNN steps:
    a grad tensor off the CPU's and float64's elementwise bound passes if it
    meets that bound against the float64 step along the card's own
    derivative branches (its recorded readout pre-activations on the other
    side of the kink than float64's), or in the bound's norm form where the
    CPU's float32 step, or else the float64 step with the state nets' units
    within the card's rounding of the kink switched, misses float64 in a
    tensor whose reverse feeds it (the layers above and its own readout; in a
    serial epoch its own layer's only); a param tensor off the CPU's by more than 1e-5 passes if it is
    within 1e-5 of float64, or if the card's grads meet their bound against
    float64 and either the CPU's is off float64 too or the card is within
    1e-5 of the optimizer's float64 update on the card's own grads (an entry
    whose gradient is within rounding of 0, where Adam's step is decided by
    the gradient's rounding and the CPU's float32 step happened to escape)."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    keys = ("[0]['state']['dense_0']['w']", "[0]['state']['dense_0']['b']",
            "[0]['output']['dense_0']['w']", "[1]['output']['dense_0']['w']")
    g64 = {k: torch.randn(s, generator=gen, dtype=torch.float64) * c
           for k, s, c in zip(keys, ((5, 7), (5,), (4, 5), (2, 7)), (3.0, 0.1, 1.0, 1.0))}
    p64 = {k: torch.randn(v.shape, generator=gen, dtype=torch.float64) for k, v in g64.items()}
    g64[keys[3]].view(-1)[3] = 1e-9
    pre64 = [("selu", torch.linspace(-1, 1, 9, dtype=torch.float64))]
    g_sw = {k: v.clone() for k, v in g64.items()}
    g_sw[keys[2]][:, 1] += 0.5          # one readout unit's other derivative branch

    def run(noise, grads=g64):
        g = {k: (v + noise * v.abs().max() * torch.randn(v.shape, generator=gen,
                                                          dtype=torch.float64)).float()
             for k, v in grads.items()}
        return {"grads": g, "params": {k: v.float() for k, v in p64.items()}}
    cpu = run(1e-7)
    off = {"close": None, "no_cpu_miss": None, "kink_witness": None, "not_fed": keys[0],
           "serial_other_layer": keys[3]}.get(case, keys[3])
    if off is not None:
        cpu["grads"][off] = cpu["grads"][off] + 1e-3 * g64[off].abs().max().float()
    card = {"close": run(1e-8), "norm_within": run(3e-5), "norm_beyond": run(3e-3),
            "no_cpu_miss": run(3e-5), "kink_witness": run(3e-5), "param_tiny_grad": run(1e-8),
            "param_large_grad": run(1e-8), "switched": run(1e-8, g_sw),
            "switched_no_flip": run(1e-8, g_sw)}.get(case)
    if card is None:                    # a miss in a layer-0 readout
        card = run(1e-8)
        card["grads"][keys[2]] = card["grads"][keys[2]] + 3e-5 * torch.randn(
            g64[keys[2]].shape, generator=gen)
    if case.startswith("param"):        # entry 3's grad is ~0, entry 4's is not
        idx = 3 if case == "param_tiny_grad" else 4
        card["params"][keys[3]].view(-1)[idx] += 2e-3
        if case == "param_tiny_grad":
            cpu["params"][keys[3]].view(-1)[idx] -= 2e-3
    replay = None
    if case.startswith("param_replay"):
        # the params of one Adam step from `before`: float64's on g64, the
        # card's on its own grads (entry 3's, ~0 in float64, moves by a share
        # of lr that its rounding decides), the CPU's float64's
        before = {k: torch.randn(v.shape, generator=gen, dtype=torch.float64)
                  for k, v in g64.items()}
        p64.update(cs.update64(torch, before, g64, "adam"))
        cpu["params"] = {k: v.float() for k, v in p64.items()}
        card["params"] = {k: v.float() for k, v in
                          cs.update64(torch, before, card["grads"], "adam").items()}
        if case == "param_replay_off":
            card["params"][keys[3]].view(-1)[4] += 2e-5
        replay = lambda: cs.update64(torch, before, card["grads"], "adam")      # noqa: E731
    pre = [("selu", pre64[0][1].float().clone())]
    pre[0][1][0] += 1e-7                # the card's rounding
    if case == "switched":
        pre[0][1][4] = -1e-8            # the card's unit 4 left of the kink, float64's at 0+
        pre64[0][1][4] = 1e-12
    called = []
    near = {k: v.clone() for k, v in g64.items()}      # the state nets' near-kink units switched
    if case == "kink_witness":
        near[keys[3]] += 1e-3 * g64[keys[3]].abs().max()

    def twin_of(switch, band=None):
        called.append(switch)
        if band is not None:
            assert 0 < band < 1e-6
            return {"params": p64, "grads": near, "pre": pre64, "switched": 3}
        if switch is None:
            return {"params": p64, "grads": g64, "pre": pre64}
        assert [int(f.sum()) for f in switch] == [1] and bool(switch[0][4])
        return {"params": p64, "grads": g_sw, "pre": pre64}
    serial = case == "serial_other_layer"
    if case == "param_replay":
        miss = (card["params"][keys[3]].double() - p64[keys[3]]).abs() > 1e-5
        assert miss.view(-1)[3] and not miss.view(-1)[4]    # the case is what it says
    if passes:
        cs.hold_stack(torch, case, card, cpu, pre, twin_of, serial=serial, replay=replay)
        assert len(called) == {"close": 0, "switched": 2, "kink_witness": 2}.get(case, 1)
    else:
        with pytest.raises(SystemExit):
            cs.hold_stack(torch, case, card, cpu, pre, twin_of, serial=serial, replay=replay)
