"""aggregation='fused' and the typed kernels on blocked batches without the
loop/dep layout, against gnn_tpu on the CPU.

Such a batch (from_graphs_blocked(..., fused_layout=False), the default, or
fused_layout=True when every block touches a residual arc) carries the
all-dep layout of graphs/batch.py: every block a dep block. gnn_tpu runs its
per-step fused path on it (gnn_tpu/models/core.py:610-643, :880-927; the BN
kernels over adj_blocks), and the port the same routes with no loop blocks:

    state net   eval             training
    one layer   K4 every step    clean K4 (plain backward); dropout K6 per
                                 step; BatchNorm K1/K2
    two layers  K9 every step    clean K9 (plain backward); dropout the plain
                                 body (as gnn_tpu); BatchNorm K14/K15

Composite models run K16 (eval) and K16/K17 (BatchNorm training) there, as
gnn_tpu does on every block-dense batch. 'auto' stays on the plain body.

Held to gnn_tpu's exact f32 body (aggregation='blocked', highest matmul
precision) at the contract's tolerances: iteration counts equal, states and
outputs atol 3e-5, the loss rtol 1e-5, grads rtol 2e-4 (atol 1e-6), params
after one Adam step and moving statistics atol 1e-5, with the keep-masks
gnn_tpu draws; eval also against gnn_tpu's own 'fused' route (Pallas in
interpret mode, its bf16 hi/lo emulation) at gnn_tpu's 2e-4.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs import datasets as jdata
from gnn_tpu.models import composite as jcomp
from gnn_tpu.models import core as jcore
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops import typed as ttyped
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_composite import (check_step_against_gnn_tpu, composite_specs, composite_weights,
                                  typed_graphs)
from test_torch_training import _graphs, _jax_masks

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
ATOL = 3e-5
KERNEL_TOL = 2e-4
K = 4
KINDS = ("no_layout", "no_loop_block")
WRAPPERS = {tf: ("propagation_loop", "propagation_step", "train_loop", "train_step"),
            tf2: ("propagation_loop2", "propagation_step2", "train_loop2"),
            tbn: ("bn_forward_step", "bn_backward_step", "bn2_forward_step", "bn2_backward_step")}


def _big_graphs(seed, typed_T=0):
    """Both packages' graphs from one seed: three graphs of 40, 50 and 70
    nodes, each over 32 nodes, so that at block_w=32 every block touches a
    residual arc and no loop block exists; node types in range(typed_T)."""
    out = ([], [])
    for mod, lst in zip((jdata, tdata), out):
        rng = np.random.default_rng(seed)
        for n in (40, 50, 70):
            g = mod.random_graph(n, 5, 3, 2, 0.2, focus="g", rng=rng)
            if typed_T:
                g = type(g)(g.arcs, g.nodes, g.targets, focus="g",
                            node_types=rng.integers(0, typed_T, n).astype(np.int32))
            lst.append(g)
    return out


def flat_batches(kind, seed=0, typed_T=0):
    """(gnn_tpu batch, port batch) without the loop/dep layout: 'no_layout'
    packs test_torch_training's graphs (loop-capable blocks, one 70-node
    graph over several blocks) with fused_layout=False; 'no_loop_block'
    packs _big_graphs with fused_layout=True."""
    if kind == "no_layout":
        jgs, tgs = typed_graphs(seed, typed_T) if typed_T else _graphs(seed)
    else:
        jgs, tgs = _big_graphs(seed, typed_T)
    fl = kind == "no_loop_block"
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=fl)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=fl)
    assert jb.adj_loop is None and tb.adj_loop is None and jb.adj_blocks is not None
    assert int(np.count_nonzero(np.asarray(jb.res_w))) > 0          # residual arcs exist
    return jb, tb


def _np(t):
    return t.detach().numpy()


def _counted(monkeypatch):
    calls = collections.Counter()
    for mod, names in WRAPPERS.items():
        for name in names:
            fn = getattr(mod, name)

            def wrapper(*args, _name=name, _fn=fn, **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)
            monkeypatch.setattr(mod, name, wrapper)
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_all_dep_layout_fields_match_gnn_tpu(kind):
    """The all-dep layout: adj_dep is gnn_tpu's adj_blocks transposed, every
    block a dep block in order, block_perm the identity, the residual arcs
    gnn_tpu's res_src/res_dst in global ids, the rest of the batch gnn_tpu's."""
    jb, tb = flat_batches(kind)
    B = tb.n_node_pad // 32
    np.testing.assert_array_equal(tb.adj_dep.numpy(),
                                  np.asarray(jb.adj_blocks).transpose(0, 2, 1))
    np.testing.assert_array_equal(tb.dep_ids.numpy(), np.arange(B))
    np.testing.assert_array_equal(tb.block_perm.numpy(), np.arange(B))
    Er = tb.res_w.shape[0]
    n_res = int(np.asarray(jb.res_src).shape[0])
    for got, want in ((tb.res_src_loc, jb.res_src), (tb.res_dst_loc, jb.res_dst)):
        np.testing.assert_array_equal(got.numpy()[:n_res], np.asarray(want))
        assert not got.numpy()[n_res:Er].any()
    np.testing.assert_array_equal(tb.res_w.numpy(), np.asarray(jb.res_w))
    assert tb.loop_ids is None and tb.loop_nm is None
    for f in ("nodes", "node_mask", "src", "dst", "edge_w", "targets", "out_index"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))


def _net_kw(layers, drop, bn):
    """State net 13 -> (16 ->) 5 (selu, tanh at the second layer), AlphaDropout
    `drop` at its input, the trailing BatchNorm when `bn`; a softmax readout
    with dropout."""
    sdrop = dict(dropout_rate=(drop,), dropout_pos=(0,), alphadropout=True) if drop else {}
    units, acts = ((5,), "selu") if layers == 1 else ((16, 5), ("selu", "tanh"))
    sk = dict(input_dim=13, units=units, activations=acts, kernel_initializer="lecun_normal",
              bias_initializer="lecun_normal", batch_normalization=bn, **sdrop)
    ok = dict(input_dim=5, units=(2,), activations="softmax", kernel_initializer="glorot_normal",
              bias_initializer="glorot_normal", dropout_rate=(0.1,), dropout_pos=(0,),
              batch_normalization=False)
    return sk, ok


def _weights(js, bn):
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    if bn:
        jbn = {"state": {"mean": jnp.full((5,), 0.1), "var": jnp.full((5,), 0.7)}, "output": {}}
    return jp, jbn


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layers,threshold,bn", [(1, 0.01, True), (1, 0.4, False),
                                                 (2, 0.01, False), (2, 0.4, True)])
def test_fused_eval_on_flat_batches_matches_gnn_tpu(monkeypatch, kind, layers, threshold, bn):
    """'fused' at eval: K4 (one layer) or K9 (two layers) over every block
    each iteration, against gnn_tpu's exact body and its own per-step fused
    path (interpret mode)."""
    jb, tb = flat_batches(kind)
    sk, ok = _net_kw(layers, 0.1, bn)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=6, threshold=threshold, aggregation="fused")
    jp, jbn = _weights(js, bn)
    with jax.default_matmul_precision("highest"):
        body = jcore.gnn_forward(dataclasses.replace(js, aggregation="blocked"), jp, jbn, jb,
                                 jax.random.key(1))
    kern = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(1))
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=6, threshold=threshold,
                          aggregation="fused", seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    assert tcore._eval_route(model.spec, tb) == ("hybrid" if layers == 1 else "hybrid2")
    calls = _counted(monkeypatch)
    rt = model.forward(tb)
    assert dict(calls) == {"propagation_step" if layers == 1 else "propagation_step2": 6}
    assert float(rt["iters"]) == float(body["iters"]) == float(kern["iters"])
    for key in ("state", "out"):
        np.testing.assert_allclose(_np(rt[key]), np.asarray(body[key]), atol=ATOL)
        np.testing.assert_allclose(_np(rt[key]), np.asarray(kern[key]), atol=KERNEL_TOL)


# route, layers, input dropout, BatchNorm, the wrappers a training step calls
TRAIN_CASES = [
    ("hybrid", 1, 0.0, False, {"propagation_step": K}),
    ("dropout", 1, 0.15, False, {"train_step": K}),
    ("bn", 1, 0.15, True, {"bn_forward_step": K, "bn_backward_step": K}),
    ("hybrid2", 2, 0.0, False, {"propagation_step2": K}),
    ("plain", 2, 0.1, False, {}),
    ("bn", 2, 0.1, True, {"bn2_forward_step": K, "bn2_backward_step": K}),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route,layers,drop,bn,expect", TRAIN_CASES,
                         ids=[f"{c[0]}{c[1]}" for c in TRAIN_CASES])
def test_fused_training_step_on_flat_batches_matches_gnn_tpu(monkeypatch, kind, route, layers,
                                                             drop, bn, expect):
    """One optimizer step of a 'fused' spec on each route of the table in
    the module docstring against gnn_tpu's make_train_step on its exact body,
    with the masks gnn_tpu draws: iteration count, states, loss, grads,
    params and BatchNorm statistics."""
    jb, tb = flat_batches(kind)
    sk, ok = _net_kw(layers, drop, bn)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=0.01, aggregation="blocked")
    jp, jbn = _weights(js, bn)
    rng = jax.random.key(3)
    opt_cfg = jopt.optimizer_config("adam")
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                iters, loss, res = jcore.evaluate_single(js, p, jbn, jb, rng, LOSS, {},
                                                         training=True)
                return loss + jcore.regularization(js, p), (iters, loss, res)
            return jax.grad(f, has_aux=True)(p)

        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
        step = jcore.make_train_step(js, LOSS, {}, opt_cfg, mean=True)
        p_j, bn_j, _, iters_s = step(jp, jbn, jopt.make_optimizer(opt_cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    assert float(iters_s) == float(iters_j)

    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=opt_cfg, max_iteration=K,
                          threshold=0.01, aggregation="fused", seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    masks = _jax_masks(js, tb.n_node_pad, rng)
    assert tcore._train_route(model.spec, tb) == route
    with torch.no_grad():
        _, _, res_t = tcore.evaluate_single(model.spec, model.params, model.bn, tb, LOSS, {},
                                            training=True, masks=masks)
    calls = _counted(monkeypatch)
    out = model.training_step(tb, mean=True, masks=masks)
    assert dict(calls) == expect
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(_np(res_t["state"]), np.asarray(res_j["state"]), atol=ATOL)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for key, v in model.bn["state"].items():
        np.testing.assert_allclose(_np(v), np.asarray(bn_j["state"][key]), atol=1e-5)
    assert sorted(model.bn["state"]) == sorted(bn_j["state"])
    for net in ("state", "output"):
        for name, leaves in model.params[net].items():
            for k, p in leaves.items():
                flip = (lambda a: a.T) if k == "w" else (lambda a: a)
                np.testing.assert_allclose(flip(_np(p.grad)), np.asarray(g_j[net][name][k]),
                                           rtol=2e-4, atol=1e-6, err_msg=f"grad {net}/{name}/{k}")
                np.testing.assert_allclose(flip(_np(p)), np.asarray(p_j[net][name][k]),
                                           atol=1e-5, err_msg=f"param {net}/{name}/{k}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["eval", "typed_bn"])
def test_composite_on_flat_batches_matches_gnn_tpu(monkeypatch, kind, mode):
    """Composite models on such batches route K16 (eval) and K16/K17 (BN
    training) as gnn_tpu does on every block-dense batch: the eval forward
    against gnn_tpu's typed kernels (interpret) and its XLA body, one
    training step against gnn_tpu's XLA body."""
    T = 3
    jb, tb = flat_batches(kind, seed=5, typed_T=T)
    js, ts = composite_specs(T)
    (jp, jbn), (tp, tbn_) = composite_weights(js)
    if mode == "eval":
        assert tcomp._route(ts, tb, False) == "typed_eval"
        calls = collections.Counter()
        fwd = ttyped.bnT_forward_step

        def counted(*a, **k):
            calls["bnT_forward_step"] += 1
            return fwd(*a, **k)
        monkeypatch.setattr(ttyped, "bnT_forward_step", counted)
        got = tcomp.composite_forward(ts, tp, tbn_, tb)
        assert dict(calls) == {"bnT_forward_step": ts.max_iteration}
        kern = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(0))
        monkeypatch.setenv("GNN_TPU_FUSED_BN", "0")
        body = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(0))
        assert float(got["iters"]) == float(kern["iters"]) == float(body["iters"])
        for key in ("state", "out"):
            np.testing.assert_allclose(_np(got[key]), np.asarray(body[key]), atol=ATOL)
            np.testing.assert_allclose(_np(got[key]), np.asarray(kern[key]), atol=KERNEL_TOL)
    else:
        monkeypatch.setenv("GNN_TPU_FUSED_BN", "0")
        check_step_against_gnn_tpu(js, jp, jbn, jb, ts, tb, jax.random.key(5),
                                   expect_route="typed_bn")


@pytest.mark.parametrize("kind", KINDS)
def test_auto_stays_plain_on_flat_batches(kind):
    """'auto' finds no loop layout on such a batch and runs the plain body in
    eval and training, as gnn_tpu's (core.py:354); 'fused' takes the kernel
    routes; a batch without blocks stays plain for composite models."""
    jb, tb = flat_batches(kind)
    for layers, drop, bn, fused_eval, fused_train in (
            (1, 0.15, True, "hybrid", "bn"), (1, 0.0, False, "hybrid", "hybrid"),
            (2, 0.1, False, "hybrid2", "plain"), (2, 0.1, True, "hybrid2", "bn")):
        sk, ok = _net_kw(layers, drop, bn)
        spec = tcore.GNNSpec(focus="g", state_spec=TSpec(**sk), output_spec=TSpec(**ok),
                             max_iteration=K)
        assert (tcore._eval_route(spec, tb), tcore._train_route(spec, tb)) == ("plain", "plain")
        fused = dataclasses.replace(spec, aggregation="fused")
        assert (tcore._eval_route(fused, tb), tcore._train_route(fused, tb)) == (
            fused_eval, fused_train)
    _, ts = composite_specs(2)
    jgs, tgs = typed_graphs(3, 2)
    assert tcomp._route(ts, tbatch.GraphBatch.from_graph(TGraph.merge(tgs)), False) == "plain"
    assert tcomp._route(ts, tbatch.from_graphs_blocked(tgs, block_w=32), True) == "typed_bn"
