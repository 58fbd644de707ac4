"""state_dim > 0 in gnn_tpu_torch against gnn_tpu, on the CPU.

With state_dim > 0 (the reference's separate state) the state starts at
0.1 * N(0, 1) on the real nodes and the state net reads [state | labels |
Σstate | Σlabels | Σarcs]; the port's kernels take it by folding the labels
and the two aggregations into their feature term (ops/fold.py). The same
numpy-seeded graphs and gnn_tpu's weights go through both packages, the
port given gnn_tpu's own initial state and keep-masks along its key chain
(torch cannot replay JAX's PRNG). State width 5 is odd and differs from the
label width 4.

Every route is held to gnn_tpu's exact f32 body (aggregation='blocked',
highest matmul precision; its plain reference of the kernels), as
tests/test_torch_training.py does; 'pallas' to gnn_tpu's K18 in interpret
mode. Tolerances are ROADMAP's exactness
contract: iteration counts equal, states and outputs within 3e-5, the loss
within rtol 1e-5, grads within rtol 2e-4 with a floor of 2e-5 of each
tensor's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnn_tpu
from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs.graph import Graph as JGraph
from gnn_tpu.models import composite as jcomp
from gnn_tpu.models import core as jcore
from gnn_tpu.models import lgnn as jlgnn
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch import LGNN, CompositeGNNgraphBased, GNNgraphBased, Predictor
from gnn_tpu_torch.convert import flatten, params_from_jax, params_to_jax
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.graphs.graph import Graph as TGraph
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.models import lgnn as tlgnn
from gnn_tpu_torch.ops import fold as tfold
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec

torch.set_num_threads(1)
NL, AL, DT, SD, K, T = 4, 3, 2, 5, 4, 3
LOSS = "categorical_crossentropy"
ATOL = 3e-5
# each route's state net: (hidden units, input dropout rate, BatchNorm)
NETS = {"hybrid": ((), 0.0, False), "hybrid_bn": ((), 0.1, True), "dropout": ((), 0.1, False),
        "bn": ((), 0.1, True), "hybrid2": ((7,), 0.0, False), "dropout2": ((7,), 0.1, False),
        "bn2": ((7,), 0.1, True)}


def graphs(seed, focus="g", n=4, types=None):
    """Both packages' graphs from one seed: n graphs of 8-19 nodes and a
    70-node one spanning several 32-node blocks (dep blocks, residual arcs);
    with `types`, node types uniform over range(types)."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(8, 20)) for _ in range(n)]
    sizes.insert(2, 70)
    out = ([], [])
    for s in sizes:
        g = tdata.random_graph(s, NL, AL, DT, 0.15 if s > 40 else 0.5, focus=focus, rng=rng)
        nt = None if types is None else rng.integers(0, types, s).astype(np.int32)
        for lst, G in zip(out, (JGraph, TGraph)):
            lst.append(G(g.arcs, g.nodes, g.targets, focus=focus, node_types=nt))
    return out


def batches(jgs, tgs, focus="g", fused_layout=True):
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus=focus, fused_layout=fused_layout)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus=focus, fused_layout=fused_layout)
    return jb, tb


def net_kw(route, focus="g", act="selu", sd=SD, nl=NL):
    """(state net kwargs, output net kwargs) at state width sd."""
    hidden, rate, bn = NETS[route]
    drop = dict(dropout_rate=(rate,), dropout_pos=(0,), alphadropout=True) if rate else {}
    sk = dict(input_dim=2 * (nl + sd) + AL, units=hidden + (sd,), activations=act,
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=bn, **drop)
    ok = dict(input_dim=(2 * (nl + sd) + AL if focus == "a" else nl + sd), units=(DT,),
              activations="softmax", kernel_initializer="glorot_normal",
              bias_initializer="glorot_normal", dropout_rate=(0.1,), dropout_pos=(0,),
              batch_normalization=False)
    return sk, ok


def specs(route, focus="g", **kw):
    """(gnn_tpu spec, port spec) of a route's nets at state_dim SD."""
    sk, ok = net_kw(route, focus)
    common = dict(focus=focus, state_dim=SD, max_iteration=K, threshold=0.01, **kw)
    return (jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), **common),
            tcore.GNNSpec(state_spec=TSpec(**sk), output_spec=TSpec(**ok), **common))


def weights(js, scale=None):
    """((params, bn) of gnn_tpu, (params, bn) of the port): gnn_tpu's init,
    non-trivial moving statistics with BatchNorm, the state net's weights
    times `scale` if given."""
    init = jcomp.composite_init if isinstance(js, jcomp.CompositeGNNSpec) else jcore.gnn_init
    params, bn = init(js, jax.random.key(0))
    if scale is not None:
        params = {**params, "state": jax.tree_util.tree_map(lambda x: x * scale,
                                                            params["state"])}

    def stats(b, t=0):
        return {"mean": jnp.full((SD,), 0.05 * (t + 1)), "var": jnp.full((SD,), 0.7 + 0.1 * t)} \
            if b else b
    if isinstance(bn["state"], tuple):
        bn = {**bn, "state": tuple(stats(b, t) for t, b in enumerate(bn["state"]))}
    else:
        bn = {**bn, "state": stats(bn["state"])}
    return (params, bn), params_from_jax(*jax.tree_util.tree_map(np.asarray, (params, bn)))


def jax_draws(js, Np, rows_out, rng, training=False):
    """gnn_tpu's draws in one forward, along its key chain: gnn_forward
    splits (rng, rng_prop, rng_out); propagate splits rng_prop into (rng,
    rng_init, rng_loop) and rng_loop into K step keys (core.py:316-338); the
    initial state is 0.1 * normal(rng_init) on the real nodes
    (core.py:317-322); each dropout layer takes split(key)[1], a composite
    net's type t fold_in(step key, t). Returns the port's masks structure."""
    _, rng_prop, rng_out = jax.random.split(rng, 3)
    _, rng_init, rng_loop = jax.random.split(rng_prop, 3)
    init = 0.1 * jax.random.normal(rng_init, (Np, js.state_dim), dtype=jnp.float32)
    masks = {"init": torch.tensor(np.asarray(init))}
    if not training:
        return masks
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
        masks["state"] = tuple(state_masks(s, t) for t, s in enumerate(js.state_specs))
    else:
        masks["state"] = state_masks(js.state_spec)
    masks["output"] = ({0: torch.tensor(keep(rng_out, js.output_spec, rows_out))}
                       if js.output_spec.dropout_rate else {})
    return masks


def with_mask(masks, nm):
    """The drawn initial state on the real nodes (the port's batch's mask)."""
    return {**masks, "init": masks["init"] * nm[:, None].float()}


def exact_body(js):
    """gnn_tpu's spec on its exact f32 XLA body ('blocked'); 'pallas' and
    'segment' specs as they are."""
    return dataclasses.replace(js, aggregation="blocked") if js.aggregation == "auto" else js


def assert_grads(got: dict, want: dict):
    """Grads by tree key: within rtol 2e-4 with a floor of 2e-5 of each
    tensor's largest entry."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        bound = 2e-4 * np.abs(w) + 2e-5 * np.abs(w).max()
        assert (np.abs(g - w) <= bound).all(), f"grad {key}: {np.abs(g - w).max():.3e}"


def port_grads(params) -> dict:
    """{gnn_tpu tree key: grad} of the port's params (weights as [in, out])."""
    grads = jax.tree_util.tree_map(lambda p: p.grad, params,
                                   is_leaf=lambda x: isinstance(x, torch.Tensor))
    return flatten(params_to_jax(grads, {})[0])


# ------------------------------------------------------------------ modules
def test_batch_agg_nodes_and_kernel_columns():
    """agg_nodes_cache equals gnn_tpu's in both batch builders, agg_nodes()
    computes it on use without a cache, `.to` and repad carry it; the
    kernels' column order is gnn_tpu's w1T_k."""
    jgs, tgs = graphs(0)
    jb, tb = batches(jgs, tgs)
    np.testing.assert_array_equal(tb.agg_nodes_cache.numpy(), np.asarray(jb.agg_nodes_cache))
    fresh = dataclasses.replace(tb, agg_nodes_cache=None)
    np.testing.assert_allclose(fresh.agg_nodes().numpy(), tb.agg_nodes_cache.numpy(), atol=1e-6)
    jg, tg = jgs[0].merge(jgs), tgs[0].merge(tgs)
    jf, tf = jbatch.GraphBatch.from_graph(jg), tbatch.GraphBatch.from_graph(tg)
    np.testing.assert_array_equal(tf.agg_nodes_cache.numpy(), np.asarray(jf.agg_nodes_cache))
    grown = tf.repad(tf.n_node_pad + 16, tf.n_edge_pad, tf.n_target_pad)
    assert grown.agg_nodes_cache.shape == (tf.n_node_pad + 16, NL)
    assert tf.to("cpu").agg_nodes_cache is not None
    assert tf.with_set_mask(np.ones(tg.n_nodes, bool)).agg_nodes_cache is not None
    _, ts = specs("hybrid")
    cols = tfold.kernel_columns(ts, NL).tolist()
    sd, nl = SD, NL
    assert cols == (list(range(sd)) + list(range(sd + nl, 2 * sd + nl))
                    + list(range(sd, sd + nl)) + list(range(2 * sd + nl, 2 * (sd + nl) + AL)))
    assert tfold.kernel_columns(dataclasses.replace(ts, state_dim=0), NL) is None


# -------------------------------------------------------------------- eval
@pytest.mark.parametrize("route,focus", [("hybrid_bn", "g"), ("hybrid2", "g"), ("hybrid", "n"),
                                         ("hybrid", "a"), ("plain", "g"), ("pallas", "g")])
def test_eval_matches_gnn_tpu(route, focus):
    """The eval forward of each route against gnn_tpu's given its initial
    state: K3/K4 ('hybrid', the affine with BatchNorm), K10/K9 ('hybrid2'),
    the plain body ('plain': aggregation 'segment') and K18's plain version
    under 'pallas' on a plan batch (Σlabels from the cache)."""
    jgs, tgs = graphs(1, focus)
    net = {"plain": "hybrid", "pallas": "hybrid"}.get(route, route)
    agg = {"plain": "segment", "pallas": "pallas"}.get(route, "auto")
    js, ts = specs(net, focus, aggregation=agg)
    if route == "pallas":
        jb = jbatch.GraphBatch.from_graph(jgs[0].merge(jgs), build_plan=True)
        tb = tbatch.GraphBatch.from_graph(tgs[0].merge(tgs), build_plan=True)
    else:
        jb, tb = batches(jgs, tgs, focus)
    want_route = {"hybrid_bn": "hybrid", "pallas": "plain"}.get(route, route)
    assert tcore._eval_route(ts, tb) == want_route
    (jp, jbn), (tp, tbn) = weights(js)
    rng = jax.random.key(5)
    with jax.default_matmul_precision("highest"):
        want = jcore.gnn_forward(exact_body(js), jp, jbn, jb, rng)
    got = tcore.gnn_forward(ts, tp, tbn, tb, masks=with_mask(jax_draws(js, tb.n_node_pad, 0, rng),
                                                              tb.node_mask))
    assert float(got["iters"]) == float(want["iters"])
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]), atol=ATOL)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]), atol=ATOL)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("route", ["hybrid", "dropout", "bn", "hybrid2", "dropout2", "bn2", "ift"])
def test_training_step_matches_gnn_tpu(route):
    """One training step of each route (the kernels' plain versions on the
    CPU) against gnn_tpu's exact f32 body with the same draws: K3/K5 and K4,
    K7/K8 and K6, K1/K2, K10/K11 and K9, K12/K13, K14/K15, and
    grad_mode='ift' (the state weights times 0.3, a contractive map)."""
    jgs, tgs = graphs(2)
    jb, tb = batches(jgs, tgs)
    ift = route == "ift"
    js, ts = specs("hybrid" if ift else route, grad_mode="ift" if ift else "unroll")
    exact = exact_body(js)
    assert tcore._train_route(ts, tb) == {"bn2": "bn", "ift": "hybrid"}.get(route, route)
    (jp, jbn), _ = weights(js, 0.3 if ift else None)
    rng = jax.random.key(3)
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                iters, loss, res = jcore.evaluate_single(exact, p, jbn, jb, rng, LOSS, {},
                                                         training=True)
                return loss + jcore.regularization(exact, p), (iters, loss, res)
            return jax.grad(f, has_aux=True)(p)
        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    sk, ok = net_kw("hybrid" if ift else route)
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01,
                          state_vect_dim=SD, grad_mode="ift" if ift else "unroll", seed=0,
                          device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    masks = with_mask(jax_draws(js, tb.n_node_pad, tb.n_node_pad, rng, True), tb.node_mask)
    with torch.no_grad():
        _, _, res_t = tcore.evaluate_single(model.spec, model.params, model.bn, tb, LOSS, {},
                                            training=True, masks=masks)
    out = model.training_step(tb, masks=masks)
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(res_t["state"].numpy(), np.asarray(res_j["state"]), atol=ATOL)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    assert_grads(port_grads(model.params), flatten(jax.tree_util.tree_map(np.asarray, g_j)))


# -------------------------------------------------------------- composites
def composite_specs(bn: bool, **kw):
    acts = ("selu", "tanh", "relu")
    drop = dict(dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=True)
    sks = [dict(input_dim=2 * (NL + SD) + AL, units=(SD,), activations=acts[t],
                kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
                batch_normalization=bn, **drop) for t in range(T)]
    _, ok = net_kw("hybrid")
    common = dict(focus="g", max_iteration=K, threshold=0.01, state_dim=SD, **kw)
    return (jcomp.CompositeGNNSpec(state_specs=tuple(JSpec(**s) for s in sks),
                                   output_spec=JSpec(**ok), **common),
            tcomp.CompositeGNNSpec(state_specs=tuple(TSpec(**s) for s in sks),
                                   output_spec=TSpec(**ok), **common), sks, ok)


@pytest.mark.parametrize("route", ["typed_eval", "typed_bn"])
def test_composite_matches_gnn_tpu(route):
    """A composite model with state_dim > 0: its K16 forward ('typed_eval')
    against gnn_tpu's typed eval kernel, one K16/K17 training step
    ('typed_bn') against gnn_tpu's type-masked XLA body with the same
    draws."""
    jgs, tgs = graphs(3, types=T)
    jb, tb = batches(jgs, tgs)
    js, ts, sks, ok = composite_specs(True)
    assert tcomp._route(ts, tb, route == "typed_bn") == route
    (jp, jbn), (tp, tbn) = weights(js)
    rng = jax.random.key(7)
    if route == "typed_eval":
        with jax.default_matmul_precision("highest"):
            want = jcomp.composite_forward(exact_body(js), jp, jbn, jb, rng)
        masks = with_mask(jax_draws(js, tb.n_node_pad, 0, rng), tb.node_mask)
        got = tcomp.composite_forward(ts, tp, tbn, tb, masks=masks)
        assert float(got["iters"]) == float(want["iters"])
        np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]), atol=ATOL)
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]), atol=ATOL)
        return
    exact = exact_body(js)
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def grads_fn(p):
            def f(p):
                res = jcomp.composite_forward(exact, p, jbn, jb, rng, training=True)
                loss = jcore.weighted_loss(jcore.get_loss(LOSS), {}, jb, res["out"])
                return loss + jcomp.composite_regularization(exact, p), (res["iters"], loss, res)
            return jax.grad(f, has_aux=True)(p)
        g_j, (iters_j, loss_j, res_j) = grads_fn(jp)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    model = CompositeGNNgraphBased([TSpec(**s) for s in sks], TSpec(**ok), max_iteration=K,
                                   threshold=0.01, state_dim=SD, seed=0, device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    masks = with_mask(jax_draws(js, tb.n_node_pad, tb.n_node_pad, rng, True), tb.node_mask)
    out = model.training_step(tb, masks=masks)
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    assert_grads(port_grads(model.params), flatten(jax.tree_util.tree_map(np.asarray, g_j)))


# --------------------------------------------------------- LGNN, lifecycle
def test_lgnn_two_layer_stack_matches_gnn_tpu():
    """A two-layer LGNN of state_dim > 0 layers (get_state and get_output:
    layer 1's labels gain layer 0's state and outputs, its Σlabels computed
    on use) at eval against gnn_tpu's, each layer given gnn_tpu's initial
    state (one key a layer, lgnn.py:87)."""
    jgs, tgs = graphs(4)
    jb, tb = batches(jgs, tgs)
    specs_j, gnns = [], []
    for layer in range(2):
        nl = NL if layer == 0 else NL + SD + DT
        sk, ok = net_kw("hybrid2" if layer else "hybrid_bn", nl=nl)
        common = dict(focus="g", state_dim=SD, max_iteration=K, threshold=0.01)
        js = jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), **common)
        (p, b), _ = weights(js)
        m = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01,
                          state_vect_dim=SD, seed=layer, device="cpu")
        m.set_params(*jax.tree_util.tree_map(np.asarray, (p, b)))
        specs_j.append((js, p, b))
        gnns.append(m)
    lgnn = LGNN(gnns, get_state=True, get_output=True, path_writer="writer/")
    rng = jax.random.key(9)
    js_all = tuple(s for s, _, _ in specs_j)
    with jax.default_matmul_precision("highest"):
        iters_j, outs_j, state_j, _ = jlgnn.lgnn_forward(
            tuple(map(exact_body, js_all)), tuple(p for _, p, _ in specs_j),
            tuple(b for _, _, b in specs_j), jb, rng, False, True, True)
    draws = [with_mask(jax_draws(js, tb.n_node_pad, 0, key), tb.node_mask)
             for js, key in zip(js_all, jax.random.split(rng, 2))]
    with torch.no_grad():
        iters, outs, state, _ = tlgnn.lgnn_forward(lgnn._specs, lgnn._params(), lgnn._bns(), tb,
                                                   False, True, True, draws)
    assert [float(i) for i in iters] == [float(i) for i in iters_j]
    np.testing.assert_allclose(state.numpy(), np.asarray(state_j), atol=ATOL)
    for o, w in zip(outs, outs_j):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=ATOL)
    layer1 = tlgnn.update_graph_batch(tb, state, outs[0], get_state=True, get_output=False,
                                      focus="g")
    assert layer1.agg_nodes_cache is None and layer1.agg_arcs_cache is not None


def test_save_load_and_serving(tmp_path):
    """A state_dim > 0 model saved by the port loads in gnn_tpu with its
    state_vect_dim, and gnn_tpu's save loads in the port; both forwards
    agree given one initial state. Predictor draws the initial state from a
    generator seeded anew each call: a request's answer does not depend on
    earlier requests, and equals the forward from that draw."""
    jgs, tgs = graphs(5)
    sk, ok = net_kw("hybrid_bn")
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01,
                          state_vect_dim=SD, seed=1, device="cpu")
    model.save(str(tmp_path / "port"))
    jm = gnn_tpu.GNNgraphBased.load(str(tmp_path / "port"))
    assert jm.state_vect_dim == SD and jm.spec.state_dim == SD
    jm.save(str(tmp_path / "jax"))
    back = GNNgraphBased.load(str(tmp_path / "jax"), device="cpu")
    assert back.spec == model.spec and back.state_vect_dim == SD
    jb, tb = batches(jgs, tgs)
    rng = jax.random.key(2)
    with jax.default_matmul_precision("highest"):
        want = jcore.gnn_forward(exact_body(jm.spec), jm.params, jm.bn, jb, rng)
    masks = with_mask(jax_draws(jm.spec, tb.n_node_pad, 0, rng), tb.node_mask)
    for m in (model, back):
        with torch.no_grad():
            got = tcore.gnn_forward(m.spec, m.params, m.bn, tb, masks=masks)
        assert float(got["iters"]) == float(want["iters"])
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]), atol=ATOL)
    pred = Predictor(model, device="cpu")
    first = pred.predict(tgs[:3], split=False)
    pred.predict(tgs[3:])
    again = pred.predict(tgs[:3], split=False)
    np.testing.assert_array_equal(first, again)
    gb = pred.build_batch(tgs[:3])
    init = tcore.draw_init(model.spec, gb, torch.Generator().manual_seed(0))
    with torch.no_grad():
        res = tcore.gnn_forward(model.spec, model.params, model.bn, gb, masks={"init": init})
    np.testing.assert_allclose(first, res["out"].numpy()[gb.sel_mask.numpy()], atol=1e-6)
    with pytest.raises(ValueError, match="initial state"):
        tcore.gnn_forward(model.spec, model.params, model.bn, gb)
    assert np.isfinite(model.Loop(tgs[0])[-1]).all()
