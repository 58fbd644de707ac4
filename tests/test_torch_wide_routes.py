"""Specs of wide states: the routes keep gnn_tpu's dispatch, the CPU
computes what gnn_tpu computes, and every kernel takes every width.

gnn_tpu's kernel predicates have no width test (ops/pallas_fused.py:1921-1946)
and its dispatch runs the Pallas kernels at any width. The port's routes
(models/core.py::_eval_route, _train_route; models/composite.py::_route) pick
by the spec and the layout alone, as gnn_tpu's do, so a spec of state width 80
takes the same kernel route as one of width 5. Every kernel takes every state
width, arc-label width, hidden width and number of node types (each a wide
plan where no staged plan fits). On
the CPU every wrapper runs its plain version, so a width-80 model matches
gnn_tpu's
exact f32 body (aggregation='blocked', highest matmul precision): iteration
counts equal, states and outputs atol 3e-5, the loss rtol 1e-5, grads rtol
2e-4 (atol 1e-6), params after one Adam step atol 1e-5. Every call a route
makes is replayed here on meta tensors, which the wrappers check as they
check CUDA ones: each passes every check and stops only at the meta device
(or, for the BatchNorm wrappers, where the library would be loaded), with no
launch counted, and none runs the plain version in the kernel's place.
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
from gnn_tpu.models import core as jcore
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu.training import optimizers as jopt
from gnn_tpu_torch import GNNgraphBased
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import _build
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tf
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops import typed as ttyped
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_training import _jax_masks

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
ATOL = 3e-5
K = 4
WRAPPERS = {tf: ("propagation_loop", "propagation_loop_bwd", "propagation_step", "train_loop",
                 "train_loop_bwd", "train_step"),
            tf2: ("propagation_loop2", "propagation_loop2_bwd", "propagation_step2",
                  "train_loop2", "train_loop2_bwd"),
            tbn: ("bn_forward_step", "bn_backward_step", "bn2_forward_step", "bn2_backward_step"),
            ttyped: ("bnT_forward_step", "bnT_backward_step")}
KERNEL = {"propagation_loop": "K3", "propagation_step": "K4", "propagation_loop_bwd": "K5",
          "train_step": "K6", "train_loop": "K7", "train_loop_bwd": "K8",
          "bn_forward_step": "K1", "bn_backward_step": "K2"}
# past every check, a wrapper on meta tensors stops at its device check or,
# where the device gate is lifted, at the launch
ON_META = "need CPU or CUDA tensors|launch reached"


def _graphs(seed, nl, al, big=70):
    """Both packages' graphs from one seed with nl-wide node and al-wide arc
    labels: 10 small graphs and one of `big` nodes, so that at block_w 32
    (big 70) or 128 (big 300) the fused layout has loop blocks and dep
    blocks."""
    out = []
    for mod in (jdata, tdata):
        rng = np.random.default_rng(seed)
        gs = [mod.random_graph(int(rng.integers(8, 30)), nl, al, 2, 0.5, focus="g", rng=rng)
              for _ in range(10)]
        gs.insert(3, mod.random_graph(big, nl, al, 2, 0.2 if big == 70 else 0.05, focus="g", rng=rng))
        out.append(gs)
    return out


def _batches(nl, al, seed=0, block_w=32):
    jgs, tgs = _graphs(seed, nl, al, big=70 if block_w == 32 else 300)
    jb = jbatch.from_graphs_blocked(jgs, block_w=block_w, focus="g", fused_layout=True)
    tb = tbatch.from_graphs_blocked(tgs, block_w=block_w, focus="g", fused_layout=True)
    assert tb.adj_loop is not None and tb.adj_dep is not None
    return jb, tb


def _net_kw(nl, al, layers=1, drop=0.0, bn=False, hidden=16):
    """A state net nl -> (hidden ->) nl (selu, tanh at the second layer),
    AlphaDropout `drop` at its input, the trailing BatchNorm when `bn`; a
    softmax readout with dropout."""
    sdrop = dict(dropout_rate=(drop,), dropout_pos=(0,), alphadropout=True) if drop else {}
    units, acts = ((nl,), "selu") if layers == 1 else ((hidden, nl), ("selu", "tanh"))
    sk = dict(input_dim=2 * nl + al, units=units, activations=acts,
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=bn, **sdrop)
    ok = dict(input_dim=nl, units=(2,), activations="softmax", kernel_initializer="glorot_normal",
              bias_initializer="glorot_normal", dropout_rate=(0.1,), dropout_pos=(0,),
              batch_normalization=False)
    return sk, ok


def _spec(nl, al, aggregation="auto", **kw):
    sk, ok = _net_kw(nl, al, **kw)
    return tcore.GNNSpec(focus="g", state_spec=TSpec(**sk), output_spec=TSpec(**ok),
                         max_iteration=K, aggregation=aggregation)


# (layers, input dropout, BatchNorm, hidden width) -> (eval route, training
# route) at widths the kernels take
NETS = {"one layer, clean": ((1, 0.0, False, 16), ("hybrid", "hybrid")),
        "one layer, dropout": ((1, 0.1, False, 16), ("hybrid", "dropout")),
        "one layer, BatchNorm": ((1, 0.1, True, 16), ("hybrid", "bn")),
        "two layers, clean": ((2, 0.0, False, 16), ("hybrid2", "hybrid2")),
        "two layers, dropout": ((2, 0.1, False, 16), ("hybrid2", "dropout2")),
        "two layers, BatchNorm": ((2, 0.1, True, 16), ("hybrid2", "bn"))}


def _recorded(monkeypatch):
    """[(wrapper, name, args, kwargs)] of every kernel wrapper call, in order,
    while the wrappers stay patched."""
    calls = []
    for mod, names in WRAPPERS.items():
        for name in names:
            fn = getattr(mod, name)

            def wrapper(*args, _name=name, _fn=fn, **kwargs):
                calls.append((_fn, _name, args, kwargs))
                return _fn(*args, **kwargs)
            monkeypatch.setattr(mod, name, wrapper)
    return calls


def _on_meta(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    if isinstance(x, (tuple, list)):
        return type(x)(_on_meta(v) for v in x)
    if isinstance(x, dict):
        return {k: _on_meta(v) for k, v in x.items()}
    return x


def _launched():
    return sum(sum(m.launches.values()) for m in WRAPPERS)


def _no_library():
    raise ValueError("launch reached")


def _replay(monkeypatch, calls, match):
    """Replay each recorded call on meta tensors, as the card would take it:
    the BatchNorm wrappers' gate on a CUDA device (bn._require_cuda) is
    lifted, and building the library raises in place of a launch. Each call
    must raise the ValueError `match` names, with no launch counted."""
    assert calls
    before = _launched()
    with monkeypatch.context() as m:
        for mod in (tbn, ttyped):
            m.setattr(mod, "_require_cuda", lambda t: None)
        m.setattr(_build, "library", _no_library)
        for fn, name, args, kwargs in calls:
            with pytest.raises(ValueError, match=match):
                fn(*_on_meta(args), **_on_meta(kwargs))
    assert _launched() == before


def _run(monkeypatch, spec, tb, training):
    """The wrapper calls of one forward (and in training one optimizer
    step) of a model of `spec` with seeded weights on the CPU batch tb."""
    model = GNNgraphBased(spec.state_spec, spec.output_spec, max_iteration=K, seed=0,
                          aggregation=spec.aggregation, device="cpu")
    with monkeypatch.context() as m:
        calls = _recorded(m)
        if training:
            out = model.training_step(tb)
            assert np.isfinite(float(out["loss"]))
        else:
            assert torch.isfinite(model.forward(tb)["out"]).all()
    return calls


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("aggregation", ["auto", "fused"])
def test_state_width_80_keeps_the_kernel_route(monkeypatch, net, aggregation):
    """At state width 80 every route is the one it is at width 5, at eval
    and in training, with 'auto' and 'fused', as gnn_tpu's dispatch; the
    model runs on the CPU through the route's wrappers (their plain
    versions), and each of those calls, replayed on meta tensors, passes
    every check of its kernel, one-layer (K1-K8) and two-layer (K9-K15)
    alike, with no launch counted."""
    (layers, drop, bn, hidden), (ev, tr) = NETS[net]
    kw = dict(layers=layers, drop=drop, bn=bn, hidden=hidden, aggregation=aggregation)
    _, narrow = _batches(5, 3)
    spec = _spec(5, 3, **kw)
    assert (tcore._eval_route(spec, narrow), tcore._train_route(spec, narrow)) == (ev, tr)
    _, wide = _batches(80, 3)
    spec = _spec(80, 3, **kw)
    assert (tcore._eval_route(spec, wide), tcore._train_route(spec, wide)) == (ev, tr)
    for training in (False, True):
        _replay(monkeypatch, _run(monkeypatch, spec, wide, training), ON_META)


@pytest.mark.parametrize("net", [n for n in NETS if n.startswith("two")] + ["one layer, BatchNorm"])
def test_arc_label_width_80(monkeypatch, net):
    """80 arc-label columns keep every route, and every call of it passes its
    kernel's checks at F = 80: the two-layer routes' (K9-K15 take every
    arc-label width through their wide plans) and the one-layer BatchNorm route's (K1/K2)."""
    (layers, drop, bn, hidden), (ev, tr) = NETS[net]
    _, tb = _batches(5, 80)
    spec = _spec(5, 80, layers=layers, drop=drop, bn=bn, hidden=hidden)
    assert (tcore._eval_route(spec, tb), tcore._train_route(spec, tb)) == (ev, tr)
    calls = _run(monkeypatch, spec, tb, training=True)
    if layers == 1:
        assert {name for _, name, _, _ in calls} == {"bn_forward_step", "bn_backward_step"}
    _replay(monkeypatch, calls, ON_META)


@pytest.mark.parametrize("net", [n for n in NETS if n.startswith("two")])
def test_hidden_width_above_max_hidden(monkeypatch, net):
    """A two-layer state net of hidden width MAX_HIDDEN + 1 keeps every
    route, and each of its calls passes every check of its kernel, as at
    MAX_HIDDEN."""
    (layers, drop, bn, _), (ev, tr) = NETS[net]
    _, tb = _batches(5, 3)
    for hidden, match in ((tf2.MAX_HIDDEN + 1, ON_META), (tf2.MAX_HIDDEN, ON_META)):
        spec = _spec(5, 3, layers=2, drop=drop, bn=bn, hidden=hidden)
        assert (tcore._eval_route(spec, tb), tcore._train_route(spec, tb)) == (ev, tr)
        _replay(monkeypatch, _run(monkeypatch, spec, tb, training=True), match)


def _composite(T, nl, al):
    sk, ok = _net_kw(nl, al, drop=0.1, bn=True)
    return tcomp.CompositeGNNSpec(focus="g", state_specs=(TSpec(**sk),) * T,
                                  output_spec=TSpec(**ok), max_iteration=K)


@pytest.mark.parametrize("T,nl,match", [(ttyped.MAX_TYPES, 5, ON_META),
                                        (ttyped.MAX_TYPES + 1, 5, ON_META),
                                        (3, 80, ON_META)])
def test_composite_typed_kernels_refuse_on_the_card(monkeypatch, T, nl, match):
    """(The name is from when the card refused more than MAX_TYPES types and
    state widths above 64.) Composite models keep K16/K17 at any number of
    types and any state width, and every call passes the kernels' checks:
    33 types and width 80 through their wide plans."""
    _, tb = _batches(nl, 3)
    tb = dataclasses.replace(tb, node_types=torch.zeros(tb.n_node_pad, dtype=torch.int64))
    spec = _composite(T, nl, 3)
    assert (tcomp._route(spec, tb, False), tcomp._route(spec, tb, True)) == (
        "typed_eval", "typed_bn")
    params, bn = tcomp.composite_init(spec, torch.Generator().manual_seed(0))
    keep = tcomp.draw_masks(spec, tb, torch.Generator().manual_seed(1))["state"]
    with monkeypatch.context() as m, torch.no_grad():
        calls = _recorded(m)
        tcomp.composite_propagate(spec, params["state"], bn["state"], tb)
        tcomp.composite_propagate(spec, params["state"], bn["state"], tb, training=True,
                                  keep=keep)
    assert {name for _, name, _, _ in calls} == {"bnT_forward_step"}
    _replay(monkeypatch, calls, match)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"])
def test_fused_wrappers_refuse_width_80_at_block_width_128(monkeypatch, kernel):
    """(The name is from when K1-K8 refused state widths above 64.) At block
    width 128 the one-layer routes' calls of K1-K8 pass every check of their
    wrappers at D 64, 80, 128 and 200, replayed on meta tensors with no
    launch counted: the staged plans where they fit, else the wide plan
    (K3-K8 from D 80 on, K1 and K2 from 128; the mirrors name it)."""
    drop = 0.1 if kernel in ("K1", "K2", "K6", "K7", "K8") else 0.0
    training = kernel not in ("K3", "K4")
    plan_of = {"K1": lambda D: tbn._bn_plan("K1", 128, D, 3),
               "K2": lambda D: tbn._bn_plan("K2", 128, D, 3),
               "K3": lambda D: tf._loop_plan(128, D), "K4": lambda D: tf._step_plan(128, D, D),
               "K5": lambda D: tf._loop_bwd_plan(128, D),
               "K6": lambda D: tf._train_step_plan(128, D, D),
               "K7": lambda D: tf._train_loop_plan(128, D),
               "K8": lambda D: tf._train_bwd_plan(128, D)}[kernel]
    wide = {"K1": 2, "K2": 2, "K3": 2, "K4": 1, "K5": 2, "K6": 1, "K7": 1, "K8": 2}[kernel]
    for D in (64, 80, 128, 200):
        _, tb = _batches(D, 3, block_w=128)
        spec = _spec(D, 3, drop=drop, bn=kernel in ("K1", "K2"))
        calls = [c for c in _run(monkeypatch, spec, tb, training) if KERNEL.get(c[1]) == kernel]
        _replay(monkeypatch, calls, ON_META)
        takes_wide = D >= (128 if kernel in ("K1", "K2") else 80)
        assert (plan_of(D)[1] == wide) == takes_wide, (D, plan_of(D))


def _np(t):
    return t.detach().numpy()


def _models(layers, drop, bn, threshold):
    """(gnn_tpu spec 'blocked', its params and bn, the port's 'auto' model
    with the same weights) at state width 80."""
    sk, ok = _net_kw(80, 3, layers=layers, drop=drop, bn=bn)
    js = jcore.GNNSpec(focus="g", state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=K, threshold=threshold, aggregation="blocked")
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    if bn:
        jbn = {"state": {"mean": jnp.full((80,), 0.1), "var": jnp.full((80,), 0.7)},
               "output": {}}
    model = GNNgraphBased(TSpec(**sk), TSpec(**ok), optimizer=jopt.optimizer_config("adam"),
                          max_iteration=K, threshold=threshold, aggregation="auto", seed=0,
                          device="cpu")
    model.set_weights(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    return js, jp, jbn, model


@pytest.mark.parametrize("layers,bn,threshold", [(1, True, 0.01), (1, False, 0.4),
                                                 (2, False, 0.01)])
def test_width_80_forward_matches_gnn_tpu(monkeypatch, layers, bn, threshold):
    """A model of state width 80 serves through its kernel route, whose
    wrappers run their plain versions on the CPU, within 3e-5 of gnn_tpu's
    exact body, iterations equal."""
    jb, tb = _batches(80, 3)
    js, jp, jbn, model = _models(layers, 0.1, bn, threshold)
    with jax.default_matmul_precision("highest"):
        body = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(1))
    calls = _recorded(monkeypatch)
    rt = model.forward(tb)
    assert {name for _, name, _, _ in calls} == (
        {"propagation_loop", "propagation_step"} if layers == 1
        else {"propagation_loop2", "propagation_step2"})
    assert float(rt["iters"]) == float(body["iters"])
    for key in ("state", "out"):
        np.testing.assert_allclose(_np(rt[key]), np.asarray(body[key]), atol=ATOL)


@pytest.mark.parametrize("layers,drop,bn", [(1, 0.15, False), (1, 0.15, True),
                                            (2, 0.1, False)])
def test_width_80_training_step_matches_gnn_tpu(monkeypatch, layers, drop, bn):
    """One optimizer step of a width-80 model with input dropout (the
    dropout, BatchNorm and two-layer dropout routes) runs through the
    route's wrappers, their plain versions on the CPU, and matches gnn_tpu's make_train_step on its exact body
    with gnn_tpu's masks: iteration count, states, loss, grads, params and
    moving statistics."""
    jb, tb = _batches(80, 3)
    js, jp, jbn, model = _models(layers, drop, bn, 0.01)
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
        p_j, bn_j, _, _ = step(jp, jbn, jopt.make_optimizer(opt_cfg).init(jp), jb, rng)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    masks = _jax_masks(js, tb.n_node_pad, rng)
    route = tcore._train_route(model.spec, tb)
    assert route == ("bn" if bn else "dropout" if layers == 1 else "dropout2")
    with torch.no_grad():
        _, _, res_t = tcore.evaluate_single(model.spec, model.params, model.bn, tb, LOSS, {},
                                            training=True, masks=masks)
    calls = _recorded(monkeypatch)
    out = model.training_step(tb, mean=True, masks=masks)
    assert calls
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(_np(res_t["state"]), np.asarray(res_j["state"]), atol=ATOL)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for key, v in model.bn["state"].items():
        np.testing.assert_allclose(_np(v), np.asarray(bn_j["state"][key]), atol=1e-5)
    for net in ("state", "output"):
        for name, leaves in model.params[net].items():
            for k, p in leaves.items():
                flip = (lambda a: a.T) if k == "w" else (lambda a: a)
                np.testing.assert_allclose(flip(_np(p.grad)), np.asarray(g_j[net][name][k]),
                                           rtol=2e-4, atol=1e-6, err_msg=f"grad {net}/{name}/{k}")
                np.testing.assert_allclose(flip(_np(p)), np.asarray(p_j[net][name][k]),
                                           atol=1e-5, err_msg=f"param {net}/{name}/{k}")
