"""gnn_tpu_torch's eval forward (models/core.py) against gnn_tpu's.

The same graphs and the same weights (drawn by gnn_tpu, carried across with
convert.params_from_jax) go through both packages on the CPU. gnn_tpu runs
its Pallas kernels in interpret mode on fused-layout batches; the port runs
the kernels' plain versions. Realised iteration counts must be equal, states
and outputs within atol 3e-5 (gnn_tpu's bound for its kernels' hi/lo f32
emulation, tests/test_fused.py)."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.graphs import datasets as jdata
from gnn_tpu.models import core as jcore
from gnn_tpu.models.engine import tree_to_npz
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch import GNNgraphBased, GNNnodeBased
from gnn_tpu_torch.convert import load_npz, params_from_jax, parse_key
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.graphs import datasets as tdata
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import fused as tfused
from gnn_tpu_torch.ops import segment as tseg
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec

torch.set_num_threads(1)
ATOL = 3e-5


def _graphs(seed, n=12, big=True, focus="g", nl=5, al=3):
    """Both packages' graphs from one seed (tests/test_fused.py hybrid_workload
    shape: a 70-node graph spans several 32-node blocks)."""
    out = []
    for mod in (jdata, tdata):
        rng = np.random.default_rng(seed)
        gs = [mod.random_graph(int(rng.integers(8, 30)), nl, al, 2, 0.5, focus=focus, rng=rng)
              for _ in range(n)]
        if big:
            gs.insert(3, mod.random_graph(70, nl, al, 2, 0.2, focus=focus, rng=rng))
        out.append(gs)
    return out


def _specs(act="selu", bn=True, units=(5,), nl=5, al=3, focus="g", **kw):
    sk = dict(input_dim=2 * nl + al, units=units, activations=act,
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=bn, dropout_rate=(0.1,), dropout_pos=(0,),
              alphadropout=True)
    ok = dict(input_dim=(2 * nl + al if focus == "a" else nl), units=(2,),
              activations="softmax", batch_normalization=False)
    js = jcore.GNNSpec(focus=focus, state_spec=JSpec(**sk), output_spec=JSpec(**ok),
                       max_iteration=4, threshold=0.01, aggregation="auto")
    ts = tcore.GNNSpec(focus=focus, state_spec=TSpec(**sk), output_spec=TSpec(**ok),
                       max_iteration=4, threshold=0.01, aggregation="auto")
    if kw:
        js, ts = dataclasses.replace(js, **kw), dataclasses.replace(ts, **kw)
    return js, ts


def _weights(js, bn_stats=True):
    params, bn = jcore.gnn_init(js, jax.random.key(0))
    if bn_stats and js.state_spec.batch_normalization:   # non-trivial inference stats
        d = js.state_spec.units[-1]
        bn = {"state": {"mean": jnp.full((d,), 0.1), "var": jnp.full((d,), 0.8)},
              "output": bn["output"]}
    np_tree = jax.tree_util.tree_map(np.asarray, (params, bn))
    return (params, bn), params_from_jax(*np_tree)


def _compare(js, ts, jgs, tgs, fused_layout=True, block_w=32):
    jb = jbatch.from_graphs_blocked(jgs, block_w=block_w, focus=js.focus,
                                    fused_layout=fused_layout)
    tb = tbatch.from_graphs_blocked(tgs, block_w=block_w, focus=ts.focus,
                                    fused_layout=fused_layout)
    (jp, jbn), (tp, tbn) = _weights(js)
    rj = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(1))
    rt = tcore.gnn_forward(ts, tp, tbn, tb)
    assert float(rt["iters"]) == float(rj["iters"])
    np.testing.assert_allclose(rt["state"].numpy(), np.asarray(rj["state"]), atol=ATOL)
    np.testing.assert_allclose(rt["out"].numpy(), np.asarray(rj["out"]), atol=ATOL)
    return rt


@pytest.mark.parametrize("threshold", [0.01, 0.4, 1.5, 1e9])
def test_hybrid_forward_matches(threshold):
    """Loop AND dep blocks, BN folded as the inference affine; coarse
    thresholds realise fewer than max_iteration steps (global early stop)."""
    js, ts = _specs(threshold=threshold, max_iteration=6)
    jgs, tgs = _graphs(0)
    tfused.reset_launches()
    rt = _compare(js, ts, jgs, tgs)
    if threshold == 1e9:
        assert float(rt["iters"]) == 0.0
    assert not any(tfused.launches.values())                 # plain versions on the CPU


@pytest.mark.parametrize("act,focus,big", [("tanh", "g", False), ("relu", "n", True),
                                           ("linear", "a", True), ("selu", "n", False)])
def test_hybrid_forward_matches_other_activations_and_focus(act, focus, big):
    js, ts = _specs(act=act, bn=(act != "tanh"), focus=focus)
    jgs, tgs = _graphs(1, n=10, big=big, focus=focus)
    _compare(js, ts, jgs, tgs)


@pytest.mark.parametrize("act,units,fused_layout", [("sigmoid", (5,), True),
                                                    ("selu", (5,), False),
                                                    ("sigmoid", (7, 5), True)])
def test_plain_body_matches(act, units, fused_layout):
    """What gnn_tpu sends to its XLA body (activation the kernels lack, a
    batch without the loop/dep layout) runs the port's plain body."""
    js, ts = _specs(act=act, units=units)
    jgs, tgs = _graphs(2)
    _compare(js, ts, jgs, tgs, fused_layout=fused_layout)


def test_node_example_loads_and_matches(tmp_path):
    from gnn_tpu.models.gnn import GNNnodeBased as JNode
    folder = tmp_path / "node_example"
    shutil.copytree("models/node_example", folder)
    jm = JNode.load(str(folder), path_writer=str(tmp_path / "writer"))
    tm = GNNnodeBased.load(str(folder), device="cpu")
    assert tm.spec.state_spec == TSpec.from_config(jm.spec.state_spec.to_config())
    jgs, tgs = _graphs(3, n=6, focus="n", nl=3, al=1)
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="n", fused_layout=True)
    tb = tm.to_batch(tgs, block_w=32)
    rj = jcore.gnn_forward(jm.spec, jm.params, jm.bn, jb, jax.random.key(0))
    # this model's BN statistics drive states up to ~5, where the kernels'
    # hi/lo emulation (relative error ~8e-6) leaves 3e-5: the states are held
    # to gnn_tpu's true-f32 XLA body on the same batch instead
    rx = jcore.gnn_forward(dataclasses.replace(jm.spec, aggregation="segment"),
                           jm.params, jm.bn, jb, jax.random.key(0))
    rt = tm.forward(tb)
    assert float(rt["iters"]) == float(rj["iters"]) == float(rx["iters"])
    np.testing.assert_allclose(rt["state"].numpy(), np.asarray(rx["state"]), atol=ATOL)
    np.testing.assert_allclose(rt["out"].numpy(), np.asarray(rx["out"]), atol=ATOL)
    np.testing.assert_allclose(rt["out"].numpy(), np.asarray(rj["out"]), atol=ATOL)
    iters, _, rows = tm.Loop(tb)
    sel = np.asarray(jb.sel_mask)
    np.testing.assert_allclose(rows, np.asarray(rj["out"])[sel], atol=ATOL)


def test_params_round_trip(tmp_path):
    js, _ = _specs()
    params, bn = jcore.gnn_init(js, jax.random.key(4))
    want_p, want_b = jax.tree_util.tree_map(np.asarray, (params, bn))
    tp, tbn = params_from_jax(want_p, want_b)
    assert tuple(tp["state"]["dense_0"]["w"].shape) == (5, 13)     # [out, in]
    # every leaf carried across, dense weights transposed back to gnn_tpu's [in, out]
    for net, layers in want_p.items():
        assert set(tp[net]) == set(layers)
        for name, leaves in layers.items():
            assert set(tp[net][name]) == set(leaves)
            for k, want in leaves.items():
                got = tp[net][name][k].numpy()
                np.testing.assert_array_equal(got.T if k == "w" else got, want)
    for net, stats in want_b.items():
        assert set(tbn[net]) == set(stats)
        for k, want in stats.items():
            np.testing.assert_array_equal(tbn[net][k].numpy(), want)
    # through gnn_tpu's npz save format and its tree path keys
    tree_to_npz(str(tmp_path / "p.npz"), params)
    loaded = load_npz(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(loaded["state"]["dense_0"]["w"], want_p["state"]["dense_0"]["w"])
    assert parse_key("['state']['dense_0']['w']") == ("state", "dense_0", "w")
    with pytest.raises(ValueError):
        parse_key("state.dense_0.w")
    flat_p, _ = params_from_jax({"['output']['dense_0']['w']": np.ones((5, 2)),
                                 "['output']['dense_0']['b']": np.zeros(2)}, {})
    assert tuple(flat_p["output"]["dense_0"]["w"].shape) == (2, 5)


@pytest.mark.parametrize("route", ["dropout", "hybrid"])
def test_bn_free_specs_train(route):
    """Training without BatchNorm: with input dropout the kernels K6-K8, with
    neither the eval kernels and K3's backward K5. Gradients reach the state
    net's dense layer (tests/test_torch_train_bnfree.py holds them to gnn_tpu)."""
    _, ts = _specs()
    _, tgs = _graphs(0, n=4)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, fused_layout=True)
    no_bn = dataclasses.replace(ts.state_spec, batch_normalization=False)
    ss = no_bn if route == "dropout" else dataclasses.replace(no_bn, dropout_rate=(),
                                                              dropout_pos=())
    spec = dataclasses.replace(ts, state_spec=ss)
    assert tcore._train_route(spec, tb) == route
    params, bn = tcore.gnn_init(spec, torch.Generator().manual_seed(0))
    w = params["state"]["dense_0"]["w"].requires_grad_()
    masks = tcore.draw_masks(spec, tb, torch.Generator().manual_seed(1))
    iters, state, bn_out = tcore.propagate(spec, params["state"], bn["state"], tb,
                                           training=True, keep=masks["state"])
    assert bn_out == {} and state.shape == tb.nodes.shape and 0 < float(iters) <= 4
    torch.sum(torch.tanh(state)).backward()
    assert torch.isfinite(w.grad).all() and (w.grad != 0).any()


def test_unported_paths_raise():
    """state_dim > 0 raises; two-layer state nets serve and train; the
    aggregation names 'pallas' and 'blocked' run the plain body on a batch
    with blocks, where gnn_tpu runs its XLA body; on a batch without blocks
    built with a plan, 'pallas' runs the plain body with K18's plain version
    (ops/segment.py) and equals gnn_tpu's, which launches its K18."""
    js, ts = _specs()
    jgs, tgs = _graphs(0, n=4, big=False)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, fused_layout=True)
    (jp, jbn), (tp, tbn) = _weights(js)
    with pytest.raises(NotImplementedError, match="state_dim"):
        tcore.propagate(dataclasses.replace(ts, state_dim=4), tp["state"], tbn["state"], tb)
    # two-layer state nets serve (K9/K10) and with BatchNorm train through
    # K14/K15 (tests/test_torch_train_h150.py and test_torch_bn2.py hold them)
    js2, ts2 = _specs(act="tanh", units=(7, 5))
    _, (tp2, tbn2) = _weights(js2)
    assert torch.isfinite(tcore.gnn_forward(ts2, tp2, tbn2, tb)["out"]).all()
    assert tcore._train_route(ts2, tb) == "bn"
    masks = tcore.draw_masks(ts2, tb, torch.Generator().manual_seed(0))
    assert torch.isfinite(tcore.gnn_forward(ts2, tp2, tbn2, tb, training=True,
                                            masks=masks)["out"]).all()
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    for name in ("pallas", "blocked"):
        spec = dataclasses.replace(ts, aggregation=name)
        assert tcore._eval_route(spec, tb) == "plain"
        got = tcore.gnn_forward(spec, tp, tbn, tb)
        want = jcore.gnn_forward(dataclasses.replace(js, aggregation=name), jp, jbn, jb,
                                 jax.random.key(0))
        assert float(got["iters"]) == float(want["iters"])
        np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]), atol=ATOL)
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]), atol=ATOL)
    spec, jspec = (dataclasses.replace(s, aggregation="pallas") for s in (ts, js))
    tg = tgs[0].merge(tgs)
    jg = jgs[0].merge(jgs)
    tp_b = tbatch.GraphBatch.from_graph(tg, build_plan=True)
    jp_b = jbatch.GraphBatch.from_graph(jg, build_plan=True)
    assert tcore._eval_route(spec, tp_b) == "plain" and tp_b.agg_plan is not None
    tseg.reset_launches()
    got = tcore.gnn_forward(spec, tp, tbn, tp_b)
    assert tseg.launches == {"segment_aggregate": 0}          # plain K18 on the CPU
    want = jcore.gnn_forward(jspec, jp, jbn, jp_b, jax.random.key(0))
    assert float(got["iters"]) == float(want["iters"])
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]), atol=ATOL)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]), atol=ATOL)


def test_entry_points_default_to_the_card():
    _, ts = _specs()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GNNgraphBased(ts.state_spec, ts.output_spec)
    model = GNNgraphBased(ts.state_spec, ts.output_spec, seed=0, device="cpu")
    assert model.params["state"]["dense_0"]["w"].device.type == "cpu"


def test_bn_free_model_round_trip(tmp_path):
    """A BN-free state net (no 'bn' leaves) carries across from gnn_tpu with
    set_params, trains, saves in gnn_tpu's format and loads back in both
    packages with the same weights and eval outputs."""
    from gnn_tpu.models.gnn import GNNgraphBased as JGraph
    js, ts = _specs(bn=False)
    (jp, jbn), _ = _weights(js)
    assert "bn" not in jp["state"] and jbn["state"] == {}
    jgs, tgs = _graphs(5)
    model = GNNgraphBased(ts.state_spec, ts.output_spec, max_iteration=4, threshold=0.01, seed=0,
                          device="cpu")
    model.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    tb = model.to_batch(tgs, block_w=32)
    assert tcore._train_route(model.spec, tb) == "dropout"
    for _ in range(2):
        assert np.isfinite(float(model.training_step(tb)["loss"]))
    model.save(str(tmp_path / "m"))
    jm = JGraph.load(str(tmp_path / "m"), path_writer=str(tmp_path / "writer"))
    assert "bn" not in jm.params["state"] and jm.bn["state"] == {}
    np.testing.assert_array_equal(np.asarray(jm.params["state"]["dense_0"]["w"]),
                                  model.params["state"]["dense_0"]["w"].detach().numpy().T)
    back = GNNgraphBased.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(back.Loop(tb)[2], model.Loop(tb)[2])
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=True)
    rj = jcore.gnn_forward(jm.spec, jm.params, jm.bn, jb, jax.random.key(0))
    np.testing.assert_allclose(model.forward(tb)["out"].numpy(), np.asarray(rj["out"]),
                               atol=ATOL)
