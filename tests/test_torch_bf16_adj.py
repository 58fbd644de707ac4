"""The bf16 block adjacency (from_graphs_blocked(adj_dtype=bfloat16)) in
gnn_tpu_torch against gnn_tpu, on the CPU.

gnn_tpu's low-precision mode stores the block adjacency in bf16 and its
kernels take it in one pass (hp = False): every product has bf16 operands
and f32 accumulation. This file holds the hidden-150 recipe's clean route
on it: K10's, K9's and K11's bf16 variants (ops/fused2.py), whose plain
versions run here against gnn_tpu's kernels in interpret mode, and the
routes not yet ported, which raise.

An f32 sum in another order can move a value across a bf16 rounding
boundary, so the two packages may differ by one rounding flip here and
there. The gate has two parts: at least 99% of the state (output) entries
within 1e-5 and of each grad tensor's entries within rtol 2e-4 (a floor of
2e-5 of its largest entry), which a different association of the rounding
points fails; and every entry within the change that one bf16 rounding flip
of U_a an iteration makes, derived here by running the plain version with
the largest bf(U_a) entry of every iteration one bf16 step larger
(`one_flip`).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.models import core as jcore
from gnn_tpu.ops import pallas_fused as jpf
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch import CompositeGNNgraphBased, GNNgraphBased, Predictor
from gnn_tpu_torch.convert import flatten
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_state_dim import NL, AL, DT, graphs, port_grads

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_bf16", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
LOSS = "categorical_crossentropy"
K, H1 = 4, 16
BF16 = torch.bfloat16


def batches(jgs, tgs, fused_layout=True):
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=fused_layout,
                                    adj_dtype=jnp.bfloat16)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=fused_layout,
                                    adj_dtype=BF16)
    return jb, tb


def bits(x):
    """The bf16 bits of a port or gnn_tpu adjacency."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def one_flip(fn, adj):
    """fn()'s outputs with the largest-magnitude entry of every bf(U_a)
    rounding one bf16 step larger, taken among the sources with an arc in
    `adj` (chip_smoke.py::one_flip): one rounding flip of U_a an iteration.
    The state enters an iteration only through bf(s), so a flip in a single
    iteration may move nothing downstream (a saturated unit) or a cascade of
    roundings; one in each covers the iteration that matters."""
    with chip_smoke.one_flip(torch, adj):
        return fn()


def hold(label, got, want, flipped, exact, share_tol):
    """The two-part gate: a share of at least 99% of the entries within
    share_tol(want) of gnn_tpu's, every entry within max(the one-flip
    change |flipped - exact| at its largest, share_tol(want))."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    tol = share_tol(want)
    share = float(np.mean(err <= tol))
    flip = float(np.abs(np.asarray(flipped, np.float64) - np.asarray(exact, np.float64)).max())
    assert share >= 0.99, f"{label}: {share:.4f} of the entries within tolerance"
    assert (err <= np.maximum(flip, tol)).all(), \
        f"{label}: {err.max():.3e} beyond the one-flip bound {flip:.3e}"


def state_tol(w):
    return np.full(w.shape, 1e-5)


def grad_tol(w):
    return 2e-4 * np.abs(w) + 2e-5 * np.abs(w).max()


# ---------------------------------------------------------------- batches
@pytest.mark.parametrize("fused_layout", [True, False])
def test_bf16_batch_matches_gnn_tpu(fused_layout):
    """A bf16 batch equals gnn_tpu's field for field, the adjacency bit for
    bit (rounded to nearest even from the f32 weights); the residual and arc
    weights stay f32; None and float32 keep the f32 batch."""
    jgs, tgs = graphs(0)
    jb, tb = batches(jgs, tgs, fused_layout)
    assert tb.adj_dtype == BF16 and tb.res_w.dtype == tb.edge_w.dtype == torch.float32
    if fused_layout:
        np.testing.assert_array_equal(bits(tb.adj_loop), bits(jb.adj_loop))
        np.testing.assert_array_equal(bits(tb.adj_dep), bits(jb.adj_dep))
        for f in ("loop_ids", "dep_ids", "block_perm", "res_src_loc", "res_dst_loc"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
        np.testing.assert_array_equal(tb.loop_nm.numpy(), np.asarray(jb.loop_nm))
    else:
        np.testing.assert_array_equal(bits(tb.adj_dep),
                                      bits(jnp.swapaxes(jb.adj_blocks, 1, 2)))
    np.testing.assert_array_equal(tb.res_w.numpy(), np.asarray(jb.res_w))
    np.testing.assert_array_equal(tb.edge_w.numpy(), np.asarray(jb.edge_w))
    np.testing.assert_array_equal(tb.agg_nodes_cache.numpy(), np.asarray(jb.agg_nodes_cache))
    f32 = tbatch.from_graphs_blocked(tgs, block_w=32, fused_layout=fused_layout)
    assert f32.adj_dtype == torch.float32
    assert tbatch.from_graphs_blocked(tgs, block_w=32, fused_layout=fused_layout,
                                      adj_dtype=torch.float32).adj_dtype == torch.float32
    np.testing.assert_array_equal(tb.adj_dep.float().numpy(),
                                  f32.adj_dep.to(BF16).float().numpy())
    assert tb.to("cpu").adj_dtype == BF16
    with pytest.raises(ValueError, match="adj_dtype"):
        tbatch.from_graphs_blocked(tgs, block_w=32, adj_dtype=torch.float16)


# ---------------------------------------------------------------- kernels
def kernel_operands(seed, act0, act1, affine):
    """Both packages' operands of the bf16 K10/K9/K11 from a bf16 batch's
    loop and dep blocks: node-major for the port, feature-major for gnn_tpu."""
    jgs, tgs = graphs(seed)
    _, tb = batches(jgs, tgs)
    g = np.random.default_rng(seed)
    D = 5

    def arr(*shape, scale=1.0):
        return torch.tensor(scale * g.standard_normal(shape), dtype=torch.float32)
    li = tb.loop_ids
    ops = dict(adjT=tb.adj_loop, nm=tb.loop_nm, s0=arr(len(li), 32, D, scale=0.5),
               fT=arr(len(li), 32, H1, scale=0.3), w20=arr(2 * H1, D, scale=D ** -0.5),
               w1=arr(D, H1, scale=H1 ** -0.5), b1=arr(D, scale=0.1),
               affine=(torch.stack([1 + arr(D, scale=0.1), arr(D, scale=0.1)]) if affine
                       else None))
    dep = dict(adjT=tb.adj_dep, s=arr(tb.adj_dep.shape[0], 32, D, scale=0.5),
               rT=arr(tb.adj_dep.shape[0], 32, H1, scale=0.1),
               fT=arr(tb.adj_dep.shape[0], 32, H1, scale=0.3))
    return ops, dep, dict(act0=act0, act1=act1)


@pytest.mark.parametrize("node,accepted", [(0, True), (1, False)])
def test_near_threshold_flags_accepts_only_a_node_at_the_threshold(node, accepted):
    """chip_smoke.py::near_threshold_flags, the rule for a K10_bf16 movement
    flag that differs from its plain version's: accepted where the plain
    version's ||s_k - s_k-1|| equals thr * ||s_k-1|| within the f32 rounding
    of the two norms (node 0: 0.25 against 0.25, exactly), refused elsewhere
    (node 1: 1 against 0.25)."""
    s0 = torch.tensor([[[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    traj = torch.tensor([[[[1.25, 0.0, 0.0], [2.0, 0.0, 0.0]]]]).expand(2, 1, 2, 3)
    want = (traj, torch.zeros(2, 1, 2))
    got = (traj, want[1].clone())
    got[1][1, 0, node] = 1.0
    assert chip_smoke.near_threshold_flags(torch, {"s0": s0, "threshold": 0.25}, got,
                                           want) is accepted


@pytest.mark.parametrize("rows,cols,shape", [(16, 16, (7, 5)), (160, 16, (150, 14)),
                                             (32, 48, (32, 33))])
def test_tile_bf16_rounds_once_and_pads_with_zeros(rows, cols, shape):
    """tile_bf16, the tensor-core kernels' weights: round_bf16's values in
    the top-left corner, exact zeros elsewhere, bf16."""
    w = torch.tensor(np.random.default_rng(rows + cols).standard_normal(shape),
                     dtype=torch.float32)
    t = tf2.tile_bf16(w, rows, cols)
    assert t.dtype == BF16 and t.shape == (rows, cols)
    full = torch.zeros(rows, cols)
    full[:shape[0], :shape[1]] = tf2.round_bf16("w", w)
    assert torch.equal(t.float(), full)


@pytest.mark.parametrize("act0,act1,affine", [("selu", "selu", False), ("tanh", "selu", True)])
def test_k10_bf16_plain_version_on_padded_weights(act0, act1, affine):
    """The zero padding of K10_bf16's tiles adds exact zeros: its plain
    version with the hidden width padded to 16 (zero rows of both halves of
    w20, zero columns of w1 and fT, as tile_bf16 pads them) gives the
    unpadded trajectory and margins bit for bit."""
    ops, _, acts = kernel_operands(3, act0, act1, affine)
    w20, w1, fT = ops["w20"], ops["w1"], ops["fT"]
    H = w1.shape[1]
    P = tf2.pad16(H + 1) - H        # H1 = 16 here: pad it to 32
    z = w20.new_zeros(P, w20.shape[1])
    pad = dict(ops, w20=torch.cat([w20[:H], z, w20[H:], z]),
               w1=torch.cat([w1, w1.new_zeros(w1.shape[0], P)], 1),
               fT=torch.cat([fT, fT.new_zeros(fT.shape[:-1] + (P,))], -1))
    for a, b in zip(tf2.propagation_loop2_bf16_ref(**pad, K=K, threshold=0.01, **acts),
                    tf2.propagation_loop2_bf16_ref(**ops, K=K, threshold=0.01, **acts)):
        assert torch.equal(a, b)


def fm(x):
    """Node-major [.., B, W, C] -> gnn_tpu's feature-major [.., B, C, W]."""
    return jnp.asarray(np.swapaxes(np.asarray(x), -1, -2))


def jaff(a):
    return None if a is None else jnp.asarray(a.numpy())


@pytest.mark.parametrize("act0,act1,affine", [("selu", "selu", False), ("tanh", "selu", True)])
def test_bf16_kernels_match_gnn_tpu(act0, act1, affine):
    """K10_bf16, K9_bf16 and K11_bf16's plain versions against gnn_tpu's
    _loop2_kernel_T, _step2_kernel_T and _loop2_bwd_kernel with hp false
    (interpret mode, jax.vjp for K11): iteration margins equal, the
    two-part gate on states and grads."""
    ops, dep, acts = kernel_operands(1, act0, act1, affine)
    B = ops["adjT"].shape[0]
    jargs = (jnp.asarray(bits(ops["adjT"]).view(jnp.bfloat16)), fm(ops["s0"]), fm(ops["fT"]),
             jnp.asarray(ops["w20"].numpy()), jnp.asarray(ops["w1"].numpy()),
             jnp.asarray(ops["b1"].numpy()), jaff(ops["affine"]))
    nmf = jnp.asarray(ops["nm"].numpy())

    def jloop(s0, fT, w20, w1, b1, aff):
        return jpf.fused_propagation_loop2(jargs[0], s0, fT, w20, w1, b1, aff, nmf, K, 0.01,
                                           act0, act1, B)
    (jtraj, jmarg), vjp = jax.vjp(jloop, *jargs[1:])
    targs = (ops["adjT"], ops["s0"], ops["fT"], ops["w20"], ops["w1"], ops["b1"],
             ops["affine"], ops["nm"], K, 0.01, act0, act1)
    traj, marg = tf2.propagation_loop2_bf16(*targs)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jmarg))
    ftraj, _ = one_flip(lambda: tf2.propagation_loop2_bf16(*targs), ops["adjT"])
    hold("K10_bf16 traj", traj, np.swapaxes(np.asarray(jtraj), -1, -2), ftraj, traj, state_tol)

    g = torch.tensor(np.random.default_rng(2).standard_normal(traj.shape), dtype=torch.float32)
    jg = vjp((fm(g), jnp.zeros_like(jmarg)))
    bargs = (ops["adjT"], ops["s0"], traj, ops["fT"], ops["w20"], ops["w1"], ops["b1"],
             ops["affine"], g, act0, act1)
    got = tf2.propagation_loop2_bwd_bf16(*bargs)
    flipped = one_flip(lambda: tf2.propagation_loop2_bwd_bf16(*bargs), ops["adjT"])

    def port(r):          # (gs, dfT, dw20, dw1, db1, daff) as gnn_tpu's cotangents
        gs, dw20, dw1, db1, dfT, daff = r
        return (gs.transpose(1, 2), dfT.transpose(1, 2), dw20.sum(0), dw1.sum(0), db1.sum(0),
                None if daff is None else daff.sum(0))
    for name, a, f, w in zip(("gs", "dfT", "dw20", "dw1", "db1", "daff"), port(got),
                             port(flipped), jg):
        if a is not None:
            hold(f"K11_bf16 {name}", a, w, f, a, grad_tol)

    rT = dep.pop("rT")
    sargs = (dep["adjT"], dep["s"], rT, dep["fT"], ops["w20"], ops["w1"], ops["b1"],
             ops["affine"], act0, act1)
    out = tf2.propagation_step2_bf16(*sargs)
    want = jpf.fused_propagation_step2(jnp.asarray(bits(dep["adjT"]).view(jnp.bfloat16)),
                                       fm(dep["s"]), fm(rT), fm(dep["fT"]), *jargs[3:], act0,
                                       act1, dep["adjT"].shape[0])
    fout = one_flip(lambda: tf2.propagation_step2_bf16(*sargs), dep["adjT"])
    hold("K9_bf16", out, np.swapaxes(np.asarray(want), -1, -2), fout, out, state_tol)


# ------------------------------------------------------------------ paths
def h150_specs(rate, **kw):
    """The hidden-150 recipe at small width (hidden H1): selu, no BatchNorm,
    AlphaDropout `rate` at both nets' input."""
    drop = dict(dropout_rate=(rate,), dropout_pos=(0,), alphadropout=True) if rate else {}
    sk = dict(input_dim=2 * NL + AL, units=(H1, NL), activations="selu",
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=False, **drop)
    ok = dict(input_dim=NL, units=(H1, DT), activations=("selu", "softmax"),
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              batch_normalization=False, **drop)
    common = dict(focus="g", max_iteration=K, threshold=0.01, **kw)
    return (jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), **common),
            tcore.GNNSpec(state_spec=TSpec(**sk), output_spec=TSpec(**ok), **common), sk, ok)


def model_of(sk, ok, jp, jbn):
    m = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01, seed=0,
                      device="cpu")
    m.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    return m


def test_h150_served_on_bf16_batch_matches_gnn_tpu():
    """The recipe served on a bf16 batch (K10_bf16 over the loop blocks, K9_bf16
    per step over the dep blocks) against gnn_tpu's hp = False kernels: equal
    iteration counts, the two-part gate on states and outputs; the
    Predictor with adj_dtype serves the same."""
    jgs, tgs = graphs(3)
    jb, tb = batches(jgs, tgs)
    js, ts, sk, ok = h150_specs(0.1)
    assert tcore._eval_route(ts, tb) == "hybrid2"
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    model = model_of(sk, ok, jp, jbn)
    want = jcore.gnn_forward(js, jp, jbn, jb, jax.random.key(1))
    got = model.forward(tb)
    flipped = one_flip(lambda: model.forward(tb), tb.adj_loop)
    assert float(got["iters"]) == float(want["iters"])
    for k in ("state", "out"):
        hold(f"h150 {k}", got[k], want[k], flipped[k], got[k], state_tol)
    tf2.reset_launches()
    served = Predictor(model, adj_dtype=BF16, device="cpu").predict(tgs, split=False)
    assert not any(tf2.launches.values())                   # plain versions on the CPU
    pb = Predictor(model, adj_dtype=BF16, device="cpu").build_batch(tgs)
    assert pb.adj_dtype == BF16
    ref = model.forward(pb)["out"].numpy()[pb.sel_mask.numpy()]
    np.testing.assert_array_equal(served, ref)


def test_h150_clean_step_on_bf16_batch_matches_gnn_tpu():
    """One h150_clean training step on a bf16 batch (K10_bf16 and K11_bf16
    over the loop blocks, K9_bf16 with gnn_tpu's f32 backward over the dep
    blocks) against gnn_tpu's make_train_step grads on its hp = False
    kernels: equal iteration counts, the loss within rtol 1e-5, the
    two-part gate on each grad tensor."""
    jgs, tgs = graphs(4)
    jb, tb = batches(jgs, tgs)
    js, ts, sk, ok = h150_specs(0.0)
    assert tcore._train_route(ts, tb) == "hybrid2"
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))

    def f(p):
        iters, loss, _ = jcore.evaluate_single(js, p, jbn, jb, jax.random.key(3), LOSS, {},
                                               training=True)
        return loss + jcore.regularization(js, p), (iters, loss)
    g_j, (iters_j, loss_j) = jax.grad(f, has_aux=True)(jp)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    want = flatten(jax.tree_util.tree_map(np.asarray, g_j))

    def step():
        m = model_of(sk, ok, jp, jbn)
        out = m.training_step(tb, masks={"state": {}, "output": {}})
        return out, port_grads(m.params)
    out, got = step()
    _, flipped = one_flip(step, tb.adj_loop)
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for key in want:
        hold(f"h150_clean grad {key}", got[key], want[key], flipped[key], got[key], grad_tol)


# ------------------------------------------------------- the other routes
def one_layer(rate, bn, act="selu"):
    drop = dict(dropout_rate=(rate,), dropout_pos=(0,), alphadropout=True) if rate else {}
    return TSpec(input_dim=2 * NL + AL, units=(NL,), activations=act,
                 batch_normalization=bn, **drop)


# each case's state net, whether it trains, its aggregation name and grad
# mode. Every kernel route runs on a bf16 batch (tests/test_torch_bf16_*.py);
# the dropout nets here leave the kernels for the plain body: one with an
# activation the kernels do not take ("dropout"), the two-layer one on the
# all-dep layout ("dropout_flat"), as gnn_tpu sends both to its XLA body;
# the two-layer BatchNorm nets on either layout ("bn2", "bn2_flat") train
# with the implicit adjoint (dropout-free, as it requires).
def bn2_net():
    return dataclasses.replace(TSpec(**h150_specs(0.0)[2]), batch_normalization=True)


ROUTES = {"plain_train": (lambda: one_layer(0.0, False), True, "segment", "unroll"),
          "dropout_flat": (lambda: h150_specs(0.1)[2], True, "fused", "unroll"),
          "dropout": (lambda: one_layer(0.1, False, "elu"), True, "auto", "unroll"),
          "ift1": (lambda: one_layer(0.0, False), True, "auto", "ift"),
          "bn2_flat": (bn2_net, True, "fused", "ift"),
          "bn2": (bn2_net, True, "auto", "ift"),
          "plain": (lambda: one_layer(0.0, False), False, "segment", "unroll"),
          "ift": (lambda: h150_specs(0.0)[2], True, "auto", "ift")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_other_routes_raise_on_bf16_batch(route):
    """Every route not yet ported to a bf16 batch (the plain body in training,
    dropout nets among them, and at eval, the implicit adjoint of a one- or
    two-layer net, the two-layer BatchNorm nets on either layout among them)
    raises NotImplementedError on it, naming the ROADMAP entry that ports
    it; none casts the batch to f32. (Every kernel route runs:
    tests/test_torch_bf16_flagship.py, test_torch_bf16_train.py,
    test_torch_bf16_dropout.py, test_torch_bf16_bn2.py,
    test_torch_bf16_composite.py and the tests above.)"""
    _, tgs = graphs(5)
    net, training, aggregation, grad_mode = ROUTES[route]
    _, tb = batches(tgs, tgs, fused_layout=not route.endswith("_flat"))
    ss = net()
    ss = ss if isinstance(ss, TSpec) else TSpec(**ss)
    spec = tcore.GNNSpec(focus="g", state_spec=ss,
                         output_spec=TSpec(input_dim=NL, units=(DT,), activations="softmax"),
                         max_iteration=K, aggregation=aggregation, grad_mode=grad_mode)
    route_of = tcore._train_route if training else tcore._eval_route
    assert route_of(spec, tb) == {"ift1": "hybrid", "ift": "hybrid2", "bn2": "bn",
                                  "bn2_flat": "bn", "plain_train": "plain",
                                  "dropout_flat": "plain", "dropout": "plain"}.get(route, route)
    params, bn = tcore.gnn_init(spec, torch.Generator().manual_seed(0))
    masks = tcore.draw_masks(spec, tb, torch.Generator().manual_seed(1)) if training else None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.gnn_forward(spec, params, bn, tb, training=training, masks=masks)


@pytest.mark.parametrize("training", [False, True])
def test_composite_routes_raise_on_bf16_batch(training):
    """A composite model whose per-type nets leave the typed kernels for the
    plain body raises on a bf16 batch: two dense layers a type at eval, the
    implicit adjoint in training. (The typed routes run:
    tests/test_torch_bf16_composite.py.)"""
    from test_torch_state_dim import graphs as typed
    _, tgs = typed(6, types=2)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, fused_layout=True, adj_dtype=BF16)
    drop = {} if training else dict(dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=True)
    ss = TSpec(input_dim=2 * NL + AL, units=(NL,) if training else (H1, NL),
               activations="selu", batch_normalization=True, **drop)
    m = CompositeGNNgraphBased([ss, ss], TSpec(input_dim=NL, units=(DT,),
                                               activations="softmax"),
                               grad_mode="ift" if training else "unroll", device="cpu")
    assert tcomp._route(m.spec, tb, training) == "plain"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if training:
            m.training_step(tb)
        else:
            m.forward(tb)
