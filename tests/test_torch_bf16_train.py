"""Training on a bf16 block adjacency in gnn_tpu_torch against gnn_tpu, on
the CPU: the hidden-150 recipe with input dropout (route 'dropout2': the bf16
variants of K12 and K13, ops/fused2.py, and the plain f32 dep step) and the
clean one-layer route ('hybrid': K3_bf16 and K4_bf16, differentiated through
K5's bf16 variant, ops/fused.py, and K4's f32 backward on the upcast
adjacency). The plain versions run here against gnn_tpu's kernels with hp
false in interpret mode.

The gate is tests/test_torch_bf16_adj.py's two-part gate (`hold`): at least
99% of the entries within 1e-5 (grads: rtol 2e-4 with a floor of 2e-5 of
the tensor's largest entry), and every entry within the change that one
bf16 rounding flip an iteration makes, derived by running the plain version
with that flip (`one_flip`). The flipped rounding is the one whose value is
a sum whose order differs between XLA and the port: the aggregated slice of
x3 ("x3") for K12_bf16 and the dropout2 step, bf(dh0) ("dh0", after dy0's
sum) for K13_bf16, bf(U_a) ("ua") for K5_bf16 and the clean step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.models import core as jcore
from gnn_tpu.ops import pallas_fused as jpf
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch.convert import flatten
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import fused as tfu
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_bf16_adj import fm, grad_tol, h150_specs, hold, state_tol
from test_torch_bf16_flagship import arrays, batches, jadj, model_of, one_flip
from test_torch_state_dim import AL, DT, NL, graphs, jax_draws, port_grads, with_mask

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
K, H1, D = 3, 24, 6


def keep_masks(g, shape, rate):
    """uint8 keep-masks, node-major (None without dropout)."""
    return torch.tensor(g.random(shape) > rate).to(torch.uint8) if rate else None


def jkeep(m, shape):
    """A port keep-mask as gnn_tpu's feature-major int8 (ones without dropout)."""
    return (jnp.ones(shape[:2] + (shape[3], shape[2]), jnp.float32) if m is None
            else fm(m.to(torch.int8)))


# ---------------------------------------------------------------- K12 / K13
def train2_operands(seed, rate):
    """K12's operands over a bf16 batch's loop blocks (W 32, D 6, H1 24)."""
    _, tb = batches(*graphs(seed))
    g, arr = arrays(seed)
    B = tb.adj_loop.shape[0]
    shape = (K, B, 32, D)
    return dict(adjT=tb.adj_loop, s0=arr(B, 32, D, scale=0.5), ms=keep_masks(g, shape, rate),
                ma=keep_masks(g, shape, rate), fd=arr(K, B, 32, AL, scale=0.5),
                w0=arr(H1, 2 * D + AL, scale=(2 * D + AL) ** -0.5), b0=arr(H1, scale=0.1),
                w1=arr(D, H1, scale=H1 ** -0.5), b1=arr(D, scale=0.1), nm=tb.loop_nm)


@pytest.mark.parametrize("act0,act1,alpha,rate", [("selu", "selu", True, 0.1),
                                                  ("tanh", "selu", False, 0.2),
                                                  ("selu", "tanh", True, 0.0)])
def test_k12_k13_bf16_match_gnn_tpu(act0, act1, alpha, rate):
    """K12_bf16's and K13_bf16's plain versions against gnn_tpu's
    _loop2_train_kernel_T and _loop2_train_bwd_kernel with hp false
    (interpret mode), both reverses from the port's trajectory and
    aggregations: the margins equal, the two-part gate on traj, agg (one
    flip of x3's aggregated slice), gs, the block-summed weight cotangents
    and dfd (one flip of bf(dh0))."""
    x = train2_operands(1, rate)
    B = x["adjT"].shape[0]
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha, rate=rate)
    jkw = dict(kw, K=K, group=B, interpret=True)
    shape = (K, B, 32, D)
    jw = [jnp.asarray(x[k].numpy()) for k in ("w0", "b0", "w1", "b1")]
    jms, jma = jkeep(x["ms"], shape), jkeep(x["ma"], shape)
    args = (x["adjT"], x["s0"], x["ms"], x["ma"], x["fd"], x["w0"], x["b0"], x["w1"], x["b1"],
            x["nm"], K, 0.05)
    traj, marg, agg = tf2.train_loop2_bf16(*args, **kw)
    jtraj, jmarg, jagg = jpf._loop2_train_impl(jadj(x["adjT"]), fm(x["s0"]), jms, jma,
                                               fm(x["fd"]), *jw, jnp.asarray(x["nm"].numpy()),
                                               threshold=0.05, **jkw)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jmarg))
    ftraj, _, fagg = one_flip(lambda: tf2.train_loop2_bf16(*args, **kw), x["adjT"], "x3")
    hold("K12_bf16 traj", traj, np.swapaxes(np.asarray(jtraj), -1, -2), ftraj, traj, state_tol)
    hold("K12_bf16 agg", agg, np.swapaxes(np.asarray(jagg), -1, -2), fagg, agg, state_tol)

    g = torch.tensor(np.random.default_rng(2).standard_normal(traj.shape), dtype=torch.float32)
    bargs = (x["adjT"], x["s0"], traj, agg, x["ms"], x["ma"], x["fd"], x["w0"], x["b0"],
             x["w1"], x["b1"], g)
    got = tf2.train_loop2_bwd_bf16(*bargs, **kw)
    want = jpf._loop2_train_bwd_impl(jadj(x["adjT"]), fm(x["s0"]), fm(traj), fm(agg), jms, jma,
                                     fm(x["fd"]), *jw, fm(g), **jkw)
    flipped = one_flip(lambda: tf2.train_loop2_bwd_bf16(*bargs, **kw), x["adjT"], "dh0")

    def port(r):          # (gs, dw0, db0, dw1, db1, dfd) as gnn_tpu's outputs
        gs, dw0, db0, dw1, db1, dfd = r
        return gs.transpose(1, 2), dw0.sum(0), db0.sum(0), dw1.sum(0), db1.sum(0), \
            dfd.transpose(-1, -2)
    assert got[1].shape == (B, H1, 2 * D + AL) and got[3].shape == (B, D, H1)
    for name, a, f, w in zip(("gs", "dw0", "db0", "dw1", "db1", "dfd"), port(got), port(flipped),
                             want):
        hold(f"K13_bf16 {name}", a, w, f, a, grad_tol)


# ---------------------------------------------------------------- K5
@pytest.mark.parametrize("act,affine", [("selu", True), ("tanh", False), ("selu", False)])
def test_k5_bf16_matches_gnn_tpu(act, affine):
    """K5_bf16's plain version against gnn_tpu's _loop_bwd_kernel with hp
    false (interpret mode) on K3_bf16's trajectory: the two-part gate on gs,
    the block-summed dw2 and daff, and dfT (one flip of U_a)."""
    _, tb = batches(*graphs(2))
    _, arr = arrays(2)
    Dn = NL
    B = tb.adj_loop.shape[0]
    w2 = arr(2 * Dn, Dn, scale=Dn ** -0.5)
    aff = torch.stack([1 + arr(Dn, scale=0.1), arr(Dn, scale=0.1)]) if affine else None
    s0, fT = arr(B, 32, Dn, scale=0.5), arr(B, 32, Dn, scale=0.3)
    traj, _ = tfu.propagation_loop_bf16(tb.adj_loop, s0, fT, w2, aff, tb.loop_nm, K, 0.01, act)
    g = torch.tensor(np.random.default_rng(3).standard_normal(traj.shape), dtype=torch.float32)
    args = (tb.adj_loop, s0, traj, fT, w2, aff, g, act)
    got = tfu.propagation_loop_bwd_bf16(*args)
    jaff_ = None if aff is None else jnp.asarray(aff.numpy())
    gs, dw2, dfT, daff = jpf._loop_bwd_impl(jadj(tb.adj_loop), fm(s0), fm(traj), fm(fT),
                                            jnp.asarray(w2.numpy()), jaff_, fm(g), K=K,
                                            activation=act, group=B, interpret=True)
    flipped = one_flip(lambda: tfu.propagation_loop_bwd_bf16(*args), tb.adj_loop, "ua")

    def port(r):          # (gs, dw2, dfT, daff) as gnn_tpu's outputs
        gs_, dw2_, dfT_, daff_ = r
        return (gs_.transpose(1, 2), dw2_.sum(0), dfT_.transpose(1, 2),
                None if daff_ is None else daff_.sum(0))
    want = (gs, dw2, dfT, None if daff is None else np.asarray(daff)[..., 0])
    assert (got[3] is None) == (not affine)
    for name, a, f, w in zip(("gs", "dw2", "dfT", "daff"), port(got), port(flipped), want):
        if a is not None:
            hold(f"K5_bf16 {name}", a, w, f, a, grad_tol)


# ------------------------------------------------------------------ steps
def jax_step(js, jp, jbn, jb, rng):
    """gnn_tpu's grads of one training step on its kernels (hp false), the
    state grads divided by the realised count: (grads by key, iters, loss)."""
    def f(p):
        iters, loss, _ = jcore.evaluate_single(js, p, jbn, jb, rng, LOSS, {}, training=True)
        return loss + jcore.regularization(js, p), (iters, loss)
    g_j, (iters_j, loss_j) = jax.jit(jax.grad(f, has_aux=True))(jp)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    return flatten(jax.tree_util.tree_map(np.asarray, g_j)), float(iters_j), float(loss_j)


def hold_step(label, js, jb, tb, sk, ok, jp, jbn, point, flip_adj, sd=0, **kw):
    """One port training step with gnn_tpu's masks against gnn_tpu's:
    iterations equal, the loss within rtol 1e-5, every grad tensor by the
    two-part gate (one flip at `point` an iteration)."""
    rng = jax.random.key(3)
    want, iters_j, loss_j = jax_step(js, jp, jbn, jb, rng)
    masks = with_mask(jax_draws(js, tb.n_node_pad, tb.n_node_pad, rng, True), tb.node_mask)

    def step():
        m = model_of(sk, ok, jp, jbn, sd, **kw)
        out = m.training_step(tb, masks=masks)
        return out, port_grads(m.params)
    tf2.reset_launches()
    tfu.reset_launches()
    out, got = step()
    assert not any(tf2.launches.values()) and not any(tfu.launches.values())
    _, flipped = one_flip(step, flip_adj, point)
    assert float(out["iters"]) == iters_j
    np.testing.assert_allclose(float(out["loss"]), loss_j, rtol=1e-5)
    assert got.keys() == want.keys()
    for key in want:
        hold(f"{label} grad {key}", got[key], want[key], flipped[key], got[key], grad_tol)


def test_dropout2_step_on_bf16_batch_matches_gnn_tpu():
    """One step of the hidden-150 recipe with its dropout on a bf16 batch
    (K12_bf16 and K13_bf16 over the loop blocks, the f32 dep step on the
    upcast adjacency) against gnn_tpu's make_train_step grads on its hp =
    False kernels with the same keep-masks: the two-part gate (one flip of
    x3's aggregated slice an iteration)."""
    jgs, tgs = graphs(4)
    jb, tb = batches(jgs, tgs)
    js, ts, sk, ok = h150_specs(0.1)
    assert tcore._train_route(ts, tb) == "dropout2"
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    hold_step("dropout2 bf16", js, jb, tb, sk, ok, jp, jbn, "x3", tb.adj_loop)


def clean_specs(sd=0, **kw):
    """The flagship's clean state net (no dropout, no BatchNorm) at small
    width, a softmax readout with dropout 0.1; state_dim `sd`."""
    sk = dict(input_dim=2 * (NL + sd) + AL, units=(sd or NL,), activations="selu",
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=False)
    ok = dict(input_dim=NL + sd, units=(DT,), activations="softmax",
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    common = dict(focus="g", state_dim=sd, max_iteration=4, threshold=0.01, **kw)
    return (jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), **common),
            tcore.GNNSpec(state_spec=TSpec(**sk), output_spec=TSpec(**ok), **common), sk, ok)


@pytest.mark.parametrize("fused_layout,sd", [(True, 0), (False, 0), (True, 5)])
def test_clean_step_on_bf16_batch_matches_gnn_tpu(fused_layout, sd):
    """One clean one-layer step on a bf16 batch: K3_bf16 over the loop blocks
    (backward K5_bf16) and K4_bf16 per step over the dep blocks (backward
    gnn_tpu's f32 rule on the upcast adjacency), or K4_bf16 over every block
    under aggregation='fused' (the all-dep layout), against gnn_tpu's grads
    on its hp = False kernels: the two-part gate (one flip of U_a an
    iteration); state_dim 5 with gnn_tpu's initial state."""
    jgs, tgs = graphs(6)
    jb, tb = batches(jgs, tgs, fused_layout)
    agg = "auto" if fused_layout else "fused"
    js, ts, sk, ok = clean_specs(sd, aggregation=agg)
    assert tcore._train_route(ts, tb) == "hybrid"
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    hold_step("clean bf16", js, jb, tb, sk, ok, jp, jbn, "ua",
              tb.adj_loop if fused_layout else tb.adj_dep, sd, aggregation=agg)


@pytest.mark.parametrize("route", ["hybrid", "dropout2"])
def test_float64_batch_keeps_its_dtype(route):
    """The two routes that upcast a bf16 adjacency (K4's f32 backward, the
    dropout2 dep step) leave a float64 batch's adjacency float64: a float64
    step on an f32-layout batch (chip_smoke.py's float64 twins) runs and
    gives float64 grads."""
    import dataclasses
    _, tgs = graphs(7)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    tb = dataclasses.replace(tb, **{f.name: getattr(tb, f.name).double()
                                    for f in dataclasses.fields(tb)
                                    if isinstance(getattr(tb, f.name), torch.Tensor)
                                    and getattr(tb, f.name).dtype == torch.float32})
    assert tb.adj_dep.dtype == torch.float64
    js, ts, sk, ok = clean_specs() if route == "hybrid" else h150_specs(0.1)
    assert tcore._train_route(ts, tb) == route
    m = model_of(sk, ok, *jcore.gnn_init(js, jax.random.key(0)))
    for leaf in tcore.param_leaves(m.params):
        leaf.data = leaf.data.double()
    masks = jax_draws(js, tb.n_node_pad, tb.n_node_pad, jax.random.key(3), True)
    masks = {k: v for k, v in masks.items() if k != "init"}
    m.training_step(tb, masks=masks)
    assert all(leaf.grad.dtype == torch.float64 for leaf in tcore.param_leaves(m.params))


# ---------------------------------------------------------------- wrappers
def test_bf16_train_wrappers_check_their_operands():
    """The new bf16 wrappers launch nothing on the CPU, mirror their CTAs'
    shared memory (the widths whose CTA does not fit raise ValueError naming
    the limit: no wide plan, no fallback), and refuse an adjacency that is
    not bf16 or not 16-byte aligned and keep-masks that are not uint8."""
    x = train2_operands(5, 0.1)
    tf2.reset_launches()
    traj, _, agg = tf2.train_loop2_bf16(**x, K=K, threshold=0.01)
    tf2.train_loop2_bwd_bf16(x["adjT"], x["s0"], traj, agg, x["ms"], x["ma"], x["fd"], x["w0"],
                             x["b0"], x["w1"], x["b1"], torch.ones_like(traj))
    assert not any(tf2.launches.values())
    C, CH = 2 * 14 + 3, tf2.BF16_CHUNK
    assert tf2.bf16_smem_bytes("K12_bf16", 128, 14, 3) == 2 * 128 * 128 + 4 * 128 * (
        2 * 14 + C + CH)
    assert tf2.bf16_smem_bytes("K13_bf16", 128, 14, 3) == 2 * 128 * 128 + 4 * 128 * (
        2 * 14 + 3 * C + 3 * CH)
    assert tf2.bf16_smem_bytes("K5_bf16", 128, 14) == tf2.bf16_smem_bytes("K11_bf16", 128, 14)

    class Card:           # a bf16 adjacency whose checks run as on the card
        def __init__(self, t, dtype=torch.bfloat16, ptr=0):
            self.shape, self.dtype, self.ptr, self.device = t.shape, dtype, ptr, \
                torch.device("cuda")

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return self.ptr
    adj = torch.empty((2, 128, 128))
    tf2._check_bf16(Card(adj), 14, 150, "K13_bf16", 3)
    with pytest.raises(ValueError, match="shared memory"):
        tf2._check_bf16(Card(adj), 14, 150, "K13_bf16", 120)
    with pytest.raises(ValueError, match="shared memory"):
        tf2._check_bf16(Card(adj), 90, 150, "K12_bf16", 3)
    with pytest.raises(ValueError, match="shared memory"):
        tf2._check_bf16(Card(adj), 100, 100, "K5_bf16")
    with pytest.raises(ValueError, match="bf16 adjT"):
        tf2._check_bf16(Card(adj, torch.float32), 14, 150, "K12_bf16", 3)
    with pytest.raises(ValueError, match="aligned"):
        tf2._check_bf16(Card(adj, ptr=8), 14, 150, "K13_bf16", 3)
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match="uint8"):
        tfu._check_keep(x["ms"].bool(), x["ms"].shape, dev, 0.1, "ms")
