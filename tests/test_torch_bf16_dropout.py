"""The flagship's BatchNorm-free dropout route on a bf16 block adjacency in
gnn_tpu_torch against gnn_tpu, on the CPU: route 'dropout' through the bf16
variants of K7 and K8 over the loop blocks and K6's per step over the dep
blocks (ops/fused.py), K6's backward f32 on the upcast adjacency, or K6's per
step over every block under aggregation='fused' (the all-dep layout). The
plain versions run here against gnn_tpu's kernels with hp false in interpret
mode.

The gate is tests/test_torch_bf16_adj.py's two-part gate (`hold`): at least
99% of the entries within 1e-5 (grads: rtol 2e-4 with a floor of 2e-5 of
the tensor's largest entry), and every entry within the change that one
bf16 rounding flip an iteration makes, derived by running the plain version
with that flip (`one_flip`). The flipped rounding is the one whose value is
a sum whose order differs between XLA and the port: the aggregated slice of
x2 ("agg") for K7, K6 and the route's step, bf(dh) ("dh", after the
recomputed dense layer) for K8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.models import core as jcore
from gnn_tpu.ops import pallas_fused as jpf
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import fused as tfu
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_bf16_adj import fm, grad_tol, hold, state_tol
from test_torch_bf16_flagship import arrays, batches, jadj, model_of, one_flip
from test_torch_bf16_train import hold_step, jkeep, keep_masks
from test_torch_state_dim import AL, DT, NL, graphs, jax_draws

torch.set_num_threads(1)
K, D = 3, NL


def loop_operands(seed, rate):
    """K7's operands over a bf16 batch's loop blocks (W 32, D 4)."""
    _, tb = batches(*graphs(seed))
    g, arr = arrays(seed)
    B = tb.adj_loop.shape[0]
    shape = (K, B, 32, D)
    return dict(adjT=tb.adj_loop, s0=arr(B, 32, D, scale=0.5), ms=keep_masks(g, shape, rate),
                ma=keep_masks(g, shape, rate), fT=arr(K, B, 32, D, scale=0.3),
                w_cat=arr(D, 2 * D, scale=(2 * D) ** -0.5), nm=tb.loop_nm)


# ---------------------------------------------------------------- K7 / K8
@pytest.mark.parametrize("act,alpha,rate", [("selu", True, 0.1), ("tanh", False, 0.1),
                                            ("selu", True, 0.0)])
def test_k7_k8_bf16_match_gnn_tpu(act, alpha, rate):
    """K7_bf16's and K8_bf16's plain versions against gnn_tpu's
    _loop_train_kernel_T and _loop_train_bwd_kernel with hp false
    (interpret mode), the reverse from the port's trajectory and
    aggregations: the margins equal, the two-part gate on traj, agg (one
    flip of x2's aggregated slice), gs, the block-summed dw and dfT (one
    flip of bf(dh))."""
    x = loop_operands(1, rate)
    B = x["adjT"].shape[0]
    kw = dict(activation=act, alpha_drop=alpha, rate=rate)
    jkw = dict(kw, K=K, group=B, interpret=True)
    shape = (K, B, 32, D)
    jw = jnp.asarray(x["w_cat"].numpy())
    jms, jma = jkeep(x["ms"], shape), jkeep(x["ma"], shape)
    args = (x["adjT"], x["s0"], x["ms"], x["ma"], x["fT"], x["w_cat"], x["nm"], K, 0.05)
    traj, marg, agg = tfu.train_loop_bf16(*args, **kw)
    jtraj, jmarg, jagg = jpf._loop_train_impl(jadj(x["adjT"]), fm(x["s0"]), jms, jma,
                                              fm(x["fT"]), jw, jnp.asarray(x["nm"].numpy()),
                                              threshold=0.05, **jkw)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jmarg))
    ftraj, _, fagg = one_flip(lambda: tfu.train_loop_bf16(*args, **kw), x["adjT"], "agg")
    hold("K7_bf16 traj", traj, np.swapaxes(np.asarray(jtraj), -1, -2), ftraj, traj, state_tol)
    hold("K7_bf16 agg", agg, np.swapaxes(np.asarray(jagg), -1, -2), fagg, agg, state_tol)

    g = torch.tensor(np.random.default_rng(2).standard_normal(traj.shape), dtype=torch.float32)
    bargs = (x["adjT"], x["s0"], traj, agg, x["ms"], x["ma"], x["fT"], x["w_cat"], g)
    got = tfu.train_loop_bwd_bf16(*bargs, **kw)
    want = jpf._loop_train_bwd_impl(jadj(x["adjT"]), fm(x["s0"]), fm(traj), fm(agg), jms, jma,
                                    fm(x["fT"]), jw, fm(g), **jkw)
    flipped = one_flip(lambda: tfu.train_loop_bwd_bf16(*bargs, **kw), x["adjT"], "dh")

    def port(r):          # (gs, dw, dfT) as gnn_tpu's outputs
        gs, dw, dfT = r
        return gs.transpose(1, 2), dw.sum(0), dfT.transpose(-1, -2)
    assert got[1].shape == (B, D, 2 * D)
    for name, a, f, w in zip(("gs", "dw", "dfT"), port(got), port(flipped), want):
        hold(f"K8_bf16 {name}", a, w, f, a, grad_tol)


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("act,alpha,rate,H,res", [("selu", True, 0.1, D, True),
                                                  ("tanh", False, 0.1, 7, True),
                                                  ("selu", True, 0.0, D, False)])
def test_k6_bf16_matches_gnn_tpu(act, alpha, rate, H, res):
    """K6_bf16's plain version against gnn_tpu's _train_kernel_T with hp
    false (interpret mode) over the dep blocks, with and without the raw
    residual aggregation, H = D and H != D: the two-part gate on y and agg
    (one flip of x2's aggregated slice)."""
    _, tb = batches(*graphs(3))
    g, arr = arrays(3)
    Bd = tb.adj_dep.shape[0]
    kw = dict(activation=act, alpha_drop=alpha, rate=rate)
    m = keep_masks(g, (Bd, 32, D), rate)
    args = (tb.adj_dep, arr(Bd, 32, D, scale=0.5), arr(Bd, 32, D, scale=0.5), m,
            arr(Bd, 32, D, scale=0.3) if res else None, arr(Bd, 32, H, scale=0.3),
            arr(H, 2 * D, scale=(2 * D) ** -0.5))
    y, agg = tfu.train_step_bf16(*args, **kw)
    jm = jkeep(None if m is None else m[None], (1, Bd, 32, D))[0]
    jy, jagg = jpf._train_fwd_impl(jadj(tb.adj_dep), fm(args[1]), fm(args[2]), jm,
                                   None if args[4] is None else fm(args[4]), fm(args[5]),
                                   jnp.asarray(args[6].numpy()), group=Bd, interpret=True, **kw)
    fy, fagg = one_flip(lambda: tfu.train_step_bf16(*args, **kw), tb.adj_dep, "agg")
    assert y.shape == (Bd, 32, H)
    hold("K6_bf16 y", y, np.swapaxes(np.asarray(jy), -1, -2), fy, y, state_tol)
    hold("K6_bf16 agg", agg, np.swapaxes(np.asarray(jagg), -1, -2), fagg, agg, state_tol)


# ------------------------------------------------------------------ steps
def dropout_specs(sd=0, **kw):
    """The flagship's BatchNorm-free state net at small width: selu,
    AlphaDropout 0.1 at its input, no BatchNorm; a softmax readout with
    dropout 0.1; state_dim `sd`."""
    sk = dict(input_dim=2 * (NL + sd) + AL, units=(sd or NL,), activations="selu",
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=False, dropout_rate=(0.1,), dropout_pos=(0,),
              alphadropout=True)
    ok = dict(input_dim=NL + sd, units=(DT,), activations="softmax",
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    common = dict(focus="g", state_dim=sd, max_iteration=4, threshold=0.01, **kw)
    return (jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), **common),
            tcore.GNNSpec(state_spec=TSpec(**sk), output_spec=TSpec(**ok), **common), sk, ok)


@pytest.mark.parametrize("fused_layout,sd", [(True, 0), (False, 0), (True, 5)])
def test_dropout_step_on_bf16_batch_matches_gnn_tpu(fused_layout, sd):
    """One step of route 'dropout' on a bf16 batch: K7_bf16 over the loop
    blocks (backward K8_bf16) and K6_bf16 per step over the dep blocks
    (backward gnn_tpu's f32 rule on the upcast adjacency), or K6_bf16 over
    every block under aggregation='fused' (the all-dep layout), against
    gnn_tpu's make_train_step grads on its hp = False kernels with the same
    keep-masks: iterations equal, the loss within rtol 1e-5, every grad by
    the two-part gate (one flip of x2's aggregated slice an iteration);
    state_dim 5 with gnn_tpu's initial state."""
    jgs, tgs = graphs(8)
    jb, tb = batches(jgs, tgs, fused_layout)
    agg = "auto" if fused_layout else "fused"
    js, ts, sk, ok = dropout_specs(sd, aggregation=agg)
    assert tcore._train_route(ts, tb) == "dropout"
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    hold_step("dropout bf16", js, jb, tb, sk, ok, jp, jbn, "agg",
              tb.adj_loop if fused_layout else tb.adj_dep, sd, aggregation=agg)


def test_float64_dropout_batch_keeps_its_dtype():
    """K6's backward upcasts a bf16 adjacency only: a float64 step of route
    'dropout' on an f32-layout batch (chip_smoke.py's float64 twins) runs and
    gives float64 grads."""
    _, tgs = graphs(7)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    tb = dataclasses.replace(tb, **{f.name: getattr(tb, f.name).double()
                                    for f in dataclasses.fields(tb)
                                    if isinstance(getattr(tb, f.name), torch.Tensor)
                                    and getattr(tb, f.name).dtype == torch.float32})
    assert tb.adj_dep.dtype == torch.float64
    js, ts, sk, ok = dropout_specs()
    assert tcore._train_route(ts, tb) == "dropout"
    m = model_of(sk, ok, *jcore.gnn_init(js, jax.random.key(0)))
    for leaf in tcore.param_leaves(m.params):
        leaf.data = leaf.data.double()
    masks = jax_draws(js, tb.n_node_pad, tb.n_node_pad, jax.random.key(3), True)
    m.training_step(tb, masks={k: v for k, v in masks.items() if k != "init"})
    assert all(leaf.grad.dtype == torch.float64 for leaf in tcore.param_leaves(m.params))


# ---------------------------------------------------------------- wrappers
def test_bf16_dropout_wrappers_check_their_operands():
    """The bf16 dropout wrappers launch nothing on the CPU, mirror their
    CTAs' shared memory (a width whose CTA does not fit raises ValueError
    naming the limit: no wide plan, no fallback), and refuse an adjacency
    that is not bf16 or not 16-byte aligned, a loop of H != D and keep-masks
    that are not uint8."""
    x = loop_operands(5, 0.1)
    tfu.reset_launches()
    traj, _, agg = tfu.train_loop_bf16(**x, K=K, threshold=0.01)
    tfu.train_loop_bwd_bf16(x["adjT"], x["s0"], traj, agg, x["ms"], x["ma"], x["fT"],
                            x["w_cat"], torch.ones_like(traj))
    tfu.train_step_bf16(x["adjT"], x["s0"], x["s0"], x["ma"][0], None, x["fT"][0], x["w_cat"])
    assert not any(tfu.launches.values())
    for k, rows, wide in (("K7_bf16", 2, 1), ("K8_bf16", 2, 2), ("K6_bf16", 1, 1)):
        assert tf2.bf16_smem_bytes(k, 128, 14) == 2 * 128 * 128 + 4 * 128 * 14 * (rows + 2 * wide)

    class Card:           # a bf16 adjacency whose checks run as on the card
        def __init__(self, dtype=torch.bfloat16, ptr=0):
            self.shape, self.dtype, self.ptr, self.device = (2, 128, 128), dtype, ptr, \
                torch.device("cuda")

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return self.ptr
    # at W 128 the CTAs fit to D 97 (K7), 65 (K8) and 130 (K6, any H)
    for k, fits in (("K7_bf16", 97), ("K8_bf16", 65), ("K6_bf16", 130)):
        tf2._check_bf16(Card(), fits, 5, k)
        with pytest.raises(ValueError, match="shared memory"):
            tf2._check_bf16(Card(), fits + 1, 5, k)
    with pytest.raises(ValueError, match="bf16 adjT"):
        tf2._check_bf16(Card(torch.float32), 14, 14, "K6_bf16")
    with pytest.raises(ValueError, match="aligned"):
        tf2._check_bf16(Card(ptr=8), 14, 14, "K7_bf16")
    with pytest.raises(ValueError, match="H == D"):
        tfu._check_loop_width(14, 7)
    with pytest.raises(ValueError, match="uint8"):
        tfu._check_keep(x["ms"].bool(), x["ms"].shape, torch.device("cpu"), 0.1, "ms")


def test_check_adj_dtype_admits_the_dropout_route():
    """On a bf16 batch check_adj_dtype admits route 'dropout' unrolled, as
    it does every kernel route ('hybrid', 'hybrid2', 'dropout2', 'bn' of
    either depth, the composite 'typed_bn' and 'typed_eval'), and still
    raises NotImplementedError naming the ROADMAP entry for the plain body
    and grad_mode='ift' (the dropout, two-layer BatchNorm and typed routes'
    too); an f32 batch passes every route."""
    _, tgs = graphs(9)
    _, tb = batches(tgs, tgs)
    for route in ("dropout", "hybrid", "hybrid2", "dropout2", "bn", "typed_bn", "typed_eval"):
        tcore.check_adj_dtype(tb, route, True, "unroll")
    # composite.py's routes take the same check
    for route, mode in (("bn", "ift"), ("plain", "unroll"), ("dropout", "ift"),
                        ("hybrid", "ift"), ("typed_bn", "ift"), ("typed_eval", "ift")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcore.check_adj_dtype(tb, route, True, mode)
    f32 = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=True)
    tcore.check_adj_dtype(f32, "plain", True, "ift")
