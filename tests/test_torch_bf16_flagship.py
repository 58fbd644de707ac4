"""The flagship on a bf16 block adjacency in gnn_tpu_torch against gnn_tpu,
on the CPU: served through the bf16 variants of K3/K4 (ops/fused.py) and
trained on the BatchNorm route through those of K1/K2 (ops/bn.py), whose
plain versions run here against gnn_tpu's kernels with hp false in
interpret mode.

The gate is tests/test_torch_bf16_adj.py's two-part gate (`hold`): at least
99% of the entries within 1e-5 (grads: rtol 2e-4 with a floor of 2e-5 of
the tensor's largest entry), and every entry within the change that one
bf16 rounding flip an iteration makes, derived by running the plain version
with that flip (`one_flip`). The flipped rounding is the one whose value is
a sum, whose order differs between XLA and the port: bf(U_a) ("ua") for
K3/K4; for K1 the aggregated slice of x3 ("agg"), and for K2 bf(dh)
("dh", after the recomputed dense layer). In the BN step the batch moments
are global f32 sums too, so bf(s) may flip in a later iteration; the
step's bound flips "agg" an iteration, which carries such a flip's reach.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.models import core as jcore
from gnn_tpu.ops import pallas_bn as jpb
from gnn_tpu.ops import pallas_fused as jpf
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch import GNNgraphBased, Predictor
from gnn_tpu_torch.convert import flatten
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused as tfu
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_bf16_adj import bits, fm, grad_tol, hold, jaff, state_tol
from test_torch_state_dim import AL, DT, NL, graphs, jax_draws, port_grads, with_mask

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_bf16_flagship", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
LOSS = "categorical_crossentropy"
K = 4
BF16 = torch.bfloat16


def one_flip(fn, adj, point):
    """fn()'s outputs with the largest-magnitude entry of every bf16 rounding
    at `point` one bf16 step larger (chip_smoke.py::one_flip)."""
    with chip_smoke.one_flip(torch, adj, point):
        return fn()


def batches(jgs, tgs, fused_layout=True):
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=fused_layout,
                                    adj_dtype=jnp.bfloat16)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=fused_layout,
                                    adj_dtype=BF16)
    return jb, tb


def jadj(adj):
    """The port's bf16 adjacency as gnn_tpu's, bit for bit."""
    return jnp.asarray(bits(adj).view(jnp.bfloat16))


def arrays(seed):
    g = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.tensor(scale * g.standard_normal(shape), dtype=torch.float32)
    return g, arr


# ---------------------------------------------------------------- K3 / K4
@pytest.mark.parametrize("act,affine", [("selu", True), ("tanh", False), ("relu", True)])
def test_k3_k4_bf16_match_gnn_tpu(act, affine):
    """K3_bf16's and K4_bf16's plain versions against gnn_tpu's
    _loop_kernel_T and _step_kernel_T with hp false (interpret mode): the
    margins equal, the two-part gate on the states (one flip of U_a)."""
    _, tb = batches(*graphs(1))
    _, arr = arrays(1)
    D = NL
    li = tb.loop_ids
    w2 = arr(2 * D, D, scale=D ** -0.5)
    aff = torch.stack([1 + arr(D, scale=0.1), arr(D, scale=0.1)]) if affine else None
    s0, fT = arr(len(li), 32, D, scale=0.5), arr(len(li), 32, D, scale=0.3)
    args = (tb.adj_loop, s0, fT, w2, aff, tb.loop_nm, K, 0.01, act)
    traj, marg = tfu.propagation_loop_bf16(*args)
    jtraj, jmarg = jpf.fused_propagation_loop(jadj(tb.adj_loop), fm(s0), fm(fT),
                                              jnp.asarray(w2.numpy()), jaff(aff),
                                              jnp.asarray(tb.loop_nm.numpy()), K, 0.01, act,
                                              len(li))
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jmarg))
    ftraj, _ = one_flip(lambda: tfu.propagation_loop_bf16(*args), tb.adj_loop, "ua")
    hold("K3_bf16 traj", traj, np.swapaxes(np.asarray(jtraj), -1, -2), ftraj, traj, state_tol)

    Bd = tb.adj_dep.shape[0]
    s, rT, fTd = arr(Bd, 32, D, scale=0.5), arr(Bd, 32, D, scale=0.1), arr(Bd, 32, D, scale=0.3)
    sargs = (tb.adj_dep, s, rT, fTd, w2, aff, act)
    out = tfu.propagation_step_bf16(*sargs)
    want = jpf.fused_propagation_step(jadj(tb.adj_dep), fm(s), fm(rT), fm(fTd),
                                      jnp.asarray(w2.numpy()), jaff(aff), act, Bd)
    fout = one_flip(lambda: tfu.propagation_step_bf16(*sargs), tb.adj_dep, "ua")
    hold("K4_bf16", out, np.swapaxes(np.asarray(want), -1, -2), fout, out, state_tol)


# ---------------------------------------------------------------- K1 / K2
def bn_operands(seed, rate, res):
    """K1's and K2's operands over a bf16 batch's block rows [loop | dep]
    (uint8 keep-masks in x3 column order, 16-byte aligned)."""
    _, tb = batches(*graphs(seed))
    g, arr = arrays(seed)
    R = tb.adj_loop.shape[0] + tb.adj_dep.shape[0]
    D, F = NL, AL
    C = 2 * D + F + 1
    nm = torch.cat([tb.loop_nm, torch.ones(tb.adj_dep.shape[0], 32)])
    aff = torch.stack([torch.stack([1 + arr(D, scale=0.2), arr(D, scale=0.1)])
                       for _ in range(2)])
    keep = (torch.tensor(g.random((R, 32, 2 * D + F)) > rate).to(torch.uint8) if rate
            else None)
    fwd = dict(adj_loop=tb.adj_loop, adj_dep=tb.adj_dep, y1=arr(R, 32, D), y2=arr(R, 32, D),
               aff=aff, keep=keep, rT=arr(R, 32, D, scale=0.3) if res else None,
               feats=arr(R, 32, F, scale=0.5), w_aug=arr(D, C, scale=0.5 / D ** 0.5), nm=nm)
    bwd = dict(adj_loop=tb.adj_loop, adj_dep=tb.adj_dep, y_prev=fwd["y1"], y_k=arr(R, 32, D),
               agg=arr(R, 32, D), keep=keep, feats=fwd["feats"], w_aug=fwd["w_aug"],
               ds_in=arr(R, 32, D, scale=0.1), gsel=arr(R, 32, D, scale=0.1),
               bnv=torch.tensor(0.5 + g.random((9, D)), dtype=torch.float32),
               flag=torch.tensor(1.0), nm=nm)
    return fwd, bwd, torch.cat([tb.adj_loop, tb.adj_dep])


@pytest.mark.parametrize("act,rate,alpha,res", [("selu", 0.1, True, True),
                                                ("tanh", 0.2, False, True),
                                                ("relu", 0.0, True, False)])
def test_k1_k2_bf16_match_gnn_tpu(act, rate, alpha, res):
    """K1_bf16's and K2_bf16's plain versions against gnn_tpu's
    _bn_fwd_call and _bn_bwd_call with hp false (interpret mode): the
    movement flags equal, the two-part gate on y, agg, the block sums, ds,
    dagg, dw and red (K1 one flip of the aggregated slice of x3, K2 of
    bf(dh))."""
    fwd, bwd, adj = bn_operands(2, rate, res)
    R = adj.shape[0]
    kw = dict(activation=act, alpha_drop=alpha, rate=rate)
    mc = None if fwd["keep"] is None else fm(fwd["keep"].to(torch.int8))
    jkw = dict(kw, group=R, interpret=True)
    nmf = jnp.asarray(fwd["nm"].numpy())[:, None, :]
    y, agg, marg, msum = tbn.bn_forward_step_bf16(**fwd, **kw, threshold=0.05)
    jy, jagg, jmarg, jmsum = jpb._bn_fwd_call(
        jadj(adj), fm(fwd["y1"]), fm(fwd["y2"]), jnp.asarray(fwd["aff"].numpy())[..., None], mc,
        None if fwd["rT"] is None else fm(fwd["rT"]), fm(fwd["feats"]),
        jnp.asarray(fwd["w_aug"].numpy()), nmf, thr=0.05, **jkw)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jmarg)[:, 0])
    np.testing.assert_allclose(agg.numpy(), np.swapaxes(np.asarray(jagg), -1, -2), atol=1e-5)
    flipped = one_flip(lambda: tbn.bn_forward_step_bf16(**fwd, **kw, threshold=0.05), adj, "agg")
    hold("K1_bf16 y", y, np.swapaxes(np.asarray(jy), -1, -2), flipped[0], y, state_tol)
    hold("K1_bf16 msum", msum.sum(0), np.asarray(jmsum).sum((0, 1)), flipped[3].sum(0),
         msum.sum(0), grad_tol)

    got = tbn.bn_backward_step_bf16(**bwd, **kw)
    bnv = jnp.zeros((16, NL)).at[:9].set(jnp.asarray(bwd["bnv"].numpy()))[..., None]
    want = jpb._bn_bwd_call(jadj(adj), fm(bwd["y_prev"]), fm(bwd["y_k"]), fm(bwd["agg"]), mc,
                            fm(bwd["feats"]), jnp.asarray(bwd["w_aug"].numpy()),
                            fm(bwd["ds_in"]), fm(bwd["gsel"]), bnv, jnp.ones((1, 1)), nmf,
                            **jkw)
    flipped = one_flip(lambda: tbn.bn_backward_step_bf16(**bwd, **kw), adj, "dh")

    def port(r):          # (ds, dw, dagg, red) as gnn_tpu's outputs
        ds, dw, dagg, red = r
        return ds.transpose(1, 2), dw.sum(0), dagg.transpose(1, 2), red.sum(0)
    for name, a, f, w in zip(("ds", "dw", "dagg", "red"), port(got), port(flipped), want):
        hold(f"K2_bf16 {name}", a, w, f, a, grad_tol)


def test_bf16_wrappers_check_their_operands():
    """The bf16 wrappers launch nothing on the CPU, count no launch there,
    and mirror the shared memory of their CTAs: the widths whose CTA does
    not fit raise ValueError naming the limit (no wide plan, no fallback)."""
    fwd, bwd, _ = bn_operands(3, 0.1, True)
    tbn.reset_launches()
    tfu.reset_launches()
    tbn.bn_forward_step_bf16(**fwd, activation="selu", alpha_drop=True, rate=0.1,
                             threshold=0.01)
    assert not any(tbn.launches.values()) and not any(tfu.launches.values())
    assert tbn.bn_bf16_smem_bytes(128, 14, 3) == 2 * 128 * 128 + 4 * 128 * 73
    meta = torch.empty((2, 128, 128), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        tbn._check_bf16_blocks(meta, None, 2, 90, 3, "K1_bf16")
    with pytest.raises(ValueError, match="bf16"):
        tbn._check_bf16_blocks(meta.float(), None, 2, 14, 3, "K2_bf16")
    with pytest.raises(ValueError, match="block rows"):
        tbn._check_bf16_blocks(meta, None, 3, 14, 3, "K2_bf16")
    assert tbn._check_bf16_blocks(None, meta, 2, 14, 3, "K1_bf16") == (0, 128)


# ------------------------------------------------------------------ paths
def flagship_specs(sd=0, **kw):
    """The flagship's nets at small width: selu, AlphaDropout 0.1 at the state
    net's input, the trailing BatchNorm (the reference default); a softmax
    readout with dropout 0.1; state_dim `sd`."""
    sk = dict(input_dim=2 * (NL + sd) + AL, units=(sd or NL,), activations="selu",
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=True, dropout_rate=(0.1,), dropout_pos=(0,),
              alphadropout=True)
    ok = dict(input_dim=NL + sd, units=(DT,), activations="softmax",
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              dropout_rate=(0.1,), dropout_pos=(0,), batch_normalization=False)
    common = dict(focus="g", state_dim=sd, max_iteration=K, threshold=0.01, **kw)
    return (jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), **common),
            tcore.GNNSpec(state_spec=TSpec(**sk), output_spec=TSpec(**ok), **common), sk, ok)


def model_of(sk, ok, jp, jbn, sd=0, **kw):
    m = GNNgraphBased(TSpec(**sk), TSpec(**ok), max_iteration=K, threshold=0.01, seed=0,
                      state_vect_dim=sd, device="cpu", **kw)
    m.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    return m


def init(js):
    """gnn_tpu's weights with non-trivial moving statistics."""
    jp, jbn = jcore.gnn_init(js, jax.random.key(0))
    D = js.state_spec.units[-1]
    return jp, {**jbn, "state": {"mean": jnp.linspace(-0.1, 0.1, D),
                                 "var": jnp.linspace(0.6, 0.9, D)}}


@pytest.mark.parametrize("fused_layout,sd", [(True, 0), (False, 0), (True, 5)])
def test_flagship_served_on_bf16_batch_matches_gnn_tpu(fused_layout, sd):
    """The flagship served on a bf16 batch: K3_bf16 over the loop blocks and
    K4_bf16 per step over the dep blocks (fused_layout), or K4_bf16 over every
    block under aggregation='fused' (the all-dep layout), against gnn_tpu's
    hp = False kernels: equal iteration counts, the two-part gate on states
    and outputs (one flip of U_a); the Predictor with adj_dtype serves the
    same; state_dim 5 with gnn_tpu's initial state."""
    jgs, tgs = graphs(4)
    jb, tb = batches(jgs, tgs, fused_layout)
    agg = "auto" if fused_layout else "fused"
    js, ts, sk, ok = flagship_specs(sd, aggregation=agg)
    assert tcore._eval_route(ts, tb) == "hybrid"
    jp, jbn = init(js)
    model = model_of(sk, ok, jp, jbn, sd, aggregation=agg)
    rng = jax.random.key(1)
    want = jax.jit(lambda p: jcore.gnn_forward(js, p, jbn, jb, rng))(jp)
    masks = with_mask(jax_draws(js, tb.n_node_pad, 0, rng), tb.node_mask) if sd else None

    def fwd():
        with torch.no_grad():
            return tcore.gnn_forward(model.spec, model.params, model.bn, tb, masks=masks)
    got = fwd()
    flipped = one_flip(fwd, tb.adj_loop if fused_layout else tb.adj_dep, "ua")
    assert float(got["iters"]) == float(want["iters"])
    for k in ("state", "out"):
        hold(f"flagship {k}", got[k], want[k], flipped[k], got[k], state_tol)
    if sd:
        return
    tfu.reset_launches()
    served = Predictor(model, adj_dtype=BF16, device="cpu").predict(tgs, split=False)
    assert not any(tfu.launches.values())                  # plain versions on the CPU
    pb = Predictor(model, adj_dtype=BF16, device="cpu").build_batch(tgs)
    assert pb.adj_dtype == BF16
    ref = model.forward(pb)["out"].detach().numpy()[pb.sel_mask.numpy()]
    np.testing.assert_array_equal(served, ref)


@pytest.mark.parametrize("sd", [0, 5])
def test_flagship_bn_step_on_bf16_batch_matches_gnn_tpu(sd):
    """One BN-route training step of the flagship on a bf16 batch (K1_bf16
    forward and K2_bf16 backward over the block rows, the residual term and
    the moments in f32) against gnn_tpu's grads on its hp = False kernels
    with the same keep-masks: equal iteration counts, the loss within rtol
    1e-5, the moving statistics and every grad tensor by the two-part gate
    (one flip of x3's aggregated slice an iteration); state_dim 5 folds the
    labels into the features."""
    jgs, tgs = graphs(5)
    jb, tb = batches(jgs, tgs)
    js, ts, sk, ok = flagship_specs(sd)
    assert tcore._train_route(ts, tb) == "bn"
    jp, jbn = init(js)
    rng = jax.random.key(3)

    def f(p):
        iters, loss, res = jcore.evaluate_single(js, p, jbn, jb, rng, LOSS, {}, training=True)
        return loss + jcore.regularization(js, p), (iters, loss, res["bn"])
    g_j, (iters_j, loss_j, bn_j) = jax.jit(jax.grad(f, has_aux=True))(jp)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    want = flatten(jax.tree_util.tree_map(np.asarray, g_j))
    masks = with_mask(jax_draws(js, tb.n_node_pad, tb.n_node_pad, rng, True), tb.node_mask)

    def step():
        m = model_of(sk, ok, jp, jbn, sd)
        out = m.training_step(tb, masks=masks)
        return out, {**port_grads(m.params), **{f"bn/{k}": v for k, v in m.bn["state"].items()}}
    tbn.reset_launches()
    out, got = step()
    assert not any(tbn.launches.values())
    adj = torch.cat([tb.adj_loop, tb.adj_dep])
    _, flipped = one_flip(step, adj, "agg")
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for k in ("mean", "var"):
        hold(f"moving {k}", got[f"bn/{k}"], np.asarray(bn_j["state"][k]), flipped[f"bn/{k}"],
             got[f"bn/{k}"], state_tol)
    for key in want:
        hold(f"flagship bf16 grad {key}", got[key], want[key], flipped[key], got[key], grad_tol)
