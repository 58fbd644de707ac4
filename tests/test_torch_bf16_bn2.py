"""The hidden-150 recipe with its trailing BatchNorm on a bf16 block adjacency
in gnn_tpu_torch against gnn_tpu, on the CPU: the two-layer route 'bn'
through the bf16 variants of K14 and K15 (ops/bn.py), whose plain versions
run here against gnn_tpu's kernels with hp false in interpret mode.

The gate is tests/test_torch_bf16_adj.py's two-part gate (`hold`): at least
99% of the entries within 1e-5 (grads: rtol 2e-4 with a floor of 2e-5 of
the tensor's largest entry), and every entry within the change that one
bf16 rounding flip an iteration makes, derived by running the plain version
with that flip (`one_flip`). The flipped rounding is the one whose value is
a sum whose order differs between XLA and the port: the aggregated slice of
x3 ("agg") for K14_bf16 and the step, bf(dh0) ("dh0", after dy0's sum) for
K15_bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.models import core as jcore
from gnn_tpu.ops import pallas_bn as jpb
from gnn_tpu.ops.mlp import MLPSpec as JSpec
from gnn_tpu_torch.convert import flatten
from gnn_tpu_torch.models import core as tcore
from gnn_tpu_torch.ops import bn as tbn
from gnn_tpu_torch.ops import fused2 as tf2
from gnn_tpu_torch.ops.mlp import MLPSpec as TSpec
from test_torch_bf16_adj import fm, grad_tol, hold, state_tol
from test_torch_bf16_flagship import arrays, batches, init, jadj, model_of, one_flip
from test_torch_state_dim import AL, DT, NL, graphs, jax_draws, port_grads, with_mask

torch.set_num_threads(1)
LOSS = "categorical_crossentropy"
K, H1 = 4, 20


def bn2_operands(seed, rate, res, H=H1):
    """K14's and K15's operands over a bf16 batch's block rows [loop | dep]
    (uint8 keep-masks in x3 column order), hidden width H."""
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
    wts = dict(w0_aug=arr(H, C, scale=0.6 / C ** 0.5), w1=arr(D, H, scale=H ** -0.5),
               b1=arr(D, scale=0.1))
    fwd = dict(adj_loop=tb.adj_loop, adj_dep=tb.adj_dep, y1=arr(R, 32, D), y2=arr(R, 32, D),
               aff=aff, keep=keep, rT=arr(R, 32, D, scale=0.3) if res else None,
               feats=arr(R, 32, F, scale=0.5), nm=nm, **wts)
    bwd = dict(adj_loop=tb.adj_loop, adj_dep=tb.adj_dep, y_prev=fwd["y1"], y_k=arr(R, 32, D),
               agg=arr(R, 32, D), keep=keep, feats=fwd["feats"], **wts,
               ds_in=arr(R, 32, D, scale=0.1), gsel=arr(R, 32, D, scale=0.1),
               bnv=torch.tensor(0.5 + g.random((9, D)), dtype=torch.float32),
               flag=torch.tensor(1.0), nm=nm)
    return fwd, bwd, torch.cat([tb.adj_loop, tb.adj_dep])


def jweights(x):
    return (jnp.asarray(x["w0_aug"].numpy()), jnp.asarray(x["w1"].numpy()),
            jnp.asarray(x["b1"].numpy()))


# ---------------------------------------------------------------- K14 / K15
@pytest.mark.parametrize("act0,act1,rate,alpha,res", [("selu", "selu", 0.1, True, True),
                                                      ("tanh", "selu", 0.2, False, True),
                                                      ("selu", "tanh", 0.0, True, False)])
def test_k14_k15_bf16_match_gnn_tpu(act0, act1, rate, alpha, res):
    """K14_bf16's and K15_bf16's plain versions against gnn_tpu's
    _bn2_fwd_call and _bn2_bwd_call with hp false (interpret mode): the
    movement flags equal, the two-part gate on y, agg, the block sums, ds,
    dagg, dw0, dw1, db1 and red (K14 one flip of the aggregated slice of x3,
    K15 of bf(dh0))."""
    fwd, bwd, adj = bn2_operands(2, rate, res)
    R = adj.shape[0]
    kw = dict(act0=act0, act1=act1, alpha_drop=alpha, rate=rate)
    mc = None if fwd["keep"] is None else fm(fwd["keep"].to(torch.int8))
    jkw = dict(kw, group=R, interpret=True)
    nmf = jnp.asarray(fwd["nm"].numpy())[:, None, :]
    y, agg, marg, msum = tbn.bn2_forward_step_bf16(**fwd, **kw, threshold=0.05)
    jy, jagg, jmarg, jmsum = jpb._bn2_fwd_call(
        jadj(adj), fm(fwd["y1"]), fm(fwd["y2"]), jnp.asarray(fwd["aff"].numpy())[..., None], mc,
        None if fwd["rT"] is None else fm(fwd["rT"]), fm(fwd["feats"]), *jweights(fwd), nmf,
        thr=0.05, **jkw)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jmarg)[:, 0])
    np.testing.assert_allclose(agg.numpy(), np.swapaxes(np.asarray(jagg), -1, -2), atol=1e-5)
    flipped = one_flip(lambda: tbn.bn2_forward_step_bf16(**fwd, **kw, threshold=0.05), adj,
                       "agg")
    hold("K14_bf16 y", y, np.swapaxes(np.asarray(jy), -1, -2), flipped[0], y, state_tol)
    hold("K14_bf16 msum", msum.sum(0), np.asarray(jmsum).sum((0, 1)), flipped[3].sum(0),
         msum.sum(0), grad_tol)

    got = tbn.bn2_backward_step_bf16(**bwd, **kw)
    bnv = jnp.zeros((16, NL)).at[:9].set(jnp.asarray(bwd["bnv"].numpy()))[..., None]
    want = jpb._bn2_bwd_call(jadj(adj), fm(bwd["y_prev"]), fm(bwd["y_k"]), fm(bwd["agg"]), mc,
                             fm(bwd["feats"]), *jweights(bwd), fm(bwd["ds_in"]),
                             fm(bwd["gsel"]), bnv, jnp.ones((1, 1)), nmf, **jkw)
    flipped = one_flip(lambda: tbn.bn2_backward_step_bf16(**bwd, **kw), adj, "dh0")

    def port(r):          # (ds, dw0, dw1, db1, dagg, red) as gnn_tpu's outputs
        ds, dw0, dw1, db1, dagg, red = r
        return (ds.transpose(1, 2), dw0.sum(0), dw1.sum(0), db1.sum(0), dagg.transpose(1, 2),
                red.sum(0))
    names = ("ds", "dw0", "dw1", "db1", "dagg", "red")
    for name, a, f, w in zip(names, port(got), port(flipped), want):
        hold(f"K15_bf16 {name}", a, w, f, a, grad_tol)


def test_bn2_bf16_wrappers_check_their_operands():
    """The K14_bf16/K15_bf16 wrappers launch nothing on the CPU, count no
    launch there, and mirror the shared memory of their CTAs: the widths
    whose CTA does not fit raise ValueError naming the limit (no wide plan,
    no fallback); the hidden width takes no room (hidden chunks, K15_bf16's
    sub-chunks of its tensor-core layout)."""
    fwd, bwd, _ = bn2_operands(3, 0.1, True)
    tbn.reset_launches()
    tbn.bn2_forward_step_bf16(**fwd, act0="selu", act1="selu", alpha_drop=True, rate=0.1,
                              threshold=0.01)
    tbn.bn2_backward_step_bf16(**bwd, act0="selu", act1="selu", alpha_drop=True, rate=0.1)
    assert not any(tbn.launches.values())
    assert tbn.bn2_bf16_smem_bytes("K14_bf16", 128, 14, 3) == 2 * 128 * 128 + 4 * 128 * 91
    # x3a [W][33] (C = 32, the stride made odd), dh1 [W][14], dx2 [W][28],
    # then the bf16 adjacency [W][136] (more than y0 and dh0 [W][32] in f32
    # need); bf(dagg) in x3a's region
    assert tbn.bn2_bf16_layout(128, 14, 3) == (32, True, 4 * 128 * (33 + 42) + 2 * 128 * 136)
    assert tbn.bn2_bf16_smem_bytes("K15_bf16", 128, 14, 3) == 73216
    meta = torch.empty((2, 128, 128), dtype=torch.bfloat16, device="meta")
    for k, fits in (("K14_bf16", 88), ("K15_bf16", 76)):
        smem = tbn._smem2_bf16(k)
        assert tbn._check_bf16_blocks(meta, None, 2, fits, 3, k, smem) == (2, 128)
        with pytest.raises(ValueError, match="shared memory"):
            tbn._check_bf16_blocks(meta, None, 2, fits + 1, 3, k, smem)
    with pytest.raises(ValueError, match="hidden width"):
        tbn._check_weights2(torch.zeros(0, 32), torch.zeros(14, 0), torch.zeros(14), 14, 3,
                            torch.device("cpu"))
    with pytest.raises(ValueError, match="shape"):
        tbn._check_weights2(torch.zeros(8, 32), torch.zeros(14, 9), torch.zeros(14), 14, 3,
                            torch.device("cpu"))


@pytest.mark.parametrize("W", [32, 64, 96, 128])
def test_tensor_core_layouts_take_every_width_the_old_ones_did(W):
    """K10_bf16's and K15_bf16's tensor-core layouts (fused2.loop2_bf16_layout,
    bn.bn2_bf16_layout) launch at every width the CUDA-core layouts they
    replaced took at block width W: those took K10_bf16 at 2W^2 + 4W(2D +
    64) bytes (every hidden width, in chunks of 32) and K15_bf16 at 2W^2 +
    4W(7D + F + 64), within SMEM_BYTES (at W 128: D to 163, 7D + F to 326)."""
    S = tf2.SMEM_BYTES
    d10 = [D for D in range(1, 1000) if 2 * W * W + 4 * W * (2 * D + 64) <= S]
    assert d10 and all(tf2.bf16_smem_bytes("K10_bf16", W, D) <= S for D in d10)
    for D in d10[::7] + d10[-1:]:
        for H1 in (1, 7, 150, 512, 4096):
            hc, nbytes = tf2.loop2_bf16_layout(W, D, H1)
            assert 16 <= hc <= tf2.pad16(H1) and hc % 16 == 0 and nbytes <= S
    taken = [(D, F) for D in range(1, 400) for F in range(0, 2000)
             if 2 * W * W + 4 * W * (7 * D + F + 64) <= S]
    assert taken and all(tbn.bn2_bf16_smem_bytes("K15_bf16", W, D, F) <= S for D, F in taken)
    if W == 128:
        assert max(d10) == 163 and max(7 * D + F for D, F in taken) == 326
        assert tf2.loop2_bf16_layout(128, 14, 150) == (128, 115712)   # two CTAs an SM


def test_bn2_bf16_tiles_round_and_pad_the_weights():
    """K15_bf16's weight tiles hold bf(w0_aug)^T, bf(w0_aug) and bf(w1)^T
    exactly as fused2.round_bf16 rounds them, zero-padded to multiples of
    16."""
    fwd, _, _ = bn2_operands(4, 0.1, True, H=23)
    w0, w1 = fwd["w0_aug"], fwd["w1"]
    p = tf2.pad16
    w0t, w1t = tbn.bn2_bf16_tiles(w0, w1)
    n0 = p(w0.shape[1]) * p(w0.shape[0])
    assert w0t.shape == (2 * n0,)
    tiles = (w0t[:n0].reshape(p(w0.shape[1]), -1), w0t[n0:].reshape(p(w0.shape[0]), -1), w1t)
    for tile, w in zip(tiles, (w0.t(), w0, w1.t())):
        assert tile.dtype == torch.bfloat16 and tile.shape == (p(w.shape[0]), p(w.shape[1]))
        full = torch.zeros(tile.shape)
        full[:w.shape[0], :w.shape[1]] = tf2.round_bf16("w", w)
        assert torch.equal(tile.float(), full)


@pytest.mark.parametrize("act0,act1", [("selu", "tanh"), ("tanh", "selu")])
def test_k15_bf16_plain_version_on_padded_weights(act0, act1):
    """The zero padding of the tensor-core tiles adds exact zeros: K15_bf16's
    plain version with the hidden width padded to 16 (zero rows of w0_aug,
    zero columns of w1, as bn2_bf16_tiles pads them) gives the unpadded
    result bit for bit (the padded units' weight partials zero)."""
    _, bwd, _ = bn2_operands(5, 0.1, True, H=7)
    kw = dict(act0=act0, act1=act1, alpha_drop=True, rate=0.1)
    w0, w1 = bwd["w0_aug"], bwd["w1"]
    Hp = tf2.pad16(w0.shape[0])
    pad = dict(bwd, w0_aug=torch.cat([w0, w0.new_zeros(Hp - w0.shape[0], w0.shape[1])]),
               w1=torch.cat([w1, w1.new_zeros(w1.shape[0], Hp - w1.shape[1])], 1))
    want = tbn.bn2_backward_step_bf16_ref(**bwd, **kw)
    got = tbn.bn2_backward_step_bf16_ref(**pad, **kw)
    H = w0.shape[0]
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 1:      # dw0 [R, H1, C]
            assert not a[:, H:].any()
            a = a[:, :H]
        if i == 2:      # dw1 [R, D, H1]
            assert not a[..., H:].any()
            a = a[..., :H]
        assert torch.equal(a, b), i


# ------------------------------------------------------------------ the step
def h150_bn_specs(sd=0, **kw):
    """The hidden-150 recipe with the reference's default trailing BatchNorm
    at small width (hidden H1): selu, AlphaDropout 0.1 at both nets' input;
    state_dim `sd`."""
    drop = dict(dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=True)
    sk = dict(input_dim=2 * (NL + sd) + AL, units=(H1, sd or NL), activations="selu",
              kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
              batch_normalization=True, **drop)
    ok = dict(input_dim=NL + sd, units=(H1, DT), activations=("selu", "softmax"),
              kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
              batch_normalization=False, **drop)
    common = dict(focus="g", state_dim=sd, max_iteration=K, threshold=0.01, **kw)
    return (jcore.GNNSpec(state_spec=JSpec(**sk), output_spec=JSpec(**ok), **common),
            tcore.GNNSpec(state_spec=TSpec(**sk), output_spec=TSpec(**ok), **common), sk, ok)


@pytest.mark.parametrize("fused_layout,sd", [(True, 0), (False, 0), (True, 5)])
def test_h150_bn_step_on_bf16_batch_matches_gnn_tpu(fused_layout, sd):
    """One step of the hidden-150 recipe with its trailing BatchNorm on a
    bf16 batch (K14_bf16 forward and K15_bf16 backward over the block rows,
    the residual term and the moments in float64 rounded once; on the
    all-dep layout under aggregation='fused') against gnn_tpu's grads on its
    hp = False kernels with the same keep-masks: equal iteration counts, the
    loss within rtol 1e-5, the moving statistics and every grad tensor by
    the two-part gate (one flip of x3's aggregated slice an iteration);
    state_dim 5 with gnn_tpu's initial state."""
    jgs, tgs = graphs(5)
    jb, tb = batches(jgs, tgs, fused_layout)
    agg = "auto" if fused_layout else "fused"
    js, ts, sk, ok = h150_bn_specs(sd, aggregation=agg)
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
        m = model_of(sk, ok, jp, jbn, sd, aggregation=agg)
        out = m.training_step(tb, masks=masks)
        return out, {**port_grads(m.params), **{f"bn/{k}": v for k, v in m.bn["state"].items()}}
    tbn.reset_launches()
    out, got = step()
    assert not any(tbn.launches.values())
    adj = torch.cat([a for a in (tb.adj_loop, tb.adj_dep) if a is not None])
    _, flipped = one_flip(step, adj, "agg")
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for k in ("mean", "var"):
        hold(f"moving {k}", got[f"bn/{k}"], np.asarray(bn_j["state"][k]), flipped[f"bn/{k}"],
             got[f"bn/{k}"], state_tol)
    assert got.keys() - {"bn/mean", "bn/var"} == want.keys()
    for key in want:
        hold(f"h150_bn bf16 grad {key}", got[key], want[key], flipped[key], got[key], grad_tol)
