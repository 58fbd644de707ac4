"""Composite (per-node-type) models on a bf16 block adjacency in
gnn_tpu_torch against gnn_tpu, on the CPU: served on route 'typed_eval'
through the bf16 variant of K16 and trained on route 'typed_bn' through
those of K16 and K17 (ops/typed.py), whose plain versions run here against
gnn_tpu's kernels with hp false in interpret mode.

The gate is tests/test_torch_bf16_adj.py's two-part gate (`hold`): at least
99% of the entries within 1e-5 (grads: rtol 2e-4 with a floor of 2e-5 of
the tensor's largest entry), and every entry within the change that one
bf16 rounding flip an iteration makes, derived by running the plain version
with that flip (`one_flip`). The flipped rounding is the one whose value is
a sum whose order differs between XLA and the port: the aggregated slice of
x3 ("agg") for K16_bf16, the served model and the step, bf(dh) ("dh", after
the recomputed dense layer) for K17_bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.graphs import batch as jbatch
from gnn_tpu.models import composite as jcomp
from gnn_tpu.models import core as jcore
from gnn_tpu.ops import pallas_typed as jpt
from gnn_tpu_torch import CompositeGNNgraphBased, Predictor
from gnn_tpu_torch.convert import flatten, params_to_jax
from gnn_tpu_torch.graphs import batch as tbatch
from gnn_tpu_torch.models import composite as tcomp
from gnn_tpu_torch.ops import typed as ttyped
from test_torch_bf16_adj import fm, grad_tol, hold, state_tol
from test_torch_bf16_flagship import arrays, jadj, one_flip
from test_torch_composite import (NL, composite_specs, composite_weights, jax_masks,
                                  typed_graphs)

torch.set_num_threads(1)
BF16 = torch.bfloat16
AL = 3
LOSS = "categorical_crossentropy"


def batches(jgs, tgs, fused_layout=True):
    jb = jbatch.from_graphs_blocked(jgs, block_w=32, focus="g", fused_layout=fused_layout,
                                    adj_dtype=jnp.bfloat16)
    tb = tbatch.from_graphs_blocked(tgs, block_w=32, focus="g", fused_layout=fused_layout,
                                    adj_dtype=BF16)
    return jb, tb


def typed_operands(seed, acts, rate, res):
    """K16's and K17's operands over a bf16 batch's block rows [loop | dep]:
    node types drawn over range(T) (the last type absent at T > 2), per-type
    affines, weights and coefficient rows that keep every output O(1)."""
    _, tb = batches(*typed_graphs(seed, len(acts)))
    g, arr = arrays(seed)
    T, D, F = len(acts), NL, AL
    R = tb.adj_loop.shape[0] + tb.adj_dep.shape[0]
    C = 2 * D + F + 1
    nm = torch.cat([tb.loop_nm, torch.ones(tb.adj_dep.shape[0], 32)])
    types = torch.tensor(g.integers(0, T - 1 if T > 2 else T, (R, 32)), dtype=torch.int32)
    aff = torch.stack([torch.stack([1 + arr(T, D, scale=0.2), arr(T, D, scale=0.1)])
                       for _ in range(2)])
    keep = (torch.tensor(g.random((R, 32, C - 1)) > rate).to(torch.uint8) if rate else None)
    fwd = dict(adj_loop=tb.adj_loop, adj_dep=tb.adj_dep, y1=arr(R, 32, D), y2=arr(R, 32, D),
               aff=aff, types=types, keep=keep, rT=arr(R, 32, D, scale=0.3) if res else None,
               feats=arr(R, 32, F, scale=0.5), w_stk=arr(T * D, C, scale=0.5 / D ** 0.5),
               nm=nm)
    bwd = dict(adj_loop=tb.adj_loop, adj_dep=tb.adj_dep, y_prev=fwd["y1"], y_k=arr(R, 32, D),
               agg=arr(R, 32, D), types=types, keep=keep, feats=fwd["feats"],
               w_stk=fwd["w_stk"], ds_in=arr(R, 32, D, scale=0.1), gsel=arr(R, 32, D, scale=0.1),
               bnv=torch.tensor(0.5 + g.random((T, 9, D)), dtype=torch.float32),
               flag=torch.tensor(1.0), nm=nm)
    return fwd, bwd, torch.cat([tb.adj_loop, tb.adj_dep])


def tm3(types, T):
    """gnn_tpu's raw one-hot type masks [R, T, W]."""
    return jnp.asarray(np.swapaxes(np.eye(T, dtype=np.float32)[types.numpy()], 1, 2))


# ---------------------------------------------------------------- K16 / K17
@pytest.mark.parametrize("acts,rate,alpha,res", [(("selu", "tanh"), 0.1, True, True),
                                                 (("selu", "tanh", "relu"), 0.2, False, True),
                                                 (("tanh", "selu", "selu"), 0.0, True, False)])
def test_k16_k17_bf16_match_gnn_tpu(acts, rate, alpha, res):
    """K16_bf16's and K17_bf16's plain versions against gnn_tpu's
    _bnT_fwd_call and _bnT_bwd_call with hp false (interpret mode), T 2 and
    3 with mixed activations: the movement flags equal, the two-part gate on
    y, agg, the per-type block sums, ds, dagg, dw and red (K16 one flip of
    the aggregated slice of x3, K17 of bf(dh))."""
    fwd, bwd, adj = typed_operands(2, acts, rate, res)
    R, T = adj.shape[0], len(acts)
    kw = dict(activations=acts, alpha_drop=alpha, rate=rate)
    mc = None if fwd["keep"] is None else fm(fwd["keep"].to(torch.int8))
    jkw = dict(acts=acts, T=T, alpha_drop=alpha, rate=rate, group=R, interpret=True)
    nmf = jnp.asarray(fwd["nm"].numpy())[:, None, :]
    y, agg, marg, msum = ttyped.bnT_forward_step_bf16(**fwd, **kw, threshold=0.05)
    jy, jagg, jmarg, jmsum = jpt._bnT_fwd_call(
        jadj(adj), fm(fwd["y1"]), fm(fwd["y2"]),
        jnp.asarray(fwd["aff"].reshape(4, T, NL).numpy())[..., None], tm3(fwd["types"], T), mc,
        None if fwd["rT"] is None else fm(fwd["rT"]), fm(fwd["feats"]),
        jnp.asarray(fwd["w_stk"].numpy()), nmf, thr=0.05, **jkw)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jmarg)[:, 0])
    np.testing.assert_allclose(agg.numpy(), np.swapaxes(np.asarray(jagg), -1, -2), atol=1e-5)
    flipped = one_flip(lambda: ttyped.bnT_forward_step_bf16(**fwd, **kw, threshold=0.05), adj,
                       "agg")
    hold("K16_bf16 y", y, np.swapaxes(np.asarray(jy), -1, -2), flipped[0], y, state_tol)
    hold("K16_bf16 msum", msum.sum(0), np.asarray(jmsum).sum(0), flipped[3].sum(0),
         msum.sum(0), grad_tol)

    got = ttyped.bnT_backward_step_bf16(**bwd, **kw)
    bnv = jnp.zeros((T, 16, NL)).at[:, :9].set(jnp.asarray(bwd["bnv"].numpy()))[..., None]
    want = jpt._bnT_bwd_call(jadj(adj), fm(bwd["y_prev"]), fm(bwd["y_k"]), fm(bwd["agg"]),
                             tm3(bwd["types"], T), mc, fm(bwd["feats"]),
                             jnp.asarray(bwd["w_stk"].numpy()), fm(bwd["ds_in"]),
                             fm(bwd["gsel"]), bnv, jnp.ones((1, 1)), nmf, **jkw)
    flipped = one_flip(lambda: ttyped.bnT_backward_step_bf16(**bwd, **kw), adj, "dh")

    def port(r):          # (ds, dw, dagg, red) as gnn_tpu's outputs
        ds, dw, dagg, red = r
        return ds.transpose(1, 2), dw.sum(0), dagg.transpose(1, 2), red.sum(0)
    for name, a, f, w in zip(("ds", "dw", "dagg", "red"), port(got), port(flipped), want):
        hold(f"K17_bf16 {name}", a, w, f, a, grad_tol)


def test_typed_bf16_wrappers_check_their_operands():
    """The K16_bf16/K17_bf16 wrappers launch nothing on the CPU, count no
    launch there, and mirror the shared memory of their CTAs: the widths
    whose CTA does not fit raise ValueError naming the limit (no wide plan,
    no fallback); the number of types takes no room, node types other than
    int32 are refused."""
    fwd, bwd, _ = typed_operands(3, ("selu", "tanh"), 0.1, True)
    ttyped.reset_launches()
    kw = dict(activations=("selu", "tanh"), alpha_drop=True, rate=0.1)
    ttyped.bnT_forward_step_bf16(**fwd, **kw, threshold=0.01)
    ttyped.bnT_backward_step_bf16(**bwd, **kw)
    assert not any(ttyped.launches.values())
    assert ttyped.bnT_bf16_smem_bytes(128, 14, 3) == 2 * 128 * 128 + 4 * 128 * 74
    meta = torch.empty((2, 128, 128), dtype=BF16, device="meta")
    assert ttyped._check_bf16_blocks(meta, None, 2, 77, 3, "K16_bf16",
                                     ttyped.bnT_bf16_smem_bytes) == (2, 128)
    with pytest.raises(ValueError, match="shared memory"):
        ttyped._check_bf16_blocks(meta, None, 2, 78, 3, "K17_bf16", ttyped.bnT_bf16_smem_bytes)
    types = torch.zeros((2, 128), dtype=torch.int32)
    assert ttyped._check_types(2, 128, 14, 3, types, torch.zeros((40 * 14, 32)),
                               ("selu",) * 40) == 40
    with pytest.raises(ValueError, match="int32"):
        ttyped._check_types(2, 128, 14, 3, types.long(), torch.zeros((4 * 14, 32)),
                            ("selu",) * 4)


# ------------------------------------------------------------------ routes
def model_of(ts, jp, jbn):
    m = CompositeGNNgraphBased(ts.state_specs, ts.output_spec, max_iteration=ts.max_iteration,
                               threshold=ts.threshold, seed=0, device="cpu")
    m.set_params(*jax.tree_util.tree_map(np.asarray, (jp, jbn)))
    return m


@pytest.mark.parametrize("T,fused_layout", [(3, True), (2, False)])
def test_composite_served_on_bf16_batch_matches_gnn_tpu(T, fused_layout):
    """A composite model served on a bf16 batch (route 'typed_eval': K16_bf16
    once an iteration, each type's inference affine in float64 rounded once)
    against gnn_tpu's typed eval chain with hp false: equal iteration
    counts, the two-part gate on states and outputs (one flip of x3's
    aggregated slice an iteration); the Predictor with adj_dtype serves the
    same."""
    jgs, tgs = typed_graphs(11, T)
    jb, tb = batches(jgs, tgs, fused_layout)
    js, ts = composite_specs(T)
    (jp, jbn), _ = composite_weights(js)
    assert tcomp._route(ts, tb, False) == "typed_eval"
    model = model_of(ts, jp, jbn)
    want = jcomp.composite_forward(js, jp, jbn, jb, jax.random.key(0))

    def fwd():
        with torch.no_grad():
            return model.forward(tb)
    ttyped.reset_launches()
    got = fwd()
    assert not any(ttyped.launches.values())
    adj = torch.cat([a for a in (tb.adj_loop, tb.adj_dep) if a is not None])
    flipped = one_flip(fwd, adj, "agg")
    assert float(got["iters"]) == float(want["iters"])
    for k in ("state", "out"):
        hold(f"composite {k}", got[k], want[k], flipped[k], got[k], state_tol)
    if not fused_layout:
        return
    served = Predictor(model, adj_dtype=BF16, device="cpu").predict(tgs, split=False)
    pb = Predictor(model, adj_dtype=BF16, device="cpu").build_batch(tgs)
    assert pb.adj_dtype == BF16
    ref = model.forward(pb)["out"].detach().numpy()[pb.sel_mask.numpy()]
    np.testing.assert_array_equal(served, ref)


@pytest.mark.parametrize("T,absent", [(3, None), (3, 1)])
def test_composite_bn_step_on_bf16_batch_matches_gnn_tpu(T, absent):
    """One composite_bn training step on a bf16 batch (route 'typed_bn':
    K16_bf16 forward and K17_bf16 backward, the per-type moments and the
    residual term in float64 rounded once) against gnn_tpu's grads on its hp
    = False typed kernels with JAX's per-type keep-masks: equal iteration
    counts, the loss within rtol 1e-5, each type's moving statistics and
    every grad tensor by the two-part gate (one flip of x3's aggregated
    slice an iteration); an absent type included."""
    jgs, tgs = typed_graphs(12, T, absent=absent)
    jb, tb = batches(jgs, tgs)
    js, ts = composite_specs(T)
    (jp, jbn), _ = composite_weights(js)
    assert tcomp._route(ts, tb, True) == "typed_bn"
    rng = jax.random.key(3)

    def f(p):
        res = jcomp.composite_forward(js, p, jbn, jb, rng, training=True)
        loss = jcore.weighted_loss(jcore.get_loss(LOSS), {}, jb, res["out"])
        return loss + jcomp.composite_regularization(js, p), (res["iters"], loss, res["bn"])
    g_j, (iters_j, loss_j, bn_j) = jax.jit(jax.grad(f, has_aux=True))(jp)
    g_j = {**g_j, "state": jax.tree_util.tree_map(lambda g: g / jnp.maximum(iters_j, 1.0),
                                                  g_j["state"])}
    want = flatten(jax.tree_util.tree_map(np.asarray, g_j))
    masks = jax_masks(js, tb.n_node_pad, tb.n_node_pad, rng)

    def step():
        m = model_of(ts, jp, jbn)
        out = m.training_step(tb, masks=masks)
        grads = jax.tree_util.tree_map(lambda p: p.grad, m.params, is_leaf=torch.is_tensor)
        moving = {f"bn/{t}/{k}": v for t, b in enumerate(m.bn["state"]) for k, v in b.items()}
        return out, {**flatten(params_to_jax(grads, {})[0]), **moving}
    ttyped.reset_launches()
    out, got = step()
    assert not any(ttyped.launches.values())
    adj = torch.cat([tb.adj_loop, tb.adj_dep])
    _, flipped = one_flip(step, adj, "agg")
    assert float(out["iters"]) == float(iters_j)
    np.testing.assert_allclose(float(out["loss"]), float(loss_j), rtol=1e-5)
    for t, b in enumerate(bn_j["state"]):
        for k in b:
            key = f"bn/{t}/{k}"
            hold(f"moving {k} of type {t}", got[key], np.asarray(b[k]), flipped[key], got[key],
                 state_tol)
    for key in want:
        hold(f"composite_bn bf16 grad {key}", got[key], want[key], flipped[key], got[key],
             grad_tol)
