"""K18, the segment aggregation of ops/segment.py, against gnn_tpu's
ops/pallas_segment.block_aggregate (its Pallas kernel in interpret mode on
the CPU, as tests/test_ops.py runs it).

The port's CSR plan and gnn_tpu's chunk plan are built from the same arcs;
the plain version (which a CPU tensor runs) must match the kernel's forward
and its VJP, the same op on the transpose plan, within rtol 1e-5 (atol 1e-6
for sums that cancel near 0: the two add their terms in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops import pallas_segment as jseg
from gnn_tpu_torch.graphs.batch import GraphBatch
from gnn_tpu_torch.graphs.graph import Graph
from gnn_tpu_torch.ops import segment as tseg

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _arcs(case, rng):
    """(src, dst, w, N) of a test case. 'random': gnn_tpu's test shapes (N
    256, 900 arcs). 'ragged': unsorted arcs, a hub with 300 in-arcs, an
    isolated node and 100 weight-0 pad arcs (into node N - 1, from node 0)."""
    N = 256
    if case == "random":
        E = 900
        return rng.integers(0, N, E), rng.integers(0, N, E), rng.random(E).astype(np.float32), N
    src = rng.integers(0, N, 600)
    dst = rng.integers(0, N, 600)
    dst[rng.choice(600, 300, replace=False)] = 7                  # the hub
    isolated = 11
    src[src == isolated] = 12
    dst[dst == isolated] = 13
    w = (rng.random(600) + 0.1).astype(np.float32)
    src = np.concatenate([src, np.zeros(100, np.int64)])
    dst = np.concatenate([dst, np.full(100, N - 1)])
    w = np.concatenate([w, np.zeros(100, np.float32)])
    perm = rng.permutation(len(src))                              # unsorted
    return src[perm], dst[perm], w[perm], N


@pytest.mark.parametrize("D", [1, 5, 14])
@pytest.mark.parametrize("case", ["random", "ragged"])
def test_plain_k18_matches_pallas_block_aggregate(case, D):
    """Forward and VJP of the port's block_aggregate (plain K18 on the CPU)
    against gnn_tpu's kernel, block_w 128 and chunk_c 128."""
    rng = np.random.default_rng(D)
    src, dst, w, N = _arcs(case, rng)
    state = rng.standard_normal((N, D)).astype(np.float32)
    M = rng.standard_normal((N, D)).astype(np.float32)
    jplans = jseg.build_agg_plan(src, dst, w, N, block_w=128, chunk_c=128)
    want = np.asarray(jseg.block_aggregate(jnp.asarray(state), jplans))
    gwant = np.asarray(jax.grad(lambda s: jnp.sum(jseg.block_aggregate(s, jplans) * M))(
        jnp.asarray(state)))

    plans = tseg.build_agg_plan(src, dst, w, N)
    s = torch.tensor(state, requires_grad=True)
    tseg.reset_launches()
    got = tseg.block_aggregate(s, plans)
    (got * torch.from_numpy(M)).sum().backward()
    assert tseg.launches == {"segment_aggregate": 0}             # plain on the CPU
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), gwant, rtol=RTOL, atol=ATOL)
    # the exact sums in float64 bound both
    ref = np.zeros((N, D))
    np.add.at(ref, dst, w[:, None].astype(np.float64) * state[src])
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    if case == "ragged":
        assert not got[11].any() and not s.grad[11].any()        # the isolated node


def test_plan_is_csr_without_weight0_arcs():
    """Rows of the forward plan are destinations, of the transpose sources;
    weight-0 arcs are dropped; a row keeps its arcs in arc order."""
    src = np.array([3, 0, 1, 0, 2, 3, 0])
    dst = np.array([1, 3, 1, 3, 0, 1, 3])
    w = np.array([0.5, 0.0, 2.0, 0.0, 1.5, 3.0, 0.0], np.float32)
    plans = tseg.build_agg_plan(src, dst, w, 5)
    fwd, bwd = plans.fwd, plans.bwd
    assert fwd.rowptr.tolist() == [0, 1, 4, 4, 4, 4] and fwd.rowptr.dtype == torch.int32
    assert fwd.col.tolist() == [2, 3, 1, 3]
    assert fwd.w.tolist() == [1.5, 0.5, 2.0, 3.0] and fwd.col.dtype == torch.int32
    assert bwd.rowptr.tolist() == [0, 0, 1, 2, 4, 4]
    assert bwd.col.tolist() == [1, 0, 1, 1] and bwd.w.tolist() == [2.0, 1.5, 0.5, 3.0]
    out = tseg.segment_aggregate(torch.ones(5, 2), fwd)
    assert out[:, 0].tolist() == [1.5, 5.5, 0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        tseg.build_agg_plan(src, dst + 3, w, 5)
    with pytest.raises(ValueError, match="shape"):
        tseg.build_agg_plan(src, dst[:-1], w, 5)


def test_wrapper_runs_the_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version (any float dtype: the float64
    arbiter of chip_smoke.py uses it); any device but the CPU and CUDA
    raises, so nothing falls back."""
    plans = tseg.build_agg_plan(np.array([0, 1]), np.array([1, 2]),
                                np.array([1.0, 2.0], np.float32), 3)
    x = torch.arange(6, dtype=torch.float64).reshape(3, 2)
    np.testing.assert_array_equal(tseg.segment_aggregate(x, plans.fwd).numpy(),
                                  [[0, 0], [0, 1], [4, 6]])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tseg.segment_aggregate(x.to("meta"), plans.fwd.to("meta"))


def test_batch_to_moves_the_plan():
    """GraphBatch.to moves the plan's tensors with the batch's."""
    rng = np.random.default_rng(0)
    arcs = np.concatenate([rng.integers(0, 9, (20, 2)), rng.random((20, 1))], axis=1)
    g = Graph(arcs, rng.random((9, 2)), np.eye(2)[rng.integers(0, 2, 9)])
    gb = GraphBatch.from_graph(g, build_plan=True)
    moved = gb.to("meta")
    for plan in (moved.agg_plan.fwd, moved.agg_plan.bwd):
        for f in dataclasses.fields(plan):
            assert getattr(plan, f.name).device.type == "meta"
    assert moved.nodes.device.type == "meta" and gb.agg_plan.fwd.col.device.type == "cpu"
