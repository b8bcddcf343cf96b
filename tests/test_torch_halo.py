"""The port's dense halo-exchange operator (``cnn_graph_tpu_torch.
parallel.halo``) against the JAX package's on its virtual 8-device
mesh: tests/test_halo.py case for case (float 1e-4), and the host plan
``build_halo_plan`` byte-equal to JAX's.

The port runs in four gloo worker processes on the CPU
(``tests/_torch_dist.py``), with a (2, 2) and a (1, 4) mesh in one
world; JAX runs here.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import gathered, run_world
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import cheby_conv, device_laplacian
from cnn_graph_tpu.parallel import make_mesh
from cnn_graph_tpu.parallel.halo import (
    build_halo_plan,
    halo_sharded_laplacian,
)
from cnn_graph_tpu_torch.parallel import halo as port_halo

WORLD = 4


@pytest.fixture(scope="module")
def banded_graph():
    """RCM-ordered kNN graph on a 1-D manifold (tests/test_halo.py)."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(size=96))
    z = np.stack([t, 0.05 * rng.normal(size=96)], axis=1).astype(np.float32)
    W = gc.knn_graph(z, k=4)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return gc.laplacian(W, normalized=True)


@pytest.fixture(scope="module")
def world(banded_graph, tmp_path_factory):
    L = banded_graph
    rng = np.random.default_rng(1)
    inp = {"L_data": L.data, "L_indices": L.indices, "L_indptr": L.indptr,
           "L_shape": np.array(L.shape)}
    inp["x16"] = rng.normal(size=(96, 16)).astype(np.float32)
    inp["t16"] = rng.normal(size=(96, 16)).astype(np.float32)
    inp["x_conv"] = rng.normal(size=(4, 96, 3)).astype(np.float32)
    inp["w_conv"] = (rng.normal(size=(5, 3, 2)) * 0.1).astype(np.float32)
    inp["x_grad"] = rng.normal(size=(2, 96, 3)).astype(np.float32)
    inp["w_grad"] = (rng.normal(size=(4, 3, 2)) * 0.1).astype(np.float32)
    res = run_world("halo", WORLD, tmp_path_factory.mktemp("halo"), **inp)
    return types.SimpleNamespace(inp=inp, res=res)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_build_halo_plan_matches_jax(banded_graph, n):
    from cnn_graph_tpu.graphs.construction import rescale_laplacian

    L = rescale_laplacian(banded_graph, lmax=2.0).tocsr()
    want = build_halo_plan(L, n)
    got = port_halo.build_halo_plan(L, n)
    assert got[1:3] == want[1:3] and got[5] == want[5]
    assert (got[0] != want[0]).nnz == 0
    np.testing.assert_array_equal(got[4], want[4])
    for s in range(n):
        for t in range(n):
            np.testing.assert_array_equal(got[3][s][t], want[3][s][t])


class TestHaloShardedLaplacian:
    @pytest.mark.parametrize("nodes", [2, 4])
    def test_matmul_matches_dense(self, banded_graph, world, nodes):
        mesh = make_mesh(data=8 // nodes, nodes=nodes)
        halo_op = halo_sharded_laplacian(banded_graph, mesh)
        dense_op = device_laplacian(banded_graph, fmt="dense")
        got = gathered(world.res, f"matmul_n{nodes}", mesh=f"n{nodes}")
        assert got.shape[0] == halo_op.m_padded
        Xd = np.zeros((dense_op.m_padded, 16), np.float32)
        Xd[:96] = world.inp["x16"]
        want = np.asarray(dense_op.matmul(jnp.asarray(Xd)))
        np.testing.assert_allclose(got[:96], want[:96], atol=1e-4)
        with mesh:
            sharded = np.asarray(jax.jit(halo_op.matmul)(jnp.asarray(
                np.pad(world.inp["x16"], ((0, halo_op.m_padded - 96),
                                          (0, 0))))))
        np.testing.assert_allclose(got, sharded, atol=1e-5)

    @pytest.mark.parametrize("nodes", [2, 4])
    def test_matmul_backward_is_the_transpose(self, banded_graph, world,
                                              nodes):
        """The reverse exchange of the halo slots' cotangents: dx of
        ``sum(L x * t)`` is ``L^T t``."""
        dense_op = device_laplacian(banded_graph, fmt="dense")
        got = gathered(world.res, f"matmul_grad_n{nodes}", mesh=f"n{nodes}")
        t = np.zeros((dense_op.m_padded, 16), np.float32)
        t[:96] = world.inp["t16"]
        want = np.asarray(dense_op.mat).T @ t
        np.testing.assert_allclose(got[:96], want[:96], atol=1e-4)

    def test_halo_is_small_for_banded_graph(self, banded_graph, world):
        mesh = make_mesh(data=2, nodes=4)
        halo_op = halo_sharded_laplacian(banded_graph, mesh)
        for r in world.res:
            mp, H, ms = r["meta_n4"]
            assert (mp, H, ms) == (halo_op.m_padded, halo_op.halo,
                                   halo_op.rows_per_shard)
            assert H <= ms // 2

    def test_cheby_conv_through_halo_operator(self, banded_graph, world):
        dense_op = device_laplacian(banded_graph, fmt="dense")
        got = gathered(world.res, "conv", axis=1, mesh="n2")[:, :96]
        want = np.asarray(cheby_conv(jnp.asarray(world.inp["x_conv"]),
                                     dense_op,
                                     jnp.asarray(world.inp["w_conv"])))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_gradients_flow_through_exchange(self, banded_graph, world):
        mesh = make_mesh(data=4, nodes=2)
        halo_op = halo_sharded_laplacian(banded_graph, mesh)
        x = jnp.asarray(world.inp["x_grad"])
        w = jnp.asarray(world.inp["w_grad"])

        def loss(w):
            return jnp.sum(cheby_conv(x, halo_op, w) ** 2)

        with mesh:
            g = np.asarray(jax.jit(jax.grad(loss))(w))
            want_loss = float(jax.jit(loss)(w))
        for r in world.res:
            assert np.all(np.isfinite(r["conv_grad"]))
            assert float(np.abs(r["conv_grad"]).max()) > 0
            np.testing.assert_allclose(r["conv_grad"], g, atol=1e-4)
            np.testing.assert_allclose(r["conv_loss"], want_loss, rtol=1e-5)
