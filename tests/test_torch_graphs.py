"""The port's host side against the JAX package's: graph construction
(``cnn_graph_tpu_torch.graphs``) and the band packers
(``cnn_graph_tpu_torch.ops.packing``), which must give byte-equal
layouts at the same G so that the CUDA kernel reads exactly what the
Pallas kernel reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.data.synthetic import city_graph as jax_city_graph
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import laplacian as jax_lap
from cnn_graph_tpu.ops import quantize_banded as jax_quantize_banded
from cnn_graph_tpu.ops.pallas_band import pack_dkw_from_ragged as jax_dkw
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.ops import device_laplacian, packing, quantize_banded
from cnn_graph_tpu_torch.ops import laplacian as port_laplacian


def _same_sparse(a, b, tol):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(a - b).max() <= tol


@pytest.fixture(scope="module")
def city96():
    """9,216-node city graph: two or more band levels at G <= 4."""
    return graphs.city_graph(96, k=8, seed=0)[0]


class TestGraphConstruction:
    def test_city_graph_matches_sklearn_recipe(self):
        """cKDTree kNN reproduces the JAX package's sklearn city graph."""
        L, pos = graphs.city_graph(40, k=8, seed=0)
        L_j, pos_j = jax_city_graph(40, k=8, seed=0)
        _same_sparse(L, L_j, 1e-12)
        np.testing.assert_array_equal(pos, pos_j)

    def test_knn_matches_sklearn(self):
        z = np.random.default_rng(5).uniform(size=(500, 2))
        dist, idx = graphs.knn(z, k=6, algorithm="auto")
        dist_j, idx_j = gc.knn(z, k=6, algorithm="auto")
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_allclose(dist, dist_j, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("normalized", [True, False])
    def test_adjacency_laplacian_rescale(self, normalized):
        z = np.random.default_rng(6).uniform(size=(300, 2))
        dist, idx = gc.knn(z, k=8)
        W = graphs.adjacency(dist, idx)
        _same_sparse(W, gc.adjacency(dist, idx), 0.0)
        L = graphs.laplacian(W, normalized=normalized)
        _same_sparse(L, gc.laplacian(W, normalized=normalized), 0.0)
        _same_sparse(graphs.rescale_laplacian(L, lmax=3.0),
                     gc.rescale_laplacian(L, lmax=3.0), 0.0)

    def test_knn_takes_the_metric_positionally_as_jax(self):
        """``knn(z, 5, "cosine")``: the third positional argument is the
        metric in both packages (it once landed in ``algorithm`` and gave
        Euclidean neighbours)."""
        z = np.random.default_rng(8).normal(size=(120, 16))
        dist, idx = graphs.knn(z, 5, "cosine")
        dist_j, idx_j = gc.knn(z, 5, "cosine")
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_allclose(dist, dist_j, rtol=0, atol=1e-12)
        assert not np.array_equal(idx, graphs.knn(z, 5)[1])
        _same_sparse(graphs.knn_graph(z, k=6, metric="cosine"),
                     gc.knn_graph(z, k=6, metric="cosine"), 1e-12)

    @pytest.mark.parametrize("algorithm", ["auto", "kd_tree"])
    def test_tree_knn_refuses_other_metrics(self, algorithm):
        z = np.random.default_rng(9).normal(size=(50, 4))
        with pytest.raises(ValueError, match="scikit-learn"):
            graphs.knn(z, 5, "cosine", algorithm=algorithm)

    def test_rcm_permutation(self):
        z = np.random.default_rng(7).uniform(size=(400, 2))
        W = graphs.adjacency(*graphs.knn(z, k=8))
        np.testing.assert_array_equal(
            graphs.bandwidth_reducing_permutation(W),
            gc.bandwidth_reducing_permutation(W))


class TestDeviceLaplacianArguments:
    @pytest.mark.parametrize("fmt", ["dense", "banded", "bsr", "auto"])
    def test_default_device_is_the_card(self, monkeypatch, fmt):
        """As JAX puts its operators on the accelerator, ``device=None``
        means the CUDA device: without one it raises, naming the CPU
        request, rather than building on the CPU; ``device="cpu"``
        builds there."""
        L, _ = graphs.city_graph(20, k=4, seed=0)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            device_laplacian(L, fmt=fmt)
        op = device_laplacian(L, fmt=fmt, device="cpu")
        assert all(t.device.type == "cpu" for t in vars(op).values()
                   if isinstance(t, torch.Tensor))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert port_laplacian._resolve_device(None) == torch.device("cuda")

    @pytest.mark.parametrize("block_size", [64, (128, 64), (64, 64), 256])
    def test_banded_takes_other_block_shapes(self, block_size):
        """``fmt="banded"`` builds at any block shape, as JAX's does: the
        same layout, bases, schedule and block shape, and the same
        product."""
        L, _ = graphs.city_graph(20, k=4, seed=0)
        op = device_laplacian(L, fmt="banded", block_size=block_size,
                              device="cpu", use_pallas=False)
        op_j = jax_device_laplacian(L, fmt="banded", block_size=block_size,
                                    use_pallas=False)
        want = ((block_size, block_size) if isinstance(block_size, int)
                else block_size)
        assert op.block_shape == tuple(op_j.block_shape) == want
        assert (op.m_padded, op.rows_per_step, op.levels) == (
            op_j.m_padded, op_j.rows_per_step, op_j.levels)
        np.testing.assert_array_equal(op.band.numpy(), np.asarray(op_j.band))
        np.testing.assert_array_equal(op.base.numpy(), np.asarray(op_j.base))
        np.testing.assert_array_equal(op.sched.numpy(),
                                      np.asarray(op_j.sched))
        x = np.random.default_rng(3).normal(
            size=(op.m_padded, 8)).astype(np.float32)
        np.testing.assert_allclose(
            op.matmul(torch.from_numpy(x)).numpy(),
            np.asarray(op_j.matmul(jnp.asarray(x))), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("block_size", ["auto", 128, (128, 128)])
    def test_banded_takes_128_blocks(self, block_size):
        L, _ = graphs.city_graph(20, k=4, seed=0)
        op = device_laplacian(L, fmt="banded", block_size=block_size,
                              device="cpu")
        assert op.band.shape[-2:] == (128, 128) and op.m_padded % 128 == 0

    def test_auto_with_other_blocks_still_goes_to_bsr(self):
        """JAX's rule: ``fmt="auto"`` with a block size other than 128
        skips the band (laplacian.py:1249-1277)."""
        L, _ = graphs.city_graph(48, k=8, seed=0)
        op = device_laplacian(L, block_size=64, device="cpu")
        op_j = jax_device_laplacian(L, block_size=64, use_pallas=False)
        assert type(op).__name__ == type(op_j).__name__ == (
            "BlockSparseLaplacian")
        assert op.block_shape == tuple(op_j.block_shape) == (64, 64)

    def test_dense_without_rescale_is_jax_matrix(self):
        L, _ = graphs.city_graph(14, k=4, seed=0)
        op = device_laplacian(L, fmt="dense", rescale=False, device="cpu")
        op_j = jax_device_laplacian(L, fmt="dense", rescale=False)
        np.testing.assert_array_equal(op.mat.numpy(), np.asarray(op_j.mat))
        np.testing.assert_array_equal(op.mat[:196, :196].numpy(),
                                      L.toarray().astype(np.float32))
        assert op.nnz == op_j.nnz == L.nnz

    @pytest.mark.parametrize("side,want", [(14, "DenseLaplacian"),
                                           (20, "BandedLaplacian")])
    def test_auto_dense_threshold_picks_jax_format(self, side, want):
        """196 nodes fall under ``dense_threshold=256``, 400 above it; the
        default threshold (2048) would take both dense."""
        L, _ = graphs.city_graph(side, k=4, seed=0)
        op = device_laplacian(L, dense_threshold=256, device="cpu")
        op_j = jax_device_laplacian(L, dense_threshold=256, use_pallas=False)
        assert type(op).__name__ == type(op_j).__name__ == want
        op = device_laplacian(L, device="cpu")
        assert type(op).__name__ == "DenseLaplacian"


class TestPacking:
    def test_band_stats(self, city96):
        L = gc.rescale_laplacian(city96)
        got, want = packing.band_stats(L), jax_lap.band_stats(L)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]

    @pytest.mark.parametrize("ws", [[3, 5, 5, 9], [2, 3, 4, 5, 6, 7, 9, 9],
                                    [4, 4, 4]])
    def test_choose_band_levels(self, ws):
        assert (packing.choose_band_levels(ws)
                == jax_lap.choose_band_levels(ws))

    @pytest.mark.parametrize("G", [1, 2, 8])
    def test_ragged_and_dkw_layout_byte_equal(self, city96, G):
        L = gc.rescale_laplacian(city96)
        band, base, sched, levels, G_, mp = packing.pack_banded_ragged(L, G=G)
        (band_j, base_j, sched_j, levels_j, _ring, G_j,
         mp_j) = jax_lap.pack_banded_ragged(L, rows_per_step=G)
        assert (G_, mp, levels) == (G_j, mp_j, levels_j)
        assert band.dtype == band_j.dtype
        assert band.tobytes() == band_j.tobytes()
        np.testing.assert_array_equal(base, base_j)
        np.testing.assert_array_equal(sched, np.asarray(sched_j, np.int32))
        bands, sd = packing.pack_dkw_from_ragged(band, sched, levels, G)
        bands_j, sd_j = jax_dkw(band_j, sched_j, levels_j, G, 128, 128)
        assert len(bands) == len(bands_j)
        for b, b_j in zip(bands, bands_j):
            assert b.shape == b_j.shape and b.tobytes() == b_j.tobytes()
        assert sd.tobytes() == sd_j.tobytes()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_device_operator_matches_jax(self, city96, dtype):
        """The port's operator holds the JAX operator's dkw arrays word for
        word (bf16 compared as raw 16-bit words)."""
        G = 4
        op = device_laplacian(city96, fmt="banded",
                              dtype=getattr(torch, dtype), rows_per_step=G,
                              use_pallas=True, device="cpu")
        op_j = jax_device_laplacian(city96, fmt="banded",
                                    dtype=getattr(jnp, dtype),
                                    use_pallas=True, rows_per_step=G)
        assert (op.levels, op.m_padded, op.m, op.nnz, op.rows_per_step) == (
            op_j.levels, op_j.m_padded, op_j.m, op_j.nnz, op_j.rows_per_step)
        np.testing.assert_array_equal(op.base.numpy(), np.asarray(op_j.base))
        np.testing.assert_array_equal(op.sched_dkw.numpy(),
                                      np.asarray(op_j.sched_dkw))
        word = torch.int16 if dtype == "bfloat16" else torch.int32
        for b, b_j in zip(op.bands_dkw, op_j.bands_dkw, strict=True):
            got = b.view(word).numpy().view(np.uint8)
            want = np.asarray(b_j).view(np.uint8)
            assert got.shape == want.shape and np.array_equal(got, want)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_quantized_band_byte_equal(self, city96, dtype):
        G = 2
        op = device_laplacian(city96, fmt="banded",
                              dtype=getattr(torch, dtype), rows_per_step=G,
                              use_pallas=True, device="cpu")
        op_j = jax_device_laplacian(city96, fmt="banded",
                                    dtype=getattr(jnp, dtype),
                                    use_pallas=True, rows_per_step=G)
        q = quantize_banded(op, sample_x=3.0)
        q_j = jax_quantize_banded(op_j, sample_x=3.0)
        assert q.band_scale == q_j.band_scale
        assert q.act_scale == q_j.act_scale
        for b, b_j in zip(q.bands_dkw, q_j.bands_dkw, strict=True):
            assert b.dtype == torch.int8
            np.testing.assert_array_equal(b.numpy(), np.asarray(b_j))
        # The packer-level quantizer on the flat band, as the JAX one runs.
        flat = np.asarray(op_j.band, np.float32)
        np.testing.assert_array_equal(
            packing.quantize_band(flat, q_j.band_scale), np.asarray(q_j.band))
