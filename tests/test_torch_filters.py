"""The Fourier, spline and Lanczos filters and their host helpers on the
CPU against the JAX package, on the same NumPy inputs.

Host helpers (``lmax``, ``fourier``, ``chebyshev_basis``,
``lanczos_basis``, ``replace_random_edges``, ``bspline_basis``,
``load_mnist``): the same arrays, exactly (the same NumPy/SciPy calls),
except ``lmax`` of an unnormalized Laplacian (ARPACK starts from a
random vector: rel 1e-5).  Device filters, f32: ``fourier_conv`` values
and gradients rtol 1e-5 / atol 1e-6 (three contractions summed in
another order); ``lanczos_basis_device``/``lanczos_conv`` on a dense and
a banded operator (JAX's without Pallas, the port's banded operator on
its kernel's plain version), values and gradients within 1e-4 of the
largest entry (a K-step Krylov recurrence and a batched ``eigh`` in f32,
each package's own LAPACK call); ``cheby_conv`` at B = 3 and Fin = 4
on every route whose carries take ``_rows``' batch-major columns (int8
banded, BSR and dense, float banded and the stacked dense route): f32
values and gradients rtol=atol=1e-4, int8 values atol=1e-4, and the
int8 stacked basis equal to JAX's; the ChebNet with each filter on a
12x12 grid's coarsened graphs, carried weights: logits rtol=atol=1e-4,
loss rtol 1e-5, gradients within 1e-4 of each leaf's largest entry
(Lanczos: 1e-3, its gradient passes through ``eigh``'s)."""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from cnn_graph_tpu.data.mnist import load_mnist as jax_load_mnist
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import ChebNet as JaxChebNet
from cnn_graph_tpu.models import bspline_basis as jax_bspline_basis
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import filters as jax_filters
from cnn_graph_tpu.ops import quantize_banded as jax_quantize_banded
from cnn_graph_tpu.ops import quantize_block_sparse as jax_quantize_bsr
from cnn_graph_tpu.ops import quantize_dense as jax_quantize_dense
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import chebnet_params_from_jax
from cnn_graph_tpu_torch.data import load_mnist
from cnn_graph_tpu_torch.models import ChebNet, bspline_basis
from cnn_graph_tpu_torch.models.common import tree_map
from cnn_graph_tpu_torch.ops import (
    cheby_basis,
    cheby_conv,
    cheby_weights_from_flat,
    device_laplacian,
    fourier_conv,
    lanczos_basis_device,
    lanczos_conv,
    quantize_banded,
    quantize_block_sparse,
    quantize_dense,
)
from cnn_graph_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def grid_graph():
    """The 8x8 grid's 8-NN graph: its normalized Laplacian, rescaled."""
    W = graphs.knn_graph(graphs.grid(8), k=8)
    L = graphs.laplacian(W, normalized=True)
    return W, L, graphs.rescale_laplacian(L)


QUANTIZE = {"banded": (quantize_banded, jax_quantize_banded),
            "bsr": (quantize_block_sparse, jax_quantize_bsr),
            "dense": (quantize_dense, jax_quantize_dense)}


def _op_pair(L, fmt, int8):
    """The port's and JAX's operator of one format for the RCM-ordered
    Laplacian (JAX's without Pallas), int8 twins with ``sample_x=3``."""
    perm = graphs.bandwidth_reducing_permutation(L)
    L = L[perm][:, perm].tocsr()
    kw = {"block_size": 16} if fmt == "bsr" else {}
    op = device_laplacian(L, fmt=fmt, device="cpu", **kw)
    op_j = jax_device_laplacian(L, fmt=fmt, use_pallas=False, **kw)
    if int8:
        quant, jax_quant = QUANTIZE[fmt]
        op, op_j = quant(op, sample_x=3.0), jax_quant(op_j, sample_x=3.0)
    return op, op_j


def _close_rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-12), err


class TestHostHelpers:
    def test_spectra_and_bases_match_jax(self, grid_graph):
        W, L, Lr = grid_graph
        lam, U = graphs.fourier(L)
        lam_j, U_j = gc.fourier(L)
        np.testing.assert_array_equal(lam, lam_j)
        np.testing.assert_array_equal(U, U_j)
        lam_e, U_e = graphs.fourier(L, algo="eig")
        np.testing.assert_array_equal(lam_e, gc.fourier(L, algo="eig")[0])
        assert np.all(np.diff(lam_e.real) >= 0)
        assert graphs.lmax(L) == gc.lmax(L) == 2.0
        Lu = graphs.laplacian(W, normalized=False)
        np.testing.assert_allclose(graphs.lmax(Lu, normalized=False),
                                   gc.lmax(Lu, normalized=False), rtol=1e-5)
        X = np.random.default_rng(0).normal(size=(64, 5))
        np.testing.assert_array_equal(graphs.chebyshev_basis(Lr, X, 4),
                                      gc.chebyshev_basis(Lr, X, 4))
        np.testing.assert_array_equal(graphs.lanczos_basis(Lr, X, 4),
                                      gc.lanczos_basis(Lr, X, 4))
        with pytest.raises(ValueError, match="EVD"):
            graphs.fourier(L, algo="svd")

    @pytest.mark.parametrize("noise,seed", [(0.1, 3), (0.5, None)])
    def test_replace_random_edges_matches_jax(self, grid_graph, noise, seed):
        W, *_ = grid_graph
        got = graphs.replace_random_edges(W, noise, seed=seed)
        if seed is None:
            # Unseeded draws differ run to run: the graph stays a
            # symmetric unit-weight perturbation with a zero diagonal.
            assert abs(got - got.T).max() == 0 and got.diagonal().max() == 0
            return
        want = gc.replace_random_edges(W, noise, seed=seed)
        assert abs(got - want).max() == 0 and got.nnz == want.nnz
        assert abs(got - W).max() > 0

    @pytest.mark.parametrize("K,degree", [(5, 3), (8, 2), (4, 1)])
    def test_bspline_basis_matches_jax(self, grid_graph, K, degree):
        """JAX's basis, a partition of unity over the spectrum."""
        lam = graphs.fourier(grid_graph[1])[0]
        B = bspline_basis(K, lam, degree)
        np.testing.assert_array_equal(B, jax_bspline_basis(K, lam, degree))
        assert B.shape == (64, K) and B.dtype == np.float32
        np.testing.assert_allclose(B.sum(1), 1.0, rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="K > degree"):
            bspline_basis(degree, lam, degree)

    def test_cheby_weights_from_flat_matches_jax(self):
        w = np.random.default_rng(1).normal(size=(3 * 4, 5)).astype(
            np.float32)
        np.testing.assert_array_equal(
            cheby_weights_from_flat(torch.from_numpy(w), 3, 4).numpy(),
            np.asarray(jax_filters.cheby_weights_from_flat(w, 3, 4)))

    @pytest.mark.parametrize("gz", [False, True])
    def test_load_mnist_reads_idx_files(self, tmp_path, gz):
        """IDX files the test writes (plain and ``.gz``) read as JAX reads
        them."""
        rng = np.random.default_rng(2)
        arrays = {"train-images-idx3-ubyte": rng.integers(
                      0, 256, (6, 28, 28), dtype=np.uint8),
                  "train-labels-idx1-ubyte": rng.integers(
                      0, 10, 6, dtype=np.uint8),
                  "t10k-images-idx3-ubyte": rng.integers(
                      0, 256, (3, 28, 28), dtype=np.uint8),
                  "t10k-labels-idx1-ubyte": rng.integers(
                      0, 10, 3, dtype=np.uint8)}
        for name, a in arrays.items():
            raw = (struct.pack(">HBB", 0, 8, a.ndim)
                   + struct.pack(f">{a.ndim}I", *a.shape) + a.tobytes())
            if gz:
                (tmp_path / (name + ".gz")).write_bytes(gzip.compress(raw))
            else:
                (tmp_path / name).write_bytes(raw)
        got, want = load_mnist(str(tmp_path)), jax_load_mnist(str(tmp_path))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (6, 784) and float(got[0].max()) <= 1.0
        with pytest.raises(FileNotFoundError, match="downloaded"):
            load_mnist(str(tmp_path / "missing"))


class TestDeviceFilters:
    def test_fourier_conv_matches_jax(self, grid_graph):
        _, L, _ = grid_graph
        U = graphs.fourier(L)[1].astype(np.float32)
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 64, 3)).astype(np.float32)
        w = rng.normal(size=(64, 4, 3)).astype(np.float32)
        r = rng.normal(size=(2, 64, 4)).astype(np.float32)

        def f_j(x, w):
            return jnp.sum(jax_filters.fourier_conv(x, jnp.asarray(U), w)
                           * r)

        y_j = jax_filters.fourier_conv(jnp.asarray(x), jnp.asarray(U),
                                       jnp.asarray(w))
        gx_j, gw_j = jax.grad(f_j, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = fourier_conv(xt, torch.from_numpy(U), wt)
        (y * torch.from_numpy(r)).sum().backward()
        for a, b in ((y.detach(), y_j), (xt.grad, gx_j), (wt.grad, gw_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)

    @pytest.mark.parametrize("fmt", ["dense", "banded"])
    def test_lanczos_matches_jax(self, grid_graph, fmt):
        """The basis and the conv's values and gradients (x and w) on each
        package's operator of one format."""
        _, L, _ = grid_graph
        perm = graphs.bandwidth_reducing_permutation(L)
        L = L[perm][:, perm].tocsr()
        op = device_laplacian(L, fmt=fmt, device="cpu")
        op_j = jax_device_laplacian(L, fmt=fmt, use_pallas=False)
        assert type(op).__name__ == type(op_j).__name__
        K = 4
        rng = np.random.default_rng(4)
        x = rng.normal(size=(2, 64, 3)).astype(np.float32)
        w = (0.3 * rng.normal(size=(K, 3, 5))).astype(np.float32)
        r = rng.normal(size=(2, 64, 5)).astype(np.float32)
        basis_j = jax.jit(jax_filters.lanczos_basis_device,
                          static_argnums=2)(jnp.asarray(x), op_j, K)
        with torch.no_grad():
            basis = lanczos_basis_device(torch.from_numpy(x), op, K)
        _close_rel(basis.numpy(), basis_j, 1e-4)

        def f_j(x, w):
            return jnp.sum(jax_filters.lanczos_conv(x, op_j, w) * r)

        y_j = jax.jit(jax_filters.lanczos_conv)(jnp.asarray(x), op_j,
                                                jnp.asarray(w))
        gx_j, gw_j = jax.jit(jax.grad(f_j, argnums=(0, 1)))(jnp.asarray(x),
                                                            jnp.asarray(w))
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = lanczos_conv(xt, op, wt)
        (y * torch.from_numpy(r)).sum().backward()
        _close_rel(y.detach().numpy(), y_j, 1e-4)
        _close_rel(xt.grad.numpy(), gx_j, 1e-4)
        _close_rel(wt.grad.numpy(), gw_j, 1e-4)

    @pytest.mark.parametrize("route,fmt,int8", [
        ("quant_stream", "banded", True),
        ("quant_stream", "bsr", True),
        ("quant_stream", "dense", True),
        ("banded", "banded", False),
        ("stacked", "dense", False),
    ], ids=["int8-banded", "int8-bsr", "int8-dense", "banded", "stacked"])
    def test_cheby_conv_routes_match_jax(self, grid_graph, route, fmt,
                                         int8):
        """Each route whose carries are batch-major columns, at B = 3 and
        Fin = 4 so that no layout coincides with another: int8 values
        (inference) within 1e-4, float values and gradients (x and w)
        rtol=atol=1e-4 of JAX's ``cheby_conv``."""
        _, L, _ = grid_graph
        op, op_j = _op_pair(L, fmt, int8)
        K = 5
        rng = np.random.default_rng(6)
        x = rng.normal(size=(3, 64, 4)).astype(np.float32)
        w = (0.3 * rng.normal(size=(K, 4, 5))).astype(np.float32)
        r = rng.normal(size=(3, 64, 5)).astype(np.float32)
        y_j = jax.jit(jax_filters.cheby_conv)(jnp.asarray(x), op_j,
                                              jnp.asarray(w))
        if int8:
            with torch.no_grad(), profiling.recording() as rec:
                y = cheby_conv(torch.from_numpy(x), op, torch.from_numpy(w))
            assert rec.spans[0].name == f"conv.{route}"
            np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0,
                                       atol=1e-4)
            return

        def f_j(x, w):
            return jnp.sum(jax_filters.cheby_conv(x, op_j, w) * r)

        gx_j, gw_j = jax.jit(jax.grad(f_j, argnums=(0, 1)))(jnp.asarray(x),
                                                            jnp.asarray(w))
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        with profiling.recording() as rec:
            y = cheby_conv(xt, op, wt)
        assert rec.spans[0].name == f"conv.{route}"
        (y * torch.from_numpy(r)).sum().backward()
        for a, b in ((y.detach(), y_j), (xt.grad, gx_j), (wt.grad, gw_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)

    @pytest.mark.parametrize("fmt", ["banded", "bsr", "dense"])
    def test_int8_cheby_basis_matches_jax(self, grid_graph, fmt):
        """The stacked basis on int8 carries with B > 1 and F > 1, one
        dequantisation of JAX's carries to x's dtype: equal."""
        _, L, _ = grid_graph
        op, op_j = _op_pair(L, fmt, int8=True)
        x = np.random.default_rng(7).normal(size=(3, 64, 4)).astype(
            np.float32)
        with torch.no_grad():
            got = cheby_basis(torch.from_numpy(x), op, 5)
        want = jax_filters.cheby_basis(jnp.asarray(x), op_j, 5)
        assert got.shape == (5, 3, 64, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_lanczos_basis_matches_the_host_oracle(self, grid_graph):
        """The device basis is the host oracle's (signs cancel), with
        the oracle's columns laid out feature-major (each column is its
        own signal, so the device's batch-major order gives the same
        basis)."""
        *_, Lr = grid_graph
        x = np.random.default_rng(5).normal(size=(2, 64, 3))
        op = device_laplacian(graphs.laplacian(grid_graph[0]), fmt="dense",
                              device="cpu")
        with torch.no_grad():
            got = lanczos_basis_device(torch.from_numpy(x).float(), op, 5)
        X = x.transpose(1, 2, 0).reshape(64, 6)
        want = graphs.lanczos_basis(Lr, X, 5).reshape(5, 64, 3, 2)
        _close_rel(got.numpy(), want.transpose(0, 3, 1, 2), 1e-4)

    def test_lanczos_breakdown_gives_finite_zeros(self):
        """An invariant subspace ends the recurrence early: the remaining
        directions are zeros, not NaNs (x an eigenvector of L)."""
        L = scipy.sparse.csr_matrix(np.diag([0.0, 0.5, 1.0, 1.5] * 2))
        op = device_laplacian(L, fmt="dense", rescale=False, device="cpu")
        x = torch.zeros(1, 8, 1)
        x[0, 1, 0] = 2.0
        basis = lanczos_basis_device(x, op, 3)
        assert bool(torch.isfinite(basis).all())
        basis_j = jax_filters.lanczos_basis_device(
            jnp.asarray(x.numpy()),
            jax_device_laplacian(L, fmt="dense", rescale=False,
                                 use_pallas=False), 3)
        np.testing.assert_allclose(basis.numpy(), np.asarray(basis_j),
                                   atol=1e-6)


ARCH = dict(F=[8, 16], K=[5, 5], p=[4, 4], M=[32, 10])


@pytest.fixture(scope="module")
def coarse():
    """The 12x12 grid's 8-NN graph coarsened 4 levels as the MNIST
    pipeline does, 4 random signals on it, and both packages' f32 dense
    operators per level."""
    W = graphs.knn_graph(graphs.grid(12), k=8)
    gs, perm = graphs.coarsen(W, levels=4, seed=2017)
    Ls = [graphs.laplacian(g, normalized=True) for g in gs]
    rng = np.random.default_rng(6)
    x = graphs.perm_data(rng.uniform(size=(4, 144)), perm).astype(np.float32)
    y = rng.integers(0, 10, 4)
    ops = [device_laplacian(L, fmt="dense", device="cpu") for L in Ls]
    ops_j = [jax_device_laplacian(L, fmt="dense", use_pallas=False)
             for L in Ls]
    return (x, y), Ls, ops, ops_j


@pytest.mark.parametrize("filt", ["fourier", "spline", "lanczos"])
def test_chebnet_filters_match_jax(coarse, filt):
    """Logits, loss and every gradient of the ChebNet with each filter,
    the JAX weights carried over, and the weights' layout."""
    (x, y), Ls, ops, ops_j = coarse
    kw = dict(laplacians=Ls, filter=filt, regularization=5e-4)
    model_j = JaxChebNet(ops_j, **ARCH, **kw)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(1)))
    model = ChebNet(ops, **ARCH, **kw)
    assert (tree_map(lambda t: tuple(t.shape), model.param_tree())
            == jax.tree.map(lambda a: a.shape, params_j))
    params = tree_map(torch.Tensor.requires_grad_,
                      chebnet_params_from_jax(params_j))
    logits = model.apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jax.jit(model_j.apply)(params_j, jnp.asarray(x))),
        rtol=1e-4, atol=1e-4)
    loss_j, grads_j = jax.jit(jax.value_and_grad(model_j.loss))(
        params_j, jnp.asarray(x), jnp.asarray(y))
    loss = model.loss(params, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    tol = 1e-3 if filt == "lanczos" else 1e-4
    for group in ("gconv", "fc"):
        for layer, layer_j in zip(params[group], grads_j[group]):
            for k in ("w", "b"):
                _close_rel(layer[k].grad.numpy(), layer_j[k], tol)
