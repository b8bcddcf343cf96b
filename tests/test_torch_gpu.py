"""The CUDA kernels against their plain PyTorch versions on the card.

Imports only torch and the port, so it runs on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_gpu.py`` (the shared
conftest imports JAX).  Every test skips where no CUDA device is present.

Tolerances: int8 bit-exact (integer accumulation, identical f32
epilogue); f32 ``atol=1e-4`` (sums in another order); bf16 within one
bf16 ulp (``rtol=2**-7``) of the plain version, which rounds the same
f32 accumulation once.
"""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse
import torch

from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.ops import (
    band_spmm,
    banded_dkw,
    banded_dkw_reference,
    banded_ragged,
    banded_rows_reference,
    banded_uniform,
    bsr_colstream,
    bsr_colstream_reference,
    bsr_csr,
    bsr_csr_reference,
    bsr_rows_reference,
    bsr_spmm,
    cheby_conv,
    cheby_conv_banded,
    cheby_conv_fused,
    cheby_conv_fused_reference,
    cheby_dw_fused,
    cheby_dw_fused_reference,
    cheby_finals,
    conv_geometry,
    conv_resources,
    device_laplacian,
    fused_filter,
    quantize_banded,
    quantize_block_sparse,
    quantize_dense,
)
from cnn_graph_tpu_torch.ops.band import layout_call
from cnn_graph_tpu_torch.serve import compile_serving
from cnn_graph_tpu_torch.utils import probes, slope_time

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def city96():
    return graphs.city_graph(96, k=8, seed=0)[0]


def _operator(L, dtype, device, G=2):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    op = device_laplacian(L, fmt="banded", dtype=dt, rows_per_step=G,
                          device=device)
    return quantize_banded(op, sample_x=3.0) if dtype == "int8" else op


def _index(op):
    """The row index K1, K5 and K6 walk, as their wrappers take it."""
    return dict(nz_rowptr=op.nz_rowptr, nz_win=op.nz_win)


def _rows_reference(op, layout, x, x0=None, c=None, scale=None,
                    base=None):
    """The row walk's plain version on ``op``'s ``layout`` band."""
    if layout == "dkw":
        bands, sched, levels = op.bands_dkw, op.sched_dkw, op.levels
    elif layout == "ragged":
        bands, sched, levels = (op.band,), op.sched, op.levels
    else:
        bands, sched, levels = (op.band,), None, (op.band.shape[1],)
    return banded_rows_reference(
        bands, op.base if base is None else base, sched, op.nz_rowptr,
        op.nz_win, x, x0, c, layout=layout, levels=levels,
        G=op.rows_per_step, band_scale=scale)


@pytest.mark.parametrize("C", [48, 37, 300])
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kernel_matches_reference(city96, cuda_device, dtype, hop, C):
    op = _operator(city96, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(C)
    x, x0 = (torch.randn(op.m_padded, C, generator=g, device=cuda_device)
             for _ in range(2))
    if dtype == "int8":
        x, x0 = op.quantize(x), op.quantize(x0)
        scale = op.band_scale
    else:
        x, x0, scale = x.to(op.compute_dtype), x0.to(op.compute_dtype), None
    args = (op.bands_dkw, op.base, op.sched_dkw, x, x0 if hop else None)
    kw = dict(levels=op.levels, G=op.rows_per_step, band_scale=scale)
    before = banded_dkw.launches
    got = banded_dkw(*args, **kw, **_index(op))
    torch.cuda.synchronize()
    assert banded_dkw.launches == before + 1
    # The window product and the row walk, both plain versions.
    for want in (banded_dkw_reference(*args, **kw),
                 _rows_reference(op, "dkw", x, x0 if hop else None,
                                 scale=scale)):
        assert got.dtype == want.dtype == x.dtype
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(
                got.float(), want.float(), atol=1e-4,
                rtol=2**-7 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("C", [48, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adjoint_hop_matches_reference(city96, cuda_device, dtype, C):
    """The + c form, 2 L@x - x0 + c, against the plain version."""
    op = _operator(city96, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(C)
    x, x0, c = (torch.randn(op.m_padded, C, generator=g, device=cuda_device)
                .to(op.compute_dtype) for _ in range(3))
    args = (op.bands_dkw, op.base, op.sched_dkw, x, x0, c)
    kw = dict(levels=op.levels, G=op.rows_per_step)
    before = banded_dkw.form_launches["hop_c"]
    got = banded_dkw(*args, **kw, **_index(op))
    torch.cuda.synchronize()
    assert banded_dkw.form_launches["hop_c"] == before + 1
    want = banded_dkw_reference(*args, **kw)
    torch.testing.assert_close(
        got.float(), want.float(), atol=1e-4,
        rtol=2**-7 if dtype == "bfloat16" else 1e-5)


def test_adjoint_hop_refuses_int8(city96, cuda_device):
    q = _operator(city96, "int8", cuda_device)
    x = torch.zeros(q.m_padded, 16, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        banded_dkw(q.bands_dkw, q.base, q.sched_dkw, x, x, x,
                   levels=q.levels, G=q.rows_per_step,
                   band_scale=q.band_scale, **_index(q))


@pytest.mark.parametrize("K", [2, 7])
def test_conv_gradients_through_kernel_match_plain_version(city96,
                                                           cuda_device, K):
    """cheby_conv_banded's dx and dW on the card (every band product a
    kernel launch) against the same operator on the CPU (plain version);
    f32, so only the summation order differs."""
    op = _operator(city96, "float32", cuda_device)
    rng = np.random.default_rng(K)
    x = rng.normal(size=(2, op.m, 8)).astype(np.float32)
    w = (rng.normal(size=(K, 8, 3)) * 0.3).astype(np.float32)
    t = rng.normal(size=(2, op.m, 3)).astype(np.float32)
    grads = []
    for o, dev in ((op, cuda_device), (op.to("cpu"), "cpu")):
        xt, wt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (x, w))
        before = banded_dkw.launches
        y = cheby_conv_banded(xt, o, wt)
        (y * torch.from_numpy(t).to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            # Forward K-1, backward K-1 (K-2 adjoint hops and one L@x).
            assert banded_dkw.launches == before + 2 * (K - 1)
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-4)


def test_kernel_rejects_bad_arguments(city96, cuda_device):
    op = _operator(city96, "float32", cuda_device)
    x = torch.zeros(op.m_padded, 16, device=cuda_device)
    kw = dict(levels=op.levels, G=op.rows_per_step, **_index(op))
    with pytest.raises(TypeError):
        banded_dkw(op.bands_dkw, op.base, op.sched_dkw, x.to(torch.bfloat16),
                   **kw)
    with pytest.raises(ValueError):
        banded_dkw(op.bands_dkw, op.base, op.sched_dkw, x[:, ::2], **kw)
    with pytest.raises(ValueError):
        banded_dkw(op.bands_dkw, op.base.cpu(), op.sched_dkw, x, **kw)
    # A contiguous view that starts 12 bytes into its buffer: the kernel's
    # 16-byte loads would fault on it, so the public wrapper refuses it.
    flat = torch.zeros(op.m_padded * 16 + 3, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        band_spmm(op, flat[3:].view(op.m_padded, 16))
    # The row index: int16 offsets, int32 row pointer of nbr*128 + 1.
    with pytest.raises(TypeError, match="int16"):
        banded_dkw(op.bands_dkw, op.base, op.sched_dkw, x,
                   **dict(kw, nz_win=op.nz_win.int()))
    with pytest.raises(ValueError, match="nz_rowptr"):
        banded_dkw(op.bands_dkw, op.base, op.sched_dkw, x,
                   **dict(kw, nz_rowptr=op.nz_rowptr[:-1]))


@pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
def test_row_walk_wrappers_raise_without_the_index(city96, cuda_device,
                                                   layout):
    """K1, K5 and K6 walk the row index: a CUDA x without it raises, and
    nothing falls back to another kernel or the plain version."""
    op = _layout_operator(city96, layout, "float32", cuda_device)
    x = torch.zeros(op.m_padded, 16, device=cuda_device)
    before = _COUNTED[layout].launches
    for missing in ("nz_rowptr", "nz_win"):
        index = dict(_index(op), **{missing: None})
        with pytest.raises(ValueError, match="row index"):
            if layout == "dkw":
                banded_dkw(op.bands_dkw, op.base, op.sched_dkw, x,
                           levels=op.levels, G=op.rows_per_step, **index)
            elif layout == "ragged":
                banded_ragged(op.band, op.base, op.sched, x,
                              levels=op.levels, G=op.rows_per_step, **index)
            else:
                banded_uniform(op.band, op.base, x, **index)
    assert _COUNTED[layout].launches == before


@pytest.mark.parametrize("int8", [False, True])
def test_serving_through_kernel_matches_plain_version(city96, cuda_device,
                                                      int8):
    """Served logits on the card: once through the kernel, once with the
    same operator and weights on the CPU (plain version)."""
    op = device_laplacian(city96, fmt="auto", dtype=torch.bfloat16,
                          device=cuda_device)
    model = NodeClassifier(op, 32, 8, hidden=[], K=5,
                           generator=torch.Generator().manual_seed(0))
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(size=(op.m, 32)).astype(np.float32))
    serving = compile_serving(model, model.param_tree(),
                              feats.to(cuda_device), int8=int8)
    before = banded_dkw.launches
    got = serving(feats.to(cuda_device)).cpu()
    assert banded_dkw.launches == before + 4
    plain = compile_serving(serving.model, model.param_tree(), feats,
                            int8=False)
    want = plain(feats)
    assert got.shape == (op.m, 8) and torch.isfinite(got).all()
    # int8: identical carries, only the f32 taps sum in another order.
    # bf16: a carry rounded from f32 sums taken in another order may land
    # one bf16 ulp away, and the later hops carry that difference along.
    tol = 1e-4 if int8 else 2**-6
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------------ K2, K3
# Tolerances: f32 ``atol=1e-4`` (the same f32 products summed in another
# order); bf16 1e-2 of the largest value: a carry that lands next to a
# bf16 rounding boundary may round one ulp (2^-8) apart in the two
# versions, and later hops carry that difference along.


@pytest.fixture(scope="module")
def knn203():
    z = np.random.default_rng(3).uniform(size=(203, 2))
    return graphs.laplacian(graphs.knn_graph(z, k=6))


def _dense(L, dtype, device):
    return device_laplacian(L, fmt="dense", dtype=dtype, device=device,
                            use_pallas=True)


def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-2 * float(want.abs().max()), err


@pytest.fixture(scope="module")
def grid976():
    """The MNIST grid's 976-node level-0 operator's Laplacian (the bench's
    dense_fused shape)."""
    from cnn_graph_tpu_torch.data import mnist_graph_data, synthetic_mnist

    splits = synthetic_mnist(n_train=8, n_val=0, n_test=8, seed=2017)
    return mnist_graph_data(splits, seed=2017)[1][0]


@pytest.mark.parametrize("F,O,B,graph", [
    (32, 64, 3, "knn203"), (64, 32, 2, "knn203"), (8, 12, 5, "knn203"),
    (12, 8, 23, "knn203"), (32, 32, 6, "knn203"), (32, 32, 4, "grid976"),
    (32, 32, 7, "grid976"), (200, 24, 2, "knn203")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cheby_kernels_match_reference(request, cuda_device, dtype, F, O, B,
                                       graph):
    """K2 and K3 against their plain versions on the card.  K2's tiling
    edges: B not a multiple of the samples per cluster (3 of 4, 23 of
    10, 6 and 7 of 4), 208 padded nodes (not a multiple of the 64-row
    tile), the 976-node operator at B = 4 (one cluster of 8 CTAs, two
    tiles each) and 7, F = 8 and 12 (np 40 and 120), and F = 200 (two
    128-column passes per hop)."""
    op = _dense(request.getfixturevalue(graph), dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(F + O)
    x = torch.randn(B, op.m, F, generator=g, device=cuda_device)
    w = 0.1 * torch.randn(7, F, O, generator=g, device=cuda_device)
    gy = torch.randn(B, op.m, O, generator=g, device=cuda_device)
    before = (cheby_conv_fused.launches, cheby_dw_fused.launches)
    y = fused_filter(x, op, w)
    dw = cheby_dw_fused(x, op, gy, 7)
    torch.cuda.synchronize()
    assert (cheby_conv_fused.launches, cheby_dw_fused.launches) == (
        before[0] + 1, before[1] + 1)
    assert y.shape == (B, op.m, O) and dw.shape == (7, F, O)
    _close(y, cheby_conv_fused_reference(x, op, w), dtype)
    _close(dw, cheby_dw_fused_reference(x, op, gy, 7), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cheby_conv_kernel_takes_a_nonsymmetric_operator(knn203, cuda_device,
                                                         dtype):
    """K2 multiplies by L, not L^T, in both dtypes: the f32 kernel reads
    its hop operand transposed and is given L^T."""
    L = (knn203 + 0.5 * scipy.sparse.triu(knn203, 1)).tocsr()
    op = _dense(L, dtype, cuda_device)
    assert not torch.equal(op.mat, op.mat.T)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(3, op.m, 32, generator=g, device=cuda_device)
    w = 0.1 * torch.randn(6, 32, 16, generator=g, device=cuda_device)
    _close(fused_filter(x, op, w), cheby_conv_fused_reference(x, op, w),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cheby_dw_kernel_takes_a_nonsymmetric_operator(knn203, cuda_device,
                                                       dtype):
    """K3 recomputes T_k(L) x, not T_k(L^T) x, in both dtypes: its f32
    hop reads the operator transposed and is given L^T, as K2's."""
    L = (knn203 + 0.5 * scipy.sparse.triu(knn203, 1)).tocsr()
    op = _dense(L, dtype, cuda_device)
    assert not torch.equal(op.mat, op.mat.T)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(3, op.m, 32, generator=g, device=cuda_device)
    gy = torch.randn(3, op.m, 64, generator=g, device=cuda_device)
    _close(cheby_dw_fused(x, op, gy, 6),
           cheby_dw_fused_reference(x, op, gy, 6), dtype)


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cheby_kernels_at_both_ring_depths(knn203, cuda_device, dtype,
                                           stages):
    """The library's 2- and 3-stage instantiations of K2 and K3, which
    tools/ring_depth.py times against each other, both compute the plain
    versions' results."""
    from cnn_graph_tpu_torch.ops.cheby import (
        _fold_dw_partials,
        _launch_conv,
        _launch_dw,
    )

    op = _dense(knn203, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(stages)
    x = torch.randn(5, op.m, 32, generator=g, device=cuda_device)
    w = 0.1 * torch.randn(6, 32, 64, generator=g, device=cuda_device)
    gy = torch.randn(5, op.m, 64, generator=g, device=cuda_device)
    _close(_launch_conv(op, x, w, stages), cheby_conv_fused_reference(
        x, op, w), dtype)
    _close(_fold_dw_partials(_launch_dw(op, x, gy, 6, stages),
                             op.compute_dtype),
           cheby_dw_fused_reference(x, op, gy, 6), dtype)


# K2's launch shapes (B, Mp, F, O), as tests/test_torch_cheby.py's
# geometry test: the bench's dense_fused conv, ChebNet layer 1's forward
# and dx, knn203's, and a wide F.
_GEOMETRY_SHAPES = [(100, 976, 32, 32), (100, 244, 32, 64),
                    (100, 244, 64, 32), (3, 208, 32, 64), (5, 208, 8, 12),
                    (4, 976, 32, 32), (3, 976, 200, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_geometry_fits_the_card(cuda_device, dtype):
    """At every geometry K2 takes, the built kernel's ring fits in the
    232,448 bytes of shared memory a CTA can have and the card holds at
    least one cluster at once; at the bench shape, all of its clusters
    (one wave)."""
    n_sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    for B, mp, F, O in _GEOMETRY_SHAPES:
        geo = conv_geometry(B, mp, F, O, n_sms)
        res = conv_resources(geo["rows"], dtype, geo["cluster"])
        assert 0 < res["smem"] <= 232_448, (B, mp, F, O, res)
        assert res["resident_clusters"] >= 1, (B, mp, F, O, res)
    bench = conv_geometry(100, 976, 32, 32, n_sms)
    assert conv_resources(bench["rows"], dtype, bench["cluster"])[
        "resident_clusters"] >= bench["groups"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_geometry_fits_the_card(cuda_device, dtype):
    """K3 runs on K2's geometry: at every shape, its ring fits in the
    232,448 bytes of shared memory a CTA can have and the card holds at
    least one of its clusters at once."""
    n_sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    for B, mp, F, O in _GEOMETRY_SHAPES:
        geo = conv_geometry(B, mp, F, O, n_sms)
        res = conv_resources(geo["rows"], dtype, geo["cluster"], "K3")
        assert 0 < res["smem"] <= 232_448, (B, mp, F, O, res)
        assert res["resident_clusters"] >= 1, (B, mp, F, O, res)


def test_cheby_conv_fused_gradients_through_kernels(knn203, cuda_device):
    """dx (K2 with W^T) and dW (K3) on the card against the same conv on
    the CPU (plain versions); f32, so only the summation order differs.
    One training pass is 2 K2 launches and 1 K3 launch."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 203, 32)).astype(np.float32)
    w = (rng.normal(size=(5, 32, 64)) * 0.1).astype(np.float32)
    t = rng.normal(size=(3, 203, 64)).astype(np.float32)
    grads = []
    for dev in (cuda_device, "cpu"):
        op = _dense(knn203, torch.float32, dev)
        xt, wt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (x, w))
        before = (cheby_conv_fused.launches, cheby_dw_fused.launches)
        y = cheby_conv(xt, op, wt)
        (y * torch.from_numpy(t).to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (cheby_conv_fused.launches - before[0],
                    cheby_dw_fused.launches - before[1]) == (2, 1)
        grads.append((y.detach().cpu(), xt.grad.cpu(), wt.grad.cpu()))
    for got, want, atol in zip(*grads, (1e-4, 1e-4, 1e-3)):
        torch.testing.assert_close(got, want, atol=atol, rtol=1e-5)


def test_cheby_kernel_rejects_bad_arguments(knn203, cuda_device):
    op = _dense(knn203, torch.float32, cuda_device)
    x = torch.zeros(2, op.m, 32, device=cuda_device)
    with pytest.raises(ValueError):
        fused_filter(x, op, torch.zeros(3, 32, 32))
    with pytest.raises(ValueError):
        fused_filter(x, op.to("cpu"), torch.zeros(3, 32, 32,
                                                  device=cuda_device))
    with pytest.raises(TypeError):
        fused_filter(x, dataclasses.replace(op, mat=op.mat.half()),
                     torch.zeros(3, 32, 32, device=cuda_device))


# ----------------------------------------------------- BSR: K4, K7, K8, K9
# Tolerances as for K1: int8 bit-exact; f32 atol 1e-4 (sums in another
# order); bf16 one bf16 ulp of the plain version's single rounding.


@pytest.fixture(scope="module")
def city48():
    """2,304 nodes: three column-streamed groups of 8 block-rows."""
    return graphs.city_graph(48, k=8, seed=0)[0]


_LAYOUTS = {  # layout -> (device_laplacian arguments, bsr_csr route)
    "colstream": (dict(), None),
    "grouped": (dict(col_stream=False), "K7"),
    "csr": (dict(col_stream=False), "K8"),
    "chunked": (dict(chunked_rows=True), "K9"),
}


def _bsr(L, layout, dtype, device, block_size=128):
    kw, route = _LAYOUTS[layout]
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    op = device_laplacian(L, fmt="bsr", block_size=block_size, dtype=dt,
                          device=device, **kw)
    assert op.use_pallas and op.col_stream == (layout == "colstream")
    if layout == "csr":  # the one-row-per-step route of the same layout
        op = dataclasses.replace(op, rows_per_step=1)
    assert (op.row_max > 0) == (layout == "chunked")
    return (quantize_block_sparse(op, sample_x=3.0) if dtype == "int8"
            else op), route


def _bsr_args(op, route):
    """The kernel's wrapper and its row-index arguments, and the block
    walk's plain version with its layout arguments and keywords."""
    rows = (op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos)
    if route is None:
        return (bsr_colstream, rows, bsr_colstream_reference,
                (op.blocks, op.cs_meta, op.cs_gcols, op.cs_gcolptr,
                 op.cs_groupptr),
                dict(G=op.rows_per_step, block_shape=op.block_shape))
    return (functools.partial(bsr_csr, route=route), rows, bsr_csr_reference,
            (op.blocks, op.block_rowptr, op.block_cols),
            dict(block_shape=op.block_shape))


def _hub(n=700, degree=300, seed=4):
    """A kNN graph whose node 0 is joined to ``degree`` others: a row of
    more than 32 nonzeros, which the kernel's warp walks in chunks."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 8)).astype(np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=6, algorithm="auto")).tolil()
    nb = rng.choice(np.arange(1, n), degree, replace=False)
    W[0, nb] = 0.5
    W[nb, 0] = 0.5
    return graphs.laplacian(W.tocsr())


@pytest.fixture(scope="module")
def hub700():
    return _hub()


def _check_bsr_kernel(op, route, dtype, hop, C, device):
    """One launch of the row kernel against the row walk's and the block
    walk's plain versions on the same inputs; pad rows included."""
    g = torch.Generator(device=device).manual_seed(C)
    x, x0 = (torch.randn(op.m_padded, C, generator=g, device=device)
             for _ in range(2))
    if dtype == "int8":
        x, x0, scale = op.quantize(x), op.quantize(x0), op.block_scale
    else:
        x, x0, scale = x.to(op.compute_dtype), x0.to(op.compute_dtype), None
    kernel, rows, block_plain, lay, kw = _bsr_args(op, route)
    counted = bsr_colstream if route is None else bsr_csr
    xx0 = x0 if hop else None
    before = counted.launches
    got = kernel(*rows, x, xx0, block_scale=scale)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    for want in (bsr_rows_reference(*rows, x, xx0, block_scale=scale),
                 block_plain(*lay, x, xx0, block_scale=scale, **kw)):
        _assert_kernel_close(got, want)
    pad = got[op.m:].float()
    assert torch.equal(pad, torch.zeros_like(pad) if not hop
                       else (-x0[op.m:].float()).to(x.dtype).float())


@pytest.mark.parametrize("C", [20, 37, 512])
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_bsr_kernels_match_reference(city48, cuda_device, layout, dtype,
                                     hop, C):
    """Every route, dtype and form at C = 20 (the scalar form in bf16 and
    int8), 37 (scalar in every dtype) and 512 (one full pass of
    16-byte vectors)."""
    op, route = _bsr(city48, layout, dtype, cuda_device)
    _check_bsr_kernel(op, route, dtype, hop, C, cuda_device)


@pytest.mark.parametrize("C", [20, 512, 1040])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["colstream", "grouped"])
def test_bsr_kernel_long_rows(hub700, cuda_device, layout, dtype, C):
    """A row of 300 nonzeros (10 warp-wide chunks) and, at C = 1040, three
    passes of 512 columns with a masked tail; hop form."""
    op, route = _bsr(hub700, layout, dtype, cuda_device)
    assert int(op.nz_rowptr.diff().max()) > 32
    _check_bsr_kernel(op, route, dtype, True, C, cuda_device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["colstream", "grouped"])
def test_bsr_kernel_other_block_shape(city48, cuda_device, layout, dtype):
    """(8, 128) blocks: the row index reads them as it reads 128x128 ones
    (JAX's BSR kernels take other block shapes too)."""
    op, route = _bsr(city48, layout, dtype, cuda_device, block_size=(8, 128))
    assert op.block_shape == (8, 128)
    _check_bsr_kernel(op, route, dtype, True, 64, cuda_device)


@pytest.mark.parametrize("layout", ["colstream", "grouped", "csr",
                                    "chunked"])
def test_bsr_operator_routes_and_counts(city48, cuda_device, layout):
    """The operator's matmul and hop take the JAX package's route, one
    launch each, counted by form (and by route on bsr_csr)."""
    op, route = _bsr(city48, layout, "float32", cuda_device)
    x = torch.randn(op.m_padded, 40, device=cuda_device)
    kernel = bsr_colstream if route is None else bsr_csr
    forms = dict(kernel.form_launches)
    routes = dict(bsr_csr.route_launches)
    op.matmul(x)
    fused_hop = layout in ("colstream", "grouped")
    op.cheby_hop(x, x)  # fused where JAX fuses it, else L@x and an update
    torch.cuda.synchronize()
    assert kernel.form_launches["spmm"] == forms.get("spmm", 0) + (
        1 if fused_hop else 2)
    assert kernel.form_launches["hop"] == forms.get("hop", 0) + fused_hop
    if route is not None:
        assert bsr_csr.route_launches[route] == routes.get(route, 0) + 2


@pytest.mark.parametrize("layout", ["colstream", "grouped"])
def test_bsr_conv_gradients_through_kernel_match_plain_version(
        city48, cuda_device, layout):
    """cheby_conv on BSR: y, dx and dW on the card (every product a kernel
    launch) against the same operator on the CPU (plain version); f32,
    so only the summation order differs.  K=5: the forward runs 1 L@x
    and 3 hops, the backward 4 L@x."""
    op, route = _bsr(city48, layout, "float32", cuda_device)
    kernel = bsr_colstream if route is None else bsr_csr
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, op.m, 8)).astype(np.float32)
    w = (rng.normal(size=(5, 8, 3)) * 0.3).astype(np.float32)
    t = rng.normal(size=(2, op.m, 3)).astype(np.float32)
    out = []
    for o, dev in ((op, cuda_device), (op.to("cpu"), "cpu")):
        xt, wt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (x, w))
        before = dict(kernel.form_launches)
        y = cheby_conv(xt, o, wt)
        (y * torch.from_numpy(t).to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert kernel.form_launches["spmm"] == before.get("spmm", 0) + 5
            assert kernel.form_launches["hop"] == before.get("hop", 0) + 3
        out.append((y.detach().cpu(), xt.grad.cpu(), wt.grad.cpu()))
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("int8", [False, True])
def test_bsr_serving_through_kernel_matches_plain_version(city48,
                                                          cuda_device, int8):
    """Served logits on a column-streamed operator: through K4 on the
    card (4 launches for K=5), and on the CPU through the plain version."""
    op = device_laplacian(city48, fmt="bsr", dtype=torch.bfloat16,
                          device=cuda_device)
    model = NodeClassifier(op, 32, 8, hidden=[], K=5,
                           generator=torch.Generator().manual_seed(0))
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(size=(op.m, 32)).astype(np.float32))
    serving = compile_serving(model, model.param_tree(),
                              feats.to(cuda_device), int8=int8)
    before = bsr_colstream.launches
    got = serving(feats.to(cuda_device)).cpu()
    assert bsr_colstream.launches == before + 4
    want = compile_serving(serving.model, model.param_tree(), feats,
                           int8=False)(feats)
    assert got.shape == (op.m, 8) and torch.isfinite(got).all()
    tol = 1e-4 if int8 else 2**-6
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("int8", [False, True])
def test_bsr_host_built_operator_serves_through_kernel(city48, cuda_device,
                                                       int8):
    """An operator built on the host with the default use_pallas and
    moved to the card by compile_serving keeps the kernel route: 4 K4
    launches for K=5, no plain path on the card."""
    op = device_laplacian(city48, fmt="bsr", dtype=torch.bfloat16,
                          device="cpu")
    assert op.blocks.device.type == "cpu" and op.use_pallas
    assert op.col_stream
    model = NodeClassifier(op, 16, 4, hidden=[], K=5,
                           generator=torch.Generator().manual_seed(0))
    feats = torch.from_numpy(
        np.random.default_rng(1).normal(size=(op.m, 16)).astype(np.float32))
    serving = compile_serving(model, model.param_tree(),
                              feats.to(cuda_device), int8=int8)
    before = bsr_colstream.launches
    got = serving(feats.to(cuda_device))
    torch.cuda.synchronize()
    assert bsr_colstream.launches == before + 4
    assert got.shape == (op.m, 4) and torch.isfinite(got).all()


def test_bsr_kernels_reject_bad_arguments(city48, cuda_device):
    op, _ = _bsr(city48, "grouped", "float32", cuda_device)
    x = torch.zeros(op.m_padded, 16, device=cuda_device)
    rows = (op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos)
    with pytest.raises(TypeError):
        bsr_csr(*rows, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        bsr_csr(*rows, x[:, ::2])
    with pytest.raises(ValueError):
        bsr_csr(op.blocks, op.nz_rowptr.cpu(), op.nz_cols, op.nz_pos, x)
    flat = torch.zeros(op.m_padded * 16 + 3, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        bsr_spmm(op, flat[3:].view(op.m_padded, 16))
    with pytest.raises(ValueError, match="16-byte"):
        bsr_csr(*rows, x, flat[3:].view(op.m_padded, 16))
    with pytest.raises(TypeError, match="row index"):
        bsr_csr(op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos.int(), x)
    with pytest.raises(ValueError, match="rows"):
        bsr_csr(*rows, x[:-128].contiguous())


# ------------------------------ K5, K6, the in-place form, cheby_finals
# Tolerances as for K1: int8 bit-exact; f32 atol 1e-4 (sums in another
# order); bf16 one bf16 ulp of the plain version's single rounding.
_COUNTED = {"dkw": banded_dkw, "uniform": banded_uniform,
            "ragged": banded_ragged}


def _layout_operator(L, layout, dtype, device, G=2):
    """The operator whose products run ``layout``'s kernel: K1 on the dkw
    layout, K5 on the uniform band, K6 on a ragged band built without its
    dkw twin and then given ``use_pallas`` (as JAX reaches K6)."""
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    op = device_laplacian(L, fmt="banded", dtype=dt, rows_per_step=G,
                          device=device, ragged=layout != "uniform",
                          use_pallas=layout != "ragged")
    if dtype == "int8":
        op = quantize_banded(op, sample_x=3.0)
    return dataclasses.replace(op, use_pallas=True)


def _layout_inputs(op, C, device, seed, rows=None):
    g = torch.Generator(device=device).manual_seed(seed)
    x, x0, c = (torch.randn(rows or op.m_padded, C, generator=g,
                            device=device) for _ in range(3))
    x0, c = x0[: op.m_padded].contiguous(), c[: op.m_padded].contiguous()
    if op.compute_dtype == torch.int8:
        return op.quantize(x), op.quantize(x0), None, op.band_scale
    return (*(t.to(op.compute_dtype) for t in (x, x0, c)), None)


def _assert_kernel_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(
            got.float(), want.float(), atol=1e-4,
            rtol=2**-7 if got.dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("C", [48, 37, 300])
@pytest.mark.parametrize("dtype,form", [
    (d, f) for d in ("float32", "bfloat16", "int8")
    for f in ("spmm", "hop", "hop_c") if (d, f) != ("int8", "hop_c")])
@pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
def test_layout_kernels_match_reference(city96, cuda_device, layout, dtype,
                                        form, C):
    """Each layout's kernel against its window plain version and the row
    walk's plain version; C = 37 and (int8) 300 take the scalar loads."""
    op = _layout_operator(city96, layout, dtype, cuda_device)
    x, x0, c, scale = _layout_inputs(op, C, cuda_device, C)
    args = (x, None, None) if form == "spmm" else (
        x, x0, c if form == "hop_c" else None)
    kernel = _COUNTED[layout]
    before = kernel.form_launches[form]
    got = layout_call(op, *args, band_scale=scale)
    torch.cuda.synchronize()
    assert kernel.form_launches[form] == before + 1
    want = layout_call(dataclasses.replace(op, use_pallas=False), *args,
                       band_scale=scale)
    _assert_kernel_close(got, want)
    _assert_kernel_close(got, _rows_reference(op, layout, *args,
                                              scale=scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
def test_layout_kernels_take_extended_column_x(city96, cuda_device, layout,
                                               dtype):
    """x with 3 halo block rows in front and 2 behind, bases shifted by
    3 (the row index unchanged: it holds window offsets): the hop equals
    the unshifted plain version.  Then an x that ends inside the last
    windows: rows past its end read as zero."""
    op = _layout_operator(city96, layout, dtype, cuda_device)
    off, C = 3, 136
    x_ext, x0, _, scale = _layout_inputs(op, C, cuda_device, 5,
                                         rows=op.m_padded + 5 * 128)
    x = x_ext[off * 128: off * 128 + op.m_padded].contiguous()
    shifted = dataclasses.replace(op, base=op.base + off)
    got = layout_call(shifted, x_ext, x0, band_scale=scale)
    torch.cuda.synchronize()
    want = layout_call(dataclasses.replace(op, use_pallas=False), x, x0,
                       band_scale=scale)
    _assert_kernel_close(got, want)
    short = x_ext[: op.m_padded].contiguous()
    got = layout_call(shifted, short, x0, band_scale=scale)
    torch.cuda.synchronize()
    want = layout_call(dataclasses.replace(shifted, use_pallas=False),
                       short, x0, band_scale=scale)
    _assert_kernel_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
def test_inplace_form_is_bit_identical(city96, cuda_device, layout, dtype):
    """donate_x0: the output in x0's storage, equal bit for bit to the
    out-of-place launch, and rejected when x aliases x0."""
    op = _layout_operator(city96, layout, dtype, cuda_device)
    x, x0, _, scale = _layout_inputs(op, 264, cuda_device, 7)
    want = layout_call(op, x, x0, band_scale=scale)
    ptr = x0.data_ptr()
    got = layout_call(op, x, x0, band_scale=scale, donate=True)
    torch.cuda.synchronize()
    assert got is x0 and got.data_ptr() == ptr
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="alias"):
        layout_call(op, x0, x0, band_scale=scale, donate=True)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
def test_cheby_finals_through_kernel(city96, cuda_device, layout, dtype):
    """The chain on the card (K-1 launches, all hops but the first in
    place) against the same chain through the plain versions."""
    K = 7
    op = _layout_operator(city96, layout, dtype, cuda_device)
    x, _, _, _ = _layout_inputs(op, 96, cuda_device, 9)
    kernel = _COUNTED[layout]
    before = kernel.launches
    got = cheby_finals(op, x, K)
    torch.cuda.synchronize()
    assert kernel.launches == before + K - 1
    want = cheby_finals(dataclasses.replace(op, use_pallas=False), x, K)
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("layout", ["uniform", "ragged"])
@pytest.mark.parametrize("int8", [False, True])
def test_layout_serving_through_kernel_matches_plain_version(
        city96, cuda_device, layout, int8):
    """Served logits through K5 or K6 (4 launches for K=5) against the
    same operator's plain version on the CPU.  The int8 operator is
    quantized before it gets ``use_pallas``, so that the ragged one
    keeps K6 (quantizing a ragged ``use_pallas`` operator adds the dkw
    twin, as in JAX)."""
    op = _layout_operator(city96, layout, "int8" if int8 else "bfloat16",
                          cuda_device)
    model = NodeClassifier(op, 32, 8, hidden=[], K=5,
                           generator=torch.Generator().manual_seed(0))
    feats = torch.from_numpy(
        np.random.default_rng(0).normal(size=(op.m, 32)).astype(np.float32))
    serving = compile_serving(model, model.param_tree(),
                              feats.to(cuda_device), int8=False)
    kernel = _COUNTED[layout]
    before = kernel.launches
    got = serving(feats.to(cuda_device)).cpu()
    assert kernel.launches == before + 4
    want = compile_serving(serving.model, model.param_tree(), feats,
                           int8=False)(feats)
    tol = 1e-4 if int8 else 2**-6
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("K", [2, 7])
def test_uniform_conv_gradients_through_kernel(city96, cuda_device, K):
    """cheby_conv_banded's dx and dW through K5 on the card against the
    plain version on the CPU, f32."""
    op = _layout_operator(city96, "uniform", "float32", cuda_device)
    rng = np.random.default_rng(K)
    x = rng.normal(size=(2, op.m, 8)).astype(np.float32)
    w = (rng.normal(size=(K, 8, 3)) * 0.3).astype(np.float32)
    t = rng.normal(size=(2, op.m, 3)).astype(np.float32)
    grads = []
    for o, dev in ((op, cuda_device), (op.to("cpu"), "cpu")):
        xt, wt = (torch.from_numpy(a).to(dev).requires_grad_() for a in (x, w))
        before = banded_uniform.launches
        y = cheby_conv_banded(xt, o, wt)
        (y * torch.from_numpy(t).to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert banded_uniform.launches == before + 2 * (K - 1)
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-4)


def test_host_built_banded_operator_takes_the_kernels(city96, cuda_device):
    """use_pallas=None on a machine with a card: the host-built ragged
    operator gets its dkw layout and, moved to the card, runs K1."""
    op = device_laplacian(city96, fmt="banded", device="cpu")
    assert op.use_pallas and op.bands_dkw is not None
    op = op.to(cuda_device)
    before = banded_dkw.launches
    op.matmul(torch.zeros(op.m_padded, 16, device=cuda_device))
    torch.cuda.synchronize()
    assert banded_dkw.launches == before + 1


def test_slope_time_on_the_card(cuda_device):
    a = torch.randn(1024, 1024, device=cuda_device)

    def make(u):
        def chain(m):
            for _ in range(u):
                m = torch.tanh(m @ a)
            return m
        return chain

    per, fixed = slope_time(make, (a,), units=(2, 6))
    assert per > 0 and np.isfinite(fixed)


# ------------------------------------------- the probes (P1-P3) and the
# dense int8 twin


@pytest.mark.parametrize("name", list(probes.MXU_SHAPES))
def test_mxu_probe_matches_reference(cuda_device, name):
    """P1 at every geometry of main_mxu, two replicas, after 1 and 3
    iterations (``probes.compare``: int8 bit-identical, bf16 one ulp
    then 2e-2 of the max), bf16 on the check operands, where the carry
    counts."""
    m, k, n, taps, _ = probes.MXU_SHAPES[name]
    a, b = probes.mxu_operands(name, cuda_device, check=True)
    for iters in (1, 3):
        before = probes.mxu_probe.launches
        got = probes.mxu_probe(a, b, iters, taps, replicas=2)
        torch.cuda.synchronize()
        assert probes.mxu_probe.launches == before + 1
        want = probes.mxu_reference(a, b, iters, taps, replicas=2)
        for g, w in zip(got, want):
            probes.compare(g, w, iters)
        if m == 128:
            assert not bool(got[1].any())


@pytest.mark.parametrize("variant", list(probes.PRED_VARIANTS))
def test_pred_probe_matches_reference(cuda_device, variant):
    widths, cond = probes.PRED_VARIANTS[variant]
    a, b = probes.pred_operands(cuda_device, check=True)
    w = torch.tensor(widths, dtype=torch.int32, device=cuda_device)
    for iters in (1, 3, 11):
        got = probes.pred_probe(w, a, b, iters, cond, replicas=2)
        probes.compare(got, probes.pred_reference(widths, a, b, iters, cond,
                                                  replicas=2), iters)


@pytest.mark.parametrize("unroll", probes.LOOPCOST_UNROLLS)
def test_loopcost_probe_matches_reference(cuda_device, unroll):
    """P3 with 64 dots per call, chained over 1 and 3 calls."""
    seed, a, b = probes.loopcost_operands(cuda_device, replicas=2)
    seed = torch.randn(seed.shape, device=cuda_device).to(torch.bfloat16)
    got = want = seed
    for calls in (1, 2):
        for _ in range(calls):
            got = probes.loopcost_probe(got, a, b, 64, unroll)
            want = probes.loopcost_reference(want, a, b, 64, unroll)
        probes.compare(got, want, 1 if calls == 1 else 3)


def test_probes_reject_bad_arguments(cuda_device):
    a, b = probes.mxu_operands("tap9_bf16", cuda_device)
    with pytest.raises(ValueError):
        probes.mxu_probe(a, b, 1, 3)
    with pytest.raises(TypeError):
        probes.mxu_probe(a, b.to(torch.int8), 1, 9)
    pa, pb = probes.pred_operands(cuda_device)
    with pytest.raises(ValueError, match="widths"):
        probes.pred_probe(torch.tensor([9], device=cuda_device), pa, pb, 1)
    seed, la, lb = probes.loopcost_operands(cuda_device)
    with pytest.raises(ValueError):
        probes.loopcost_probe(seed, la, lb, 20, 8)


def test_dense_int8_twin_bit_identical_on_card_and_cpu(knn203, cuda_device):
    """``QuantDenseLaplacian``: spmm_q, cheby_hop_q and a cheby_finals
    chain on the card equal the same calls on the CPU bit for bit (exact
    float64 accumulation, one f32 emission)."""
    op = device_laplacian(knn203, fmt="dense", device="cpu")
    q = quantize_dense(op, sample_x=3.0)
    qc = q.to(cuda_device)
    g = torch.Generator().manual_seed(3)
    x, x0 = (q.quantize(torch.randn(q.m_padded, 37, generator=g) * 2)
             for _ in range(2))
    xc, x0c = x.to(cuda_device), x0.to(cuda_device)
    assert torch.equal(qc.spmm_q(xc).cpu(), q.spmm_q(x))
    assert torch.equal(qc.cheby_hop_q(xc, x0c).cpu(), q.cheby_hop_q(x, x0))
    assert torch.equal(cheby_finals(qc, xc, 9).cpu(), cheby_finals(q, x, 9))
