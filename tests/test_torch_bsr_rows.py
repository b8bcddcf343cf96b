"""The BSR operators' row index and the row kernel's plain version.

The CUDA kernel of ``csrc/bsr.cu`` walks each BSR operator's nonzero
index by output row (``nz_rowptr``, ``nz_cols``, ``nz_pos``) and reads
the values from the operator's ``blocks``.  On the CPU: the index
reproduces the rescaled Laplacian exactly in every layout; the kernel's
plain version ``bsr_rows_reference`` agrees with the block walks' plain
versions and with the JAX package's Pallas kernels in interpret mode
(K4 ``_colstream_call``, K7 ``_grouped_call`` and ``bsr_call_quant``,
K8/K9 ``_bsr_spmm_impl``); pad rows, rows of more than 32 nonzeros,
operators whose blocks were cast, quantized or moved; and the sparse
roofline's counts.  The kernel itself is held against both plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: f32 ``atol=1e-4`` (the JAX tests' bound; sums in another
order); int8 bit-exact (exact accumulation, one f32 emission with the
same operations); bf16 one bf16 ulp (both round one f32 sum of exact
products).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import quantize_block_sparse as jax_quantize_bsr
from cnn_graph_tpu.ops.pallas_spmm import (
    _bsr_spmm_impl,
    _colstream_call,
    _grouped_call,
    bsr_call_quant,
)
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.ops import (
    bsr_colstream,
    bsr_colstream_reference,
    bsr_csr,
    bsr_csr_reference,
    bsr_rows_reference,
    device_laplacian,
    quantize_block_sparse,
)
from cnn_graph_tpu_torch.ops.laplacian import ROW_INDEX_FIELDS
from cnn_graph_tpu_torch.utils import sparse_roofline, spmm_roofline
from cnn_graph_tpu_torch.utils.profiling import (
    H100_BYTES_PER_S,
    H100_OPS_PER_S,
)


def _scattered(n, seed=0):
    """The bench's scattered recipe at n nodes (bench.py:776-782)."""
    z = np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=10, algorithm="auto"))
    perm = graphs.bandwidth_reducing_permutation(W)
    return graphs.laplacian(W[perm][:, perm].tocsr())


def _hub(n=700, degree=300, seed=4):
    """A kNN graph whose node 0 is joined to ``degree`` others: its row
    holds more than 32 nonzeros, so the kernel loops over the row."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 8)).astype(np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=6, algorithm="auto")).tolil()
    nb = rng.choice(np.arange(1, n), degree, replace=False)
    W[0, nb] = 0.5
    W[nb, 0] = 0.5
    return graphs.laplacian(W.tocsr())


@pytest.fixture(scope="module")
def g900():
    return _scattered(900)


@pytest.fixture(scope="module")
def city48():
    return graphs.city_graph(48, k=8, seed=0)[0]


@pytest.fixture(scope="module", params=["g900", "city48"])
def graph(request):
    return request.getfixturevalue(request.param)


_LAYOUTS = {  # layout -> (device_laplacian arguments, route)
    "colstream": (dict(), "K4"),
    "grouped": (dict(col_stream=False), "K7"),
    "per_block": (dict(col_stream=False), "K8"),
    "chunked": (dict(chunked_rows=True), "K9"),
    "colstream_8x128": (dict(block_size=(8, 128)), "K4"),
    "grouped_8x128": (dict(col_stream=False, block_size=(8, 128)), "K7"),
}


def _op(L, layout, **kw):
    kw = {"fmt": "bsr", "block_size": 128, "use_pallas": True,
          **_LAYOUTS[layout][0], **kw}
    op = device_laplacian(L, **kw, device="cpu")
    if layout == "per_block":  # K8: the one-row-per-step route
        op = dataclasses.replace(op, rows_per_step=1)
    return op


def _index(op):
    return (op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos)


def _block_ref(op, x, x0=None, scale=None):
    """The block walk's plain version of the operator's layout."""
    if op.col_stream:
        return bsr_colstream_reference(
            op.blocks, op.cs_meta, op.cs_gcols, op.cs_gcolptr,
            op.cs_groupptr, x, x0, G=op.rows_per_step,
            block_shape=op.block_shape, block_scale=scale)
    return bsr_csr_reference(op.blocks, op.block_rowptr, op.block_cols, x,
                             x0, block_shape=op.block_shape,
                             block_scale=scale)


def _inputs(mp, C, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(mp, C)) * scale).astype(np.float32)
            for _ in range(2)]


# --------------------------------------------------------------- the index


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_row_index_is_the_laplacian(graph, layout):
    """Values read through ``nz_pos``, at ``nz_cols`` by ``nz_rowptr``,
    are the rescaled Laplacian in f32, entry for entry, padded with
    empty rows; columns sorted within each row."""
    op = _op(graph, layout)
    mp = op.m_padded
    assert op.nz_rowptr.dtype == torch.int32 and op.nz_cols.dtype == \
        torch.int32 and op.nz_pos.dtype == torch.int64
    assert op.nz_rowptr.shape == (mp + 1,)
    rowptr, cols = op.nz_rowptr.numpy(), op.nz_cols.numpy()
    vals = op.blocks.reshape(-1)[op.nz_pos].numpy()
    got = scipy.sparse.csr_matrix((vals, cols, rowptr), shape=(mp, mp))
    assert got.has_sorted_indices
    want = graphs.rescale_laplacian(graph).tocsr()
    want.eliminate_zeros()
    want.sort_indices()
    want = scipy.sparse.csr_matrix(
        (want.data.astype(np.float32), want.indices, np.concatenate(
            [want.indptr, np.full(mp - op.m, want.indptr[-1])])),
        shape=(mp, mp))
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)
    assert int(rowptr[-1]) == op.nnz


# ------------------------------------------ plain version vs the Pallas
# kernels in interpret mode and the block walks' plain versions


def _jax_op(L, layout):
    kw = {"fmt": "bsr", "block_size": 128, "use_pallas": True,
          **_LAYOUTS[layout][0]}
    op_j = jax_device_laplacian(L, **kw)
    if layout == "per_block":
        op_j = dataclasses.replace(op_j, rows_per_step=1)
    return op_j


@pytest.mark.parametrize("C", [20, 64])
@pytest.mark.parametrize("route,hop", [
    ("K4", False), ("K4", True), ("K7", False), ("K7", True),
    ("K8", False), ("K9", False)])
def test_rows_reference_matches_pallas_f32(g900, route, hop, C):
    layout = {"K4": "colstream", "K7": "grouped", "K8": "per_block",
              "K9": "chunked"}[route]
    op, op_j = _op(g900, layout), _jax_op(g900, layout)
    x, x0 = _inputs(op.m_padded, C, 1)
    x0 = x0 if hop else None
    jx, jx0 = jnp.asarray(x), None if x0 is None else jnp.asarray(x0)
    if route == "K4":
        want = _colstream_call(op_j, jx, jx0, interpret=True)
    elif route == "K7":
        want = _grouped_call(op_j, jx, jx0, interpret=True)
    else:
        want = _bsr_spmm_impl(op_j, jx, interpret=True)
    tx, tx0 = torch.from_numpy(x), None if x0 is None else torch.from_numpy(
        x0)
    got = bsr_rows_reference(*_index(op), tx, tx0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _block_ref(op, tx, tx0).numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("C", [20, 64])
@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("route", ["K4", "K7"])
def test_rows_reference_int8_bit_exact(g900, route, hop, C):
    """int8 against ``bsr_call_quant`` (K4 or K7 in interpret mode) and
    the block walk's plain version, bit for bit."""
    layout = "colstream" if route == "K4" else "grouped"
    q = quantize_block_sparse(_op(g900, layout), sample_x=3.0)
    q_j = jax_quantize_bsr(_jax_op(g900, layout), sample_x=3.0)
    xq, x0q = (np.array(q_j.quantize(jnp.asarray(v)))
               for v in _inputs(q.m_padded, C, 2, scale=1.5))
    x0q = x0q if hop else None
    want = np.asarray(bsr_call_quant(
        q_j, jnp.asarray(xq), None if x0q is None else jnp.asarray(x0q),
        interpret=True))
    tx, tx0 = torch.from_numpy(xq), None if x0q is None else \
        torch.from_numpy(x0q)
    got = bsr_rows_reference(*_index(q), tx, tx0, block_scale=q.block_scale)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, _block_ref(q, tx, tx0, q.block_scale))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pad_rows(city48, dtype):
    """The pad rows past m hold no nonzeros: 0 for L@x, -x0 (clipped in
    int8) for the hop, through the wrappers as the operator calls them."""
    op = _op(city48, "colstream")
    assert op.m_padded > op.m
    x, x0 = (torch.from_numpy(v) for v in _inputs(op.m_padded, 24, 3,
                                                  scale=2.0))
    scale = None
    if dtype == "int8":
        op = quantize_block_sparse(op, sample_x=6.0)
        x, x0, scale = op.quantize(x), op.quantize(x0), op.block_scale
    y = bsr_colstream(*_index(op), x, block_scale=scale)
    h = bsr_colstream(*_index(op), x, x0, block_scale=scale)
    assert not bool(y[op.m:].any())
    assert torch.equal(h[op.m:], (-x0[op.m:].float()).to(x.dtype))
    assert bool(y[: op.m].any())


# --------------------------------------------------------- no stale values


@pytest.mark.parametrize("change", ["bf16", "quantize", "to"])
def test_index_follows_the_blocks(g900, change):
    """The index holds positions, not values: after the blocks are cast
    (``dataclasses.replace``), quantized or the operator moved, the row
    walk reads the new blocks and agrees with the block walk."""
    op = _op(g900, "colstream")
    x, x0 = (torch.from_numpy(v) for v in _inputs(op.m_padded, 40, 5))
    if change == "bf16":
        new = dataclasses.replace(op, blocks=op.blocks.to(torch.bfloat16))
        xb, x0b = x.to(torch.bfloat16), x0.to(torch.bfloat16)
        got = bsr_colstream(*_index(new), xb, x0b)
        want = _block_ref(new, xb, x0b)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=2**-7)
        # and not the f32 blocks' values, rounded after the sum
        assert not torch.equal(got, bsr_colstream(
            *_index(op), xb.float(), x0b.float()).to(torch.bfloat16))
    elif change == "quantize":
        q = quantize_block_sparse(op, sample_x=3.0)
        assert all(getattr(q, f) is getattr(op, f) for f in ROW_INDEX_FIELDS)
        xq, x0q = q.quantize(x), q.quantize(x0)
        assert torch.equal(q.cheby_hop_q(xq, x0q),
                           _block_ref(q, xq, x0q, q.block_scale))
        assert torch.equal(q.spmm_q(xq), _block_ref(q, xq, None,
                                                    q.block_scale))
    else:
        moved = op.to("meta")
        for f in ROW_INDEX_FIELDS:
            assert getattr(moved, f).device.type == "meta"
            assert getattr(moved, f).shape == getattr(op, f).shape
        back = op.to("cpu")
        assert torch.equal(back.matmul(x), op.matmul(x))
        torch.testing.assert_close(back.matmul(x), _block_ref(op, x),
                                   atol=1e-4, rtol=0)


def test_operator_without_index_raises(g900):
    op = dataclasses.replace(_op(g900, "colstream"), nz_rowptr=None)
    with pytest.raises(ValueError, match="row index"):
        op.matmul(torch.zeros(op.m_padded, 4))


# ----------------------------------------------------------- long rows


@pytest.mark.parametrize("route", ["K4", "K7"])
def test_rows_longer_than_a_warp(route):
    """A row of 300 nonzeros: the row walk and the block walk give
    scipy's product, L@x and the hop, f32 and int8."""
    L = _hub()
    op = _op(L, "colstream" if route == "K4" else "grouped")
    assert int(op.nz_rowptr.diff().max()) > 64
    x, x0 = _inputs(op.m_padded, 33, 6)
    want = graphs.rescale_laplacian(L).astype(np.float64) @ x[: op.m]
    tx, tx0 = torch.from_numpy(x), torch.from_numpy(x0)
    kernel = bsr_colstream if route == "K4" else bsr_csr
    got = kernel(*_index(op), tx)
    np.testing.assert_allclose(got[: op.m].numpy(), want, atol=1e-4)
    hop = kernel(*_index(op), tx, tx0)
    np.testing.assert_allclose(hop.numpy(),
                               (_block_ref(op, tx, tx0)).numpy(), atol=1e-4)
    q = quantize_block_sparse(op, sample_x=3.0)
    xq, x0q = q.quantize(tx), q.quantize(tx0)
    assert torch.equal(kernel(*_index(q), xq, x0q, block_scale=q.block_scale),
                       _block_ref(q, xq, x0q, q.block_scale))


# ------------------------------------------------------- sparse roofline


def test_sparse_roofline_counts_what_the_nonzeros_need():
    """A path of 4 nodes: the rescaled normalized Laplacian (lmax 2) has
    a zero diagonal, so 6 nonzeros; one 128-row padded block.  At C = 10,
    f32: 6 x (4 + 4) value and column bytes + 129 x 4 row-pointer bytes
    + 2 x 128 x 10 x 4 of x and y = 10,804 bytes, 2 x 6 x 10 = 120
    operations; the hop reads x0 too (+5,120); bf16 6 x 6 + 516 + 5,120
    = 5,672; int8 6 x 5 + 516 + 2,560 = 3,106.  The block count is the
    products of every stored 128x128 block, pads included."""
    W = scipy.sparse.diags([np.ones(3), np.ones(3)], [-1, 1], format="csr")
    op = device_laplacian(graphs.laplacian(W), fmt="bsr", block_size=128,
                          use_pallas=True, device="cpu")
    assert (op.nnz, op.m_padded) == (6, 128)
    r = sparse_roofline(op, 1e-6, 10)
    assert (r["bytes"], r["flops"], r["bound_by"]) == (10804, 120, "bytes")
    assert r["bound_us"] == pytest.approx(10804 / H100_BYTES_PER_S * 1e6)
    assert r["t_ops_us"] == pytest.approx(
        120 / H100_OPS_PER_S[torch.float32] * 1e6)
    assert r["achieved_frac_of_bound"] == pytest.approx(
        10804 / H100_BYTES_PER_S / 1e-6)
    assert sparse_roofline(op, None, 10, extra_inputs=1)["bytes"] == 15924
    bf = dataclasses.replace(op, blocks=op.blocks.to(torch.bfloat16))
    assert sparse_roofline(bf, None, 10)["bytes"] == 5672
    assert sparse_roofline(quantize_block_sparse(op), None,
                           10)["bytes"] == 3106
    # The column-streamed layout pads its one block to a bundle of 8.
    assert op.block_cols.numel() == 8
    assert spmm_roofline(op, None, 10)["flops"] == 8 * 2 * 128 * 128 * 10
