"""The banded operators' row index and the row walk's plain version.

K1 (dkw layout), K5 (uniform band) and K6 (flat ragged band) of
``csrc/band.cu`` walk the banded operator's nonzero index by output row
(``nz_rowptr``, ``nz_win``: each nonzero's offset in its block-row's
window) and read every value from the layout's own band.  On the CPU:
the index against a loop over the rescaled Laplacian's nonzeros and its
refusals; the row walk's plain version ``banded_rows_reference`` against
the layouts' window plain versions and against the JAX package's Pallas
kernels (``banded_call_dkw``, ``banded_call``, ``banded_call_ragged``)
in interpret mode, for L@x, the
hop and the adjoint hop in f32, bf16 and int8; the index after
``quantize_banded`` and ``.to()``, with bases shifted for an
extended-column x, and the operator's check of it.  The kernel itself is
held against both plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.

Tolerances: f32 ``atol=1e-4`` (the JAX tests' bound; sums in another
order); int8 bit-exact (exact accumulation, one f32 emission with the
same operations); bf16 one bf16 ulp (``rtol=2**-7``: both round one f32
sum of exact bf16 products).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import quantize_banded as jax_quantize_banded
from cnn_graph_tpu.ops.pallas_band import (
    banded_call,
    banded_call_dkw,
    banded_call_ragged,
)
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.ops import (
    banded_ragged_reference,
    banded_rows_reference,
    device_laplacian,
    packing,
    quantize_banded,
)
from cnn_graph_tpu_torch.ops.band import layout_call
from cnn_graph_tpu_torch.ops.laplacian import BAND_INDEX_FIELDS
from cnn_graph_tpu_torch.utils.profiling import sparse_roofline

G = 2
C = 48
LAYOUTS = ("dkw", "uniform")
DTYPES = ("float32", "bfloat16", "int8")
FORMS = {"spmm": 1, "hop": 2, "hop_c": 3}  # form -> inputs x[, x0[, c]]
CASES = [(d, f) for d in DTYPES for f in FORMS if (d, f) != ("int8", "hop_c")]


@pytest.fixture(scope="module")
def city():
    """4,356 nodes, 4,608 padded (two pad block rows), width levels
    (3, 4, 5) ragged and W = 5 uniform at G = 2."""
    return graphs.city_graph(66, k=8, seed=0)[0]


def _port_op(L, layout, dtype):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    op = device_laplacian(L, fmt="banded", ragged=layout == "dkw",
                          use_pallas=True, rows_per_step=G, dtype=dt,
                          device="cpu")
    return quantize_banded(op, sample_x=3.0) if dtype == "int8" else op


def _jax_op(L, layout, dtype):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    op = jax_device_laplacian(L, fmt="banded", ragged=layout == "dkw",
                              use_pallas=layout == "dkw", rows_per_step=G,
                              dtype=dt)
    op = dataclasses.replace(op, use_pallas=True)
    return jax_quantize_banded(op, sample_x=3.0) if dtype == "int8" else op


@pytest.fixture(scope="module")
def ops(city):
    return {(lay, dt): _port_op(city, lay, dt)
            for lay in LAYOUTS for dt in DTYPES}


@pytest.fixture(scope="module")
def rag_ops(city):
    """The flat ragged operators (no dkw layout) of both packages by
    dtype, given ``use_pallas`` after the build (and after quantizing)
    as JAX's tests reach K6."""
    out = {}
    for dtype in DTYPES:
        f = "float32" if dtype == "int8" else dtype
        op = device_laplacian(city, fmt="banded", use_pallas=False,
                              rows_per_step=G, device="cpu",
                              dtype=getattr(torch, f))
        op_j = jax_device_laplacian(city, fmt="banded", use_pallas=False,
                                    rows_per_step=G, dtype=getattr(jnp, f))
        if dtype == "int8":  # before use_pallas, which adds the dkw twin
            op = quantize_banded(op, sample_x=3.0)
            op_j = jax_quantize_banded(op_j, sample_x=3.0)
        op = dataclasses.replace(op, use_pallas=True)
        op_j = dataclasses.replace(op_j, use_pallas=True)
        assert op.levels and op.bands_dkw is None
        out[dtype] = (op, op_j)
    return out


def _operands(op):
    """``(bands, sched, levels)`` as ``banded_rows_reference`` takes
    them for the operator's layout."""
    if op.bands_dkw is not None:
        return op.bands_dkw, op.sched_dkw, op.levels
    return (op.band,), None, (op.band.shape[1],)


def _layout(op):
    return "dkw" if op.bands_dkw is not None else "uniform"


def _rows(op, x, x0=None, c=None, base=None):
    bands, sched, levels = _operands(op)
    return banded_rows_reference(
        bands, op.base if base is None else base, sched, op.nz_rowptr,
        op.nz_win, x, x0, c, layout=_layout(op), levels=levels,
        G=op.rows_per_step,
        band_scale=op.band_scale if op.compute_dtype == torch.int8 else None)


def _inputs(op, rows, seed, n):
    """``n`` seeded float matrices, in the operator's dtype (int8:
    quantized by the operator's activation scale)."""
    rng = np.random.default_rng(seed)
    out = [torch.from_numpy((rng.normal(size=(rows, C)) * 1.5)
                            .astype(np.float32)) for _ in range(n)]
    if op.compute_dtype == torch.int8:
        return [op.quantize(t) for t in out]
    return [t.to(op.compute_dtype) for t in out]


def _close(got, want, dtype):
    """``got`` (torch) against ``want`` (torch or NumPy) within the
    dtype's tolerance."""
    if isinstance(want, torch.Tensor):
        want = want.float().numpy() if dtype != "int8" else want.numpy()
    if dtype == "int8":
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
        return
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-4,
                               rtol=2**-7 if dtype == "bfloat16" else 0)


class TestIndex:
    def test_matches_a_loop_over_the_nonzeros(self, city, ops):
        op = ops[("dkw", "float32")]
        A = graphs.rescale_laplacian(city).tocsr()
        A.eliminate_zeros()
        A.sort_indices()
        base = op.base.numpy()
        rowptr, win = [0], []
        for row in range(op.m_padded):
            if row < A.shape[0]:
                for col in A.indices[A.indptr[row]:A.indptr[row + 1]]:
                    win.append(col - 128 * base[row // 128])
            rowptr.append(len(win))
        assert op.nz_rowptr.dtype == torch.int32
        assert op.nz_win.dtype == torch.int16
        np.testing.assert_array_equal(op.nz_rowptr.numpy(), rowptr)
        np.testing.assert_array_equal(op.nz_win.numpy(), win)
        assert int(op.nz_rowptr[-1]) == op.nnz

    def test_one_index_for_every_layout(self, city, ops):
        """The ragged, dkw and uniform operators of one graph share the
        bases, so one index: the operators' are equal.  The ragged
        operator given ``use_pallas`` quantizes to the dkw layout (as in
        JAX), whose kernel K1 walks that index."""
        rag = device_laplacian(city, fmt="banded", use_pallas=False,
                               rows_per_step=G, device="cpu")
        for lay in LAYOUTS:
            for f in BAND_INDEX_FIELDS:
                assert torch.equal(getattr(ops[(lay, "float32")], f),
                                   getattr(rag, f))
        q = quantize_banded(dataclasses.replace(rag, use_pallas=True),
                            sample_x=3.0)
        assert _layout(q) == "dkw"
        (x,) = _inputs(q, q.m_padded, 6, 1)
        _close(_rows(q, x), layout_call(q, x, band_scale=q.band_scale),
               "int8")

    def test_raises_past_int16(self):
        n = 8000
        A = scipy.sparse.eye(n, format="lil")
        A[0, 7000] = A[7000, 0] = 0.5
        A = A.tocsr()
        base = np.zeros(-(-n // 128), np.int32)
        with pytest.raises(ValueError, match="int16"):
            packing.band_row_index(A, base, len(base) * 128)

    def test_raises_before_the_window(self, city):
        A = graphs.rescale_laplacian(city).tocsr()
        base, _, _, mp = packing.band_stats(A)
        base = base.copy()
        base[5] += 1
        with pytest.raises(ValueError, match="before"):
            packing.band_row_index(A, base, mp)

    def test_survives_quantize_and_to(self, ops):
        for lay in LAYOUTS:
            op = ops[(lay, "float32")]
            q = ops[(lay, "int8")]
            for moved in (q, q.to("cpu"), op.to("cpu")):
                for f in BAND_INDEX_FIELDS:
                    assert torch.equal(getattr(moved, f), getattr(op, f))
            meta = op.to("meta")
            assert all(getattr(meta, f).device.type == "meta"
                       for f in BAND_INDEX_FIELDS)

    @pytest.mark.parametrize("bad", ["offset", "rowptr", "length", "dtype"])
    def test_operator_checks_the_index(self, ops, bad):
        """The kernel takes the index on trust: an offset past its row's
        band width, a falling or short row pointer, or another dtype is
        refused where the operator is built."""
        op = ops[("dkw", "float32")]
        rowptr, win = op.nz_rowptr.clone(), op.nz_win.clone()
        err = ValueError
        if bad == "offset":
            win[int(rowptr[5])] = op.levels[-1] * 128
        elif bad == "rowptr":
            rowptr[10] = rowptr[12]
        elif bad == "length":
            win = win[:-1]
        else:
            win, err = win.to(torch.int32), TypeError
        with pytest.raises(err):
            dataclasses.replace(op, nz_rowptr=rowptr, nz_win=win)


class TestRowsReference:
    @pytest.mark.parametrize("dtype,form", CASES)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_matches_window_version(self, ops, layout, dtype, form):
        """The row walk against the layout's window product (the CPU
        path of ``layout_call``), pad rows included."""
        op = ops[(layout, dtype)]
        args = _inputs(op, op.m_padded, 1, FORMS[form])
        got = _rows(op, *args)
        want = layout_call(op, *args, band_scale=getattr(op, "band_scale",
                                                          None))
        assert got.dtype == want.dtype and got.shape == want.shape
        _close(got, want, dtype)

    @pytest.mark.parametrize("dtype,form", CASES)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_matches_pallas(self, city, ops, layout, dtype, form):
        """The row walk against the TPU kernel in interpret mode on the
        same inputs: ``banded_call_dkw`` (K1) or ``banded_call`` (K5)."""
        op, op_j = ops[(layout, dtype)], _jax_op(city, layout, dtype)
        args = _inputs(op, op.m_padded, 2, FORMS[form])
        got = _rows(op, *args)
        if dtype == "bfloat16":
            arrs = [jnp.asarray(a.float().numpy(), jnp.bfloat16)
                    for a in args]
        else:
            arrs = [jnp.asarray(a.numpy()) for a in args]
        arrs += [None] * (3 - len(arrs))
        kw = dict(ring=op_j.ring_slots, G=op_j.rows_per_step,
                  out_rows=op_j.m_padded, interpret=True,
                  band_scale=op_j.band_scale if dtype == "int8" else None)
        if layout == "dkw":
            want = banded_call_dkw(op_j.bands_dkw, op_j.base, op_j.sched_dkw,
                                   *arrs, levels=op_j.levels, **kw)
        else:
            want = banded_call(op_j.band, op_j.base, *arrs, **kw)
        if dtype == "bfloat16":
            want = np.asarray(want.astype(jnp.float32))
        _close(got, want, dtype)

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_extended_column_x(self, ops, layout, dtype):
        """x with 3 halo block rows in front and 2 behind, every base
        shifted by 3, the same index: the hop equals the unshifted
        one's, and x rows past the end add nothing."""
        op = ops[(layout, dtype)]
        off = 3
        x_ext, x0 = _inputs(op, op.m_padded + 5 * 128, 3, 2)
        x0 = x0[: op.m_padded].contiguous()
        x = x_ext[off * 128: off * 128 + op.m_padded]
        got = _rows(op, x_ext, x0, base=op.base + off)
        want = layout_call(op, x, x0,
                           band_scale=getattr(op, "band_scale", None))
        _close(got, want, dtype)
        # Bases shifted past the end of a short x: the windows read zeros.
        short = x_ext[: op.m_padded]
        got = _rows(op, short, x0, base=op.base + off)
        want = banded_rows_reference(
            *_operands(op)[:1], op.base + off, _operands(op)[1],
            op.nz_rowptr, op.nz_win,
            torch.cat([short, torch.zeros_like(x_ext[:5 * 128])]), x0,
            layout=_layout(op), levels=_operands(op)[2], G=G,
            band_scale=getattr(op, "band_scale", None))
        assert torch.equal(got, want)

    @pytest.mark.parametrize("shift", [0, 3])
    @pytest.mark.parametrize("dtype,form", CASES)
    def test_ragged_layout(self, city, rag_ops, dtype, form, shift):
        """The walk on the flat ragged band (K6) against the ragged
        window product ``banded_ragged_reference`` and against the TPU
        kernel ``banded_call_ragged`` in interpret mode, on the same
        inputs: x with 5 extra block rows, every base shifted by
        ``shift``, the same index."""
        op, op_j = rag_ops[dtype]
        scale = op.band_scale if dtype == "int8" else None
        (x,) = _inputs(op, op.m_padded + 5 * 128, 7, 1)
        rest = _inputs(op, op.m_padded, 8, FORMS[form] - 1)
        base = op.base + shift
        got = banded_rows_reference(
            (op.band,), base, op.sched, op.nz_rowptr, op.nz_win, x, *rest,
            layout="ragged", levels=op.levels, G=G, band_scale=scale)
        _close(got, banded_ragged_reference(
            op.band, base, op.sched, x, *rest, levels=op.levels, G=G,
            band_scale=scale), dtype)
        args = [x, *rest]
        if dtype == "bfloat16":
            arrs = [jnp.asarray(a.float().numpy(), jnp.bfloat16)
                    for a in args]
        else:
            arrs = [jnp.asarray(a.numpy()) for a in args]
        arrs += [None] * (3 - len(arrs))
        # The TPU kernel's x ring follows the schedule's column high-water
        # (row 2), which moves with the bases; the walk does not read it.
        sched = np.asarray(op_j.sched, np.int32).copy()
        sched[2] += shift
        want = banded_call_ragged(
            op_j.band, jnp.asarray(base.numpy()), jnp.asarray(sched), *arrs,
            levels=op_j.levels, ring=op_j.ring_slots, G=G,
            out_rows=op_j.m_padded, interpret=True,
            band_scale=op_j.band_scale if dtype == "int8" else None)
        if dtype == "bfloat16":
            want = np.asarray(want.astype(jnp.float32))
        _close(got, want, dtype)

    def test_pad_rows(self, ops):
        """Rows without nonzeros: 0 for L@x, -x0 + c for the adjoint
        hop."""
        op = ops[("uniform", "float32")]
        x, x0, c = _inputs(op, op.m_padded, 5, 3)
        pad = slice(op.m, op.m_padded)
        assert not _rows(op, x)[pad].any()
        torch.testing.assert_close(_rows(op, x, x0, c)[pad],
                                   (-x0 + c)[pad], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sparse_roofline_counts_the_int16_offset(city, ops, layout, dtype):
    """The sparse bound of a banded product charges each nonzero its
    value and the int16 window offset the walk reads, not an int32
    column; the ragged operator, which holds the same nonzeros, gets the
    same bound."""
    op = ops[(layout, dtype)]
    e = torch.empty(0, dtype=op.compute_dtype).element_size()
    assert op.nz_win.element_size() == 2
    want = (op.nnz * (e + op.nz_win.element_size()) + (op.m_padded + 1) * 4
            + 3 * op.m_padded * C * e)
    assert sparse_roofline(op, None, C, extra_inputs=1)["bytes"] == want
    rag = device_laplacian(
        city, fmt="banded", use_pallas=False, rows_per_step=G,
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
                           device="cpu")
    if dtype == "int8":
        rag = quantize_banded(rag, sample_x=3.0)
    assert sparse_roofline(rag, None, C, extra_inputs=1)["bytes"] == want
