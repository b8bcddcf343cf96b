"""The block-sparse (BSR) slice against the JAX package on the same NumPy
inputs: the packers and ``device_laplacian(fmt="bsr")``'s layouts
(byte-equal), the plain versions of the two CUDA kernels against the
Pallas kernels in interpret mode (K4 ``_colstream_call``, K7
``_grouped_call`` and ``bsr_call_quant``, K8/K9 ``_bsr_spmm_impl``), the
autograd wrappers' gradients against ``jax.grad``, the int8 twin, and
the NodeClassifier on BSR operators.  The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.

Tolerances: f32 ``atol=1e-4`` (the JAX tests' bound; sums in another
order); int8 bit-exact (exact integer accumulation, one f32 epilogue
with identical operations); gradients ``atol=1e-3, rtol=1e-4`` as
tests/test_quant_formats.py; NodeClassifier logits, loss and gradients
1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.models.common import (
    quantize_model_operators as jax_quantize_model_operators,
)
from cnn_graph_tpu.ops import cheby_finals as jax_cheby_finals
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import laplacian as jax_lap
from cnn_graph_tpu.ops import quantize_block_sparse as jax_quantize_bsr
from cnn_graph_tpu.ops import quantize_dense as jax_quantize_dense
from cnn_graph_tpu.ops.pallas_spmm import (
    _bsr_spmm_impl,
    _colstream_call,
    _grouped_call,
    bsr_call_quant,
)
from cnn_graph_tpu.ops.pallas_spmm import bsr_cheby_hop as jax_bsr_cheby_hop
from cnn_graph_tpu.ops.pallas_spmm import bsr_spmm as jax_bsr_spmm
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import node_classifier_params_from_jax
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.models.common import quantize_model_operators
from cnn_graph_tpu_torch.ops import (
    BlockSparseLaplacian,
    DenseLaplacian,
    QuantBlockSparseLaplacian,
    QuantDenseLaplacian,
    bsr_cheby_hop,
    bsr_colstream,
    bsr_colstream_reference,
    bsr_csr,
    bsr_csr_reference,
    bsr_spmm,
    cheby_conv,
    cheby_finals,
    device_laplacian,
    packing,
    quantize_block_sparse,
    quantize_dense,
)
from cnn_graph_tpu_torch.ops.laplacian import ROW_INDEX_FIELDS
from cnn_graph_tpu_torch.serve import compile_serving

C = 200  # not a multiple of the TPU's 128-lane tiles


def _scattered(n, seed=0, dims=8, k=10):
    """Embedding-kNN-style graph: Gaussian points, kNN, RCM, normalized
    Laplacian (tests/test_quant_formats.py:34-45, bench.py:776-782)."""
    z = np.random.default_rng(seed).normal(size=(n, dims)).astype(np.float32)
    W = graphs.adjacency(*graphs.knn(z, k=k, algorithm="auto"))
    perm = graphs.bandwidth_reducing_permutation(W)
    return graphs.laplacian(W[perm][:, perm].tocsr())


@pytest.fixture(scope="module")
def g900():
    """900 nodes: 8 block-rows, one column-streamed group, row groups of
    G > 1 in the block-CSR layout."""
    L = _scattered(900)
    z = np.random.default_rng(0).normal(size=(900, 8)).astype(np.float32)
    W = gc.adjacency(*gc.knn(z, k=10, algorithm="auto"))
    perm = gc.bandwidth_reducing_permutation(W)
    L_j = gc.laplacian(W[perm][:, perm].tocsr(), normalized=True)
    assert abs(L - L_j).max() <= 1e-12
    return L


@pytest.fixture(scope="module")
def city48():
    """2,304 nodes: three column-streamed groups."""
    return graphs.city_graph(48, k=8, seed=0)[0]


@pytest.fixture(scope="module", params=["g900", "city48"])
def graph(request):
    return request.getfixturevalue(request.param)


def _ops(L, **kw):
    """The port's and the JAX package's operator for the same arguments."""
    kw = {"fmt": "bsr", "block_size": 128, "use_pallas": True, **kw}
    return device_laplacian(L, **kw,
                            device="cpu"), jax_device_laplacian(L, **kw)


def _inputs(mp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(mp, C)) * scale).astype(np.float32)
            for _ in range(2)]


def _assert_same_operator(op, op_j):
    """Every field equal: tensors as raw bytes, the rest by value.  The
    port's own row index (``ROW_INDEX_FIELDS``) has no JAX counterpart;
    tests/test_torch_bsr_rows.py holds it to the Laplacian."""
    for f in dataclasses.fields(op):
        if f.name in ROW_INDEX_FIELDS:
            continue
        a, b = getattr(op, f.name), getattr(op_j, f.name)
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.bfloat16:
                a = a.view(torch.int16)
            b = np.asarray(b)
            assert a.shape == b.shape, f.name
            assert a.numpy().tobytes() == b.tobytes(), f.name
        else:
            assert a == b or (a is None and b is None), (f.name, a, b)


# ----------------------------------------------------------------- packers


class TestPackers:
    def test_choose_block_shape(self, graph):
        L = gc.rescale_laplacian(graph)
        assert packing.choose_block_shape(L) == jax_lap.choose_block_shape(L)
        cands = ((8, 128), (16, 128))
        assert (packing.choose_block_shape(L, cands, dma_overhead=10)
                == jax_lap.choose_block_shape(L, cands, dma_overhead=10))

    @pytest.mark.parametrize("shape", [(128, 128), (8, 128), (32, 128)])
    @pytest.mark.parametrize("rect", [False, True])
    def test_pack_block_sparse_byte_equal(self, g900, shape, rect):
        L = gc.rescale_laplacian(g900)
        if rect:  # the rectangular branch: rows and columns pad apart
            L = L.tocsr()[:700]
        got = packing.pack_block_sparse(L, shape)
        want = jax_lap.pack_block_sparse(L, shape)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert got[4] == want[4]

    @pytest.mark.parametrize("G", [1, 2, 8])
    def test_colstream_pack_byte_equal(self, graph, G):
        L = gc.rescale_laplacian(graph)
        blocks, brows, bcols, rowptr, mp = packing.pack_block_sparse(L)
        n_rb = -(-(mp // 128) // G) * G
        rowptr = np.concatenate(
            [rowptr, np.full(n_rb + 1 - len(rowptr), rowptr[-1], np.int32)])
        got = packing.colstream_pack(blocks, brows, bcols, rowptr, G)
        want = jax_lap.colstream_pack(blocks, brows, bcols, rowptr, G)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("elem_bytes", [1, 2, 4])
    def test_choose_bsr_row_group(self, graph, elem_bytes):
        rowptr = packing.pack_block_sparse(gc.rescale_laplacian(graph))[3]
        assert (packing.choose_bsr_row_group(rowptr, 128, 128, elem_bytes)
                == jax_lap.choose_bsr_row_group(rowptr, 128, 128,
                                                elem_bytes))

    def test_colstream_pack_checks_the_meta_fields(self):
        """A group with more distinct columns than a 16-bit slot holds
        raises, where the JAX packer would wrap the slot into the row
        field: one (1, 1)-block row with 65,537 columns, G = 1."""
        n = (1 << 16) + 1
        blocks = np.ones((n, 1, 1), np.float32)
        brows = np.zeros(n, np.int32)
        bcols = np.arange(n, dtype=np.int32)
        rowptr = np.array([0, n], np.int32)
        with pytest.raises(ValueError, match="16-bit column slot"):
            packing.colstream_pack(blocks, brows, bcols, rowptr, 1)
        # One column fewer fits, and its last slot is 65,535.
        meta = packing.colstream_pack(blocks[:-1], brows[:-1], bcols[:-1],
                                      np.array([0, n - 1], np.int32), 1)[3]
        assert meta.max() == 0xFFFF

    def test_colstream_pack_checks_the_row_field(self):
        G = (1 << 16) + 1
        with pytest.raises(ValueError, match="16-bit row field"):
            packing.colstream_pack(np.zeros((0, 1, 1), np.float32),
                                   np.zeros(0, np.int32),
                                   np.zeros(0, np.int32),
                                   np.zeros(G + 1, np.int32), G)


class TestDeviceOperator:
    @pytest.mark.parametrize("kw", [
        dict(), dict(col_stream=False), dict(chunked_rows=True),
        dict(col_stream=False, block_size=(8, 128)),
        dict(block_size=(8, 128)), dict(use_pallas=False),
        dict(block_size="auto"),
    ], ids=["colstream", "grouped", "chunked", "grouped_8x128",
            "colstream_8x128", "gather", "auto_shape"])
    def test_layout_matches_jax(self, graph, kw):
        _assert_same_operator(*_ops(graph, **kw))

    @pytest.mark.parametrize("kw", [dict(), dict(col_stream=False)])
    def test_bf16_layout_matches_jax(self, g900, kw):
        op = device_laplacian(g900, fmt="bsr", block_size=128,
                              use_pallas=True, dtype=torch.bfloat16, **kw,
                              device="cpu")
        op_j = jax_device_laplacian(g900, fmt="bsr", block_size=128,
                                    use_pallas=True, dtype=jnp.bfloat16,
                                    **kw)
        assert op.blocks.dtype == torch.bfloat16
        _assert_same_operator(op, op_j)

    def test_use_pallas_follows_the_device(self, g900, monkeypatch):
        """None: the kernels wherever a CUDA device is present, whatever
        device the operator is built on, the gather route elsewhere (JAX:
        on any backend but the CPU)."""
        op = device_laplacian(g900, fmt="bsr", device="cpu")
        assert not op.use_pallas and not op.col_stream
        _assert_same_operator(op, jax_device_laplacian(g900, fmt="bsr"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for device in ("meta", "cpu"):
            op = device_laplacian(g900, fmt="bsr", device=device)
            assert op.use_pallas and op.col_stream
            assert op.blocks.device.type == device
        _assert_same_operator(
            op, jax_device_laplacian(g900, fmt="bsr", use_pallas=True))

    def test_auto_takes_bsr_as_jax_does(self, city48):
        """A block size other than 128 sends fmt="auto" to BSR; so does a
        wide band over the dense budget."""
        op, op_j = _ops(city48, fmt="auto", block_size=(8, 128))
        assert isinstance(op, BlockSparseLaplacian)
        _assert_same_operator(op, op_j)
        z = np.random.default_rng(13).uniform(size=(5000, 2))
        L = graphs.laplacian(graphs.adjacency(
            *graphs.knn(z, k=8, algorithm="auto")))
        op, op_j = _ops(L, fmt="auto", block_size="auto",
                        dense_budget=1 << 20)
        assert isinstance(op, BlockSparseLaplacian) and op.col_stream
        _assert_same_operator(op, op_j)

    def test_to_device_moves_every_tensor(self, g900):
        op, _ = _ops(g900)
        moved = op.to("meta")
        for f in ("blocks", "block_rows", "block_cols", "block_rowptr",
                  "cs_meta", "cs_gcols", "cs_gcolptr", "cs_groupptr",
                  "nz_rowptr", "nz_cols", "nz_pos"):
            assert getattr(moved, f).device.type == "meta"
        assert moved.rows_per_step == op.rows_per_step


# ---------------------------------------------- plain versions vs Pallas


def _colstream_ref(op, x, x0=None, scale=None):
    return bsr_colstream_reference(
        op.blocks, op.cs_meta, op.cs_gcols, op.cs_gcolptr, op.cs_groupptr,
        torch.from_numpy(x), None if x0 is None else torch.from_numpy(x0),
        G=op.rows_per_step, block_scale=scale).numpy()


def _csr_ref(op, x, x0=None, scale=None):
    return bsr_csr_reference(
        op.blocks, op.block_rowptr, op.block_cols, torch.from_numpy(x),
        None if x0 is None else torch.from_numpy(x0),
        block_scale=scale).numpy()


def _jarr(a):
    return None if a is None else jnp.asarray(a)


class TestReferencesAgainstPallas:
    @pytest.mark.parametrize("hop", [False, True])
    def test_colstream_f32(self, graph, hop):
        """K4: bsr_colstream_reference vs _kernel_colstream."""
        op, op_j = _ops(graph)
        x, x0 = _inputs(op.m_padded, 1)
        x0 = x0 if hop else None
        want = np.asarray(_colstream_call(op_j, jnp.asarray(x), _jarr(x0),
                                          interpret=True))
        np.testing.assert_allclose(_colstream_ref(op, x, x0), want,
                                   atol=1e-4)

    @pytest.mark.parametrize("hop", [False, True])
    def test_colstream_int8_bit_exact(self, graph, hop):
        op, op_j = _ops(graph)
        q, q_j = quantize_block_sparse(op, sample_x=3.0), jax_quantize_bsr(
            op_j, sample_x=3.0)
        xq, x0q = (np.array(q_j.quantize(jnp.asarray(v)))
                   for v in _inputs(op.m_padded, 2, scale=1.5))
        x0q = x0q if hop else None
        want = np.asarray(bsr_call_quant(q_j, jnp.asarray(xq), _jarr(x0q),
                                         interpret=True))
        got = _colstream_ref(q, xq, x0q, scale=q.block_scale)
        assert got.dtype == np.int8 and np.array_equal(got, want)

    @pytest.mark.parametrize("hop", [False, True])
    def test_grouped_f32(self, graph, hop):
        """K7: bsr_csr_reference vs _kernel_grouped (G > 1)."""
        op, op_j = _ops(graph, col_stream=False)
        assert op.rows_per_step > 1
        x, x0 = _inputs(op.m_padded, 3)
        x0 = x0 if hop else None
        want = np.asarray(_grouped_call(op_j, jnp.asarray(x), _jarr(x0),
                                        interpret=True))
        np.testing.assert_allclose(_csr_ref(op, x, x0), want, atol=1e-4)

    @pytest.mark.parametrize("hop", [False, True])
    def test_grouped_int8_bit_exact(self, graph, hop):
        op, op_j = _ops(graph, col_stream=False)
        q, q_j = quantize_block_sparse(op, sample_x=3.0), jax_quantize_bsr(
            op_j, sample_x=3.0)
        xq, x0q = (np.array(q_j.quantize(jnp.asarray(v)))
                   for v in _inputs(op.m_padded, 4, scale=1.5))
        x0q = x0q if hop else None
        want = np.asarray(bsr_call_quant(q_j, jnp.asarray(xq), _jarr(x0q),
                                         interpret=True))
        got = _csr_ref(q, xq, x0q, scale=q.block_scale)
        assert got.dtype == np.int8 and np.array_equal(got, want)

    @pytest.mark.parametrize("layout", ["per_block", "chunked"])
    def test_csr_f32(self, graph, layout):
        """K8 (the per-block pipeline, G = 1) and K9 (chunked rows) vs
        _bsr_spmm_impl."""
        if layout == "chunked":
            op, op_j = _ops(graph, chunked_rows=True)
            assert op.row_max > 0
        else:
            op, op_j = (dataclasses.replace(o, rows_per_step=1)
                        for o in _ops(graph, col_stream=False))
        x, _ = _inputs(op.m_padded, 5)
        want = np.asarray(_bsr_spmm_impl(op_j, jnp.asarray(x),
                                         interpret=True))
        np.testing.assert_allclose(_csr_ref(op, x), want, atol=1e-4)

    def test_matches_scipy_and_keeps_pad_rows_zero(self, graph):
        op, _ = _ops(graph)
        x, _ = _inputs(op.m_padded, 6)
        got = _colstream_ref(op, x)
        want = gc.rescale_laplacian(graph) @ x[: op.m]
        np.testing.assert_allclose(got[: op.m], want, atol=1e-5)
        assert not np.any(got[op.m:])


# ------------------------------------------------- operators and routing


class TestOperatorRouting:
    @pytest.mark.parametrize("kw", [dict(), dict(col_stream=False),
                                    dict(chunked_rows=True),
                                    dict(use_pallas=False)],
                             ids=["colstream", "grouped", "chunked",
                                  "gather"])
    def test_matmul_and_hop_match_jax(self, g900, kw):
        """The operator's matmul and cheby_hop on the CPU (the kernels'
        plain versions, or the gather route) against the JAX operator's
        (Pallas in interpret mode, or XLA)."""
        op, op_j = _ops(g900, **kw)
        x, x0 = _inputs(op.m_padded, 7)
        jx, jx0 = jnp.asarray(x), jnp.asarray(x0)
        if op_j.use_pallas:
            want = jax_bsr_spmm(op_j, jx, 512, True)
            fused = op_j.rows_per_step > 1 or op_j.col_stream
            want_h = (jax_bsr_cheby_hop(op_j, jx, jx0, 512, True) if fused
                      else 2.0 * want - jx0)
        else:
            want, want_h = op_j.matmul(jx), op_j.cheby_hop(jx, jx0)
        got = op.matmul(torch.from_numpy(x))
        got_h = op.cheby_hop(torch.from_numpy(x), torch.from_numpy(x0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   atol=1e-4)

    def test_routes_count_by_kernel(self, g900):
        """On the CPU the wrappers run their plain versions and count no
        launch; the route is still chosen as on the card."""
        from cnn_graph_tpu_torch.ops import bsr as bsr_mod

        ops = {name: _ops(g900, **kw)[0] for name, kw in (
            ("K4", dict()), ("K7", dict(col_stream=False)),
            ("K9", dict(chunked_rows=True)))}
        ops["K8"] = dataclasses.replace(ops["K7"], rows_per_step=1)
        for route, op in ops.items():
            assert bsr_mod._spmm_route(op) == route
        assert bsr_mod._grouped_route(ops["K4"]) == "K4"
        assert bsr_mod._grouped_route(ops["K8"]) == "K7"
        with pytest.raises(ValueError, match="group_max"):
            bsr_mod._grouped_route(ops["K9"])
        before = (bsr_colstream.launches, bsr_csr.launches)
        x = torch.zeros(ops["K4"].m_padded, 4)
        for op in ops.values():
            op.matmul(x[: op.m_padded])
        assert (bsr_colstream.launches, bsr_csr.launches) == before

    def test_bf16_gather_rounds_per_block(self, g900):
        """bf16 on the gather route: each block's product rounds to bf16
        before the sum, as preferred_element_type=bf16 does in JAX; within
        a few bf16 ulps of JAX's XLA result (the two round the partial sums
        in other orders)."""
        op = device_laplacian(g900, fmt="bsr", block_size=128,
                              use_pallas=False, dtype=torch.bfloat16,
                              device="cpu")
        op_j = jax_device_laplacian(g900, fmt="bsr", block_size=128,
                                    use_pallas=False, dtype=jnp.bfloat16)
        x, _ = _inputs(op.m_padded, 8)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = op.matmul(xb)
        assert got.dtype == torch.bfloat16
        want = np.asarray(op_j.matmul(jnp.asarray(x, jnp.bfloat16)),
                          np.float32)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=4 * 2**-8 * scale)


class TestGradients:
    """bsr_spmm / bsr_cheby_hop backward against jax.grad through the
    Pallas wrappers' custom VJPs (interpret mode)."""

    @pytest.mark.parametrize("kw", [dict(), dict(col_stream=False)],
                             ids=["colstream", "grouped"])
    def test_bsr_spmm(self, g900, kw):
        op, op_j = _ops(g900, **kw)
        x, t = _inputs(op.m_padded, 9)
        xt = torch.from_numpy(x).requires_grad_()
        (bsr_spmm(op, xt) * torch.from_numpy(t)).sum().backward()
        want = jax.grad(lambda a: jnp.sum(
            jax_bsr_spmm(op_j, a, 512, True) * t))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                   atol=1e-3, rtol=1e-4)

    @pytest.mark.parametrize("kw", [dict(), dict(col_stream=False)],
                             ids=["colstream", "grouped"])
    def test_bsr_cheby_hop(self, g900, kw):
        op, op_j = _ops(g900, **kw)
        x1, x0 = _inputs(op.m_padded, 10)
        t, _ = _inputs(op.m_padded, 11)
        a1, a0 = (torch.from_numpy(a).requires_grad_() for a in (x1, x0))
        (bsr_cheby_hop(op, a1, a0) * torch.from_numpy(t)).sum().backward()
        g1, g0 = jax.grad(lambda u, v: jnp.sum(
            jax_bsr_cheby_hop(op_j, u, v, 512, True) * t),
            argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x0))
        for got, want in ((a1.grad, g1), (a0.grad, g0)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-3, rtol=1e-4)


# --------------------------------------------------------------- int8 twin


class TestQuantTwin:
    @pytest.mark.parametrize("kw", [dict(), dict(col_stream=False),
                                    dict(use_pallas=False)],
                             ids=["colstream", "grouped", "gather"])
    def test_quantized_blocks_byte_equal(self, g900, kw):
        op, op_j = _ops(g900, **kw)
        q, q_j = quantize_block_sparse(op, sample_x=3.0), jax_quantize_bsr(
            op_j, sample_x=3.0)
        assert isinstance(q, QuantBlockSparseLaplacian)
        _assert_same_operator(q, q_j)

    @pytest.mark.parametrize("kw", [dict(), dict(col_stream=False),
                                    dict(use_pallas=False)],
                             ids=["colstream", "grouped", "gather"])
    def test_carries_match_jax_fallback(self, g900, kw):
        """spmm_q / cheby_hop_q against the JAX twin's int32 gather route,
        bit for bit, and the float view."""
        op, op_j = _ops(g900, **kw)
        q = quantize_block_sparse(op, sample_x=3.0)
        q_fb = dataclasses.replace(jax_quantize_bsr(op_j, sample_x=3.0),
                                   use_pallas=False)
        x, x0 = _inputs(op.m_padded, 12, scale=2.0)
        xq, x0q = (np.array(q_fb.quantize(jnp.asarray(v))) for v in (x, x0))
        np.testing.assert_array_equal(q.quantize(torch.from_numpy(x)).numpy(),
                                      xq)
        np.testing.assert_array_equal(
            q.cheby_hop_q(torch.from_numpy(xq), torch.from_numpy(x0q)).numpy(),
            np.asarray(q_fb.cheby_hop_q(jnp.asarray(xq), jnp.asarray(x0q))))
        np.testing.assert_array_equal(
            q.spmm_q(torch.from_numpy(xq)).numpy(),
            np.asarray(q_fb.spmm_q(jnp.asarray(xq))))
        np.testing.assert_allclose(q.matmul(torch.from_numpy(x)).numpy(),
                                   np.asarray(q_fb.matmul(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)

    def test_inference_only(self, g900):
        q = quantize_block_sparse(_ops(g900)[0], sample_x=3.0)
        x = torch.zeros(q.m_padded, 4, requires_grad=True)
        with pytest.raises(RuntimeError, match="inference-only"):
            q.matmul(x)
        with pytest.raises(RuntimeError, match="no backward"):
            bsr_colstream(q.blocks, q.nz_rowptr, q.nz_cols, q.nz_pos, x)

    def test_no_kernel_on_other_devices(self, g900):
        """No silent fallback: a tensor on neither the CPU nor a CUDA
        device reaches no plain version."""
        op = _ops(g900, col_stream=False)[0]
        x = torch.zeros(op.m_padded, 4, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            bsr_csr(op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos, x)
        cs = _ops(g900)[0]
        with pytest.raises(ValueError, match="no kernel"):
            bsr_colstream(cs.blocks, cs.nz_rowptr, cs.nz_cols, cs.nz_pos, x)


# ---------------------------------------------------------- dense int8 twin


@pytest.fixture(scope="module")
def dense_pair(g900):
    """The 900-node scattered graph as the port's and JAX's dense operator
    and int8 twin (tests/test_quant_formats.py:250-268)."""
    op = device_laplacian(g900, fmt="dense", device="cpu")
    op_j = jax_device_laplacian(g900, fmt="dense")
    return op, op_j, quantize_dense(op, sample_x=3.0), jax_quantize_dense(
        op_j, sample_x=3.0)


class TestQuantDense:
    def test_matrix_and_scales_equal_jax(self, dense_pair):
        *_, q, q_j = dense_pair
        assert isinstance(q, QuantDenseLaplacian)
        assert q.mat.dtype == torch.int8
        np.testing.assert_array_equal(q.mat.numpy(), np.asarray(q_j.mat))
        assert q.mat_scale == q_j.mat_scale
        assert (q.act_scale, q.headroom, q.m, q.m_padded, q.nnz) == (
            q_j.act_scale, q_j.headroom, q_j.m, q_j.m_padded, q_j.nnz)

    @pytest.mark.parametrize("hop", [False, True])
    def test_carries_bit_identical_to_jax(self, dense_pair, hop):
        """spmm_q and cheby_hop_q on the same int8 inputs: the exact
        accumulator and one f32 emission, as JAX's int32 ``jnp.dot``."""
        *_, q, q_j = dense_pair
        x, x0 = _inputs(q.m_padded, 13, scale=2.0)
        xq, x0q = (np.array(q_j.quantize(jnp.asarray(v))) for v in (x, x0))
        np.testing.assert_array_equal(q.quantize(torch.from_numpy(x)).numpy(),
                                      xq)
        if hop:
            got = q.cheby_hop_q(torch.from_numpy(xq), torch.from_numpy(x0q))
            want = q_j.cheby_hop_q(jnp.asarray(xq), jnp.asarray(x0q))
        else:
            got = q.spmm_q(torch.from_numpy(xq))
            want = q_j.spmm_q(jnp.asarray(xq))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_chain_bit_identical_to_jax(self, dense_pair):
        *_, q, q_j = dense_pair
        x = _inputs(q.m_padded, 14)[0]
        got = cheby_finals(q, q.quantize(torch.from_numpy(x)), 6)
        want = jax_cheby_finals(q_j, q_j.quantize(jnp.asarray(x)), 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_float_view_and_conv_within_jax_bounds(self, dense_pair):
        """The JAX test's bounds (tests/test_quant_formats.py:252-268):
        the float view within 0.05 and the int8 conv within 0.08 of the
        float operator's, relative to its max."""
        op, _, q, _ = dense_pair
        rng = np.random.default_rng(7)
        X = torch.from_numpy(rng.normal(size=(op.m_padded, 64)).astype(
            np.float32))
        f32 = op.matmul(X)
        rel = float((q.matmul(X) - f32).abs().max() / f32.abs().max())
        assert rel < 0.05, rel
        x = torch.from_numpy(rng.normal(size=(2, op.m, 8)).astype(np.float32))
        w = torch.from_numpy((rng.normal(size=(5, 8, 6)) * 0.2).astype(
            np.float32))
        with torch.no_grad():
            yq, yf = cheby_conv(x, q, w), cheby_conv(x, op, w)
        rel = float((yq - yf).abs().max() / yf.abs().max())
        assert rel < 0.08, rel

    def test_quantize_model_operators_maps_dense(self, dense_pair):
        op, *_ = dense_pair
        model = quantize_model_operators(NodeClassifier(op, 4, 2, hidden=[],
                                                        K=2))
        assert isinstance(model.op, QuantDenseLaplacian)
        assert quantize_model_operators(model).op is model.op

    def test_zero_matrix_takes_scale_one(self):
        op = DenseLaplacian(mat=torch.zeros(8, 8), m=8, m_padded=8, nnz=0)
        q = quantize_dense(op)
        assert q.mat_scale == 1.0 and not bool(q.mat.any())


# --------------------------------------------------------------- the model

FIN, CLASSES, K = 16, 4, 5


@pytest.fixture(scope="module")
def model_data(city48):
    rng = np.random.default_rng(21)
    m = city48.shape[0]
    feats = rng.normal(size=(m, FIN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, m)
    mask = rng.random(m) < 0.3
    return feats, labels, mask


def _models(op, op_j, hidden):
    model_j = JaxNodeClassifier(op_j, FIN, CLASSES, hidden=hidden, K=K)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(0)))
    model = NodeClassifier(op, FIN, CLASSES, hidden=hidden, K=K)
    return model, model_j, node_classifier_params_from_jax(params_j), params_j


class TestNodeClassifier:
    @pytest.mark.parametrize("use_pallas", [True, False],
                             ids=["kernels", "gather"])
    def test_logits_loss_and_gradients_match_jax(self, city48, model_data,
                                                 use_pallas):
        """The deep model on a BSR operator (the kernels' plain versions,
        or the gather route) against JAX's on its XLA route, f32."""
        feats, labels, mask = model_data
        op = device_laplacian(city48, fmt="bsr", use_pallas=use_pallas,
                              device="cpu")
        op_j = jax_device_laplacian(city48, fmt="bsr", use_pallas=False)
        assert op.col_stream == use_pallas
        model, model_j, params, params_j = _models(op, op_j, hidden=[8])
        args_j = (jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(mask))
        want_logits = np.asarray(model_j.apply(params_j, args_j[0]))
        loss_j, grads_j = jax.value_and_grad(model_j.loss)(params_j, *args_j)
        for layer in params["convs"]:
            for t in layer.values():
                t.requires_grad_()
        x = torch.from_numpy(feats)
        logits = model.apply(params, x)
        np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                                   rtol=1e-4, atol=1e-4)
        loss = model.loss(params, x, torch.from_numpy(labels),
                          torch.from_numpy(mask))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                                   rtol=1e-4)
        for layer, layer_j in zip(params["convs"], grads_j["convs"]):
            for k in ("w", "b"):
                want = np.asarray(layer_j[k])
                np.testing.assert_allclose(
                    layer[k].grad.numpy(), want,
                    atol=1e-4 * max(1.0, float(np.abs(want).max())))

    @pytest.mark.parametrize("fmt_kw", [dict(), dict(col_stream=False)],
                             ids=["colstream", "grouped"])
    def test_int8_served_logits_match_jax(self, city48, model_data, fmt_kw):
        """compile_serving(int8=True) quantizes the BSR operator; its
        logits against JAX's quantize_model_operators on the XLA route,
        whose int8 carries the port reproduces bit for bit."""
        feats = model_data[0]
        op, op_j = _ops(city48, **fmt_kw)
        model, model_j, params, params_j = _models(
            op, dataclasses.replace(op_j, use_pallas=False), hidden=[])
        x = torch.from_numpy(feats)
        serving = compile_serving(model, params, x, int8=True)
        assert isinstance(serving.model.op, QuantBlockSparseLaplacian)
        got = serving(x).numpy()
        qmodel_j = jax_quantize_model_operators(
            model_j, sample_x=float(np.abs(feats).max()))
        want = np.asarray(qmodel_j.apply(params_j, jnp.asarray(feats)))
        assert got.shape == (op.m, CLASSES)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_quantize_model_operators_passes_the_twin_through(self, city48):
        op = device_laplacian(city48, fmt="bsr", device="cpu")
        model = quantize_model_operators(NodeClassifier(op, 4, 2, hidden=[],
                                                        K=2))
        assert isinstance(model.op, QuantBlockSparseLaplacian)
        assert quantize_model_operators(model).op is model.op


# ----------------------------------------------- the bench's 50k graph


def test_bench_scattered_graph_packs_as_jax_does():
    """The bench's 50k scattered graph (bench.py:763-787: 50,000 Gaussian
    points in 8-D, seed 0, kNN k=10, RCM, normalized Laplacian) built by
    both packages, and its column-streamed packing compared on the block
    structure: 54,165 blocks of 128x128, 8,568 distinct group columns, the
    same metadata and the same block order.  The block values are left
    out here (3.55 GB of f32 blocks per copy); the small graphs above
    compare them byte for byte.  A proxy array of block ids stands in for
    the blocks, so the test also checks where each block goes."""
    n = 50000
    z = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    dist, idx = graphs.knn(z, k=10, algorithm="auto")
    dist_j, idx_j = gc.knn(z, k=10, algorithm="auto")
    np.testing.assert_array_equal(idx, idx_j)
    W = graphs.adjacency(dist, idx)
    perm = graphs.bandwidth_reducing_permutation(W)
    np.testing.assert_array_equal(perm, gc.bandwidth_reducing_permutation(W))
    L = graphs.rescale_laplacian(graphs.laplacian(W[perm][:, perm].tocsr()))
    assert L.nnz == 699780
    assert packing.choose_block_shape(L) == jax_lap.choose_block_shape(L) \
        == (128, 128)

    # The block structure: the 128x128 occupancy pattern, packed as a
    # (1, 1)-block matrix, gives the same rows, columns and rowptr.
    coo = L.tocoo()
    n_rb = -(-n // 128)
    ids = np.unique((coo.row // 128).astype(np.int64) * n_rb + coo.col // 128)
    P = scipy.sparse.csr_matrix(
        (np.ones(len(ids), np.float32), (ids // n_rb, ids % n_rb)),
        shape=(n_rb, n_rb))
    _, brows, bcols, rowptr, _ = packing.pack_block_sparse(P, (1, 1))
    _, brows_j, bcols_j, rowptr_j, _ = jax_lap.pack_block_sparse(P, (1, 1))
    for a, b in ((brows, brows_j), (bcols, bcols_j), (rowptr, rowptr_j)):
        assert a.tobytes() == b.tobytes()
    assert len(brows) == 54165 and np.diff(rowptr).max() == 201

    G = 8  # device_laplacian's colstream group: m_padded 50,176
    rowptr = np.concatenate([rowptr, np.full(-(-n_rb // G) * G - n_rb,
                                             rowptr[-1], np.int32)])
    proxy = np.arange(len(brows), dtype=np.int32).reshape(-1, 1, 1)
    got = packing.colstream_pack(proxy + 1, brows, bcols, rowptr, G)
    want = jax_lap.colstream_pack(proxy + 1, brows, bcols, rowptr, G)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    blocks2, _, _, meta, gcols, gcolptr, groupptr = got
    assert len(gcols) == 8568 and int(groupptr[-1]) == 54328
    assert int((meta & 0xFFFF).max()) == 229 and int((meta >> 16).max()) == 7
    real = blocks2.ravel()[blocks2.ravel() > 0] - 1
    np.testing.assert_array_equal(np.sort(real), np.arange(len(brows)))
    assert (packing.choose_bsr_row_group(rowptr[: n_rb + 1], 128, 128, 2)
            == (1, 0))
