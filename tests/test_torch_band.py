"""The banded kernel's plain PyTorch version against the Pallas kernel
(``banded_call_dkw`` in interpret mode, as tests/test_pallas_band.py runs
it) and the JAX operators, on the same NumPy inputs.  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.  The adjoint form
``2 L@x - x0 + c`` and the gradients of ``band_spmm`` /
``band_cheby_hop`` are held against the JAX package the same way.

Tolerances: f32 ``atol=1e-4`` (the JAX tests' own bound; the two sum the
W*128-deep products in different orders); int8 bit-exact (integer
accumulation, one f32 epilogue with identical operations); bf16 within
one bf16 ulp of the f32 result (both accumulate exact bf16 products in
f32, in different orders, and round once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import quantize_banded as jax_quantize_banded
from cnn_graph_tpu.ops.pallas_band import band_cheby_hop as jax_band_cheby_hop
from cnn_graph_tpu.ops.pallas_band import (
    band_cheby_hop_c as jax_band_cheby_hop_c,
)
from cnn_graph_tpu.ops.pallas_band import band_spmm as jax_band_spmm
from cnn_graph_tpu.ops.pallas_band import banded_call_dkw
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.ops import band as band_mod
from cnn_graph_tpu_torch.ops import (
    band_cheby_hop,
    band_cheby_hop_c,
    band_spmm,
    banded_dkw,
    banded_dkw_reference,
    cheby_conv,
    device_laplacian,
    quantize_banded,
)

G = 2  # three width levels on the 96-side city graph
C = 48


@pytest.fixture(scope="module")
def ops():
    """(port f32 operator, JAX f32 operator with its dkw layout)."""
    L, _ = graphs.city_graph(96, k=8, seed=0)
    op = device_laplacian(L, fmt="banded", rows_per_step=G, use_pallas=True,
                          device="cpu")
    op_j = jax_device_laplacian(L, fmt="banded", dtype=jnp.float32,
                                use_pallas=True, rows_per_step=G)
    assert len(op.levels) >= 2
    return L, op, op_j


@pytest.fixture(scope="module")
def qops(ops):
    _, op, op_j = ops
    return quantize_banded(op, sample_x=3.0), jax_quantize_banded(
        op_j, sample_x=3.0)


def _inputs(mp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(mp, C)) * scale).astype(np.float32)
    x0 = (rng.normal(size=(mp, C)) * scale).astype(np.float32)
    return x, x0


def _jax_dkw(op_j, x, x0=None, band_scale=None, c=None):
    def arr(a):
        return None if a is None else jnp.asarray(a)

    return np.asarray(banded_call_dkw(
        op_j.bands_dkw, op_j.base, op_j.sched_dkw, arr(x), arr(x0), arr(c),
        levels=op_j.levels,
        ring=op_j.ring_slots, G=op_j.rows_per_step, out_rows=op_j.m_padded,
        band_scale=band_scale, interpret=True,
    ))


def _port_dkw(op, x, x0=None, band_scale=None, c=None):
    return banded_dkw_reference(
        op.bands_dkw, op.base, op.sched_dkw, x, x0, c,
        levels=op.levels, G=op.rows_per_step, band_scale=band_scale,
    ).numpy()


class TestReferenceAgainstPallas:
    @pytest.mark.parametrize("hop", [False, True])
    def test_float32(self, ops, hop):
        _, op, op_j = ops
        x, x0 = _inputs(op.m_padded, 0)
        got = _port_dkw(op, torch.from_numpy(x),
                        torch.from_numpy(x0) if hop else None)
        want = _jax_dkw(op_j, x, x0 if hop else None)
        np.testing.assert_allclose(got, want, atol=1e-4)

    @pytest.mark.parametrize("hop", [False, True])
    def test_int8_bit_exact(self, qops, hop):
        q, q_j = qops
        x, x0 = _inputs(q.m_padded, 1, scale=1.5)
        xq, x0q = (np.array(q_j.quantize(jnp.asarray(v))) for v in (x, x0))
        got = _port_dkw(q, torch.from_numpy(xq),
                        torch.from_numpy(x0q) if hop else None,
                        band_scale=q.band_scale)
        want = _jax_dkw(q_j, xq, x0q if hop else None,
                        band_scale=q_j.band_scale)
        assert got.dtype == np.int8 and np.array_equal(got, want)

    def test_float32_matches_scipy(self, ops):
        L, op, _ = ops
        x, _ = _inputs(op.m_padded, 2)
        got = band_spmm(op, torch.from_numpy(x)).numpy()
        want = graphs.rescale_laplacian(L) @ x[: op.m]
        np.testing.assert_allclose(got[: op.m], want, atol=1e-5)
        assert not np.any(got[op.m:])

    def test_bf16_boundary_casts(self, ops):
        """f32 x into a bf16 operator: cast to bf16 at the kernel boundary,
        the result back in f32 (pallas_band._band_call)."""
        L, _, _ = ops
        op = device_laplacian(L, fmt="banded", dtype=torch.bfloat16,
                              rows_per_step=G, use_pallas=True, device="cpu")
        op_j = jax_device_laplacian(L, fmt="banded", dtype=jnp.bfloat16,
                                    use_pallas=True, rows_per_step=G)
        x, _ = _inputs(op.m_padded, 3)
        got = band_spmm(op, torch.from_numpy(x))
        assert got.dtype == torch.float32
        want = np.asarray(jax_band_spmm(op_j, jnp.asarray(x), 512, True))
        np.testing.assert_allclose(got.numpy(), want, rtol=2**-7, atol=1e-5)


class TestQuantOperator:
    @pytest.fixture(scope="class")
    def q_fb(self, qops):
        """The JAX int8 operator on its XLA fallback (int32 taps)."""
        import dataclasses

        return dataclasses.replace(qops[1], use_pallas=False)

    def test_hop_and_spmm_match_jax_fallback(self, qops, q_fb):
        """QuantBandedLaplacian.cheby_hop_q / spmm_q equal the JAX
        operator's XLA fallback bit for bit."""
        q, q_j = qops
        x, x0 = _inputs(q.m_padded, 4, scale=2.0)
        xq, x0q = (np.array(q_j.quantize(jnp.asarray(v))) for v in (x, x0))
        np.testing.assert_array_equal(
            q.quantize(torch.from_numpy(x)).numpy(), xq)
        got = q.cheby_hop_q(torch.from_numpy(xq), torch.from_numpy(x0q))
        want = q_fb.cheby_hop_q(jnp.asarray(xq), jnp.asarray(x0q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = q.spmm_q(torch.from_numpy(xq))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(q_fb.spmm_q(jnp.asarray(xq))))

    def test_float_view(self, qops, q_fb):
        q = qops[0]
        x, _ = _inputs(q.m_padded, 5)
        got = q.matmul(torch.from_numpy(x)).numpy()
        want = np.asarray(q_fb.matmul(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


class TestAdjointForm:
    """``2 L@x - x0 + c``: the backward adjoint chain's hop."""

    def test_reference_matches_pallas(self, ops):
        _, op, op_j = ops
        x, x0 = _inputs(op.m_padded, 6)
        c, _ = _inputs(op.m_padded, 7)
        got = _port_dkw(op, *(torch.from_numpy(a) for a in (x, x0)),
                        c=torch.from_numpy(c))
        want = _jax_dkw(op_j, x, x0, c=c)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_band_cheby_hop_c_matches_jax(self, ops):
        _, op, op_j = ops
        x, x0 = _inputs(op.m_padded, 8)
        c, _ = _inputs(op.m_padded, 9)
        got = band_cheby_hop_c(op, *(torch.from_numpy(a) for a in (x, x0, c)))
        want = jax_band_cheby_hop_c(op_j, *(jnp.asarray(a) for a in
                                            (x, x0, c)), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    @pytest.mark.parametrize("bad", ["no_x0", "int8"])
    def test_rejects_c_without_a_float_hop(self, ops, qops, bad):
        _, op, _ = ops
        x, x0 = (torch.from_numpy(a) for a in _inputs(op.m_padded, 10))
        kw = dict(levels=op.levels, G=op.rows_per_step)
        if bad == "no_x0":
            args, c = (op.bands_dkw, op.base, op.sched_dkw, x, None), x0
        else:
            q = qops[0]
            x, x0 = q.quantize(x), q.quantize(x0)
            args, c = (q.bands_dkw, q.base, q.sched_dkw, x, x0), x
            kw["band_scale"] = q.band_scale
        with pytest.raises(ValueError, match="c"):
            banded_dkw(*args, c, **kw)
        with pytest.raises(ValueError, match="c"):
            band_mod._check_kernel_args(*args, c, op.levels, op.rows_per_step,
                                        kw.get("band_scale"))


class TestBandGradients:
    """The symmetric adjoints against ``jax.grad`` through the Pallas
    wrappers' custom VJPs (interpret mode), atol 1e-4 as the forward."""

    def test_band_spmm(self, ops):
        _, op, op_j = ops
        x, t = _inputs(op.m_padded, 11)
        xt = torch.from_numpy(x).requires_grad_()
        (band_spmm(op, xt) * torch.from_numpy(t)).sum().backward()
        want = jax.grad(lambda a: jnp.sum(
            jax_band_spmm(op_j, a, 512, True) * t))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                   atol=1e-4)

    def test_band_cheby_hop(self, ops):
        _, op, op_j = ops
        x1, x0 = _inputs(op.m_padded, 12)
        t, _ = _inputs(op.m_padded, 13)
        a1, a0 = (torch.from_numpy(a).requires_grad_() for a in (x1, x0))
        (band_cheby_hop(op, a1, a0) * torch.from_numpy(t)).sum().backward()
        g1, g0 = jax.grad(lambda u, v: jnp.sum(
            jax_band_cheby_hop(op_j, u, v, 512, True) * t),
            argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x0))
        np.testing.assert_allclose(a1.grad.numpy(), np.asarray(g1), atol=1e-4)
        np.testing.assert_allclose(a0.grad.numpy(), np.asarray(g0), atol=1e-4)


class TestInferenceOnly:
    def test_raises_when_grad_is_requested(self, ops, qops):
        """The int8 operator stays inference-only, as the JAX int8
        operators are; so does the raw kernel call, whose gradient path
        is band_spmm / band_cheby_hop."""
        _, op, _ = ops
        q = qops[0]
        x = torch.zeros(op.m_padded, 4, requires_grad=True)
        with pytest.raises(RuntimeError, match="inference-only"):
            q.matmul(x)
        w = torch.zeros(2, 4, 3, requires_grad=True)
        with pytest.raises(RuntimeError, match="inference-only"):
            cheby_conv(x[None, : op.m], q, w)
        with pytest.raises(RuntimeError, match="no backward"):
            banded_dkw(op.bands_dkw, op.base, op.sched_dkw, x,
                       levels=op.levels, G=op.rows_per_step)
        with torch.no_grad():
            assert q.matmul(x).shape == x.shape

    def test_no_kernel_on_other_devices(self, ops):
        _, op, _ = ops
        x = torch.zeros(op.m_padded, 4, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            banded_dkw(op.bands_dkw, op.base, op.sched_dkw, x,
                       levels=op.levels, G=op.rows_per_step)


def _offset_view(t: torch.Tensor, offset: int = 3) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts ``offset`` elements
    into its buffer, so its data pointer is not 16-byte aligned."""
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


class TestKernelArgs:
    @pytest.mark.parametrize("which", ["x", "x0", "band", "c"])
    def test_rejects_misaligned_views(self, ops, which):
        """The kernel's 16-byte vector loads need aligned bands and x, and
        x0 and c are held to the same rule; the wrapper's check refuses an
        offset view before any launch."""
        _, op, _ = ops
        x, x0 = (torch.from_numpy(a) for a in _inputs(op.m_padded, 5))
        c = x0.clone()
        bands = list(op.bands_dkw)
        if which == "x":
            x = _offset_view(x)
        elif which == "x0":
            x0 = _offset_view(x0)
        elif which == "c":
            c = _offset_view(c)
        else:
            bands[-1] = _offset_view(bands[-1])
        with pytest.raises(ValueError, match="16-byte"):
            band_mod._check_kernel_args(bands, op.base, op.sched_dkw, x, x0,
                                        c, op.levels, op.rows_per_step, None)

    def test_accepts_the_operator_layout(self, ops):
        _, op, _ = ops
        x, x0 = (torch.from_numpy(a) for a in _inputs(op.m_padded, 5))
        nsb = band_mod._check_kernel_args(op.bands_dkw, op.base, op.sched_dkw,
                                          x, x0, x0.clone(), op.levels,
                                          op.rows_per_step, None)
        assert nsb == op.m_padded // (G * 128)
