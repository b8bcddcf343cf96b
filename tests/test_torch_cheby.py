"""The fused dense Chebyshev kernels' plain versions on the CPU against
the JAX package's Pallas kernels in interpret mode, on the same NumPy
inputs: K2 (``cheby_conv_fused_reference``) and K3
(``cheby_dw_fused_reference``) in f32 and bf16, the autograd Function's
dx and dW against ``jax.grad``, the dispatch rules ``_fused_eligible``,
``_dw_eligible`` and ``fused_vmem_ok`` against JAX's, and pooling.

Tolerances: K2 f32 ``atol=1e-4`` (the bound of tests/test_pallas_cheby.py
:50; f32 sums in another order); K2 bf16 ``atol=1e-3``: both round the
same operands, and only a carry that lands next to a bf16 boundary can
round one ulp apart; K3 ``1e-5`` of the largest entry in f32 (sums over
B*M products in another order) and ``2**-8`` of it in bf16 (one bf16
ulp of a partial); dx ``atol=1e-4`` and dW ``atol=1e-3``, the bounds of
tests/test_pallas_cheby.py:78-79."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import avg_pool as jax_avg_pool
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import max_pool as jax_max_pool
from cnn_graph_tpu.ops.filters import _fused_eligible as jax_fused_eligible
from cnn_graph_tpu.ops.pallas_cheby import _dw_eligible as jax_dw_eligible
from cnn_graph_tpu.ops.pallas_cheby import (
    cheby_conv_fused as jax_cheby_conv_fused,
)
from cnn_graph_tpu.ops.pallas_cheby import cheby_dw_fused as jax_cheby_dw_fused
from cnn_graph_tpu.ops.pallas_cheby import fused_vmem_ok as jax_fused_vmem_ok
from cnn_graph_tpu_torch.ops import (
    DenseLaplacian,
    avg_pool,
    cheby_conv,
    cheby_conv_fused,
    cheby_conv_fused_reference,
    cheby_dw_fused,
    cheby_dw_fused_reference,
    device_laplacian,
    fused_filter,
    max_pool,
)
from cnn_graph_tpu_torch.ops.cheby import (
    _dw_eligible,
    conv_geometry,
    fused_vmem_ok,
)
from cnn_graph_tpu_torch.ops.filters import _fused_eligible

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def knn200():
    """A 200-node 6-NN graph's normalized Laplacian (tests/test_pallas_
    cheby.py's fixture)."""
    z = np.random.default_rng(0).uniform(size=(200, 2)).astype(np.float32)
    return gc.laplacian(gc.knn_graph(z, k=6), normalized=True)


def _ops(L, dtype):
    dt, jdt = DTYPES[dtype]
    return (device_laplacian(L, fmt="dense", dtype=dt, use_pallas=True,
                             device="cpu"),
            jax_device_laplacian(L, fmt="dense", dtype=jdt, use_pallas=False))


def _inputs(seed, B, K, F, O, m=200):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, m, F)).astype(np.float32)
    w = (rng.normal(size=(K, F, O)) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, m, O)).astype(np.float32)
    return x, w, g


@dataclasses.dataclass(frozen=True)
class _CountingDense(DenseLaplacian):
    """The port's dense operator, counting its fused kernel calls."""

    calls: list = dataclasses.field(default_factory=list)

    def fused_filter(self, x, w):
        self.calls.append("K2")
        return super().fused_filter(x, w)

    def fused_dw(self, x, g, K):
        self.calls.append("K3")
        return super().fused_dw(x, g, K)


class TestPlainVersions:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,K,F,O,col_tile", [
        (10, 7, 32, 16, 128),
        (5, 4, 32, 32, 256),    # 8 samples per tile: a partial batch tile
        (3, 1, 64, 32, 128),    # K = 1: the tap of x alone
        (4, 2, 16, 32, 256),
    ])
    def test_k2_matches_pallas_interpret(self, knn200, dtype, B, K, F, O,
                                         col_tile):
        op, op_j = _ops(knn200, dtype)
        x, w, _ = _inputs(B * K + F, B, K, F, O)
        want = np.asarray(jax_cheby_conv_fused(
            jnp.asarray(x), op_j, jnp.asarray(w), col_tile, True))
        got = cheby_conv_fused_reference(torch.from_numpy(x), op,
                                         torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 if dtype == "float32" else 1e-3)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,K,F,O", [(5, 4, 32, 32), (3, 6, 32, 64)])
    def test_k3_matches_pallas_interpret(self, knn200, dtype, B, K, F, O):
        op, op_j = _ops(knn200, dtype)
        x, _, g = _inputs(B + K, B, K, F, O)
        want = np.asarray(jax_cheby_dw_fused(
            jnp.asarray(x), op_j, jnp.asarray(g), K, interpret=True))
        got = cheby_dw_fused_reference(torch.from_numpy(x), op,
                                       torch.from_numpy(g), K).numpy()
        assert got.shape == want.shape == (K, F, O)
        tol = 1e-5 if dtype == "float32" else 2**-8
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_k2_takes_a_nonsymmetric_operator(self, knn200, dtype):
        """K2 computes ``sum_k T_k(L) x W_k`` for any L, as the Pallas
        kernel does; its plain version, which the CUDA kernel is held
        to, multiplies by L and not by L^T."""
        L = (knn200 + 0.5 * scipy.sparse.triu(knn200, 1)).tocsr()
        assert (L != L.T).nnz
        op, op_j = _ops(L, dtype)
        x, w, _ = _inputs(11, 3, 5, 32, 16)
        want = np.asarray(jax_cheby_conv_fused(
            jnp.asarray(x), op_j, jnp.asarray(w), 128, True))
        got = cheby_conv_fused_reference(torch.from_numpy(x), op,
                                         torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 if dtype == "float32" else 1e-3)

    def test_cpu_wrappers_take_the_plain_versions(self, knn200):
        """On CPU tensors the wrappers compute the plain versions and
        launch nothing."""
        op, _ = _ops(knn200, "float32")
        x, w, g = (torch.from_numpy(a) for a in _inputs(1, 2, 3, 32, 32))
        before = (cheby_conv_fused.launches, cheby_dw_fused.launches)
        torch.testing.assert_close(fused_filter(x, op, w),
                                   cheby_conv_fused_reference(x, op, w),
                                   rtol=0, atol=0)
        torch.testing.assert_close(cheby_dw_fused(x, op, g, 3),
                                   cheby_dw_fused_reference(x, op, g, 3),
                                   rtol=0, atol=0)
        assert (cheby_conv_fused.launches,
                cheby_dw_fused.launches) == before

    def test_wrappers_refuse_gradients_and_bad_shapes(self, knn200):
        op, _ = _ops(knn200, "float32")
        x, w, g = (torch.from_numpy(a) for a in _inputs(2, 2, 3, 32, 32))
        with pytest.raises(ValueError, match="does not take"):
            fused_filter(x, op, w[:, :16])
        with pytest.raises(ValueError, match="does not match"):
            cheby_dw_fused(x, op, g[:1], 3)
        with pytest.raises(RuntimeError, match="no backward"):
            cheby_dw_fused(x, op, g.requires_grad_(), 3)
        with pytest.raises(RuntimeError, match="no backward"):
            fused_filter(x, op, w.requires_grad_())


class TestFusedConvGradients:
    @pytest.mark.parametrize("F,O,dw_route", [(32, 64, "K3"),
                                              (12, 8, "stacked")])
    def test_grads_match_jax(self, knn200, F, O, dw_route):
        """dx by K2 with W^T, dW by K3 where ``_dw_eligible`` holds and by
        the stacked basis where it does not, each against ``jax.grad``
        through the Pallas kernel in interpret mode."""
        op, op_j = _ops(knn200, "float32")
        x, w, _ = _inputs(F + O, 4, 5, F, O)

        def loss_j(x, w):
            return jnp.sum(jnp.sin(jax_cheby_conv_fused(x, op_j, w, 128,
                                                        True)))

        gx_j, gw_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
        counted = _CountingDense(**{f.name: getattr(op, f.name)
                                    for f in dataclasses.fields(op)})
        xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        torch.sin(cheby_conv_fused(xt, counted, wt)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                                   atol=1e-4)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j),
                                   atol=1e-3)
        want_calls = ["K2", "K2"] + (["K3"] if dw_route == "K3" else [])
        assert counted.calls == want_calls

    def test_no_dx_when_the_input_needs_none(self, knn200):
        """A first layer over raw data: the backward runs no dx K2."""
        op, _ = _ops(knn200, "float32")
        counted = _CountingDense(**{f.name: getattr(op, f.name)
                                    for f in dataclasses.fields(op)})
        x, w, _ = _inputs(5, 2, 3, 32, 32)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
        cheby_conv_fused(xt, counted, wt).sum().backward()
        assert counted.calls == ["K2", "K3"] and xt.grad is None

    def test_cheby_conv_dispatch_matches_stacked_path(self, knn200):
        """``cheby_conv`` takes the fused route on an eligible layer and
        agrees with the stacked route on the same operator."""
        op, _ = _ops(knn200, "float32")
        counted = _CountingDense(**{f.name: getattr(op, f.name)
                                    for f in dataclasses.fields(op)})
        x, w, _ = (torch.from_numpy(a) for a in _inputs(6, 3, 5, 32, 64))
        fused = cheby_conv(x, counted, w)
        assert counted.calls == ["K2"]
        stacked = cheby_conv(x, dataclasses.replace(op, use_fused=False), w)
        torch.testing.assert_close(fused, stacked, atol=1e-4, rtol=1e-5)
        cheby_conv(x[..., :1], counted, torch.ones(5, 1, 64))
        assert counted.calls == ["K2"]  # Fin = 1: not eligible


class TestDispatchRules:
    def test_fused_eligible_matches_jax(self):
        widths = (1, 2, 8, 10, 16, 32, 64, 96, 128, 256, 512, 600)
        for mp in (200, 248, 976, 1704, 2048):
            for dt, jdt in DTYPES.values():
                port = types.SimpleNamespace(m_padded=mp, compute_dtype=dt)
                ref = types.SimpleNamespace(m_padded=mp, compute_dtype=jdt)
                for tile in (256, 512):
                    for fin in widths:
                        for fout in widths:
                            assert _fused_eligible(port, fin, fout, tile) \
                                == jax_fused_eligible(ref, fin, fout, tile), \
                                (mp, dt, tile, fin, fout)

    def test_dw_eligible_and_vmem_budget_match_jax(self):
        widths = (1, 2, 8, 12, 32, 48, 64, 128, 300)
        for f in widths:
            for o in widths:
                assert _dw_eligible(f, o) == jax_dw_eligible(f, o)
        for mp in (248, 976, 1200, 1704):
            for dt, jdt in DTYPES.values():
                for tile in (32, 256, 512, 1024):
                    assert fused_vmem_ok(mp, dt, tile) == jax_fused_vmem_ok(
                        mp, jdt, tile)

    def test_paper_chebnet_layers(self):
        """In the paper's ChebNet only layer 1 (32 -> 64, 248 padded
        nodes) is fused; layer 0 (Fin = 1, 976 nodes) is not."""
        l0 = types.SimpleNamespace(m_padded=976, compute_dtype=torch.float32)
        l2 = types.SimpleNamespace(m_padded=248, compute_dtype=torch.float32)
        assert not _fused_eligible(l0, 1, 32)
        assert _fused_eligible(l2, 32, 64) and _dw_eligible(32, 64)
        assert _fused_eligible(l0, 32, 32) and _dw_eligible(32, 32)


# K2's launch shapes (B, Mp, F, O): the bench's dense_fused conv, the
# paper ChebNet's layer 1 forward and dx, and tests/test_torch_gpu.py's
# knn203 operator (208 padded nodes) at its K2 shapes.
GEOMETRY_SHAPES = {"bench": (100, 976, 32, 32), "layer1": (100, 244, 32, 64),
                   "dx": (100, 244, 64, 32), "knn203": (3, 208, 32, 64),
                   "knn203_dx": (2, 208, 64, 32),
                   "knn203_narrow": (5, 208, 8, 12),
                   "bench_b4": (4, 976, 32, 32), "wide": (3, 976, 200, 40)}


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_conv_geometry_covers_every_element_once(shape):
    """Every (row, column) of the conv's columns falls in exactly one CTA:
    cluster c of group g owns rows ``[c, c + 1) * tiles_per_cta * rows``
    of the group's samples.  Clusters stay within the portable 8 and the
    bench shape fills at least 120 of the H100's 132 SMs.  (The shared
    memory a tile takes is the built kernel's: tests/test_torch_gpu.py
    holds it to the card.)"""
    B, mp, F, O = GEOMETRY_SHAPES[shape]
    geo = conv_geometry(B, mp, F, O, 132)
    S, G, rows, per = (geo[k] for k in ("samples", "groups", "rows",
                                          "tiles_per_cta"))
    assert 1 <= geo["cluster"] <= 8 and rows in (64, 128)
    assert geo["ctas"] == G * geo["cluster"]
    assert S == min(B, max(1, 128 // F)) and G * S >= B > (G - 1) * S
    assert geo["np"] % 8 == 0 and S * F <= geo["np"] < S * F + 8
    assert geo["nop"] % 8 == 0 and S * O <= geo["nop"] < S * O + 8
    count = np.zeros((mp, B * F), np.int32)
    for g in range(G):
        cols = slice(g * S * F, min((g + 1) * S, B) * F)
        for c in range(geo["cluster"]):
            r0, r1 = c * per * rows, min((c + 1) * per * rows, mp)
            assert r0 < r1  # no CTA without rows
            count[r0:r1, cols] += 1
    assert (count == 1).all()
    if shape == "bench":
        assert geo["ctas"] >= 120


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_pooling_matches_jax(pool, p):
    x = np.random.default_rng(p).normal(size=(3, 16, 5)).astype(np.float32)
    fn, fn_j = {"max": (max_pool, jax_max_pool),
                "avg": (avg_pool, jax_avg_pool)}[pool]
    got = fn(torch.from_numpy(x), p)
    assert got.shape == (3, 16 // p, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(fn_j(jnp.asarray(x),
                                                            p)),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="divisible"):
        fn(torch.from_numpy(x[:, :15]), 2)
