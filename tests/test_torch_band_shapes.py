"""The banded operator at every block shape JAX builds, against the JAX
package on the same NumPy inputs, on ``city_graph(14)`` (196 nodes) at
G = 4: (8, 8), (16, 16), (32, 64), (64, 32), (64, 64) and (128, 128).

* The packers (``band_stats``, ``pack_banded``, ``pack_banded_ragged``,
  ``pack_dkw_from_ragged``) and ``device_laplacian(fmt="banded",
  block_size=...)``'s three layouts and int8 twin byte-equal to JAX's;
  the row index (``band_row_index``) names every nonzero of L.
* The plain versions of K1, K5 and K6 (the wrappers on CPU tensors) and
  the row walk's (``banded_rows_reference``) against the Pallas kernels
  ``banded_call_dkw``, ``banded_call`` and ``banded_call_ragged`` in
  interpret mode, as tests/test_pallas_band.py runs them: the f32
  adjoint hop ``2 L@x - x0 + c``, the bf16 ``L@x`` and the int8 hop.
* ``band_spmm``/``band_cheby_hop`` against JAX's product and hop (its
  XLA route) in f32 and bf16, the int8 K-term chain, the gradients
  against ``jax.grad``, the NodeClassifier's logits and int8 serving at
  (16, 16), and an int8 artifact at (32, 64) exported and loaded.

Tolerances, as the JAX tests use them: f32 ``atol=1e-5`` of the max
(products summed in another order) and ``1e-4`` for the adjoint hop;
bf16 one bf16 ulp of the largest output (both accumulate exact bf16
products in f32 and round once; JAX's XLA hop rounds the product before
``2 y - x0``, one more rounding); int8 bit-exact; gradients ``rtol=1e-4,
atol=1e-6``; logits ``rtol=atol=1e-4``.  The CUDA kernel itself is held
against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 28)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.models.common import (
    quantize_model_operators as jax_quantize_model_operators,
)
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import laplacian as jax_lap
from cnn_graph_tpu.ops import quantize_banded as jax_quantize_banded
from cnn_graph_tpu.ops.pallas_band import (
    banded_call,
    banded_call_dkw,
    banded_call_ragged,
)
from cnn_graph_tpu.ops.pallas_band import pack_dkw_from_ragged as jax_dkw
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import node_classifier_params_from_jax
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.ops import (
    band_cheby_hop,
    band_spmm,
    banded_dkw,
    banded_ragged,
    banded_rows_reference,
    banded_uniform,
    device_laplacian,
    packing,
    quantize_banded,
)
from cnn_graph_tpu_torch.serve import (
    compile_serving,
    export_serving,
    load_serving,
)

SHAPES = [(8, 8), (16, 16), (32, 64), (64, 32), (64, 64), (128, 128)]
IDS = [f"{a}x{b}" for a, b in SHAPES]
LAYOUTS = ["dkw", "uniform", "ragged"]
G = 4
C = 24
K = 4
FIN, CLASSES = 6, 3


@pytest.fixture(scope="module")
def city():
    L, _ = graphs.city_graph(14, k=8, seed=0)
    return L, graphs.rescale_laplacian(L).tocsr()


def _rows(m, seed, n=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int8:
        return [rng.integers(-100, 100, (m, C)).astype(np.int8)
                for _ in range(n)]
    return [rng.normal(size=(m, C)).astype(np.float32) for _ in range(n)]


def _ops(L, shape, dtype=torch.float32, **kw):
    """The port's and JAX's banded operators of ``L`` at ``shape``."""
    op = device_laplacian(L, fmt="banded", block_size=shape, device="cpu",
                          rows_per_step=G, dtype=dtype, **kw)
    op_j = jax_device_laplacian(
        L, fmt="banded", block_size=shape, rows_per_step=G,
        dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32,
        **kw)
    return op, op_j


def _eq(t, a):
    np.testing.assert_array_equal(
        t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
        np.asarray(a, np.float32) if t.dtype == torch.bfloat16
        else np.asarray(a))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
class TestLayouts:
    def test_packers_match_jax(self, city, shape):
        _, Lr = city
        base, W, nb, mp = packing.band_stats(Lr, shape)
        base_j, W_j, nb_j, mp_j = jax_lap.band_stats(Lr, shape)
        assert (W, nb, mp) == (W_j, nb_j, mp_j)
        np.testing.assert_array_equal(base, base_j)
        band, base, g, mp = packing.pack_banded(Lr, rows_per_step=G,
                                                block_shape=shape)
        band_j, base_j, _, g_j, mp_j = jax_lap.pack_banded(
            Lr, shape, rows_per_step=G)
        assert band.shape[2:] == shape and (g, mp) == (g_j, mp_j)
        np.testing.assert_array_equal(band, band_j)
        np.testing.assert_array_equal(base, base_j)
        flat, base, sched, levels, g, mp = packing.pack_banded_ragged(
            Lr, G=G, block_shape=shape)
        flat_j, base_j, sched_j, levels_j, _, _, mp_j = (
            jax_lap.pack_banded_ragged(Lr, shape, rows_per_step=G))
        assert (levels, mp) == (levels_j, mp_j)
        np.testing.assert_array_equal(flat, flat_j)
        np.testing.assert_array_equal(base, base_j)
        np.testing.assert_array_equal(sched, np.asarray(sched_j))
        bands, sd = packing.pack_dkw_from_ragged(flat, sched, levels, G,
                                                 shape)
        bands_j, sd_j = jax_dkw(flat_j, sched_j, levels_j, G, *shape)
        np.testing.assert_array_equal(sd, sd_j)
        for b, b_j in zip(bands, bands_j, strict=True):
            np.testing.assert_array_equal(b, b_j)
        # Every nonzero of L once, at its window offset.
        rowptr, win = packing.band_row_index(Lr, base, mp, shape)
        row = np.repeat(np.arange(mp), np.diff(rowptr))
        col = shape[1] * base[row // shape[0]].astype(np.int64) + win
        coo = Lr.tocoo()
        key = np.unique(coo.row.astype(np.int64) * Lr.shape[1] + coo.col)
        np.testing.assert_array_equal(row * Lr.shape[1] + col, key)

    def test_device_laplacian_matches_jax(self, city, shape):
        L, _ = city
        op, op_j = _ops(L, shape, use_pallas=True)
        assert op.block_shape == tuple(op_j.block_shape) == shape
        assert (op.m_padded, op.levels) == (op_j.m_padded, op_j.levels)
        for f in ("band", "base", "sched_dkw"):
            _eq(getattr(op, f), getattr(op_j, f))
        _eq(op.sched, np.asarray(op_j.sched))
        for b, b_j in zip(op.bands_dkw, op_j.bands_dkw, strict=True):
            _eq(b, b_j)
        uni, uni_j = _ops(L, shape, use_pallas=True, ragged=False)
        assert uni.band.shape[2:] == shape and uni.levels == ()
        _eq(uni.band, uni_j.band)
        _eq(uni.base, uni_j.base)
        q, q_j = quantize_banded(op), jax_quantize_banded(op_j)
        assert q.band_scale == q_j.band_scale and q.block_shape == shape
        _eq(q.band, q_j.band)
        for b, b_j in zip(q.bands_dkw, q_j.bands_dkw, strict=True):
            _eq(b, b_j)
        moved = op.to("cpu")
        assert moved.block_shape == shape


@pytest.fixture(scope="module")
def kernel_ops(city):
    """Per shape: the port's and JAX's operators in f32, bf16 and int8,
    with the dkw layout (and its flat ragged band) and the uniform one."""
    L, _ = city
    cache = {}

    def get(shape):
        if shape not in cache:
            out = {}
            for lab, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                out[lab] = {"ragged": _ops(L, shape, dt, use_pallas=True),
                            "uniform": _ops(L, shape, dt, use_pallas=True,
                                            ragged=False)}
            out["int8"] = {lay: (quantize_banded(p, sample_x=3.0),
                                 jax_quantize_banded(j, sample_x=3.0))
                           for lay, (p, j) in out["f32"].items()}
            cache[shape] = out
        return cache[shape]

    return get


def _jax_kernel(layout, op_j, x, x0=None, c=None, band_scale=None):
    """One interpret-mode call of ``layout``'s Pallas kernel."""
    arr = [None if a is None else jnp.asarray(a) for a in (x, x0, c)]
    kw = dict(ring=op_j.ring_slots, G=op_j.rows_per_step,
              out_rows=op_j.m_padded, band_scale=band_scale, interpret=True)
    if layout == "dkw":
        y = banded_call_dkw(op_j.bands_dkw, op_j.base, op_j.sched_dkw, *arr,
                            levels=op_j.levels, **kw)
    elif layout == "uniform":
        y = banded_call(op_j.band, op_j.base, *arr, **kw)
    else:
        y = banded_call_ragged(op_j.band, op_j.base,
                               jnp.asarray(np.asarray(op_j.sched, np.int32)),
                               *arr, levels=op_j.levels, **kw)
    return np.asarray(y.astype(jnp.float32) if y.dtype == jnp.bfloat16
                      else y)


def _port_kernel(layout, op, x, x0=None, c=None, band_scale=None):
    """The layout's wrapper on CPU tensors (its plain window version) and
    the row walk's plain version, on the same inputs."""
    t = [None if a is None else torch.from_numpy(a).to(op.band.dtype)
         for a in (x, x0, c)]
    idx = dict(nz_rowptr=op.nz_rowptr, nz_win=op.nz_win)
    kw = dict(band_scale=band_scale)
    if layout == "dkw":
        y = banded_dkw(op.bands_dkw, op.base, op.sched_dkw, *t,
                       levels=op.levels, G=op.rows_per_step, **kw, **idx)
        rows = ((op.bands_dkw, op.sched_dkw, op.levels, op.rows_per_step))
    elif layout == "uniform":
        y = banded_uniform(op.band, op.base, *t, **kw, **idx)
        rows = ((op.band,), None, (op.band.shape[1],), 1)
    else:
        y = banded_ragged(op.band, op.base, op.sched, *t, levels=op.levels,
                          G=op.rows_per_step, **kw, **idx)
        rows = ((op.band,), op.sched, op.levels, op.rows_per_step)
    bands, sched, levels, g = rows
    yr = banded_rows_reference(bands, op.base, sched, op.nz_rowptr,
                               op.nz_win, *t, layout=layout, levels=levels,
                               G=g, band_scale=band_scale)
    return [v.float().numpy() for v in (y, yr)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_versions_match_pallas(kernel_ops, shape, layout):
    ops = kernel_ops(shape)
    src = "uniform" if layout == "uniform" else "ragged"
    # f32: the adjoint hop, every operand of the emission.
    op, op_j = ops["f32"][src]
    x, x0, c = _rows(op.m_padded, 1, n=3)
    want = _jax_kernel(layout, op_j, x, x0, c)
    for got in _port_kernel(layout, op, x, x0, c):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    # bf16: L@x on bf16 operands.
    op, op_j = ops["bf16"][src]
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = _jax_kernel(layout, op_j, jnp.asarray(xb, jnp.bfloat16))
    for got in _port_kernel(layout, op, xb):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0**-7 * np.abs(want).max())
    # int8: the hop with requantization, bit-exact.
    q, q_j = ops["int8"][src]
    assert q.band_scale == q_j.band_scale
    xq, xq0 = _rows(q.m_padded, 2, n=2, dtype=np.int8)
    want = _jax_kernel(layout, q_j, xq, xq0, band_scale=q_j.band_scale)
    for got in _port_kernel(layout, q, xq, xq0, band_scale=q.band_scale):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_product_and_hop_match_jax(city, shape, dtype):
    """``L @ x`` and the hop against JAX's XLA route on a flat ragged
    operator (the port's plain window version), and the int8 K-term
    chain bit-exact."""
    L, _ = city
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    op, op_j = _ops(L, shape, dt, use_pallas=False)
    if dtype == "int8":
        q, q_j = (quantize_banded(op, sample_x=3.0),
                  jax_quantize_banded(op_j, sample_x=3.0))
        (xq,) = _rows(op.m_padded, 3, dtype=np.int8)
        got, want = [torch.from_numpy(xq)], [jnp.asarray(xq)]
        with torch.no_grad():
            got.append(q.spmm_q(got[0]))
            for _ in range(2, K):
                got.append(q.cheby_hop_q(got[-1], got[-2]))
        want.append(q_j.spmm_q(want[0]))
        for _ in range(2, K):
            want.append(q_j.cheby_hop_q(want[-1], want[-2]))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    x, x0 = _rows(op.m_padded, 4, n=2)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    xs = [torch.from_numpy(a).to(dt) for a in (x, x0)]
    xj = [jnp.asarray(a, jdt) for a in (x, x0)]
    with torch.no_grad():
        got = [band_spmm(op, xs[0]), band_cheby_hop(op, *xs)]
    want = [op_j.matmul(xj[0]), op_j.cheby_hop(*xj)]
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        tol = 2.0**-7 if dtype == "bf16" else 1e-5
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_gradients_match_jax(city, shape):
    L, _ = city
    op, op_j = _ops(L, shape, use_pallas=False)
    x, x0, t = _rows(op.m_padded, 5, n=3)
    tt = torch.from_numpy(t)
    xg = torch.from_numpy(x).requires_grad_()
    (band_spmm(op, xg) * tt).sum().backward()
    x1g = torch.from_numpy(x).requires_grad_()
    x0g = torch.from_numpy(x0).requires_grad_()
    (band_cheby_hop(op, x1g, x0g) * tt).sum().backward()
    tj = jnp.asarray(t)
    g_mm = jax.grad(lambda v: jnp.sum(op_j.matmul(v) * tj))(jnp.asarray(x))
    g1, g0 = jax.grad(lambda a, b: jnp.sum(op_j.cheby_hop(a, b) * tj),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(x0))
    for got, want in ((xg.grad, g_mm), (x1g.grad, g1), (x0g.grad, g0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)


def _models(L, shape, hidden):
    op, op_j = _ops(L, shape, use_pallas=False)
    model_j = JaxNodeClassifier(op_j, FIN, CLASSES, hidden=hidden, K=K)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(4)))
    model = NodeClassifier(op, FIN, CLASSES, hidden=hidden, K=K)
    feats = np.random.default_rng(12).normal(size=(op.m, FIN)).astype(
        np.float32)
    return (model, node_classifier_params_from_jax(params_j), model_j,
            params_j, feats)


def test_node_classifier_matches_jax_at_16x16(city):
    L, _ = city
    model, params, model_j, params_j, feats = _models(L, (16, 16), [8])
    assert model.op.block_shape == (16, 16)
    want = np.asarray(model_j.apply(params_j, jnp.asarray(feats)))
    with torch.inference_mode():
        got = model.apply(params, torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    model, params, model_j, params_j, feats = _models(L, (16, 16), [])
    x = torch.from_numpy(feats)
    serving = compile_serving(model, params, x, int8=True)
    assert serving.model.op.block_shape == (16, 16)
    qmodel_j = jax_quantize_model_operators(
        model_j, sample_x=float(np.abs(feats).max()))
    want = np.asarray(qmodel_j.apply(params_j, jnp.asarray(feats)))
    np.testing.assert_allclose(serving(x).numpy(), want, rtol=0, atol=1e-4)


def test_int8_artifact_round_trips_a_non_square_shape(city, tmp_path):
    """``export_serving``/``load_serving`` of an int8 model on (32, 64)
    blocks: the op's output rows come from the band's block rows, so the
    loaded program gives the compiled handle's logits bit for bit."""
    L, _ = city
    model, params, _, _, feats = _models(L, (32, 64), [])
    x = torch.from_numpy(feats)
    export_serving(model, params, x, str(tmp_path), int8=True)
    loaded = load_serving(str(tmp_path))
    want = compile_serving(model, params, x, int8=True)(x)
    assert torch.equal(loaded(x), want)
