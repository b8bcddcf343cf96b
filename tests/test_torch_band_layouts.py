"""The banded operator's uniform (K5) and flat ragged (K6) layouts, the
in-place hop and ``cheby_finals``, against the JAX package on the same
NumPy inputs: the packers and ``device_laplacian``'s layouts byte-equal,
the plain versions of K5 and K6 against ``banded_call`` /
``banded_call_ragged`` in interpret mode (as tests/test_pallas_band.py
runs them), with an extended-column x, the chain driver, the
NodeClassifier on the uniform operator, and ``spmm_roofline``'s counts.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: f32 ``atol=1e-4`` (the W*128-deep products summed in another
order); int8 bit-exact (integer accumulation, one f32 epilogue with
identical operations); bf16 through the boundary casts within one bf16
ulp (``rtol=2**-7``: both accumulate exact bf16 products in f32 and
round once).  Chains, logits and gradients as tests/test_torch_train.py:
f32 chains ``atol=1e-4``, logits ``rtol=atol=1e-4``, gradients
``rtol=1e-4, atol=1e-6``, int8 chains and carries bit-exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.models.common import (
    quantize_model_operators as jax_quantize_model_operators,
)
from cnn_graph_tpu.ops import cheby_finals as jax_cheby_finals
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops import quantize_banded as jax_quantize_banded
from cnn_graph_tpu.ops.laplacian import pack_banded as jax_pack_banded
from cnn_graph_tpu.ops.pallas_band import band_cheby_hop as jax_hop
from cnn_graph_tpu.ops.pallas_band import band_cheby_hop_c as jax_hop_c
from cnn_graph_tpu.ops.pallas_band import band_spmm as jax_spmm
from cnn_graph_tpu.ops.pallas_band import banded_call, banded_call_ragged
from cnn_graph_tpu.utils.profiling import spmm_roofline as jax_roofline
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import node_classifier_params_from_jax
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.ops import (
    BandedLaplacian,
    band_cheby_hop,
    band_cheby_hop_c,
    band_spmm,
    banded_dkw,
    banded_ragged,
    banded_uniform,
    cheby_finals,
    device_laplacian,
    packing,
    quantize_banded,
)
from cnn_graph_tpu_torch.serve import compile_serving
from cnn_graph_tpu_torch.utils import slope_time, spmm_roofline

G = 8
C = 160  # one 256-lane tile in the Pallas kernels, a ragged 160 here
LAYOUTS = ("uniform", "ragged")
FIN, CLASSES, K = 8, 4, 5


@pytest.fixture(scope="module")
def city():
    """7,168 padded nodes: 7 steps of G = 8 block-rows, two width levels
    (4, 5) ragged, W = 5 uniform."""
    return graphs.city_graph(80, k=8, seed=0)[0]


def _jax_op(L, layout, dtype=jnp.float32, pallas=True):
    """The JAX operator whose products run K5 or K6 (``use_pallas``
    replaced after the build, as tests/test_pallas_band.py:500 reaches
    K6), or its XLA fallback."""
    op = jax_device_laplacian(L, fmt="banded", ragged=layout == "ragged",
                              use_pallas=False, rows_per_step=G, dtype=dtype)
    return dataclasses.replace(op, use_pallas=pallas)


def _port_op(L, layout, dtype=torch.float32):
    """The port's operator whose products run K5 or K6 (their plain
    versions here)."""
    op = device_laplacian(L, fmt="banded", ragged=layout == "ragged",
                          use_pallas=False, rows_per_step=G, dtype=dtype,
                          device="cpu")
    return dataclasses.replace(op, use_pallas=True)


@pytest.fixture(scope="module")
def pairs(city):
    return {lay: (_port_op(city, lay), _jax_op(city, lay))
            for lay in LAYOUTS}


@pytest.fixture(scope="module")
def qpairs(pairs):
    return {lay: (quantize_banded(op, sample_x=3.0),
                  jax_quantize_banded(op_j, sample_x=3.0))
            for lay, (op, op_j) in pairs.items()}


def _inputs(rows, seed, n=3, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, C)) * scale).astype(np.float32)
            for _ in range(n)]


def _t(a):
    """A writable torch copy (arrays from JAX are read-only)."""
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jax_call(op_j, base, x, x0=None, c=None, band_scale=None, sched=None):
    """One interpret-mode call of the JAX op's layout kernel."""
    kw = dict(ring=op_j.ring_slots, G=op_j.rows_per_step,
              out_rows=op_j.m_padded, band_scale=band_scale, interpret=True)
    if op_j.levels:
        if sched is None:
            sched = np.asarray(op_j.sched, np.int32)
        y = banded_call_ragged(op_j.band, _j(base), _j(sched), _j(x), _j(x0),
                               _j(c), levels=op_j.levels, **kw)
    else:
        y = banded_call(op_j.band, _j(base), _j(x), _j(x0), _j(c), **kw)
    return np.asarray(y)


def _port_call(op, base, x, x0=None, c=None, band_scale=None,
               donate_x0=False):
    """The same call through the port's wrapper (its plain version on
    the CPU)."""
    if op.levels:
        return banded_ragged(op.band, _t(base), op.sched, _t(x), _t(x0),
                             _t(c), levels=op.levels, G=op.rows_per_step,
                             band_scale=band_scale, donate_x0=donate_x0)
    return banded_uniform(op.band, _t(base), _t(x), _t(x0), _t(c),
                          band_scale=band_scale, donate_x0=donate_x0)


FORMS = {"spmm": 1, "hop": 2, "hop_c": 3}  # form -> inputs x[, x0[, c]]


class TestLayouts:
    @pytest.mark.parametrize("row_multiple", [None, 16])
    def test_pack_banded_byte_equal(self, city, row_multiple):
        L = graphs.rescale_laplacian(city).tocsr()
        band, base, g, mp = packing.pack_banded(L, rows_per_step=G,
                                                row_multiple=row_multiple)
        band_j, base_j, _ring, g_j, mp_j = jax_pack_banded(
            L, rows_per_step=G, row_multiple=row_multiple)
        assert (g, mp) == (g_j, mp_j) and band.shape == band_j.shape
        assert band.tobytes() == band_j.tobytes()
        assert base.tobytes() == np.asarray(base_j, np.int32).tobytes()

    def test_pack_banded_width_guard(self, city):
        L = graphs.rescale_laplacian(city).tocsr()
        with pytest.raises(ValueError, match="band width"):
            packing.pack_banded(L, max_band_width=2)
        with pytest.raises(ValueError, match="band width"):
            jax_pack_banded(L, max_band_width=2, rows_per_step=G)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_device_operator_matches_jax(self, city, layout, dtype):
        """band (bf16 as raw 16-bit words), base, sched and levels equal
        JAX's; neither package builds the dkw layout without
        ``use_pallas``."""
        op = device_laplacian(city, fmt="banded", ragged=layout == "ragged",
                              use_pallas=False, rows_per_step=G,
                              dtype=getattr(torch, dtype), device="cpu")
        op_j = _jax_op(city, layout, getattr(jnp, dtype), pallas=False)
        assert (op.levels, op.m, op.m_padded, op.nnz, op.rows_per_step,
                op.band_width) == (op_j.levels, op_j.m, op_j.m_padded,
                                   op_j.nnz, op_j.rows_per_step,
                                   op_j.band_width)
        word = torch.int16 if dtype == "bfloat16" else torch.int32
        assert tuple(op.band.shape) == op_j.band.shape
        assert op.band.view(word).numpy().tobytes() == np.asarray(
            op_j.band).tobytes()
        np.testing.assert_array_equal(op.base.numpy(), np.asarray(op_j.base))
        if layout == "ragged":
            np.testing.assert_array_equal(
                op.sched.numpy(), np.asarray(op_j.sched, np.int32))
        else:
            assert op.sched is None and op_j.sched == ()
        assert op.bands_dkw is None and op_j.bands_dkw is None

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_dkw_twin_only_with_use_pallas_and_levels(self, city, layout):
        op = device_laplacian(city, fmt="banded", ragged=layout == "ragged",
                              use_pallas=True, rows_per_step=G, device="cpu")
        op_j = jax_device_laplacian(city, fmt="banded",
                                    ragged=layout == "ragged",
                                    use_pallas=True, rows_per_step=G)
        assert (op.bands_dkw is None) == (op_j.bands_dkw is None) == (
            layout == "uniform")
        q, q_j = quantize_banded(op), jax_quantize_banded(op_j)
        assert (q.bands_dkw is None) == (q_j.bands_dkw is None)
        assert q.band_scale == q_j.band_scale
        np.testing.assert_array_equal(q.band.numpy(), np.asarray(q_j.band))

    def test_use_pallas_none_follows_cuda(self, city, monkeypatch):
        """``None`` resolves from the platform, as the BSR branch does:
        false on this CPU-only machine, true wherever CUDA is available
        (then the ragged band gets its dkw layout)."""
        op = device_laplacian(city, fmt="banded", rows_per_step=G,
                              device="cpu")
        assert op.use_pallas is torch.cuda.is_available()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        op = device_laplacian(city, fmt="banded", rows_per_step=G,
                              device="cpu")
        assert op.use_pallas and op.bands_dkw is not None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        op = device_laplacian(city, fmt="banded", rows_per_step=G,
                              device="cpu")
        assert not op.use_pallas and op.bands_dkw is None

    def test_to_moves_every_tensor(self, city):
        op = device_laplacian(city, fmt="banded", rows_per_step=G,
                              use_pallas=True, device="cpu")
        for o in (op, quantize_banded(op)):
            moved = o.to("meta")
            tensors = [moved.band, moved.base, moved.sched, moved.sched_dkw,
                       *moved.bands_dkw]
            assert all(t.device.type == "meta" for t in tensors)


class TestKernelsAgainstPallas:
    @pytest.mark.parametrize("form", list(FORMS))
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_float32(self, pairs, layout, form):
        op, op_j = pairs[layout]
        args = _inputs(op.m_padded, 1)[:FORMS[form]]
        got = _port_call(op, op.base.numpy(), *args)
        want = _jax_call(op_j, op_j.base, *args)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    @pytest.mark.parametrize("form", ["spmm", "hop"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_int8_bit_exact(self, qpairs, layout, form):
        q, q_j = qpairs[layout]
        args = [np.asarray(q_j.quantize(jnp.asarray(a))) for a in
                _inputs(q.m_padded, 2, scale=1.5)[:FORMS[form]]]
        got = _port_call(q, q.base.numpy(), *args, band_scale=q.band_scale)
        want = _jax_call(q_j, q_j.base, *args, band_scale=q_j.band_scale)
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("form", list(FORMS))
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_bf16_boundary_casts(self, city, layout, form):
        """f32 inputs into a bf16 operator: cast to bf16 at the kernel
        boundary, the result back in f32 (pallas_band._band_call)."""
        op = _port_op(city, layout, torch.bfloat16)
        op_j = _jax_op(city, layout, jnp.bfloat16)
        args = _inputs(op.m_padded, 3)[:FORMS[form]]
        port = {"spmm": band_spmm, "hop": band_cheby_hop,
                "hop_c": band_cheby_hop_c}[form]
        got = port(op, *(_t(a) for a in args))
        if form == "spmm":
            want = jax_spmm(op_j, _j(args[0]), 512, True)
        elif form == "hop":
            want = jax_hop(op_j, _j(args[0]), _j(args[1]), 512, True)
        else:
            want = jax_hop_c(op_j, *(_j(a) for a in args), interpret=True)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2**-7, atol=1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_extended_column_x(self, pairs, qpairs, layout, dtype):
        """x with more rows than the output: ``off`` block rows of halo in
        front, two behind, every window base shifted by ``off`` (and the
        ragged schedule's column high-water with it, which the Pallas
        kernel reads): the same result as the unshifted call, in the
        hop form."""
        op, op_j = (qpairs if dtype == "int8" else pairs)[layout]
        scale = op.band_scale if dtype == "int8" else None
        off = 3
        x, x0, halo = _inputs(op.m_padded + 5 * 128, 4, scale=1.5)
        x, halo = x[: op.m_padded], halo[: 5 * 128]
        x_ext = np.concatenate([halo[: off * 128], x, halo[off * 128:]])
        if dtype == "int8":
            x, x0, x_ext = (np.asarray(op_j.quantize(jnp.asarray(a)))
                            for a in (x, x0[: op.m_padded], x_ext))
        else:
            x0 = x0[: op.m_padded]
        base_ext = (op.base.numpy() + off).astype(np.int32)
        sched_ext = None
        if layout == "ragged":
            sched_ext = np.asarray(op_j.sched, np.int32).copy()
            sched_ext[2] += off
        got = _port_call(op, base_ext, x_ext, x0, band_scale=scale)
        assert got.shape == (op.m_padded, C)
        want = _jax_call(op_j, base_ext, x_ext, x0, band_scale=scale,
                         sched=sched_ext)
        unshifted = _port_call(op, op.base.numpy(), x, x0, band_scale=scale)
        if dtype == "int8":
            assert np.array_equal(got.numpy(), want)
            assert torch.equal(got, unshifted)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
            np.testing.assert_allclose(got.numpy(), unshifted.numpy(),
                                       atol=1e-4)


class TestInPlace:
    """``donate_x0``: the output written over x0's storage."""

    def _layout_args(self, city, layout, dtype):
        op = device_laplacian(city, fmt="banded", ragged=layout != "uniform",
                              use_pallas=layout == "dkw", rows_per_step=G,
                              device="cpu")
        if dtype == "int8":
            op = quantize_banded(op, sample_x=3.0)
        x, x0 = _inputs(op.m_padded, 5, n=2, scale=1.5)
        x, x0 = _t(x), _t(x0)
        if dtype == "int8":
            x, x0 = op.quantize(x), op.quantize(x0)
        kw = dict(band_scale=op.band_scale if dtype == "int8" else None)
        if layout == "dkw":
            return banded_dkw, (op.bands_dkw, op.base, op.sched_dkw), dict(
                kw, levels=op.levels, G=G), x, x0, op
        if layout == "ragged":
            return banded_ragged, (op.band, op.base, op.sched), dict(
                kw, levels=op.levels, G=G), x, x0, op
        return banded_uniform, (op.band, op.base), kw, x, x0, op

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    @pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
    def test_bit_identical_and_shares_storage(self, city, layout, dtype):
        fn, lay, kw, x, x0, _ = self._layout_args(city, layout, dtype)
        want = fn(*lay, x, x0, **kw)
        ptr = x0.data_ptr()
        got = fn(*lay, x, x0, donate_x0=True, **kw)
        assert got is x0 and got.data_ptr() == ptr
        assert torch.equal(got, want)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_matches_the_donated_pallas_kernel(self, pairs, layout):
        op, op_j = pairs[layout]
        x, x0 = _inputs(op.m_padded, 6, n=2)
        kw = dict(ring=op_j.ring_slots, G=op_j.rows_per_step,
                  out_rows=op_j.m_padded, interpret=True, donate_x0=True)
        if layout == "ragged":
            want = banded_call_ragged(
                op_j.band, op_j.base, jnp.asarray(np.asarray(op_j.sched,
                                                             np.int32)),
                _j(x), _j(x0), levels=op_j.levels, **kw)
        else:
            want = banded_call(op_j.band, op_j.base, _j(x), _j(x0), **kw)
        got = _port_call(op, op.base.numpy(), x, x0, donate_x0=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    @pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
    def test_raises_on_aliasing_and_without_hop_form(self, city, layout):
        fn, lay, kw, x, x0, _ = self._layout_args(city, layout, "float32")
        with pytest.raises(ValueError, match="alias"):
            fn(*lay, x0, x0, donate_x0=True, **kw)
        # x a view of x0's buffer shifted by one block row: they overlap.
        buf = torch.zeros(x0.numel() + 128 * C)
        x0, x = buf[: x0.numel()].view(x0.shape), buf[128 * C:].view(x0.shape)
        with pytest.raises(ValueError, match="alias"):
            fn(*lay, x, x0, donate_x0=True, **kw)
        with pytest.raises(ValueError, match="hop form"):
            fn(*lay, x, None, donate_x0=True, **kw)

    @pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
    def test_raises_under_autograd(self, city, layout):
        fn, lay, kw, x, x0, op = self._layout_args(city, layout, "float32")
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*lay, x.requires_grad_(), x0, donate_x0=True, **kw)
        with pytest.raises(RuntimeError, match="no backward"):
            band_cheby_hop(op, x, x0, donate=True)
        with torch.no_grad():
            assert band_cheby_hop(op, x, x0, donate=True) is x0

    @pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
    def test_raises_outside_the_band_dtype(self, city, layout):
        """A carry in another dtype than the band's would be cast to a
        copy, so nothing would be written in place: refused."""
        *_, x, x0, op = self._layout_args(city, layout, "float32")
        with torch.no_grad():
            for a, b in ((x, x0.double()), (x.double(), x0),
                         (x, x0.t().contiguous().t())):
                with pytest.raises(ValueError, match="band dtype"):
                    band_cheby_hop(op, a, b, donate=True)


class TestTables:
    """The table values the kernels take on trust are checked where the
    operator is built."""

    @pytest.fixture(scope="class")
    def ops(self, city):
        return {lay: device_laplacian(city, fmt="banded",
                                      ragged=lay != "uniform",
                                      use_pallas=lay == "dkw",
                                      rows_per_step=G, device="cpu")
                for lay in ("dkw", "uniform", "ragged")}

    @pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
    def test_negative_base(self, ops, layout):
        base = ops[layout].base.clone()
        base[3] = -1
        with pytest.raises(ValueError, match="negative window base"):
            dataclasses.replace(ops[layout], base=base)

    @pytest.mark.parametrize("field", ["sched", "sched_dkw"])
    @pytest.mark.parametrize("row,value,match", [
        (0, 10**6, "outside its band"), (0, -1, "outside its band"),
        (1, 2, "level index")])
    def test_bad_step(self, ops, field, row, value, match):
        op = ops["dkw"]  # carries both the flat ragged and the dkw tables
        sched = getattr(op, field).clone()
        sched[row, -1] = value
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(op, **{field: sched})

    def test_good_tables_pass_and_quantized_too(self, ops):
        for op in ops.values():
            dataclasses.replace(op)
            quantize_banded(op, sample_x=3.0)


def _chain_oracle(op, x, K):
    """The recurrence unrolled, no donation."""
    quant = hasattr(op, "cheby_hop_q")
    basis = [x, op.spmm_q(x) if quant else op.matmul(x)]
    for _ in range(2, K):
        basis.append(op.cheby_hop_q(basis[-1], basis[-2]) if quant
                     else op.cheby_hop(basis[-1], basis[-2]))
    return basis[K - 1]


class TestChebyFinals:
    @pytest.fixture(scope="class")
    def chain_ops(self, city):
        """Each port layout beside the JAX fallback operator of the same
        band (the flat ragged band stands for the dkw one)."""
        out = {}
        for layout in ("dkw", "uniform", "ragged"):
            op = device_laplacian(city, fmt="banded",
                                  ragged=layout != "uniform",
                                  use_pallas=layout == "dkw",
                                  rows_per_step=G, device="cpu")
            op_j = _jax_op(city, "uniform" if layout == "uniform"
                           else "ragged", pallas=False)
            out[layout] = (op, op_j)
        return out

    @pytest.mark.parametrize("K", [1, 2, 3, 6, 7])
    @pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
    def test_float_matches_jax(self, chain_ops, layout, K):
        op, op_j = chain_ops[layout]
        (x,) = _inputs(op.m_padded, 7, n=1)
        xt = _t(x)
        got = cheby_finals(op, xt, K)
        want = np.asarray(jax.jit(lambda o, v: jax_cheby_finals(o, v, K))(
            op_j, jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
        assert np.array_equal(xt.numpy(), x), "the caller's x was written"

    @pytest.mark.parametrize("K", [2, 5, 6])
    @pytest.mark.parametrize("layout", ["dkw", "uniform", "ragged"])
    def test_int8_bit_exact(self, chain_ops, layout, K):
        op, op_j = chain_ops[layout]
        q = quantize_banded(op, sample_x=3.0)
        q_j = jax_quantize_banded(op_j, sample_x=3.0)
        (x,) = _inputs(op.m_padded, 8, n=1)
        xq = np.asarray(q_j.quantize(jnp.asarray(x)))
        got = cheby_finals(q, _t(xq), K)
        want = np.asarray(jax.jit(lambda o, v: jax_cheby_finals(o, v, K))(
            q_j, jnp.asarray(xq)))
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, _chain_oracle(q, _t(xq), K))

    @pytest.mark.parametrize("K", [3, 6, 7])
    def test_hops_write_in_place(self, chain_ops, K):
        """Every hop but the one that would overwrite the caller's x is
        donated, and the chain equals the unrolled recurrence bit for
        bit."""

        @dataclasses.dataclass(frozen=True)
        class Counting(BandedLaplacian):
            donated: list = dataclasses.field(default_factory=list)

            def cheby_hop(self, x1, x0, *, donate=False):
                self.donated.append(donate)
                return super().cheby_hop(x1, x0, donate=donate)

        op, _ = chain_ops["uniform"]
        counted = Counting(**{f.name: getattr(op, f.name)
                              for f in dataclasses.fields(op)})
        (x,) = _inputs(op.m_padded, 9, n=1)
        got = cheby_finals(counted, _t(x), K)
        assert counted.donated == [False] + [True] * (K - 3)
        assert torch.equal(got, _chain_oracle(op, _t(x), K))

    def test_no_donation_outside_the_compute_dtype(self, chain_ops):
        """f64 carries on an f32 operator: no hop is donated (its result
        would land in a cast copy), and the chain is the recurrence's."""
        op, _ = chain_ops["uniform"]
        (x,) = _inputs(op.m_padded, 11, n=1)
        xd = _t(x).double()
        with torch.no_grad():
            got = cheby_finals(op, xd, 6)
            want = _chain_oracle(op, xd, 6)
        assert got.dtype == torch.float64 and torch.equal(got, want)

    def test_no_donation_while_autograd_records(self, chain_ops):
        op, _ = chain_ops["ragged"]
        (x,) = _inputs(op.m_padded, 10, n=1)
        xt = _t(x).requires_grad_()
        y = cheby_finals(op, xt, 5)
        y.sum().backward()
        assert xt.grad is not None and np.array_equal(
            xt.detach().numpy(), x)


def _models(op, op_j, hidden):
    model_j = JaxNodeClassifier(op_j, FIN, CLASSES, hidden=hidden, K=K)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(4)))
    model = NodeClassifier(op, FIN, CLASSES, hidden=hidden, K=K)
    return model, model_j, node_classifier_params_from_jax(params_j), \
        params_j


class TestNodeClassifierUniform:
    """The bench's model shape in miniature on the uniform operator (K5's
    plain version) against the JAX model on its uniform fallback."""

    @pytest.fixture(scope="class")
    def data(self, pairs):
        op, op_j = pairs["uniform"]
        op_j = dataclasses.replace(op_j, use_pallas=False)
        rng = np.random.default_rng(12)
        feats = rng.normal(size=(op.m, FIN)).astype(np.float32)
        labels = rng.integers(0, CLASSES, op.m)
        mask = rng.random(op.m) < 0.5
        return op, op_j, feats, labels, mask

    def test_logits_match_jax(self, data):
        op, op_j, feats, *_ = data
        model, model_j, params, params_j = _models(op, op_j, hidden=[8])
        want = np.asarray(model_j.apply(params_j, jnp.asarray(feats)))
        with torch.inference_mode():
            got = model.apply(params, torch.from_numpy(feats)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_loss_and_gradients_match_jax(self, data):
        op, op_j, feats, labels, mask = data
        model, model_j, params, params_j = _models(op, op_j, hidden=[8])
        args_j = (jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(mask))
        loss_j, grads_j = jax.value_and_grad(model_j.loss)(params_j, *args_j)
        for layer in params["convs"]:
            for v in layer.values():
                v.requires_grad_()
        loss = model.loss(params, torch.from_numpy(feats),
                          torch.from_numpy(labels), torch.from_numpy(mask))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                                   rtol=1e-5)
        for layer, layer_j in zip(params["convs"], grads_j["convs"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    layer[k].grad.numpy(), np.asarray(layer_j[k]),
                    rtol=1e-4, atol=1e-6)

    def test_int8_serving_matches_jax(self, data):
        op, op_j, feats, *_ = data
        model, model_j, params, params_j = _models(op, op_j, hidden=[])
        x = torch.from_numpy(feats)
        serving = compile_serving(model, params, x, int8=True)
        assert serving.model.op.band.dtype == torch.int8
        assert serving.model.op.band.dim() == 4  # the uniform layout
        got = serving(x).numpy()
        qmodel_j = jax_quantize_model_operators(
            model_j, sample_x=float(np.abs(feats).max()))
        want = np.asarray(qmodel_j.apply(params_j, jnp.asarray(feats)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


class TestRoofline:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_counts_match_jax(self, city, layout, dtype):
        op = _port_op(city, layout, torch.bfloat16 if dtype == "bfloat16"
                      else torch.float32)
        op_j = _jax_op(city, layout, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)
        if dtype == "int8":
            op, op_j = quantize_banded(op), jax_quantize_banded(op_j)
        got = spmm_roofline(op, 1e-3, 512)
        want = jax_roofline(op_j, 1e-3, 512)
        assert (got["bytes"], got["flops"]) == (want["bytes"], want["flops"])
        # JAX rounds the share to three decimals.
        assert got["useful_edge_flops_frac"] == pytest.approx(
            want["useful_edge_flops_frac"], abs=5e-4)

    def test_dkw_layout_counts_its_own_blocks(self, city):
        """The dkw arrays hold the flat band's blocks, so both count the
        same; the bound is the larger time, named by its resource."""
        op = device_laplacian(city, fmt="banded", rows_per_step=G,
                              use_pallas=True, dtype=torch.bfloat16,
                              device="cpu")
        flat = dataclasses.replace(op, bands_dkw=None, sched_dkw=None)
        got, want = spmm_roofline(op, None, 512), spmm_roofline(flat, None,
                                                                 512)
        assert (got["bytes"], got["flops"]) == (want["bytes"], want["flops"])
        assert got["flops"] == 2 * op.band.shape[0] * 128 * 128 * 512
        t_bytes = got["bytes"] / 3.35e12
        t_ops = got["flops"] / 989e12
        assert got["bound_us"] == pytest.approx(max(t_bytes, t_ops) * 1e6)
        assert got["bound_by"] == ("bytes" if t_bytes >= t_ops
                                   else "operations")
        hop = spmm_roofline(op, None, 512, extra_inputs=1)
        assert hop["bytes"] - got["bytes"] == op.m_padded * 512 * 2

    def test_slope_time_needs_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card; tests/test_torch_gpu.py "
                        "times it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            slope_time(lambda u: (lambda: torch.zeros(1)))
