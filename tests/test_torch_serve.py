"""The serving artifact on the CPU: the port's ``export_serving`` ->
``load_serving`` against the JAX package's on the same NumPy weights
(carried by ``convert.py``), against the port's own ``CompiledServing``,
its metadata, the custom ops (``ops/library.py``) under
``torch.library.opcheck``, and a load in a fresh process.

Tolerances: f32 and bf16 logits against JAX's ``rtol=atol=1e-4``, as the
NodeClassifier tests (f32 sums in another order; a bf16 operator's
carries round the same bf16 products); int8 logits ``atol=1e-4 *
max|y|`` (the int8 carries are the same bits, the f32 taps sum in
another order; ``test_torch_chebnet.py``'s int8 test).  Against the
port's own handle: int8 bit-identical, float within ``1e-6 * max|y|``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from cnn_graph_tpu import serve as jax_serve
from cnn_graph_tpu.data.synthetic import city_graph as jax_city_graph
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import ChebNet as JaxChebNet
from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.models import ResGNN as JaxResGNN
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu_torch import convert, graphs
from cnn_graph_tpu_torch.models import (
    ChebNet,
    NodeClassifier,
    PerNodeLSTM,
    ResGNN,
)
from cnn_graph_tpu_torch.models.common import graph_arrays
from cnn_graph_tpu_torch.ops import (
    band,
    bsr,
    device_laplacian,
    library,
    quantize_banded,
    quantize_block_sparse,
)
from cnn_graph_tpu_torch.serve import (
    compile_serving,
    export_serving,
    load_serving,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIN, CLASSES, K = 4, 3, 3

# The port's operator by layout, and the JAX operator it is held to (the
# JAX package's plain route, as its own serving tests build it).
PORT_OPS = {
    "dkw": dict(fmt="banded", use_pallas=True),
    "uniform": dict(fmt="banded", use_pallas=True, ragged=False),
    "ragged": dict(fmt="banded", use_pallas=False),
    "bsr": dict(fmt="bsr", use_pallas=True),
    "dense": dict(fmt="dense"),
}
JAX_OPS = {"dkw": dict(fmt="banded"), "uniform": dict(fmt="banded"),
           "ragged": dict(fmt="banded"), "bsr": dict(fmt="bsr"),
           "dense": dict(fmt="dense")}


@pytest.fixture(scope="module")
def city():
    L, _ = graphs.city_graph(16, k=8, seed=0)
    x = np.random.default_rng(5).normal(size=(L.shape[0], FIN)).astype(
        np.float32)
    return L, x


def _export_both(tmp_path, model, params, model_j, params_j, x, int8,
                 **kw):
    """Export and load with both packages; returns the two loaded handles
    and the port's compiled one."""
    xt = torch.from_numpy(x)
    d, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    export_serving(model, params, xt, d, int8=int8, **kw)
    jax_serve.export_serving(model_j, params_j, jnp.asarray(x), dj,
                             int8=int8, **kw)
    return (load_serving(d), jax_serve.load_serving(dj),
            compile_serving(model, params, xt, int8=int8, **kw))


def _node_classifiers(L, layout, dtype=torch.float32):
    op = device_laplacian(L, device="cpu", dtype=dtype, **PORT_OPS[layout])
    op_j = jax_device_laplacian(
        L, use_pallas=False, dtype=jnp.bfloat16 if dtype == torch.bfloat16
        else jnp.float32, **JAX_OPS[layout])
    model_j = JaxNodeClassifier(op_j, FIN, CLASSES, hidden=[8], K=K)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(0)))
    model = NodeClassifier(op, FIN, CLASSES, hidden=[8], K=K)
    return (model, convert.node_classifier_params_from_jax(params_j),
            model_j, params_j)


def _int8_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


class TestAgainstJax:
    @pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
    @pytest.mark.parametrize("layout", list(PORT_OPS))
    def test_node_classifier(self, city, tmp_path, layout, int8):
        L, x = city
        model, params, model_j, params_j = _node_classifiers(L, layout)
        got, want, compiled = _export_both(tmp_path, model, params,
                                           model_j, params_j, x, int8)
        xt = torch.from_numpy(x)
        y, y_j = got(xt), np.asarray(want(jnp.asarray(x)))
        assert tuple(y.shape) == y_j.shape == (L.shape[0], CLASSES)
        assert got.meta["int8"] is int8 and want.meta["int8"] is int8
        if int8:
            _int8_close(y.numpy(), y_j)
            assert torch.equal(y, compiled(xt))
        else:
            np.testing.assert_allclose(y.numpy(), y_j, rtol=1e-4, atol=1e-4)
            ref = compiled(xt)
            assert float((y - ref).abs().max()) <= 1e-6 * float(
                ref.abs().max())

    def test_bf16_leaves_round_trip(self, city, tmp_path):
        """A bf16 operator exported with ``int8=False``: the leaves come
        back bit for bit, and the logits match JAX's loaded artifact."""
        L, x = city
        model, params, model_j, params_j = _node_classifiers(
            L, "dense", torch.bfloat16)
        got, want, compiled = _export_both(tmp_path, model, params,
                                           model_j, params_j, x, False)
        assert "bfloat16" in got.meta["leaf_dtypes"]
        # The same leaves as JAX's, in another order (JAX sorts dict
        # keys).
        assert sorted(zip(got.meta["leaf_dtypes"], got.meta["leaf_shapes"])
                      ) == sorted(zip(want.meta["leaf_dtypes"],
                                      want.meta["leaf_shapes"]))
        leaves = pytree.tree_leaves((graph_arrays(compiled.model),
                                     compiled.params))
        assert len(got._leaves) == len(leaves)
        assert all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got._leaves, leaves))
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(got(xt).numpy(),
                                   np.asarray(want(jnp.asarray(x))),
                                   rtol=1e-4, atol=1e-4)

    def test_chebnet_int8(self, tmp_path):
        """``test_torch_chebnet.py``'s int8 ChebNet (grid(12), 2
        coarsening levels, F=[4, 8], K=[5, 5]) through both packages'
        default (int8) artifacts."""
        W = gc.knn_graph(gc.grid(12), k=8)
        Ws, perm = graphs.coarsen(W, levels=2, seed=2017)
        Ls = [graphs.laplacian(A, normalized=True) for A in Ws]
        arch = dict(F=[4, 8], K=[5, 5], p=[2, 2], M=[16, 10])
        model_j = JaxChebNet([jax_device_laplacian(L, fmt="dense")
                              for L in Ls], **arch)
        params_j = jax.tree.map(np.asarray,
                                model_j.init(jax.random.PRNGKey(3)))
        model = ChebNet([device_laplacian(L, fmt="dense", use_pallas=True,
                                          device="cpu") for L in Ls],
                        **arch)
        x = graphs.perm_data(np.random.default_rng(11).normal(
            size=(6, 144)), perm).astype(np.float32)
        got, want, compiled = _export_both(
            tmp_path, model, convert.chebnet_params_from_jax(params_j),
            model_j, params_j, x, True)
        assert got.meta["quantized_operators"] == len(model.operators)
        xt = torch.from_numpy(x)
        y = got(xt)
        assert tuple(y.shape) == (6, 10)
        _int8_close(y.numpy(), want(jnp.asarray(x)))
        assert torch.equal(y, compiled(xt))

    @pytest.mark.parametrize("filt", ["chebyshev", "fourier"])
    def test_resgnn_forecaster(self, tmp_path, filt):
        """ResGNN on JAX's forecaster export graph (``city_graph(12)``,
        144 regions, banded, ``tests/test_serve.py:182``), int8 (the
        default) on the Chebyshev filter, f32 on the Fourier one (its
        eigenbasis is a leaf)."""
        L, _ = jax_city_graph(12, k=8, seed=0)
        U = gc.fourier(L)[1].astype(np.float32) if filt == "fourier" \
            else None
        kw = dict(input_features=6, K=3, nfilter=8, nres_layer_count=2,
                  filter=filt)
        model_j = JaxResGNN(jax_device_laplacian(
            L, fmt="banded", use_pallas=False), **kw,
            fourier_u=None if U is None else jnp.asarray(U))
        params_j = jax.tree.map(np.asarray,
                                model_j.init(jax.random.PRNGKey(0)))
        model = ResGNN(device_laplacian(L, fmt="banded", use_pallas=False,
                                        device="cpu"), **kw, fourier_u=U)
        x = np.random.default_rng(6).normal(size=(2, 144, 6)).astype(
            np.float32)
        int8 = filt == "chebyshev"
        got, want, compiled = _export_both(
            tmp_path, model, convert.resgnn_params_from_jax(params_j),
            model_j, params_j, x, int8)
        xt = torch.from_numpy(x)
        y, y_j = got(xt), np.asarray(want(jnp.asarray(x)))
        if int8:
            _int8_close(y.numpy(), y_j)
            assert torch.equal(y, compiled(xt))
        else:
            np.testing.assert_allclose(y.numpy(), y_j, rtol=1e-4, atol=1e-4)
            assert float((y - compiled(xt)).abs().max()) <= 1e-6 * float(
                y.abs().max())


class TestArtifact:
    def test_files_and_no_baked_tables(self, city, tmp_path):
        """The directory holds JAX's three parts (the program as
        ``model.pt2``), and the program carries no operator table or
        weight as a constant: its constants are scalars."""
        L, x = city
        model, params, *_ = _node_classifiers(L, "dkw")
        d = str(tmp_path / "a")
        export_serving(model, params, torch.from_numpy(x), d)
        assert sorted(os.listdir(d)) == ["leaves.npz", "meta.json",
                                         "model.pt2"]
        program = torch.export.load(os.path.join(d, "model.pt2"))
        assert all(t.numel() <= 1 for t in program.constants.values())
        assert not program.state_dict
        names = {str(n.target) for n in program.graph.nodes
                 if n.op == "call_function"}
        assert "cnn_graph_torch.band_rows.default" in names

    def test_int8_meta_reflects_actual_conversion(self, city, tmp_path):
        """``int8`` is what the artifact computes in: true where an
        operator was converted, false for an all-float request and for a
        model with no operator to convert (JAX's
        ``test_int8_meta_reflects_actual_conversion``)."""
        L, x = city
        model, params, *_ = _node_classifiers(L, "dense")
        xt = torch.from_numpy(x)
        for int8, want in ((True, (True, True, 1)),
                           (False, (False, False, 0))):
            d = str(tmp_path / str(int8))
            export_serving(model, params, xt, d, int8=int8)
            meta = load_serving(d).meta
            assert (meta["int8"], meta["int8_requested"],
                    meta["quantized_operators"]) == want
            assert meta["platforms"] == ["cpu"]
            assert meta["model"] == "NodeClassifier"
        lstm = PerNodeLSTM(5, 3, num_hidden=4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        xs = torch.from_numpy(np.random.default_rng(1).normal(
            size=(2, 5, 6)).astype(np.float32))
        d = str(tmp_path / "lstm")
        export_serving(lstm, lstm.param_tree(), xs, d, int8=True)
        ls = load_serving(d)
        assert (ls.meta["int8"], ls.meta["int8_requested"],
                ls.meta["quantized_operators"]) == (False, True, 0)
        with torch.no_grad():
            want = lstm.apply(lstm.param_tree(), xs)
        assert torch.equal(ls(xs), want)

    def test_platforms_name_the_device_only(self, city, tmp_path):
        L, x = city
        model, params, *_ = _node_classifiers(L, "dense")
        xt = torch.from_numpy(x)
        export_serving(model, params, xt, str(tmp_path / "ok"),
                       platforms=["cpu"])
        for platforms in (["cuda"], ["cpu", "cuda"]):
            with pytest.raises(ValueError, match="platforms"):
                export_serving(model, params, xt, str(tmp_path / "no"),
                               platforms=platforms)

    def test_input_spec_is_enforced(self, city, tmp_path):
        L, x = city
        model, params, *_ = _node_classifiers(L, "dense")
        d = str(tmp_path / "a")
        export_serving(model, params, torch.from_numpy(x), d)
        ls = load_serving(d)
        assert ls.input_spec.shape == x.shape
        with pytest.raises(ValueError, match="serving spec"):
            ls(torch.from_numpy(x[:-1]))
        with pytest.raises(ValueError, match="serving spec"):
            ls(torch.from_numpy(x).double())

    def test_loads_and_serves_in_a_fresh_process(self, city, tmp_path):
        """From the directory alone: a new interpreter that imports no
        model code loads the artifact through the command line and
        serves it, with the same logits."""
        L, x = city
        model, params, *_ = _node_classifiers(L, "dkw")
        xt = torch.from_numpy(x)
        d = str(tmp_path / "a")
        export_serving(model, params, xt, d)
        np.save(tmp_path / "x.npy", x)
        proc = subprocess.run(
            [sys.executable, "-m", "cnn_graph_tpu_torch.serve", d,
             str(tmp_path / "x.npy"), "--out", str(tmp_path / "out")],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        assert rec["device"] == "cpu" and rec["requests"] == 1
        assert rec["launches"] == {}  # the CPU runs the plain versions
        got = np.load(tmp_path / "out" / "out_0.npy")
        assert np.array_equal(got, compile_serving(model, params, xt)(
            xt).numpy())


# ------------------------------------------------------------ custom ops


def _band_case(layout, dtype, form):
    """Arguments of ``band_rows`` for a small operator in ``layout``."""
    L, _ = graphs.city_graph(12, k=8, seed=0)
    op = device_laplacian(L, device="cpu", **PORT_OPS[layout],
                          rows_per_step=1)
    if dtype == "int8":
        op = quantize_banded(op, sample_x=3.0)
    elif dtype == "bf16":
        op = device_laplacian(L, device="cpu", dtype=torch.bfloat16,
                              rows_per_step=1, **PORT_OPS[layout])
    gen = torch.Generator().manual_seed(0)
    x, x0, c = (torch.randn(op.m_padded, 5, generator=gen)
                for _ in range(3))
    scale = None
    if dtype == "int8":
        x, x0, c = op.quantize(x), op.quantize(x0), None
        scale = op.band_scale
    else:
        x, x0, c = (t.to(op.compute_dtype) for t in (x, x0, c))
    if layout == "dkw":
        bands, sched, levels = list(op.bands_dkw), op.sched_dkw, op.levels
    elif layout == "ragged":
        bands, sched, levels = [op.band], op.sched, op.levels
    else:
        bands, sched, levels = [op.band], None, [op.band.shape[1]]
    x0 = None if form == "spmm" else x0
    c = c if form == "hop_c" else None
    return (bands, op.base, sched, op.nz_rowptr, op.nz_win, x, x0, c,
            layout, list(levels), op.rows_per_step, scale)


BAND_FORMS = [(lay, dt, form) for lay in ("dkw", "uniform", "ragged")
              for dt in ("f32", "bf16", "int8")
              for form in ("spmm", "hop", "hop_c")
              if not (dt == "int8" and form == "hop_c")]


class TestCustomOps:
    @pytest.mark.parametrize("layout,dtype,form", BAND_FORMS)
    def test_band_rows(self, layout, dtype, form):
        args = _band_case(layout, dtype, form)
        torch.library.opcheck(torch.ops.cnn_graph_torch.band_rows, args)
        y = torch.ops.cnn_graph_torch.band_rows(*args)
        assert y.dtype == args[5].dtype  # int8 in, int8 out

    @pytest.mark.parametrize("layout,dtype", [
        (lay, dt) for lay in ("dkw", "uniform", "ragged")
        for dt in ("f32", "int8")])
    def test_band_rows_in_place(self, layout, dtype):
        args = list(_band_case(layout, dtype, "hop"))
        want = torch.ops.cnn_graph_torch.band_rows(*args)
        torch.library.opcheck(torch.ops.cnn_graph_torch.band_rows_,
                              tuple(args))
        buf = args[6].clone()
        args[6] = buf
        torch.ops.cnn_graph_torch.band_rows_(*args)
        assert torch.equal(buf, want)

    @pytest.mark.parametrize("route,dtype,form", [
        (r, dt, f) for r in ("K4", "K7", "K8", "K9")
        for dt in ("f32", "bf16", "int8") for f in ("spmm", "hop")])
    def test_bsr_rows(self, route, dtype, form):
        L, _ = graphs.city_graph(12, k=8, seed=0)
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        op = device_laplacian(L, fmt="bsr", use_pallas=True, device="cpu",
                              dtype=dt, col_stream=route == "K4")
        gen = torch.Generator().manual_seed(1)
        x, x0 = (torch.randn(op.m_padded, 5, generator=gen)
                 for _ in range(2))
        scale = None
        if dtype == "int8":
            op = quantize_block_sparse(op, sample_x=3.0)
            x, x0, scale = op.quantize(x), op.quantize(x0), op.block_scale
        else:
            x, x0 = x.to(dt), x0.to(dt)
        args = (op.blocks, op.nz_rowptr, op.nz_cols, op.nz_pos, x,
                None if form == "spmm" else x0, route, scale)
        torch.library.opcheck(torch.ops.cnn_graph_torch.bsr_rows, args)
        assert torch.ops.cnn_graph_torch.bsr_rows(*args).dtype == x.dtype

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("op_name", ["cheby_conv", "cheby_dw"])
    def test_cheby(self, op_name, dtype):
        W = gc.knn_graph(gc.grid(6), k=4)
        op = device_laplacian(graphs.laplacian(W, normalized=True),
                              fmt="dense", dtype=dtype, device="cpu")
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(3, op.m, 4, generator=gen)
        if op_name == "cheby_conv":
            args = (op.mat, x, torch.randn(5, 4, 6, generator=gen))
        else:
            args = (op.mat, x, torch.randn(3, op.m, 6, generator=gen), 5)
        fn = getattr(torch.ops.cnn_graph_torch, op_name)
        torch.library.opcheck(fn, args)
        y = fn(*args)
        assert y.shape == ((3, op.m, 6) if op_name == "cheby_conv"
                           else (5, 4, 6))

    def test_cpu_calls_count_nothing(self, city):
        """The counts are the kernels': the CPU runs the plain versions
        and counts no launch, through the wrappers or the ops."""
        L, x = city
        library.reset_launch_counts()
        for layout in ("dkw", "uniform", "ragged", "bsr"):
            model, params, *_ = _node_classifiers(L, layout)
            compile_serving(model, params, torch.from_numpy(x))(
                torch.from_numpy(x))
        assert not any(library.launch_counts().values())
        assert not any(band.banded_dkw.form_launches.values())
        assert not any(bsr.bsr_csr.route_launches.values())
