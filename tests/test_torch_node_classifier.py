"""The serving slice end to end on the CPU against the JAX package: the
operator choice, ``cheby_conv``, ``NodeClassifier`` with converted
weights, and int8 serving through ``compile_serving``; plus the port's
guards (no JAX import, no silent fallback for unported formats).

Tolerances: float logits ``rtol=atol=1e-4`` (f32 sums in another order
over the hops and taps); int8 logits ``atol=1e-4`` with the int8 carries
themselves bit-exact."""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.models.common import (
    quantize_model_operators as jax_quantize_model_operators,
)
from cnn_graph_tpu.ops import cheby_conv as jax_cheby_conv
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops.laplacian import BandedLaplacian as JaxBanded
from cnn_graph_tpu.ops.laplacian import BlockSparseLaplacian
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import node_classifier_params_from_jax
from cnn_graph_tpu_torch.models import ChebNet, NodeClassifier
from cnn_graph_tpu_torch.models.common import quantize_model_operators
from cnn_graph_tpu_torch.ops import (
    BandedLaplacian,
    DenseLaplacian,
    cheby_conv,
    device_laplacian,
)
from cnn_graph_tpu_torch.serve import compile_serving

FIN, CLASSES, K = 16, 4, 5


@pytest.fixture(scope="module")
def city():
    """9,216-node city graph, features from a NumPy seed, and the two
    packages' operators chosen by fmt="auto" (banded, f32 band); the
    port's with ``use_pallas`` so that its products run K1's plain
    version, as on the card."""
    L, _ = graphs.city_graph(96, k=8, seed=0)
    op = device_laplacian(L, fmt="auto", use_pallas=True, device="cpu")
    op_j = jax_device_laplacian(L, fmt="auto")
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(op.m, FIN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, op.m)
    mask = rng.random(op.m) < 0.3
    return op, op_j, feats, labels, mask


def _models(op, op_j, hidden):
    model_j = JaxNodeClassifier(op_j, FIN, CLASSES, hidden=hidden, K=K)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(0)))
    model = NodeClassifier(op, FIN, CLASSES, hidden=hidden, K=K,
                           generator=torch.Generator().manual_seed(0))
    return model, model_j, node_classifier_params_from_jax(params_j), \
        params_j


def test_auto_format_matches_jax(city):
    op, op_j, *_ = city
    assert isinstance(op, BandedLaplacian) and isinstance(op_j, JaxBanded)
    assert (op.m, op.nnz) == (op_j.m, op_j.nnz)


def test_converted_params_keep_layout():
    params_j = {"convs": [{"w": np.ones((5, 16, 8), np.float32),
                           "b": np.zeros(8, np.float32)}]}
    params = node_classifier_params_from_jax(params_j)
    assert params["convs"][0]["w"].shape == (5, 16, 8)
    assert params["convs"][0]["b"].dtype == torch.float32


class TestFloatSlice:
    def test_logits_match_jax(self, city):
        op, op_j, feats, *_ = city
        model, model_j, params, params_j = _models(op, op_j, hidden=[8])
        want = np.asarray(model_j.apply(params_j, jnp.asarray(feats)))
        with torch.inference_mode():
            got = model.apply(params, torch.from_numpy(feats)).numpy()
        assert got.shape == (op.m, CLASSES)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_loss_and_accuracy_match_jax(self, city):
        op, op_j, feats, labels, mask = city
        model, model_j, params, params_j = _models(op, op_j, hidden=[8])
        args_j = (params_j, jnp.asarray(feats), jnp.asarray(labels),
                  jnp.asarray(mask))
        args = (params, torch.from_numpy(feats), torch.from_numpy(labels),
                torch.from_numpy(mask))
        with torch.inference_mode():
            np.testing.assert_allclose(float(model.loss(*args)),
                                       float(model_j.loss(*args_j)),
                                       rtol=1e-5)
            assert float(model.accuracy(*args)) == pytest.approx(
                float(model_j.accuracy(*args_j)), abs=1e-6)

    def test_forward_uses_module_parameters(self, city):
        op, _, feats, *_ = city
        model = NodeClassifier(op, FIN, CLASSES, hidden=[], K=3,
                               generator=torch.Generator().manual_seed(1))
        x = torch.from_numpy(feats)
        with torch.no_grad():
            torch.testing.assert_close(model(x),
                                       model.apply(model.param_tree(), x))
        w = model.weights[0].detach()
        assert w.shape == (3, FIN, CLASSES) and float(w.abs().max()) <= 0.2

    def test_dense_conv_matches_jax(self):
        L, _ = graphs.city_graph(30, k=8, seed=2)  # 900 nodes: auto -> dense
        op = device_laplacian(L, device="cpu")
        op_j = jax_device_laplacian(L)
        assert isinstance(op, DenseLaplacian)
        rng = np.random.default_rng(12)
        x = rng.normal(size=(2, op.m, 6)).astype(np.float32)
        w = (rng.normal(size=(K, 6, 3)) * 0.3).astype(np.float32)
        got = cheby_conv(torch.from_numpy(x), op, torch.from_numpy(w))
        want = np.asarray(jax_cheby_conv(jnp.asarray(x), op_j,
                                         jnp.asarray(w)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


class TestInt8Serving:
    def test_served_logits_match_jax(self, city):
        op, op_j, feats, *_ = city
        model, model_j, params, params_j = _models(op, op_j, hidden=[])
        x = torch.from_numpy(feats)
        serving = compile_serving(model, params, x, int8=True)
        got = serving(x).numpy()
        qmodel_j = jax_quantize_model_operators(
            model_j, sample_x=float(np.abs(feats).max()))
        want = np.asarray(qmodel_j.apply(params_j, jnp.asarray(feats)))
        assert got.shape == (op.m, CLASSES)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_int8_carries_bit_exact(self, city):
        """The K carries of the int8 recurrence, as cheby_conv runs it."""
        import dataclasses

        op, op_j, feats, *_ = city
        q = quantize_model_operators(
            NodeClassifier(op, FIN, CLASSES, hidden=[], K=K)).op
        q_j = dataclasses.replace(
            jax_quantize_model_operators(
                JaxNodeClassifier(op_j, FIN, CLASSES, hidden=[], K=K)).op,
            use_pallas=False)
        xt = np.zeros((op.m_padded, FIN), np.float32)
        xt[: op.m] = feats
        s = float(np.abs(xt).max()) * (q.headroom / 127.0)
        a, a_j = q.quantize(torch.from_numpy(xt), s), q_j.quantize(
            jnp.asarray(xt), s)
        b, b_j = q.spmm_q(a), q_j.spmm_q(a_j)
        for _ in range(K - 2):
            np.testing.assert_array_equal(b.numpy(), np.asarray(b_j))
            a, b = b, q.cheby_hop_q(b, a)
            a_j, b_j = b_j, q_j.cheby_hop_q(b_j, a_j)
        np.testing.assert_array_equal(b.numpy(), np.asarray(b_j))

    def test_input_spec_is_enforced(self, city):
        op, _, feats, *_ = city
        model = NodeClassifier(op, FIN, CLASSES, hidden=[], K=2)
        x = torch.from_numpy(feats)
        serving = compile_serving(model, model.param_tree(), x, int8=False)
        assert serving.input_spec.shape == tuple(x.shape)
        with pytest.raises(ValueError, match="serving spec"):
            serving(x[:-1])
        with pytest.raises(ValueError, match="serving spec"):
            serving(x.double())


class TestGuards:
    def test_port_never_imports_jax(self):
        """Neither the port nor chip_smoke.py pulls in JAX, the JAX
        package, scikit-learn, optax, Orbax, statsmodels, stldecompose or
        rpy2: the card's machine has none of them."""
        code = (
            "import sys, cnn_graph_tpu_torch, cnn_graph_tpu_torch.graphs, "
            "cnn_graph_tpu_torch.graphs.construction, "
            "cnn_graph_tpu_torch.graphs.coarsening, "
            "cnn_graph_tpu_torch.data, cnn_graph_tpu_torch.data.mnist, "
            "cnn_graph_tpu_torch.data.synthetic, "
            "cnn_graph_tpu_torch.data.stl, "
            "cnn_graph_tpu_torch.data.humantraffic, "
            "cnn_graph_tpu_torch.data.rdata, "
            "cnn_graph_tpu_torch.ops, cnn_graph_tpu_torch.ops.cheby, "
            "cnn_graph_tpu_torch.ops.band, cnn_graph_tpu_torch.ops.laplacian, "
            "cnn_graph_tpu_torch.ops.bsr, cnn_graph_tpu_torch.ops.packing, "
            "cnn_graph_tpu_torch.ops.library, "
            "cnn_graph_tpu_torch.ops.pooling, cnn_graph_tpu_torch.models, "
            "cnn_graph_tpu_torch.models.chebnet, "
            "cnn_graph_tpu_torch.models.common, "
            "cnn_graph_tpu_torch.models.resgnn, "
            "cnn_graph_tpu_torch.models.gconv_lstm, "
            "cnn_graph_tpu_torch.models.forecasting, "
            "cnn_graph_tpu_torch.models.gconv_rnn, "
            "cnn_graph_tpu_torch.models.node_lstm, "
            "cnn_graph_tpu_torch.ops.filters, "
            "cnn_graph_tpu_torch.serve, cnn_graph_tpu_torch.convert, "
            "cnn_graph_tpu_torch.train, "
            "cnn_graph_tpu_torch.train.classification, "
            "cnn_graph_tpu_torch.train.trainer, "
            "cnn_graph_tpu_torch.train.optim, "
            "cnn_graph_tpu_torch.train.checkpoint, "
            "cnn_graph_tpu_torch.data.text, "
            "cnn_graph_tpu_torch.data.stop_words, "
            "cnn_graph_tpu_torch.experiments, "
            "cnn_graph_tpu_torch.experiments.mnist, "
            "cnn_graph_tpu_torch.experiments.text20news, "
            "cnn_graph_tpu_torch.experiments.rcv1, "
            "cnn_graph_tpu_torch.experiments.humanflow, "
            "cnn_graph_tpu_torch.experiments.node_classification, "
            "cnn_graph_tpu_torch.experiments.usage_demo, "
            "cnn_graph_tpu_torch.experiments.gconv_sweep, "
            "cnn_graph_tpu_torch.experiments.multichip, "
            "cnn_graph_tpu_torch.native, "
            "cnn_graph_tpu_torch.utils, cnn_graph_tpu_torch.utils.profiling, "
            "cnn_graph_tpu_torch.utils.probes, "
            "cnn_graph_tpu_torch.utils.metrics, "
            "cnn_graph_tpu_torch.utils.logging, "
            "cnn_graph_tpu_torch.utils.harness, "
            "cnn_graph_tpu_torch.utils.notify, "
            "cnn_graph_tpu_torch.utils.plots, "
            "cnn_graph_tpu_torch.parallel, "
            "cnn_graph_tpu_torch.parallel.mesh, "
            "cnn_graph_tpu_torch.parallel.node_sharded, "
            "cnn_graph_tpu_torch.parallel.halo, "
            "cnn_graph_tpu_torch.parallel.banded_halo, "
            "cnn_graph_tpu_torch.parallel.sparse_halo, "
            "cnn_graph_tpu_torch.parallel.dryrun, "
            "cnn_graph_tpu_torch._build, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cnn_graph_tpu', 'sklearn', 'optax', "
            "'orbax', 'statsmodels', 'stldecompose', 'rpy2')]\n"
            "assert not bad, bad\n"
        )
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr

    @pytest.mark.parametrize("fmt", ["bcoo"])
    def test_unported_formats_raise(self, fmt):
        """Every format of the JAX package is ported (``fmt`` builds its
        operator, tests/test_torch_bcoo.py); a format JAX does not have
        raises rather than falling back."""
        L, _ = graphs.city_graph(20, k=4, seed=0)
        op = device_laplacian(L, fmt=fmt, device="cpu")
        assert type(op).__name__ == "BCOOLaplacian"
        with pytest.raises(ValueError, match="unknown Laplacian format"):
            device_laplacian(L, fmt=fmt + "x", device="cpu")

    def test_auto_landing_on_bsr_builds_bsr(self):
        """A scattered (un-reordered) graph too wide for the band and over
        the dense budget: both packages pick BSR (tests/test_torch_bsr.py
        compares the layouts)."""
        z = np.random.default_rng(13).uniform(size=(5000, 2))
        L = graphs.laplacian(graphs.adjacency(
            *graphs.knn(z, k=8, algorithm="auto")))
        assert isinstance(
            jax_device_laplacian(L, use_pallas=False, dense_budget=1 << 20),
            BlockSparseLaplacian)
        op = device_laplacian(L, dense_budget=1 << 20, device="cpu")
        assert type(op).__name__ == "BlockSparseLaplacian"

    @pytest.mark.parametrize("model", ["node_classifier", "chebnet"])
    def test_models_follow_the_operator_device(self, model):
        """``device=None``: the weights live where the operator does (an
        operator on the meta device gives meta weights), drawn on the CPU
        from the caller's generator and moved, so that one seed gives the
        same weights on every device."""
        L, _ = graphs.city_graph(12, k=4, seed=0)

        def build(dev, **kw):
            op = device_laplacian(L, fmt="dense", device=dev)
            gen = torch.Generator().manual_seed(3)
            if model == "chebnet":
                return ChebNet([op], F=[4], K=[3], p=[1], M=[5],
                               generator=gen, **kw)
            return NodeClassifier(op, 4, 2, hidden=[3], K=3, generator=gen,
                                  **kw)

        meta = build("meta")
        assert {p.device.type for p in meta.parameters()} == {"meta"}
        cpu, asked = build("cpu"), build("meta", device="cpu")
        assert {p.device.type for p in cpu.parameters()} == {"cpu"}
        for a, b in zip(cpu.parameters(), asked.parameters()):
            assert torch.equal(a, b)

    def test_quantize_unported_format_raises(self):
        """The dense operator, once without a twin, quantizes now; an
        operator of a format with no twin still raises."""
        L, _ = graphs.city_graph(20, k=4, seed=0)
        model = NodeClassifier(device_laplacian(L, device="cpu"), 4, 2,
                               hidden=[], K=2)
        assert type(quantize_model_operators(model).op).__name__ == (
            "QuantDenseLaplacian")
        model.op = types.SimpleNamespace(m=L.shape[0])
        with pytest.raises(NotImplementedError, match="SimpleNamespace"):
            quantize_model_operators(model)
        with pytest.raises(NotImplementedError):
            compile_serving(model, model.param_tree(),
                            torch.zeros(L.shape[0], 4), int8=True)
