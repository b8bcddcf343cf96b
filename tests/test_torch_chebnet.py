"""The ChebNet slice on the CPU against the JAX package, on the same NumPy
inputs: the MNIST grid graph (``knn``'s dense route, ``grid``,
``coarsen``, ``perm_data``), the synthetic digits and their
preprocessing, ChebNet's logits, loss and gradients with converted
weights on the real coarsened grid graphs, a 3-step adam run against
``optax.adam``, and ``compile_serving`` on ChebNet.

The port's operators are built with ``use_pallas=True``, so layer 1 takes
the fused route (here the plain versions of K2 and K3); the JAX model's
with ``use_pallas=False``, the same function (tests/test_pallas_cheby.py
:44-79 holds the two routes together within ``atol=1e-4``).  Dropout
stays off in the parity tests: its bits are not ``jax.random``'s.

Tolerances: graphs, permutations and data exact; logits ``rtol=atol=
1e-4`` and loss ``rtol=1e-5`` (f32 sums in another order); gradients
``rtol=1e-4, atol=1e-6``; adam losses within rel 1e-4 of optax's."""

import dataclasses
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cnn_graph_tpu.data.mnist import mnist_graph_data as jax_mnist_graph_data
from cnn_graph_tpu.data.mnist import synthetic_mnist as jax_synthetic_mnist
from cnn_graph_tpu.graphs import coarsening as jax_coarsening
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import ChebNet as JaxChebNet
from cnn_graph_tpu.models.common import (
    quantize_model_operators as jax_quantize_model_operators,
)
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import chebnet_params_from_jax
from cnn_graph_tpu_torch.data import mnist_graph_data, synthetic_mnist
from cnn_graph_tpu_torch.models import ChebNet
from cnn_graph_tpu_torch.models.common import (
    map_operators,
    tree_leaves,
    tree_map,
    trunc_normal,
)
from cnn_graph_tpu_torch.ops import (
    DenseLaplacian,
    QuantDenseLaplacian,
    device_laplacian,
)
from cnn_graph_tpu_torch.serve import compile_serving
from cnn_graph_tpu_torch.train import train_classifier

ARCH = dict(F=[32, 64], K=[3, 3], p=[4, 4], M=[512, 10])


def _chip_smoke():
    """chip_smoke.py as a module, for its phase-8 configuration."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_sparse(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(a - b).max() == 0


@pytest.fixture(scope="module")
def mnist():
    """12 synthetic digits through both packages' preprocessing, and the
    two packages' f32 dense operators per level."""
    splits = synthetic_mnist(8, 2, 2, seed=3)
    data, Ls, perm = mnist_graph_data(splits)
    ops = [device_laplacian(L, fmt="dense", use_pallas=True,
                            device="cpu") for L in Ls]
    ops_j = [jax_device_laplacian(L, fmt="dense", use_pallas=False)
             for L in Ls]
    return data, Ls, perm, ops, ops_j


def _models(mnist, **kw):
    *_, ops, ops_j = mnist
    model_j = JaxChebNet(ops_j, **ARCH, **kw)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(1)))
    return ChebNet(ops, **ARCH, **kw), model_j, params_j


class TestMnistGraph:
    def test_grid_and_knn_graph_match_jax_exactly(self):
        """The 28x28 8-NN grid graph: ``knn``'s dense route breaks the
        grid's distance ties as the JAX package does (a tree query does
        not, and gave 16 other entries of W)."""
        z = graphs.grid(28)
        np.testing.assert_array_equal(z, gc.grid(28))
        dist, idx = graphs.knn(z, k=8)
        dist_j, idx_j = gc.knn(z, k=8)
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(dist, dist_j)
        _same_sparse(graphs.knn_graph(z, k=8), gc.knn_graph(z, k=8))

    def test_coarsen_matches_jax_exactly(self):
        W = gc.knn_graph(gc.grid(28), k=8)
        got, perm = graphs.coarsen(W, levels=4, seed=2017)
        want, perm_j = jax_coarsening.coarsen(W, levels=4, seed=2017,
                                              verbose=False)
        assert [g.shape[0] for g in got] == [976, 488, 244, 122, 61]
        for a, b in zip(got, want):
            _same_sparse(a, b)
        assert perm == perm_j
        x = np.random.default_rng(4).normal(size=(3, 784, 2))
        np.testing.assert_array_equal(graphs.perm_data(x, perm),
                                      jax_coarsening.perm_data(x, perm))
        np.testing.assert_array_equal(graphs.perm_data(x[..., 0], perm),
                                      jax_coarsening.perm_data(x[..., 0],
                                                               perm))

    def test_graclus_without_seed_still_pairs(self):
        W = gc.knn_graph(gc.grid(8), k=4)
        graphs_, parents = graphs.graclus(W, levels=2, seed=None)
        assert len(graphs_) == 3 and len(parents) == 2
        assert graphs.perm_data(np.ones((1, 64)), None).shape == (1, 64)

    def test_data_and_preprocessing_match_jax(self, mnist):
        data, Ls, perm, *_ = mnist
        splits_j = jax_synthetic_mnist(8, 2, 2, seed=3)
        for k, v in synthetic_mnist(8, 2, 2, seed=3).items():
            np.testing.assert_array_equal(v, splits_j[k])
        data_j, Ls_j, perm_j = jax_mnist_graph_data(splits_j)
        assert perm == perm_j
        for k in data:
            np.testing.assert_array_equal(data[k], data_j[k])
        for a, b in zip(Ls, Ls_j):
            _same_sparse(a, b)
        # edge_noise: replace_random_edges draws the same random edges.
        noisy, Ls_n, perm_n = mnist_graph_data(splits_j, edge_noise=0.1)
        noisy_j, Ls_nj, perm_nj = jax_mnist_graph_data(splits_j,
                                                       edge_noise=0.1)
        assert perm_n == perm_nj and perm_n != perm
        for a, b in zip(Ls_n, Ls_nj):
            _same_sparse(a, b)
        np.testing.assert_array_equal(noisy["train_data"],
                                      noisy_j["train_data"])


class TestChebNet:
    @pytest.mark.parametrize("brelu,pool", [("b1relu", "max"),
                                            ("b2relu", "average"),
                                            ("b1tanh", "max")])
    def test_logits_loss_and_gradients_match_jax(self, mnist, brelu, pool):
        data, *_ = mnist
        x, y = data["train_data"][:4], data["train_labels"][:4]
        model, model_j, params_j = _models(mnist, brelu=brelu, pool=pool,
                                           regularization=5e-4)
        params = chebnet_params_from_jax(params_j)
        with torch.no_grad():
            logits = model.apply(params, torch.from_numpy(x))
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(model_j.apply(params_j,
                                                     jnp.asarray(x))),
            rtol=1e-4, atol=1e-4)
        loss_j, grads_j = jax.value_and_grad(model_j.loss)(
            params_j, jnp.asarray(x), jnp.asarray(y))
        params = tree_map(torch.Tensor.requires_grad_, params)
        loss = model.loss(params, torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                                   rtol=1e-5)
        for group in ("gconv", "fc"):
            for layer, layer_j in zip(params[group], grads_j[group]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(
                        layer[k].grad.numpy(), np.asarray(layer_j[k]),
                        rtol=1e-4, atol=1e-6)

    def test_parameter_layout_and_levels(self, mnist):
        *_, ops, _ = mnist
        model, model_j, params_j = _models(mnist)
        assert [o.m for o in model.operators] == [976, 244]
        shapes = tree_map(lambda t: tuple(t.shape), model.param_tree())
        assert shapes == jax.tree.map(lambda a: a.shape, params_j,
                                      is_leaf=lambda a: isinstance(
                                          a, np.ndarray))
        assert bool((model.param_tree()["fc"][0]["b"] == 0.1).all())
        x = torch.zeros(2, 976)
        with torch.no_grad():
            torch.testing.assert_close(model(x), model.apply(
                model.param_tree(), x))
            assert model.predict_classes(model.param_tree(), x).shape == (2,)

    def test_trunc_normal_is_the_same_under_every_torch_version(self):
        """The seeded initializer draws one uniform per entry and maps it
        through the inverse CDF: these values came out of torch 2.11 and
        2.13 alike (``nn.init.trunc_normal_`` gives other weights under
        each), so a model made from a seed is the same model on both."""
        t = trunc_normal((6,), generator=torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(t.numpy(), np.float32(
            [-0.000895651348400861, 0.06935495883226395,
             -0.12415473163127899, -0.10417095571756363,
             -0.047839339822530746, 0.03265029564499855]))
        big = trunc_normal((100_000,), std=0.5,
                           generator=torch.Generator().manual_seed(1))
        assert float(big.abs().max()) <= 1.0
        # std of N(0, 0.5) truncated at 2 std: 0.5 * 0.8796
        assert abs(float(big.std()) - 0.5 * 0.8796) < 3e-3

    def test_adam_losses_match_optax(self, mnist):
        """3 adam steps over batches of 4 (the port's wrap-around batch
        order, replayed on the JAX side) against ``optax.adam``."""
        data, *_ = mnist
        x, y = data["train_data"], data["train_labels"]
        model, model_j, params_j = _models(mnist, regularization=5e-4)
        opt = optax.adam(1e-3)
        state = opt.init(params_j)
        p, want = params_j, []
        for step in range(3):
            rows = np.arange(step * 4, (step + 1) * 4) % len(x)
            loss, g = jax.value_and_grad(model_j.loss)(
                p, jnp.asarray(x[rows]), jnp.asarray(y[rows]))
            up, state = opt.update(g, state, p)
            p = optax.apply_updates(p, up)
            want.append(float(loss))
        params = chebnet_params_from_jax(params_j)
        trained, losses = train_classifier(
            model, params, torch.from_numpy(x), torch.from_numpy(y),
            batch_size=4, steps=3, learning_rate=1e-3)
        np.testing.assert_allclose(losses.numpy(), want, rtol=1e-4)
        # Adam moves an entry whose gradient is near zero by about +-lr a
        # step, in a direction set by that gradient's rounding: the
        # trained weights agree within the 3 steps' total, 3 * lr.
        for a, b in zip(tree_leaves(trained),
                        [layer[k] for group in ("gconv", "fc")
                         for layer in p[group] for k in ("w", "b")]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=3e-3)

    def test_dropout_only_in_training(self, mnist):
        data, *_ = mnist
        model, _, params_j = _models(mnist, dropout=0.5)
        params = chebnet_params_from_jax(params_j)
        x = torch.from_numpy(data["train_data"][:4])
        with torch.no_grad():
            ev = model.apply(params, x)
            tr = [model.apply(params, x, train=True,
                              generator=torch.Generator().manual_seed(6))
                  for _ in range(2)]
        torch.testing.assert_close(tr[0], tr[1], rtol=0, atol=0)
        assert not torch.allclose(tr[0], ev)

    @pytest.mark.parametrize("filt", ["fourier", "spline", "lanczos"])
    def test_unported_filters_raise(self, mnist, filt):
        """The three filters are ported (tests/test_torch_filters.py holds
        them against JAX): what still raises is a filter that needs the
        host Laplacians built without them, or an unknown filter."""
        _, Ls, _, ops, _ = mnist
        if filt == "lanczos":
            assert ChebNet(ops, **ARCH, filter=filt).filter == filt
        else:
            with pytest.raises(ValueError, match="laplacians"):
                ChebNet(ops, **ARCH, filter=filt)
            assert ChebNet(ops, **ARCH, laplacians=Ls, filter=filt,
                           spline_degree=2).filter == filt
        with pytest.raises(ValueError, match="unknown filter"):
            ChebNet(ops, **ARCH, filter=filt + "2")

    def test_bad_pooling_raises(self, mnist):
        *_, ops, _ = mnist
        with pytest.raises(ValueError, match="powers of 2"):
            ChebNet(ops, F=[32], K=[3], p=[3], M=[10])
        with pytest.raises(ValueError, match="levels"):
            ChebNet(ops[:2], F=[32, 64], K=[3, 3], p=[4, 4], M=[10])


class TestServing:
    def test_compile_serving_chebnet(self, mnist):
        """The handle moves every level's operator and the whole
        ``{"gconv", "fc"}`` tree; its logits are the model's."""
        data, *_ = mnist
        model, _, params_j = _models(mnist)
        params = chebnet_params_from_jax(params_j)
        x = torch.from_numpy(data["test_data"][:2])
        serving = compile_serving(model, params, x, int8=False)
        assert all(isinstance(o, DenseLaplacian) and o.use_fused
                   for o in serving.model.operators)
        assert serving.model is not model
        with torch.no_grad():
            want = model.apply(params, x)
        torch.testing.assert_close(serving(x), want, rtol=0, atol=0)
        with pytest.raises(ValueError, match="serving spec"):
            serving(x[:1])

    def test_int8_on_dense_operators_raises(self, mnist):
        """Dense operators have their int8 twin now: ``int8=True`` serves
        them quantized.  What still raises is an operator with no twin,
        rather than serve it unquantized."""
        data, *_ = mnist
        model, *_ = _models(mnist)
        x = torch.from_numpy(data["test_data"][:2])
        serving = compile_serving(model, model.param_tree(), x, int8=True)
        assert all(isinstance(o, QuantDenseLaplacian)
                   for o in serving.model.operators)
        odd = map_operators(model, lambda o: types.SimpleNamespace(m=o.m))
        with pytest.raises(NotImplementedError, match="SimpleNamespace"):
            compile_serving(odd, model.param_tree(), x, int8=True)

    def test_default_serving_is_int8_and_matches_jax(self):
        """The paper's ChebNet, small: ``grid(12)``, 8-NN, 2 coarsening
        levels, F=[4, 8], K=[5, 5].  ``compile_serving`` with its default
        arguments quantizes every dense operator; the logits equal JAX's
        ``quantize_model_operators`` ChebNet on the same converted
        weights within 1e-4 of their max (the int8 carries are the same
        bits; the f32 taps sum in another order)."""
        W = gc.knn_graph(gc.grid(12), k=8)
        Ws, perm = graphs.coarsen(W, levels=2, seed=2017)
        Ls = [graphs.laplacian(A, normalized=True) for A in Ws]
        arch = dict(F=[4, 8], K=[5, 5], p=[2, 2], M=[16, 10])
        model_j = JaxChebNet([jax_device_laplacian(L, fmt="dense")
                              for L in Ls], **arch)
        params_j = jax.tree.map(np.asarray,
                                model_j.init(jax.random.PRNGKey(3)))
        model = ChebNet([device_laplacian(L, fmt="dense", use_pallas=True,
                                          device="cpu")
                         for L in Ls], **arch)
        rng = np.random.default_rng(11)
        x = graphs.perm_data(rng.normal(size=(6, 144)), perm).astype(
            np.float32)
        serving = compile_serving(model, chebnet_params_from_jax(params_j),
                                  torch.from_numpy(x))
        assert all(isinstance(o, QuantDenseLaplacian)
                   for o in serving.model.operators)
        got = serving(torch.from_numpy(x)).numpy()
        qmodel_j = jax_quantize_model_operators(
            model_j, sample_x=float(np.abs(x).max()))
        want = np.asarray(qmodel_j.apply(params_j, jnp.asarray(x)))
        assert got.shape == want.shape == (6, 10)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))

    def test_phase8_int8_agreement_matches_jax(self):
        """chip_smoke.py phase 8's int8 request at its full size: the
        paper's MNIST ChebNet (F=[32, 64], K=[25, 25]) with its seeded
        weights, 4 requests of 100 digits.  The port's int8 and f32
        logits equal JAX's (``quantize_model_operators`` and the f32
        model, on the same weights) within 1e-4 of their max, and the
        int8 argmax agrees with the f32 one on the same rows in both:
        ``CHEB_INT8_AGREEMENT`` of them, the figure the chip run is held
        to."""
        cs = _chip_smoke()
        splits = synthetic_mnist(n_train=cs.CHEB_B, n_val=0,
                                 n_test=cs.N_REQUESTS * cs.CHEB_B,
                                 seed=cs.CHEB_SEED)
        data, Ls, _ = mnist_graph_data(splits, seed=cs.CHEB_SEED)
        model, params = cs.chebnet_model(Ls, torch.float32,
                                         torch.device("cpu"))
        reqs = list(torch.from_numpy(data["test_data"]).split(cs.CHEB_B))
        f32 = compile_serving(model, params, reqs[0], int8=False)
        q8 = compile_serving(model, params, reqs[0])
        got = [np.concatenate([s(x).numpy() for x in reqs]) for s in (f32,
                                                                      q8)]
        model_j = JaxChebNet([jax_device_laplacian(L, fmt="dense")
                              for L in Ls], **cs.CHEB)
        params_j = tree_map(lambda t: t.detach().numpy(), params)
        qmodel_j = jax_quantize_model_operators(
            model_j, sample_x=float(reqs[0].abs().max()))
        want = [np.concatenate([np.asarray(m.apply(params_j, jnp.asarray(
            x.numpy()))) for x in reqs]) for m in (model_j, qmodel_j)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * float(np.abs(w).max()))
        agree = (got[0].argmax(1) == got[1].argmax(1)).mean()
        agree_j = (want[0].argmax(1) == want[1].argmax(1)).mean()
        assert agree == agree_j == pytest.approx(cs.CHEB_INT8_AGREEMENT,
                                                 abs=1e-12)

    def test_unfused_operators_serve_the_same_logits(self, mnist):
        """``use_pallas=False`` operators take the stacked path in every
        layer: the same function."""
        data, *_ = mnist
        model, _, params_j = _models(mnist)
        params = chebnet_params_from_jax(params_j)
        x = torch.from_numpy(data["test_data"][:2])
        plain = compile_serving(model, params, x, int8=False)
        plain.model.operators = [dataclasses.replace(o, use_fused=False)
                                 for o in plain.model.operators]
        served = compile_serving(model, params, x, int8=False)
        torch.testing.assert_close(served(x), plain(x), rtol=1e-4, atol=1e-4)
