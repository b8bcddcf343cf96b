"""The training slice on the CPU against the JAX package, on the same
NumPy inputs: ``cheby_conv_banded``'s adjoint backward against
``jax.grad`` of the JAX one, the ``input_grad`` switch and its dx
contract, NodeClassifier loss and gradients with converted weights, a
5-step adam run against ``optax.adam``, and dropout on its own (its
bits are not ``jax.random``'s, so the parity tests keep it off).

Both packages' band products run their plain versions here: the port's
``banded_dkw_reference`` and the JAX operator's XLA fallback
(``use_pallas=False``), as tests/test_pallas_band.py runs the JAX conv.

Tolerances: conv dx and dW ``atol=2e-3, rtol=1e-4``, the bound of the
JAX package's own streaming-vs-autodiff test
(tests/test_pallas_band.py:542-545; f32 sums in another order over K
hops); model loss ``rtol=1e-5`` and parameter gradients ``rtol=1e-4,
atol=1e-6``; adam losses within rel 1e-4 of optax's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cnn_graph_tpu.models import NodeClassifier as JaxNodeClassifier
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.ops.filters import (
    cheby_conv_banded as jax_cheby_conv_banded,
)
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import node_classifier_params_from_jax
from cnn_graph_tpu_torch.models import NodeClassifier
from cnn_graph_tpu_torch.models.common import dropout
from cnn_graph_tpu_torch.ops import (
    BandedLaplacian,
    cheby_conv_banded,
    device_laplacian,
)
from cnn_graph_tpu_torch.train import train_node_classifier

G = 2
FIN, HIDDEN, CLASSES = 8, 8, 4


@pytest.fixture(scope="module")
def city():
    """The 96-side city graph (9,216 nodes) as both packages' f32 banded
    operators, and node data from a NumPy seed."""
    L, _ = graphs.city_graph(96, k=8, seed=0)
    op = device_laplacian(L, fmt="banded", rows_per_step=G, use_pallas=True,
                          device="cpu")
    op_j = jax_device_laplacian(L, fmt="banded", dtype=jnp.float32,
                                use_pallas=False, rows_per_step=G)
    rng = np.random.default_rng(21)
    feats = rng.normal(size=(op.m, FIN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, op.m)
    mask = rng.random(op.m) < 0.5
    return op, op_j, feats, labels, mask


@dataclasses.dataclass(frozen=True)
class _CountingBanded(BandedLaplacian):
    """The port's operator, counting its adjoint-chain hops."""

    hop_c_calls: list = dataclasses.field(default_factory=list)

    def cheby_hop_c(self, x1, x0, c):
        self.hop_c_calls.append(1)
        return super().cheby_hop_c(x1, x0, c)


def _counting(op):
    return _CountingBanded(**{f.name: getattr(op, f.name)
                              for f in dataclasses.fields(op)})


def _conv_inputs(m, K, seed, B=2, Fout=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, m, FIN)).astype(np.float32)
    w = (rng.normal(size=(K, FIN, Fout)) * 0.3).astype(np.float32)
    t = rng.normal(size=(B, m, Fout)).astype(np.float32)
    return x, w, t


def _jax_conv_grads(op_j, x, w, t, input_grad):
    def loss(x, w):
        return jnp.sum(jax_cheby_conv_banded(x, op_j, w, input_grad) * t)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(gx), np.asarray(gw)


def _port_conv_grads(op, x, w, t, input_grad):
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = cheby_conv_banded(xt, op, wt, input_grad=input_grad)
    (y * torch.from_numpy(t)).sum().backward()
    return xt.grad, wt.grad


class TestChebyConvBandedBackward:
    @pytest.mark.parametrize("K", [1, 2, 3, 7])
    def test_grads_match_jax(self, city, K):
        op, op_j, *_ = city
        x, w, t = _conv_inputs(op.m, K, seed=30 + K)
        gx, gw = _port_conv_grads(op, x, w, t, input_grad=True)
        want_x, want_w = _jax_conv_grads(op_j, x, w, t, input_grad=True)
        np.testing.assert_allclose(gx.numpy(), want_x, atol=2e-3, rtol=1e-4)
        np.testing.assert_allclose(gw.numpy(), want_w, atol=2e-3, rtol=1e-4)

    def test_no_input_grad_skips_the_adjoint_chain(self, city):
        """``input_grad=False``: the same dW, no gradient for x at all
        (None, where JAX returns zeros), and not one adjoint hop run."""
        op, op_j, *_ = city
        K = 7
        x, w, t = _conv_inputs(op.m, K, seed=40)
        counted = _counting(op)
        gx, gw = _port_conv_grads(counted, x, w, t, input_grad=False)
        assert gx is None and not counted.hop_c_calls
        want_x, want_w = _jax_conv_grads(op_j, x, w, t, input_grad=False)
        assert not want_x.any()
        np.testing.assert_allclose(gw.numpy(), want_w, atol=2e-3, rtol=1e-4)
        gx_full, gw_full = _port_conv_grads(counted, x, w, t, input_grad=True)
        assert len(counted.hop_c_calls) == K - 2 and gx_full is not None
        torch.testing.assert_close(gw, gw_full, rtol=0, atol=0)

    def test_forward_without_grad_matches_forward_with_grad(self, city):
        op, *_ = city
        x, w, _ = _conv_inputs(op.m, 5, seed=41)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        with torch.no_grad():
            plain = cheby_conv_banded(xt, op, wt)
        tracked = cheby_conv_banded(xt, op, wt.clone().requires_grad_())
        assert tracked.requires_grad
        torch.testing.assert_close(tracked.detach(), plain, rtol=0, atol=0)


def _models(city, **kw):
    op, op_j, *_ = city
    model_j = JaxNodeClassifier(op_j, FIN, CLASSES, hidden=[HIDDEN], K=4,
                                **kw)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(3)))
    model = NodeClassifier(op, FIN, CLASSES, hidden=[HIDDEN], K=4, **kw)
    return model, model_j, params_j


def _requires_grad(params):
    return {"convs": [{k: v.requires_grad_() for k, v in layer.items()}
                      for layer in params["convs"]]}


class TestNodeClassifierTraining:
    @pytest.mark.parametrize("residual", [False, True])
    def test_loss_and_gradients_match_jax(self, city, residual):
        _, _, feats, labels, mask = city
        model, model_j, params_j = _models(city, residual=residual)
        loss_j, grads_j = jax.value_and_grad(model_j.loss)(
            params_j, jnp.asarray(feats), jnp.asarray(labels),
            jnp.asarray(mask))
        params = _requires_grad(node_classifier_params_from_jax(params_j))
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

    def test_input_grad_reaches_the_features(self, city):
        """``input_grad=True``: layer 0 runs the adjoint chain and the
        features get JAX's gradient."""
        _, _, feats, labels, mask = city
        model, model_j, params_j = _models(city, input_grad=True)
        want = jax.grad(model_j.loss, argnums=1)(
            params_j, jnp.asarray(feats), jnp.asarray(labels),
            jnp.asarray(mask))
        f = torch.from_numpy(feats).requires_grad_()
        model.loss(node_classifier_params_from_jax(params_j), f,
                   torch.from_numpy(labels), torch.from_numpy(mask)).backward()
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)

    def test_adam_losses_match_optax(self, city):
        _, _, feats, labels, mask = city
        model, model_j, params_j = _models(city)
        opt = optax.adam(1e-2)
        state = opt.init(params_j)
        args_j = (jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(mask))
        p, want = params_j, []
        for _ in range(5):
            loss, g = jax.value_and_grad(model_j.loss)(p, *args_j)
            up, state = opt.update(g, state, p)
            p = optax.apply_updates(p, up)
            want.append(float(loss))
        params = node_classifier_params_from_jax(params_j)
        before = [t.clone() for layer in params["convs"]
                  for t in layer.values()]
        trained, losses = train_node_classifier(
            model, params, torch.from_numpy(feats), torch.from_numpy(labels),
            torch.from_numpy(mask), steps=5, learning_rate=1e-2)
        assert losses.shape == (5,) and want[-1] < want[0]
        np.testing.assert_allclose(losses.numpy(), want, rtol=1e-4)
        # The caller's params are untouched; the trained ones moved.
        after = [t for layer in params["convs"] for t in layer.values()]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert not torch.equal(trained["convs"][0]["w"],
                               params["convs"][0]["w"])
        assert not trained["convs"][0]["w"].requires_grad


class TestDropout:
    def test_identity_at_keep_one_and_in_eval(self):
        x = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        assert dropout(x, 1.0, True, gen) is x
        assert dropout(x, 0.5, False, gen) is x
        assert dropout(x, 0.5, False) is x

    def test_keeps_and_scales_by_inverse_keep_prob(self):
        x = torch.rand(200, 50, generator=torch.Generator().manual_seed(2)) + 1
        y = dropout(x, 0.5, True, torch.Generator().manual_seed(3))
        kept = y != 0
        torch.testing.assert_close(y[kept], 2.0 * x[kept], rtol=0, atol=0)
        assert 0.45 < float(kept.float().mean()) < 0.55

    def test_mask_follows_the_generator_seed(self):
        x = torch.ones(100, 100)
        a, b, c = (dropout(x, 0.5, True, torch.Generator().manual_seed(s))
                   for s in (4, 4, 5))
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_training_needs_a_generator(self):
        with pytest.raises(ValueError, match="Generator"):
            dropout(torch.ones(4), 0.5, True)

    def test_node_classifier_drops_only_in_training(self, city):
        _, _, feats, *_ = city
        model, _, params_j = _models(city, dropout=0.5)
        params = node_classifier_params_from_jax(params_j)
        f = torch.from_numpy(feats)
        with torch.no_grad():
            ev = model.apply(params, f)
            tr = [model.apply(params, f, train=True,
                              generator=torch.Generator().manual_seed(6))
                  for _ in range(2)]
        torch.testing.assert_close(ev, model.apply(params, f).detach())
        torch.testing.assert_close(tr[0], tr[1], rtol=0, atol=0)
        assert not torch.allclose(tr[0], ev)
