"""The flow-forecasting family on the CPU against the JAX package, on the
same NumPy inputs and carried weights: ``ResGNN`` (Chebyshev and Fourier,
one tower and ``stack_splits``), ``GConvLSTMCell.step``, the 12
``GConvForecaster`` variants, ``GConvRNN`` and ``PerNodeLSTM`` (outputs,
loss and every gradient), ``Trainer.fit`` of ResGNN (regression) and of
GConvRNN (sequence) against JAX's ``Trainer``, which convs take the fused
route (K2 and K3's plain versions here) and how often, and the humanflow
and mnist drivers as subprocesses.

JAX's operators take the stacked route (``use_pallas=False``); the
port's dense operators are built with ``use_pallas=True`` where a test
says so, and then run the fused conv's plain versions, which
tests/test_torch_cheby.py holds to the Pallas kernels.  Dropout stays
off (keep probability 1): its bits are not ``jax.random``'s.

Tolerances (f32, sums in another order): outputs within 1e-4 of their
largest entry, loss rel 1e-5, gradients within 1e-4 of each leaf's
largest entry; Trainer runs: metric history and validation losses rel
1e-4, final parameters within 1e-4 of each leaf's largest entry."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu import models as jm
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.train import TrainConfig as JaxTrainConfig
from cnn_graph_tpu.train import Trainer as JaxTrainer
from cnn_graph_tpu_torch import convert, graphs, models
from cnn_graph_tpu_torch.models.common import tree_leaves, tree_map
from cnn_graph_tpu_torch.ops import DenseLaplacian, device_laplacian
from cnn_graph_tpu_torch.train import TrainConfig, Trainer

M = 16  # nodes of the 4x4 grid graph


@pytest.fixture(scope="module")
def graph():
    W = graphs.knn_graph(graphs.grid(4), k=4)
    L = graphs.laplacian(W, normalized=True)
    U = graphs.fourier(L)[1].astype(np.float32)
    return (L, U, device_laplacian(L, fmt="dense", device="cpu"),
            device_laplacian(L, fmt="dense", device="cpu", use_pallas=True),
            jax_device_laplacian(L, fmt="dense", use_pallas=False))


def _close_rel(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-12), err


def _sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _sorted_leaves(t)]
    return [tree]


def _check_model(model, model_j, params_j, x, y, tol=1e-4):
    """Outputs, loss and every gradient of ``model`` on the carried
    ``params_j`` against the JAX model's; the parameter layouts equal."""
    assert (tree_map(lambda t: tuple(t.shape), model.param_tree())
            == jax.tree.map(lambda a: a.shape, params_j))
    params = tree_map(lambda t: t.requires_grad_(),
                      convert.forecaster_params_from_jax(params_j))
    out = model.apply(params, torch.from_numpy(x))

    def loss_and_out(p):
        return model_j.loss(p, x, y), model_j.apply(p, x)

    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(
        loss_and_out, has_aux=True))(params_j)
    _close_rel(out.detach().numpy(), out_j, tol)
    loss = model.loss(params, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    leaves_j = jax.tree.leaves(grads_j)
    leaves = _sorted_leaves(params)
    assert len(leaves) == len(leaves_j)
    for p, g in zip(leaves, leaves_j):
        _close_rel(p.grad.numpy(), g, tol)


def _init(model_j, seed=1):
    return jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("filt,splits", [("chebyshev", None),
                                         ("fourier", None),
                                         ("chebyshev", [(0, 4), (4, 6)])])
def test_resgnn_matches_jax(graph, filt, splits):
    L, U, op, _, op_j = graph
    kw = dict(input_features=6, K=3, nfilter=8, nres_layer_count=2,
              stack_splits=splits, filter=filt)
    model_j = jm.ResGNN(op_j, **kw, fourier_u=(
        jnp.asarray(U) if filt == "fourier" else None))
    model = models.ResGNN(op, **kw, fourier_u=U if filt == "fourier"
                          else None)
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(3, M, 6)).astype(np.float32)
    y = rng.uniform(size=(3, M, 2)).astype(np.float32)
    _check_model(model, model_j, _init(model_j), x, y)


@pytest.mark.parametrize("filter_type", ["cheby_conv", "fourier_conv"])
def test_glstm_cell_step_matches_jax(graph, filter_type):
    """One step of the cell, the four gates in one concatenated pass each
    for x and h, from a nonzero state."""
    L, U, op, _, op_j = graph
    cell_j = jm.GConvLSTMCell(op_j, 5, 3, K=3, filter_type=filter_type,
                              fourier_u=jnp.asarray(U))
    cell = models.GConvLSTMCell(op, 5, 3, K=3, filter_type=filter_type,
                                fourier_u=torch.from_numpy(U))
    params_j = _init(cell_j)
    params = convert.forecaster_params_from_jax(params_j)
    assert ({k: tuple(v.shape) for k, v in cell.init().items()}
            == {k: v.shape for k, v in params_j.items()})
    rng = np.random.default_rng(3)
    c, h = (rng.normal(size=(2, M, 5)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(2, M, 3)).astype(np.float32)
    (c1, h1), out = cell.step(params, (torch.from_numpy(c),
                                       torch.from_numpy(h)),
                              torch.from_numpy(x))
    (c1_j, h1_j), out_j = cell_j.step(params_j, (jnp.asarray(c),
                                                 jnp.asarray(h)),
                                      jnp.asarray(x))
    for a, b in ((c1, c1_j), (h1, h1_j), (out, out_j)):
        _close_rel(a.numpy(), b)


FORECAST = dict(seq_closeness=2, seq_period=1, seq_trend=1, num_hidden=8,
                num_hidden_conv=4, conv_layer_num=1, K=2,
                lstm_keep_prob=1.0)


@pytest.mark.parametrize("variant", jm.FORECAST_VARIANTS)
def test_forecaster_variants_match_jax(graph, variant):
    assert models.FORECAST_VARIANTS == jm.FORECAST_VARIANTS
    L, U, op, _, op_j = graph
    model_j = jm.GConvForecaster(op_j, variant=variant, **FORECAST)
    model = models.GConvForecaster(op, variant=variant, **FORECAST)
    assert model.to_string() == model_j.to_string()
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, M, 8)).astype(np.float32)
    y = rng.uniform(size=(2, M, 2)).astype(np.float32)
    _check_model(model, model_j, _init(model_j), x, y)


def test_forecaster_fourier_and_two_layer_stack_match_jax(graph):
    L, U, op, _, op_j = graph
    kw = dict(FORECAST, variant="glstm_gconv", filter="fourier_conv",
              lstm_layer_count=2)
    model_j = jm.GConvForecaster(op_j, fourier_u=jnp.asarray(U), **kw)
    model = models.GConvForecaster(op, fourier_u=U, **kw)
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, M, 8)).astype(np.float32)
    y = rng.uniform(size=(2, M, 2)).astype(np.float32)
    _check_model(model, model_j, _init(model_j), x, y)


@pytest.mark.parametrize("kw,match", [
    (dict(variant="nope"), "unknown variant"),
    (dict(seq_closeness=0), "seq_closeness"),
    (dict(seq_closeness=3, seq_period=1), "divisible"),
    (dict(variant="glstm_gconv_split", seq_period=1), "two closeness"),
    (dict(variant="glstm_period_expand", seq_period=1), "seq_trend"),
    (dict(filter="fourier_conv"), "fourier_u")])
def test_forecaster_validates_like_jax(graph, kw, match):
    """JAX's asserts as ValueErrors; JAX refuses the same configurations."""
    op, op_j = graph[2], graph[4]
    kw = dict(dict(seq_closeness=2, variant="glstm"), **kw)
    with pytest.raises(ValueError, match=match):
        models.GConvForecaster(op, **kw)
    with pytest.raises(AssertionError):
        jm.GConvForecaster(op_j, **kw).init(jax.random.PRNGKey(0))


def test_gconv_rnn_matches_jax(graph):
    L, U, op, _, op_j = graph
    kw = dict(num_units=6, feat_in=2, num_classes=3, K=3, num_layers=2)
    model_j = jm.GConvRNN(op_j, **kw)
    model = models.GConvRNN(op, **kw)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, M, 2, 4)).astype(np.float32)
    y = rng.integers(0, 3, (2, 4, M))
    _check_model(model, model_j, _init(model_j), x, y)
    assert model.predict_classes(model.param_tree(),
                                 torch.from_numpy(x)).shape == (2, 4, M)


def test_per_node_lstm_matches_jax():
    model_j = jm.PerNodeLSTM(n_nodes=5, seq=3, num_hidden=4)
    model = models.PerNodeLSTM(n_nodes=5, seq=3, num_hidden=4, device="cpu")
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(4, 5, 6)).astype(np.float32)
    y = rng.uniform(size=(4, 5, 2)).astype(np.float32)
    _check_model(model, model_j, _init(model_j), x, y)
    coll = [{k: rng.normal(size=(3, 2)) for k in (
        "train_data", "train_labels", "test_data", "test_labels")}
        for _ in range(5)]
    got, want = (models.stack_lstm_collection(coll),
                 jm.stack_lstm_collection(coll))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="nodes"):
        model(torch.zeros(1, 4, 6))


class _Counting(DenseLaplacian):
    """A dense operator that counts its fused conv's two kernels (here
    their plain versions)."""

    def fused_filter(self, x, w):
        self.calls["K2"].append((x.shape[2], w.shape[2]))
        return super().fused_filter(x, w)

    def fused_dw(self, x, g, K):
        self.calls["K3"].append((x.shape[2], g.shape[2]))
        return super().fused_dw(x, g, K)


def _counting(op):
    c = _Counting(**{f: getattr(op, f) for f in
                     ("mat", "m", "m_padded", "nnz", "use_fused")})
    object.__setattr__(c, "calls", {"K2": [], "K3": []})
    return c


@pytest.mark.parametrize("name", ["resgnn", "glstm_gconv"])
def test_fused_route_per_training_step(graph, name):
    """Which convs of a training step take K2 and K3 on a fused dense
    operator (JAX's ``_fused_eligible`` and ``_dw_eligible``) and at
    which widths: ResGNN (nfilter 64, nres 4) runs its 8 residual convs
    there, forward, dx and dW; glstm_gconv (H 64, Hc 32, 4 steps) its
    h-conv at (64 -> 256), whose dx is (256 -> 64) on 3 of the 4 steps
    (the first step's h is the zero state), and its 9 conv-stack convs.
    The loss and gradients equal the stacked route's."""
    op_f = _counting(graph[3])
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(size=(2, M, 12)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(size=(2, M, 2)).astype(np.float32))
    if name == "resgnn":
        make = lambda op: models.ResGNN(  # noqa: E731
            op, 12, generator=torch.Generator().manual_seed(0))
        want = {"K2": [(64, 64)] * 16, "K3": [(64, 64)] * 8}
    else:
        make = lambda op: models.GConvForecaster(  # noqa: E731
            op, 4, 1, 1, variant="glstm_gconv", lstm_keep_prob=1.0,
            generator=torch.Generator().manual_seed(0))
        want = {"K2": [(64, 256)] * 4 + [(64, 32)] + [(32, 32)] * 8
                + [(32, 32)] * 8 + [(32, 64)] + [(256, 64)] * 3,
                "K3": [(32, 32)] * 8 + [(64, 32)] + [(64, 256)] * 4}
    results = []
    for op in (op_f, graph[2]):
        model = make(op)
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          model.param_tree())
        loss = model.loss(params, x, y)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in
                                        tree_leaves(params)]))
    assert {k: sorted(v) for k, v in op_f.calls.items()} == {
        k: sorted(v) for k, v in want.items()}
    (loss_f, grads_f), (loss_s, grads_s) = results
    np.testing.assert_allclose(float(loss_f), float(loss_s), rtol=1e-5)
    for a, b in zip(grads_f, grads_s):
        _close_rel(a.numpy(), b.numpy())


def _fit_both(model, model_j, params_j, convert_fn, task, data, **cfg):
    tj = JaxTrainer(model_j, JaxTrainConfig(**cfg), task=task)
    tj.params = jax.tree.map(jnp.asarray, params_j)
    rj = tj.fit(*data, verbose=False)
    tt = Trainer(model, TrainConfig(**cfg), task=task)
    tt.params = convert_fn(params_j)
    rt = tt.fit(*data, verbose=False)
    np.testing.assert_allclose(rt[0], rj[0], rtol=1e-4)
    np.testing.assert_allclose(rt[1], rj[1], rtol=1e-4)
    leaves_j = jax.tree.leaves(jax.tree.map(np.asarray, tj.params))
    leaves_t = [t.detach().numpy() for t in _sorted_leaves(tt.params)]
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_t, leaves_j):
        _close_rel(a, b)
    return tt, tj


STEPS = dict(num_epochs=2, eval_frequency=4, decay_steps=4, decay_rate=0.5,
             batch_size=10, learning_rate=1e-2, seed=3)


def test_trainer_fits_resgnn_as_jax(graph):
    """8 adam steps of regression (a staircase crossing one boundary, two
    evaluations) from the same weights: the same metric history, losses
    and parameters; ``evaluate`` the same MSE."""
    L, U, op, op_f, op_j = graph
    kw = dict(input_features=6, K=2, nfilter=8, nres_layer_count=2)
    model_j = jm.ResGNN(op_j, **kw)
    rng = np.random.default_rng(9)
    data = [rng.uniform(size=(n, M, c)).astype(np.float32)
            for n, c in ((40, 6), (40, 2), (15, 6), (15, 2))]
    tt, tj = _fit_both(models.ResGNN(op_f, **kw), model_j, _init(model_j),
                       convert.resgnn_params_from_jax, "regression",
                       data, **STEPS)
    s, m = tt.evaluate(data[2], data[3])
    s_j, m_j = tj.evaluate(data[2], data[3])
    np.testing.assert_allclose(m["mse"], m_j["mse"], rtol=1e-4)
    _close_rel(m["predictions"], m_j["predictions"])
    assert s.split()[0] == s_j.split()[0] == "mse:"


def test_trainer_fits_gconv_rnn_as_jax(graph):
    """The sequence task: per-step node labels, accuracy over every
    (batch, step, node) slot."""
    L, U, op, _, op_j = graph
    kw = dict(num_units=4, feat_in=2, num_classes=2, K=2)
    model_j = jm.GConvRNN(op_j, **kw)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(50, M, 2, 3)).astype(np.float32)
    y = (x[:, :, 0, :].transpose(0, 2, 1) > 0).astype(np.int32)
    data = (x[:40], y[:40], x[40:], y[40:])
    _fit_both(models.GConvRNN(op, **kw), model_j, _init(model_j),
              convert.gconv_rnn_params_from_jax, "sequence", data, **STEPS)


def test_models_follow_the_generator_and_operator_device(graph):
    """Seeded weights: the same generator seed gives the same model."""
    op = graph[2]
    a, b = (models.ResGNN(op, 6, generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(
        tree_leaves(a.param_tree()), tree_leaves(b.param_tree())))
    assert a.param_tree()["tower"]["res"][3]["w2"].device == torch.device(
        "cpu")
    with pytest.raises(ValueError, match="fourier_u"):
        models.ResGNN(op, 6, filter="fourier")


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _driver(module, *argv):
    proc = subprocess.run(
        [sys.executable, "-m", f"cnn_graph_tpu_torch.experiments.{module}",
         "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("model", ["resgnn", "glstm", "lstm"])
def test_humanflow_driver_runs_on_the_cpu(model, tmp_path):
    """The driver at 64 regions for one epoch: the test line, RMSE and
    MAPE, and the saved predictions."""
    out = _driver("humanflow", "--model", model, "--epochs", "1",
                  "--nodes", "64", "--save-predictions",
                  str(tmp_path / "pred.mat"))
    lines = out.splitlines()
    assert any(s.startswith("test  mse: ") for s in lines), out[-2000:]
    rmse = [s for s in lines if s.startswith("RMSE (real units): ")]
    assert len(rmse) == 1 and np.isfinite(float(rmse[0].split(": ")[1]))
    assert any(s.startswith("MAPE (targets>20): ") for s in lines)
    assert (tmp_path / "pred.mat").exists()


def test_mnist_driver_runs_the_lanczos_filter():
    out = _driver("mnist", "--filter", "lanczos", "--epochs", "1",
                  "--n-train", "100", "--n-val", "50", "--n-test", "50",
                  "--K", "3", "--batch-size", "50", "--edge-noise", "0.05")
    assert any(s.startswith("test  accuracy: ") for s in out.splitlines())
