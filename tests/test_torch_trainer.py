"""The port's ``TrainConfig``/``Trainer``, its optimizer chain, checkpoints
and metrics logger on the CPU against the JAX package's, on the same
NumPy inputs.

A small ChebNet (the 8x8 grid's 64-node 8-NN graph, F=[8], K=[3], p=[1],
4 classes, keep probability 1, L2 5e-4) with the JAX weights carried over
by ``convert.chebnet_params_from_jax`` runs ``fit`` in both packages for
18 steps of 40 (3 evaluations, a staircase of 6 steps at rate 0.5 that
crosses two boundaries) with adam, sgd (momentum 0.9) and rmsprop, the
global-norm clip set low enough to bind on every step.

Tolerances: the metric history (accuracy in percent) equal; validation
losses within rel 1e-4; final parameters within 1e-4 of their largest
entry (f32 sums in another order, carried over 18 updates).  Strings of
``evaluate`` equal, metrics within rel 1e-5."""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_graph_tpu.graphs import construction as jax_gc
from cnn_graph_tpu.models import ChebNet as JaxChebNet
from cnn_graph_tpu.ops import device_laplacian as jax_device_laplacian
from cnn_graph_tpu.train import TrainConfig as JaxTrainConfig
from cnn_graph_tpu.train import Trainer as JaxTrainer
from cnn_graph_tpu.train.trainer import _EpochSampler as JaxEpochSampler
from cnn_graph_tpu.utils import metrics as jax_metrics
from cnn_graph_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from cnn_graph_tpu_torch import graphs
from cnn_graph_tpu_torch.convert import chebnet_params_from_jax
from cnn_graph_tpu_torch.models import ChebNet
from cnn_graph_tpu_torch.models.common import tree_leaves
from cnn_graph_tpu_torch.ops import device_laplacian
from cnn_graph_tpu_torch.train import TrainConfig, Trainer
from cnn_graph_tpu_torch.train.checkpoint import CheckpointManager
from cnn_graph_tpu_torch.train.trainer import _EpochSampler
from cnn_graph_tpu_torch.utils import metrics
from cnn_graph_tpu_torch.utils.logging import MetricsLogger

ARCH = dict(F=[8], K=[3], p=[1], M=[4], dropout=1.0, regularization=5e-4)
N_TRAIN, N_VAL, BATCH = 240, 50, 40  # 6 steps an epoch; val ragged
STEPS = dict(num_epochs=3, eval_frequency=6, decay_steps=6, decay_rate=0.5,
             batch_size=BATCH, seed=7)
OPTIMIZERS = {"adam": dict(optimizer="adam", learning_rate=1e-2),
              "sgd": dict(optimizer="sgd", learning_rate=0.1, momentum=0.9),
              "rmsprop": dict(optimizer="rmsprop", learning_rate=3e-3)}
CLIP = 0.05  # under every step's gradient norm here


@pytest.fixture(scope="module")
def setup():
    W = graphs.knn_graph(graphs.grid(8), k=8)
    L = graphs.laplacian(W, normalized=True)
    assert abs(L - jax_gc.laplacian(jax_gc.knn_graph(jax_gc.grid(8), k=8),
                                    normalized=True)).max() == 0
    op = device_laplacian(L, fmt="dense", device="cpu")
    op_j = jax_device_laplacian(L, fmt="dense", use_pallas=False)
    model_j = JaxChebNet([op_j], **ARCH)
    params_j = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(3)))
    model = ChebNet([op], **ARCH)
    rng = np.random.default_rng(11)
    templates = rng.normal(size=(4, 64)).astype(np.float32)

    def make(n):
        y = rng.integers(0, 4, n)
        x = templates[y] + rng.normal(0, 1.5, (n, 64)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int64)

    return model, model_j, params_j, make(N_TRAIN), make(N_VAL)


def _fit(model, model_j, params_j, train, val, **cfg):
    """Both packages' ``fit`` from the same weights; returns the two
    trainers and results."""
    tj = JaxTrainer(model_j, JaxTrainConfig(**cfg), task="classification")
    tj.params = jax.tree.map(jnp.asarray, params_j)
    rj = tj.fit(*train, *val, verbose=False)
    tt = Trainer(model, TrainConfig(**cfg), task="classification")
    tt.params = chebnet_params_from_jax(params_j)
    rt = tt.fit(*train, *val, verbose=False)
    return tj, rj, tt, rt


def _sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _sorted_leaves(t)]
    return [tree]


def _close_params(pt, pj, tol=1e-4):
    leaves_j = jax.tree.leaves(jax.tree.map(np.asarray, pj))
    leaves_t = [t.detach().numpy() for t in _sorted_leaves(pt)]
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_t, leaves_j):
        assert a.shape == b.shape
        err = float(np.abs(a - b).max())
        assert err <= tol * max(float(np.abs(b).max()), 1e-6), err


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_fit_matches_jax(setup, name):
    """Metric history, validation losses and final parameters of a
    clipped, decayed run equal JAX's."""
    model, model_j, params_j, train, val = setup
    tj, (hj, lj, _), tt, (ht, lt, t_step) = _fit(
        model, model_j, params_j, train, val, grad_clip=CLIP,
        **STEPS, **OPTIMIZERS[name])
    assert len(ht) == len(hj) == 3 and t_step > 0
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    _close_params(tt.params, tj.params)
    # The optimizer's step count is optax's: one per applied update.
    assert int(tt.opt_state["count"]) == 18


def test_clip_binds_and_changes_the_run(setup):
    """The clip is live: without it the run ends elsewhere."""
    model, model_j, params_j, train, val = setup
    cfg = dict(**STEPS, **OPTIMIZERS["sgd"])
    _, _, clipped, _ = _fit(model, model_j, params_j, train, val,
                            grad_clip=CLIP, **cfg)
    free = Trainer(model, TrainConfig(**cfg), task="classification")
    free.params = chebnet_params_from_jax(params_j)
    free.fit(*train, *val, verbose=False)
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(
        tree_leaves(clipped.params), tree_leaves(free.params)))
    assert diff > 1e-3


def test_check_numerics_skips_a_nan_batch(setup):
    """One NaN sample poisons one batch an epoch: both packages skip
    those 3 updates, their schedule counts stay at 15, and the runs
    agree."""
    model, model_j, params_j, (x, y), val = setup
    x = x.copy()
    x[5, 3] = np.nan
    tj, (hj, lj, _), tt, (ht, lt, _) = _fit(
        model, model_j, params_j, (x, y), val, check_numerics=True,
        **STEPS, **OPTIMIZERS["adam"])
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    _close_params(tt.params, tj.params)
    inner = tj.opt_state.inner_state
    counts_j = [int(s.count) for s in inner if hasattr(s, "count")]
    assert counts_j and set(counts_j) == {15}
    assert int(tt.opt_state["count"]) == 15
    assert int(tt.opt_state["total_notfinite"]) == int(
        tj.opt_state.total_notfinite) == 3
    assert all(torch.isfinite(t).all() for t in tree_leaves(tt.params))


def test_resume_matches_jax(setup, tmp_path):
    """12 steps with checkpoints, then a 3-epoch trainer over the same
    directory: it resumes at step 12 with the sampler restarted from
    the seed, in both packages, and ends at JAX's parameters."""
    model, model_j, params_j, train, val = setup
    cfg = dict(STEPS, **OPTIMIZERS["adam"])
    runs = {}
    for pkg in ("jax", "torch"):
        d = str(tmp_path / pkg)
        first = dict(cfg, num_epochs=2, checkpoint_dir=d)
        if pkg == "jax":
            t = JaxTrainer(model_j, JaxTrainConfig(**first),
                           task="classification")
            t.params = jax.tree.map(jnp.asarray, params_j)
        else:
            t = Trainer(model, TrainConfig(**first), task="classification")
            t.params = chebnet_params_from_jax(params_j)
        t.fit(*train, *val, verbose=False)
        second = (JaxTrainer(model_j, JaxTrainConfig(**dict(
            cfg, checkpoint_dir=d)), task="classification") if pkg == "jax"
            else Trainer(model, TrainConfig(**dict(cfg, checkpoint_dir=d)),
                         task="classification"))
        runs[pkg] = (second, second.fit(*train, *val, verbose=False))
    (tj, (hj, lj, _)), (tt, (ht, lt, _)) = runs["jax"], runs["torch"]
    assert len(ht) == len(hj) == 1  # one evaluation, at step 18
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    _close_params(tt.params, tj.params)
    assert int(tt.opt_state["count"]) == 18
    assert CheckpointManager(str(tmp_path / "torch")).all_steps() == [6, 12,
                                                                     18]


class _LinearJax:
    """A toy model for the JAX Trainer: ``x @ W``, shaped per task."""

    def __init__(self, w, task):
        self.w, self.task = jnp.asarray(w), task

    def init(self, key):
        return {"w": self.w}

    def apply(self, params, x):
        y = jnp.tensordot(x, params["w"], axes=1)
        return y

    def loss(self, params, x, y, *, train=False, rng=None):
        out = self.apply(params, x)
        if self.task == "regression":
            return jnp.mean((out - y) ** 2)
        logp = jax.nn.log_softmax(out, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], -1))


class _LinearTorch:
    def __init__(self, w, task):
        self.w, self.task = torch.from_numpy(w), task

    def param_tree(self):
        return {"w": self.w}

    def apply(self, params, x):
        return torch.tensordot(x, params["w"], dims=1)

    def loss(self, params, x, y, *, train=False, generator=None):
        out = self.apply(params, x)
        if self.task == "regression":
            return ((out - y) ** 2).mean()
        logp = torch.log_softmax(out, dim=-1)
        return -logp.gather(-1, y[..., None].long()).mean()


def _task_data(task, rng):
    """53 samples (a ragged last batch of 13 at batch 20)."""
    if task == "regression":
        x = rng.normal(size=(53, 6)).astype(np.float32)
        return x, rng.normal(size=(53, 3)).astype(np.float32), \
            rng.normal(size=(6, 3)).astype(np.float32)
    if task == "sequence":  # [B, T, N, F] -> [B, T, N, C]
        x = rng.normal(size=(53, 4, 5, 6)).astype(np.float32)
        return x, rng.integers(0, 3, (53, 4, 5)), \
            rng.normal(size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(53, 6)).astype(np.float32)
    return x, rng.integers(0, 3, 53), rng.normal(size=(6, 3)).astype(
        np.float32)


@pytest.mark.parametrize("task", ["regression", "classification",
                                  "sequence"])
def test_predict_and_evaluate_match_jax(task):
    x, y, w = _task_data(task, np.random.default_rng(5))
    cfg = dict(batch_size=20)
    tj = JaxTrainer(_LinearJax(w, task), JaxTrainConfig(**cfg), task=task)
    tj.params = {"w": jnp.asarray(w)}
    tt = Trainer(_LinearTorch(w, task), TrainConfig(**cfg), task=task)
    tt.params = {"w": torch.from_numpy(w)}
    pj, loss_j = tj.predict(x, y)
    pt, loss_t = tt.predict(x, y)
    assert pt.shape == pj.shape and pt.shape[0] == 53
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    np.testing.assert_allclose(tt.predict(x), tj.predict(x), rtol=1e-5,
                               atol=1e-6)
    sj, mj = tj.evaluate(x, y)
    st, mt = tt.evaluate(x, y)
    assert st == sj
    for k in mj:
        if k != "predictions":
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5)
    np.testing.assert_array_equal(mt["predictions"] if task != "regression"
                                  else np.round(mt["predictions"], 4),
                                  mj["predictions"] if task != "regression"
                                  else np.round(mj["predictions"], 4))
    # The device evaluation of fit gives the same line on the same data.
    batched = tt._device_batches(x, y)
    sd, md = tt._evaluate_device(tt.params, batched, y)
    assert sd == st


@pytest.mark.parametrize("n,batch", [(10, 3), (7, 7), (5, 12)])
def test_epoch_sampler_matches_jax(n, batch):
    a, b = _EpochSampler(n, 2017), JaxEpochSampler(n, 2017)
    for _ in range(9):
        x, y = a.next_batch(batch), b.next_batch(batch)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    t, p = rng.uniform(0, 60, 200), rng.uniform(0, 60, 200)
    labels, pred = rng.integers(0, 5, 300), rng.integers(0, 5, 300)
    assert metrics.rmse(t, p) == jax_metrics.rmse(t, p)
    assert metrics.mape(t, p) == jax_metrics.mape(t, p)
    assert np.isnan(metrics.mape(t, p, threshold=100.0))
    assert metrics.accuracy(labels, pred) == jax_metrics.accuracy(labels,
                                                                  pred)
    assert metrics.weighted_f1(labels, pred) == jax_metrics.weighted_f1(
        labels, pred)
    params = {"a": [{"w": np.zeros((3, 4))}, {"b": np.zeros(5)}]}
    assert metrics.count_params(
        {"a": [{"w": torch.zeros(3, 4)}, {"b": torch.zeros(5)}]}) == \
        jax_metrics.count_params(params) == 17


def test_metrics_logger_writes_jax_lines(tmp_path):
    """The same JSONL events with the same keys, in the same order."""
    lines = {}
    for name, cls in (("jax", JaxMetricsLogger), ("torch", MetricsLogger)):
        path = str(tmp_path / name / "m.jsonl")
        with cls(path, run_name="r") as log:
            log.log_params({"lr": 0.1})
            log.log(3, loss_ema=1.5, val_metric=80.0)
        assert log.scalars == {"loss_ema": [(3, 1.5)],
                               "val_metric": [(3, 80.0)]}
        lines[name] = [json.loads(s) for s in open(path)]
    assert [list(r) for r in lines["torch"]] == [list(r)
                                                 for r in lines["jax"]]
    for a, b in zip(lines["torch"], lines["jax"]):
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}


def test_checkpoint_retention_and_interrupted_save(tmp_path):
    """``max_to_keep`` newest steps stay; a save cut short (its
    temporary file left behind) leaves the previous step the latest."""
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    params = {"w": [torch.arange(4.0)]}
    opt = {"count": torch.tensor(0, dtype=torch.int32)}
    for step in (1, 2, 3):
        assert mngr.save(step, {"w": [params["w"][0] * step]},
                         {"count": torch.tensor(step, dtype=torch.int32)})
    assert mngr.all_steps() == [2, 3]
    (tmp_path / "step_4.pt.tmp").write_bytes(b"cut short")
    assert mngr.latest_step() == 3
    p, o, step = mngr.restore(params, opt)
    assert step == 3 and torch.equal(p["w"][0], torch.arange(4.0) * 3)
    assert o["count"].dtype == torch.int32 and int(o["count"]) == 3
    assert not CheckpointManager(str(tmp_path), save_interval_steps=2).save(
        5, params, opt)


def test_mesh_raises():
    """A mesh whose data axis does not divide the batch is refused, as
    JAX's Trainer asserts (trainer.py:135-141); the mesh itself runs
    (tests/test_torch_parallel.py)."""
    mesh = types.SimpleNamespace(axis_names=("data", "nodes"),
                                 shape={"data": 3, "nodes": 1})
    with pytest.raises(AssertionError, match="divisible"):
        Trainer(_LinearTorch(np.zeros((2, 2), np.float32), "regression"),
                TrainConfig(batch_size=100, mesh=mesh))


DRIVERS = {
    "mnist": ["--epochs", "1", "--n-train", "200", "--n-val", "100",
              "--n-test", "150", "--K", "3"],
    "text20news": ["--synthetic", "--epochs", "1"],
    "rcv1": ["--epochs", "1"],
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_runs_on_the_cpu(name):
    """Each experiment driver of the port trains through ``Trainer`` at
    a tiny size as a subprocess and prints its test line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", f"cnn_graph_tpu_torch.experiments.{name}",
         "--device", "cpu", *DRIVERS[name]],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("test  ")]
    assert len(line) == 1 and "accuracy: " in line[0], proc.stdout[-2000:]


@pytest.mark.parametrize("argv,item", [(["--mesh-data", "2"],
                                        "torch.distributed.run")])
def test_mnist_driver_refuses_unported_flags(argv, item):
    """``--mesh-data`` runs one process per rank: launched alone, with no
    rendezvous to join, the driver refuses before any work."""
    from cnn_graph_tpu_torch.experiments import mnist

    with pytest.raises(RuntimeError, match=item):
        mnist.main(["--device", "cpu", *argv])


def test_text_driver_refuses_baselines(monkeypatch):
    """Without scikit-learn (the card's machine has none) ``--baselines``
    raises ``ImportError`` naming it before any training; with it the
    baselines run (tests/test_torch_utils.py)."""
    from cnn_graph_tpu_torch.experiments import text20news

    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        text20news.main(["--device", "cpu", "--synthetic", "--epochs", "1",
                         "--baselines"])
