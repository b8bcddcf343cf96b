"""Training runtime: device-resident data, steps that never wait for the
host, periodic evaluation, checkpoints.

Counterpart of ``cnn_graph_tpu/train/trainer.py``: ``TrainConfig`` (:38)
and ``Trainer`` (:70) with ``fit`` (:242), ``predict`` (:345),
``evaluate`` (:371), ``_metrics`` (:379), ``_device_batches`` (:405),
``_evaluate_device`` (:424) and ``_EpochSampler`` (:434), with the same
semantics:

* the training set is uploaded once per ``fit``; each eval interval
  uploads one ``[chunk, batch]`` index tensor, and each step gathers its
  rows on the device (JAX runs the chunk as one ``lax.scan``; here the
  step loop enqueues work without waiting: losses, the loss EMA, the
  optimizer state and its step count stay device tensors, and nothing
  calls ``.item()`` per step);
* batches are drawn without replacement, epoch-permutation style;
* the optimizer chain is optax's (``train/optim.py``);
* evaluation pads the last batch with zeros and fetches once.

The model protocol is the port's: ``param_tree()``, ``loss(params, x, y,
*, train, generator)`` and ``apply(params, x)``.  Dropout masks come from
a ``torch.Generator`` on the model's device seeded with ``config.seed``,
so they are not ``jax.random``'s.  The Trainer runs on the device of the
model's operator (``models.common.operator_device``).

``TrainConfig.mesh`` (JAX :58-67, :135-151, :257-263) is a
``parallel.Mesh``; every rank runs ``fit`` with the same arguments.
Each step's batch is drawn as on one device and split over ``data``
(each rank takes its slice; the batch must divide); the parameters and
the optimizer state start as global rank 0's; the gradients are summed
over ``nodes`` and averaged over ``data`` (``Mesh.sync_grads``) before
the update; dropout draws the whole batch's mask and keeps this rank's
slice.  With ``nodes`` > 1 the model's operators are node-sharded on
that mesh: each rank takes its rows of the node axis (axis 1) of the
data, and of the targets, so the task must be ``regression`` (targets
per node); predictions are gathered over ``nodes``.  Checkpoints and
the metrics stream are written by global rank 0 alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from cnn_graph_tpu_torch.models.common import (
    operator_device,
    tree_leaves,
    tree_map,
)
from cnn_graph_tpu_torch.train.checkpoint import CheckpointManager
from cnn_graph_tpu_torch.train.optim import Optimizer
from cnn_graph_tpu_torch.utils.logging import MetricsLogger
from cnn_graph_tpu_torch.utils.metrics import weighted_f1
from cnn_graph_tpu_torch.utils.profiling import span

__all__ = ["TrainConfig", "Trainer"]

TASKS = ("regression", "classification", "sequence")


@dataclasses.dataclass
class TrainConfig:
    num_epochs: int = 20
    learning_rate: float = 0.1
    decay_rate: float = 0.95
    decay_steps: int | None = None
    momentum: float = 0.9
    batch_size: int = 100
    eval_frequency: int = 200
    optimizer: str = "adam"  # adam | sgd | rmsprop
    grad_clip: float | None = None  # global-norm clip
    seed: int = 2017
    loss_ema_decay: float = 0.9
    check_numerics: bool = False  # skip non-finite updates
    checkpoint_dir: str | None = None  # enables periodic save + resume
    checkpoint_keep: int = 5
    log_path: str | None = None  # JSONL metrics stream
    # Data x node parallelism over a parallel.Mesh (see the module's
    # docstring).
    mesh: Any = None


class Trainer:
    """Drives a model exposing ``param_tree()``, ``loss(params, x, y, *,
    train, generator)`` and ``apply(params, x)``.

    ``task``: ``regression`` (ReLU prediction head, MSE), ``classification``
    (argmax head, accuracy and weighted F1) or ``sequence`` (argmax over
    the last axis per batch, step and node).  ``params`` is None until
    ``fit`` takes the model's own; set it first to train others.
    """

    def __init__(self, model, config: TrainConfig,
                 task: str = "regression"):
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}; one of {TASKS}")
        mesh = config.mesh
        self.node_op = None
        if mesh is not None:
            assert "data" in mesh.axis_names, mesh
            n_dp = mesh.shape["data"]
            assert config.batch_size % n_dp == 0, (
                f"batch_size {config.batch_size} not divisible by the "
                f"mesh's data axis ({n_dp})")
            if mesh.shape["nodes"] > 1:
                self.node_op = _node_sharded_operator(model, mesh, task)
        self.model = model
        self.config = config
        self.task = task
        self.params = None
        self.opt_state = None
        self.optimizer = Optimizer(config)
        self.device = _model_device(model)

    # ---- high-level API (fit / predict / evaluate) ----

    def fit(self, train_data, train_labels, val_data, val_labels,
            verbose: bool = True):
        """Train; returns ``(metric_history, val_losses, t_step_seconds)``
        as the JAX Trainer does."""
        c = self.config
        t_wall = time.time()
        if self.params is None:
            self.params = self.model.param_tree()
        params = _canonical(tree_map(
            lambda t: torch.as_tensor(t).detach().to(self.device).clone(),
            self.params))
        opt_state = self.optimizer.init(tree_leaves(params))
        lead = self._lead
        verbose = verbose and lead

        n = train_data.shape[0]
        data = self._node_rows(torch.as_tensor(np.asarray(train_data)).to(
            self.device))
        labels = self._node_rows(torch.as_tensor(np.asarray(
            train_labels)).to(self.device))
        num_steps = int(c.num_epochs * n / c.batch_size)

        ema = torch.tensor(-1.0, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        sampler = _EpochSampler(n, c.seed)
        metric_hist, loss_hist = [], []
        val_batched = self._device_batches(val_data, val_labels)

        mngr = logger = None
        step = 0
        if c.checkpoint_dir:
            mngr = CheckpointManager(c.checkpoint_dir,
                                     max_to_keep=c.checkpoint_keep)
            if mngr.latest_step() is not None:
                params, opt_state, step = mngr.restore(params, opt_state)
                if verbose:
                    print(f"resumed from checkpoint at step {step}")
        if c.mesh is not None:
            # Every rank starts from global rank 0's state.
            from cnn_graph_tpu_torch.parallel.mesh import replicated

            replicated(c.mesh, (params, opt_state))
        if c.log_path and lead:
            logger = MetricsLogger(c.log_path)

        while step < num_steps:
            # One uploaded index tensor per eval interval.
            chunk = min(c.eval_frequency, num_steps - step)
            idx = torch.from_numpy(np.stack(
                [sampler.next_batch(c.batch_size) for _ in range(chunk)]
            )).to(self.device)
            for i in range(chunk):
                rows = self._data_rows(idx[i])
                opt_state, ema = self._train_step(
                    params, opt_state, ema, self._draws(gen), data[rows],
                    labels[rows])
            step += chunk
            if step % c.eval_frequency == 0 or step == num_steps:
                self.params, self.opt_state = params, opt_state
                string, metrics = self._evaluate_device(
                    params, val_batched, val_labels)
                metric_hist.append(metrics["main"])
                loss_hist.append(metrics["loss"])
                ema_host = float(ema)
                if logger:
                    logger.log(step, loss_ema=ema_host,
                               val_metric=metrics["main"],
                               val_loss=metrics["loss"])
                if mngr and lead:
                    mngr.save(step, params, opt_state)
                if verbose:
                    epoch = step * c.batch_size / n
                    print(f"step {step} / {num_steps} (epoch {epoch:.2f} / "
                          f"{c.num_epochs}):")
                    print(f"  loss_average = {ema_host:.2e}")
                    print(f"  validation {string}")
                    print(f"  time: wall {time.time() - t_wall:.0f}s")

        self.params, self.opt_state = params, opt_state
        if mngr and lead:
            mngr.wait()
            mngr.close()
        if logger:
            logger.close()
        t_step = (time.time() - t_wall) / num_steps
        return metric_hist, loss_hist, t_step

    def predict(self, data, labels=None):
        """Batched inference with a zero-padded final batch.  Returns the
        predictions, and the size-weighted mean loss when labels are
        given."""
        c = self.config
        n = data.shape[0]
        preds = []
        total_loss = 0.0
        for begin in range(0, n, c.batch_size):
            end = min(begin + c.batch_size, n)
            batch = np.zeros((c.batch_size,) + data.shape[1:], data.dtype)
            batch[: end - begin] = data[begin:end]
            xb = self._node_rows(torch.from_numpy(batch).to(self.device))
            if labels is not None:
                yb = np.zeros((c.batch_size,) + labels.shape[1:],
                              labels.dtype)
                yb[: end - begin] = labels[begin:end]
                out, loss = self._eval_batch(
                    self.params, xb,
                    self._node_rows(torch.from_numpy(yb).to(self.device)))
                total_loss += float(loss)
            else:
                out = self._eval_batch(self.params, xb)
            preds.append(out.cpu().numpy()[: end - begin])
        predictions = np.concatenate(preds, axis=0)
        if labels is not None:
            return predictions, total_loss * c.batch_size / n
        return predictions

    def evaluate(self, data, labels):
        """Metrics and the report line: regression the MSE over all
        outputs, classification accuracy and weighted F1."""
        outputs, loss = self.predict(data, labels)
        return self._metrics(outputs, labels, loss)

    # ---- internals ----

    @property
    def _lead(self) -> bool:
        """Whether this process writes checkpoints, logs and reports:
        global rank 0, or the only process."""
        import torch.distributed as dist

        return self.config.mesh is None or dist.get_rank() == 0

    def _node_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the node axis (axis 1) of a batch-leading
        tensor, where the model's operators are node-sharded."""
        if self.node_op is None:
            return t
        return self.node_op.local_rows(t, axis=1).contiguous()

    def _gather_nodes(self, out: torch.Tensor) -> torch.Tensor:
        """The model's outputs on every rank's rows, ``[B, m, ...]``."""
        if self.node_op is None:
            return out
        full = self.config.mesh.all_gather(out.transpose(0, 1).contiguous(),
                                           "nodes")
        return full.transpose(0, 1)[:, :self.node_op.m]

    def _data_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """This rank's slice over ``data`` of one step's batch indices."""
        if self.config.mesh is None:
            return idx
        from cnn_graph_tpu_torch.parallel.mesh import data_sharding

        return data_sharding(self.config.mesh, idx)

    def _draws(self, gen):
        """The step's dropout generator: over ``data``, the whole batch's
        masks, this rank's slice of them."""
        mesh = self.config.mesh
        if mesh is None or mesh.shape["data"] == 1:
            return gen
        from cnn_graph_tpu_torch.models.common import shard_draw

        b = self.config.batch_size // mesh.shape["data"]
        return shard_draw(gen, 0, mesh.coord("data") * b,
                          self.config.batch_size)

    def _train_step(self, params, opt_state, ema, gen, x, y):
        """One step on ``params`` in place: loss and gradients, the
        optimizer chain, the EMA (which takes the first loss as it is).
        Returns the new ``(opt_state, ema)``; nothing waits for the
        device.  The step is the unit span ``train.step``, the chain and
        EMA the span ``train.optimizer``, timed on the card."""
        with span("train.step", unit=True):
            c = self.config
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            with torch.enable_grad():
                loss = self.model.loss(params, x, y, train=True,
                                       generator=gen)
                grads = torch.autograd.grad(loss, leaves)
            mesh = c.mesh
            if mesh is not None:
                grads = mesh.sync_grads(list(grads))
                if mesh.shape["data"] > 1:
                    loss = mesh.all_reduce(loss.detach().clone(), "data") / (
                        mesh.shape["data"])
            with torch.no_grad(), span("train.optimizer", device=True):
                updates, opt_state = self.optimizer.update(grads, opt_state)
                for p, u in zip(leaves, updates):
                    p.add_(u)
                loss = loss.detach()
                ema = torch.where(ema < 0, loss, c.loss_ema_decay * ema
                                  + (1 - c.loss_ema_decay) * loss)
            return opt_state, ema

    def _eval_batch(self, params, x, y=None):
        """The prediction head on one batch and, given labels, the loss."""
        with torch.inference_mode():
            out = self.model.apply(params, x)
            if self.task == "regression":
                out = torch.relu(out)
            out_all = self._gather_nodes(out)
            if y is None:
                return out_all
            return out_all, self.model.loss(params, x, y)

    def _metrics(self, outputs, labels, loss):
        if self.task == "regression":
            mse = float(np.sum((labels - outputs) ** 2) / outputs.size)
            string = f"mse: {mse:.5f} ({len(labels):d}), loss: {loss:.2e}"
            return string, {"main": mse, "mse": mse, "loss": loss,
                            "predictions": outputs}
        if self.task == "sequence":
            pred = np.argmax(outputs, axis=-1)
            accuracy = 100.0 * float(np.mean(pred == labels))
            string = (f"seq accuracy: {accuracy:.2f} ({len(labels):d}), "
                      f"loss: {loss:.2e}")
            return string, {"main": accuracy, "accuracy": accuracy,
                            "loss": loss, "predictions": pred}
        pred_classes = np.argmax(outputs, axis=1)
        accuracy = 100.0 * float(np.mean(pred_classes == labels))
        f1 = weighted_f1(labels, pred_classes)
        string = (f"accuracy: {accuracy:.2f} ({len(labels):d}), "
                  f"f1 (weighted): {f1:.2f}, loss: {loss:.2e}")
        return string, {"main": accuracy, "accuracy": accuracy, "f1": f1,
                        "loss": loss, "predictions": pred_classes}

    def _device_batches(self, data, labels):
        """Pad to a whole number of batches and upload once (this rank's
        node rows, where the operators are node-sharded)."""
        B = self.config.batch_size
        n = data.shape[0]
        nb = -(-n // B)
        pad = nb * B - n
        if pad:
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], data.dtype)])
            labels = np.concatenate(
                [labels, np.zeros((pad,) + labels.shape[1:], labels.dtype)])
        data, labels = (self._node_rows(torch.from_numpy(
            np.ascontiguousarray(a)).to(self.device)) for a in (data, labels))
        return (data.reshape((nb, B) + data.shape[1:]),
                labels.reshape((nb, B) + labels.shape[1:]), n)

    def _evaluate_device(self, params, batched, labels):
        """Evaluate pre-batched device data, with one fetch (the span
        ``train.evaluate``)."""
        data_b, labels_b, n = batched
        with span("train.evaluate"):
            outs = [self._eval_batch(params, x, y)
                    for x, y in zip(data_b, labels_b)]
            preds = torch.stack([o for o, _ in outs])
            losses = torch.stack([l.to(preds.dtype) for _, l in outs])
            shape, size = tuple(preds.shape), preds.numel()
            flat = torch.cat([preds.reshape(-1), losses]).cpu().numpy()
        outputs = flat[:size].reshape((-1,) + shape[2:])[:n]
        loss = float(flat[size:].sum()) * self.config.batch_size / n
        return self._metrics(outputs, labels, loss)


class _EpochSampler:
    """Without-replacement batch sampler: every sample is used once per
    epoch before any repeats."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.buffer = np.empty((0,), np.int64)

    def next_batch(self, batch_size: int) -> np.ndarray:
        while len(self.buffer) < batch_size:
            self.buffer = np.concatenate(
                [self.buffer, self.rng.permutation(self.n)])
        out, self.buffer = self.buffer[:batch_size], self.buffer[batch_size:]
        return out.astype(np.int32)


def _canonical(tree):
    """The tree with every dict's keys sorted, the leaf order of JAX's
    pytrees: the optimizer's flat state follows it, so that a checkpoint
    restores onto a tree built in any key order."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_canonical(v) for v in tree]
    return tree


def _node_sharded_operator(model, mesh, task: str):
    """The model's node-sharded operator on ``mesh``, which a ``nodes``
    axis needs: every graph operator of the model must be one."""
    if task != "regression":
        raise ValueError(
            f"a mesh with nodes > 1 shards the data's node axis: the task "
            f"must be regression (targets per node), not {task!r}")
    ops = getattr(model, "operators", None) or [getattr(model, "op", None)]
    if not ops or any(getattr(o, "mesh", None) is not mesh for o in ops):
        raise ValueError("a mesh with nodes > 1 needs the model's operators "
                         "node-sharded on that mesh (parallel.*_laplacian)")
    return ops[0]


def _model_device(model) -> torch.device:
    """The device of the model's first graph operator, else of its first
    parameter."""
    ops = getattr(model, "operators", None)
    op = ops[0] if ops else getattr(model, "op", None)
    if op is not None:
        return operator_device(op)
    return tree_leaves(model.param_tree())[0].device
