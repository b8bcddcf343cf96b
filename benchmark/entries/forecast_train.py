"""Training the graph-conv LSTM forecaster through the ``Trainer``'s own
step, on a regression task.

The session is ``chebnet_train``'s (its loop, observed steps, checks and
controls are this entry's too): ``Session.drive`` runs ``Trainer.fit``'s
loop (the epoch sampler, one uploaded index chunk per evaluation
interval, ``_train_step``, an evaluation of the validation windows after
each interval) on one optimizer state from set-up through the window.
Here the Trainer is ``Trainer(task="regression")`` with the TrainConfig
of ``experiments/humanflow.py`` (Adam, the rate decayed by
``decay_rate`` once an epoch), on ``device_laplacian(fmt=...)``'s
operator, and the reference is ``reference/forecaster.py``.

Traffic keys: ``learning_rate``, ``decay_rate``, ``eval_frequency``,
``checked_steps``; ``reference_precision`` (``float64``),
``reference_chunk`` (samples a reference gradient is summed over, so
that float64 fits on the card) and ``controls``: name -> the reference's
``precision`` changed or ``half`` (half of each batch, a fault), each
read by ``benchmark/control.py`` against the reference at the cell's
own.

On the card, set-up ends with a short ``torch.profiler`` session of its
own (``profiler_first_session``), so that a traced run's window is not
the process's first profiler session.  On an H100 (torch 2.11) the
first session of a process lost its last kernel, the window's end
marker, in 2 of 17 traced windows of this cell (``harness/trace.py``
then raises); later sessions of a process lost it in none of 38.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.train import TrainConfig, Trainer
from harness import found
from models import forecaster as fc
from reference import forecaster as ref

LOOP = "train"


class Session(found.entry("chebnet_train").Session):
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device, self.seed = (cfg, traffic,
                                                          device, seed)
        self.p = fc.Problem(cfg, seed, device)
        d = self.p.samples()
        self.train_x, self.train_y = (torch.from_numpy(a).to(device)
                                      for a in d["train"])
        self.val_x, self.val_y = d["val"]
        B = cfg["batch_size"]
        self.config = TrainConfig(
            learning_rate=traffic["learning_rate"],
            decay_rate=traffic["decay_rate"],
            decay_steps=max(len(self.train_y) // B, 1), batch_size=B,
            eval_frequency=traffic["eval_frequency"], seed=seed)
        self.trainer = Trainer(fc.model(cfg, self.p.L, device), self.config,
                               task="regression")
        self.losses, self.grad_norms, self.change_norms = [], None, None
        self._state = None
        self._val = None
        if device.type == "cuda":
            profiler_first_session(device)

    def work(self) -> dict:
        B = self.cfg["batch_size"]
        step, k1 = self.p.step_work(B)
        fwd, k1_fwd = self.p.forward_work(B)
        # An evaluation runs each padded batch forward twice: for the
        # predictions and for the loss (Trainer._eval_batch).
        passes = 2 * -(-len(self.val_y) // B)
        return {"step": {"total": step,
                         "kernels": {"band_rows_kernel": k1}},
                "eval": {"total": fwd * passes,
                         "kernels": {"band_rows_kernel": k1_fwd * passes}}}

    def _reference(self, precision=None, half=False):
        steps = self.traffic["checked_steps"]
        B = self.cfg["batch_size"]
        return ref.train_steps(
            ref.operator(self.p.L, self.device), self.p.tree, self.train_x,
            self.train_y,
            ref.epoch_batches(len(self.train_y), B, self.seed, steps),
            self.p.windows, keep=self.cfg["lstm_keep_prob"],
            learning_rate=self.traffic["learning_rate"],
            decay_rate=self.traffic["decay_rate"],
            decay_steps=self.config.decay_steps, seed=self.seed,
            layers=self.cfg["lstm_layer_count"],
            precision=precision or self.traffic["reference_precision"],
            chunk=self.traffic.get("reference_chunk"), half=half)


def profiler_first_session(device):
    """A ``torch.profiler`` session over one small kernel on ``device``,
    whose trace nothing reads."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def session(cfg, traffic, seed, device):
    return Session(cfg, traffic, seed, device)
