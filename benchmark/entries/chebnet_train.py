"""Training the ChebNet through the ``Trainer``'s own step.

The ``Trainer`` has no public step: ``Session.drive`` runs
``Trainer.fit``'s loop (the epoch sampler, one uploaded index chunk per
evaluation interval, ``_train_step``, an evaluation of the validation set
after each interval) on one optimizer state from set-up through the
window.

Traffic keys: ``learning_rate``, ``decay_rate``, ``eval_frequency``,
``n_train``, ``n_val``, ``checked_steps``; ``reference_precision``
(``float64``) and ``controls``: name -> the reference's ``precision``
changed or ``half`` (half of each batch, a fault), each read by
``benchmark/control.py`` against the reference at the cell's own.
"""

from __future__ import annotations

import numpy as np
import torch

from cnn_graph_tpu_torch.models.common import tree_map
from cnn_graph_tpu_torch.train import TrainConfig, Trainer
from cnn_graph_tpu_torch.train.trainer import _EpochSampler
from harness import compare
from harness import work as W
from models import chebnet as cn
from reference import chebnet as ref

LOOP = "train"


class _LossTap:
    """The model with its training loss recorded: the checked steps' only
    difference from the window's."""

    def __init__(self, model, losses):
        self._model, self._losses = model, losses

    def loss(self, *a, **k):
        out = self._model.loss(*a, **k)
        self._losses.append(out.detach())
        return out

    def __getattr__(self, name):
        return getattr(self._model, name)


class Session:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device, self.seed = (cfg, traffic,
                                                          device, seed)
        self.p = cn.Problem(cfg, seed, device)
        d = self.p.samples((traffic["n_train"], traffic["n_val"], 0))
        self.train_x, self.train_y = (torch.from_numpy(a).to(device)
                                      for a in d["train"])
        self.val_x, self.val_y = d["val"]
        n = len(self.train_y)
        self.config = TrainConfig(
            learning_rate=traffic["learning_rate"],
            decay_rate=traffic["decay_rate"],
            decay_steps=n // cfg["batch_size"],
            batch_size=cfg["batch_size"],
            eval_frequency=traffic["eval_frequency"], seed=seed)
        self.trainer = Trainer(cn.model(cfg, self.p.Ls, device), self.config,
                               task="classification")
        self.losses, self.grad_norms, self.change_norms = [], None, None
        self._state = None
        self._val = None

    def drive(self, on_step, on_eval):
        t, c = self.trainer, self.config
        params = tree_map(lambda v: v.detach().clone(), self.p.tree)
        opt_state = t.optimizer.init([v for _, v in
                                      compare.named_leaves(params)])
        ema = torch.tensor(-1.0, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        sampler = _EpochSampler(len(self.train_y), c.seed)
        self._val = t._device_batches(self.val_x, self.val_y)
        checked = self.traffic["checked_steps"]
        model = t.model
        t.model = _LossTap(model, self.losses)
        step = 0
        while True:
            idx = torch.from_numpy(np.stack([
                sampler.next_batch(c.batch_size)
                for _ in range(c.eval_frequency)])).to(self.device)
            for i in range(c.eval_frequency):
                self._state = (params, opt_state)
                if step == checked:
                    t.model = model
                on_step(step)
                rows = t._data_rows(idx[i])
                opt_state, ema = t._train_step(
                    params, opt_state, ema, t._draws(gen),
                    self.train_x[rows], self.train_y[rows])
                step += 1
            self._state = (params, opt_state)
            with on_eval():
                t._evaluate_device(params, self._val, self.val_y)

    def observe(self, step: int):
        params, opt_state = self._state
        named = compare.named_leaves(params)
        if step == 1:
            b1 = 0.9  # the Trainer's adam: mu is (1 - b1) g after one step
            self.grad_norms = {k: float(mu.norm()) / (1 - b1) for (k, _), mu
                               in zip(named, opt_state["mu"])}
        if step == self.traffic["checked_steps"]:
            self.change_norms = {
                k: float((v.detach() - self.p.leaves[k]).norm())
                for k, v in named}

    def warm(self):
        params, _ = self._state
        self.trainer._evaluate_device(params, self._val, self.val_y)

    def work(self) -> dict:
        B, p = self.cfg["batch_size"], self.p
        fwd, k2 = p.forward_work(B)
        step, kernels = fwd, list(k2)
        for i, (fin, fout) in enumerate(zip(p.fins, self.cfg["F"])):
            m, nnz, K = p.conv(i)
            if p.fused(i):
                dw = p.fused_conv(i, B, fin, fout)  # K3
                kernels.append(dw)
                step = step + dw
                if i > 0:  # dx: K2 on g with the taps transposed
                    dx = p.fused_conv(i, B, fout, fin)
                    kernels.append(dx)
                    step = step + dx
            else:
                step = step + W.dense(fin, B * m, fout) * K  # dW
                if i > 0:  # dx: K injections, the adjoint recurrence
                    step = (step + W.dense(B * m, fout, fin) * K
                            + W.hop(nnz, m, B * fin, "float32", "float32", 4)
                            * (K - 2)
                            + W.hop(nnz, m, B * fin, "float32", "float32", 2))
        for m_in, m_out in p.fc_dims:
            step = step + W.dense(m_in, B, m_out) + W.dense(B, m_out, m_in)
        # An evaluation runs each padded batch forward twice: for the
        # predictions and for the loss (Trainer._eval_batch).
        passes = 2 * -(-len(self.val_y) // B)
        return {"step": {"total": step,
                         "kernels": {"cheby_conv_kernel": kernels}},
                "eval": {"total": fwd * passes,
                         "kernels": {"cheby_conv_kernel": k2 * passes}}}

    def _reference(self, precision=None, half=False):
        steps = self.traffic["checked_steps"]
        B = self.cfg["batch_size"]
        batches = ref.epoch_batches(len(self.train_y), B, self.seed, steps)
        masks = ref.dropout_masks((B, self.cfg["M"][0]), self.cfg["dropout"],
                                  self.seed, self.device, steps)
        if half:
            batches = [b[:B // 2] for b in batches]
            masks = [m[:B // 2] for m in masks]
        return ref.train_steps(
            ref.dense_operators(self.p.Ls, self.device), self.p.levels,
            self.cfg["p"], self.p.leaves, self.train_x, self.train_y,
            batches, masks, keep=self.cfg["dropout"],
            regularization=self.cfg["regularization"],
            learning_rate=self.traffic["learning_rate"],
            decay_rate=self.traffic["decay_rate"],
            decay_steps=len(self.train_y) // B,
            precision=precision or self.traffic["reference_precision"])

    def _free(self):
        self.trainer = self._state = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, kept=None) -> dict:
        got = {"losses": [float(x) for x in self.losses[:self.traffic[
                   "checked_steps"]]],
               "grad_norms": self.grad_norms,
               "change_norms": self.change_norms}
        self._free()
        self.detail = []
        return compare.train_readings(got, self._reference(), self.detail)

    def control(self, which: str = "controls") -> dict:
        """Each of the mix's ``controls`` and faults (or ``observed``)
        against the reference at the cell's own precision."""
        self._free()
        want = self._reference()
        return {name: compare.train_readings(self._reference(**change), want)
                for name, change in self.traffic.get(which, {}).items()}


def session(cfg, traffic, seed, device):
    return Session(cfg, traffic, seed, device)
