"""Training the NodeClassifier full-batch: ``adam_steps``, the step that
``train_node_classifier`` runs, on one continuous optimizer state, the
loss masked to a labelled share of the nodes.

Traffic keys: ``operator_dtype``, ``learning_rate``, ``label_share``,
``checked_steps``; the reference's precision ``reference_rounding`` (the
operator's values, carries, injections and adjoint hops) and ``taps``
(the tap and dW products' operands), each a name of
``models/node_classifier.py ROUNDINGS``; ``controls``: name -> the
reference's settings changed (``half``: the loss over half of the
labelled nodes, a fault), each read by ``benchmark/control.py`` against
the reference at the cell's own and above the cell's limits;
``observed``: the same, read for the record where the cell's numbers do
not separate them.
"""

from __future__ import annotations

import sys

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from cnn_graph_tpu_torch.ops import device_laplacian
from cnn_graph_tpu_torch.train import adam_steps
from harness import compare
from harness import work as W
from models import node_classifier as nc
from reference import node_classifier as ref

LOOP = "train"


class Session:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic = cfg, traffic
        self.p = nc.Problem(cfg, seed, device)
        self.feats = self.p.features(1)[0]
        self.labels = self.p.labels.to(device)
        self.mask = torch.rand(len(self.labels), generator=self.p.gen,
                               device=device) < traffic["label_share"]
        self.op_dtype = traffic["operator_dtype"]
        op = device_laplacian(self.p.L, fmt=cfg["operator_format"],
                              dtype=nc.DTYPES[self.op_dtype], device=device)
        self.model = nc.model(cfg, op)
        self.losses, self.grad_norms, self.change_norms = [], None, None
        self._p, self._opt = None, None

    def drive(self, on_step, on_eval):
        checked = self.traffic["checked_steps"]

        def seen(opt, args, kwargs):
            self._opt = opt

        hook = register_optimizer_step_post_hook(seen)

        def loss_of(p, step):
            self._p = p
            on_step(step)
            loss = self.model.loss(p, self.feats, self.labels, self.mask,
                                   train=True)
            if step < checked:
                self.losses.append(loss.detach())
            return loss

        try:
            adam_steps(self.p.tree, loss_of, steps=sys.maxsize,
                       learning_rate=self.traffic["learning_rate"])
        finally:
            hook.remove()

    def observe(self, step: int):
        named = compare.named_leaves(self._p)
        if step == 1:
            b1 = 0.9  # adam_steps' beta1: exp_avg is (1 - b1) g after a step
            state = self._opt.state if self._opt is not None else {}
            self.grad_norms = {
                k: (float(state[v]["exp_avg"].norm()) / (1 - b1)
                    if "exp_avg" in state.get(v, {}) else 0.0)
                for k, v in named}
        if step == self.traffic["checked_steps"]:
            self.change_norms = {
                k: float((v.detach() - self.p.leaves[k]).norm())
                for k, v in named}

    def warm(self):
        pass

    def work(self) -> dict:
        p, K, dt = self.p, self.cfg["K"], self.op_dtype
        total, k1 = nc.forward_work(p, dt, dt)
        for i, (fin, fout) in enumerate(p.convs()):
            total = total + W.dense(fin, p.m, fout) * K  # dW
            if i > 0:  # the adjoint chain: injections, K-2 hops with c, L@x
                total = total + W.dense(p.m, fout, fin, dt, dt, dt) * K
                adj = ([W.hop(p.nnz, p.m, fin, dt, dt, 4)] * (K - 2)
                       + [W.hop(p.nnz, p.m, fin, dt, dt, 2)])
                k1 += adj
                for h in adj:
                    total = total + h
        return {"step": {"total": total,
                         "kernels": {"band_rows_kernel": k1}},
                "eval": {"total": W.Work()}}

    def _reference(self, **change):
        s = {"reference_rounding": self.traffic["reference_rounding"],
             "taps": self.traffic.get("taps", "float32"), "half": False}
        s.update(change)
        mask = self.mask
        if s["half"]:
            mask = mask & (torch.cumsum(mask, 0) <= mask.sum() // 2)
        return ref.train_steps(
            self.p.L, self.p.leaves, self.feats, self.labels, mask,
            learning_rate=self.traffic["learning_rate"],
            steps=self.traffic["checked_steps"],
            rnd=nc.ROUNDINGS[s["reference_rounding"]],
            taps=nc.ROUNDINGS[s["taps"]])

    def _free(self):
        self.model = self._p = self._opt = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, kept=None) -> dict:
        losses = [float(x) for x in self.losses]
        self._free()
        got = {"losses": losses, "grad_norms": self.grad_norms,
               "change_norms": self.change_norms}
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
