"""Serving the ChebNet: one request is the logits of a batch of samples,
through ``compile_serving`` on the float operators.

Traffic keys: ``ring`` (distinct batches, made at set-up), ``warmup``,
``check_sample``; ``reference_precision`` (``float64``) and
``controls``: name -> the reference's ``precision`` changed (``tf32``),
each read by ``benchmark/control.py`` against the reference at the
cell's own.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.serve import compile_serving
from harness import compare
from models import chebnet as cn
from reference import chebnet as ref

LOOP = "serve"


class Session:
    def __init__(self, cfg, traffic, seed, device):
        if traffic.get("int8", False):
            raise ValueError("the ChebNet reference computes in float; an "
                             "int8 mix needs an int8 reference beside it")
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.p = cn.Problem(cfg, seed, device)
        B, R = cfg["batch_size"], traffic["ring"]
        x, _ = self.p.samples((0, 0, B * R))["test"]
        self.inputs = list(torch.from_numpy(x).to(device).reshape(R, B, -1))
        self.handle = compile_serving(cn.model(cfg, self.p.Ls, device),
                                      self.p.tree, self.inputs[0],
                                      int8=False)

    def call(self, x):
        return self.handle(x)

    def work(self) -> dict:
        total, k2 = self.p.forward_work(self.cfg["batch_size"])
        return {"request": {"total": total,
                            "kernels": {"cheby_conv_kernel": k2}}}

    def _free(self):
        self.handle = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _reference(self, ops, x, precision=None):
        return ref.logits(ops, self.p.levels, self.cfg["p"], self.p.leaves,
                          x, precision=precision or self.traffic[
                              "reference_precision"])

    def check(self, kept) -> dict:
        self._free()
        ops = ref.dense_operators(self.p.Ls, self.device)
        ring, B = len(self.inputs), self.cfg["batch_size"]
        by_input = {}
        for i, o in kept.items():
            by_input.setdefault(i % ring, []).append(o)
        gaps, order = [], sorted(by_input)
        for at in range(0, len(order), 32):
            chunk = order[at:at + 32]
            want = self._reference(
                ops, torch.cat([self.inputs[r] for r in chunk]))
            for j, r in enumerate(chunk):
                gaps += [compare.logit_gap(o, want[j * B:(j + 1) * B])
                         for o in by_input[r]]
        return {"logit_gap": max(gaps) if gaps else float("inf")}

    def control(self, which: str = "controls", n_inputs: int = 32) -> dict:
        """Each of the mix's ``controls`` (or ``observed``) against the
        reference at the cell's own precision, on the ring's first batches."""
        self._free()
        ops = ref.dense_operators(self.p.Ls, self.device)
        x = torch.cat(self.inputs[:n_inputs])
        want = self._reference(ops, x)
        return {name: {"logit_gap": compare.logit_gap(
                    self._reference(ops, x, change["precision"]), want)}
                for name, change in self.traffic.get(which, {}).items()}


def session(cfg, traffic, seed, device):
    return Session(cfg, traffic, seed, device)
