"""Serving the NodeClassifier: one request is the whole graph's logits
for one feature matrix, through the handle the traffic mix names.

Traffic keys:

* ``int8``: serve the operator's int8 twin (``qmax``, ``headroom``), or
  the float operator of ``operator_dtype``;
* ``handle``: ``compiled`` (``compile_serving``) or ``loaded`` (the
  ``torch.export`` artifact written by ``export_serving`` under the run's
  ``TMPDIR`` and read back by ``load_serving``, with no model code);
* ``features``: ``device`` (the ring of feature matrices lives on the
  card) or ``host`` (in pinned host memory: each request uploads its
  matrix inside the timed call);
* ``ring``, ``warmup``, ``check_sample``: the serve loop's;
* the reference's precision: ``reference_rounding`` (float operators:
  the operator's values and carries) and ``taps`` (the tap products'
  operands), each a name of ``models/node_classifier.py ROUNDINGS``;
* ``controls``: name -> the reference's settings changed, each read by
  ``benchmark/control.py`` against the reference at the cell's own and
  above the cell's limits; ``observed``: the same, read for the record
  where the cell's numbers do not separate them.
"""

from __future__ import annotations

import tempfile

import torch

from cnn_graph_tpu_torch.ops import device_laplacian
from cnn_graph_tpu_torch.serve import (compile_serving, export_serving,
                                       load_serving)
from harness import compare
from models import node_classifier as nc
from reference import node_classifier as ref

LOOP = "serve"


class Session:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.p = nc.Problem(cfg, seed, device)
        self.inputs = self.p.features(traffic["ring"])
        self.int8 = bool(traffic["int8"])
        self.op_dtype = traffic.get("operator_dtype", "float32")
        op = device_laplacian(self.p.L, fmt=cfg["operator_format"],
                              dtype=nc.DTYPES[self.op_dtype], device=device)
        served = nc.model(cfg, op)
        kw = {"int8": self.int8, "headroom": traffic.get("headroom", 2.0)}
        self._artifact = None
        if traffic.get("handle", "compiled") == "loaded":
            self._artifact = tempfile.TemporaryDirectory(prefix="artifact-")
            export_serving(served, self.p.tree, self.inputs[0],
                           self._artifact.name, **kw)
            self.handle = load_serving(self._artifact.name)
        else:
            self.handle = compile_serving(served, self.p.tree,
                                          self.inputs[0], **kw)
        if traffic.get("features", "device") == "host":
            self.inputs = [x.cpu().pin_memory() if device.type == "cuda"
                           else x.cpu() for x in self.inputs]

    def call(self, x):
        return self.handle(x.to(self.device, non_blocking=True))

    def work(self) -> dict:
        dt = "int8" if self.int8 else self.op_dtype
        total, k1 = nc.forward_work(self.p, dt, dt)
        return {"request": {"total": total,
                            "kernels": {"band_rows_kernel": k1}}}

    def _free(self):
        self.handle = None
        if self._artifact is not None:
            self._artifact.cleanup()
            self._artifact = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _reference(self, x, **change):
        s = {"qmax": self.traffic.get("qmax", 127),
             "headroom": self.traffic.get("headroom", 2.0),
             "reference_rounding": self.traffic.get("reference_rounding",
                                                    self.op_dtype),
             "taps": self.traffic.get("taps", "float32")}
        s.update(change)
        x = x.to(self.device)
        taps = nc.ROUNDINGS[s["taps"]]
        if self.int8:
            return ref.serve_logits(self.p.L, self.p.leaves, x,
                                    qmax=s["qmax"], headroom=s["headroom"],
                                    taps=taps)
        return ref.float_logits(self.p.L, self.p.leaves, x,
                                rnd=nc.ROUNDINGS[s["reference_rounding"]],
                                taps=taps)

    def check(self, kept) -> dict:
        self._free()
        ring = len(self.inputs)
        gaps = []
        for r in range(ring):
            outs = [o for i, o in kept.items() if i % ring == r]
            if outs:
                want = self._reference(self.inputs[r])
                gaps += [compare.logit_gap(o, want) for o in outs]
        return {"logit_gap": max(gaps) if gaps else float("inf")}

    def control(self, which: str = "controls", n_inputs: int = 2) -> dict:
        """Each of the mix's ``controls`` (or ``observed``) against the
        reference at the cell's own precision, on the ring's first inputs."""
        self._free()
        out = {}
        for name, change in self.traffic.get(which, {}).items():
            out[name] = {"logit_gap": max(compare.logit_gap(
                self._reference(x, **change), self._reference(x))
                for x in self.inputs[:n_inputs])}
        return out


def session(cfg, traffic, seed, device):
    return Session(cfg, traffic, seed, device)
