"""The NodeClassifier family's shared pieces, for the entries that serve
and train it (``benchmark/entries/nodecls_*.py``): the graph its
configuration names, the weights and labels, the program's model, and
the work its convs need.

The configuration file gives the graph (its ``kind`` and sizes) and the
model (K, input features, hidden widths, classes, the operator's
format).  Weights are truncated normal (std 0.1, the model's
initializer), biases zero, all drawn on the device from the run's seed;
each node's class is its spatial patch, and the features are the bench's
planted partition (a class signature per class plus unit noise), drawn
likewise.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.models import NodeClassifier
from harness import compare, data, found, graphs
from harness import work as W
from reference import node_classifier as ref

__all__ = ["DTYPES", "ROUNDINGS", "Problem", "model", "conv_hops",
           "forward_work"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The roundings a traffic mix may name for its reference or its controls.
ROUNDINGS = {"float32": ref.exact, "bfloat16": ref.round_bf16,
             "int8": ref.int8_scaled, "tf32": ref.round_tf32}


class Problem:
    """One run's graph, weights (the program's tree and ``{leaf name:
    tensor}``), labels and feature generator, from the seed."""

    def __init__(self, cfg, seed, device):
        self.cfg, self.device = cfg, device
        g = found.graph(cfg["graph"])
        self.L = g["laplacians"][0]
        self.m = self.L.shape[0]
        self.nnz = int(graphs.rescale_laplacian(self.L).nnz)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.widths = ([cfg["input_features"]] + list(cfg["hidden"])
                       + [cfg["num_classes"]])
        shapes = {f"convs.{i}.w": (cfg["K"], a, b) for i, (a, b) in
                  enumerate(zip(self.widths[:-1], self.widths[1:]))}
        ws = data.weights_from_seed(shapes, self.gen)
        self.tree = {"convs": [{"w": ws[f"convs.{i}.w"],
                                "b": torch.zeros(b, device=device)}
                               for i, b in enumerate(self.widths[1:])]}
        self.leaves = dict(compare.named_leaves(self.tree))
        self.labels = torch.from_numpy(data.patch_labels(
            g["positions"], cfg["num_classes"], cfg["feature_patches"]))

    def features(self, count: int) -> list:
        return data.planted_features(self.labels, self.cfg["num_classes"],
                                     self.cfg["input_features"], count,
                                     self.gen)

    def convs(self):
        return zip(self.widths[:-1], self.widths[1:])


def model(cfg, op):
    return NodeClassifier(op, cfg["input_features"], cfg["num_classes"],
                          hidden=cfg["hidden"], K=cfg["K"],
                          dropout=cfg["dropout"])


def conv_hops(p: Problem, cols: int, op_dt: str, x_dt: str) -> list:
    """The K - 1 launches of one forward recurrence: L@x, then hops."""
    K = p.cfg["K"]
    return ([W.hop(p.nnz, p.m, cols, op_dt, x_dt, 2)]
            + [W.hop(p.nnz, p.m, cols, op_dt, x_dt, 3)] * (K - 2))


def forward_work(p: Problem, op_dt: str, x_dt: str) -> tuple:
    """One forward pass: ``(Work, [band_rows_kernel launches])``; the taps
    are float32 products whatever the carries' type."""
    total, k1 = W.Work(), []
    for fin, fout in p.convs():
        hops = conv_hops(p, fin, op_dt, x_dt)
        k1 += hops
        for h in hops:
            total = total + h
        total = total + W.dense(p.m, fin, fout) * p.cfg["K"]
    return total, k1
