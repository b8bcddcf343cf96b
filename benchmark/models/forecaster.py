"""The forecaster family's shared pieces, for the entry that trains it
(``benchmark/entries/forecast_train.py``): the graph and the flow
windows its configuration names, the weights, the program's model, and
the work of its convs.

The configuration gives the graph (``kind`` and sizes), the operator's
format, the variant (``glstm_period_expand_gconv3``: closeness, period
and trend gLSTM stacks into a residual gconv stack and a head conv) and
its widths.  Weights are drawn on the device from the run's seed in the
program's tree, its dict keys sorted as the Trainer keeps them: the
cells' ``W*x``/``W*h`` Uniform(-0.1, 0.1) and biases 0 (the cell's
initializer), the convs truncated normal, std 0.1 (the stack's).

**The work** (``harness/work.py``) of one forward pass, conv by conv:
``K - 1`` hops on ``batch * Fin`` columns (K1: ``L @ x``, then ``2 L x1
- x0``) and ``K`` tap products ``[batch * M, Fin] @ [Fin, Fout]``; of a
training step's backward, each conv's dW (``K`` products) and, where its
input takes a gradient, the injections ``g W_k^T`` (``K`` products) and
the adjoint chain (``K - 2`` hops with an injection, then ``L @ s``).
An input takes no gradient where it is data (the first layer's x-conv)
or the cell's zero state (the h-conv of each window's first step).  The
gate math is element-wise: no operations, its bytes the program's own
``glstm_gate_bytes`` counter, which ``metrics/glstm_gates_roofline.py``
reads.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.models import GConvForecaster
from cnn_graph_tpu_torch.ops import device_laplacian
from harness import compare, data, found, graphs
from harness import work as W

__all__ = ["Problem", "model", "GATES"]

GATES = ("z", "i", "f", "o")


class Problem:
    """One run's graph, weights and the windows' layout, from the seed."""

    def __init__(self, cfg, seed, device):
        self.cfg, self.device, self.seed = cfg, device, seed
        g = found.graph(cfg["graph"])
        self.L = g["laplacians"][0]
        self.m = self.L.shape[0]
        self.nnz = int(graphs.rescale_laplacian(self.L).nnz)
        c = 2 * cfg["seq_closeness"]
        p = c + 2 * cfg["seq_period"]
        # (steps, first channel, end) of the closeness, period and trend
        # windows: each is [in-series, out-series] over its steps.
        self.windows = [(cfg["seq_closeness"], 0, c),
                        (cfg["seq_period"], c, p),
                        (cfg["seq_trend"], p, p + 2 * cfg["seq_trend"])]
        gen = torch.Generator(device=device).manual_seed(seed)
        self._params(gen)

    def _params(self, gen):
        cfg, dev = self.cfg, gen.device
        H, K, fin = cfg["num_hidden"], cfg["K"], cfg["in_features"]

        def cell(f):
            p = {}
            for g in GATES:
                p[f"W{g}x"] = torch.empty((K, f, H), device=dev)
                p[f"W{g}h"] = torch.empty((K, H, H), device=dev)
                p[f"b{g}"] = torch.zeros(H, device=dev)
            for k in sorted(p):
                if k.startswith("W"):
                    p[k].uniform_(-0.1, 0.1, generator=gen)
            return {k: p[k] for k in sorted(p)}

        lstms = [[cell(fin if j == 0 else H)
                  for j in range(cfg["lstm_layer_count"])]
                 for _ in self.windows]
        shapes = {"init": (K, 3 * H, H)}
        for r in range(cfg["conv_layer_num"]):
            shapes[f"res.{r}.w1"] = (K, H, H)
            shapes[f"res.{r}.w2"] = (K, H, H)
        shapes["head"] = (K, H, cfg["out_features"])
        ws = data.weights_from_seed(shapes, gen)
        self.tree = {
            "head": ws["head"],
            "lstms": lstms,
            "stack": {"init": ws["init"],
                      "res": [{"w1": ws[f"res.{r}.w1"],
                               "w2": ws[f"res.{r}.w2"]}
                              for r in range(cfg["conv_layer_num"])]}}
        self.leaves = dict(compare.named_leaves(self.tree))

    def samples(self) -> dict:
        """``{"train"|"val"|"test": (x, y)}`` float32 NumPy windows."""
        return found.dataset(self.cfg["data"], self.cfg,
                             (self.m, self.cfg["slots"]), self.seed)

    def convs(self):
        """``(fin, fout, takes dx)`` of each conv of one forward pass, in
        the order the program runs them."""
        cfg = self.cfg
        H, fin = cfg["num_hidden"], cfg["in_features"]
        out = []
        for T, _, _ in self.windows:
            for j in range(cfg["lstm_layer_count"]):
                for t in range(T):
                    out.append((fin if j == 0 else H, 4 * H, j > 0))
                    out.append((H, 4 * H, t > 0))
        out.append((3 * H, H, True))
        out += [(H, H, True)] * (2 * cfg["conv_layer_num"])
        out.append((H, cfg["out_features"], True))
        return out

    def forward_work(self, batch: int):
        """One forward pass: ``(Work, [band_rows_kernel launches])``."""
        K, m, nnz = self.cfg["K"], self.m, self.nnz
        total, k1 = W.Work(), []
        for fin, fout, _ in self.convs():
            cols = batch * fin
            hops = [] if K == 1 else (
                [W.hop(nnz, m, cols, "float32", "float32", 2)]
                + [W.hop(nnz, m, cols, "float32", "float32", 3)] * (K - 2))
            k1 += hops
            for h in hops:
                total = total + h
            total = total + W.dense(batch * m, fin, fout) * K
        return total, k1

    def step_work(self, batch: int):
        """One training step, forward and backward: ``(Work, [launches])``."""
        K, m, nnz = self.cfg["K"], self.m, self.nnz
        total, k1 = self.forward_work(batch)
        for fin, fout, dx in self.convs():
            total = total + W.dense(fin, batch * m, fout) * K  # dW
            if dx and K > 1:
                cols = batch * fin
                total = total + W.dense(batch * m, fout, fin) * K
                adj = ([W.hop(nnz, m, cols, "float32", "float32", 4)]
                       * (K - 2)
                       + [W.hop(nnz, m, cols, "float32", "float32", 2)])
                k1 += adj
                for h in adj:
                    total = total + h
        return total, k1


def model(cfg, L, device):
    """The program's model on ``device_laplacian(fmt=...)``'s operator of
    ``L``; its own weights are drawn and left unused (the Trainer takes
    the run's)."""
    op = device_laplacian(L, fmt=cfg["operator_format"], device=device)
    return GConvForecaster(
        op, seq_closeness=cfg["seq_closeness"],
        seq_period=cfg["seq_period"], seq_trend=cfg["seq_trend"],
        variant=cfg["variant"], num_hidden=cfg["num_hidden"],
        conv_layer_num=cfg["conv_layer_num"],
        lstm_layer_count=cfg["lstm_layer_count"], K=cfg["K"],
        in_features=cfg["in_features"], out_features=cfg["out_features"],
        lstm_keep_prob=cfg["lstm_keep_prob"],
        generator=torch.Generator(device=device).manual_seed(0),
        device=device)
