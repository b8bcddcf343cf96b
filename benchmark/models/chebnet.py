"""The ChebNet family's shared pieces, for the entries that serve and
train it (``benchmark/entries/chebnet_*.py``): the graph and dataset its
configuration names, the weights, the program's model, and the work its
convs need.

The configuration states the route of each conv: ``use_pallas`` builds
the operators for the fused kernels, and ``fused_convs`` says which convs
take K2 (and K3 for dW); the others take the stacked route.  The work
count follows the configuration, not the program's rule: where the
program routes a conv otherwise, the kernel's launches in the trace do
not match and its roofline is left out.  Weights are truncated normal
(std 0.1) and biases 0.1, the model's initializer, drawn on the device
from the run's seed.
"""

from __future__ import annotations

import numpy as np
import torch

from cnn_graph_tpu_torch.models import ChebNet
from cnn_graph_tpu_torch.ops import device_laplacian
from harness import compare, data, found, graphs
from harness import work as W

__all__ = ["Problem", "model"]


class Problem:
    """One run's graph levels, weights and the work of its passes."""

    def __init__(self, cfg, seed, device):
        self.cfg, self.device, self.seed = cfg, device, seed
        g = found.graph(cfg["graph"])
        self.Ls, self.perm = g["laplacians"], g["perm"]
        self.nnz = [int(graphs.rescale_laplacian(L).nnz) for L in self.Ls]
        logs = np.log2(np.asarray(cfg["p"], dtype=float))
        self.levels = [int(v) for v in
                       np.concatenate([[0], np.cumsum(logs[:-1])])]
        self.fins = [1] + list(cfg["F"][:-1])
        gen = torch.Generator(device=device).manual_seed(seed)
        self._params(gen)

    def _params(self, gen):
        """The weights as the program's tree (keys sorted, as the Trainer
        keeps them) and as ``{leaf name: tensor}``."""
        cfg = self.cfg
        m_in = (self.Ls[self.levels[-1]].shape[0] * cfg["F"][-1]
                // cfg["p"][-1])
        shapes, self.fc_dims = {}, []
        for i, (k, fin, fout) in enumerate(zip(cfg["K"], self.fins,
                                               cfg["F"])):
            shapes[f"gconv.{i}.w"] = (k, fin, fout)
        for j, m_out in enumerate(cfg["M"]):
            shapes[f"fc.{j}.w"] = (m_in, m_out)
            self.fc_dims.append((m_in, m_out))
            m_in = m_out
        ws = data.weights_from_seed(shapes, gen)

        def bias(shape):
            return torch.full(shape, 0.1, device=gen.device)

        self.tree = {"fc": [{"b": bias((o,)), "w": ws[f"fc.{j}.w"]}
                            for j, (_, o) in enumerate(self.fc_dims)],
                     "gconv": [{"b": bias((1, 1, f)), "w": ws[f"gconv.{i}.w"]}
                               for i, f in enumerate(cfg["F"])]}
        self.leaves = dict(compare.named_leaves(self.tree))

    def samples(self, sizes: tuple) -> dict:
        """``{"train"|"val"|"test": (x [n, nodes] f32, labels)}`` in the
        coarsening's order, from the run's seed."""
        d = found.dataset(self.cfg["data"], self.cfg, sizes, self.seed)
        return {key: (graphs.perm_data(x, self.perm).astype(np.float32), y)
                for key, (x, y) in d.items()}

    def conv(self, i):
        """``(m, nnz, K)`` of conv ``i``'s level."""
        lvl = self.levels[i]
        return self.Ls[lvl].shape[0], self.nnz[lvl], self.cfg["K"][i]

    def fused(self, i) -> bool:
        return bool(self.cfg["fused_convs"][i])

    def fused_conv(self, i, batch, fin, fout):
        m, nnz, K = self.conv(i)
        return W.fused_conv(nnz, m, batch, fin, fout, K, "float32")

    def stacked_conv(self, i, batch, fin, fout):
        """The stacked route: K - 1 hops on ``batch * fin`` columns, then K
        tap products."""
        m, nnz, K = self.conv(i)
        return (W.hop(nnz, m, batch * fin, "float32", "float32", 2)
                + W.hop(nnz, m, batch * fin, "float32", "float32", 3)
                * (K - 2) + W.dense(batch * m, fin, fout) * K)

    def forward_work(self, batch):
        """One forward pass: ``(Work, [cheby_conv_kernel launches])``."""
        total, k2 = W.Work(), []
        for i, (fin, fout) in enumerate(zip(self.fins, self.cfg["F"])):
            if self.fused(i):
                c = self.fused_conv(i, batch, fin, fout)
                k2.append(c)
                total = total + c
            else:
                total = total + self.stacked_conv(i, batch, fin, fout)
        for m_in, m_out in self.fc_dims:
            total = total + W.dense(batch, m_in, m_out)
        return total, k2


def model(cfg, Ls, device):
    ops = [device_laplacian(L, device=device,
                            use_pallas=cfg["operator"]["use_pallas"])
           for L in Ls]
    return ChebNet(ops, F=cfg["F"], K=cfg["K"], p=cfg["p"], M=cfg["M"],
                   dropout=cfg["dropout"],
                   regularization=cfg["regularization"])
