"""Plain per-node LSTM baseline: no graph structure at all.

Counterpart of ``cnn_graph_tpu/models/node_lstm.py``: ``PerNodeLSTM``
(:41) and ``stack_lstm_collection`` (:28).  The humanflow workflow judges
the graph models against a per-node LSTM trained on each region's own
in/out-flow series (``HumanTraffic.load_lstm_data``); the M independent
LSTMs run as one batched loop, every product a batched ``einsum`` over
the node axis of the parameters.  Weights Uniform(-0.1, 0.1); MSE loss,
the ReLU prediction head in the Trainer (``task="regression"``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cnn_graph_tpu_torch.models import common
from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.ops.laplacian import _resolve_device

__all__ = ["PerNodeLSTM", "stack_lstm_collection"]


def stack_lstm_collection(collection: list[dict]) -> dict:
    """``load_lstm_data``'s per-node datasets as node-batched float32
    arrays: ``train_data`` ``[S, n_nodes, 2*seq]``, ``train_labels`` ``[S,
    n_nodes, 2]``, the same for test."""
    return {key: np.stack([c[key] for c in collection], axis=1).astype(
                np.float32)
            for key in ("train_data", "train_labels", "test_data",
                        "test_labels")}


class PerNodeLSTM(nn.Module):
    """M independent 2-feature LSTMs, one per node, trained together.
    ``x`` ``[B, n_nodes, 2*seq]`` (the in-flow window, then the out-flow
    window; step t feeds ``(in[t], out[t])``) -> the next step's ``(in,
    out)`` ``[B, n_nodes, 2]``.  Parameters: ``Wx`` ``[n, 2, 4h]``, ``Wh``
    ``[n, h, 4h]``, ``b`` ``[n, 4h]``, ``Wo`` ``[n, h, 2]``, ``bo`` ``[n,
    2]``, drawn from ``generator`` on ``device``: the CUDA device unless
    one is given (it raises where there is none)."""

    FEAT = 2

    def __init__(self, n_nodes: int, seq: int, num_hidden: int = 32,
                 forget_bias: float = 1.0, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.n_nodes = n_nodes
        self.seq = seq
        self.num_hidden = num_hidden
        self.forget_bias = forget_bias
        n, h, f = n_nodes, num_hidden, self.FEAT
        device = _resolve_device(device)
        draw = dict(generator=generator, device=device)
        self.weights = common.ParamTree({
            "Wx": common.uniform_init((n, f, 4 * h), **draw),
            "Wh": common.uniform_init((n, h, 4 * h), **draw),
            "b": torch.zeros((n, 4 * h), device=device),
            "Wo": common.uniform_init((n, h, f), **draw),
            "bo": torch.zeros((n, f), device=device)})

    def param_tree(self) -> dict:
        """The module's parameters in the JAX package's layout."""
        return self.weights.tree()

    def apply(self, params, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        B, n, twoseq = x.shape
        if n != self.n_nodes or twoseq != 2 * self.seq:
            raise ValueError(f"x {tuple(x.shape)} does not take {self.n_nodes}"
                             f" nodes of {self.seq} steps")
        H = self.num_hidden
        # [B, n, 2*seq] -> time-major [seq, B, n, 2] of (in_t, out_t).
        seq_x = torch.stack([x[:, :, :self.seq], x[:, :, self.seq:]],
                            -1).permute(2, 0, 1, 3)
        c = h = x.new_zeros((B, n, H))
        with full_f32_matmul():
            for xt in seq_x:
                pre = (torch.einsum("bnf,nfh->bnh", xt, params["Wx"])
                       + torch.einsum("bnh,nhg->bng", h, params["Wh"])
                       + params["b"])
                z = torch.tanh(pre[..., :H])
                i = torch.sigmoid(pre[..., H:2 * H])
                f = torch.sigmoid(pre[..., 2 * H:3 * H] + self.forget_bias)
                o = torch.sigmoid(pre[..., 3 * H:])
                c = f * c + i * z
                h = o * torch.tanh(c)
            return torch.einsum("bnh,nhf->bnf", h, params["Wo"]) + params["bo"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.param_tree(), x)

    def loss(self, params, x: torch.Tensor, y: torch.Tensor, *,
             train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        pred = self.apply(params, x, train=train, generator=generator)
        return ((y - pred) ** 2).mean()
