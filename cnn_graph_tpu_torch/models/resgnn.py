"""ResGNN: deep residual spectral graph ConvNet for node-level regression.

Counterpart of ``cnn_graph_tpu/models/resgnn.py:29``, the fork's working
flow-prediction model (``GraphConv``, lib/graph_conv.py:12-330): an
init conv lifts the input channels to ``nfilter`` features,
``nres_layer_count`` residual blocks (two convs each, an identity skip
merged before the activation) refine them, and a final conv projects to
the 2-channel in/out-flow output.  With ``stack_splits`` the input
channels are split into parallel towers whose ReLU outputs are merged
with learned per-node weights (graph_conv.py:276-300).  No biases, the
fork's plain relu/tanh; MSE loss, and the ReLU prediction head lives in
the Trainer (``task="regression"``).

Parameters use the JAX package's layout: ``{"tower": {"conv_init",
"res": [{"w1", "w2"}], "conv_out"}}``, or ``{"towers": [...], "merge_w":
[[M, out]]}`` with ``stack_splits``; Chebyshev weights ``[K, Fin,
Fout]``, Fourier ``[M, Fout, Fin]``.  On a dense operator the 64-wide
residual convs take the fused kernels K2 and K3 where ``cheby_conv``
finds them eligible (the JAX rule): 8 K2 forward, 8 K2 dx and 8 K3 per
training step at ``nres_layer_count`` 4.
"""

from __future__ import annotations

import torch
from torch import nn

from cnn_graph_tpu_torch.models import common
from cnn_graph_tpu_torch.ops.filters import cheby_conv, fourier_conv

__all__ = ["ResGNN"]

_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


class ResGNN(nn.Module):
    """``operator``: the device Laplacian; ``stack_splits``: optional
    ``(start, end)`` channel ranges, one tower each (None: one tower over
    all channels).  ``filter``: ``chebyshev`` or ``fourier``, which needs
    ``fourier_u``, the ``[M, M]`` eigenbasis (``graphs.fourier``).
    Weights are drawn from ``generator`` (truncated normal, std 0.1) and
    live on ``device``, by default the operator's.  ``apply`` shadows
    ``nn.Module.apply``."""

    def __init__(self, operator, input_features: int, K: int = 2,
                 nfilter: int = 64, nres_layer_count: int = 4,
                 out_features: int = 2, activation: str = "relu",
                 residual: bool = True,
                 stack_splits: list[tuple[int, int]] | None = None,
                 filter: str = "chebyshev", fourier_u=None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if filter not in ("chebyshev", "fourier"):
            raise ValueError(f"unknown filter {filter!r}")
        if filter == "fourier" and fourier_u is None:
            raise ValueError("the fourier filter needs fourier_u")
        if stack_splits and not all(e > s for s, e in stack_splits):
            raise ValueError(f"empty channel range in {stack_splits}")
        if device is None:
            device = common.operator_device(operator)
        self.op = operator
        self.input_features = input_features
        self.K = K
        self.nfilter = nfilter
        self.nres = nres_layer_count
        self.out_features = out_features
        self.act = _ACTS[activation]
        self.residual = residual
        self.stack_splits = stack_splits
        self.filter = filter
        self.fourier_u = (None if fourier_u is None else torch.as_tensor(
            fourier_u, dtype=torch.float32).to(device))
        draw = dict(generator=generator, device=device)

        def conv_init(fin, fout):
            shape = ((K, fin, fout) if filter == "chebyshev"
                     else (operator.m, fout, fin))
            return common.trunc_normal(shape, **draw)

        def tower(fin):
            return {"conv_init": conv_init(fin, nfilter),
                    "res": [{"w1": conv_init(nfilter, nfilter),
                             "w2": conv_init(nfilter, nfilter)}
                            for _ in range(nres_layer_count)],
                    "conv_out": conv_init(nfilter, out_features)}

        if not stack_splits:
            tree = {"tower": tower(input_features)}
        else:
            tree = {"towers": [], "merge_w": []}
            for s, e in stack_splits:
                tree["towers"].append(tower(e - s))
                tree["merge_w"].append(common.trunc_normal(
                    (operator.m, out_features), **draw))
        self.weights = common.ParamTree(tree)

    def param_tree(self) -> dict:
        """The module's parameters in the JAX package's layout."""
        return self.weights.tree()

    def _conv(self, w, x):
        if self.filter == "chebyshev":
            return cheby_conv(x, self.op, w)
        return fourier_conv(x, self.fourier_u, w)

    def _residual_network(self, tower, x):
        """conv_init -> residual blocks -> conv_out (graph_conv.py
        :305-330)."""
        x = self.act(self._conv(tower["conv_init"], x))
        for blk in tower["res"]:
            identity = x
            x = self.act(self._conv(blk["w1"], x))
            x = self._conv(blk["w2"], x)
            if self.residual:
                x = x + identity
            x = self.act(x)
        return self._conv(tower["conv_out"], x)

    def apply(self, params, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """``x``: ``[B, M, C]`` -> raw outputs ``[B, M, out_features]``."""
        if not self.stack_splits:
            return self._residual_network(params["tower"], x)
        out = None
        for (s, e), tower, w in zip(self.stack_splits, params["towers"],
                                    params["merge_w"]):
            y = torch.relu(self._residual_network(tower, x[:, :, s:e])) * w
            out = y if out is None else out + y
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.param_tree(), x)

    def loss(self, params, x: torch.Tensor, y: torch.Tensor, *,
             train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Mean squared error (graph_model.py:253-259); on a node-sharded
        operator ``x`` and ``y`` are this rank's rows and the mean is
        over every rank's (``common.node_mean``)."""
        pred = self.apply(params, x, train=train, generator=generator)
        return common.node_mean((y - pred) ** 2, self.op)
