"""GConvRNN: sequence-labelling graph-conv LSTM (per-step outputs).

Counterpart of ``cnn_graph_tpu/models/gconv_rnn.py:27``, the reference's
GCRN-style stack (lib/gconvRNN.py): the gLSTM cells of
``models/gconv_lstm.py``, a Chebyshev head applied to every step's output
(gconvRNN.py:306-317; JAX vmaps it over T, here the T steps ride the
batch axis of one conv), and a cross-entropy over every (batch, step,
node) slot (:326-345).  Trained with ``Trainer(task="sequence")``.
"""

from __future__ import annotations

import torch
from torch import nn

from cnn_graph_tpu_torch.models import common
from cnn_graph_tpu_torch.models.gconv_lstm import (
    GConvLSTMCell,
    glstm_stack_apply,
    glstm_stack_init,
)
from cnn_graph_tpu_torch.ops.filters import cheby_conv

__all__ = ["GConvRNN"]


class GConvRNN(nn.Module):
    """Graph-conv LSTM over T steps with a per-step classification head:
    ``x`` ``[B, M, Fin, T]`` -> logits ``[B, T, M, C]``; labels for
    ``loss`` are class ids ``[B, T, M]``.  ``output_keep_prob``: output
    dropout after each layer in training.  Parameters: ``{"lstm": [cell
    params], "head": [K, H, C], "head_b": [C]}``."""

    def __init__(self, operator, num_units: int, feat_in: int,
                 num_classes: int, K: int = 2, num_layers: int = 1,
                 output_keep_prob: float = 1.0, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if device is None:
            device = common.operator_device(operator)
        self.op = operator
        self.H = num_units
        self.feat_in = feat_in
        self.C = num_classes
        self.K = K
        self.num_layers = num_layers
        self.keep = output_keep_prob
        draw = dict(generator=generator, device=device)
        self.weights = common.ParamTree({
            "lstm": glstm_stack_init(self._cells(), **draw),
            "head": common.trunc_normal((K, num_units, num_classes), **draw),
            "head_b": torch.zeros(num_classes, device=device)})

    def _cells(self):
        return [GConvLSTMCell(self.op, self.H,
                              self.feat_in if i == 0 else self.H, K=self.K)
                for i in range(self.num_layers)]

    def param_tree(self) -> dict:
        """The module's parameters in the JAX package's layout."""
        return self.weights.tree()

    def apply(self, params, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        B, M, Fin, T = x.shape
        seq = glstm_stack_apply(params["lstm"], self._cells(),
                                x.permute(3, 0, 1, 2), train=train,
                                generator=generator,
                                output_keep_prob=self.keep)
        logits = cheby_conv(seq.reshape(T * B, M, self.H), self.op,
                            params["head"]) + params["head_b"]
        return logits.reshape(T, B, M, self.C).transpose(0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.param_tree(), x)

    def loss(self, params, x: torch.Tensor, labels: torch.Tensor, *,
             train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Mean softmax cross-entropy over all (batch, step, node) slots."""
        logp = torch.log_softmax(
            self.apply(params, x, train=train, generator=generator), dim=-1)
        return -logp.gather(-1, labels[..., None].long()).mean()

    def predict_classes(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x).argmax(dim=-1)
