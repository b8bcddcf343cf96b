"""Graph-convolutional LSTM: an LSTM whose dense products are spectral
graph convolutions.

Counterpart of ``cnn_graph_tpu/models/gconv_lstm.py``: ``GConvLSTMCell``
(:35), ``glstm_stack_init`` (:118) and ``glstm_stack_apply`` (:123).
Four gates (z, i, f, o), each ``filter(x, W*x) + filter(h, W*h) + b``
with a Chebyshev (``[K, Fin, H]``) or Fourier (``[M, H, Fin]``) filter.
The time axis runs as a Python loop where JAX runs ``lax.scan``;
multi-layer stacks apply output dropout (keep 0.8) to every layer's
outputs in training, as the reference's DropoutWrapper does.  The JAX
package's deliberate fixes of the fork hold here too: gate z uses tanh
(the fork's ``tf.tan`` is a typo), gate o uses sigmoid.

``step`` concatenates the four gates' weights along the output features,
so that x and h each take one filter pass of width 4H, as JAX does: on a
dense operator with H = 64 the h-conv is K2 at (64 -> 256), its dx K2 at
(256 -> 64) and its dW K3 at (64, 256), where the fused rule admits them.

Spans (``utils/profiling.py``): each ``step`` is the span ``glstm.step``;
inside it ``glstm.gates``, timed on the card, holds the sum of the two
filters' outputs and the bias, the four gates and the ``(c, h)`` update,
and the counter ``glstm_gate_bytes`` adds the least f32 traffic of that
math, ``44 H`` bytes a node and sample (read both filter outputs, 4H
wide each, and c; write c and h).  Both cover the forward alone: autograd
runs the backward outside them.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.models import common
from cnn_graph_tpu_torch.ops.filters import cheby_conv, fourier_conv
from cnn_graph_tpu_torch.utils.profiling import count, span

__all__ = ["GConvLSTMCell", "glstm_stack_init", "glstm_stack_apply"]

_GATES = ("z", "i", "f", "o")


class GConvLSTMCell:
    """One graph-conv LSTM cell over ``[B, M, F]`` node signals.

    ``filter_type``: ``cheby_conv`` or ``fourier_conv``; the Fourier
    filter needs ``fourier_u``, the ``[M, M]`` eigenbasis (a tensor on
    the operator's device)."""

    def __init__(self, operator, num_units: int, feat_in: int, K: int = 2,
                 filter_type: str = "cheby_conv", fourier_u=None,
                 forget_bias: float = 1.0):
        if filter_type not in ("cheby_conv", "fourier_conv"):
            raise ValueError(f"unknown filter_type {filter_type!r}")
        if filter_type == "fourier_conv" and fourier_u is None:
            raise ValueError("the fourier_conv filter needs fourier_u")
        self.op = operator
        self.num_units = num_units
        self.feat_in = feat_in
        self.K = K
        self.filter_type = filter_type
        self.fourier_u = fourier_u
        self.forget_bias = forget_bias

    def init(self, *, generator: torch.Generator | None = None,
             device=None) -> dict:
        """Per-gate weights ``W{g}x``, ``W{g}h`` (Uniform(-0.1, 0.1)) and
        biases ``b{g}`` (zero), on ``device`` (the operator's by
        default)."""
        h, fin, m = self.num_units, self.feat_in, self.op.m
        if device is None:
            device = common.operator_device(self.op)
        draw = dict(generator=generator, device=device)
        cheby = self.filter_type == "cheby_conv"
        params = {}
        for g in _GATES:
            params[f"W{g}x"] = common.uniform_init(
                (self.K, fin, h) if cheby else (m, h, fin), **draw)
        for g in _GATES:
            params[f"W{g}h"] = common.uniform_init(
                (self.K, h, h) if cheby else (m, h, h), **draw)
        for g in _GATES:
            params[f"b{g}"] = torch.zeros(h, device=device)
        return params

    def zero_state(self, batch_size: int, dtype=torch.float32, device=None):
        shape = (batch_size, self.op.m, self.num_units)
        if device is None:
            device = common.operator_device(self.op)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def _filter(self, x, w):
        if self.filter_type == "cheby_conv":
            return cheby_conv(x, self.op, w)
        return fourier_conv(x, self.fourier_u, w)

    def step(self, params, carry, x):
        """One time step: ``carry = (c, h)``, ``x`` ``[B, M, feat_in]``.
        Returns ``((c, h), h)``.  The gates' weights are concatenated
        along the output features, one filter pass for x and one for h.
        The spans ``glstm.step`` and ``glstm.gates`` (timed) and the
        counter ``glstm_gate_bytes`` cover the forward only."""
        with span("glstm.step"):
            c, h = carry
            H = self.num_units
            axis = -1 if self.filter_type == "cheby_conv" else 1
            wx = torch.cat([params[f"W{g}x"] for g in _GATES], axis)
            wh = torch.cat([params[f"W{g}h"] for g in _GATES], axis)
            b = torch.cat([params[f"b{g}"] for g in _GATES], -1)
            fx, fh = self._filter(x, wx), self._filter(h, wh)
            with span("glstm.gates", device=True):
                count("glstm_gate_bytes", 44 * H * c.shape[0] * c.shape[1])
                pre = fx + fh + b
                del fx, fh  # freed before the gates, as in one expression
                z = torch.tanh(pre[..., :H])
                i = torch.sigmoid(pre[..., H:2 * H])
                f = torch.sigmoid(pre[..., 2 * H:3 * H] + self.forget_bias)
                o = torch.sigmoid(pre[..., 3 * H:])
                new_c = f * c + i * z
                new_h = o * torch.tanh(new_c)
            return (new_c, new_h), new_h


def glstm_stack_init(cells: list[GConvLSTMCell], *,
                     generator: torch.Generator | None = None,
                     device=None) -> list:
    """Each cell's parameters, drawn in turn from ``generator``."""
    return [cell.init(generator=generator, device=device) for cell in cells]


def glstm_stack_apply(params, cells: list[GConvLSTMCell],
                      x_seq: torch.Tensor, *, train: bool = False,
                      generator: torch.Generator | None = None,
                      output_keep_prob: float = 0.8) -> torch.Tensor:
    """A multi-layer gLSTM over time: ``x_seq`` ``[T, B, M, Fin]``
    time-major -> the top layer's outputs ``[T, B, M, H]``.  In training,
    output dropout (keep ``output_keep_prob``) after every layer, drawn
    from ``generator``."""
    seq = x_seq
    for cell, cell_params in zip(cells, params):
        carry = cell.zero_state(x_seq.shape[1], device=x_seq.device)
        outs = []
        for x in seq:
            carry, h = cell.step(cell_params, carry, x)
            outs.append(h)
        seq = torch.stack(outs)
        seq = common.dropout(seq, output_keep_prob, train, generator)
    return seq
