"""Spatiotemporal forecasting zoo: gLSTM and gconv architectures with
closeness / period / trend branch fusion.

Counterpart of ``cnn_graph_tpu/models/forecasting.py:58``
(``GConvForecaster``, ``FORECAST_VARIANTS``), the reference's
``GconvModel`` (lib/gconv_lstm.py:224-671), whose 12 ``inference_*``
variants are compositions of four blocks: a gLSTM stack over a channel
window, a residual gconv stack, a single-gconv projection head, and a
learned per-node weighted merge of branches.  The same compositions, the
same validation (as ``ValueError``) and the same parameter layout as
the JAX package's, which documents two deliberate deviations from the
fork that hold here too: ``glstm_period_no_expand`` returns the head's
output (the fork returns the pre-head tensor), and
``glstm_period_expand_gconv2``'s stray input transpose is dropped.

Spans (``utils/profiling.py``, untimed, forward only: autograd runs the
backward outside them): ``forecast.branch`` around each gLSTM branch of
``apply`` (one a timescale in the ``*period_expand*`` variants) and
``forecast.stack`` around each residual gconv stack (``_conv_stack``).
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
from cnn_graph_tpu_torch.ops.filters import cheby_conv, fourier_conv
from cnn_graph_tpu_torch.utils.profiling import span

__all__ = ["GConvForecaster", "FORECAST_VARIANTS"]

FORECAST_VARIANTS = (
    "glstm",
    "glstm_period_no_expand",
    "gconv",
    "gconv_period_no_expand",
    "gconv_period_expand",
    "glstm_gconv",
    "glstm_gconv_no_expand",
    "glstm_gconv_split",
    "glstm_period_expand",
    "glstm_period_expand_gconv1",
    "glstm_period_expand_gconv2",
    "glstm_period_expand_gconv3",
)

_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


class GConvForecaster(nn.Module):
    """Next-step flow forecaster over a region graph.

    ``x``: ``[B, M, C]``, C = 2 * (seq_closeness + seq_period +
    seq_trend) channels laid out [in-window, out-window] per timescale
    (HumanTraffic's sample layout); output ``[B, M, out_features]``.
    ``filter``: ``cheby_conv`` or ``fourier_conv`` (with ``fourier_u``,
    the ``[M, M]`` eigenbasis).  ``lstm_keep_prob``: the gLSTM stacks'
    output dropout in training.  Weights are drawn from ``generator``
    and live on ``device``, by default the operator's."""

    def __init__(self, operator, seq_closeness: int, seq_period: int = 0,
                 seq_trend: int = 0, variant: str = "glstm",
                 filter: str = "cheby_conv", fourier_u=None,
                 num_hidden: int = 64, num_hidden_conv: int = 32,
                 conv_layer_num: int = 4, lstm_layer_count: int = 1,
                 K: int = 2, in_features: int = 2, out_features: int = 2,
                 lstm_keep_prob: float = 0.8, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if variant not in FORECAST_VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        if seq_closeness < 1:
            raise ValueError("seq_closeness must be >= 1")
        c_all = 2 * (seq_closeness + seq_period + seq_trend)
        if variant in ("glstm", "glstm_period_no_expand", "glstm_gconv",
                       "glstm_gconv_no_expand") and c_all % seq_closeness:
            raise ValueError(
                f"variant {variant!r} folds all {c_all} channels over "
                f"seq_closeness={seq_closeness} steps; the total window "
                "must be divisible by it")
        if variant == "glstm_gconv_split" and c_all != 4 * seq_closeness:
            raise ValueError(
                "variant 'glstm_gconv_split' needs two closeness-sized "
                f"windows (4*seq_closeness={4 * seq_closeness} channels), "
                f"got {c_all}")
        if "period_expand" in variant and not (seq_period > 0
                                               and seq_trend > 0):
            raise ValueError(
                f"variant {variant!r} fuses closeness/period/trend "
                "branches; seq_period and seq_trend must be > 0")
        if filter == "fourier_conv" and fourier_u is None:
            raise ValueError("the fourier_conv filter needs fourier_u")
        if device is None:
            device = common.operator_device(operator)
        self.op = operator
        self.Tc, self.Tp, self.Tt = seq_closeness, seq_period, seq_trend
        self.variant = variant
        self.filter = filter
        self.fourier_u = (None if fourier_u is None else torch.as_tensor(
            fourier_u, dtype=torch.float32).to(device))
        self.H = num_hidden
        self.Hc = num_hidden_conv
        self.n_conv = conv_layer_num
        self.n_lstm = lstm_layer_count
        self.K = K
        self.Fin = in_features
        self.Fout = out_features
        self.keep = lstm_keep_prob
        self._draw = dict(generator=generator, device=device)
        self.weights = common.ParamTree(self._init(c_all))
        del self._draw

    def to_string(self) -> str:
        """Pipe-delimited hyperparameter log line (gconv_lstm.py:261-263)."""
        return (f"|{self.Tc}|{self.Tp}|{self.Tt}|{self.Fin}|{self.H}|{self.K}"
                f"|{self.filter}|{self.n_conv}|{self.n_lstm}|{self.variant}"
                f"|{self.Hc}")

    def param_tree(self) -> dict:
        """The module's parameters in the JAX package's layout."""
        return self.weights.tree()

    # ---- building blocks ----

    def _gconv_init(self, fin, fout):
        shape = ((self.K, fin, fout) if self.filter == "cheby_conv"
                 else (self.op.m, fout, fin))
        return common.trunc_normal(shape, **self._draw)

    def _gconv(self, w, x):
        if self.filter == "cheby_conv":
            return cheby_conv(x, self.op, w)
        return fourier_conv(x, self.fourier_u, w)

    def _cells(self, fin):
        return [GConvLSTMCell(self.op, self.H, fin if i == 0 else self.H,
                              K=self.K, filter_type=self.filter,
                              fourier_u=self.fourier_u)
                for i in range(self.n_lstm)]

    def _glstm_branch_init(self, fin):
        return glstm_stack_init(self._cells(fin), **self._draw)

    def _glstm_branch(self, params, x_window, T, *, train, generator):
        """``x_window`` ``[B, M, Fin*T]`` -> the last gLSTM output ``[B, M,
        H]``; the channels reshape to (Fin, T), the in/out series as
        feature rows over T steps.  The span ``forecast.branch``."""
        with span("forecast.branch"):
            B, M, C = x_window.shape
            fin = C // T
            x_seq = x_window.reshape(B, M, fin, T).permute(3, 0, 1, 2)
            out_seq = glstm_stack_apply(params, self._cells(fin), x_seq,
                                        train=train, generator=generator,
                                        output_keep_prob=self.keep)
            return out_seq[-1]

    def _conv_stack_init(self, fin, hidden):
        return {"init": self._gconv_init(fin, hidden),
                "res": [{"w1": self._gconv_init(hidden, hidden),
                         "w2": self._gconv_init(hidden, hidden)}
                        for _ in range(self.n_conv)]}

    def _conv_stack(self, params, x, init_act, res_act):
        """init conv + residual gconv layers (gconv_lstm.py:642-658); the
        span ``forecast.stack``."""
        with span("forecast.stack"):
            x = _ACTS[init_act](self._gconv(params["init"], x))
            act = _ACTS[res_act]
            for blk in params["res"]:
                identity = x
                x = act(self._gconv(blk["w1"], x))
                x = act(self._gconv(blk["w2"], x) + identity)
            return x

    def _splits(self):
        """Channel ranges of the closeness, period and trend windows."""
        c = 2 * self.Tc
        p = c + 2 * self.Tp
        return [(0, c), (c, p), (p, p + 2 * self.Tt)]

    # ---- parameters / apply ----

    def _init(self, c_all: int) -> dict:
        v = self.variant
        if v in ("glstm", "glstm_period_no_expand"):
            return {"lstm": self._glstm_branch_init(c_all // self.Tc),
                    "head": self._gconv_init(self.H, self.Fout)}
        if v in ("gconv", "gconv_period_no_expand"):
            return {"stack": self._conv_stack_init(c_all, self.H),
                    "head": self._gconv_init(self.H, self.Fout)}
        if v == "gconv_period_expand":
            return {"branches": [self._conv_stack_init(e - s, self.H)
                                 for s, e in self._splits()],
                    "branch_heads": [self._gconv_init(self.H, self.Fout)
                                     for _ in range(3)],
                    "merge": self._gconv_init(3 * self.Fout, self.Fout)}
        if v in ("glstm_gconv", "glstm_gconv_no_expand"):
            return {"lstm": self._glstm_branch_init(c_all // self.Tc),
                    "stack": self._conv_stack_init(self.H, self.Hc),
                    "head": self._gconv_init(self.Hc, self.Fout)}
        if v == "glstm_gconv_split":
            return {"lstms": [self._glstm_branch_init(2) for _ in range(2)],
                    "stack": self._conv_stack_init(2 * self.H, self.H),
                    "head": self._gconv_init(self.H, self.Fout)}
        lstms = [self._glstm_branch_init(2) for _ in range(3)]
        if v == "glstm_period_expand_gconv3":
            return {"lstms": lstms,
                    "stack": self._conv_stack_init(3 * self.H, self.H),
                    "head": self._gconv_init(self.H, self.Fout)}
        p = {"lstms": lstms,
             "branch_heads": [self._gconv_init(self.H, self.Fout)
                              for _ in range(3)]}
        if v == "glstm_period_expand_gconv2":
            p["merge"] = self._gconv_init(3 * self.Fout, self.Fout)
        else:  # glstm_period_expand, glstm_period_expand_gconv1
            p["merge_w"] = [common.trunc_normal((self.op.m, self.Fout),
                                                **self._draw)
                            for _ in range(3)]
        return p

    def apply(self, params, x: torch.Tensor, *, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """``x`` ``[B, M, C]`` -> ``[B, M, out_features]``; ``train`` turns
        the gLSTM output dropout on, drawing from ``generator``."""
        v = self.variant
        kw = dict(train=train, generator=generator)

        if v in ("glstm", "glstm_period_no_expand"):
            h = self._glstm_branch(params["lstm"], x, self.Tc, **kw)
            return self._gconv(params["head"], h)

        if v in ("gconv", "gconv_period_no_expand"):
            act = "tanh" if v == "gconv" else "relu"
            h = self._conv_stack(params["stack"], x, act, act)
            return self._gconv(params["head"], h)

        if v == "gconv_period_expand":
            outs = [torch.relu(self._gconv(head, self._conv_stack(
                        stack, x[:, :, s:e], "tanh", "relu")))
                    for (s, e), stack, head in zip(
                        self._splits(), params["branches"],
                        params["branch_heads"])]
            return self._gconv(params["merge"], torch.cat(outs, dim=2))

        if v in ("glstm_gconv", "glstm_gconv_no_expand"):
            h = self._glstm_branch(params["lstm"], x, self.Tc, **kw)
            h = self._conv_stack(params["stack"], h, "relu", "relu")
            return self._gconv(params["head"], h)

        if v == "glstm_gconv_split":
            w = 2 * self.Tc
            h = torch.cat([self._glstm_branch(
                params["lstms"][i], x[:, :, i * w:(i + 1) * w], self.Tc,
                **kw) for i in range(2)], dim=2)
            h = self._conv_stack(params["stack"], h, "relu", "relu")
            return self._gconv(params["head"], h)

        windows = [(x[:, :, s:e], T) for (s, e), T in zip(
            self._splits(), (self.Tc, self.Tp, self.Tt))]
        hs = [self._glstm_branch(lstm, xw, T, **kw)
              for (xw, T), lstm in zip(windows, params["lstms"])]

        if v in ("glstm_period_expand", "glstm_period_expand_gconv1"):
            out = None
            for h, head, w in zip(hs, params["branch_heads"],
                                  params["merge_w"]):
                y = self._gconv(head, h) * w  # learned per-node weights
                out = y if out is None else out + y
            return out

        if v == "glstm_period_expand_gconv2":
            outs = [self._gconv(head, h)
                    for h, head in zip(hs, params["branch_heads"])]
            return self._gconv(params["merge"], torch.cat(outs, dim=2))

        # glstm_period_expand_gconv3
        h = self._conv_stack(params["stack"], torch.cat(hs, dim=2), "relu",
                             "relu")
        return self._gconv(params["head"], h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.param_tree(), x)

    def loss(self, params, x: torch.Tensor, y: torch.Tensor, *,
             train: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Mean squared error."""
        pred = self.apply(params, x, train=train, generator=generator)
        return ((y - pred) ** 2).mean()
