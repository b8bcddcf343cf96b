"""Carry trained weights from the JAX package into the port.

The port keeps the JAX package's parameter layouts, so conversion is a
copy into tensors: no transpose, no reshape.  ChebNet's Fourier (``[M,
Fout, Fin]``), spline (``[K, Fout, Fin]``) and Lanczos weights are
carried as they are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["chebnet_params_from_jax", "forecaster_params_from_jax",
           "gconv_rnn_params_from_jax", "node_classifier_params_from_jax",
           "node_lstm_params_from_jax", "resgnn_params_from_jax"]


def _tensors(tree):
    """A tree of dicts and lists of array-likes (NumPy, or anything
    ``np.asarray`` reads) -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _layers(params, groups) -> dict:
    """Layer lists of ``{"w", "b"}``, each layer's keys in that order
    (the port modules' own order, whatever order the JAX tree has)."""
    return {group: [{k: _tensors(layer[k]) for k in ("w", "b")}
                    for layer in params[group]] for group in groups}


def node_classifier_params_from_jax(params) -> dict:
    """``{"convs": [{"w": [K, Fin, Fout], "b": [Fout]}, ...]}``."""
    return _layers(params, ("convs",))


def chebnet_params_from_jax(params) -> dict:
    """ChebNet's ``{"gconv": [{"w", "b"}], "fc": [{"w", "b"}]}``, for
    every filter."""
    return _layers(params, ("gconv", "fc"))


def resgnn_params_from_jax(params) -> dict:
    """ResGNN's ``{"tower": ...}`` or ``{"towers": [...], "merge_w":
    [...]}``."""
    return _tensors(params)


def forecaster_params_from_jax(params) -> dict:
    """Any of GConvForecaster's 12 variants' trees."""
    return _tensors(params)


def gconv_rnn_params_from_jax(params) -> dict:
    """GConvRNN's ``{"lstm": [...], "head", "head_b"}``."""
    return _tensors(params)


def node_lstm_params_from_jax(params) -> dict:
    """PerNodeLSTM's ``{"Wx", "Wh", "b", "Wo", "bo"}``."""
    return _tensors(params)
