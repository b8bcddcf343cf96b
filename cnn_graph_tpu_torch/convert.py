"""Carry trained weights from the JAX package into the port.

The port keeps the JAX package's parameter layouts, so conversion is a
copy into tensors: no transpose, no reshape.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["chebnet_params_from_jax", "node_classifier_params_from_jax"]


def _layers(params, groups) -> dict:
    return {group: [{k: torch.from_numpy(np.array(layer[k]))
                     for k in ("w", "b")} for layer in params[group]]
            for group in groups}


def node_classifier_params_from_jax(params) -> dict:
    """``{"convs": [{"w": [K, Fin, Fout], "b": [Fout]}, ...]}`` of array-likes
    (NumPy, or anything ``np.asarray`` reads) -> the same tree of tensors."""
    return _layers(params, ("convs",))


def chebnet_params_from_jax(params) -> dict:
    """ChebNet's ``{"gconv": [{"w", "b"}], "fc": [{"w", "b"}]}`` of
    array-likes -> the same tree of tensors."""
    return _layers(params, ("gconv", "fc"))
