"""Shared model building blocks: the weight initializer, dropout and the
one-call int8 conversion of a model's graph operators.

Counterpart of ``cnn_graph_tpu/models/common.py`` (``trunc_normal`` :125,
``dropout`` :176, ``quantize_model_operators`` :63).
"""

from __future__ import annotations

import copy

import torch

__all__ = ["trunc_normal", "dropout", "quantize_model_operators"]


def trunc_normal(shape, std: float = 0.1, *, generator=None,
                 device=None) -> torch.Tensor:
    """Truncated normal(0, std) on ``[-2 std, 2 std]``, the reference's
    default weight initializer, drawn from ``generator``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def dropout(x: torch.Tensor, keep_prob: float, train: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout with a KEEP probability: kept entries are scaled
    by ``1 / keep_prob``, the rest zeroed.  Identity at ``keep_prob``
    1.0 or outside training.  The mask is drawn from ``generator``, which
    must live on x's device; its bits are not ``jax.random``'s."""
    if not train or keep_prob >= 1.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def quantize_model_operators(model, sample_x: float = 1.0,
                             headroom: float = 2.0):
    """A shallow copy of ``model`` whose graph operator ``op`` is replaced
    by its int8 twin.  Only the banded operator has a twin in the port so
    far; an already quantized operator passes through, and any other
    format raises rather than serving unquantized."""
    from cnn_graph_tpu_torch.ops.laplacian import (
        BandedLaplacian,
        QuantBandedLaplacian,
        quantize_banded,
    )

    op = model.op
    if isinstance(op, BandedLaplacian):
        op = quantize_banded(op, headroom=headroom, sample_x=sample_x)
    elif not isinstance(op, QuantBandedLaplacian):
        raise NotImplementedError(
            f"no int8 twin for {type(op).__name__} in cnn_graph_tpu_torch yet "
            "(quantize_dense / quantize_block_sparse: ROADMAP queue 1 item 8)"
        )
    clone = copy.copy(model)
    clone.op = op
    return clone
