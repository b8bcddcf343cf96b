"""Binary-tree graph pooling.

Counterpart of ``cnn_graph_tpu/ops/pooling.py`` (``max_pool`` :23,
``avg_pool`` :32).  The coarsening permutation lays each coarse node's
children out contiguously, so pooling by ``p`` is a reduction over
groups of ``p`` consecutive nodes.  Fake nodes carry 0, so after a ReLU
a max-pool keeps the real sibling.
"""

from __future__ import annotations

import torch

from cnn_graph_tpu_torch.utils.profiling import span

__all__ = ["max_pool", "avg_pool"]


def _groups(x: torch.Tensor, p: int) -> torch.Tensor:
    B, M, F = x.shape
    if M % p:
        raise ValueError(f"node count {M} not divisible by pool size {p}")
    return x.reshape(B, M // p, p, F)


def max_pool(x: torch.Tensor, p: int) -> torch.Tensor:
    """Max over groups of ``p`` nodes: ``[B, M, F]`` -> ``[B, M/p, F]``."""
    if p <= 1:
        return x
    with span("pool"):
        return _groups(x, p).amax(dim=2)


def avg_pool(x: torch.Tensor, p: int) -> torch.Tensor:
    """Mean over groups of ``p`` nodes."""
    if p <= 1:
        return x
    with span("pool"):
        return _groups(x, p).mean(dim=2)
