"""Evaluation metrics for classification and flow forecasting.

NumPy copies of ``cnn_graph_tpu/utils/metrics.py``: ``rmse`` (:10),
``mape`` (:17), ``accuracy`` (:30), ``weighted_f1`` (:34) and
``count_params`` (:47), which walks the port's parameter trees (nested
dicts and lists of tensors) with ``models.common.tree_leaves``.
"""

from __future__ import annotations

import numpy as np

from cnn_graph_tpu_torch.models.common import tree_leaves

__all__ = ["rmse", "mape", "accuracy", "weighted_f1", "count_params"]


def rmse(targets: np.ndarray, predictions: np.ndarray) -> float:
    """Root mean squared error over every output element, the humanflow
    headline metric (nips2016/humanflow.py:183-184)."""
    return float(np.sqrt(np.sum((targets - predictions) ** 2) / targets.size))


def mape(targets: np.ndarray, predictions: np.ndarray,
         threshold: float = 20.0) -> float:
    """Mean absolute percentage error over the targets above
    ``threshold`` (small flows are left out, nips2016/gconvTest.py
    :178-183); NaN when none is."""
    mask = targets > threshold
    if not np.any(mask):
        return float("nan")
    return float(
        np.mean(np.abs(targets[mask] - predictions[mask]) / targets[mask]))


def accuracy(labels: np.ndarray, predictions: np.ndarray) -> float:
    return 100.0 * float(np.mean(labels == predictions))


def weighted_f1(labels: np.ndarray, predictions: np.ndarray) -> float:
    """Support-weighted mean of the per-class F1 scores (scikit-learn's
    ``average="weighted"``), in percent."""
    classes, counts = np.unique(labels, return_counts=True)
    f1s = []
    for c in classes:
        tp = np.sum((predictions == c) & (labels == c))
        fp = np.sum((predictions == c) & (labels != c))
        fn = np.sum((predictions != c) & (labels == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return 100.0 * float(np.sum(np.asarray(f1s) * counts) / counts.sum())


def count_params(params) -> int:
    """The number of scalars in a parameter tree."""
    return sum(int(np.prod(t.shape)) for t in tree_leaves(params))
