"""Synthetic datasets for demos, tests and the chip run.

NumPy copies of ``cnn_graph_tpu/data/synthetic.py``:
``community_classification`` (:21), the usage.ipynb demo scenario
(Gaussian features with community structure, a noisy non-linear target
thresholded into 3 classes, a kNN feature graph, coarsening, permuted
50/10/40 splits), and ``synthetic_flow`` (:62), a HumanTraffic-style
region-graph flow matrix for the forecasting models without the
unshipped ``.mat`` datasets.  ``city_graph`` (:89) has one copy, in
``graphs/construction.py``, re-exported here.  The same seed gives the
same arrays as the JAX package's.
"""

from __future__ import annotations

import numpy as np

from cnn_graph_tpu_torch.graphs import coarsening, construction
from cnn_graph_tpu_torch.graphs.construction import city_graph

__all__ = ["community_classification", "synthetic_flow", "city_graph"]


def community_classification(n: int = 10000, d: int = 100,
                             n_communities: int = 5, knn: int = 10,
                             coarsening_levels: int = 3, seed: int = 0):
    """Returns ``(splits, graphs, perm)``: train/val/test data and labels
    (50/10/40), the coarsened kNN graphs of the training features' rows
    (one node per feature) and the pooling permutation."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    X += np.linspace(0, 1, n_communities).repeat(d // n_communities)
    w = rng.normal(0, 0.02, d)
    t = np.tanh(X @ w + rng.normal(0, 0.001, n))
    y = np.ones(n, np.int32)
    y[t > t.mean() + 0.4 * t.std()] = 0
    y[t < t.mean() - 0.4 * t.std()] = 2

    n_train, n_val = n // 2, n // 10
    X_train = X[:n_train]
    dist, idx = construction.knn(X_train.T, k=knn)
    A = construction.adjacency(dist, idx).astype(np.float32)
    graphs, perm = coarsening.coarsen(A, levels=coarsening_levels, seed=seed)
    splits = {
        "train_data": coarsening.perm_data(X_train, perm),
        "val_data": coarsening.perm_data(X[n_train:n_train + n_val], perm),
        "test_data": coarsening.perm_data(X[n_train + n_val:], perm),
        "train_labels": y[:n_train],
        "val_labels": y[n_train:n_train + n_val],
        "test_labels": y[n_train + n_val:],
    }
    return splits, graphs, perm


def synthetic_flow(n_nodes: int = 64, n_steps: int = 1344, period: int = 48,
                   seed: int = 0):
    """In/out-flow matrices ``[M, T]`` with a daily period and noise, and a
    random sparse symmetric edge matrix ``[M, M]``, shaped like
    HumanTraffic's ``ln_data.mat`` (nips2016/humantraffic.py:38-48)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_steps)
    base = 50 + 30 * np.sin(2 * np.pi * t / period)[None, :]
    node_scale = rng.uniform(0.5, 2.0, (n_nodes, 1))
    in_matrix = node_scale * base + rng.normal(0, 5, (n_nodes, n_steps))
    out_matrix = node_scale * np.roll(base, period // 4, axis=1) + rng.normal(
        0, 5, (n_nodes, n_steps))
    in_matrix = np.clip(in_matrix, 0, None)
    out_matrix = np.clip(out_matrix, 0, None)
    edges = rng.uniform(0, 1000, (n_nodes, n_nodes))
    edges = np.triu(edges * (rng.random((n_nodes, n_nodes)) < 0.15), k=1)
    return in_matrix, out_matrix, edges + edges.T
