"""Multilevel Graclus coarsening and the binary-tree pooling permutation.

NumPy/SciPy copies of ``cnn_graph_tpu/graphs/coarsening.py`` (``coarsen``
:30, ``graclus`` :63, ``graclus_pairing`` :117, ``compute_perm`` :154,
``perm_data`` :193, ``perm_adjacency`` :215).  ``graphs[i]`` become the
per-level Laplacians of ``models.ChebNet`` and ``perm`` reorders level-0
signals so that pooling by ``p`` is a reduction over ``p`` consecutive
nodes (``ops.pooling``).

Each level's matching runs the native C++ matcher
(``cnn_graph_tpu_torch.native.graclus_one_level``), as the JAX package's
does; ``graclus_pairing`` is its plain Python version, which gives the
same clusters.  Where JAX falls back to the loop without a compiler,
the port raises.  The visit order at level 0 is
``np.random.default_rng(seed).permutation``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

from cnn_graph_tpu_torch import native

__all__ = [
    "coarsen",
    "graclus",
    "graclus_pairing",
    "compute_perm",
    "perm_data",
    "perm_adjacency",
]


def coarsen(A: scipy.sparse.spmatrix, levels: int,
            self_connections: bool = False, seed: int | None = None):
    """Coarsen adjacency ``A`` over ``levels`` levels.  Returns ``(graphs,
    perm)``: ``graphs[i]`` is the level-i adjacency (CSR, fake nodes
    added, rows and columns permuted for binary-tree pooling) and
    ``perm`` reorders level-0 signals (``None`` when ``levels == 0``)."""
    graphs, parents = graclus(A, levels, seed=seed)
    perms = compute_perm(parents)
    for i, g in enumerate(graphs):
        if not self_connections:
            g = g.tolil()
            g.setdiag(0)
        if i < levels:
            g = perm_adjacency(g, perms[i])
        g = g.tocsr()
        g.eliminate_zeros()
        graphs[i] = g
    return graphs, perms[0] if levels > 0 else None


def graclus(W: scipy.sparse.spmatrix, levels: int,
            rid: np.ndarray | None = None, seed: int | None = None):
    """Multilevel randomized heavy-edge matching with the Graclus
    normalized-cut gain.  Returns ``(graphs, parents)``: ``graphs[0]`` is
    the input, ``parents[i]`` maps level-i vertices to their level-(i+1)
    cluster.  Later levels visit vertices by ascending coarse degree."""
    N = W.shape[0]
    if rid is None:
        rid = np.random.default_rng(seed).permutation(N)
    graphs = [W]
    parents = []
    # Pairing weights: degrees without self-loops at the finest level.
    degree = np.asarray(W.sum(axis=0)).ravel() - W.diagonal()
    for _ in range(levels):
        csr = W.tocsr()
        cluster = native.graclus_one_level(csr.indptr, csr.indices, csr.data,
                                           rid, np.asarray(degree).ravel())
        parents.append(cluster)
        # Coarse graph: edge weights summed over cluster pairs.
        coo = W.tocoo()
        n_coarse = int(cluster.max()) + 1
        W = scipy.sparse.csr_matrix(
            (coo.data, (cluster[coo.row], cluster[coo.col])),
            shape=(n_coarse, n_coarse))
        W.eliminate_zeros()
        graphs.append(W)
        # Next level: lowest degree first, self-loops included.
        degree = np.asarray(W.sum(axis=0)).ravel()
        rid = np.argsort(degree)
    return graphs, parents


def graclus_pairing(indptr, indices, data, rid, weights) -> np.ndarray:
    """One level of greedy matching over a CSR graph: in ``rid`` order,
    each unmatched vertex takes the unmatched neighbour with the largest
    gain ``w_ij (1/d_i + 1/d_j)`` (strictly positive), else stays alone."""
    N = len(indptr) - 1
    matched = np.zeros(N, dtype=bool)
    cluster = np.zeros(N, dtype=np.int32)
    n_clusters = 0
    for tid in rid:
        if matched[tid]:
            continue
        matched[tid] = True
        best_gain = 0.0
        best = -1
        for e in range(indptr[tid], indptr[tid + 1]):
            nid = indices[e]
            if matched[nid]:
                continue
            gain = data[e] * (1.0 / weights[tid] + 1.0 / weights[nid])
            if gain > best_gain:
                best_gain = gain
                best = nid
        cluster[tid] = n_clusters
        if best >= 0:
            cluster[best] = n_clusters
            matched[best] = True
        n_clusters += 1
    return cluster


def compute_perm(parents: list[np.ndarray]) -> list[list[int]]:
    """Node orderings, finest first, that lay each coarse node's children
    out contiguously, with fake singleton children appended as needed."""
    orderings: list[list[int]] = []
    if parents:
        coarsest = int(max(parents[-1])) + 1
        orderings.append(list(range(coarsest)))
    for parent in parents[::-1]:
        next_fake = len(parent)  # fake nodes get ids past the real ones
        layer: list[int] = []
        for cluster_id in orderings[-1]:
            children = list(np.where(parent == cluster_id)[0])
            if len(children) == 1:
                children.append(next_fake)
                next_fake += 1
            elif not children:
                children = [next_fake, next_fake + 1]
                next_fake += 2
            layer.extend(children)
        orderings.append(layer)
    return orderings[::-1]


def perm_data(x: np.ndarray, indices: list[int] | None) -> np.ndarray:
    """Reorder node signals ``(N, M[, F])`` by ``indices``; fake vertices
    get zeros, so a max-pool over {real, fake} keeps the real value."""
    if indices is None:
        return x
    M = x.shape[1]
    idx = np.asarray(indices)
    if len(idx) < M:
        raise ValueError(f"{len(idx)} indices for {M} nodes")
    xnew = np.zeros((x.shape[0], len(idx)) + x.shape[2:], dtype=x.dtype)
    real = idx < M
    xnew[:, np.nonzero(real)[0]] = x[:, idx[real]]
    return xnew


def perm_adjacency(A: scipy.sparse.spmatrix, indices: list[int] | None):
    """Reorder adjacency rows and columns by ``indices``, first growing the
    matrix with isolated fake vertices."""
    if indices is None:
        return A
    A = A.tocoo()
    new_pos = np.argsort(indices)
    n = len(indices)
    return scipy.sparse.coo_matrix(
        (A.data, (new_pos[A.row], new_pos[A.col])), shape=(n, n))
