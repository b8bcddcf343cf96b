"""The benchmark's own copies of the graphs it hands to the program and to
the plain reference.

Frozen copies of ``cnn_graph_tpu_torch/graphs/construction.py`` (``grid``,
``knn``, ``adjacency``, ``laplacian``, ``rescale_laplacian``,
``bandwidth_reducing_permutation``, ``city_graph``) and
``cnn_graph_tpu_torch/graphs/coarsening.py`` (``coarsen`` with the plain
Graclus matcher, ``compute_perm``, ``perm_data``, ``perm_adjacency``), so
that a later change to the program cannot change the graphs the
benchmark measures on.  ``benchmark/tests/test_bench_copies.py`` holds each
copy equal to the program's at small sizes.  NumPy and SciPy only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import scipy.spatial
import scipy.spatial.distance

__all__ = ["grid", "knn", "adjacency", "laplacian", "rescale_laplacian",
           "city_graph", "grid_knn_graph", "coarsen", "perm_data"]


def grid(m: int, dtype=np.float32) -> np.ndarray:
    """Coordinates ``(m*m, 2)`` of an ``m x m`` grid in ``[0, 1]^2``."""
    ticks = np.linspace(0, 1, m, dtype=dtype)
    cols, rows = np.meshgrid(ticks, ticks)
    return np.stack([cols.ravel(), rows.ravel()], axis=1).astype(dtype)


def knn(z: np.ndarray, k: int, dense: bool):
    """Exact k nearest neighbours, self excluded: ``dense`` by ``pdist`` and
    argsort (the MNIST grid's tie-breaking depends on it), else by a k-d
    tree.  Returns ``(dist, idx)`` ``(M, k)``, nearest first."""
    if dense:
        d = scipy.spatial.distance.squareform(
            scipy.spatial.distance.pdist(z, metric="euclidean"))
        order = np.argsort(d, axis=1)[:, 1:k + 1]
        return np.take_along_axis(d, order, axis=1), order
    dist, idx = scipy.spatial.cKDTree(z).query(z, k=k + 1, workers=-1)
    return dist[:, 1:], idx[:, 1:]


def adjacency(dist: np.ndarray, idx: np.ndarray) -> scipy.sparse.csr_matrix:
    """Gaussian-kernel kNN adjacency ``exp(-d^2 / sigma^2)``, sigma the mean
    k-th neighbour distance, symmetrised with the elementwise maximum."""
    M, k = dist.shape
    sigma2 = np.mean(dist[:, -1]) ** 2
    vals = np.exp(-(dist**2) / sigma2).ravel()
    rows = np.repeat(np.arange(M), k)
    cols = idx.ravel()
    keep = rows != cols
    W = scipy.sparse.coo_matrix(
        (vals[keep], (rows[keep], cols[keep])), shape=(M, M)).tocsr()
    W = W.maximum(W.T)
    W.eliminate_zeros()
    return W


def laplacian(W: scipy.sparse.spmatrix) -> scipy.sparse.csr_matrix:
    """The normalized Laplacian ``I - D^-1/2 W D^-1/2``, with the epsilon
    degree guard for isolated vertices."""
    W = W.tocsr()
    d = np.asarray(W.sum(axis=0)).ravel()
    d = d + np.spacing(np.array(0, W.dtype))
    inv_sqrt = scipy.sparse.diags(1.0 / np.sqrt(d))
    L = scipy.sparse.identity(d.size, dtype=W.dtype) - inv_sqrt @ W @ inv_sqrt
    L = L.tocsr()
    L.eliminate_zeros()
    return L


def rescale_laplacian(L: scipy.sparse.spmatrix,
                      lmax: float = 2.0) -> scipy.sparse.csr_matrix:
    """``2 L / lmax - I``, the spectrum mapped onto ``[-1, 1]``, with its
    explicit zeros dropped."""
    M = L.shape[0]
    out = (L * (2.0 / lmax)
           - scipy.sparse.identity(M, format="csr", dtype=L.dtype)).tocsr()
    out.eliminate_zeros()
    return out


def city_graph(side: int, k: int, seed: int, jitter: float):
    """Planar city-like graph: a jittered ``side x side`` grid, k-NN
    adjacency, reverse Cuthill-McKee order, normalized Laplacian.
    Returns ``(L, positions)``, positions in RCM order."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    z = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    z += rng.normal(0, jitter, z.shape).astype(np.float32)
    W = adjacency(*knn(z, k, dense=False))
    perm = np.asarray(scipy.sparse.csgraph.reverse_cuthill_mckee(
        W.tocsr(), symmetric_mode=True))
    W = W[perm][:, perm].tocsr()
    return laplacian(W), z[perm]


def grid_knn_graph(side: int, k: int) -> scipy.sparse.csr_matrix:
    """The MNIST grid graph: the ``side x side`` grid's Gaussian k-NN
    adjacency (dense kNN)."""
    return adjacency(*knn(grid(side), k, dense=True))


def _graclus_pairing(indptr, indices, data, rid, weights) -> np.ndarray:
    """One level of greedy matching: in ``rid`` order, each unmatched vertex
    takes the unmatched neighbour with the largest gain ``w_ij (1/d_i +
    1/d_j)`` (strictly positive), else stays alone."""
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


def _graclus(W, levels: int, seed: int):
    N = W.shape[0]
    rid = np.random.default_rng(seed).permutation(N)
    graphs, parents = [W], []
    degree = np.asarray(W.sum(axis=0)).ravel() - W.diagonal()
    for _ in range(levels):
        csr = W.tocsr()
        cluster = _graclus_pairing(csr.indptr, csr.indices, csr.data, rid,
                                   np.asarray(degree).ravel())
        parents.append(cluster)
        coo = W.tocoo()
        n_coarse = int(cluster.max()) + 1
        W = scipy.sparse.csr_matrix(
            (coo.data, (cluster[coo.row], cluster[coo.col])),
            shape=(n_coarse, n_coarse))
        W.eliminate_zeros()
        graphs.append(W)
        degree = np.asarray(W.sum(axis=0)).ravel()
        rid = np.argsort(degree)
    return graphs, parents


def _compute_perm(parents):
    orderings = []
    if parents:
        orderings.append(list(range(int(max(parents[-1])) + 1)))
    for parent in parents[::-1]:
        next_fake = len(parent)
        layer = []
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


def _perm_adjacency(A, indices):
    A = A.tocoo()
    new_pos = np.argsort(indices)
    n = len(indices)
    return scipy.sparse.coo_matrix(
        (A.data, (new_pos[A.row], new_pos[A.col])), shape=(n, n))


def coarsen(A: scipy.sparse.spmatrix, levels: int, seed: int):
    """Multilevel Graclus coarsening.  Returns ``(graphs, perm)``: the
    level-i adjacency (no self-loops, fake nodes added, permuted for
    binary-tree pooling) and the level-0 signal order."""
    graphs, parents = _graclus(A, levels, seed)
    perms = _compute_perm(parents)
    for i, g in enumerate(graphs):
        g = g.tolil()
        g.setdiag(0)
        if i < levels:
            g = _perm_adjacency(g, perms[i])
        g = g.tocsr()
        g.eliminate_zeros()
        graphs[i] = g
    return graphs, perms[0]


def perm_data(x: np.ndarray, indices) -> np.ndarray:
    """Reorder node signals ``(N, M)`` by ``indices``; fake vertices get
    zeros."""
    M = x.shape[1]
    idx = np.asarray(indices)
    xnew = np.zeros((x.shape[0], len(idx)) + x.shape[2:], dtype=x.dtype)
    real = idx < M
    xnew[:, np.nonzero(real)[0]] = x[:, idx[real]]
    return xnew
