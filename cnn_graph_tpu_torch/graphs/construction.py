"""Host-side graph construction for the port: grids, kNN, adjacency,
Laplacian, RCM ordering, and the planar city graph of the serving
benchmark.

NumPy/SciPy copies of the counterparts in ``cnn_graph_tpu/graphs/
construction.py`` (``grid`` :36, ``knn`` :48, ``adjacency`` :77,
``knn_graph`` :108, ``laplacian`` :148, ``rescale_laplacian`` :197,
``bandwidth_reducing_permutation`` :264) and ``cnn_graph_tpu/data/
synthetic.py:89 city_graph``.  The port carries its own copies so that it
runs where the JAX package is not installed; ``tests/test_torch_graphs.py``
and ``tests/test_torch_chebnet.py`` hold them equal to the originals.

``knn`` defaults to the JAX package's exact ``algorithm="dense"`` route
(``pdist`` and ``argsort``, any SciPy metric), whose tie-breaking the
MNIST grid graph depends on.  Any other ``algorithm`` takes
``scipy.spatial.cKDTree`` (Euclidean only) where the JAX package goes
through scikit-learn: on the city graphs both give the same neighbours,
distances and RCM order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import scipy.spatial
import scipy.spatial.distance

__all__ = [
    "grid",
    "knn",
    "knn_graph",
    "adjacency",
    "laplacian",
    "rescale_laplacian",
    "bandwidth_reducing_permutation",
    "city_graph",
]


def grid(m: int, dtype=np.float32) -> np.ndarray:
    """Coordinates ``(m*m, 2)`` of an ``m x m`` grid in ``[0, 1]^2``; row
    ``i*m + j`` is the point ``(j/(m-1), i/(m-1))``."""
    ticks = np.linspace(0, 1, m, dtype=dtype)
    cols, rows = np.meshgrid(ticks, ticks)
    return np.stack([cols.ravel(), rows.ravel()], axis=1).astype(dtype)


def knn(z: np.ndarray, k: int = 4, metric: str = "euclidean",
        algorithm: str = "dense"):
    """Exact k-nearest neighbours of every point under ``metric``, self
    excluded; the JAX package's signature.

    ``algorithm="dense"`` builds the full distance matrix with ``pdist``
    (any SciPy metric, ``"cosine"`` included) and argsorts it (O(M^2)
    memory), exactly as the JAX package does, ties included.  Any other
    value queries a ``cKDTree`` (on every host core; each point's query
    is independent, so the result is the serial one), which scales to
    millions of points but serves ``"euclidean"`` only: the JAX package takes scikit-learn's
    metrics there, and scikit-learn is not on the card's machine, so
    another metric raises rather than fall back to Euclidean.
    Returns ``(dist, idx)`` of shape ``(M, k)``, nearest first."""
    if algorithm == "dense":
        d = scipy.spatial.distance.squareform(
            scipy.spatial.distance.pdist(z, metric=metric))
        order = np.argsort(d, axis=1)[:, 1:k + 1]
        return np.take_along_axis(d, order, axis=1), order
    if metric != "euclidean":
        raise ValueError(
            f"knn(algorithm={algorithm!r}) serves metric 'euclidean' only, "
            f"not {metric!r}: the JAX package takes scikit-learn's metrics "
            "there, and scikit-learn is not on the card's machine; use "
            "algorithm='dense' for other metrics")
    dist, idx = scipy.spatial.cKDTree(z).query(z, k=k + 1, workers=-1)
    return dist[:, 1:], idx[:, 1:]


def adjacency(dist: np.ndarray, idx: np.ndarray) -> scipy.sparse.csr_matrix:
    """Gaussian-kernel kNN adjacency ``exp(-d^2 / sigma^2)``, sigma the mean
    k-th neighbour distance, symmetrised with the elementwise maximum."""
    M, k = dist.shape
    if idx.shape != (M, k) or dist.min() < 0:
        raise ValueError("dist and idx must be matching (M, k), dist >= 0")
    sigma2 = np.mean(dist[:, -1]) ** 2
    vals = np.exp(-(dist**2) / sigma2).ravel()
    rows = np.repeat(np.arange(M), k)
    cols = idx.ravel()
    keep = rows != cols
    W = scipy.sparse.coo_matrix(
        (vals[keep], (rows[keep], cols[keep])), shape=(M, M)
    ).tocsr()
    W = W.maximum(W.T)
    W.eliminate_zeros()
    return W


def knn_graph(z: np.ndarray, k: int = 8,
              metric: str = "euclidean") -> scipy.sparse.csr_matrix:
    """Points -> Gaussian kNN adjacency through the dense ``knn``."""
    return adjacency(*knn(z, k=k, metric=metric))


def laplacian(W: scipy.sparse.spmatrix,
              normalized: bool = True) -> scipy.sparse.csr_matrix:
    """``D - W``, or ``I - D^-1/2 W D^-1/2`` with the epsilon degree guard
    for isolated vertices."""
    W = W.tocsr()
    d = np.asarray(W.sum(axis=0)).ravel()
    if not normalized:
        L = scipy.sparse.diags(d) - W
    else:
        d = d + np.spacing(np.array(0, W.dtype))
        inv_sqrt = scipy.sparse.diags(1.0 / np.sqrt(d))
        L = (scipy.sparse.identity(d.size, dtype=W.dtype)
             - inv_sqrt @ W @ inv_sqrt)
    L = L.tocsr()
    L.eliminate_zeros()
    return L


def rescale_laplacian(L: scipy.sparse.spmatrix,
                      lmax: float = 2.0) -> scipy.sparse.csr_matrix:
    """Map the spectrum from ``[0, lmax]`` to ``[-1, 1]``:
    ``2 L / lmax - I``."""
    M = L.shape[0]
    return (L * (2.0 / lmax)
            - scipy.sparse.identity(M, format="csr", dtype=L.dtype)).tocsr()


def bandwidth_reducing_permutation(W: scipy.sparse.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee order: neighbours cluster near the diagonal, so
    the 128-tiled Laplacian is block-banded."""
    return np.asarray(scipy.sparse.csgraph.reverse_cuthill_mckee(
        W.tocsr(), symmetric_mode=True))


def city_graph(side: int, k: int = 8, seed: int = 0, jitter: float = 0.3,
               normalized: bool = True):
    """Planar city-like graph: a jittered ``side x side`` grid, k-NN
    adjacency, RCM-ordered, normalized Laplacian.  Same recipe and random
    draws as the JAX package's ``city_graph``.  Returns ``(L, positions)``
    with positions in RCM order."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    z = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    z += rng.normal(0, jitter, z.shape).astype(np.float32)
    dist, idx = knn(z, k=k, algorithm="auto")
    W = adjacency(dist, idx)
    perm = bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return laplacian(W, normalized=normalized), z[perm]
