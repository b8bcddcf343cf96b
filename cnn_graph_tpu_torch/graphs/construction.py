"""Host-side graph construction for the port: grids, kNN, adjacency,
Laplacian, RCM ordering, and the planar city graph of the serving
benchmark.

NumPy/SciPy copies of the counterparts in ``cnn_graph_tpu/graphs/
construction.py`` (``grid`` :36, ``knn`` :48, ``adjacency`` :77,
``knn_graph`` :108, ``laplacian`` :148, ``rescale_laplacian`` :197,
``bandwidth_reducing_permutation`` :264, ``replace_random_edges`` :116,
``lmax`` :168, ``fourier`` :178, ``chebyshev_basis`` :212,
``lanczos_basis`` :227) and ``cnn_graph_tpu/data/synthetic.py:89
city_graph``.  The port carries its own copies so that it
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
import scipy.sparse.linalg
import scipy.spatial
import scipy.spatial.distance

__all__ = [
    "grid",
    "knn",
    "knn_graph",
    "adjacency",
    "replace_random_edges",
    "laplacian",
    "lmax",
    "fourier",
    "rescale_laplacian",
    "chebyshev_basis",
    "lanczos_basis",
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


def replace_random_edges(A: scipy.sparse.spmatrix, noise_level: float,
                         seed: int | None = None) -> scipy.sparse.csr_matrix:
    """Replace a fraction ``noise_level`` of the undirected edges with
    uniformly random unit-weight edges; the same graph as the JAX
    package's from the same seed (the same draws in the same order)."""
    M, _ = A.shape
    n = int(noise_level * A.nnz // 2)
    rng = np.random.default_rng(seed)
    upper = scipy.sparse.triu(A, format="coo")
    if upper.nnz != A.nnz // 2 or upper.nnz < n:
        raise ValueError("A must be symmetric with a zero diagonal and at "
                         f"least {n} edges")
    victims = rng.permutation(upper.nnz)[:n]
    new_rows = rng.integers(0, M, n)
    new_cols = rng.integers(0, M, n)
    A = A.tolil()
    for v, r, c in zip(victims, new_rows, new_cols):
        A[upper.row[v], upper.col[v]] = 0
        A[upper.col[v], upper.row[v]] = 0
        A[r, c] = 1
        A[c, r] = 1
    A.setdiag(0)
    A = A.tocsr()
    A.eliminate_zeros()
    return A


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


def lmax(L: scipy.sparse.spmatrix, normalized: bool = True) -> float:
    """Upper bound of the spectrum: 2 for a normalized Laplacian, else the
    largest-magnitude eigenvalue (``eigsh``)."""
    if normalized:
        return 2.0
    return float(scipy.sparse.linalg.eigsh(
        L, k=1, which="LM", return_eigenvectors=False)[0])


def fourier(L: scipy.sparse.spmatrix, algo: str = "eigh", k: int = 1):
    """The graph Fourier basis ``(lam, U)``, eigenvalues ascending, the
    eigenvectors U's columns: the same call as the JAX package's for each
    ``algo`` (``eigh`` by default, on the dense Laplacian)."""

    def _sorted(lamb, U):
        order = lamb.argsort()
        return lamb[order], U[:, order]

    if algo == "eig":
        return _sorted(*np.linalg.eig(L.toarray()))
    if algo == "eigh":
        return np.linalg.eigh(L.toarray())
    if algo == "eigs":
        return _sorted(*scipy.sparse.linalg.eigs(L, k=k, which="SM"))
    if algo == "eigsh":
        return scipy.sparse.linalg.eigsh(L, k=k, which="SM")
    raise ValueError(f"unknown EVD algorithm {algo!r}")


def rescale_laplacian(L: scipy.sparse.spmatrix,
                      lmax: float = 2.0) -> scipy.sparse.csr_matrix:
    """Map the spectrum from ``[0, lmax]`` to ``[-1, 1]``:
    ``2 L / lmax - I``."""
    M = L.shape[0]
    return (L * (2.0 / lmax)
            - scipy.sparse.identity(M, format="csr", dtype=L.dtype)).tocsr()


def chebyshev_basis(L: scipy.sparse.spmatrix, X: np.ndarray,
                    K: int) -> np.ndarray:
    """NumPy oracle of the Chebyshev recurrence: ``T_k(L) X`` for k < K,
    ``(K, M, N)``; L already rescaled to ``[-1, 1]``."""
    M, N = X.shape
    Xt = np.empty((K, M, N), X.dtype)
    Xt[0] = X
    if K > 1:
        Xt[1] = L @ X
    for k in range(2, K):
        Xt[k] = 2 * (L @ Xt[k - 1]) - Xt[k - 2]
    return Xt


def lanczos_basis(L: scipy.sparse.spmatrix, X: np.ndarray,
                  K: int) -> np.ndarray:
    """NumPy oracle of the per-signal K-step Lanczos basis, ``(K, M, N)``:
    Lanczos on each column of X, the tridiagonal H diagonalized, the
    rotated basis scaled back by the columns' norms."""
    M, N = X.shape
    norms = np.linalg.norm(X, axis=0)
    a = np.empty((K, N), X.dtype)
    b = np.zeros((K, N), X.dtype)
    V = np.empty((K, M, N), X.dtype)
    V[0] = X / norms
    for k in range(K - 1):
        W = L @ V[k]
        a[k] = np.sum(W * V[k], axis=0)
        W = W - a[k] * V[k] - (b[k] * V[k - 1] if k > 0 else 0)
        b[k + 1] = np.linalg.norm(W, axis=0)
        V[k + 1] = W / b[k + 1]
    a[K - 1] = np.sum((L @ V[K - 1]) * V[K - 1], axis=0)
    H = np.zeros((N, K, K), a.dtype)
    rows = np.arange(K)
    H[:, rows, rows] = a.T
    H[:, rows[1:], rows[:-1]] = b[1:].T
    Q = np.linalg.eigh(H, UPLO="L")[1]
    Xt = np.einsum("njk,jmn->kmn", Q, V)
    Xt *= Q[:, 0, :].T[:, np.newaxis, :]
    Xt *= norms
    return Xt


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
