"""MNIST grid-graph classification data.

NumPy copies of ``cnn_graph_tpu/data/mnist.py``: ``load_mnist`` (:38),
which reads the standard IDX files (plain or ``.gz``) from a local
directory (nothing is downloaded), ``synthetic_mnist`` (:68),
class-structured fake 28x28 digits with the real data's shapes and
splits, and ``mnist_graph_data`` (:100), the reference preprocessing
(8-NN grid graph, optionally with a fraction of its edges replaced by
random ones, Graclus coarsening, ``perm_data`` on every split; nips
2016/mnist.ipynb cells 3-5).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from cnn_graph_tpu_torch.graphs import coarsening, construction as gc

__all__ = ["load_mnist", "synthetic_mnist", "mnist_graph_data"]

_IDX_DTYPES = {8: np.uint8, 11: np.int16, 12: np.int32, 13: np.float32,
               14: np.float64}
_IDX_FILES = {"train_images": "train-images-idx3-ubyte",
              "train_labels": "train-labels-idx1-ubyte",
              "test_images": "t10k-images-idx3-ubyte",
              "test_labels": "t10k-labels-idx1-ubyte"}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, code, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), _IDX_DTYPES[code]).reshape(shape)


def load_mnist(data_dir: str):
    """Read the four IDX MNIST files (each optionally ``.gz``) from
    ``data_dir``.  Returns ``(train_images [N, 784] float32 in [0, 1],
    train_labels int64, test_images, test_labels)``."""
    out = {}
    for key, base in _IDX_FILES.items():
        path = os.path.join(data_dir, base)
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path += ".gz"
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found: place the IDX files there (nothing is "
                "downloaded) or use synthetic_mnist()")
        out[key] = _read_idx(path)
    return (
        out["train_images"].reshape(-1, 784).astype(np.float32) / 255.0,
        out["train_labels"].astype(np.int64),
        out["test_images"].reshape(-1, 784).astype(np.float32) / 255.0,
        out["test_labels"].astype(np.int64),
    )


def synthetic_mnist(n_train: int = 55000, n_val: int = 5000,
                    n_test: int = 10000, seed: int = 0) -> dict:
    """Each class is a smooth blob-and-ring pattern plus noise on the
    28x28 grid, so a grid-graph ConvNet can separate them.  The same
    draws as the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, 28), np.linspace(-1, 1, 28))
    templates = []
    for c in range(10):
        cx, cy = np.cos(2 * np.pi * c / 10), np.sin(2 * np.pi * c / 10)
        blob = np.exp(-(((xs - 0.5 * cx) ** 2 + (ys - 0.5 * cy) ** 2) / 0.15))
        ring = np.exp(-((np.hypot(xs, ys) - 0.3 - 0.05 * c) ** 2) / 0.02)
        templates.append((blob + 0.5 * ring).ravel())
    templates = np.asarray(templates, np.float32)

    def make(n):
        y = rng.integers(0, 10, n)
        x = templates[y] * rng.uniform(0.7, 1.3, (n, 1)).astype(np.float32)
        x += rng.normal(0, 0.3, (n, 784)).astype(np.float32)
        return np.clip(x, 0, None).astype(np.float32), y.astype(np.int64)

    train, val, test = make(n_train), make(n_val), make(n_test)
    return {
        "train_data": train[0], "train_labels": train[1],
        "val_data": val[0], "val_labels": val[1],
        "test_data": test[0], "test_labels": test[1],
    }


def mnist_graph_data(splits: dict, k: int = 8, levels: int = 4,
                     seed: int = 2017, edge_noise: float = 0.0):
    """8-NN grid graph -> ``coarsen`` -> ``perm_data`` on every split.
    ``edge_noise`` replaces that fraction of the grid's edges with random
    ones before coarsening (``replace_random_edges`` seeded with
    ``seed``).  Returns ``(permuted splits, normalized Laplacians per
    level, perm)``."""
    W = gc.knn_graph(gc.grid(28), k=k)
    if edge_noise:
        W = gc.replace_random_edges(W, edge_noise, seed=seed)
    graphs, perm = coarsening.coarsen(W, levels=levels, seed=seed)
    Ls = [gc.laplacian(g, normalized=True) for g in graphs]
    out = dict(splits)
    for key in ("train_data", "val_data", "test_data"):
        out[key] = coarsening.perm_data(splits[key], perm).astype(np.float32)
    return out, Ls, perm
