"""The port's native host kernels: ``graph_kernels.cpp``, its own copy of
``cnn_graph_tpu/native/graph_kernels.cpp``, built with ``g++`` into
``cnn_graph_tpu_torch/_build/`` on first use (``_build.build_host``,
hashed like the CUDA sources) and bound with ``ctypes``.

``graclus_one_level`` is one level of Graclus matching, which
``graphs.coarsening.graclus`` runs at every level; its plain version is
``graphs.coarsening.graclus_pairing``, the same algorithm as a Python
loop.  Where the JAX package finds no compiler it falls back to that
loop without a word; here a failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from cnn_graph_tpu_torch import _build

__all__ = ["graclus_one_level"]


@functools.lru_cache(maxsize=None)
def _matcher():
    fn = _build.load_host("graph_kernels").graclus_one_level
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_int64, p]
    fn.restype = ctypes.c_int64
    return fn


def graclus_one_level(indptr, indices, data, rid, weights) -> np.ndarray:
    """One level of greedy Graclus matching over the CSR graph
    ``(indptr, indices, data)``: in ``rid`` order each unmatched vertex
    takes the unmatched neighbour of largest gain ``w_ij (1/d_i + 1/d_j)``
    (``weights`` = d), else stays alone.  Returns each vertex's cluster,
    int32 ``[n]``."""
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    rid = np.ascontiguousarray(rid, np.int64)
    weights = np.ascontiguousarray(weights, np.float64)
    if (len(rid) != n or len(weights) != n or len(indices) != len(data)
            or len(indices) != int(indptr[-1])):
        raise ValueError("graclus_one_level: rid and weights need one entry "
                         "per vertex, indices and data one per edge")
    cluster = np.empty(n, np.int32)
    _matcher()(indptr.ctypes.data, indices.ctypes.data, data.ctypes.data,
               rid.ctypes.data, weights.ctypes.data, n, cluster.ctypes.data)
    return cluster
