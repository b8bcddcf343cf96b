"""Halo-exchange node parallelism: ship only the boundary rows per hop.

Counterpart of ``cnn_graph_tpu/parallel/halo.py`` (``HaloShardedLaplacian``
:52, ``build_halo_plan`` :96, ``halo_exchange_columns`` :133,
``halo_sharded_laplacian`` :148).  The host plan (``build_halo_plan``, a
NumPy copy held byte-equal to JAX's) lists, for a contiguous n-way row
partition, the rows each shard needs from each other shard, padded to
one pair-halo width H so that every rank runs the same exchange.  Per
product each rank gathers the rows its peers need, sends them in one
``all_to_all_single`` over the ``nodes`` axis and multiplies its
extended-column block:

    send = x_local[send_idx]                     # [n*H, C], per peer
    recv = all_to_all(send, "nodes")             # [n*H, C]
    y    = L_ext @ [x_local | recv]              # dense, plain torch

The backward is the transpose, written out: ``L_ext^T g`` splits into
this rank's rows and the halo slots, whose cotangents go back to their
owners by the reverse exchange and are added into the rows they were
sent from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import torch
from torch.autograd.function import once_differentiable

from cnn_graph_tpu_torch.graphs import rescale_laplacian
from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.parallel.mesh import Mesh, ShardedOperator

__all__ = ["HaloShardedLaplacian", "build_halo_plan",
           "halo_exchange_columns", "halo_sharded_laplacian"]


def build_halo_plan(L: scipy.sparse.spmatrix, n: int, tile: int = 8):
    """The exchange plan of a contiguous n-way row partition (JAX :96):
    ``(Lp, mp, ms, need, send_idx, H)``, the zero-padded matrix, its
    padded size, rows per shard, each pair's needed remote columns, the
    send-index tensor ``[n, n, H]`` (``send_idx[t, s]``: shard t's local
    rows that shard s needs, padded with 0) and the pair-halo width."""
    m = L.shape[0]
    step = tile * n
    mp = -(-m // step) * step
    ms = mp // n

    Lp = scipy.sparse.csr_matrix((L.data, L.indices, L.indptr), shape=(m, mp))
    Lp.resize(mp, mp)

    need = [[np.array([], np.int64) for _ in range(n)] for _ in range(n)]
    for s in range(n):
        block = Lp[s * ms: (s + 1) * ms]
        cols = np.unique(block.indices)
        remote = cols[(cols < s * ms) | (cols >= (s + 1) * ms)]
        owners = remote // ms
        for t in range(n):
            need[s][t] = remote[owners == t]

    H = max((len(need[s][t]) for s in range(n) for t in range(n)), default=0)
    H = max(H, 1)  # keep shapes non-degenerate

    send_idx = np.zeros((n, n, H), np.int32)
    for s in range(n):
        for t in range(n):
            cols = need[s][t]
            send_idx[t, s, : len(cols)] = cols - t * ms
    return Lp, mp, ms, need, send_idx, H


def halo_exchange_columns(x_local: torch.Tensor, send_idx_local: torch.Tensor,
                          mesh: Mesh, H: int) -> torch.Tensor:
    """The per-product exchange (JAX :133): this rank's boundary rows for
    each peer (``send_idx_local`` ``[n, H]``), one ``all_to_all`` over
    ``nodes``, and ``[local | halo]`` ``[ms + n*H, C]``."""
    n = mesh.shape["nodes"]
    send = x_local.index_select(0, send_idx_local.reshape(-1))
    recv = mesh.all_to_all(send, [H] * n, [H] * n, "nodes").wait()
    return torch.cat([x_local, recv], dim=0)


def _ext_product(op, x_ext: torch.Tensor, dtype) -> torch.Tensor:
    dt = torch.promote_types(op.mat_ext.dtype, dtype)
    with full_f32_matmul():
        return torch.matmul(op.mat_ext.to(dt), x_ext.to(dt)).to(dtype)


class _HaloMatmul(torch.autograd.Function):
    """``L_ext @ exchange(x)``; the backward sends the halo slots'
    cotangents back to their owners (the reverse ``all_to_all``) and adds
    them into the rows they came from."""

    @staticmethod
    def forward(ctx, op, x):
        ctx.op = op
        x_ext = halo_exchange_columns(x, op.send_idx, op.mesh, op.halo)
        return _ext_product(op, x_ext, x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        op = ctx.op
        n, H, ms = op.mesh.shape["nodes"], op.halo, op.rows_per_shard
        dt = torch.promote_types(op.mat_ext.dtype, g.dtype)
        with full_f32_matmul():
            d_ext = torch.matmul(op.mat_ext.to(dt).t(), g.to(dt))
        back = op.mesh.all_to_all(d_ext[ms:], [H] * n, [H] * n,
                                  "nodes").wait()
        dx = d_ext[:ms].index_add(0, op.send_idx.reshape(-1), back)
        return None, dx.to(g.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class HaloShardedLaplacian(ShardedOperator):
    """This rank's rows against its extended columns ``[local rows | halo
    slots]``: ``mat_ext`` ``[ms, ms + n*H]`` (peer t's slots from column
    ``ms + t*H``) and ``send_idx`` ``[n, H]``, this rank's rows each peer
    needs."""

    mat_ext: torch.Tensor
    send_idx: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int

    @property
    def compute_dtype(self):
        return self.mat_ext.dtype

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for this rank's rows ``x`` ``[rows_per_shard, C]``."""
        return _HaloMatmul.apply(self, x)


def halo_sharded_laplacian(L: scipy.sparse.spmatrix, mesh: Mesh,
                           lmax: float = 2.0, rescale: bool = True,
                           dtype=torch.float32) -> HaloShardedLaplacian:
    """This rank's block of the halo-exchange operator (JAX :148) on the
    mesh's device.  Order the graph to reduce its bandwidth first
    (``graphs.bandwidth_reducing_permutation``): the halo is the edge cut
    of the contiguous partition."""
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    m = L.shape[0]
    n = mesh.shape["nodes"]
    Lp, mp, ms, need, send_idx, H = build_halo_plan(L, n)
    s = mesh.coord("nodes")
    block = Lp[s * ms:(s + 1) * ms].tocoo()
    col = block.col.astype(np.int64)
    ext = col - s * ms
    owner = col // ms
    for t in range(n):
        sel = owner == t
        if t != s and sel.any():
            ext[sel] = ms + t * H + np.searchsorted(need[s][t], col[sel])
    mat_ext = np.zeros((ms, ms + n * H), np.float32)
    mat_ext[block.row, ext] = block.data
    dev = mesh.device
    return HaloShardedLaplacian(
        mat_ext=torch.from_numpy(mat_ext).to(device=dev, dtype=dtype),
        send_idx=torch.from_numpy(send_idx[s].astype(np.int64)).to(dev),
        mesh=mesh, m=m, m_padded=mp, nnz=int(L.nnz), halo=H,
        rows_per_shard=ms)
