"""Node-dimension parallelism: the all-gather, row-sharded Laplacian.

Counterpart of ``cnn_graph_tpu/parallel/node_sharded.py``
(``NodeShardedLaplacian`` :45, ``node_sharded_laplacian`` :82).  Each
rank holds ``rows_per_shard`` rows of the zero-padded dense Laplacian
(all columns) and the same rows of the activations; per product it
gathers every rank's rows over the ``nodes`` axis and multiplies its row
block:

    x_full  = all_gather(x_local, "nodes")     # [Mp, C] on every rank
    y_local = L_rows_local @ x_full            # [Mp/n, C]

JAX runs the product with ``jnp.dot`` outside any Pallas kernel, so it is
a plain ``torch.matmul`` here.  The backward is the same operator on the
cotangent: L is symmetric, which JAX's transpose of the gather and the
product gives.
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

__all__ = ["NodeShardedLaplacian", "node_sharded_laplacian"]


def _gather_product(op, x: torch.Tensor) -> torch.Tensor:
    x_full = op.mesh.all_gather(x.contiguous(), "nodes")
    dt = torch.promote_types(op.mat.dtype, x.dtype)
    with full_f32_matmul():
        return torch.matmul(op.mat.to(dt), x_full.to(dt)).to(x.dtype)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, x):
        ctx.op = op
        return _gather_product(op, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, _gather_product(ctx.op, g)


@dataclasses.dataclass(frozen=True, eq=False)
class NodeShardedLaplacian(ShardedOperator):
    """This rank's ``[rows_per_shard, m_padded]`` rows of the rescaled
    Laplacian; ``matmul`` takes and returns this rank's rows."""

    mat: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    rows_per_shard: int

    @property
    def compute_dtype(self):
        return self.mat.dtype

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for this rank's rows ``x`` ``[rows_per_shard, C]``."""
        return _AllGatherMatmul.apply(self, x)


def node_sharded_laplacian(L: scipy.sparse.spmatrix, mesh: Mesh,
                           lmax: float = 2.0, rescale: bool = True,
                           dtype=torch.float32) -> NodeShardedLaplacian:
    """This rank's row block of the dense Laplacian on ``mesh``'s device;
    the node count is padded to a multiple of ``8 * nodes``, as JAX's."""
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    m = L.shape[0]
    n = mesh.shape["nodes"]
    tile = 8 * n
    mp = -(-m // tile) * tile
    ms = mp // n
    lo = mesh.coord("nodes") * ms
    rows = np.zeros((ms, mp), np.float32)
    block = L[lo:min(lo + ms, m)].toarray()
    rows[:block.shape[0], :m] = block
    return NodeShardedLaplacian(
        mat=torch.from_numpy(rows).to(device=mesh.device, dtype=dtype),
        mesh=mesh, m=m, m_padded=mp, nnz=int(L.nnz), rows_per_shard=ms)
