"""The sparse halo operators: row-sharded SpMM with an all_to_all halo
for graphs the banded ring halo cannot shard, and their int8 twins.

Counterpart of ``cnn_graph_tpu/parallel/sparse_halo.py``
(``SparseHaloLaplacian`` :50, ``BandedSparseHaloLaplacian`` :170,
``_pack_local_banded`` :375, ``QuantSparseHaloLaplacian`` :414,
``QuantBandedSparseHaloLaplacian`` :453, ``quantize_sparse_halo`` :489,
the custom VJPs :283-317 and :525-541, and ``sparse_halo_laplacian``
:544, which builds them).

The exchange plan is the dense halo operator's (``parallel.halo.
build_halo_plan``, byte-equal to JAX's): shard s keeps its ``ms`` rows
against its extended columns, its own columns first, then peer t's halo
slots from column ``ms + t*H``, padded to ``ext_p`` (a multiple of the
block width).  Per product each rank sends its peers the rows they need
in one ``all_to_all_single`` over ``nodes`` and multiplies its shard:

    x_ext = [x_local | halo recv | 0]                  # [ext_p, C]
    y     = shard @ x_ext                              # [ms, C]

Each rank holds its shard as a single-chip operator of shape ``[ms,
ext_p]`` and runs its products through that operator's kernel:

* ``SparseHaloLaplacian``: a ``BlockSparseLaplacian`` (block-CSR with
  its row index), so on the card the row kernel ``bsr_rows_kernel`` as
  route K8 (``ops.bsr``), on CPU tensors the JAX package's gather and
  segment-sum route, or with ``use_pallas`` the row walk's plain
  version.  A rank keeps its own block count (JAX pads every shard to
  the most for one SPMD program).  The hop is JAX's unfused
  ``2 (L @ x1) - x0``.
* ``BandedSparseHaloLaplacian``: a uniform ``BandedLaplacian`` (band
  ``[nbr_s, W, br, bc]`` at the caller's ``block_shape``, its bases and
  row index) over a private
  column order of the shard (``colperm``, by mean nonzero row), which
  pulls the halo slots it reads into band position.  Each product
  gathers ``x_ext[colperm]`` and runs ``ops.band.layout_call``: K5 on
  the card (``band_rows_kernel`` layout 1), the hop fused.

The int8 twins carry int8 across the exchange (half the bf16 bytes)
and compute as the single-chip quantized operators do, so every rank's
rows of a K-hop int8 chain are bit-identical to ``quantize_banded``'s
chain.  L is symmetric, so the backward of ``L @ x`` is ``L @ g``
through a second exchange.

Every rank builds the plan on the host from the global matrix (the
banded band width ``W`` over every shard, so that all ranks agree on it
without a collective) and keeps its own shard on its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import torch
from torch.autograd.function import once_differentiable

from cnn_graph_tpu_torch.graphs import rescale_laplacian
from cnn_graph_tpu_torch.ops import packing
from cnn_graph_tpu_torch.ops.band import _emit, layout_call
from cnn_graph_tpu_torch.ops.laplacian import (
    BandedLaplacian,
    BlockSparseLaplacian,
    QuantBandedLaplacian,
    QuantBlockSparseLaplacian,
    QuantOpMixin,
)
from cnn_graph_tpu_torch.ops.packing import BLOCK, _round_up
from cnn_graph_tpu_torch.parallel.banded_halo import _quantize_tensor
from cnn_graph_tpu_torch.parallel.halo import build_halo_plan
from cnn_graph_tpu_torch.parallel.mesh import Mesh, ShardedOperator

__all__ = ["SparseHaloLaplacian", "BandedSparseHaloLaplacian",
           "QuantSparseHaloLaplacian", "QuantBandedSparseHaloLaplacian",
           "sparse_halo_laplacian", "quantize_sparse_halo"]


def _extended_plan(L, n: int, block_shape, shards):
    """The exchange plan and, for each shard in ``shards``, its rows
    against its extended columns (JAX :561-590) as a COO matrix ``[ms,
    ext_p]``.  JAX maps each nonzero's column through a dict; here each
    peer's columns go to their halo slots by ``np.searchsorted`` on the
    sorted ``need[s][t]``.  Returns ``(mp, ms, H, ext_p, send_idx,
    locals)``."""
    br, bc = block_shape
    Lp, mp, ms, need, send_idx, H = build_halo_plan(
        L, n, tile=int(np.lcm(br, bc)))
    ext_p = _round_up(ms + n * H, bc)
    locals_ = {}
    for s in shards:
        block = Lp[s * ms:(s + 1) * ms].tocoo()
        col = block.col.astype(np.int64)
        ext = col - s * ms
        owner = col // ms
        for t in range(n):
            sel = owner == t
            if t != s and sel.any():
                ext[sel] = ms + t * H + np.searchsorted(need[s][t], col[sel])
        locals_[s] = scipy.sparse.coo_matrix(
            (block.data, (block.row, ext)), shape=(ms, ext_p))
    return mp, ms, H, ext_p, send_idx, locals_


def _pack_local_banded(block, ms: int, ext_p: int, block_shape):
    """One shard's private column order, by mean nonzero row, and its
    band geometry (JAX :375): ``(rows, new_cols, data, base, W,
    order)``, ``order[new] = old`` column, ``base`` the suffix minimum of
    each block row's lowest block column (monotone), ``W`` its width."""
    br, bc = block_shape
    rows = block.row.astype(np.int64)
    cols = block.col.astype(np.int64)
    col_sum = np.zeros(ext_p, np.float64)
    col_cnt = np.zeros(ext_p, np.int64)
    np.add.at(col_sum, cols, rows)
    np.add.at(col_cnt, cols, 1)
    key = np.where(col_cnt > 0, col_sum / np.maximum(col_cnt, 1), np.inf)
    order = np.argsort(key, kind="stable")
    colpos = np.empty(ext_p, np.int64)
    colpos[order] = np.arange(ext_p)
    new_cols = colpos[cols]

    nbr = ms // br
    n_cb = ext_p // bc
    brow = rows // br
    bcol = new_cols // bc
    lo = np.full(nbr, n_cb, np.int64)
    hi = np.full(nbr, -1, np.int64)
    np.minimum.at(lo, brow, bcol)
    np.maximum.at(hi, brow, bcol)
    base = np.minimum.accumulate(lo[::-1])[::-1]
    W = int(max((hi - base).max() + 1, 1))
    return rows, new_cols, block.data, base, W, order


def _banded_shard(packed, W: int, ms: int, ext_p: int, block_shape):
    """A shard's uniform band ``[nbr_s, W, br, bc]`` at the width of
    every shard, its bases clipped into the extended columns (JAX
    :334-341), and ``colperm``."""
    br, bc = block_shape
    rows, cols, data, base, _, order = packed
    nbr, n_cb = ms // br, ext_p // bc
    base = np.clip(base, 0, max(n_cb - W, 0)).astype(np.int64)
    band = np.zeros((nbr, W, br, bc), np.float32)
    brow = rows // br
    band[brow, cols // bc - base[brow], rows % br, cols % bc] = (
        data.astype(np.float32))
    return band, base.astype(np.int32), order.astype(np.int64)


class _SparseHaloMixin(ShardedOperator):
    """What the four sparse halo operators share: the exchange into the
    extended columns and the shard's product."""

    @property
    def compute_dtype(self):
        return self.local.compute_dtype

    @property
    def use_pallas(self) -> bool:
        return self.local.use_pallas

    def _extended(self, x: torch.Tensor) -> torch.Tensor:
        """``[x | halo recv | 0]`` ``[ext_p, C]``: the rows each peer
        needs of ``x`` go out and the slots come back in one
        ``all_to_all`` over ``nodes`` (JAX :109-112)."""
        n, H, ms = self.mesh.shape["nodes"], self.halo, self.rows_per_shard
        send = x.index_select(0, self.send_idx.reshape(-1))
        recv = self.mesh.all_to_all(send, [H] * n, [H] * n, "nodes").wait()
        x_ext = x.new_empty((self.ext_cols_padded, x.shape[1]))
        x_ext[:ms] = x
        x_ext[ms:ms + n * H] = recv
        x_ext[ms + n * H:] = 0
        return x_ext

    def _shard_call(self, x, x0=None, band_scale=None) -> torch.Tensor:
        """One product of this rank's rows ``x`` (in the compute dtype):
        the exchange, then the shard's kernel, ``L @ x`` or the fused
        ``2 L @ x - x0``."""
        x_ext = self._extended(x)
        if isinstance(self.local, (BandedLaplacian, QuantBandedLaplacian)):
            return layout_call(self.local,
                               x_ext.index_select(0, self.colperm), x0,
                               band_scale=band_scale)
        if band_scale is not None:
            if self.local.use_pallas:
                return self.local.kernel_call(x_ext, x0, "K8", band_scale)
            return _emit(self.local._acc(x_ext), x0, None, band_scale,
                         torch.int8)
        y = self.local.matmul(x_ext)
        return y if x0 is None else (2.0 * y - x0).to(y.dtype)

    def _apply(self, x, x0=None) -> torch.Tensor:
        """A float product with the kernel boundary's casts to the
        compute dtype and back to x's."""
        cdt = self.compute_dtype
        y = self._shard_call(x.to(cdt).contiguous(),
                             None if x0 is None else x0.to(cdt).contiguous())
        return y.to(x.dtype)


class _Matmul(torch.autograd.Function):
    """``L @ x``; L is symmetric, so ``dx = L g`` (JAX :525-541)."""

    @staticmethod
    def forward(ctx, op, x):
        ctx.op = op
        return op._apply(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, ctx.op._apply(g)


class _Hop(torch.autograd.Function):
    """The banded shard's fused ``2 L @ x1 - x0``; ``dx1 = 2 L g``,
    ``dx0 = -g`` (JAX :301-317)."""

    @staticmethod
    def forward(ctx, op, x1, x0):
        ctx.op, ctx.x0_dtype = op, x0.dtype
        return op._apply(x1, x0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dx1 = (2.0 * ctx.op._apply(g)).to(g.dtype)
        return None, dx1, (-g).to(ctx.x0_dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseHaloLaplacian(_SparseHaloMixin):
    """This rank's shard of the row-sharded block-sparse Laplacian:
    ``local``, a ``BlockSparseLaplacian`` ``[rows_per_shard,
    ext_cols_padded]`` over the extended columns, and ``send_idx`` ``[n,
    H]``, this rank's rows each peer needs.  ``matmul`` and
    ``cheby_hop`` take and return this rank's rows and are
    differentiable."""

    local: BlockSparseLaplacian
    send_idx: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int

    @property
    def blocks(self) -> torch.Tensor:
        return self.local.blocks

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for this rank's rows ``x`` ``[rows_per_shard, C]``."""
        return _Matmul.apply(self, x)


@dataclasses.dataclass(frozen=True, eq=False)
class BandedSparseHaloLaplacian(_SparseHaloMixin):
    """This rank's shard as a uniform banded operator over its private
    column order: ``local`` a ``BandedLaplacian`` with band ``[nbr_s, W,
    br, bc]`` (``ragged`` off), ``colperm`` ``[ext_p]`` (new position
    -> extended column) and ``send_idx`` ``[n, H]``.  Products run K5 on
    the gathered ``x_ext[colperm]``; the hop is one fused pass."""

    local: BandedLaplacian
    colperm: torch.Tensor
    send_idx: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int

    @property
    def band(self) -> torch.Tensor:
        return self.local.band

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for this rank's rows ``x`` ``[rows_per_shard, C]``."""
        return _Matmul.apply(self, x)

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """The fused hop ``2 (L @ x1) - x0``, one kernel pass."""
        return _Hop.apply(self, x1, x0)


class _QuantSparseHaloMixin(_SparseHaloMixin, QuantOpMixin):
    """The int8 twins' protocol: every product one exchange of int8
    carries and one int8 pass with the global band scale."""

    def _call(self, x_q, x0_q):
        return self._shard_call(x_q, x0_q, band_scale=self.band_scale)

    def cheby_chain_q(self, x_q: torch.Tensor, K: int) -> torch.Tensor:
        """The stacked int8 K-term basis ``[K, rows_per_shard, C]``."""
        basis = [x_q]
        if K > 1:
            basis.append(self.spmm_q(x_q))
        for _ in range(2, K):
            basis.append(self.cheby_hop_q(basis[-1], basis[-2]))
        return torch.stack(basis)


@dataclasses.dataclass(frozen=True, eq=False)
class QuantSparseHaloLaplacian(_QuantSparseHaloMixin):
    """The int8 twin of ``SparseHaloLaplacian`` (JAX :414), multi-chip
    serving on scattered graphs: ``local`` a ``QuantBlockSparseLaplacian``
    whose ``block_scale`` is the global ``band_scale``.  Inference
    only."""

    local: QuantBlockSparseLaplacian
    send_idx: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int
    band_scale: float = 1.0
    act_scale: float = 1.0
    headroom: float = 2.0


@dataclasses.dataclass(frozen=True, eq=False)
class QuantBandedSparseHaloLaplacian(_QuantSparseHaloMixin):
    """The int8 twin of ``BandedSparseHaloLaplacian`` (JAX :453): ``local``
    a uniform ``QuantBandedLaplacian`` whose ``band_scale`` is the global
    one.  Inference only."""

    local: QuantBandedLaplacian
    colperm: torch.Tensor
    send_idx: torch.Tensor
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int
    band_scale: float = 1.0
    act_scale: float = 1.0
    headroom: float = 2.0


def quantize_sparse_halo(op, headroom: float = 2.0, sample_x: float = 1.0):
    """The int8 twin of a sparse halo operator (JAX :489): one global
    band scale ``max|L| / 127``, the max over every shard's data (an
    ``all_reduce(MAX)`` over ``nodes``), the data ``clip(round(L / s),
    +-127)`` half to even, and one activation scale with ``headroom``."""
    banded = isinstance(op, BandedSparseHaloLaplacian)
    data = op.local.band if banded else op.local.blocks
    local = (data.abs().amax() if data.numel() else data.new_zeros(())
             ).to(torch.float32).reshape(1)
    s_b = float(op.mesh.all_reduce(local, "nodes", "max"))
    s_b = s_b / 127.0 if s_b > 0.0 else 1.0
    s32 = torch.tensor(s_b, dtype=torch.float32, device=data.device)
    q = _quantize_tensor(data, s32)
    act = float(sample_x) * headroom / 127.0
    fields = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)}
    if banded:
        lo = op.local
        fields["local"] = QuantBandedLaplacian(
            band=q, base=lo.base, m=lo.m, m_padded=lo.m_padded, nnz=lo.nnz,
            rows_per_step=lo.rows_per_step, use_pallas=lo.use_pallas,
            band_scale=s_b, act_scale=act, headroom=headroom,
            nz_rowptr=lo.nz_rowptr, nz_win=lo.nz_win,
            block_shape=lo.block_shape)
        cls = QuantBandedSparseHaloLaplacian
    else:
        lo = {f.name: getattr(op.local, f.name)
              for f in dataclasses.fields(op.local)}
        lo.update(blocks=q, block_scale=s_b, act_scale=act,
                  headroom=headroom)
        fields["local"] = QuantBlockSparseLaplacian(**lo)
        cls = QuantSparseHaloLaplacian
    return cls(**fields, band_scale=s_b, act_scale=act, headroom=headroom)


def _rows_per_step(nbr: int) -> int:
    """The port's G, ``min(8, block rows)``, lowered to a divisor of the
    shard's block rows (the uniform layout's G changes no result)."""
    return next(g for g in range(min(packing.ROWS_PER_STEP, nbr), 0, -1)
                if nbr % g == 0)


def sparse_halo_laplacian(
    L: scipy.sparse.spmatrix,
    mesh: Mesh,
    lmax: float = 2.0,
    rescale: bool = True,
    dtype=torch.float32,
    block_shape: tuple = (BLOCK, BLOCK),
    fmt: str = "bsr",
    max_band_width: int = 32,
    use_pallas: bool | None = None,
):
    """This rank's shard of the sparse halo operator over ``mesh``'s
    ``nodes`` axis (JAX :544), on the mesh's device.  Order the graph to
    reduce its bandwidth first: the halo is the contiguous partition's
    edge cut.

    ``fmt``: ``"bsr"`` (block-CSR shard, the row kernel as K8),
    ``"banded"`` (the shard in its private column order as a uniform
    band of ``block_shape`` blocks, K5; raises ``ValueError`` when any
    shard's band is wider than ``max_band_width`` blocks) or ``"auto"``
    (banded where every shard fits, else bsr), as JAX's :592-604.
    ``use_pallas``
    (default: wherever CUDA is available) runs the shard's kernel, else
    the gather route (bsr) or the kernel's plain version (banded)."""
    if fmt not in ("bsr", "banded", "auto"):
        raise ValueError(f"unknown sparse halo format {fmt!r}")
    block_shape = tuple(block_shape)
    br = block_shape[0]
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    n = mesh.shape["nodes"]
    s = mesh.coord("nodes")
    if use_pallas is None:
        use_pallas = torch.cuda.is_available()
    use_pallas = bool(use_pallas)
    banded = fmt in ("banded", "auto")
    mp, ms, H, ext_p, send_idx, locals_ = _extended_plan(
        L, n, block_shape, range(n) if banded else (s,))
    dev = mesh.device
    common = dict(send_idx=torch.from_numpy(send_idx[s].astype(np.int64)).to(
        dev), mesh=mesh, m=L.shape[0], m_padded=mp, nnz=int(L.nnz), halo=H,
        rows_per_shard=ms, block_shape=block_shape, ext_cols_padded=ext_p)

    if banded:
        packed = [_pack_local_banded(locals_[t], ms, ext_p, block_shape)
                  for t in range(n)]
        W = max(p[4] for p in packed)
        if W <= max_band_width:
            band, base, colperm = _banded_shard(packed[s], W, ms, ext_p,
                                                block_shape)
            rows, cols, data = packed[s][:3]
            perm = scipy.sparse.csr_matrix((data, (rows, cols)),
                                           shape=(ms, ext_p))
            nz_rowptr, nz_win = packing.band_row_index(perm, base, ms,
                                                       block_shape)
            local = BandedLaplacian(
                band=torch.from_numpy(band).to(device=dev, dtype=dtype),
                base=torch.from_numpy(base).to(dev), m=ms, m_padded=ms,
                nnz=int(len(data)), rows_per_step=_rows_per_step(ms // br),
                use_pallas=use_pallas,
                nz_rowptr=torch.from_numpy(nz_rowptr).to(dev),
                nz_win=torch.from_numpy(nz_win).to(dev),
                block_shape=block_shape)
            return BandedSparseHaloLaplacian(
                local=local, colperm=torch.from_numpy(colperm).to(dev),
                **common)
        if fmt == "banded":
            raise ValueError(f"per-shard band width {W} exceeds "
                             f"{max_band_width}; use fmt='bsr' (or fewer "
                             "shards)")

    loc = locals_[s]
    blocks, brows, bcols, rowptr, _ = packing.pack_block_sparse(
        loc, block_shape)
    nz_rowptr, nz_cols, nz_pos = packing.row_index(loc, brows, bcols,
                                                   block_shape, ms)

    def put(a, dt=None):
        t = torch.from_numpy(a).to(dev)
        return t if dt is None else t.to(dt)

    local = BlockSparseLaplacian(
        blocks=put(blocks, dtype), block_rows=put(brows),
        block_cols=put(bcols), block_rowptr=put(rowptr), m=ms, m_padded=ms,
        nnz=int(loc.nnz), block_shape=block_shape, use_pallas=use_pallas,
        nz_rowptr=put(nz_rowptr), nz_cols=put(nz_cols), nz_pos=put(nz_pos))
    return SparseHaloLaplacian(local=local, **common)
