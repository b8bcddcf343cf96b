"""Graph Laplacian operators on torch tensors.

Counterpart of ``cnn_graph_tpu/ops/laplacian.py``.  Ported so far:

* ``DenseLaplacian`` (:130): zero-padded ``[Mp, Mp]`` matrix, plain
  ``torch.matmul`` for the stacked path; with ``use_fused`` the conv
  takes the fused kernels K2 and K3 (``ops/cheby.py``).
* ``BandedLaplacian`` (:291) in its three layouts (uniform, flat
  ragged, deep-K window), multiplied by the kernels K5, K6 and K1 of
  ``csrc/band.cu`` (``ops/band.py``).
* ``QuantBandedLaplacian`` (:409, with ``QuantOpMixin`` :95 folded in)
  and ``quantize_banded`` (:745): the int8 serving twin, same kernels in
  their int8 form.
* ``cheby_finals`` (:519): the chain driver with in-place hops.
* ``BlockSparseLaplacian`` (:162): dense 128x128 blocks at the nonzero
  block positions, in block-CSR order or the column-streamed layout,
  multiplied by the ``bsr_colstream`` and ``bsr_csr`` kernels
  (``ops/bsr.py``) when built with ``use_pallas``, else by the JAX
  package's gather and segment-sum route in plain torch.
* ``QuantBlockSparseLaplacian`` (:642) and ``quantize_block_sparse``
  (:713): its int8 serving twin.
* ``QuantDenseLaplacian`` (:575) and ``quantize_dense`` (:617): the
  dense operator's int8 serving twin.
* ``BCOOLaplacian`` (:385): the library fallback, a torch sparse COO
  matrix multiplied by ``torch.sparse.mm`` (JAX's is ``jax.experimental.
  sparse`` in XLA, no Pallas kernel).
* ``device_laplacian`` (:1200) with the JAX package's format choice and
  its banded, BSR and BCOO layouts.

Operators are frozen dataclasses of tensors; ``.to(device)`` returns a
copy on another device.  ``operator_leaves`` and ``with_operator_leaves``
take an operator's tensors out as leaves and put others in (the tables
``torch.export`` traces as inputs); its ints and floats stay static.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect

import numpy as np
import scipy.sparse
import torch

from cnn_graph_tpu_torch.graphs import rescale_laplacian
from cnn_graph_tpu_torch.ops import packing, quant
from cnn_graph_tpu_torch.ops.packing import _round_up
from cnn_graph_tpu_torch.ops.band import (
    _emit,
    band_cheby_hop,
    band_cheby_hop_c,
    band_spmm,
    check_band_index,
    check_band_tables,
    layout_call,
    level_rows_of,
)
from cnn_graph_tpu_torch.ops.bsr import (
    block_products,
    bsr_call_quant,
    bsr_cheby_hop,
    bsr_spmm,
    kernel_call,
)
from cnn_graph_tpu_torch.ops.cheby import cheby_dw_fused, fused_filter
from cnn_graph_tpu_torch.utils.profiling import count, span

__all__ = [
    "DENSE_THRESHOLD",
    "DenseLaplacian",
    "BandedLaplacian",
    "QuantBandedLaplacian",
    "quantize_banded",
    "cheby_finals",
    "BlockSparseLaplacian",
    "QuantBlockSparseLaplacian",
    "quantize_block_sparse",
    "QuantDenseLaplacian",
    "quantize_dense",
    "BCOOLaplacian",
    "device_laplacian",
    "operator_leaves",
    "with_operator_leaves",
]

# Auto-format thresholds of the JAX package (laplacian.py:1240-1277),
# tuned on a TPU v5e and kept for parity; to be re-tuned on Hopper.
DENSE_THRESHOLD = 2048  # nodes: dense at or below


@dataclasses.dataclass(frozen=True)
class DenseLaplacian:
    """Rescaled Laplacian as a zero-padded dense ``[Mp, Mp]`` matrix."""

    mat: torch.Tensor
    m: int
    m_padded: int
    nnz: int
    use_fused: bool = False  # cheby_conv takes K2/K3 where eligible

    @property
    def compute_dtype(self):
        return self.mat.dtype

    def fused_filter(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``sum_k T_k(L) x W_k`` by the fused kernel K2, no backward."""
        return fused_filter(x, self, w)

    def fused_dw(self, x: torch.Tensor, g: torch.Tensor,
                 K: int) -> torch.Tensor:
        """K2's weight gradient by the fused kernel K3."""
        return cheby_dw_fused(x, self, g, K)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``."""
        dt = torch.promote_types(self.mat.dtype, x.dtype)
        return torch.matmul(self.mat.to(dt), x.to(dt)).to(x.dtype)

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """Chebyshev recurrence hop ``2 (L @ x1) - x0``."""
        return (2.0 * self.matmul(x1) - x0).to(x1.dtype)

    def to(self, device) -> DenseLaplacian:
        return dataclasses.replace(self, mat=self.mat.to(device))


# The port's own fields of the banded operators: the nonzero index by
# output row (``packing.band_row_index``) that K1, K5 and K6 walk.
BAND_INDEX_FIELDS = ("nz_rowptr", "nz_win")


class _BandedMixin:
    """What the float and int8 banded operators share: the layout
    fields' accessors and ``.to``."""

    def __post_init__(self):
        # The kernels take the tables' values on trust: checked once here.
        if self.levels:
            check_band_tables((self.band,), self.base, self.sched,
                              self.levels, self.rows_per_step, "ragged")
        else:
            check_band_tables((self.band,), self.base, None, (), 1,
                              "uniform")
        if self.bands_dkw is not None:
            check_band_tables(self.bands_dkw, self.base, self.sched_dkw,
                              self.levels, self.rows_per_step, "dkw")
        if self.nz_rowptr is not None:
            check_band_index(self.nz_rowptr, self.nz_win, self.base,
                             self.sched, self.levels or (self.band_width,),
                             self.rows_per_step, self.block_shape)
        # Not a field: derived from sched, so every build recomputes it.
        object.__setattr__(self, "level_rows", None if (
            not self.levels or self.sched.is_meta) else level_rows_of(
                self.sched, self.base.numel(), self.rows_per_step,
                len(self.levels)))

    @property
    def band_width(self) -> int:
        return self.levels[-1] if self.levels else self.band.shape[1]

    def to(self, device):
        moved = {f: getattr(self, f).to(device)
                 for f in ("band", "base", "sched", "sched_dkw")
                 + BAND_INDEX_FIELDS if getattr(self, f) is not None}
        if self.bands_dkw is not None:
            moved["bands_dkw"] = tuple(b.to(device) for b in self.bands_dkw)
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass(frozen=True)
class BandedLaplacian(_BandedMixin):
    """Rescaled Laplacian as a block band with monotone window bases
    ``base`` (JAX :291-376), in one of three layouts:

    * uniform (``levels`` empty): ``band`` is ``[nbr, W, br, bc]``;
      ``band[i, d]`` is the block at block coordinates ``(i, base[i] +
      d)``.  Products run K5 (``ops.band.banded_uniform``).
    * flat ragged (``levels`` set): ``band`` is ``[total, br, bc]``;
      each G-row step s stores ``W_s = levels[sched[1, s]]`` blocks per
      row from ``sched[0, s]`` on.  Products run K6 (``banded_ragged``).
      ``sched`` is int32 ``[3, nsb]`` on the band's device; rows 0-1 are
      what the GPU reads, row 2 (the TPU's column high-water) is kept for
      parity.
    * deep-K window (``bands_dkw`` set, beside the flat band): one array
      ``[n_rows_l, br, W_l*bc]`` per level, ``sched_dkw`` with each
      step's row offset.  Products run K1 (``banded_dkw``).

    ``block_shape`` is ``(br, bc)``, JAX's field: 128x128 by default, any
    shape ``device_laplacian(block_size=...)`` packs.

    Beside JAX's fields the operator carries the nonzero index by output
    row, ``nz_rowptr`` (int32 ``[m_padded + 1]``) and ``nz_win`` (int16,
    each nonzero's offset in its block-row's window;
    ``ops.packing.band_row_index``): K1, K5 and K6 walk it and read each
    value from the layout's own band, so one index serves every layout
    of a graph, the int8 twin and shifted bases.  ``level_rows``, an
    attribute derived from ``sched`` at build (one int64 tensor per
    level), lists each width level's block rows, which the plain
    versions take.

    With ``use_pallas`` the products run the layout's kernel, without it
    the kernel's plain version, which computes what JAX's fallback does
    (f32 accumulation of the window products, rounded once)."""

    band: torch.Tensor
    base: torch.Tensor
    m: int
    m_padded: int
    nnz: int
    rows_per_step: int
    use_pallas: bool
    sched: torch.Tensor | None = None
    levels: tuple = ()
    bands_dkw: tuple | None = None
    sched_dkw: torch.Tensor | None = None
    nz_rowptr: torch.Tensor | None = None
    nz_win: torch.Tensor | None = None
    block_shape: tuple = (packing.BLOCK, packing.BLOCK)

    @property
    def compute_dtype(self):
        return self.band.dtype

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``."""
        return band_spmm(self, x)

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor, *,
                  donate: bool = False) -> torch.Tensor:
        """``2 (L @ x1) - x0``; ``donate`` writes it over ``x0``
        (inference only)."""
        return band_cheby_hop(self, x1, x0, donate=donate)

    def cheby_hop_c(self, x1: torch.Tensor, x0: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
        """The adjoint chain's hop ``2 (L @ x1) - x0 + c``, no backward."""
        return band_cheby_hop_c(self, x1, x0, c)


class QuantOpMixin:
    """The int8 serving protocol of the JAX package's ``QuantOpMixin``
    (:95-121).  The operator carries one global scale ``max|L| / 127``;
    activations ride one scale across the recurrence, and the kernels'
    emission works in input-scale units, so that scale never enters a
    kernel: callers may pass a run-time scale to ``quantize``/
    ``dequantize``.  Inference only, as the JAX int8 operators are:
    ``quantize`` raises when a gradient would be needed through it.
    Subclasses carry ``act_scale`` and implement ``_call(x_q, x0_q)``.
    Each ``quantize`` and ``dequantize`` is one launch of
    ``csrc/quant.cu`` on the card, the plain expression on the CPU
    (``ops/quant.py``), in a span timed on the card, and counts the bytes
    its elements need at least (``quant_bytes``: 4 read and 1 written,
    ``dequant_bytes``: 1 read and 4 written)."""

    @property
    def compute_dtype(self):
        return torch.int8

    def quantize(self, x: torch.Tensor, scale=None) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                f"{type(self).__name__} is inference-only (no backward "
                "through int8): run under torch.no_grad()/inference_mode()")
        s = self.act_scale if scale is None else scale
        count("quant_bytes", 5 * x.numel())
        with span("quantize", device=True):
            return quant.quantize_int8(x, s)

    def dequantize(self, q: torch.Tensor, dtype=torch.float32,
                   scale=None) -> torch.Tensor:
        s = self.act_scale if scale is None else scale
        count("dequant_bytes", 5 * q.numel())
        with span("dequantize", device=True):
            return quant.dequantize_int8(q, s, dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Float view: quantize -> int8 SpMM -> dequantize."""
        return self.dequantize(self.spmm_q(self.quantize(x)), x.dtype)

    def spmm_q(self, x_q: torch.Tensor) -> torch.Tensor:
        """``quantize(L @ dequantize(x_q))`` in one int8 pass."""
        return self._call(x_q, None)

    def cheby_hop_q(self, x1_q: torch.Tensor,
                    x0_q: torch.Tensor) -> torch.Tensor:
        """Quantized fused recurrence hop ``2 (L @ x1) - x0``."""
        return self._call(x1_q, x0_q)


@dataclasses.dataclass(frozen=True)
class QuantBandedLaplacian(_BandedMixin, QuantOpMixin):
    """Int8 banded Laplacian for serving, the JAX package's banded twin
    (:409): the float operator's layouts with the band in int8 and
    ``band_scale = max|L| / 127``, every product one int8 launch of the
    layout's kernel (or its plain version without ``use_pallas``)."""

    band: torch.Tensor
    base: torch.Tensor
    m: int
    m_padded: int
    nnz: int
    rows_per_step: int
    use_pallas: bool
    band_scale: float
    act_scale: float
    headroom: float = 2.0
    sched: torch.Tensor | None = None
    levels: tuple = ()
    bands_dkw: tuple | None = None
    sched_dkw: torch.Tensor | None = None
    nz_rowptr: torch.Tensor | None = None
    nz_win: torch.Tensor | None = None
    block_shape: tuple = (packing.BLOCK, packing.BLOCK)

    def _call(self, x_q, x0_q, donate=False):
        return layout_call(self, x_q, x0_q, band_scale=self.band_scale,
                           donate=donate)

    def cheby_hop_q(self, x1_q: torch.Tensor, x0_q: torch.Tensor, *,
                    donate: bool = False) -> torch.Tensor:
        """Quantized fused recurrence hop ``2 (L @ x1) - x0``; ``donate``
        writes it over ``x0_q``."""
        return self._call(x1_q, x0_q, donate)


def quantize_banded(op: BandedLaplacian, headroom: float = 2.0,
                    sample_x: float = 1.0) -> QuantBandedLaplacian:
    """Quantize a BandedLaplacian for int8 inference (JAX :745-786).  The
    scale comes from the flat or uniform band; the dkw twin is built only
    where the float operator has the dkw layout's conditions,
    ``use_pallas`` and ``levels``.  ``sample_x`` is the expected
    activation max; ``headroom`` widens the activation scale so carries
    that wander above the input range saturate instead of wrapping.  The
    row index is the float operator's: the int8 band has its layout."""
    host = op.band.to(torch.float32).cpu().numpy()
    s_b = packing.band_scale_of([host])
    band_q = packing.quantize_band(host, s_b)
    dev = op.base.device
    bands_dkw = sched_dkw = None
    if op.use_pallas and op.levels:
        bd, sd = packing.pack_dkw_from_ragged(
            band_q, op.sched.cpu().numpy(), op.levels, op.rows_per_step,
            op.block_shape)
        bands_dkw = tuple(_tensor(b, dev) for b in bd)
        sched_dkw = _tensor(sd, dev)
    return QuantBandedLaplacian(
        band=_tensor(band_q, dev), base=op.base, m=op.m,
        m_padded=op.m_padded, nnz=op.nnz, rows_per_step=op.rows_per_step,
        use_pallas=op.use_pallas, band_scale=s_b,
        act_scale=float(sample_x) * headroom / 127.0, headroom=headroom,
        sched=op.sched, levels=op.levels, bands_dkw=bands_dkw,
        sched_dkw=sched_dkw, nz_rowptr=op.nz_rowptr, nz_win=op.nz_win,
        block_shape=op.block_shape,
    )


def cheby_finals(L, x: torch.Tensor, K: int) -> torch.Tensor:
    """``T_{K-1}(L) x`` by the K-1-product Chebyshev recurrence (JAX
    :519-565): the chain driver behind the throughput benches.  Two hops
    per loop iteration, each written in place over the older carry
    where the operator's hop takes ``donate`` and the carries are in its
    compute dtype,

        r = hop(q, p)   # into p's buffer
        s = hop(r, q)   # into q's buffer

    so the chain runs on two fixed buffers.  The caller's ``x`` is never
    written: the first hop that would overwrite it allocates instead.
    Operators with ``cheby_hop_q`` take and return int8 carries (pass
    ``x`` quantized); every other runs in its compute dtype.  No hop is
    donated while autograd records ``x``."""
    quant = hasattr(L, "cheby_hop_q")
    f = L.cheby_hop_q if quant else L.cheby_hop
    donate_ok = ("donate" in inspect.signature(f).parameters
                 and (quant or x.dtype == L.compute_dtype)
                 and not (torch.is_grad_enabled() and x.requires_grad))

    def hop(a, b, donate):
        return f(a, b, donate=True) if donate and donate_ok else f(a, b)

    if K <= 1:
        return x
    p, q = x, (L.spmm_q(x) if quant else L.matmul(x))
    n = K - 2  # hops remaining after the first product
    for i in range(n // 2):
        r = hop(q, p, donate=i > 0)
        s = hop(r, q, donate=True)
        p, q = r, s
    if n % 2:
        q = hop(q, p, donate=n > 1)
    return q


def _gather_products(op, x, compute_dtype, acc_dtype) -> torch.Tensor:
    """The JAX package's gather and segment-sum route (:240-255,
    :676-691): every real block's product with its gathered x tile in
    ``compute_dtype``, cast to ``acc_dtype`` and summed into its row.
    ``[Mp, C]`` in ``acc_dtype``; x has the operator's columns (more than
    ``Mp`` rows for a rectangular shard)."""
    nb = op.block_cols.numel()
    acc = block_products(op.blocks[:nb], op.block_rows.to(torch.int64),
                         op.block_cols.to(torch.int64), x,
                         op.m_padded // op.block_shape[0], op.block_shape,
                         compute_dtype, acc_dtype)
    return acc.reshape(-1, x.shape[1])


# The port's own fields of the BSR operators: the nonzero index by output
# row (``packing.row_index``) that the GPU's row kernel walks.
ROW_INDEX_FIELDS = ("nz_rowptr", "nz_cols", "nz_pos")


class _BsrMixin:
    """What the float and int8 BSR operators share."""

    @property
    def block_size(self):  # square-block accessor, as in JAX
        return self.block_shape[0]

    def kernel_call(self, x, x0, route, block_scale=None):
        """One BSR kernel launch by ``route`` (``ops.bsr.kernel_call``)."""
        return kernel_call(self, x, x0, route, block_scale)

    def to(self, device):
        moved = {f: getattr(self, f).to(device) for f in (
            "blocks", "block_rows", "block_cols", "block_rowptr", "cs_meta",
            "cs_gcols", "cs_gcolptr", "cs_groupptr") + ROW_INDEX_FIELDS
            if getattr(self, f) is not None}
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass(frozen=True)
class BlockSparseLaplacian(_BsrMixin):
    """Rescaled Laplacian as dense ``br x bc`` blocks at the nonzero block
    positions: ``blocks[i]`` sits at block coordinates ``(block_rows[i],
    block_cols[i])``, in block-CSR order with row extents
    ``block_rowptr``.

    Layouts, as the JAX package builds them: ``row_max > 0`` (chunked
    rows) and ``group_max > 0`` (row groups of ``rows_per_step``) give
    ``blocks`` a zero tail of that many blocks; ``col_stream`` reorders
    each group of ``rows_per_step`` block-rows by (column, row), pads it
    to whole 8-block bundles, adds a 64-block zero tail and the kernel
    metadata ``cs_*`` (``ops.packing.colstream_pack``); ``block_rows`` is
    then not sorted within a group and ``block_rowptr`` holds at group
    boundaries only.

    Beside JAX's fields the operator carries the nonzero index by output
    row, ``nz_rowptr`` (int32 ``[m_padded + 1]``), ``nz_cols`` (int32) and
    ``nz_pos`` (int64, each nonzero's flat place in ``blocks``;
    ``ops.packing.row_index``): the GPU kernel walks it and reads the
    values from ``blocks`` through it, so a copy with other ``blocks`` of
    the same layout (another dtype, the int8 twin) stays right.

    With ``use_pallas`` the products run through the BSR kernels
    (``ops.bsr``); without, through the gather and segment-sum route,
    whose bf16 products round per block before the sum, as in JAX."""

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    block_rowptr: torch.Tensor
    m: int
    m_padded: int
    nnz: int
    block_shape: tuple
    use_pallas: bool
    row_max: int = 0
    rows_per_step: int = 1
    group_max: int = 0
    col_stream: bool = False
    cs_meta: torch.Tensor | None = None
    cs_gcols: torch.Tensor | None = None
    cs_gcolptr: torch.Tensor | None = None
    cs_groupptr: torch.Tensor | None = None
    nz_rowptr: torch.Tensor | None = None
    nz_cols: torch.Tensor | None = None
    nz_pos: torch.Tensor | None = None

    @property
    def compute_dtype(self):
        return self.blocks.dtype

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``."""
        if self.use_pallas:
            return bsr_spmm(self, x)
        dt = torch.promote_types(self.blocks.dtype, x.dtype)
        return _gather_products(self, x, dt, x.dtype)

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """``2 (L @ x1) - x0``: one fused kernel pass where JAX has one
        (column-streamed or grouped rows), else from ``matmul``."""
        if self.use_pallas and (self.rows_per_step > 1 or self.col_stream):
            return bsr_cheby_hop(self, x1, x0)
        return (2.0 * self.matmul(x1) - x0).to(x1.dtype)


@dataclasses.dataclass(frozen=True)
class QuantBlockSparseLaplacian(_BsrMixin, QuantOpMixin):
    """Int8 BSR Laplacian for serving, the JAX package's twin (:642): the
    float operator's layout with int8 blocks and ``block_scale = max|L| /
    127``.  With ``use_pallas``, ``group_max > 0`` or ``col_stream``
    products run through the BSR kernel in its int8 form; otherwise
    through the int32 gather route."""

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    block_rowptr: torch.Tensor
    m: int
    m_padded: int
    nnz: int
    block_shape: tuple
    use_pallas: bool
    block_scale: float
    act_scale: float
    headroom: float = 2.0
    row_max: int = 0
    rows_per_step: int = 1
    group_max: int = 0
    col_stream: bool = False
    cs_meta: torch.Tensor | None = None
    cs_gcols: torch.Tensor | None = None
    cs_gcolptr: torch.Tensor | None = None
    cs_groupptr: torch.Tensor | None = None
    nz_rowptr: torch.Tensor | None = None
    nz_cols: torch.Tensor | None = None
    nz_pos: torch.Tensor | None = None

    def _acc(self, x_q: torch.Tensor) -> torch.Tensor:
        """The exact accumulator ``(L / block_scale) @ x_q`` (int32 in
        JAX; float64 here, exact at these magnitudes on every device)."""
        return _gather_products(self, x_q, torch.float64, torch.float64)

    def _call(self, x_q, x0_q):
        if self.use_pallas and (self.group_max > 0 or self.col_stream):
            return bsr_call_quant(self, x_q, x0_q)
        return _emit(self._acc(x_q), x0_q, None, self.block_scale,
                     torch.int8)


def quantize_block_sparse(op: BlockSparseLaplacian, headroom: float = 2.0,
                          sample_x: float = 1.0) -> QuantBlockSparseLaplacian:
    """Quantize a BlockSparseLaplacian for int8 inference: blocks
    ``clip(round(blocks / s), +-127)`` in float32 with ``s = max|blocks| /
    127``, on the blocks' device, byte-equal to the JAX package's NumPy
    quantizer.  ``sample_x`` and ``headroom`` as in ``quantize_banded``."""
    s = float(op.blocks.abs().max().float()) / 127.0 if op.blocks.numel() \
        else 0.0
    if s == 0.0:
        s = 1.0
    s32 = torch.tensor(s, dtype=torch.float32, device=op.blocks.device)
    q = torch.empty(op.blocks.shape, dtype=torch.int8,
                    device=op.blocks.device)
    for lo in range(0, op.blocks.shape[0], 4096):  # bounds the f32 copy
        chunk = op.blocks[lo:lo + 4096].to(torch.float32)
        q[lo:lo + 4096] = torch.clamp(torch.round(chunk / s32), -127, 127)
    fields = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)}
    fields.update(blocks=q, block_scale=s,
                  act_scale=float(sample_x) * headroom / 127.0,
                  headroom=headroom)
    return QuantBlockSparseLaplacian(**fields)


@dataclasses.dataclass(frozen=True)
class QuantDenseLaplacian(QuantOpMixin):
    """Int8 dense Laplacian for serving, the JAX package's dense twin
    (:575): the zero-padded matrix in int8 with one global scale
    ``mat_scale = max|L| / 127`` and the emission of the banded and BSR
    twins.  JAX multiplies with ``jnp.dot`` outside any Pallas kernel, so
    the product here is a plain torch matmul, on the device the tensors
    are on."""

    mat: torch.Tensor  # [Mp, Mp] int8
    m: int
    m_padded: int
    nnz: int
    mat_scale: float
    act_scale: float
    headroom: float = 2.0

    def _acc(self, x_q: torch.Tensor) -> torch.Tensor:
        """The exact accumulator ``L_q @ x_q`` in int32, as JAX's int32
        ``jnp.dot``, by ``torch._int_mm``: no sum can overflow while
        ``127 * 127 * Mp < 2^31``.  Its CUDA form takes column counts
        that are multiples of 8 and more than 16 rows, and runs cuBLASLt's
        int8 tensor-core kernels only on a column-major second operand
        (about 5x faster than a row-major one on the H100, PR 6's peak
        probe): x is copied once into a zero-padded column-major buffer.
        An operator outside those limits takes ``_acc_f64``."""
        mp, c = self.mat.shape[0], x_q.shape[1]
        if mp <= 16 or 127 * 127 * mp >= 2**31:
            return self._acc_f64(x_q)
        xt = x_q.new_zeros((c + -c % 8, mp))
        xt[:c] = x_q.t()
        return torch._int_mm(self.mat, xt.t())[:, :c]

    def _acc_f64(self, x_q: torch.Tensor) -> torch.Tensor:
        """The same accumulator in float64, exact too (every partial sum
        is an integer far below 2^53), on an f64 copy of L made per
        product: the plain version ``_acc`` is held to."""
        return torch.matmul(self.mat.to(torch.float64),
                            x_q.to(torch.float64))

    def _call(self, x_q, x0_q):
        return _emit(self._acc(x_q), x0_q, None, self.mat_scale, torch.int8)

    def to(self, device) -> QuantDenseLaplacian:
        return dataclasses.replace(self, mat=self.mat.to(device))


def quantize_dense(op: DenseLaplacian, headroom: float = 2.0,
                   sample_x: float = 1.0) -> QuantDenseLaplacian:
    """Quantize a DenseLaplacian for int8 inference (JAX :617): ``clip(
    round(mat / s), +-127)`` in float32 with ``s = max|mat| / 127`` (1.0
    for a zero matrix), on the matrix's device, byte-equal to the JAX
    package's NumPy quantizer.  ``sample_x`` and ``headroom`` as in
    ``quantize_banded``."""
    mat = op.mat.to(torch.float32)
    s = float(mat.abs().max()) / 127.0 if mat.numel() else 0.0
    if s == 0.0:
        s = 1.0
    s32 = torch.tensor(s, dtype=torch.float32, device=mat.device)
    q = torch.clamp(torch.round(mat / s32), -127, 127).to(torch.int8)
    return QuantDenseLaplacian(
        mat=q, m=op.m, m_padded=op.m_padded, nnz=op.nnz, mat_scale=s,
        act_scale=float(sample_x) * headroom / 127.0, headroom=headroom)


@dataclasses.dataclass(frozen=True)
class BCOOLaplacian:
    """Rescaled Laplacian as a coalesced torch sparse COO matrix ``[Mp,
    Mp]``, ``Mp = round_up(m, 8)``: the JAX package's BCOO fallback
    (:385, CPU tests and odd shapes).  ``matmul`` is one
    ``torch.sparse.mm``, differentiable in x; JAX's BCOO product is XLA's
    sparse dot, no Pallas kernel, so a library call is its counterpart.
    It has no int8 twin: ``quantize_model_operators`` passes it through,
    as JAX's does."""

    mat: torch.Tensor
    m: int
    m_padded: int
    nnz: int

    @property
    def compute_dtype(self):
        return self.mat.dtype

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``, in the promoted
        dtype of L and x, returned in x's.  A 16-bit float product is
        taken in f32 and rounded once: cuSPARSE's COO product refuses
        bfloat16."""
        dt = torch.promote_types(self.mat.dtype, x.dtype)
        if dt in (torch.bfloat16, torch.float16):
            dt = torch.float32
        return torch.sparse.mm(self.mat.to(dt), x.to(dt)).to(x.dtype)

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """Chebyshev recurrence hop ``2 (L @ x1) - x0``."""
        return (2.0 * self.matmul(x1) - x0).to(x1.dtype)

    def to(self, device) -> BCOOLaplacian:
        return dataclasses.replace(self, mat=self.mat.to(device))


def _is_leaf(v) -> bool:
    return isinstance(v, torch.Tensor) or (
        isinstance(v, tuple) and len(v) > 0
        and all(isinstance(t, torch.Tensor) for t in v))


def operator_leaves(op) -> dict:
    """The operator's tensor fields by name (a tuple of tensors, as
    ``bands_dkw``, stays a tuple), and the banded operators'
    ``level_rows``: the graph data that a trace takes as inputs, the
    counterpart of the JAX operators' pytree leaves.  Ints, floats, flags
    and ``levels`` stay on the operator, static."""
    names = [f.name for f in dataclasses.fields(op)] + ["level_rows"]
    return {n: getattr(op, n) for n in names
            if _is_leaf(getattr(op, n, None))}


def with_operator_leaves(op, leaves: dict):
    """A copy of ``op`` holding ``leaves`` (``operator_leaves``' fields,
    possibly traced tensors) in place of its own.  The copy skips the
    build-time checks, which read the tables' values."""
    clone = copy.copy(op)
    for name, v in leaves.items():
        object.__setattr__(clone, name,
                           tuple(v) if isinstance(v, (list, tuple)) else v)
    return clone


def _resolve_device(device=None) -> torch.device:
    """The device an operator is built on: ``device`` as given, else the
    CUDA device, as the JAX package puts its operators on the
    accelerator.  Raises where there is none rather than falling back to
    the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's operators live on the card by "
            "default; pass device=\"cpu\" to build one on the CPU")
    return torch.device("cuda")


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array on ``device``, converted to ``dtype`` there (a large
    block array crosses once, in its host dtype)."""
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def _pad_rowptr(rowptr: np.ndarray, n_rb: int) -> np.ndarray:
    """Extend a block-CSR row pointer with empty rows up to ``n_rb``."""
    return np.concatenate(
        [rowptr, np.full(n_rb + 1 - len(rowptr), rowptr[-1], rowptr.dtype)])


def _zero_tail(blocks: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate(
        [blocks, np.zeros((n,) + blocks.shape[1:], blocks.dtype)])


def device_laplacian(L: scipy.sparse.spmatrix, lmax: float = 2.0,
                     fmt: str = "auto", dtype=torch.float32, device=None,
                     rows_per_step: int | None = None,
                     dense_budget: int = 2 << 30,
                     use_pallas: bool | None = None,
                     block_size: int | tuple | str = "auto",
                     chunked_rows: bool = False,
                     col_stream: bool | None = None, ragged: bool = True,
                     rescale: bool = True,
                     dense_threshold: int = DENSE_THRESHOLD):
    """Build a device operator for the rescaled Laplacian ``2 L / lmax - I``
    (``rescale=False``: for ``L`` as given, already rescaled).

    ``fmt`` is ``dense``, ``banded``, ``bsr``, ``bcoo`` (the library
    fallback, never chosen by ``auto``) or ``auto``: dense up to
    ``dense_threshold`` nodes, banded for narrow, reasonably full bands,
    dense again above 1/3 block occupancy within ``dense_budget`` bytes,
    else BSR; with a ``block_size`` other than ``"auto"`` or 128, ``auto``
    goes to BSR straight away (laplacian.py:1240-1277).  These thresholds
    are the JAX package's, tuned on a TPU v5e; they are kept word for word
    for parity and are to be re-tuned on Hopper.  ``rows_per_step`` is the
    banded layout's G (default ``min(8, block rows)``).  ``block_size``
    sets the banded operator's block shape too: ``"auto"`` is 128x128,
    an int square blocks, ``(br, bc)`` any other shape; every layout and
    the kernels K1, K5 and K6 take it.

    ``device`` (default: the CUDA device) is where the operator lives;
    without CUDA, ``device=None`` raises, and CPU use asks for
    ``device="cpu"``.

    ``use_pallas`` keeps the JAX name.  A dense operator built with it
    true takes the fused conv kernels (``use_fused``); a banded operator
    runs its layout's kernel with it and the kernel's plain version
    without; a BSR operator runs the BSR kernels with it and the gather
    and segment-sum route without.  For banded and BSR, ``None`` means
    true wherever CUDA is available, whatever ``device`` is, as JAX's
    default is true on any backend but the CPU: an operator built on the
    host keeps its kernel layouts when ``.to()`` moves it to the card.

    Banded only: ``ragged`` (default true) packs one width level per
    G-row step (``pack_banded_ragged``), false the uniform band
    (``pack_banded``); the deep-K-window layout is added for a ragged
    band with ``use_pallas``, as in JAX.  BSR only: ``block_size``
    is an int (square blocks), ``(rows, cols)`` or ``"auto"``
    (``choose_block_shape``);
    ``col_stream`` (default: ``use_pallas`` and not ``chunked_rows``)
    builds the column-streamed layout with groups of ``min(8, block
    rows)``; otherwise ``chunked_rows`` adds the ``row_max`` tail of the
    chunked-row kernel where a row's blocks stay within 4x the mean, and
    with ``use_pallas`` the block-CSR layout gets its row group and
    ``group_max`` tail (``choose_bsr_row_group``).  The layouts, paddings
    and tails are the JAX package's, byte for byte.
    """
    device = _resolve_device(device)
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    L.eliminate_zeros()
    m = L.shape[0]
    nnz = int(L.nnz)

    stats = None
    if fmt == "auto":
        if m <= dense_threshold:
            fmt = "dense"
        elif block_size == "auto" or (isinstance(block_size, int)
                                      and block_size == packing.BLOCK):
            stats = packing.band_stats(L)
            base, W, n_blocks, _ = stats
            n_rb = len(base)
            fmt = "banded" if W <= 32 and n_rb * W <= 3 * n_blocks else "bsr"
            if fmt == "bsr":
                density = n_blocks / float(n_rb * n_rb)
                mp8 = _round_up(m, 8)
                itemsize = torch.empty(0, dtype=dtype).element_size()
                dense_bytes = mp8 * mp8 * itemsize
                if density >= 1 / 3 and dense_bytes <= dense_budget:
                    fmt = "dense"
        else:
            fmt = "bsr"

    if fmt == "dense":
        mp = _round_up(m, 8)
        dense = np.zeros((mp, mp), dtype=np.float32)
        dense[:m, :m] = L.toarray()
        return DenseLaplacian(
            mat=torch.from_numpy(dense).to(device=device, dtype=dtype),
            m=m, m_padded=mp, nnz=nnz, use_fused=bool(use_pallas),
        )

    if fmt == "banded":
        block_shape = ((packing.BLOCK, packing.BLOCK) if block_size == "auto"
                       else (block_size, block_size)
                       if isinstance(block_size, int) else tuple(block_size))
        return _banded_laplacian(L, m, nnz, dtype, device, use_pallas,
                                 rows_per_step, ragged, stats, block_shape)

    if fmt == "bsr":
        return _bsr_laplacian(L, m, nnz, dtype, device, use_pallas,
                              block_size, chunked_rows, col_stream)
    if fmt == "bcoo":
        mp = _round_up(m, 8)
        coo = L.tocoo()
        idx = torch.from_numpy(np.stack([coo.row, coo.col]).astype(np.int64))
        mat = torch.sparse_coo_tensor(
            idx, torch.from_numpy(coo.data.astype(np.float32)), (mp, mp),
            check_invariants=True).coalesce()
        return BCOOLaplacian(mat=mat.to(device=device, dtype=dtype), m=m,
                             m_padded=mp, nnz=nnz)
    raise ValueError(f"unknown Laplacian format {fmt!r}")


def _banded_laplacian(L, m, nnz, dtype, device, use_pallas, rows_per_step,
                      ragged, stats, block_shape) -> BandedLaplacian:
    """The ``fmt="banded"`` branch of ``device_laplacian`` (JAX
    :1292-1339)."""
    if use_pallas is None:
        use_pallas = torch.cuda.is_available()
    sched, levels = None, ()
    if ragged:
        band, base, sched, levels, G, mp = packing.pack_banded_ragged(
            L, G=rows_per_step, stats=stats, block_shape=block_shape)
    else:
        band, base, G, mp = packing.pack_banded(
            L, rows_per_step=rows_per_step, stats=stats,
            block_shape=block_shape)
    bands_dkw = sched_dkw = None
    if use_pallas and levels:
        bd, sd = packing.pack_dkw_from_ragged(band, sched, levels, G,
                                              block_shape)
        bands_dkw = tuple(_tensor(b, device, dtype) for b in bd)
        sched_dkw = _tensor(sd, device)
    nz_rowptr, nz_win = packing.band_row_index(L, base, mp, block_shape)
    return BandedLaplacian(
        band=_tensor(band, device, dtype), base=_tensor(base, device), m=m,
        m_padded=mp, nnz=nnz, rows_per_step=G, use_pallas=bool(use_pallas),
        sched=None if sched is None else _tensor(sched, device),
        levels=levels, bands_dkw=bands_dkw, sched_dkw=sched_dkw,
        nz_rowptr=_tensor(nz_rowptr, device), nz_win=_tensor(nz_win, device),
        block_shape=block_shape)


def _bsr_laplacian(L, m, nnz, dtype, device, use_pallas, block_size,
                   chunked_rows, col_stream) -> BlockSparseLaplacian:
    """The ``fmt="bsr"`` branch of ``device_laplacian`` (JAX :1341-1461)."""
    if use_pallas is None:
        # The platform decides, as in JAX: an operator built on the host
        # keeps its kernel layouts when .to() moves it to the card.
        use_pallas = torch.cuda.is_available()
    if block_size == "auto":
        block_shape = packing.choose_block_shape(L)
    elif isinstance(block_size, int):
        block_shape = (block_size, block_size)
    else:
        block_shape = tuple(block_size)
    br, bc = block_shape
    blocks, brows, bcols, rowptr, mp = packing.pack_block_sparse(
        L, block_shape)
    counts = np.diff(rowptr)
    row_max = int(counts.max()) if len(counts) else 0
    mean_cnt = float(counts.mean()) if len(counts) else 0.0
    if col_stream is None:
        col_stream = bool(use_pallas) and not chunked_rows
    common = dict(m=m, nnz=nnz, block_shape=block_shape,
                  use_pallas=use_pallas)

    csr_rows, csr_cols = brows, bcols  # block-CSR order, before any reorder

    def index(mp, order=None):
        return dict(zip(ROW_INDEX_FIELDS, (
            _tensor(a, device) for a in packing.row_index(
                L, csr_rows, csr_cols, block_shape, mp, order))))

    if col_stream and use_pallas and len(counts):
        G = min(packing.ROWS_PER_STEP, max(len(counts), 1))
        mp = _round_up(mp, int(np.lcm(G * br, bc)))
        rowptr = _pad_rowptr(rowptr, mp // br)
        (blocks, brows, bcols, meta, gcols, gcolptr,
         groupptr) = packing.colstream_pack(blocks, brows, bcols, rowptr, G)
        blocks = _zero_tail(blocks, packing.COLSTREAM_CHUNK)
        meta = np.concatenate(
            [meta, np.zeros(packing.COLSTREAM_CHUNK, meta.dtype)])
        order = packing.colstream_order(csr_rows, csr_cols, rowptr, groupptr,
                                        G)
        return BlockSparseLaplacian(
            blocks=_tensor(blocks, device, dtype),
            block_rows=_tensor(brows, device),
            block_cols=_tensor(bcols, device),
            block_rowptr=_tensor(rowptr, device), m_padded=mp,
            rows_per_step=G, col_stream=True,
            cs_meta=_tensor(meta, device), cs_gcols=_tensor(gcols, device),
            cs_gcolptr=_tensor(gcolptr, device),
            cs_groupptr=_tensor(groupptr, device), **index(mp, order),
            **common)

    if chunked_rows and row_max > 0 and row_max <= max(4.0 * mean_cnt, 8.0):
        blocks = _zero_tail(blocks, row_max)
    else:
        row_max = 0
    G, Lg = 1, 0
    if row_max == 0 and use_pallas:
        itemsize = torch.empty(0, dtype=dtype).element_size()
        G, Lg = packing.choose_bsr_row_group(rowptr, br, bc, itemsize)
        if G == 1 and len(counts):
            # The slab tail even at G = 1, so that the int8 twin's grouped
            # kernel can always run.
            Lg = int(counts.max())
    if Lg > 0:
        mp = _round_up(mp, int(np.lcm(G * br, bc)))
        rowptr = _pad_rowptr(rowptr, mp // br)
        blocks = _zero_tail(blocks, Lg)
    return BlockSparseLaplacian(
        blocks=_tensor(blocks, device, dtype),
        block_rows=_tensor(brows, device), block_cols=_tensor(bcols, device),
        block_rowptr=_tensor(rowptr, device), m_padded=mp, row_max=row_max,
        rows_per_step=G, group_max=Lg, **index(mp), **common)
