"""Block-sparse (BSR) SpMM and fused Chebyshev hop.

Counterpart of ``cnn_graph_tpu/ops/pallas_spmm.py``.  One CUDA kernel,
``csrc/bsr.cu``, computes what its four Pallas kernels compute: a
row-sparse gather SpMM that walks the operator's nonzero index by output
row (``nz_rowptr``, ``nz_cols``, ``nz_pos``; ``ops.packing.row_index``)
and reads each value from the operator's ``blocks`` through it.  Two
wrappers launch it, under the names of the TPU kernels they stand for:

* ``bsr_colstream``: K4, ``_kernel_colstream`` :129 via
  ``_colstream_call`` :269, on the column-streamed layout.
* ``bsr_csr``: K7 (``_kernel_grouped`` :35), K8 (``_kernel`` :450) and K9
  (``_kernel_chunked`` :502) over block-CSR; ``route`` names which of the
  three a call stands for, for the launch counts.

Beside the kernel, its plain PyTorch version ``bsr_rows_reference`` (the
same row walk).  Both wrappers check their arguments' shapes and call the
custom op ``cnn_graph_torch::bsr_rows`` (``ops/library.py``), whose CUDA
implementation launches the kernel and whose CPU implementation is the
plain version; the device of ``x`` is the only thing that chooses.  The
plain versions of the block walks the TPU kernels do,
``bsr_colstream_reference`` and ``bsr_csr_reference``, stay as what the
CPU tests hold against the Pallas kernels in interpret mode, and as a
second check of the kernel on the card.  ``launches`` counts kernel
launches, ``form_launches`` the same by form (``spmm``, ``hop``) and, on
``bsr_csr``, ``route_launches`` by route (``K7``, ``K8``, ``K9``): views
of the recorder's counters (``utils/profiling.py Counted``), to which the
CUDA implementation adds where it launches, inside the span
``bsr_colstream.<form>`` or ``bsr_csr.<route>.<form>``.

The operator-level wrappers route as the JAX package does: ``bsr_spmm``
(:580, backward ``dx = L g``) takes K4 for a column-streamed layout, K7
with ``rows_per_step > 1``, else K9 with ``row_max > 0``, else K8;
``bsr_cheby_hop`` (:411, backward ``dx1 = 2 L g``, ``dx0 = -g``) and the
int8 ``bsr_call_quant`` (:436, inference only) take K4 or K7.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from cnn_graph_tpu_torch import _build
from cnn_graph_tpu_torch.ops.band import _CHUNK_BYTES, _emit, full_f32_matmul
from cnn_graph_tpu_torch.ops.packing import BLOCK
from cnn_graph_tpu_torch.utils import profiling

__all__ = [
    "bsr_colstream",
    "bsr_colstream_reference",
    "bsr_csr",
    "bsr_csr_reference",
    "bsr_rows_reference",
    "block_products",
    "kernel_call",
    "bsr_spmm",
    "bsr_cheby_hop",
    "bsr_call_quant",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ROUTES = ("K7", "K8", "K9")  # bsr_csr's; bsr_colstream's is K4


def block_products(blocks, brow, bcol, x, n_rb: int, block_shape,
                   compute_dtype, acc_dtype) -> torch.Tensor:
    """``acc[brow[b]] += blocks[b] @ x_tile[bcol[b]]`` over the blocks
    listed, as ``[n_rb, br, C]`` in ``acc_dtype``.  Each block's product
    is taken in ``compute_dtype`` (f32 products in full f32) and cast to
    ``acc_dtype`` before it is added.  A 16-bit ``acc_dtype`` adds a
    row's blocks one at a time in their order, each sum rounded, as
    XLA's ``segment_sum`` does in that dtype (``index_add_`` alone sums
    a row's repeated indices otherwise)."""
    br, bc = block_shape
    mp, C = x.shape
    xb = x.reshape(mp // bc, bc, C)
    acc = torch.zeros(n_rb, br, C, dtype=acc_dtype, device=x.device)
    size = torch.empty(0, dtype=compute_dtype).element_size()
    step = max(1, _CHUNK_BYTES // (bc * max(C, 1) * size))
    narrow = acc_dtype in (torch.bfloat16, torch.float16)
    with full_f32_matmul():
        for lo in range(0, brow.numel(), step):
            hi = lo + step
            prod = torch.bmm(blocks[lo:hi].to(compute_dtype),
                             xb.index_select(0, bcol[lo:hi]).to(compute_dtype))
            rows = brow[lo:hi]
            if not narrow:
                acc.index_add_(0, rows, prod.to(acc_dtype))
                continue
            # Each block's place among its row's blocks: one pass per
            # place, so every pass adds to a row at most once.
            order = torch.argsort(rows, stable=True)
            srt = rows[order]
            place = torch.empty_like(order)
            place[order] = (torch.arange(srt.numel(), device=x.device)
                            - torch.searchsorted(srt, srt))
            for j in range(int(place.max()) + 1 if place.numel() else 0):
                sel = place == j
                acc.index_add_(0, rows[sel], prod[sel].to(acc_dtype))
    return acc


def _acc_dtype(block_scale):
    # Int8 accumulates in float64, exact here (|acc| <= 127^2 * 128 *
    # blocks per row << 2^53) on every device, unlike f32 (inexact above
    # 2^24) or an int8 product (wraps).
    return torch.float64 if block_scale is not None else torch.float32


def bsr_colstream_reference(blocks, meta, gcols, gcolptr, groupptr, x,
                            x0=None, *, G, block_shape=(BLOCK, BLOCK),
                            block_scale=None) -> torch.Tensor:
    """The block walk of K4 (``_kernel_colstream``) in plain PyTorch,
    written from the TPU kernel: every block of group s's run
    ``groupptr[s]:groupptr[s+1]`` (pads included) adds ``blocks[b] @
    x[tile gcols[gcolptr[s] + (meta[b] & 0xFFFF)]]`` to block-row ``s*G +
    (meta[b] >> 16)``; f32 accumulation over a row's blocks (exact for
    int8), then the emission, rounded once."""
    nsb = groupptr.numel() - 1
    dev = x.device
    groupptr = groupptr.to(torch.int64)
    nb = int(groupptr[-1])
    grp = torch.repeat_interleave(torch.arange(nsb, device=dev),
                                  groupptr.diff())
    meta = meta[:nb].to(torch.int64)
    brow = grp * G + (meta >> 16)
    bcol = gcols.to(torch.int64)[gcolptr.to(torch.int64)[grp]
                                 + (meta & 0xFFFF)]
    acc_dt = _acc_dtype(block_scale)
    acc = block_products(blocks[:nb], brow, bcol, x, nsb * G, block_shape,
                         acc_dt, acc_dt)
    return _emit(acc.reshape(x.shape), x0, None, block_scale, x.dtype)


def bsr_csr_reference(blocks, rowptr, cols, x, x0=None, *,
                      block_shape=(BLOCK, BLOCK),
                      block_scale=None) -> torch.Tensor:
    """The block walk of K7/K8/K9 in plain PyTorch: block-row i sums
    ``blocks[b] @ x[tile cols[b]]`` over ``rowptr[i]:rowptr[i+1]`` in f32
    (exact for int8), then the emission, rounded once.  Never reads past
    ``rowptr[-1]``."""
    n_rb = rowptr.numel() - 1
    rowptr = rowptr.to(torch.int64)
    nb = int(rowptr[-1])
    brow = torch.repeat_interleave(torch.arange(n_rb, device=x.device),
                                   rowptr.diff())
    acc_dt = _acc_dtype(block_scale)
    acc = block_products(blocks[:nb], brow, cols[:nb].to(torch.int64), x,
                         n_rb, block_shape, acc_dt, acc_dt)
    return _emit(acc.reshape(x.shape), x0, None, block_scale, x.dtype)


# ------------------------------------------------------------------ kernels


def bsr_rows_reference(blocks, nz_rowptr, nz_cols, nz_pos, x, x0=None, *,
                       block_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the row kernel: output row i sums
    ``blocks.view(-1)[nz_pos[e]] * x[nz_cols[e]]`` over its nonzeros
    ``nz_rowptr[i]:nz_rowptr[i+1]`` in f32 (float64 for int8, exact),
    then the emission, rounded once.  Rows without nonzeros (the pad
    rows) give 0, or ``-x0`` for the hop.  The output has the index's
    ``len(nz_rowptr) - 1`` rows; x may have more (a rectangular
    operator's columns)."""
    mp, C = nz_rowptr.numel() - 1, x.shape[1]
    dev = x.device
    rowptr = nz_rowptr.to(torch.int64)
    nnz = int(rowptr[-1])
    rows = torch.repeat_interleave(torch.arange(mp, device=dev),
                                   rowptr.diff())
    cols = nz_cols[:nnz].to(torch.int64)
    acc_dt = _acc_dtype(block_scale)
    vals = blocks.reshape(-1)[nz_pos[:nnz]].to(acc_dt)
    acc = torch.zeros(mp, C, dtype=acc_dt, device=dev)
    step = max(1, _CHUNK_BYTES // (max(C, 1) * 8))
    for lo in range(0, nnz, step):
        hi = lo + step
        acc.index_add_(0, rows[lo:hi], vals[lo:hi, None]
                       * x.index_select(0, cols[lo:hi]).to(acc_dt))
    return _emit(acc, x0, None, block_scale, x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bsr")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsr_rows_launch.argtypes = [p, p, p, p, i, p, p, p, i,
                                    ctypes.c_float, i, p]
    lib.bsr_rows_launch.restype = ctypes.c_int
    return lib


def _check_no_grad(name, *ts):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} has no backward: differentiate through bsr_spmm / "
            "bsr_cheby_hop, or run under torch.no_grad()")


def _check_rows(name, blocks, nz_rowptr, nz_cols, nz_pos, x, x0,
                block_scale):
    """What the kernel takes, from metadata alone (so also while
    ``torch.export`` traces): dtypes, the row index's shape and types,
    one device, contiguity.  The alignment is ``_launch``'s."""
    dev = x.device
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if (x.dtype == torch.int8) != (block_scale is not None):
        raise ValueError(f"{name}: block_scale is required for int8 and "
                         "only for int8")
    if blocks.dtype != x.dtype:
        raise TypeError(f"{name}: blocks {blocks.dtype} vs x {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: x must be [Mp, C] with Mp, C >= 1, got "
                         f"{tuple(x.shape)}")
    rows = nz_rowptr.numel() - 1
    if x0 is not None and (x0.dtype != x.dtype
                           or tuple(x0.shape) != (rows, x.shape[1])):
        raise ValueError(f"{name}: x0 must be [{rows}, C] in x's dtype")
    if (nz_rowptr.dtype != torch.int32 or nz_cols.dtype != torch.int32
            or nz_pos.dtype != torch.int64):
        raise TypeError(f"{name}: the row index is int32 nz_rowptr and "
                        "nz_cols and int64 nz_pos")
    if (nz_rowptr.dim() != 1 or rows < 1 or nz_cols.shape != nz_pos.shape
            or nz_cols.dim() != 1):
        raise ValueError(f"{name}: nz_rowptr must hold the output rows + 1 "
                         "and nz_cols/nz_pos one entry per nonzero")
    if x.shape[0] < rows:
        # A square operator's columns are its rows; a rectangular shard
        # has more columns than rows.
        raise ValueError(f"{name}: x has {x.shape[0]} rows, fewer than the "
                         f"operator's {rows} output rows")
    for t in (blocks, nz_rowptr, nz_cols, nz_pos, x) + (
            () if x0 is None else (x0,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on "
                             f"{dev}")


def _launch(blocks, nz_rowptr, nz_cols, nz_pos, x, x0, route, block_scale):
    """One launch of the row kernel as ``route`` (K4: ``bsr_colstream``,
    else ``bsr_csr``), counted on its wrapper: the CUDA implementation of
    ``cnn_graph_torch::bsr_rows`` (``ops/library.py``), reached through
    the wrappers' checks."""
    name = "bsr_colstream" if route == "K4" else "bsr_csr"
    # The kernel loads x and x0 in 16-byte vectors.
    for t in (x,) + (() if x0 is None else (x0,)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: x and x0 must start on a 16-byte "
                             "boundary (a view with a storage offset may "
                             "not)")
    form = "spmm" if x0 is None else "hop"
    span = (f"bsr_colstream.{form}" if route == "K4"
            else f"bsr_csr.{route}.{form}")
    mp, C = nz_rowptr.numel() - 1, x.shape[1]
    y = x.new_empty((mp, C))
    with torch.cuda.device(x.device), profiling.span(span):
        rc = _lib().bsr_rows_launch(
            blocks.data_ptr(), nz_rowptr.data_ptr(), nz_cols.data_ptr(),
            nz_pos.data_ptr(), mp, x.data_ptr(),
            None if x0 is None else x0.data_ptr(), y.data_ptr(), C,
            0.0 if block_scale is None else float(block_scale),
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if route == "K4":
        bsr_colstream.launched(form)
    else:
        bsr_csr.launched(form, route)
    return y


def _call(name, blocks, nz_rowptr, nz_cols, nz_pos, x, x0, block_scale,
          route):
    """Check, then one call of the custom op: the kernel for a CUDA
    ``x``, the plain version for a CPU one; any other device raises."""
    _check_no_grad(name, x, x0)
    if x.device.type == "cuda":
        _check_rows(name, blocks, nz_rowptr, nz_cols, nz_pos, x, x0,
                    block_scale)
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return torch.ops.cnn_graph_torch.bsr_rows(
        blocks, nz_rowptr, nz_cols, nz_pos, x, x0, route, block_scale)


@profiling.counted("bsr_colstream")
def bsr_colstream(blocks, nz_rowptr, nz_cols, nz_pos, x, x0=None, *,
                  block_scale=None):
    """K4: ``L @ x`` (``x0`` None) or the hop ``2 (L @ x) - x0`` of a
    column-streamed operator, by the row kernel over its nonzero index
    (``nz_rowptr`` int32 ``[Mp + 1]``, ``nz_cols`` int32 and ``nz_pos``
    int64, into ``blocks`` of any layout and block shape); ``x``
    ``[Mc, C]`` (``Mc`` = ``Mp`` for a square operator, the column count
    for a rectangular one) and ``x0`` ``[Mp, C]`` in the blocks' dtype.
    ``block_scale`` (int8 only) is the blocks' dequant scale; the result
    is then requantized int8 in x's scale.  Returns ``[Mp, C]`` in x's
    dtype, ``Mp = len(nz_rowptr) - 1``."""
    return _call("bsr_colstream", blocks, nz_rowptr, nz_cols, nz_pos, x, x0,
                 block_scale, "K4")


@profiling.counted("bsr_csr")
def bsr_csr(blocks, nz_rowptr, nz_cols, nz_pos, x, x0=None, *,
            block_scale=None, route="K8"):
    """K7, K8 or K9 (``route``, for the counts): the same product as
    ``bsr_colstream``, by the same row kernel, on a block-CSR operator's
    nonzero index."""
    if route not in _ROUTES:
        raise ValueError(f"bsr_csr: route {route!r} not in {_ROUTES}")
    return _call("bsr_csr", blocks, nz_rowptr, nz_cols, nz_pos, x, x0,
                 block_scale, route)


# ------------------------------------------------------- operator wrappers


def kernel_call(L, x, x0, route, block_scale=None):
    """One kernel launch on a (Quant)BlockSparseLaplacian's row index:
    ``bsr_colstream`` for ``route == "K4"``, else ``bsr_csr`` as that
    route.  The operators' ``kernel_call`` method lands here; every
    product of the operator-level wrappers below goes through that
    method."""
    if L.nz_rowptr is None:
        raise ValueError("this BSR operator has no row index (nz_rowptr): "
                         "build it with device_laplacian(fmt='bsr')")
    index = (L.blocks, L.nz_rowptr, L.nz_cols, L.nz_pos)
    if route == "K4":
        return bsr_colstream(*index, x, x0, block_scale=block_scale)
    return bsr_csr(*index, x, x0, block_scale=block_scale, route=route)


def _grouped_route(L) -> str:
    # The hop and int8 kernels of JAX are K4 and K7 only; K7 reads the
    # layout's group_max slab (_grouped_call asserts it).
    if L.col_stream:
        return "K4"
    if L.group_max <= 0:
        raise ValueError("the hop and int8 BSR kernels need the grouped "
                         "layout (group_max > 0): build the operator with "
                         "use_pallas and without chunked_rows")
    return "K7"


def _spmm_route(L) -> str:
    if L.col_stream:
        return "K4"
    if L.rows_per_step > 1:
        return "K7"
    return "K9" if L.row_max > 0 else "K8"


def _float_call(L, x, x0=None):
    # The kernel boundary casts x and x0 to the blocks' dtype; the result
    # comes back in x's dtype.
    cdt = L.compute_dtype
    route = _spmm_route(L) if x0 is None else _grouped_route(L)
    y = L.kernel_call(x.to(cdt).contiguous(),
                      None if x0 is None else x0.to(cdt).contiguous(), route)
    return y.to(x.dtype)


class _BsrSpmm(torch.autograd.Function):
    """``L @ x``; L is symmetric, so ``dx = L g`` (pallas_spmm :594-601).
    The operator is a non-tensor argument with no gradient."""

    @staticmethod
    def forward(ctx, L, x):
        ctx.L = L
        return _float_call(L, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dx = _float_call(ctx.L, g) if ctx.needs_input_grad[1] else None
        return None, dx


class _BsrChebyHop(torch.autograd.Function):
    """``2 (L @ x1) - x0``; ``dx1 = 2 (L g)``, ``dx0 = -g`` (:422-430)."""

    @staticmethod
    def forward(ctx, L, x1, x0):
        ctx.L, ctx.x0_dtype = L, x0.dtype
        return _float_call(L, x1, x0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        _, need_x1, need_x0 = ctx.needs_input_grad
        dx1 = 2.0 * _float_call(ctx.L, g) if need_x1 else None
        dx0 = (-g).to(ctx.x0_dtype) if need_x0 else None
        return None, dx1, dx0


def bsr_spmm(L, x: torch.Tensor) -> torch.Tensor:
    """``L @ x`` for a BlockSparseLaplacian; ``x``: ``[Mp, C]``.
    Differentiable in ``x``."""
    return _BsrSpmm.apply(L, x)


def bsr_cheby_hop(L, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Fused Chebyshev hop ``2 (L @ x1) - x0`` in one kernel pass, through
    K4 or K7.  Differentiable in ``x1`` and ``x0``."""
    return _BsrChebyHop.apply(L, x1, x0)


def bsr_call_quant(L, x_q: torch.Tensor,
                   x0_q: torch.Tensor | None = None) -> torch.Tensor:
    """Int8 SpMM or fused hop for a QuantBlockSparseLaplacian through K4
    or K7: int8 blocks times int8 activations, int32 accumulation,
    requantized in input-scale units.  Inference only."""
    return L.kernel_call(x_q, x0_q, _grouped_route(L), L.block_scale)
