"""Banded SpMM and fused Chebyshev hop in the banded operator's three
layouts.

Counterpart of ``cnn_graph_tpu/ops/pallas_band.py``.  One CUDA source,
``csrc/band.cu``, serves the three TPU kernels; each keeps its own
wrapper, plain PyTorch version and launch counts:

* ``banded_dkw`` (K1, ``banded_call_dkw`` :568): the deep-K-window
  layout, one array ``[n_rows_l, br, W_l*bc]`` per width level;
* ``banded_uniform`` (K5, ``banded_call`` :730): the uniform band
  ``[n_rows, W, br, bc]``, W taps per block-row;
* ``banded_ragged`` (K6, ``banded_call_ragged`` :314): the flat ragged
  band ``[total, br, bc]``, ``W_s`` taps per G-row step.

The block shape ``(br, bc)`` is read from the band's shape
(``block_shape_of``), as the TPU kernels read it (``total, br, bc =
band.shape``): 128x128 by default, any shape the packers take.

All three launch one walk over the band's nonzeros row by row (one warp
per output row, ``csrc/rows.cuh``): they take the operator's row index
``nz_rowptr``/``nz_win`` (``ops.packing.band_row_index``, each nonzero's
offset in its block-row's window) as keywords and read every value from
the layout's own band.  Their plain version as the kernel computes it is
``banded_rows_reference``, the same row walk; tests and chip_smoke.py
hold the kernel against it and against the layout's window product.

Each wrapper checks its arguments' shapes and calls the custom op
``cnn_graph_torch::band_rows`` (``band_rows_`` for the in-place form;
``ops/library.py``), whose CUDA implementation launches the kernel and
whose CPU implementation is the layout's plain window version
(``*_reference``); the device of ``x`` is the only thing that chooses.
So a program that ``torch.export`` traced through a wrapper keeps the
kernel as one node.  ``launches`` counts kernel launches,
``form_launches`` the same launches by form (``spmm``, ``hop``,
``hop_c``): views of the recorder's counters (``utils/profiling.py
Counted``), to which the CUDA implementation adds where it launches,
inside the span ``band_<layout>.<form>``.
``x`` may have more rows than the output (the sharded halo operators'
extended columns): the output has ``br * len(base)`` rows and ``base``
indexes x's block columns.  ``donate_x0``
writes the hop's output over ``x0`` and returns ``x0``: the in-place
form that ``cheby_finals`` uses.  It is inference-only, like the raw
calls themselves.

``band_spmm`` and ``band_cheby_hop`` are ``torch.autograd.Function``s
with the symmetric adjoints of :664-671 and :850-858, each backward one
kernel launch; ``_band_call`` is the JAX one's dispatch by layout with
its boundary casts (:674-711).  ``band_cheby_hop_c`` (:714), the adjoint
chain's hop, has no backward, like the raw calls: they raise when a
gradient would be needed rather than return a result with no gradient
path.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from cnn_graph_tpu_torch import _build
from cnn_graph_tpu_torch.ops.packing import BLOCK, MAX_LEVELS
from cnn_graph_tpu_torch.utils import profiling

__all__ = ["banded_dkw", "banded_dkw_reference", "banded_uniform",
           "banded_uniform_reference", "banded_ragged",
           "banded_ragged_reference", "banded_rows_reference", "layout_call",
           "band_spmm", "band_cheby_hop", "band_cheby_hop_c",
           "block_shape_of", "check_band_index", "check_band_tables",
           "full_f32_matmul"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# csrc/band.cu's layout codes; each launches the row walk band_rows_kernel.
_LAYOUT_CODE = {"dkw": 0, "uniform": 1, "ragged": 2}
# The plain versions here and in ops/bsr.py gather x rows or block tiles
# in chunks of about this many bytes: one gather of every block's tile at
# the 50k scattered graph and C = 512 would take 7.1 GB in bf16.
_CHUNK_BYTES = 1 << 28


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full f32, not TF32, for the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def block_shape_of(layout: str, bands, levels) -> tuple:
    """``(br, bc)`` of the band ``bands`` (as the layout's wrapper takes
    them) in ``layout``, read from its shape."""
    b = bands[0]
    if layout == "uniform":
        return int(b.shape[2]), int(b.shape[3])
    if layout == "dkw":
        return int(b.shape[1]), int(b.shape[2]) // levels[0]
    return int(b.shape[1]), int(b.shape[2])


def _emit(acc: torch.Tensor, x0, c, band_scale, out_dtype) -> torch.Tensor:
    """The kernel's emission epilogue (pallas_band._emit_row) on an exact
    or f32 accumulator, computed in f32: ``(2 acc - x0) + c`` in that
    order, rounded once to the output dtype."""
    if band_scale is not None:
        scale = torch.tensor(band_scale, dtype=torch.float32)
        y = acc.to(torch.float32) * scale
        if x0 is not None:
            y = 2.0 * y - x0.to(torch.float32)
        return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    y = acc.to(torch.float32)
    if x0 is not None:
        y = 2.0 * y - x0.to(torch.float32)
    if c is not None:
        y = y + c.to(torch.float32)
    return y.to(out_dtype)


def _check_c(x0, c, band_scale):
    if c is None:
        return
    if x0 is None:
        raise ValueError("banded kernel: c requires x0 (the hop form)")
    if band_scale is not None:
        raise ValueError("banded kernel: no c form for int8 (inference "
                         "only)")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _check_donate(x, x0, c):
    if x0 is None:
        raise ValueError("donate_x0 needs the hop form (x0)")
    if _overlap(x, x0) or (c is not None and _overlap(c, x0)):
        raise ValueError("donate_x0: x and c must not alias x0, whose "
                         "storage the output overwrites")


def _check_no_grad(*ts):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise RuntimeError(
            "the banded kernel calls have no backward: differentiate "
            "through band_spmm / band_cheby_hop, or run under "
            "torch.no_grad()"
        )


def _windows_reference(x, base, parts, x0, c, band_scale, donate_x0,
                       block_shape):
    """The plain version shared by the three layouts.  ``parts`` yields
    ``(rows, operand, W)``: block-rows ``rows`` multiply their ``[n, br,
    W*bc]`` band operands by their x windows (x rows ``base*bc`` on; rows
    past the end of x read as zero) in one batched product; then the
    emission.  The row lists' lengths are their shapes, never their
    values, so that ``torch.export`` traces this with the operator's
    tables as inputs.

    Float bands accumulate in f32.  Int8 accumulates in float64, which is
    exact here (|acc| <= 127^2 * W*bc << 2^53) on every device, unlike
    int8 ``matmul`` (wraps) or f32 (inexact above 2^24)."""
    _check_c(x0, c, band_scale)
    if donate_x0:
        _check_donate(x, x0, c)
    br, bc = block_shape
    x_rows, C = x.shape
    nbr = base.numel()
    acc_dtype = torch.float64 if band_scale is not None else torch.float32
    acc = torch.zeros(nbr, br, C, dtype=acc_dtype, device=x.device)
    xa = x.to(acc_dtype)
    with full_f32_matmul():
        for rows, operand, w in parts:
            if rows.numel() == 0:
                continue
            idx = (base[rows].to(torch.int64)[:, None] * bc
                   + torch.arange(w * bc, device=x.device)[None, :])
            inside = (idx < x_rows).to(acc_dtype)[..., None]
            win = xa[idx.clamp(max=x_rows - 1)] * inside  # [n, w*bc, C]
            acc[rows] = torch.bmm(operand.to(acc_dtype), win)
    y = _emit(acc.reshape(nbr * br, C), x0, c, band_scale, x.dtype)
    if donate_x0:
        return x0.copy_(y)
    return y


def _step_rows(sched, nbr, G, device):
    """Each block-row's step and, from ``sched``, its level index and
    offset."""
    rows = torch.arange(nbr, device=device)
    step = rows // G
    sched = sched.to(torch.int64)
    return rows, sched[1][step], sched[0][step]


def level_rows_of(sched, nbr: int, G: int, n_levels: int) -> tuple:
    """The block rows of each width level, one int64 tensor per level on
    ``sched``'s device, read from ``sched`` on the host.  The operators
    build them once, beside their tables, so that the plain versions
    never size a tensor by the tables' values."""
    lvl = sched[1].cpu().to(torch.int64)[torch.arange(nbr) // G]
    return tuple(torch.nonzero(lvl == li).flatten().to(sched.device)
                 for li in range(n_levels))


def _level_rows(level_rows, sched, nbr, G, n_levels):
    return (level_rows if level_rows is not None
            else level_rows_of(sched, nbr, G, n_levels))


def _taps(blocks: torch.Tensor) -> torch.Tensor:
    """``[n, W, br, bc]`` taps side by side: ``[n, br, W*bc]``."""
    n, w, br, bc = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(n, br, w * bc)


def banded_dkw_reference(bands, base, sched, x, x0=None, c=None, *, levels,
                         G, band_scale=None, donate_x0=False,
                         level_rows=None) -> torch.Tensor:
    """Plain PyTorch version of ``banded_dkw``: per width level, gather
    each block-row's x window, one batched product, scatter to the output
    rows, then the emission (``_windows_reference``).  ``level_rows``:
    each level's block rows (``level_rows_of``), found from ``sched``
    when None."""
    rows, lvl, off = _step_rows(sched, base.numel(), G, x.device)
    local = off + rows % G
    parts = []
    for li, (w, sel) in enumerate(zip(levels, _level_rows(
            level_rows, sched, base.numel(), G, len(levels)))):
        parts.append((sel, bands[li][local[sel]], w))
    return _windows_reference(x, base, parts, x0, c, band_scale, donate_x0,
                              block_shape_of("dkw", bands, levels))


def banded_uniform_reference(band, base, x, x0=None, c=None, *,
                             band_scale=None,
                             donate_x0=False) -> torch.Tensor:
    """Plain PyTorch version of ``banded_uniform``: every block-row's W
    taps as one ``[br, W*bc]`` operand against its window."""
    rows = torch.arange(base.numel(), device=x.device)
    return _windows_reference(x, base, [(rows, _taps(band), band.shape[1])],
                              x0, c, band_scale, donate_x0,
                              block_shape_of("uniform", (band,), ()))


def banded_ragged_reference(band, base, sched, x, x0=None, c=None, *,
                            levels, G, band_scale=None, donate_x0=False,
                            level_rows=None) -> torch.Tensor:
    """Plain PyTorch version of ``banded_ragged``: per width level, each
    block-row's ``W_s`` blocks from the flat band as one operand.
    ``level_rows`` as for ``banded_dkw_reference``."""
    rows, lvl, off = _step_rows(sched, base.numel(), G, x.device)
    parts = []
    for w, sel in zip(levels, _level_rows(level_rows, sched, base.numel(),
                                          G, len(levels))):
        first = off[sel] + (sel % G) * w
        idx = first[:, None] + torch.arange(w, device=x.device)[None, :]
        parts.append((sel, _taps(band[idx]), w))
    return _windows_reference(x, base, parts, x0, c, band_scale, donate_x0,
                              block_shape_of("ragged", (band,), levels))


def banded_rows_reference(bands, base, sched, nz_rowptr, nz_win, x, x0=None,
                          c=None, *, layout, levels, G,
                          band_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the row walk that K1, K5 and K6 launch:
    output row ``r*br + i`` sums ``v * x[base[r]*bc + k]`` over its
    nonzeros ``nz_rowptr[row]:nz_rowptr[row+1]``, where ``k =
    nz_win[e]`` and ``v`` is element ``(i, k)`` of block-row r's band
    operand in ``layout`` (``dkw``, ``uniform`` or ``ragged``; ``bands``,
    ``sched``, ``levels`` and ``G`` as the layout's wrapper takes them,
    ``bands`` ``(band,)`` for the tap layouts, ``sched`` None and
    ``levels`` ``(W,)`` for the uniform band).  x rows at or past
    ``x.shape[0]`` add nothing.  f32 accumulation (float64 for int8,
    exact), then the emission, rounded once; rows without nonzeros give
    0, ``-x0`` or ``-x0 + c``."""
    if layout not in _LAYOUT_CODE:
        raise ValueError(f"banded_rows_reference: unknown layout {layout!r}")
    _check_c(x0, c, band_scale)
    br, bc = block_shape_of(layout, bands, levels)
    x_rows, C = x.shape
    dev = x.device
    nbr = base.numel()
    nnz = int(nz_rowptr[-1])
    row = torch.repeat_interleave(torch.arange(nbr * br, device=dev),
                                  nz_rowptr.to(torch.int64).diff())
    r, i = row // br, row % br
    k = nz_win[:nnz].to(torch.int64)
    if layout == "uniform":
        (band,) = bands
        w = band.shape[1]
        flat = [((r * w + k // bc) * br + i) * bc + k % bc]
        sources, lvl = (band,), torch.zeros_like(k)
    else:
        _, lvl_r, off_r = _step_rows(sched, nbr, G, dev)
        lvl, off = lvl_r[r], off_r[r]
        if layout == "dkw":
            flat = [((off + r % G) * br + i) * (w * bc) + k
                    for w in levels]
            sources = bands
        else:
            # One flat band: block sched[0, s] + g*W_s + k // bc of it.
            flat = [((off + (r % G) * w + k // bc) * br + i) * bc
                    + k % bc for w in levels]
            sources = bands * len(levels)
    acc_dt = torch.float64 if band_scale is not None else torch.float32
    vals = torch.zeros(nnz, dtype=acc_dt, device=dev)
    for li, (src, fl) in enumerate(zip(sources, flat)):
        sel = lvl == li
        vals[sel] = src.reshape(-1)[fl[sel]].to(acc_dt)
    xrow = base.to(torch.int64)[r] * bc + k
    inside = xrow < x_rows
    vals = vals * inside
    xrow = xrow.clamp(max=x_rows - 1)
    acc = torch.zeros(nbr * br, C, dtype=acc_dt, device=dev)
    step = max(1, _CHUNK_BYTES // (max(C, 1) * 8))
    for lo in range(0, nnz, step):
        hi = lo + step
        acc.index_add_(0, row[lo:hi], vals[lo:hi, None]
                       * x.index_select(0, xrow[lo:hi]).to(acc_dt))
    return _emit(acc, x0, c, band_scale, x.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("band").band_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([i] + [p] * MAX_LEVELS + [i] * MAX_LEVELS
                   + [p, p, p, p, i, i, i, i, i, p, i, p, p, p, i,
                      ctypes.c_float, i, p])
    fn.restype = ctypes.c_int
    return fn


def check_band_tables(bands, base, sched, levels, G, layout="dkw"):
    """The table values the kernel takes on trust: ``base`` non-negative
    and, for the stepped layouts, each step's level index in range and
    its rows (dkw) or blocks (flat ragged) inside its band array.  Reads
    the tables on the host, one device sync, so the banded operators run
    it once where they are built rather than before every launch.  Meta
    tensors hold no values and pass."""
    if base.is_meta:
        return
    if base.numel() and int(base.min()) < 0:
        raise ValueError("banded layout: a negative window base")
    if layout == "uniform" or sched.shape[1] == 0:
        return
    off, lvl = sched[0].long().cpu(), sched[1].long().cpu()
    if int(lvl.min()) < 0 or int(lvl.max()) >= len(levels):
        raise ValueError("banded layout: a step's level index is out of "
                         f"range for {len(levels)} levels")
    if layout == "dkw":
        end, size = off + G, torch.tensor([b.shape[0] for b in bands])[lvl]
    else:
        end, size = off + G * torch.tensor(levels)[lvl], bands[0].shape[0]
    if int(off.min()) < 0 or bool((end > size).any()):
        raise ValueError("banded layout: a step's offset reaches outside "
                         "its band array")


def check_band_index(nz_rowptr, nz_win, base, sched, levels, G,
                     block_shape=(BLOCK, BLOCK)):
    """The row index's values, which the row walk takes on trust:
    ``nz_rowptr`` int32 ``[br * len(base) + 1]`` from 0, monotone and
    ending at ``len(nz_win)``; every window offset in ``nz_win`` (int16)
    inside its block-row's band, ``0 <= k < W * bc`` with ``W`` the
    row's level width (``levels[sched[1, r // G]]``; ``sched`` None and
    ``levels`` ``(W,)`` for the uniform band).  Reads the index on the
    host, one device sync, so the banded operators run it once where they
    are built.  Meta tensors hold no values and pass."""
    if nz_rowptr.is_meta:
        return
    if nz_rowptr.dtype != torch.int32 or nz_win.dtype != torch.int16:
        raise TypeError("banded row index: nz_rowptr int32 and nz_win int16 "
                        f"wanted, got {nz_rowptr.dtype} and {nz_win.dtype}")
    br, bc = block_shape
    rowptr = nz_rowptr.cpu().to(torch.int64)
    win = nz_win.cpu().to(torch.int64)
    nbr = base.numel()
    if (rowptr.dim() != 1 or rowptr.numel() != nbr * br + 1
            or int(rowptr[0]) != 0 or int(rowptr[-1]) != win.numel()
            or bool((rowptr.diff() < 0).any())):
        raise ValueError(f"banded row index: nz_rowptr must rise from 0 to "
                         f"{win.numel()} over {nbr * br} rows")
    if sched is None:
        width = torch.full((nbr,), levels[0], dtype=torch.int64)
    else:
        step = torch.arange(nbr) // G
        width = torch.tensor(levels)[sched[1].cpu().to(torch.int64)[step]]
    limit = torch.repeat_interleave(width, rowptr[::br].diff()) * bc
    if win.numel() and (int(win.min()) < 0 or bool((win >= limit).any())):
        raise ValueError("banded row index: a window offset lies outside "
                         "its block-row's band")


def _check_kernel_args(bands, base, sched, x, x0, c, levels, G, band_scale,
                       layout="dkw", index=None):
    """Everything the kernel takes on trust but the table values
    (``check_band_tables``'s) and the row index's
    (``check_band_index``'s): the shapes, dtypes and devices
    (``_check_kernel_shapes``, which the wrappers run before they call
    the op) and the alignment (``_check_alignment``, which the launch
    runs).  Returns the number of G-row steps."""
    nsb = _check_kernel_shapes(bands, base, sched, x, x0, c, levels, G,
                               band_scale, layout, index)
    _check_alignment(bands, x, x0, c)
    return nsb


def _check_kernel_shapes(bands, base, sched, x, x0, c, levels, G,
                         band_scale, layout="dkw", index=None):
    """The shapes, dtypes and devices the kernel takes on trust, from
    metadata alone, so also while ``torch.export`` traces.  ``bands``:
    the dkw layout's arrays, or ``(band,)`` for the tap layouts;
    ``levels``: the uniform layout's ``(W,)``; ``index``: the row walk's
    ``(nz_rowptr, nz_win)``.  The block shape ``(br, bc)`` is the
    band's (``block_shape_of``); every band of the layout must share it.
    Returns the number of G-row steps (the block rows for the uniform
    layout)."""
    dev = x.device
    x_rows, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"banded kernel: unsupported dtype {x.dtype}")
    if (x.dtype == torch.int8) != (band_scale is not None):
        raise ValueError("banded kernel: band_scale is required for int8 "
                         "and only for int8")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"banded kernel: 1..{MAX_LEVELS} width levels")
    if bands[0].dim() != (4 if layout == "uniform" else 3):
        raise ValueError(f"banded kernel: {layout} band "
                         f"{tuple(bands[0].shape)}")
    br, bc = block_shape_of(layout, bands, levels)
    nbr = base.numel()
    if (base.dim() != 1 or nbr < 1 or br < 1 or bc < 1 or x_rows % bc
            or C < 1):
        raise ValueError(f"banded kernel: base {tuple(base.shape)}, block "
                         f"({br}, {bc}) or x rows {x_rows} (a multiple of "
                         f"{bc} wanted)")
    if layout == "uniform":
        (band,) = bands
        if band.shape[0] != nbr or (band.shape[1],) != tuple(levels):
            raise ValueError(f"banded kernel: uniform band "
                             f"{tuple(band.shape)} for {nbr} block rows")
        nsb, tables = nbr, [base]
    else:
        if nbr % G:
            raise ValueError(f"banded kernel: {nbr} block rows are not "
                             f"whole steps of G = {G}")
        nsb = nbr // G
        if layout == "dkw":
            if len(bands) != len(levels):
                raise ValueError("banded kernel: one dkw band per level")
            for b, w in zip(bands, levels):
                if b.dim() != 3 or b.shape[1:] != (br, w * bc):
                    raise ValueError(f"banded kernel: band {tuple(b.shape)}"
                                     f" does not match level width {w} of "
                                     f"({br}, {bc}) blocks")
        elif len(bands) != 1:
            raise ValueError("banded kernel: one flat ragged band")
        if tuple(sched.shape) != (3, nsb):
            raise ValueError("banded kernel: sched does not match base")
        tables = [base, sched]
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError("banded kernel: base and sched must be int32")
    if index is not None:
        nz_rowptr, nz_win = index
        if nz_rowptr.dtype != torch.int32 or nz_win.dtype != torch.int16:
            raise TypeError("banded kernel: nz_rowptr must be int32 and "
                            "nz_win int16")
        if (tuple(nz_rowptr.shape) != (nbr * br + 1,)
                or nz_win.dim() != 1):
            raise ValueError(f"banded kernel: nz_rowptr must be "
                             f"[{nbr * br + 1}] and nz_win 1-D")
        tables = tables + [nz_rowptr, nz_win]
    _check_c(x0, c, band_scale)
    rows = [t for t in (x, x0, c) if t is not None]
    for t in list(bands) + tables + rows:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("banded kernel: every tensor must be "
                             f"contiguous on {dev}")
    for b in bands:
        if b.dtype != x.dtype:
            raise TypeError(f"banded kernel: band {b.dtype} vs x {x.dtype}")
    for name, t in (("x0", x0), ("c", c)):
        if t is not None and (t.dtype != x.dtype
                              or tuple(t.shape) != (nbr * br, C)):
            raise ValueError(f"banded kernel: {name} must be [{nbr * br},"
                             f" {C}] in x's dtype")
    return nsb


def _check_alignment(bands, x, x0, c):
    # The kernel loads bands and x in 16-byte vectors; x0 and c are held
    # to the same rule.  Reads addresses: run where the kernel launches.
    for t in list(bands) + [t for t in (x, x0, c) if t is not None]:
        if t.data_ptr() % 16:
            raise ValueError("banded kernel: bands, x, x0 and c must start "
                             "on a 16-byte boundary (a view with a storage "
                             "offset may not)")


def _launch(layout, bands, widths, base, sched, index, x, x0, c, G,
            band_scale, y):
    """One launch of ``csrc/band.cu`` in ``layout`` writing ``y`` (``x0``
    itself for the in-place form), counted on the layout's wrapper: the
    CUDA implementation of ``cnn_graph_torch::band_rows`` and
    ``band_rows_`` (``ops/library.py``), reached through the wrappers'
    shape checks."""
    _check_alignment(bands, x, x0, c)
    nbr = base.numel()
    nsb = nbr if layout == "uniform" else nbr // G
    br, bc = block_shape_of(layout, bands, widths)
    x_rows, C = x.shape
    ptrs = [b.data_ptr() for b in bands] + [None] * (MAX_LEVELS - len(bands))
    widths = list(widths) + [0] * (MAX_LEVELS - len(widths))
    form = "spmm" if x0 is None else "hop" if c is None else "hop_c"
    # The span names the kernel and form in a torch.profiler trace.
    with torch.cuda.device(x.device), profiling.span(
            f"band_{layout}.{form}"):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            _LAYOUT_CODE[layout], *ptrs, *widths, base.data_ptr(),
            None if sched is None else sched.data_ptr(),
            *(t.data_ptr() for t in index), nbr, nsb, G, br, bc,
            x.data_ptr(), x_rows, None if x0 is None else x0.data_ptr(),
            None if c is None else c.data_ptr(), y.data_ptr(), C,
            0.0 if band_scale is None else float(band_scale),
            _DTYPE_CODE[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"band_{layout} kernel launch failed: CUDA "
                           f"error {rc}")
    _WRAPPERS[layout].launched(form)


def window_reference(layout, bands, base, sched, x, x0, c, levels, G,
                     band_scale):
    """The plain window version of ``layout`` (``bands`` as the kernel
    takes them): the CPU implementation of ``cnn_graph_torch::
    band_rows``."""
    if layout == "dkw":
        return banded_dkw_reference(bands, base, sched, x, x0, c,
                                    levels=levels, G=G,
                                    band_scale=band_scale)
    if layout == "uniform":
        return banded_uniform_reference(bands[0], base, x, x0, c,
                                        band_scale=band_scale)
    return banded_ragged_reference(bands[0], base, sched, x, x0, c,
                                   levels=levels, G=G, band_scale=band_scale)


def _call(name, layout, bands, widths, base, sched, x, x0, c, G,
          band_scale, donate_x0, index):
    """Check the arguments, then one call of the custom op: the kernel
    for a CUDA ``x``, the plain window version for a CPU one.  Returns
    the output (``x0`` itself when donated)."""
    _check_no_grad(x, x0, c)
    if x.device.type == "cuda":
        if index[0] is None or index[1] is None:
            raise ValueError(f"{name}: the kernel walks the operator's "
                             "row index; pass nz_rowptr and nz_win "
                             "(ops.packing.band_row_index)")
        _check_kernel_shapes(bands, base, sched, x, x0, c, widths, G,
                             band_scale, layout, index)
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    elif donate_x0 and x0 is None:
        raise ValueError("donate_x0 needs the hop form (x0)")
    args = (list(bands), base, sched, *index, x)
    static = (layout, list(widths), G, band_scale)
    if donate_x0:
        torch.ops.cnn_graph_torch.band_rows_(*args, x0, c, *static)
        return x0
    return torch.ops.cnn_graph_torch.band_rows(*args, x0, c, *static)


@profiling.counted("band_dkw")
def banded_dkw(bands, base, sched, x, x0=None, c=None, *, levels, G,
               band_scale=None, donate_x0=False, nz_rowptr=None,
               nz_win=None) -> torch.Tensor:
    """``L @ x`` (``x0`` None), the hop ``2 (L @ x) - x0``, or the adjoint
    hop ``2 (L @ x) - x0 + c`` on the dkw layout (K1).  ``bands``: one
    ``[n_rows_l, br, W_l*bc]`` array per level; ``base`` int32
    ``[nbr]``; ``sched`` int32 ``[3, nbr/G]`` (row offset, level index,
    column high-water); ``x``: ``[x_rows, C]``; ``x0``, ``c``: ``[nbr*br,
    C]``, all in the band dtype.  ``band_scale`` (int8 only, no ``c``) is
    the band's dequant scale; the result is then requantized int8 in x's
    scale.  ``nz_rowptr``/``nz_win``: the operator's row index, which the
    kernel walks (required for a CUDA x, unread on the CPU).  Returns
    ``[nbr*br, C]`` in x's dtype."""
    return _call("banded_dkw", "dkw", bands, levels, base, sched, x, x0, c,
                 G, band_scale, donate_x0, (nz_rowptr, nz_win))


@profiling.counted("band_uniform")
def banded_uniform(band, base, x, x0=None, c=None, *, band_scale=None,
                   donate_x0=False, nz_rowptr=None,
                   nz_win=None) -> torch.Tensor:
    """``banded_dkw``'s forms on the uniform band ``[nbr, W, br, bc]``
    (K5): block-row r multiplies ``band[r, d]`` by x block-row ``base[r] +
    d`` for d < W.  The row index as for ``banded_dkw``."""
    return _call("banded_uniform", "uniform", (band,), (band.shape[1],),
                 base, None, x, x0, c, 1, band_scale, donate_x0,
                 (nz_rowptr, nz_win))


@profiling.counted("band_ragged")
def banded_ragged(band, base, sched, x, x0=None, c=None, *, levels, G,
                  band_scale=None, donate_x0=False, nz_rowptr=None,
                  nz_win=None) -> torch.Tensor:
    """``banded_dkw``'s forms on the flat ragged band ``[total, br, bc]``
    (K6): block-row r = s*G + g multiplies ``band[sched[0, s] + g*W_s +
    d]``, ``W_s = levels[sched[1, s]]``, by x block-row ``base[r] + d``.
    The row index as for ``banded_dkw``."""
    return _call("banded_ragged", "ragged", (band,), levels, base, sched, x,
                 x0, c, G, band_scale, donate_x0, (nz_rowptr, nz_win))


_WRAPPERS = {"dkw": banded_dkw, "uniform": banded_uniform,
             "ragged": banded_ragged}


def layout_call(L, x, x0=None, c=None, *, band_scale=None, donate=False):
    """One product through a banded operator's layout, the dispatch of
    ``_band_call`` (pallas_band.py:688-710): the dkw layout where
    ``bands_dkw`` is present (K1), else the flat ragged one where
    ``levels`` is set (K6), else the uniform one (K5).  With
    ``L.use_pallas`` the kernel's wrapper, without it the layout's plain
    window version on the operator's row lists per level
    (``L.level_rows``).  Every kernel walks the band's nonzeros row by row
    through the operator's row index (``L.nz_rowptr``, ``L.nz_win``),
    reading each value from the layout's band."""
    if L.bands_dkw is not None:
        fns = (banded_dkw, banded_dkw_reference)
        args = (L.bands_dkw, L.base, L.sched_dkw)
        kw = dict(levels=L.levels, G=L.rows_per_step)
    elif L.levels:
        fns = (banded_ragged, banded_ragged_reference)
        args = (L.band, L.base, L.sched)
        kw = dict(levels=L.levels, G=L.rows_per_step)
    else:
        fns = (banded_uniform, banded_uniform_reference)
        args = (L.band, L.base)
        kw = {}
    index = dict(nz_rowptr=L.nz_rowptr, nz_win=L.nz_win)
    if not L.use_pallas:
        if kw:
            kw["level_rows"] = L.level_rows
        return fns[1](*args, x, x0, c, band_scale=band_scale,
                      donate_x0=donate, **kw)
    return fns[0](*args, x, x0, c, band_scale=band_scale, donate_x0=donate,
                  **kw, **index)


def _band_call(L, x, x0, c=None, donate=False):
    # The kernel boundary casts x, x0 and c to the band dtype; the result
    # comes back in the caller's dtype (pallas_band._band_call).
    cdt = L.compute_dtype

    def cast(t):
        return None if t is None else t.to(cdt).contiguous()

    y = layout_call(L, cast(x), cast(x0), cast(c), donate=donate)
    return y.to(x.dtype)


class _BandSpmm(torch.autograd.Function):
    """``L @ x``; L is symmetric, so ``dx = L g`` (pallas_band :664-671).
    The operator is a non-tensor argument with no gradient."""

    @staticmethod
    def forward(ctx, L, x):
        ctx.L = L
        return _band_call(L, x, None)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dx = _band_call(ctx.L, g, None) if ctx.needs_input_grad[1] else None
        return None, dx


class _BandChebyHop(torch.autograd.Function):
    """``2 (L @ x1) - x0``; ``dx1 = 2 L g``, ``dx0 = -g`` (:850-858)."""

    @staticmethod
    def forward(ctx, L, x1, x0):
        ctx.L, ctx.x0_dtype = L, x0.dtype
        return _band_call(L, x1, x0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        _, need_x1, need_x0 = ctx.needs_input_grad
        dx1 = 2.0 * _band_call(ctx.L, g, None) if need_x1 else None
        dx0 = (-g).to(ctx.x0_dtype) if need_x0 else None
        return None, dx1, dx0


def band_spmm(L, x: torch.Tensor) -> torch.Tensor:
    """``L @ x`` for a BandedLaplacian; ``x``: ``[Mp, C]``.  Differentiable
    in ``x``."""
    return _BandSpmm.apply(L, x)


def band_cheby_hop(L, x1: torch.Tensor, x0: torch.Tensor,
                   donate: bool = False) -> torch.Tensor:
    """Fused Chebyshev recurrence hop ``2 (L @ x1) - x0`` in one pass.
    Differentiable in ``x1`` and ``x0``.  ``donate`` writes the result
    over ``x0``, which must then be contiguous and, with ``x1``, in the
    band dtype (no cast copy to write into); inference only: it raises
    when autograd would record the hop."""
    if donate:
        if torch.is_grad_enabled() and (x1.requires_grad
                                        or x0.requires_grad):
            raise RuntimeError("band_cheby_hop(donate=True) overwrites x0 "
                               "and has no backward: run under "
                               "torch.no_grad()")
        if not (x1.dtype == x0.dtype == L.compute_dtype
                and x0.is_contiguous()):
            raise ValueError(
                f"band_cheby_hop(donate=True): x1 {x1.dtype} and x0 "
                f"{x0.dtype} must be in the band dtype {L.compute_dtype} "
                "and x0 contiguous, or the result lands in a copy")
        return _band_call(L, x1, x0, donate=True)
    return _BandChebyHop.apply(L, x1, x0)


def band_cheby_hop_c(L, x1: torch.Tensor, x0: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """Adjoint-chain hop ``2 (L @ x1) - x0 + c`` in one kernel pass: the
    reverse Chebyshev recurrence with its injection ``c`` folded into the
    emission.  No backward: it runs inside ``cheby_conv_banded``'s."""
    return _band_call(L, x1, x0, c)
