"""Banded SpMM and fused Chebyshev hop on the deep-K-window layout.

Counterpart of ``cnn_graph_tpu/ops/pallas_band.py``: ``banded_dkw`` is
``banded_call_dkw`` (:568), ``band_spmm`` / ``band_cheby_hop`` are the
operator-level wrappers (:653, :833) and ``_band_call`` keeps the
boundary casts of the JAX one (:674-711).

``banded_dkw`` launches the CUDA kernel ``csrc/band_dkw.cu`` for CUDA
tensors and runs the plain PyTorch version ``banded_dkw_reference`` for
CPU tensors; the device of ``x`` is the only thing that chooses.  Its
``launches`` attribute counts kernel launches, ``form_launches`` the same
launches by form (``spmm``, ``hop``, ``hop_c``).

``band_spmm`` and ``band_cheby_hop`` are ``torch.autograd.Function``s
with the symmetric adjoints of :664-671 and :850-858, each backward one
kernel launch.  ``band_cheby_hop_c`` (:714), the adjoint chain's hop, has
no backward, like ``banded_dkw`` itself: both raise when a gradient would
be needed rather than return a result with no gradient path.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
from torch.profiler import record_function

from cnn_graph_tpu_torch import _build
from cnn_graph_tpu_torch.ops.packing import BLOCK, MAX_LEVELS

__all__ = ["banded_dkw", "banded_dkw_reference", "band_spmm",
           "band_cheby_hop", "band_cheby_hop_c", "full_f32_matmul"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full f32, not TF32, for the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


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
        raise ValueError("banded_dkw: c requires x0 (the hop form)")
    if band_scale is not None:
        raise ValueError("banded_dkw: no c form for int8 (inference only)")


def banded_dkw_reference(bands, base, sched, x, x0=None, c=None, *, levels,
                         G, band_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per width level, gather each
    block-row's x window (rows past the end of x read as zero), one
    batched product, scatter to the output rows, then the emission.

    Float bands accumulate in f32.  Int8 accumulates in float64, which is
    exact here (|acc| <= 127^2 * W*128 << 2^53) on every device, unlike
    int8 ``matmul`` (wraps) or f32 (inexact above 2^24)."""
    _check_c(x0, c, band_scale)
    mp, C = x.shape
    nbr = mp // BLOCK
    quant = band_scale is not None
    acc_dtype = torch.float64 if quant else torch.float32
    rows = torch.arange(nbr, device=x.device)
    step = rows // G
    sched = sched.to(torch.int64)
    lvl = sched[1][step]
    local = sched[0][step] + rows % G
    acc = torch.zeros(nbr, BLOCK, C, dtype=acc_dtype, device=x.device)
    xa = x.to(acc_dtype)
    with full_f32_matmul():
        for li, w in enumerate(levels):
            sel = torch.nonzero(lvl == li).flatten()
            if sel.numel() == 0:
                continue
            idx = (base[sel].to(torch.int64)[:, None] * BLOCK
                   + torch.arange(w * BLOCK, device=x.device)[None, :])
            inside = (idx < mp).to(acc_dtype)[..., None]
            win = xa[idx.clamp(max=mp - 1)] * inside   # [n, w*128, C]
            blk = bands[li][local[sel]].to(acc_dtype)  # [n, 128, w*128]
            acc[sel] = torch.bmm(blk, win)
    return _emit(acc.reshape(mp, C), x0, c, band_scale, x.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("band_dkw").band_dkw_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * MAX_LEVELS + [i] * MAX_LEVELS
                   + [p, p, i, i, p, p, p, p, i, i, ctypes.c_float, i, p])
    fn.restype = ctypes.c_int
    return fn


def _check_no_grad(*ts):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise RuntimeError(
            "banded_dkw has no backward: differentiate through band_spmm / "
            "band_cheby_hop, or run under torch.no_grad()"
        )


def _check_kernel_args(bands, base, sched, x, x0, c, levels, G, band_scale):
    dev = x.device
    mp, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"banded_dkw: unsupported dtype {x.dtype}")
    if (x.dtype == torch.int8) != (band_scale is not None):
        raise ValueError("banded_dkw: band_scale is required for int8 and "
                         "only for int8")
    if not 1 <= len(bands) == len(levels) <= MAX_LEVELS:
        raise ValueError(f"banded_dkw: 1..{MAX_LEVELS} levels, one band each")
    if mp % (G * BLOCK) or C < 1:
        raise ValueError(f"banded_dkw: x rows {mp} not a multiple of G*128")
    nsb = mp // (G * BLOCK)
    for b, w in zip(bands, levels):
        if b.dim() != 3 or b.shape[1:] != (BLOCK, w * BLOCK):
            raise ValueError(f"banded_dkw: band {tuple(b.shape)} does not "
                             f"match level width {w}")
    if tuple(base.shape) != (mp // BLOCK,) or tuple(sched.shape) != (3, nsb):
        raise ValueError("banded_dkw: base/sched do not match x's rows")
    if base.dtype != torch.int32 or sched.dtype != torch.int32:
        raise TypeError("banded_dkw: base and sched must be int32")
    _check_c(x0, c, band_scale)
    rows = [t for t in (x, x0, c) if t is not None]
    for t in list(bands) + [base, sched] + rows:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("banded_dkw: every tensor must be contiguous on "
                             f"{dev}")
    for b in bands:
        if b.dtype != x.dtype:
            raise TypeError(f"banded_dkw: band {b.dtype} vs x {x.dtype}")
    # The kernel loads bands and x in 16-byte vectors; x0 and c are held
    # to the same rule.
    for t in list(bands) + rows:
        if t.data_ptr() % 16:
            raise ValueError("banded_dkw: bands, x, x0 and c must start on a "
                             "16-byte boundary (a view with a storage "
                             "offset may not)")
    for name, t in (("x0", x0), ("c", c)):
        if t is not None and (t.dtype != x.dtype or t.shape != x.shape):
            raise ValueError(f"banded_dkw: {name} must match x's shape and "
                             "dtype")
    return nsb


def banded_dkw(bands, base, sched, x, x0=None, c=None, *, levels, G,
               band_scale=None) -> torch.Tensor:
    """``L @ x`` (``x0`` None), the hop ``2 (L @ x) - x0``, or the adjoint
    hop ``2 (L @ x) - x0 + c`` on the dkw layout.  ``bands``: one
    ``[n_rows_l, 128, W_l*128]`` array per level; ``base`` int32
    ``[Mp/128]``; ``sched`` int32 ``[3, nsb]`` (row offset, level index,
    column high-water); ``x``, ``x0``, ``c``: ``[Mp, C]`` in the band
    dtype.  ``band_scale`` (int8 only, no ``c``) is the band's dequant
    scale; the result is then requantized int8 in x's scale.  Returns
    ``[Mp, C]`` in x's dtype."""
    _check_no_grad(x, x0, c)
    if x.device.type == "cpu":
        return banded_dkw_reference(bands, base, sched, x, x0, c,
                                    levels=levels, G=G,
                                    band_scale=band_scale)
    if x.device.type != "cuda":
        raise ValueError(f"banded_dkw: no kernel for device {x.device}")
    nsb = _check_kernel_args(bands, base, sched, x, x0, c, levels, G,
                             band_scale)
    mp, C = x.shape
    y = torch.empty_like(x)
    ptrs = [b.data_ptr() for b in bands] + [None] * (MAX_LEVELS - len(bands))
    widths = list(levels) + [0] * (MAX_LEVELS - len(levels))
    form = "spmm" if x0 is None else "hop" if c is None else "hop_c"
    # The range names the form in a torch.profiler trace.
    with torch.cuda.device(x.device), record_function(f"band_dkw.{form}"):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            *ptrs, *widths, base.data_ptr(), sched.data_ptr(), nsb, G,
            x.data_ptr(), None if x0 is None else x0.data_ptr(),
            None if c is None else c.data_ptr(), y.data_ptr(), mp, C,
            0.0 if band_scale is None else float(band_scale),
            _DTYPE_CODE[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"band_dkw kernel launch failed: CUDA error {rc}")
    banded_dkw.launches += 1
    banded_dkw.form_launches[form] += 1
    return y


banded_dkw.launches = 0
banded_dkw.form_launches = collections.Counter()


def _band_call(L, x, x0, c=None):
    # The kernel boundary casts x, x0 and c to the band dtype; the result
    # comes back in the caller's dtype (pallas_band._band_call).
    cdt = L.compute_dtype

    def cast(t):
        return None if t is None else t.to(cdt).contiguous()

    y = banded_dkw(L.bands_dkw, L.base, L.sched_dkw, cast(x), cast(x0),
                   cast(c), levels=L.levels, G=L.rows_per_step)
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


def band_cheby_hop(L, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Fused Chebyshev recurrence hop ``2 (L @ x1) - x0`` in one pass.
    Differentiable in ``x1`` and ``x0``."""
    return _BandChebyHop.apply(L, x1, x0)


def band_cheby_hop_c(L, x1: torch.Tensor, x0: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """Adjoint-chain hop ``2 (L @ x1) - x0 + c`` in one kernel pass: the
    reverse Chebyshev recurrence with its injection ``c`` folded into the
    emission.  No backward: it runs inside ``cheby_conv_banded``'s."""
    return _band_call(L, x1, x0, c)
