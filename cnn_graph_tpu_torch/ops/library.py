"""The port's hand-written CUDA kernels as torch custom ops.

Each kernel family is one op in the ``cnn_graph_torch`` namespace, so
that ``torch.export`` keeps a kernel as one node of the program it
traces (a ``ctypes`` launch reads ``data_ptr()``s, which the fake
tensors of a trace do not have) and a program loaded in another process
launches the same kernels:

* ``band_rows``: K1, K5 and K6 (``csrc/band.cu band_rows_kernel``), the
  layout an argument; every form (``L@x``, ``2L@x - x0``, ``+c``) in
  f32, bf16 and int8 (with ``band_scale``), at any block shape, which
  each implementation reads from the band (``band.block_shape_of``).
  ``band_rows_`` is the in-place form, which writes its output over ``x0``
  (``mutates_args=("x0",)``) and returns nothing.
* ``bsr_rows``: K4, K7, K8 and K9 (``csrc/bsr.cu bsr_rows_kernel``),
  the route an argument.
* ``cheby_conv``: K2 (``csrc/cheby_fused.cu``), on the dense operator's
  matrix.
* ``cheby_dw``: K3 and its fold, on K2's launch template.
* ``quantize_int8`` and ``dequantize_int8``: the int8 twins' activation
  conversions (``csrc/quant.cu``), a scale tensor or a float.

Each op has three implementations: CUDA, the ``ctypes`` launch of
``ops/band.py``, ``ops/bsr.py``, ``ops/cheby.py`` or ``ops/quant.py``,
which counts the launch on its wrapper (``launches``, ``form_launches``,
``route_launches``, views of the recorder's counters) and, but for the
conversions, whose spans are their callers', names it in a span of the
recorder (``utils/profiling.py``), so a loaded program counts and names
its launches as the eager path does; CPU, the kernel's plain PyTorch
version; and a fake one that gives the output's shape and dtype (int8
in, int8 out; the conversions' int8 or ``dtype``) and counts nothing.
There is no fallback: a CUDA op that cannot build or launch raises.  The
wrappers (``banded_dkw``, ``bsr_colstream``, ``fused_filter``,
``quantize_int8``, ...) check their arguments' shapes before they call
an op, so the checks run while ``torch.export`` traces too.

Importing ``cnn_graph_tpu_torch.ops`` imports this module, which
registers the ops; ``serve.load_serving`` needs them registered before
``torch.export.load``.
"""

from __future__ import annotations

from typing import Optional

import torch

from cnn_graph_tpu_torch.ops import band, bsr, cheby, quant

__all__ = ["NAMESPACE", "launch_counts", "reset_launch_counts"]

NAMESPACE = "cnn_graph_torch"
Tensor = torch.Tensor


# ----------------------------------------------------------- K1, K5, K6


def _block_rows(layout, bands, levels) -> int:
    """The band's block rows: the output has ``len(base)`` times as many."""
    return band.block_shape_of(layout, bands, levels)[0]


@torch.library.custom_op(f"{NAMESPACE}::band_rows", mutates_args=(),
                         device_types="cpu")
def band_rows(bands: list[Tensor], base: Tensor, sched: Optional[Tensor],
              nz_rowptr: Optional[Tensor], nz_win: Optional[Tensor],
              x: Tensor, x0: Optional[Tensor], c: Optional[Tensor],
              layout: str, levels: list[int], G: int,
              band_scale: Optional[float]) -> Tensor:
    """The banded product in ``layout`` (``dkw``, ``uniform`` or
    ``ragged``): ``[len(base) * br, C]`` in x's dtype, ``br`` the band's
    block rows.  CPU: the layout's plain window version."""
    return band.window_reference(layout, bands, base, sched, x, x0, c,
                                 levels, G, band_scale)


@band_rows.register_kernel("cuda")
def _(bands, base, sched, nz_rowptr, nz_win, x, x0, c, layout, levels, G,
      band_scale):
    y = x.new_empty((base.shape[0] * _block_rows(layout, bands, levels),
                     x.shape[1]))
    band._launch(layout, bands, levels, base, sched, (nz_rowptr, nz_win),
                 x, x0, c, G, band_scale, y)
    return y


@band_rows.register_fake
def _(bands, base, sched, nz_rowptr, nz_win, x, x0, c, layout, levels, G,
      band_scale):
    return x.new_empty((base.shape[0] * _block_rows(layout, bands, levels),
                        x.shape[1]))


@torch.library.custom_op(f"{NAMESPACE}::band_rows_", mutates_args=("x0",),
                         device_types="cpu")
def band_rows_(bands: list[Tensor], base: Tensor, sched: Optional[Tensor],
               nz_rowptr: Optional[Tensor], nz_win: Optional[Tensor],
               x: Tensor, x0: Tensor, c: Optional[Tensor], layout: str,
               levels: list[int], G: int,
               band_scale: Optional[float]) -> None:
    """``band_rows``' hop written over ``x0``, which x and c must not
    alias.  CPU: the plain window version, copied into x0."""
    band._check_donate(x, x0, c)
    x0.copy_(band.window_reference(layout, bands, base, sched, x, x0, c,
                                   levels, G, band_scale))


@band_rows_.register_kernel("cuda")
def _(bands, base, sched, nz_rowptr, nz_win, x, x0, c, layout, levels, G,
      band_scale):
    band._check_donate(x, x0, c)
    band._launch(layout, bands, levels, base, sched, (nz_rowptr, nz_win),
                 x, x0, c, G, band_scale, x0)


@band_rows_.register_fake
def _(bands, base, sched, nz_rowptr, nz_win, x, x0, c, layout, levels, G,
      band_scale):
    return None


# ------------------------------------------------------ K4, K7, K8, K9


@torch.library.custom_op(f"{NAMESPACE}::bsr_rows", mutates_args=(),
                         device_types="cpu")
def bsr_rows(blocks: Tensor, nz_rowptr: Tensor, nz_cols: Tensor,
             nz_pos: Tensor, x: Tensor, x0: Optional[Tensor], route: str,
             block_scale: Optional[float]) -> Tensor:
    """The BSR row walk as ``route`` (``K4``, ``K7``, ``K8`` or ``K9``):
    ``[len(nz_rowptr) - 1, C]`` in x's dtype.  CPU: ``bsr_rows_reference``."""
    return bsr.bsr_rows_reference(blocks, nz_rowptr, nz_cols, nz_pos, x, x0,
                                  block_scale=block_scale)


@bsr_rows.register_kernel("cuda")
def _(blocks, nz_rowptr, nz_cols, nz_pos, x, x0, route, block_scale):
    return bsr._launch(blocks, nz_rowptr, nz_cols, nz_pos, x, x0, route,
                       block_scale)


@bsr_rows.register_fake
def _(blocks, nz_rowptr, nz_cols, nz_pos, x, x0, route, block_scale):
    return x.new_empty((nz_rowptr.shape[0] - 1, x.shape[1]))


# --------------------------------------------------------------- K2, K3


@torch.library.custom_op(f"{NAMESPACE}::cheby_conv", mutates_args=(),
                         device_types="cpu")
def cheby_conv(mat: Tensor, x: Tensor, w: Tensor) -> Tensor:
    """K2: ``sum_k T_k(L) x W_k`` on the dense matrix ``mat``; ``x`` ``[B,
    M, F]``, ``w`` ``[K, F, O]`` -> ``[B, M, O]`` in x's dtype.  CPU:
    ``cheby_conv_fused_reference``, made contiguous as the kernel's
    output is."""
    return cheby.cheby_conv_fused_reference(x, cheby.dense_view(mat),
                                            w).contiguous()


@cheby_conv.register_kernel("cuda")
def _(mat, x, w):
    # Contiguous as the fake output is: a copy only where one sample
    # fills a group and O is not a multiple of 8 (a view of the padding).
    return cheby.conv_kernel(mat, x, w).contiguous()


@cheby_conv.register_fake
def _(mat, x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@torch.library.custom_op(f"{NAMESPACE}::cheby_dw", mutates_args=(),
                         device_types="cpu")
def cheby_dw(mat: Tensor, x: Tensor, g: Tensor, K: int) -> Tensor:
    """K3: ``dW[k, f, o] = sum_{b, m} (T_k x)[b, m, f] g[b, m, o]``, f32
    ``[K, F, O]``.  CPU: ``cheby_dw_fused_reference``."""
    return cheby.cheby_dw_fused_reference(x, cheby.dense_view(mat), g, K)


@cheby_dw.register_kernel("cuda")
def _(mat, x, g, K):
    return cheby.dw_kernel(mat, x, g, K)


@cheby_dw.register_fake
def _(mat, x, g, K):
    return x.new_empty((K, x.shape[2], g.shape[2]), dtype=torch.float32)


# ---------------------------------------------------- int8 conversions


@torch.library.custom_op(f"{NAMESPACE}::quantize_int8", mutates_args=(),
                         device_types="cpu")
def quantize_int8(x: Tensor, scale: Optional[Tensor],
                  scale_value: float) -> Tensor:
    """``clamp(round(x / s), -127, 127)`` in int8, ``s`` the tensor
    ``scale`` where given, else ``scale_value``.  CPU:
    ``quant.quantize_reference``, in the kernel's output layout."""
    s = scale_value if scale is None else scale
    return quant.out_like(x, torch.int8).copy_(
        quant.quantize_reference(x, s))


@quantize_int8.register_kernel("cuda")
def _(x, scale, scale_value):
    return quant.quant_kernel(x, scale, scale_value)


@quantize_int8.register_fake
def _(x, scale, scale_value):
    return quant.out_like(x, torch.int8)


@torch.library.custom_op(f"{NAMESPACE}::dequantize_int8", mutates_args=(),
                         device_types="cpu")
def dequantize_int8(q: Tensor, scale: Optional[Tensor], scale_value: float,
                    dtype: torch.dtype) -> Tensor:
    """``float32(q) * s`` in ``dtype``, ``s`` as for ``quantize_int8``.
    CPU: ``quant.dequantize_reference``, in the kernel's output
    layout."""
    s = scale_value if scale is None else scale
    return quant.out_like(q, dtype).copy_(
        quant.dequantize_reference(q, s, dtype))


@dequantize_int8.register_kernel("cuda")
def _(q, scale, scale_value, dtype):
    return quant.dequant_kernel(q, scale, scale_value, dtype)


@dequantize_int8.register_fake
def _(q, scale, scale_value, dtype):
    return quant.out_like(q, dtype)


# ------------------------------------------------------------ the counts

_COUNTED = {"band_dkw": band.banded_dkw, "band_uniform": band.banded_uniform,
            "band_ragged": band.banded_ragged,
            "bsr_colstream": bsr.bsr_colstream, "bsr_csr": bsr.bsr_csr,
            "cheby_conv_fused": cheby.cheby_conv_fused,
            "cheby_dw_fused": cheby.cheby_dw_fused}


def launch_counts() -> dict:
    """Every graph-operator kernel wrapper's launch count, by wrapper
    (the int8 conversions count on ``quant.quantize_int8`` and
    ``quant.dequantize_int8``)."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts():
    """Set every launch count, by form and route too, to 0."""
    for fn in _COUNTED.values():
        fn.reset()
