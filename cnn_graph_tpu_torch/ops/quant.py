"""The int8 twins' activation conversions, each one pass on the card.

``QuantOpMixin.quantize`` and ``.dequantize`` (``ops/laplacian.py``) call
the two wrappers here, and through them every int8 operator, the
streaming int8 conv and the int8 basis (``ops/filters.py``):

* ``quantize_int8(x, scale)``: ``clamp(round(x / scale), -127, 127)``
  in int8 (``quantize_reference``);
* ``dequantize_int8(q, scale, dtype)``: ``float32(q) * scale`` in
  ``dtype`` (``dequantize_reference``).

``scale`` is a Python float or a one-element tensor: the operator's
``act_scale``, or the run-time scale the int8 convs compute on the card.
Each wrapper checks its arguments and calls its custom op
(``cnn_graph_torch::quantize_int8``, ``dequantize_int8``,
``ops/library.py``), whose CUDA implementation launches
``csrc/quant.cu`` and whose CPU implementation is the plain expression;
the device of the input is the only thing that chooses.  So a program
that ``torch.export`` traced keeps each conversion as one node.

On the card each conversion is one kernel launch that gives the plain
expression's bits.  Those depend on how the scale is passed: ATen
divides by a device tensor, but multiplies by the f32 reciprocal of a
host number (a Python float or a 0-d CPU tensor), and it casts a device
scale to a 16-bit input's dtype first; the launch does the same
(``_kernel_scale``).  The kernel reads a device scale where it lies, so
the host never waits for it.  Inputs on the card are dense of any shape
in any order of their dims (a transposed carry, as the first conv of a
ChebNet passes it), walked in memory order, or ``[batch, rows, C]`` with
any batch and row stride and a unit column stride (``rows_view``); the
output has the plain expression's layout (``out_like``).  Quantisation
takes float32, bfloat16 and float16, dequantisation gives them.
Anything else on the card raises.  ``launches`` counts kernel launches: views of the
recorder's counters ``launches.quantize_int8`` and
``launches.dequantize_int8`` (``utils/profiling.py Counted``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cnn_graph_tpu_torch import _build
from cnn_graph_tpu_torch.utils import profiling

__all__ = ["dequantize_int8", "dequantize_reference", "out_like",
           "quantize_int8", "quantize_reference", "rows_view"]

# csrc/quant.cu's codes for the float side of a conversion.
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize_reference(x: torch.Tensor, scale) -> torch.Tensor:
    """The plain version: ``clamp(round(x / scale), -127, 127)`` in int8."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_reference(q: torch.Tensor, scale,
                         dtype=torch.float32) -> torch.Tensor:
    """The plain version: ``float32(q) * scale`` in ``dtype``."""
    return (q.to(torch.float32) * scale).to(dtype)


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill a span of memory with no gap, in some
    order of its dims (size-1 dims aside), as a transpose of a contiguous
    tensor does."""
    want = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(),
                                                         t.shape) if sz != 1):
        if stride != want:
            return False
        want *= size
    return True


def out_like(t: torch.Tensor, dtype) -> torch.Tensor:
    """The output of a conversion of ``t``, in the plain expression's
    layout: ``t``'s strides where ``t`` is dense (ATen's elementwise ops
    keep them), else contiguous."""
    if _dense(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=dtype,
                                   device=t.device)
    return torch.empty(t.shape, dtype=dtype, device=t.device)


def rows_view(t: torch.Tensor) -> tuple:
    """``t`` as the kernels take it, ``(B, R, C, sb, sr)``: ``[B, R, C]``
    with element strides ``sb``, ``sr`` and 1.  A dense tensor
    (``_dense``) is one row in memory order; a 2-D or 3-D one with a unit
    column stride is its rows, rows that follow each other folded into
    one.  Raises on any other layout."""
    if _dense(t):
        n = t.numel()
        return 1, 1, n, n, n
    if t.dim() not in (2, 3) or (t.shape[-1] != 1 and t.stride(-1) != 1):
        raise ValueError(
            f"int8 conversion kernel: a {t.dim()}-D input with shape "
            f"{tuple(t.shape)} and strides {t.stride()}: it takes a "
            "dense tensor or [batch, rows, C] with a unit column "
            "stride")
    B, R, C = (1, *t.shape) if t.dim() == 2 else t.shape
    sb, sr = (0, t.stride(0)) if t.dim() == 2 else t.stride()[:2]
    if R == 1 or sr == C:
        R, C, sr = 1, R * C, R * C
    return B, R, C, sb, sr


def _split_scale(scale):
    """``scale`` as the ops take it: ``(tensor or None, float)``."""
    if isinstance(scale, torch.Tensor):
        return scale, 0.0
    return None, float(scale)


def _check(t, scale, dtype, what):
    """What the kernels take, for a CUDA input ``t``."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: no kernel for {dtype}")
    rows_view(t)
    if scale is None:
        return
    if scale.device.type == "cpu":
        if scale.dim() != 0:
            raise ValueError(f"{what}: a CPU scale is a 0-d tensor")
    elif (scale.device != t.device or scale.dim() != 0
          or scale.dtype != torch.float32):
        raise ValueError(f"{what}: a device scale is a 0-d float32 tensor "
                         f"on the input's device, not {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")


def _kernel_scale(scale, value, dtype, reciprocal):
    """``(device tensor or None, float)`` as the launch takes them: a
    device scale cast to ``dtype`` and back to f32, as ATen casts it to
    the common dtype; a host number (a float or a 0-d CPU tensor) in f32,
    or its f32 reciprocal where ATen multiplies by it."""
    if scale is not None and scale.device.type != "cpu":
        return scale.to(dtype).to(torch.float32), 0.0
    v = np.float32(value if scale is None else scale.item())
    with np.errstate(divide="ignore"):
        return None, float(np.float32(1.0) / v if reciprocal else v)


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = _build.load("quant")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.dequant_launch, lib.quant_launch):
        fn.argtypes = [p, p, ll, ll, ll, ll, ll, p, ctypes.c_float,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib.dequant_launch, lib.quant_launch


def _launch(which, x, y, scale, value, dtype):
    fn = _launchers()[which == "quantize_int8"]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), *rows_view(x),
                None if scale is None else scale.data_ptr(), value,
                _DTYPE_CODE[dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{which} kernel launch failed: CUDA error {rc}")
    _WRAPPERS[which].launched()


def dequant_kernel(q, scale, scale_value, dtype) -> torch.Tensor:
    """One launch of ``dequant_kernel``: the CUDA implementation of
    ``cnn_graph_torch::dequantize_int8``."""
    y = out_like(q, dtype)
    if q.numel():
        s, v = _kernel_scale(scale, scale_value, torch.float32, False)
        _launch("dequantize_int8", q, y, s, v, dtype)
    return y


def quant_kernel(x, scale, scale_value) -> torch.Tensor:
    """One launch of ``quant_kernel``: the CUDA implementation of
    ``cnn_graph_torch::quantize_int8``."""
    y = out_like(x, torch.int8)
    if x.numel():
        s, v = _kernel_scale(scale, scale_value, x.dtype, True)
        _launch("quantize_int8", x, y, s, v, x.dtype)
    return y


@profiling.counted("quantize_int8")
def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """``clamp(round(x / scale), -127, 127)`` in int8, x's shape: one
    kernel launch for a CUDA ``x``, ``quantize_reference`` for a CPU
    one."""
    s, v = _split_scale(scale)
    if x.device.type == "cuda":
        _check(x, s, x.dtype, "quantize_int8")
    return torch.ops.cnn_graph_torch.quantize_int8(x, s, v)


@profiling.counted("dequantize_int8")
def dequantize_int8(q: torch.Tensor, scale,
                    dtype=torch.float32) -> torch.Tensor:
    """``float32(q) * scale`` in ``dtype``, q's shape: one
    kernel launch for a CUDA ``q``, ``dequantize_reference`` for a CPU
    one."""
    s, v = _split_scale(scale)
    if q.device.type == "cuda":
        if q.dtype != torch.int8:
            raise TypeError(f"dequantize_int8: q is {q.dtype}, not int8")
        _check(q, s, dtype, "dequantize_int8")
    return torch.ops.cnn_graph_torch.dequantize_int8(q, s, v, dtype)


_WRAPPERS = {"quantize_int8": quantize_int8,
             "dequantize_int8": dequantize_int8}
