"""Fused dense Chebyshev convolution: the whole filter in one kernel.

Counterpart of ``cnn_graph_tpu/ops/pallas_cheby.py``:

* ``fused_filter`` launches K2 (``_kernel`` :61, reached through
  ``cheby_conv_fused`` :101): ``y = sum_k T_k(L) x W_k`` on a dense
  operator, the basis never stored.  No backward.
* ``cheby_conv_fused`` is the differentiable conv, the custom VJP of
  :183-204 as a ``torch.autograd.Function``: dx is K2 again with
  ``W_k^T`` (``T_k(L)`` is symmetric); dW is K3 where ``_dw_eligible``
  holds, else the stacked-basis contraction, a shape rule of the JAX
  package applied the same way.
* ``cheby_dw_fused`` launches K3 (``_dw_kernel`` :210): dW with the
  recurrence recomputed in the kernel, its per-CTA partials folded here
  by a plain sum, as the JAX package folds its tiles (:304-305).

Both kernels live in ``csrc/cheby_fused.cu``.  Beside each is its plain
PyTorch version (``cheby_conv_fused_reference``, ``cheby_dw_fused_
reference``), which computes what the TPU kernel computes in its
precision: float32 carries; for a bfloat16 operator the operands of
every product (L, the carry, W_k, g) rounded to bfloat16 and the sums in
float32, and K3's per-(sample, hop) partial rounded to bfloat16 once.
(The stacked path's ``cheby_basis`` keeps bfloat16 carries instead.)
The wrappers run the plain version for CPU tensors and the kernel for
CUDA tensors, counting launches on ``cheby_conv_fused.launches`` and
``cheby_dw_fused.launches``.  The operator's ``fused_filter`` and
``fused_dw`` methods call them, so an operator may substitute either.

``expand_tap_weights`` (the TPU's block-diagonal lane fill) and
``zero_cotangent`` have no counterpart: the CUDA kernel taps per sample,
and the operator is not a differentiable argument.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as nnf
from torch.autograd.function import once_differentiable
from torch.profiler import record_function

from cnn_graph_tpu_torch import _build
from cnn_graph_tpu_torch.ops.band import full_f32_matmul

__all__ = [
    "cheby_conv_fused",
    "cheby_conv_fused_reference",
    "cheby_dw_fused",
    "cheby_dw_fused_reference",
    "fused_filter",
    "fused_vmem_ok",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_vmem_ok(m_padded: int, compute_dtype, col_tile: int = 512,
                  budget_bytes: int = 14 * 1024 * 1024 + 512 * 1024) -> bool:
    """The TPU kernel's VMEM working set against its budget (pallas_cheby
    .py:37-48), kept word for word because it decides which layers take
    the fused path: tuned on a TPU, to be re-tuned on Hopper."""
    itemsize = compute_dtype.itemsize
    need = (m_padded * m_padded * itemsize        # L
            + 2 * m_padded * col_tile * 4         # recurrence ping-pong
            + m_padded * col_tile * 4             # accumulator
            + 2 * col_tile * col_tile * itemsize  # weight double-buffer
            + m_padded * col_tile * 4)            # x tile
    return need <= budget_bytes


def _dw_eligible(F: int, O: int, col_tile: int = 256) -> bool:
    """Whether dW takes K3 (pallas_cheby.py:178): the TPU tile's lanes
    align.  A shape rule kept for parity, to be re-tuned on Hopper."""
    s = max(col_tile // F, 1)
    return (s * F) % 128 == 0 and (s * O) % 128 == 0


def _columns(x: torch.Tensor, m_padded: int) -> torch.Tensor:
    """``[B, M, F]`` -> f32 ``[Mp, B*F]``, batch-major columns, the node
    axis zero-padded to the operator's size."""
    B, M, F = x.shape
    xt = x.permute(1, 0, 2).reshape(M, B * F).to(torch.float32)
    return nnf.pad(xt, (0, 0, 0, m_padded - M)).contiguous()


def _hops(L, t0: torch.Tensor, K: int):
    """Yield ``T_k(L) t0`` for k < K with f32 carries; each product takes
    its operands in the operator's precision."""
    Lf = L.mat.to(torch.float32)
    rnd = _rounder(L.compute_dtype)
    prev, cur = None, t0
    yield cur
    for k in range(1, K):
        nxt = torch.matmul(Lf, rnd(cur))
        if k >= 2:
            nxt = 2.0 * nxt - prev
        prev, cur = cur, nxt
        yield cur


def _rounder(dtype):
    """Round an f32 tensor to ``dtype`` and back: what a product's operand
    is in the kernel."""
    if dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(dtype).to(torch.float32)


def cheby_conv_fused_reference(x: torch.Tensor, L,
                               w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: ``[B, M, F]``, ``[K, F, O]`` ->
    ``[B, M, O]`` in x's dtype, in the TPU kernel's precision."""
    K, F, O = w.shape
    B, M, _ = x.shape
    rnd = _rounder(L.compute_dtype)
    wc = rnd(w.to(torch.float32))
    mp = L.m_padded
    with full_f32_matmul():
        y = sum(torch.matmul(rnd(t).reshape(mp, B, F), wc[k])
                for k, t in enumerate(_hops(L, _columns(x, mp), K)))
    return y[:M].permute(1, 0, 2).to(x.dtype)


def cheby_dw_fused_reference(x: torch.Tensor, L, g: torch.Tensor,
                             K: int) -> torch.Tensor:
    """Plain PyTorch version of K3: ``dW[k, f, o] = sum_{b, m} (T_k x)[b,
    m, f] g[b, m, o]``, f32 ``[K, F, O]``, each sample's partial rounded
    to the operator's dtype before the sum over samples."""
    B, M, F = x.shape
    O = g.shape[2]
    mp = L.m_padded
    rnd = _rounder(L.compute_dtype)
    gc = rnd(_columns(g, mp)).reshape(mp, B, O)
    with full_f32_matmul():
        return torch.stack([
            rnd(torch.einsum("mbf,mbo->bfo", rnd(t).reshape(mp, B, F),
                             gc)).sum(0)
            for t in _hops(L, _columns(x, mp), K)])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("cheby_fused").cheby_fused_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 8 + [p]
    fn.restype = ctypes.c_int
    return fn


def _samples_per_cta(F: int) -> int:
    """Whole samples per CTA: enough to fill 32 columns when F is small,
    else one, so that a batch of B gives B CTAs."""
    return max(1, 32 // F)


def _launch(L, x: torch.Tensor, w, g, *, K: int, O: int, name: str):
    """One launch of K2 (``w`` given) or K3 (``g`` given) on CUDA tensors;
    returns the kernel's raw f32 output."""
    B, M, F = x.shape
    mat = L.mat
    if mat.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: no kernel for a {mat.dtype} operator")
    if (mat.device != x.device or not mat.is_contiguous()
            or tuple(mat.shape) != (L.m_padded, L.m_padded)):
        raise ValueError(f"{name}: the operator must be a contiguous "
                         f"[Mp, Mp] matrix on {x.device}")
    if M > L.m_padded:
        raise ValueError(f"{name}: {M} nodes for a {L.m_padded}-node operator")
    if any(t is not None and t.device != x.device for t in (w, g)):
        raise ValueError(f"{name}: every tensor must be on {x.device}")
    mp = L.m_padded
    S = _samples_per_cta(F)
    n_ctas = -(-B // S)
    xt = _columns(x, mp)
    scratch = torch.empty(n_ctas, 2, mp, S * F, dtype=torch.float32,
                          device=x.device)
    if g is None:
        wt = w.to(mat.dtype).contiguous()
        gt = None
        out = torch.empty(mp, B * O, dtype=torch.float32, device=x.device)
    else:
        wt = None
        gt = _columns(g, mp)
        out = torch.zeros(n_ctas, K, F, S * O, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device), record_function(name):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(
            mat.data_ptr(), xt.data_ptr(),
            None if wt is None else wt.data_ptr(),
            None if gt is None else gt.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), mp, K, F, O, B, S, _DTYPE_CODE[mat.dtype],
            int(g is not None), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, S


def _plain_or_kernel(name: str, x: torch.Tensor, w=None, g=None) -> bool:
    """Check a wrapper's arguments; True for CPU tensors (plain version),
    False for CUDA ones (kernel)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, g)):
        raise RuntimeError(f"{name} has no backward: use cheby_conv_fused, "
                           "or run under torch.no_grad()")
    if w is not None and (w.dim() != 3 or w.shape[1] != x.shape[2]):
        raise ValueError(f"{name}: w {tuple(w.shape)} does not take x "
                         f"{tuple(x.shape)}")
    if g is not None and (g.dim() != 3 or g.shape[:2] != x.shape[:2]):
        raise ValueError(f"{name}: g {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return False


def fused_filter(x: torch.Tensor, L, w: torch.Tensor) -> torch.Tensor:
    """K2: ``sum_k T_k(L) x W_k`` for ``x`` ``[B, M, F]`` and ``w`` ``[K,
    F, O]`` on a DenseLaplacian -> ``[B, M, O]`` in x's dtype.  The
    kernel for CUDA tensors, the plain version for CPU ones.  No
    backward: ``cheby_conv_fused`` differentiates it."""
    if _plain_or_kernel("fused_filter", x, w=w):
        return cheby_conv_fused_reference(x, L, w)
    K, F, O = w.shape
    B, M, _ = x.shape
    y, _ = _launch(L, x, w, None, K=K, O=O, name="cheby_fused.K2")
    cheby_conv_fused.launches += 1
    return y[:M].reshape(M, B, O).permute(1, 0, 2).to(x.dtype)


def cheby_dw_fused(x: torch.Tensor, L, g: torch.Tensor,
                   K: int) -> torch.Tensor:
    """K3: ``dW[k, f, o] = sum_{b, m} (T_k x)[b, m, f] g[b, m, o]`` as f32
    ``[K, F, O]`` without storing the basis.  The kernel for CUDA
    tensors, the plain version for CPU ones.  No backward."""
    if _plain_or_kernel("cheby_dw_fused", x, g=g):
        return cheby_dw_fused_reference(x, L, g, K)
    B, M, F = x.shape
    O = g.shape[2]
    parts, S = _launch(L, x, None, g, K=K, O=O, name="cheby_fused.K3")
    cheby_dw_fused.launches += 1
    return parts.reshape(-1, K, F, S, O).sum(dim=(0, 3))


cheby_dw_fused.launches = 0


class _ChebyConvFused(torch.autograd.Function):
    """K2 forward; dx by K2 with ``W_k^T``, dW by K3 or the stacked basis
    (pallas_cheby.py:183-204).  The operator rides on ctx."""

    @staticmethod
    def forward(ctx, x, L, w):
        ctx.save_for_backward(x, w)
        ctx.L = L
        with record_function("cheby_conv_fused.forward"):
            return L.fused_filter(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        L = ctx.L
        K, F, O = w.shape
        dx = dw = None
        if ctx.needs_input_grad[0]:
            with record_function("cheby_conv_fused.dx"):
                dx = L.fused_filter(g, w.transpose(1, 2).contiguous()).to(
                    x.dtype)
        if ctx.needs_input_grad[2]:
            with record_function("cheby_conv_fused.dW"):
                if _dw_eligible(F, O):
                    dw = L.fused_dw(x, g, K)
                else:
                    from cnn_graph_tpu_torch.ops.filters import cheby_basis

                    basis = cheby_basis(x, L, K)
                    with full_f32_matmul():
                        dw = torch.einsum("kbmf,bmo->kfo",
                                          basis.to(torch.float32),
                                          g.to(torch.float32))
            dw = dw.to(w.dtype)
        return dx, None, dw


def cheby_conv_fused(x: torch.Tensor, L, w: torch.Tensor) -> torch.Tensor:
    """Fused Chebyshev conv on a DenseLaplacian: ``x`` ``[B, M, F]``, ``w``
    ``[K, F, O]`` -> ``[B, M, O]``, differentiable in ``x`` and ``w``.
    The JAX signature's ``col_tile`` chose the TPU's tile; the CUDA
    kernel picks its own, so only ``cheby_conv``'s eligibility rule
    keeps a tile width."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ChebyConvFused.apply(x, L, w)
    with record_function("cheby_conv_fused.forward"):
        return L.fused_filter(x, w)


cheby_conv_fused.launches = 0
