"""Spectral graph convolutions: Chebyshev, Lanczos and Fourier.

Counterpart of ``cnn_graph_tpu/ops/filters.py``: ``cheby_conv`` (:323)
with the same dispatch (:344-378) and fused-kernel eligibility rule
``_fused_eligible`` (:47), ``cheby_conv_banded`` (:180-320) with
its streaming forward and fused adjoint backward, the int8 streaming
conv (:74), the stacked ``cheby_basis`` (:138) of the dense path and,
for the sharded operators, its one-call ``cheby_chain`` and int8 basis
(:106); the Lanczos filter ``lanczos_basis_device`` (:381) and
``lanczos_conv`` (:446), whose ``L @ v`` products go through the
operator's ``matmul`` (a banded or BSR operator's kernel on the card);
``cheby_weights_from_flat`` (:466); and the Fourier filter
``fourier_conv`` (:473), three dense contractions with the eigenbasis
U, plain ``torch.einsum`` as the JAX package leaves them to XLA.
Activations are ``[B, M, F]``, Chebyshev and Lanczos weights ``[K,
Fin, Fout]``, Fourier weights ``[M, Fout, Fin]``.

The per-tap products ``T_k x W_k`` and dW are plain ``torch.matmul``s on
f32-upcast operands, accumulated in f32, as the JAX package's taps
accumulate in f32; the backward's injections ``g W_k^T`` run in the
operator's compute dtype, as in JAX.

Every Chebyshev recurrence here holds its carries in one layout,
``ops/cheby.py _rows``'s batch-major ``[rows, B*F]`` columns, and in one
codec chosen once per conv from the operator (``_carries``): float
carries in its compute dtype, or int8 carries on one run-time scale.
One streaming loop (``_ccb_forward``) and one stacked basis
(``cheby_basis``) serve both kinds.

Spans (``utils/profiling.py``): ``cheby_conv`` opens ``conv.<route>``
(``banded``, ``quant_stream``, ``fused``, ``stacked``); the tap work is
timed on the card in ``conv.taps`` (each hop's tap with its operand's
cast and the sum into y, or the stacked contraction), ``conv.dW`` (the
banded backward's dW) and ``conv.injections`` (its ``g W_k^T``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.ops.cheby import (
    _rows,
    _unrows,
    cheby_conv_fused,
    fused_vmem_ok,
)
from cnn_graph_tpu_torch.ops.laplacian import BandedLaplacian
from cnn_graph_tpu_torch.utils.profiling import span

__all__ = ["cheby_basis", "cheby_conv", "cheby_conv_banded",
           "cheby_weights_from_flat", "fourier_conv", "lanczos_basis_device",
           "lanczos_conv"]


def _fused_eligible(L, fin: int, fout: int, col_tile: int = 512) -> bool:
    """Whether a conv takes the fused kernels: the JAX package's rule word
    for word (whole samples per 128-lane-aligned tile, both directions
    since dx runs K2 with the taps transposed, and the VMEM budget).  It
    was tuned on a TPU and is kept for parity: to be re-tuned on Hopper,
    where the kernel picks its own tile."""
    for a, b in ((fin, fout), (fout, fin)):
        if a > col_tile:
            return False
        s = max(col_tile // a, 1)
        if (s * a) % 128 != 0 or (s * b) % 128 != 0 or s * b > 2048:
            return False
        if not fused_vmem_ok(L.m_padded, L.compute_dtype, col_tile=s * a):
            return False
    return True


class _FloatCarries:
    """Float carries in the operator's compute dtype: ``first`` is ``L
    x``, ``hop`` ``2 L x1 - x0``, ``chain`` the operator's one-call
    stacked basis (or None).  ``decode`` reads a carry as it is; whoever
    reads it casts it."""

    def __init__(self, L):
        self.dtype = L.compute_dtype
        self.first, self.hop = L.matmul, L.cheby_hop
        self.chain = getattr(L, "cheby_chain", None)

    def encode(self, xt: torch.Tensor) -> torch.Tensor:
        return xt.to(self.dtype)

    def decode(self, c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return c


class _Int8Carries:
    """Int8 carries (JAX filters.py:74-131) on one activation scale from
    ``max|x|`` at run time, so no calibration pass is needed; over every
    rank's rows of a sharded operator, an ``all_reduce(MAX)`` over
    ``nodes``.  ``encode`` quantizes, ``decode`` dequantizes to
    ``dtype``; ``first``, ``hop`` and ``chain`` are the operator's int8
    products.  Inference only: ``quantize`` raises under a gradient."""

    def __init__(self, L):
        self.L = L
        self.first, self.hop = L.spmm_q, L.cheby_hop_q
        self.chain = getattr(L, "cheby_chain_q", None)

    def encode(self, xt: torch.Tensor) -> torch.Tensor:
        L = self.L
        xt = xt.to(torch.float32)
        amax = xt.abs().amax()
        if getattr(L, "mesh", None) is not None:
            amax = L.mesh.all_reduce(amax.reshape(1), "nodes", "max")[0]
        self.scale = torch.clamp_min(amax, 1e-30) * torch.tensor(
            L.headroom / 127.0, dtype=torch.float32)
        return L.quantize(xt, scale=self.scale)

    def decode(self, q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.L.dequantize(q, dtype, scale=self.scale)


def _carries(L):
    """The carry codec of one conv on ``L``: int8 where the operator has
    ``cheby_hop_q``, else float."""
    return (_Int8Carries if hasattr(L, "cheby_hop_q") else _FloatCarries)(L)


def _ccb_forward(x: torch.Tensor, L, w: torch.Tensor, keep: bool):
    """Streaming taps ``y += T_k x W_k`` over the recurrence, in ``_rows``'
    ``[Mp, B*F]`` columns, on the float banded operator or any single-chip
    int8 one.  Each hop's tap reads its carry in f32: an int8 carry
    dequantized (its own span) before ``conv.taps``, a float one cast
    inside it.  ``keep``: also return the K carries as a list (for the
    backward; a ``torch.stack`` would copy them all), else only two
    rolling carries stay live."""
    K, Fin, Fout = w.shape
    B, M, F = x.shape
    if F != Fin:
        raise ValueError(f"feature mismatch: x has {F}, w expects {Fin}")
    codec = _carries(L)
    prev, cur = None, codec.encode(_rows(x, L))
    wc = w.to(torch.float32)
    y = torch.zeros((B, M, Fout), dtype=torch.float32, device=x.device)
    carries = []
    with full_f32_matmul():
        for k in range(K):
            if k == 1:
                prev, cur = cur, codec.first(cur)
            elif k >= 2:
                prev, cur = cur, codec.hop(cur, prev)
            if keep:
                carries.append(cur)
            tap = codec.decode(cur[:M], torch.float32)
            with span("conv.taps", device=True):
                tap = tap.reshape(M, B, F).to(torch.float32)
                y = y + torch.einsum("mbf,fo->bmo", tap, wc[k])
    return y.to(x.dtype), carries


class _ChebyConvBanded(torch.autograd.Function):
    """The banded conv with the fused three-term adjoint backward
    (filters.py:180-320).  The operator and ``input_grad`` ride on ctx."""

    @staticmethod
    def forward(ctx, x, L, w, input_grad):
        y, carries = _ccb_forward(x, L, w, keep=True)
        ctx.save_for_backward(w, *carries)
        ctx.L, ctx.input_grad, ctx.x_dtype = L, input_grad, x.dtype
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        w, *S = ctx.saved_tensors
        K, Fin, _ = w.shape
        B, M, _ = g.shape
        dx = dw = None
        if ctx.needs_input_grad[2]:
            # dW[k, f, o] = sum_{b, m} S[k, m, b, f] g[b, m, o], per hop.
            with full_f32_matmul(), span("conv.dW", device=True):
                gc = g.to(torch.float32)
                dws = []
                for k in range(K):
                    tap = S[k][:M].reshape(M, B, Fin).to(torch.float32)
                    dws.append(torch.einsum("mbf,bmo->fo", tap, gc))
                dw = torch.stack(dws).to(w.dtype)
        if ctx.input_grad and ctx.needs_input_grad[0]:
            dx = _unrows(_ccb_adjoint(ctx.L, g, w), B, M, Fin).to(
                ctx.x_dtype)
        return dx, None, dw, None


def _ccb_adjoint(L, g, w):
    """``dx`` in the kernel layout ``[M, B*Fin]`` by the adjoint recurrence

        s_{K-1} = c_{K-1},  s_{K-2} = 2 L s_{K-1} + c_{K-2},
        s_k     = 2 L s_{k+1} - s_{k+2} + c_k,      c_k = g W_k^T
        dx      = s_0 = c_0 + L s_1 - s_2

    with one fused ``cheby_hop_c`` kernel pass per hop (filters.py
    :288-312)."""
    K, Fin, _ = w.shape
    B, M, _ = g.shape
    cdt = L.compute_dtype
    with full_f32_matmul(), span("conv.injections", device=True):
        gcd, wcd = g.to(cdt), w.to(cdt)
        # Each c_k made node-major, so that _rows' permutation is a view.
        C = [_rows(torch.einsum("bmo,fo->mbf", gcd, wcd[k]).transpose(0, 1),
                   L) for k in range(K)]
    if K == 1:
        s0 = C[0]
    elif K == 2:
        s0 = C[0] + L.matmul(C[1])
    else:
        # s_{K-2} = 2 L s_{K-1} + c_{K-2}: a hop against a zero x0.
        s_next = L.cheby_hop_c(C[K - 1], torch.zeros_like(C[K - 1]),
                               C[K - 2])
        s_next2 = C[K - 1]
        for k in range(K - 3, 0, -1):
            s_next, s_next2 = L.cheby_hop_c(s_next, s_next2, C[k]), s_next
        s0 = C[0] + L.matmul(s_next) - s_next2
    return s0[:M]


def cheby_conv_banded(x: torch.Tensor, L: BandedLaplacian, w: torch.Tensor,
                      input_grad: bool = True) -> torch.Tensor:
    """Chebyshev conv on a banded operator: the streaming forward and,
    when a gradient is needed, a ``torch.autograd.Function`` whose
    backward is the fused adjoint recurrence (``_ccb_adjoint``) plus dW
    streamed per hop in f32.  The forward then keeps the K carries in
    the compute dtype; otherwise only two rolling carries stay live.

    The dx contract: with ``input_grad=False`` (a first-layer conv over
    raw data) the backward skips the adjoint chain and returns no
    gradient for ``x`` (``None``, never zeros): ``x.grad`` stays ``None``
    and the K-1 hops are never run.  The JAX package returns exact zeros
    there instead (node_classifier.py:36-46)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ChebyConvBanded.apply(x, L, w, input_grad)
    return _ccb_forward(x, L, w, keep=False)[0]


def cheby_basis(x: torch.Tensor, L, K: int) -> torch.Tensor:
    """Stacked Chebyshev basis ``T_k(L) x`` for k < K: ``[B, M, F]`` ->
    ``[K, B, M, F]``, in the operator's compute dtype, or, on int8 carries
    (JAX filters.py:106-131), dequantized once to x's dtype.  Sharded
    operators run it as one ``cheby_chain`` (``cheby_chain_q``) where they
    have one (JAX filters.py:138-177)."""
    B, M, F = x.shape
    codec = _carries(L)
    t0 = codec.encode(_rows(x, L))
    if codec.chain is not None:
        stacked = codec.chain(t0, K)
    else:
        basis = [t0]
        if K > 1:
            basis.append(codec.first(t0))
        for _ in range(2, K):
            basis.append(codec.hop(basis[-1], basis[-2]))
        stacked = torch.stack(basis)
    return _unrows(codec.decode(stacked[:, :M], x.dtype), B, M, F)


def cheby_conv(x: torch.Tensor, L, w: torch.Tensor,
               input_grad: bool = True) -> torch.Tensor:
    """Chebyshev spectral graph convolution ``y = sum_k T_k(L) x W_k``.

    ``x``: ``[B, M, Fin]``, ``w``: ``[K, Fin, Fout]`` -> ``[B, M, Fout]``.
    Banded operators take ``cheby_conv_banded``; single-chip quantized
    operators the same streaming loop on int8 carries (inference only),
    sharded ones the stacked int8 basis of ``cheby_chain_q``; dense
    operators built with ``use_fused`` the fused kernels where
    ``_fused_eligible`` holds (tile 512 for f32 operators, 256 otherwise,
    as in JAX);
    everything else (block-sparse operators included) the stacked basis
    and one tap contraction, differentiated by torch.
    ``input_grad=False`` declares that no gradient for ``x`` is consumed;
    only the banded path uses it (see ``cheby_conv_banded``).
    """
    K, Fin, Fout = w.shape
    B, M, F = x.shape
    if F != Fin:
        raise ValueError(f"feature mismatch: x has {F}, w expects {Fin}")
    if isinstance(L, BandedLaplacian):
        with span("conv.banded"):
            return cheby_conv_banded(x, L, w, input_grad)
    if hasattr(L, "cheby_hop_q") and not hasattr(L, "cheby_chain_q"):
        with span("conv.quant_stream"):
            return _ccb_forward(x, L, w, keep=False)[0]
    fused_tile = 512 if L.compute_dtype == torch.float32 else 256
    if getattr(L, "use_fused", False) and _fused_eligible(
            L, Fin, Fout, col_tile=fused_tile):
        with span("conv.fused"):
            return cheby_conv_fused(x, L, w)
    with span("conv.stacked"):
        basis = cheby_basis(x, L, K)
        with full_f32_matmul(), span("conv.taps", device=True):
            return stacked_taps(basis, w, x.dtype)


def stacked_taps(basis: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The stacked route's tap contraction ``sum_k basis[k] W_k``:
    ``[K, B, M, F]`` x ``[K, F, O]`` -> ``[B, M, O]`` in ``out_dtype``.
    As JAX's ``einsum(basis, w.astype(basis.dtype),
    preferred_element_type=x.dtype)`` (filters.py:373-378): w is rounded
    to the basis dtype first, and a bf16 (or f16) basis with f32
    activations is contracted in f32 (``_NarrowTaps``), so the products
    of the bf16 values are summed and returned unrounded."""
    if (basis.dtype in (torch.bfloat16, torch.float16)
            and out_dtype == torch.float32):
        return _NarrowTaps.apply(basis, w)
    return torch.einsum("kbmf,kfo->bmo", basis,
                        w.to(basis.dtype)).to(out_dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of narrow operands, summed and returned in f32: on the
    card one ``torch.mm(..., out_dtype=float32)``, which reads the
    operands as they are (the CPU build refuses it); on the CPU on f32
    copies."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _NarrowTaps(torch.autograd.Function):
    """``sum_k basis[k] W_k`` for a narrow basis, in f32: one product per
    k, accumulated into one f32 output, with no f32 copy of the basis
    (at the 50k scattered request the copy took 7.7 ms of device time
    where the K products take 0.75; ``tools/stacked_contract.py``).
    ``torch.mm``'s ``out_dtype`` form has no derivative, so the backward
    is written out, and gives the gradients of the upcast einsum: the
    basis's rounded to its dtype, W's rounded to the basis dtype (JAX's
    cotangent through ``w.astype``)."""

    @staticmethod
    def forward(ctx, basis, w):
        K, B, M, F = basis.shape
        wb = w.to(basis.dtype)
        y = _mm_f32(basis[0].reshape(B * M, F), wb[0])
        for k in range(1, K):
            y += _mm_f32(basis[k].reshape(B * M, F), wb[k])
        ctx.save_for_backward(basis, wb)
        ctx.w_dtype = w.dtype
        return y.reshape(B, M, -1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        basis, wb = ctx.saved_tensors
        K, B, M, F = basis.shape
        g2 = g.reshape(B * M, -1).to(torch.float32)
        d_basis = d_w = None
        with full_f32_matmul():
            if ctx.needs_input_grad[0]:
                d_basis = torch.stack([
                    (g2 @ wb[k].to(torch.float32).t()).to(basis.dtype)
                    for k in range(K)]).reshape(K, B, M, F)
            if ctx.needs_input_grad[1]:
                d_w = torch.stack([
                    basis[k].reshape(B * M, F).to(torch.float32).t() @ g2
                    for k in range(K)]).to(basis.dtype).to(ctx.w_dtype)
        return d_basis, d_w


def lanczos_basis_device(x: torch.Tensor, L, K: int,
                         eps: float = 1e-12) -> torch.Tensor:
    """Per-signal K-step Lanczos basis, ``[B, M, F]`` -> ``[K, B, M, F]``:
    K-step Lanczos on every signal column (``_rows``' ``B*F`` columns,
    one wide ``L @ V`` product per step through the operator's
    ``matmul``), one
    batched ``torch.linalg.eigh`` of the N tridiagonal ``K x K``
    matrices, and the rotation back.  The orthogonalisation runs in f32,
    the products in the operator's compute dtype.  A breakdown (``b_k <=
    eps``) zeroes the remaining directions.  The eigenvectors' signs
    cancel (each basis vector carries its column twice).  Differentiable;
    the gradient through ``eigh`` is undefined at degenerate Ritz values,
    as in JAX."""
    B, M, F = x.shape
    cdt = getattr(L, "compute_dtype", x.dtype)
    xt = _rows(x, L).to(torch.float32)
    N = B * F

    def lmul(v):
        return L.matmul(v.to(cdt)).to(torch.float32)

    norms = torch.linalg.vector_norm(xt, dim=0)
    V = [xt / norms.clamp_min(eps)]
    a, b = [], [xt.new_zeros(N)]
    for k in range(K - 1):
        w = lmul(V[k])
        a.append((w * V[k]).sum(0))
        w = w - a[k] * V[k] - (b[k] * V[k - 1] if k > 0 else 0.0)
        bk = torch.linalg.vector_norm(w, dim=0)
        b.append(bk)
        V.append(torch.where(bk > eps, w / bk.clamp_min(eps), 0.0))
    a.append((lmul(V[K - 1]) * V[K - 1]).sum(0))

    H = torch.diag_embed(torch.stack(a, dim=1))           # [N, K, K]
    if K > 1:
        off = torch.stack(b[1:], dim=1)                    # [N, K-1]
        H = H + torch.diag_embed(off, -1) + torch.diag_embed(off, 1)
    Q = torch.linalg.eigh(H)[1]                            # [N, K, K]
    with full_f32_matmul():
        Xt = torch.einsum("njk,jmn->kmn", Q, torch.stack(V))
    Xt = Xt * Q[:, 0, :].t()[:, None, :] * norms
    return _unrows(Xt, B, M, F).to(x.dtype)


def lanczos_conv(x: torch.Tensor, L, w: torch.Tensor) -> torch.Tensor:
    """Lanczos-basis spectral graph convolution ``y = sum_k (Lanczos_k x)
    W_k``: ``x`` ``[B, M, Fin]``, ``w`` ``[K, Fin, Fout]`` -> ``[B, M,
    Fout]``, the taps one contraction as in ``cheby_conv``."""
    K, Fin, Fout = w.shape
    if x.shape[2] != Fin:
        raise ValueError(f"feature mismatch: x has {x.shape[2]}, w expects "
                         f"{Fin}")
    basis = lanczos_basis_device(x, L, K)
    with full_f32_matmul():
        return torch.einsum("kbmf,kfo->bmo", basis,
                            w.to(basis.dtype)).to(x.dtype)


def cheby_weights_from_flat(w_flat: torch.Tensor, K: int,
                            Fin: int) -> torch.Tensor:
    """The reference's ``[K*Fin, Fout]`` weights (Fin-major: row ``fin*K +
    k``, graph_conv.py:171-174) as ``[K, Fin, Fout]``."""
    return w_flat.reshape(Fin, K, w_flat.shape[1]).permute(1, 0, 2)


def fourier_conv(x: torch.Tensor, U: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Non-parametric spectral filter in the full Fourier basis: ``x`` ``[B,
    M, Fin]``, ``U`` ``[M, M]`` (eigenvectors as columns, eigenvalues
    ascending), ``w`` ``[M, Fout, Fin]`` -> ``U (W_lambda . (U^T x))``,
    ``[B, M, Fout]`` (lib/filter.py:11-27)."""
    with full_f32_matmul():
        xhat = torch.einsum("ml,bmf->blf", U, x)
        filtered = torch.einsum("lof,blf->blo", w, xhat)
        return torch.einsum("ml,blo->bmo", U, filtered)
