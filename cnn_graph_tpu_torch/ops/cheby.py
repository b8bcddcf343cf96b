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
  by plain sums (``_fold_dw_partials``), as the JAX package folds its
  tiles (:304-305).

Both are one kernel template in ``csrc/cheby_fused.cu``, whose tap kind
(K2's or K3's) is a template parameter.  Beside each is its plain
PyTorch version (``cheby_conv_fused_reference``, ``cheby_dw_fused_
reference``), which computes what the TPU kernel computes in its
precision: float32 carries; for a bfloat16 operator the operands of
every product (L, the carry, W_k, g) rounded to bfloat16 and the sums in
float32, and K3's per-(sample, hop) partial rounded to bfloat16 once.
(The stacked path's ``cheby_basis`` keeps bfloat16 carries instead.)
The wrappers check their arguments and call the custom ops
``cnn_graph_torch::cheby_conv`` and ``cheby_dw`` (``ops/library.py``) on
the operator's matrix: their CUDA implementations launch the kernel and
count it on ``cheby_conv_fused.launches`` and
``cheby_dw_fused.launches`` (views of the recorder's counters,
``utils/profiling.py Counted``) inside the spans ``cheby_fused.K2`` and
``cheby_fused.K3``, their CPU implementations are the plain versions.
The operator's ``fused_filter`` and ``fused_dw`` methods call the
wrappers, so an operator may substitute either.

Both wrappers lay the columns out by cluster (``conv_geometry``: groups
of ``128 // F`` samples).  K2's expands each ``W_k`` block-diagonally
over a group's samples, as ``expand_tap_weights`` (the TPU's lane fill)
does, so that a group taps in one product; K3's lays g out by the same
groups, its tap's other operand.  ``zero_cotangent`` has no
counterpart: the operator is not a differentiable argument.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch
import torch.nn.functional as nnf
from torch.autograd.function import once_differentiable

from cnn_graph_tpu_torch import _build
from cnn_graph_tpu_torch.ops.band import full_f32_matmul
from cnn_graph_tpu_torch.utils.profiling import counted, span

__all__ = [
    "cheby_conv_fused",
    "cheby_conv_fused_reference",
    "cheby_dw_fused",
    "cheby_dw_fused_reference",
    "conv_geometry",
    "conv_resources",
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


def _rows(x: torch.Tensor, L=None) -> torch.Tensor:
    """``[B, M, F]`` as every Chebyshev recurrence lays its carries out:
    ``[rows, B*F]``, batch-major columns (column ``b*F + f``).  With an
    operator ``L`` the node axis is zero-padded to its ``m_padded`` rows
    (by ``torch.cat``, which writes each byte once); a node-sharded
    operator (``rows_per_shard``) takes this rank's rows, ``M =
    rows_per_shard``, and those past the graph's last node are zeroed,
    as JAX's slice to ``M`` and zero padding leave them.  A view of
    ``x`` where nothing moves (``B`` or ``F`` is 1 and no row is
    padded).  ``_unrows`` is its inverse."""
    B, M, F = x.shape
    rows = M
    if L is not None:
        rows = getattr(L, "rows_per_shard", None)
        if rows is None:
            rows = L.m_padded
        elif M != rows:
            raise ValueError(f"a node-sharded operator takes this rank's "
                             f"{rows} rows; x has {M}")
        else:
            x = x[:, :L.real_rows]
    xt = x.permute(1, 0, 2).reshape(x.shape[1], B * F)
    if xt.shape[0] == rows:
        return xt
    return torch.cat([xt, xt.new_zeros((rows - xt.shape[0], B * F))])


def _unrows(t: torch.Tensor, B: int, M: int, F: int) -> torch.Tensor:
    """``_rows``'s inverse, a view: ``[..., rows, B*F]`` -> ``[..., B, M,
    F]``."""
    return t[..., :M, :].unflatten(-1, (B, F)).transpose(-3, -2)


def _columns(x: torch.Tensor, m_padded: int) -> torch.Tensor:
    """``_rows`` of ``x`` as a contiguous f32 ``[Mp, B*F]``, the fused
    kernels' input and their plain versions'.  Padded by ``nnf.pad``:
    on the card its copy of the contiguous rows is a memcpy, not a
    kernel launch."""
    xt = _rows(x).to(torch.float32)
    return nnf.pad(xt, (0, 0, 0, m_padded - xt.shape[0])).contiguous()


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
def _lib():
    lib = _build.load("cheby_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cheby_conv_launch.argtypes = [p] * 7 + [i] * 13 + [p]
    lib.cheby_dw_launch.argtypes = [p] * 7 + [i] * 13 + [p]
    lib.cheby_resident_clusters.argtypes = [i] * 5
    lib.cheby_smem_bytes.argtypes = [i] * 3
    for f in (lib.cheby_conv_launch, lib.cheby_dw_launch,
              lib.cheby_resident_clusters, lib.cheby_smem_bytes):
        f.restype = i
    return lib


# The depth of the cp.async ring the wrappers launch.  The library holds
# 2- and 3-stage instantiations of both kernels; tools/ring_depth.py times
# them against each other.
RING_STAGES = 3
_TAPS = {"K2": 0, "K3": 1}  # the kernel template's tap kind

# The kernels' geometry (csrc/cheby_fused.cu cheby_conv_kernel): a CTA
# tile is at most 128 columns wide; clusters of at most 8 CTAs (the
# portable limit).
_TILE_COLS = 128
_MAX_CLUSTER = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv_geometry(B: int, mp: int, F: int, O: int, n_sms: int) -> dict:
    """K2's and K3's launch geometry, a pure function of the shapes (x
    ``[B, mp, F]``; w ``[K, F, O]`` or g ``[B, mp, O]``) and the card's
    ``n_sms``.

    ``samples`` whole samples per column group (``128 // F``, at least
    one, at most ``B``), ``groups`` of them; each group's columns padded
    to ``np`` (carries) and ``nop`` (outputs), multiples of 8.  One
    cluster of ``cluster`` CTAs per group splits the ``mp`` rows into
    ``rows`` -row tiles (128, or 64 where 128-row tiles would give fewer
    CTAs than ``n_sms``), ``tiles_per_cta`` consecutive tiles each:
    CTA ``c`` of group ``g`` owns rows ``[c * tiles_per_cta * rows,
    (c + 1) * tiles_per_cta * rows)`` of columns ``[g * np, (g + 1) *
    np)``."""
    S = min(B, max(1, _TILE_COLS // F))
    G = -(-B // S)
    rows = 128
    if G * min(_MAX_CLUSTER, -(-mp // 128)) < n_sms:
        rows = 64
    tiles = -(-mp // rows)
    cluster = min(_MAX_CLUSTER, tiles)
    per = -(-tiles // cluster)
    cluster = -(-tiles // per)
    return {"samples": S, "groups": G, "np": _round_up(S * F, 8),
            "nop": _round_up(S * O, 8), "rows": rows, "cluster": cluster,
            "tiles_per_cta": per, "ctas": cluster * G}


def conv_resources(rows: int, dtype, cluster: int,
                   kernel: str = "K2") -> dict:
    """What the built ``kernel`` (K2 or K3) the wrappers launch, for
    ``rows``-row tiles and a ``dtype`` operator, asks of the card:
    ``smem``, one CTA's dynamic shared memory in bytes, and
    ``resident_clusters``, how many clusters of ``cluster`` CTAs the
    current CUDA device holds at once (negative: a CUDA error)."""
    lib, code = _lib(), _DTYPE_CODE[dtype]
    return {"smem": lib.cheby_smem_bytes(rows, RING_STAGES, code),
            "resident_clusters": lib.cheby_resident_clusters(
                _TAPS[kernel], cluster, rows, RING_STAGES, code)}


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_operator(L, x, name: str, *others):
    mat = L.mat
    if mat.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: no kernel for a {mat.dtype} operator")
    if (mat.device != x.device or not mat.is_contiguous()
            or tuple(mat.shape) != (L.m_padded, L.m_padded)
            or mat.data_ptr() % 16):
        raise ValueError(f"{name}: the operator must be a contiguous, "
                         f"16-byte aligned [Mp, Mp] matrix on {x.device}")
    if x.shape[1] > L.m_padded:
        raise ValueError(f"{name}: {x.shape[1]} nodes for a {L.m_padded}-"
                         "node operator")
    if any(t.device != x.device for t in others):
        raise ValueError(f"{name}: every tensor must be on {x.device}")


def _grouped(t: torch.Tensor, mp: int, S: int, G: int,
             width: int) -> torch.Tensor:
    """``[B, M, C]`` -> f32 ``[G, mp, width]``: the batch-major columns of
    ``S`` samples per group, node axis and columns zero-padded."""
    B, _, C = t.shape
    tg = nnf.pad(_columns(t, mp).reshape(mp, B, C),
                 (0, 0, 0, G * S - B)).reshape(mp, G, S * C)
    return nnf.pad(tg, (0, width - S * C)).permute(1, 0, 2).contiguous()


def _hop_operator(L) -> torch.Tensor:
    """The operator as the kernels' hop reads it: L in bf16; the f32 hop
    reads its A operand transposed, so it is given ``L^T`` (one copy per
    call), and L need not be symmetric."""
    return L.mat.t().contiguous() if L.mat.dtype == torch.float32 else L.mat


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch_conv(L, x: torch.Tensor, w: torch.Tensor,
                 stages: int = RING_STAGES) -> torch.Tensor:
    """One launch of K2 on CUDA tensors: ``[B, M, O]`` f32."""
    _check_operator(L, x, "cheby_fused.K2", w)
    B, M, F = x.shape
    K, _, O = w.shape
    mp = L.m_padded
    dt = L.mat.dtype
    geo = conv_geometry(B, mp, F, O, _sms(x.device.index or 0))
    S, G, np_, nop = geo["samples"], geo["groups"], geo["np"], geo["nop"]
    xg = _grouped(x, mp, S, G, np_)
    # T_0 as the tap reads it: rounded (bf16) or transposed (f32).
    xc = (xg.transpose(1, 2).contiguous() if dt == torch.float32
          else xg.to(dt))
    # Each hop's tap weights, block-diagonal over the group's samples.
    eye = torch.eye(S, dtype=torch.float32, device=x.device)
    wbd = torch.einsum("st,kfo->ksfto", eye, w.to(torch.float32))
    wbd = nnf.pad(wbd.reshape(K, S * F, S * O),
                  (0, nop - S * O, 0, np_ - S * F)).to(dt).contiguous()
    mat = _hop_operator(L)
    y = torch.empty(G, mp, nop, dtype=torch.float32, device=x.device)
    carry = torch.empty(G, 2, mp, np_, dtype=torch.float32, device=x.device)
    carryc = torch.empty_like(carry, dtype=dt)  # f32: [G, 2, np, mp]
    with torch.cuda.device(x.device), span("cheby_fused.K2"):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cheby_conv_launch(
            mat.data_ptr(), xg.data_ptr(), xc.data_ptr(), wbd.data_ptr(),
            y.data_ptr(), carry.data_ptr(), carryc.data_ptr(), mp, K, np_,
            nop, S, F, O, G, geo["cluster"], geo["rows"],
            geo["tiles_per_cta"], stages, _DTYPE_CODE[dt], stream)
    _raise_on(rc, "cheby_fused.K2")
    y = y[:, :M, :S * O].reshape(G, M, S, O).permute(0, 2, 1, 3)
    return y.reshape(G * S, M, O)[:B]


def _launch_dw(L, x: torch.Tensor, g: torch.Tensor, K: int,
               stages: int = RING_STAGES) -> torch.Tensor:
    """One launch of K3 on CUDA tensors, on K2's geometry: the per-rank
    partials ``[G, CL, K, S, O, F]`` f32, rank ``c`` of a group's cluster
    summing ``g[m, s*O + o] T_k[m, s*F + f]`` over its rows ``m``."""
    _check_operator(L, x, "cheby_fused.K3", g)
    B, M, F = x.shape
    O = g.shape[2]
    mp = L.m_padded
    dt = L.mat.dtype
    geo = conv_geometry(B, mp, F, O, _sms(x.device.index or 0))
    S, G, np_, nop = geo["samples"], geo["groups"], geo["np"], geo["nop"]
    xg = _grouped(x, mp, S, G, np_)
    gg = _grouped(g, mp, S, G, nop)
    carry = torch.empty(G, 2, mp, np_, dtype=torch.float32, device=x.device)
    if dt == torch.float32:
        # The f32 tap reads the carry as its A^T and g as its B: no
        # copies.
        xc = carryc = None
    else:
        # T_0 and g^T rounded once, and the rounded carries' scratch.
        xc, gg = xg.to(dt), gg.transpose(1, 2).to(dt).contiguous()
        carryc = torch.empty_like(carry, dtype=dt)
    parts = torch.empty(G, geo["cluster"], K, S, O, F, dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device), span("cheby_fused.K3"):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cheby_dw_launch(
            _hop_operator(L).data_ptr(), xg.data_ptr(),
            None if xc is None else xc.data_ptr(), gg.data_ptr(),
            parts.data_ptr(), carry.data_ptr(),
            None if carryc is None else carryc.data_ptr(), mp, K, np_, nop,
            S, F, O, G, geo["cluster"], geo["rows"], geo["tiles_per_cta"],
            stages, _DTYPE_CODE[dt], stream)
    _raise_on(rc, "cheby_fused.K3")
    return parts


def _fold_dw_partials(parts: torch.Tensor, dtype) -> torch.Tensor:
    """K3's fold: per-rank partials ``[G, CL, K, S, O, F]`` -> f32 dW
    ``[K, F, O]``.  The ranks are summed in f32 first, so that each
    (sample, hop) sum runs over all the nodes before it is rounded to the
    operator's ``dtype``, as the TPU rounds ``P * diag_mask``; then the
    groups and samples are summed in f32."""
    per_sample = _rounder(dtype)(parts.sum(1))  # [G, K, S, O, F]
    return per_sample.sum((0, 2)).transpose(1, 2).contiguous()


def _check_call(name: str, x: torch.Tensor, w=None, g=None):
    """Check a wrapper's arguments from their metadata: no gradient
    wanted, the shapes, and a CPU (plain version) or CUDA (kernel)
    ``x``."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def dense_view(mat: torch.Tensor):
    """A dense operator as the kernels and their plain versions read it,
    from its ``[Mp, Mp]`` matrix alone: what the custom ops receive."""
    return types.SimpleNamespace(mat=mat, m_padded=mat.shape[0],
                                 compute_dtype=mat.dtype)


def conv_kernel(mat, x, w) -> torch.Tensor:
    """K2's launch, counted: the CUDA implementation of
    ``cnn_graph_torch::cheby_conv``."""
    y = _launch_conv(dense_view(mat), x, w)
    cheby_conv_fused.launched()
    return y.to(x.dtype)


def dw_kernel(mat, x, g, K: int) -> torch.Tensor:
    """K3's launch, counted, and its fold: the CUDA implementation of
    ``cnn_graph_torch::cheby_dw``."""
    parts = _launch_dw(dense_view(mat), x, g, K)
    cheby_dw_fused.launched()
    with span("cheby_fused.K3.fold"):
        return _fold_dw_partials(parts, mat.dtype)


def fused_filter(x: torch.Tensor, L, w: torch.Tensor) -> torch.Tensor:
    """K2: ``sum_k T_k(L) x W_k`` for ``x`` ``[B, M, F]`` and ``w`` ``[K,
    F, O]`` on a DenseLaplacian -> ``[B, M, O]`` in x's dtype.  The
    kernel for CUDA tensors, the plain version for CPU ones.  No
    backward: ``cheby_conv_fused`` differentiates it."""
    _check_call("fused_filter", x, w=w)
    return torch.ops.cnn_graph_torch.cheby_conv(L.mat, x, w)


@counted("cheby_dw_fused")
def cheby_dw_fused(x: torch.Tensor, L, g: torch.Tensor,
                   K: int) -> torch.Tensor:
    """K3: ``dW[k, f, o] = sum_{b, m} (T_k x)[b, m, f] g[b, m, o]`` as f32
    ``[K, F, O]`` without storing the basis.  The kernel for CUDA
    tensors, the plain version for CPU ones.  No backward."""
    _check_call("cheby_dw_fused", x, g=g)
    return torch.ops.cnn_graph_torch.cheby_dw(L.mat, x, g, K)


class _ChebyConvFused(torch.autograd.Function):
    """K2 forward; dx by K2 with ``W_k^T``, dW by K3 or the stacked basis
    (pallas_cheby.py:183-204).  The operator rides on ctx."""

    @staticmethod
    def forward(ctx, x, L, w):
        ctx.save_for_backward(x, w)
        ctx.L = L
        with span("cheby_conv_fused.forward"):
            return L.fused_filter(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        L = ctx.L
        K, F, O = w.shape
        dx = dw = None
        if ctx.needs_input_grad[0]:
            with span("cheby_conv_fused.dx"):
                dx = L.fused_filter(g, w.transpose(1, 2).contiguous()).to(
                    x.dtype)
        if ctx.needs_input_grad[2]:
            with span("cheby_conv_fused.dW"):
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


@counted("cheby_conv_fused")
def cheby_conv_fused(x: torch.Tensor, L, w: torch.Tensor) -> torch.Tensor:
    """Fused Chebyshev conv on a DenseLaplacian: ``x`` ``[B, M, F]``, ``w``
    ``[K, F, O]`` -> ``[B, M, O]``, differentiable in ``x`` and ``w``.
    The JAX signature's ``col_tile`` chose the TPU's tile; the CUDA
    kernel picks its own, so only ``cheby_conv``'s eligibility rule
    keeps a tile width."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ChebyConvFused.apply(x, L, w)
    with span("cheby_conv_fused.forward"):
        return L.fused_filter(x, w)
