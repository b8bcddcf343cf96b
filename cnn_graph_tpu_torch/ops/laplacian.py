"""Graph Laplacian operators on torch tensors.

Counterpart of ``cnn_graph_tpu/ops/laplacian.py``.  Ported so far:

* ``DenseLaplacian`` (:130): zero-padded ``[Mp, Mp]`` matrix, plain
  ``torch.matmul`` for the stacked path; with ``use_fused`` the conv
  takes the fused kernels K2 and K3 (``ops/cheby.py``).
* ``BandedLaplacian`` (:291): the ragged band in its deep-K-window
  layout, multiplied by the ``band_dkw`` kernel (``ops/band.py``).
* ``QuantBandedLaplacian`` (:409, with ``QuantOpMixin`` :95 folded in)
  and ``quantize_banded`` (:745): the int8 serving twin, same kernel in
  its int8 form.
* ``device_laplacian`` (:1200) with the JAX package's format choice.

Operators are frozen dataclasses of tensors; ``.to(device)`` returns a
copy on another device.  The BSR and BCOO formats raise
``NotImplementedError``: they are ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import torch

from cnn_graph_tpu_torch.graphs import rescale_laplacian
from cnn_graph_tpu_torch.ops import packing
from cnn_graph_tpu_torch.ops.packing import _round_up
from cnn_graph_tpu_torch.ops.band import (
    band_cheby_hop,
    band_cheby_hop_c,
    band_spmm,
    banded_dkw,
)
from cnn_graph_tpu_torch.ops.cheby import cheby_dw_fused, fused_filter

__all__ = [
    "DENSE_THRESHOLD",
    "DenseLaplacian",
    "BandedLaplacian",
    "QuantBandedLaplacian",
    "quantize_banded",
    "device_laplacian",
]

# Auto-format thresholds of the JAX package (laplacian.py:1240-1277),
# tuned on a TPU v5e and kept for parity; to be re-tuned on Hopper.
DENSE_THRESHOLD = 2048  # nodes: dense at or below
_UNPORTED = ("format {!r} is not ported to cnn_graph_tpu_torch yet "
             "(ROADMAP queue 1 item 8)")


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


@dataclasses.dataclass(frozen=True)
class BandedLaplacian:
    """Rescaled Laplacian as a ragged block band in the deep-K-window
    layout: ``bands_dkw[l]`` is ``[n_rows_l, 128, W_l*128]``, block-row r
    multiplies x rows ``[base[r]*128, (base[r]+W_l)*128)``; ``sched_dkw``
    int32 ``[3, nsb]`` gives each G-row step its row offset and level."""

    bands_dkw: tuple
    base: torch.Tensor
    sched_dkw: torch.Tensor
    levels: tuple
    rows_per_step: int
    m: int
    m_padded: int
    nnz: int

    @property
    def compute_dtype(self):
        return self.bands_dkw[0].dtype

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``."""
        return band_spmm(self, x)

    def cheby_hop(self, x1: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        return band_cheby_hop(self, x1, x0)

    def cheby_hop_c(self, x1: torch.Tensor, x0: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
        """The adjoint chain's hop ``2 (L @ x1) - x0 + c``, no backward."""
        return band_cheby_hop_c(self, x1, x0, c)

    def to(self, device) -> BandedLaplacian:
        return dataclasses.replace(
            self, bands_dkw=tuple(b.to(device) for b in self.bands_dkw),
            base=self.base.to(device), sched_dkw=self.sched_dkw.to(device),
        )


@dataclasses.dataclass(frozen=True)
class QuantBandedLaplacian:
    """Int8 banded Laplacian for serving (the int8 protocol of the JAX
    package's ``QuantOpMixin``, :95-121, plus its banded twin).  The band
    carries one global scale ``band_scale = max|L| / 127``; activations
    ride one scale across the recurrence, and the kernel's emission works
    in input-scale units, so that scale never enters the kernel: callers
    may pass a run-time scale to ``quantize``/``dequantize``.  Inference
    only, as the JAX int8 operators are: ``quantize`` raises when a
    gradient would be needed through it."""

    bands_dkw: tuple
    base: torch.Tensor
    sched_dkw: torch.Tensor
    levels: tuple
    rows_per_step: int
    m: int
    m_padded: int
    nnz: int
    band_scale: float
    act_scale: float
    headroom: float = 2.0

    @property
    def compute_dtype(self):
        return torch.int8

    def quantize(self, x: torch.Tensor, scale=None) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                "QuantBandedLaplacian is inference-only (no backward through "
                "int8): run under torch.no_grad()/inference_mode()")
        s = self.act_scale if scale is None else scale
        return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)

    def dequantize(self, q: torch.Tensor, dtype=torch.float32,
                   scale=None) -> torch.Tensor:
        s = self.act_scale if scale is None else scale
        return (q.to(torch.float32) * s).to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Float view: quantize -> int8 SpMM -> dequantize."""
        return self.dequantize(self.spmm_q(self.quantize(x)), x.dtype)

    def _call(self, x_q, x0_q):
        return banded_dkw(self.bands_dkw, self.base, self.sched_dkw, x_q,
                          x0_q, levels=self.levels, G=self.rows_per_step,
                          band_scale=self.band_scale)

    def spmm_q(self, x_q: torch.Tensor) -> torch.Tensor:
        """``quantize(L @ dequantize(x_q))`` in one int8 kernel pass."""
        return self._call(x_q, None)

    def cheby_hop_q(self, x1_q: torch.Tensor,
                    x0_q: torch.Tensor) -> torch.Tensor:
        """Quantized fused recurrence hop ``2 (L @ x1) - x0``."""
        return self._call(x1_q, x0_q)

    def to(self, device) -> QuantBandedLaplacian:
        return dataclasses.replace(
            self, bands_dkw=tuple(b.to(device) for b in self.bands_dkw),
            base=self.base.to(device), sched_dkw=self.sched_dkw.to(device),
        )


def quantize_banded(op: BandedLaplacian, headroom: float = 2.0,
                    sample_x: float = 1.0) -> QuantBandedLaplacian:
    """Quantize a BandedLaplacian for int8 inference.  ``sample_x`` is the
    expected activation max; ``headroom`` widens the activation scale so
    carries that wander above the input range saturate instead of
    wrapping."""
    host = [b.to(torch.float32).cpu().numpy() for b in op.bands_dkw]
    s_b = packing.band_scale_of(host)
    dev = op.base.device
    return QuantBandedLaplacian(
        bands_dkw=tuple(
            torch.from_numpy(packing.quantize_band(b, s_b)).to(dev)
            for b in host),
        base=op.base, sched_dkw=op.sched_dkw, levels=op.levels,
        rows_per_step=op.rows_per_step, m=op.m, m_padded=op.m_padded,
        nnz=op.nnz, band_scale=s_b,
        act_scale=float(sample_x) * headroom / 127.0, headroom=headroom,
    )


def device_laplacian(L: scipy.sparse.spmatrix, lmax: float = 2.0,
                     fmt: str = "auto", dtype=torch.float32, device=None,
                     rows_per_step: int | None = None,
                     dense_budget: int = 2 << 30,
                     use_pallas: bool | None = None):
    """Build a device operator for the rescaled Laplacian ``2 L / lmax - I``.

    ``fmt`` is ``dense``, ``banded`` or ``auto``: dense up to
    ``DENSE_THRESHOLD`` nodes, banded for narrow, reasonably full bands,
    and otherwise dense again above 1/3 block occupancy within
    ``dense_budget`` bytes, else BSR, which is not ported and raises.
    These thresholds are the JAX package's, tuned on a TPU v5e; they are
    kept word for word for parity and are to be re-tuned on Hopper.
    ``rows_per_step`` is the banded layout's G (default ``min(8, block
    rows)``).  ``use_pallas`` keeps the JAX name: a dense operator built
    with it true takes the fused conv kernels (``use_fused``); the banded
    operator always runs its kernel.
    """
    L = rescale_laplacian(L, lmax=lmax).tocsr()
    L.eliminate_zeros()
    m = L.shape[0]
    nnz = int(L.nnz)

    stats = None
    if fmt == "auto":
        if m <= DENSE_THRESHOLD:
            fmt = "dense"
        else:
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

    if fmt == "dense":
        mp = _round_up(m, 8)
        dense = np.zeros((mp, mp), dtype=np.float32)
        dense[:m, :m] = L.toarray()
        return DenseLaplacian(
            mat=torch.from_numpy(dense).to(device=device, dtype=dtype),
            m=m, m_padded=mp, nnz=nnz, use_fused=bool(use_pallas),
        )

    if fmt == "banded":
        band, base, sched, levels, G, mp = packing.pack_banded_ragged(
            L, G=rows_per_step, stats=stats)
        bands, sched_dkw = packing.pack_dkw_from_ragged(band, sched, levels,
                                                        G)
        return BandedLaplacian(
            bands_dkw=tuple(torch.from_numpy(b).to(device=device, dtype=dtype)
                            for b in bands),
            base=torch.from_numpy(base).to(device),
            sched_dkw=torch.from_numpy(sched_dkw).to(device),
            levels=levels, rows_per_step=G, m=m, m_padded=mp, nnz=nnz,
        )

    if fmt in ("bsr", "bcoo"):
        raise NotImplementedError(_UNPORTED.format(fmt))
    raise ValueError(f"unknown Laplacian format {fmt!r}")
