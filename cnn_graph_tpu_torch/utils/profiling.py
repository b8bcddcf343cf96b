"""Step timers, trace capture, device timing by slope fit and the SpMM
rooflines, on an NVIDIA H100.

Counterpart of ``cnn_graph_tpu/utils/profiling.py`` (``slope_time`` :18,
``StepTimer`` :55, ``trace`` :81, ``spmm_roofline`` :117), its own copy:
that module imports JAX.
``sparse_roofline`` is the port's own: the bound of a sparse product by
what its nonzeros need, where ``spmm_roofline`` counts a block format's
work.  Times
come from CUDA events, and a run that finds no card raises rather than
time the CPU.  The roofline uses the H100 SXM data-sheet peaks at its
700 W limit (dense rates, no sparsity) in place of the TPU v5e's
measured ones.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import torch

__all__ = ["H100_BYTES_PER_S", "H100_OPS_PER_S", "StepTimer", "trace",
           "slope_time", "spmm_roofline", "sparse_roofline", "roofline"]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    """Wall-clock step timer (JAX :55): ``stop(result)`` waits for the
    card when a tensor of ``result`` lives there, so that queued work is
    charged to the step that launched it; CPU tensors are computed by
    the time they are returned."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        devices = {t.device for t in _tensors(result) if t.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)

    @property
    def min_ms(self) -> float:
        return 1000.0 * min(self.times) if self.times else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write a Chrome trace, ``log_dir/trace.json``,
    which Perfetto and ``chrome://tracing`` open (JAX :81 writes a
    ``jax.profiler`` trace).  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

H100_BYTES_PER_S = 3.35e12
# Operations per second by the operands' type: tensor cores for bf16 and
# int8; float32 is computed in exact f32 by FMA outside the tensor cores;
# "tf32" is the tensor cores' rate for f32 products taken in TF32, which
# only the probes' library rows (utils/probes.py peak_probe) ask for.
H100_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12,
                  torch.float32: 67e12, "tf32": 495e12}


def slope_time(make_fn, args=(), units=(2, 16), reps: int = 3):
    """Per-unit device time with every per-call constant cancelled: time
    the same chain at two lengths and difference them,

        per_unit = (t(u1) - t(u0)) / (u1 - u0).

    ``make_fn(u)`` returns a callable whose device work grows linearly in
    ``u`` and whose result holds only finite values.  Each length runs
    once as a warm-up, then ``reps`` times between CUDA events on the
    current stream; the least time counts.  Returns ``(per_unit_seconds,
    fixed_seconds)``."""
    if not torch.cuda.is_available():
        raise RuntimeError("slope_time times the card; no CUDA device is "
                           "visible")
    times = []
    for u in units:
        fn = make_fn(u)
        out = fn(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"slope_time: the {u}-unit chain gave "
                               "non-finite values")
        best = math.inf
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        times.append(best)
    per_unit = (times[-1] - times[0]) / (units[-1] - units[0])
    return per_unit, times[0] - units[0] * per_unit


def _operator_blocks(op):
    """``(blocks, block rows, block cols)`` an operator's product reads:
    the dkw layout's arrays where present, else the flat ragged or the
    uniform band, the BSR blocks without their zero tails, or the whole
    dense matrix as one block."""
    if getattr(op, "bands_dkw", None) is not None:
        # Square blocks where the operator names no shape (the halo ones).
        br, bc = getattr(op, "block_shape", (op.bands_dkw[0].shape[1],) * 2)
        return (sum(b.shape[0] * (b.shape[2] // bc) for b in op.bands_dkw),
                br, bc)
    if getattr(op, "band", None) is not None:
        if op.band.dim() == 3:  # flat ragged
            return op.band.shape[0], op.band.shape[1], op.band.shape[2]
        nbr, w, br, bc = op.band.shape
        return nbr * w, br, bc
    if getattr(op, "blocks", None) is not None:
        _, br, bc = op.blocks.shape
        return op.block_cols.numel(), br, bc
    if getattr(op, "mat", None) is not None:
        return 1, op.mat.shape[0], op.mat.shape[1]
    raise ValueError(f"no roofline model for {type(op).__name__}")


def roofline(ops: float, nbytes: float, dtype, seconds: float | None = None,
             bytes_per_s: float = H100_BYTES_PER_S,
             ops_per_s: dict = H100_OPS_PER_S) -> dict:
    """The least time the card could take for ``ops`` operations on
    ``dtype`` operands and ``nbytes`` moved once: the larger of the two
    times, named by what bounds it; with ``seconds``, the achieved share
    of that bound."""
    t_bytes = nbytes / bytes_per_s
    t_ops = ops / ops_per_s[dtype]
    out = {"bytes": int(nbytes), "flops": int(ops),
           "t_bytes_us": t_bytes * 1e6, "t_ops_us": t_ops * 1e6,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_us": max(t_bytes, t_ops) * 1e6}
    if seconds is not None:
        out["achieved_frac_of_bound"] = max(t_bytes, t_ops) / seconds
    return out


def spmm_roofline(op, seconds_per_spmm: float | None, feature_width: int,
                  extra_inputs: int = 0, **peaks) -> dict:
    """Roofline of one ``L @ x`` through ``op`` at ``feature_width``
    columns (JAX :117-181): the operator's storage read once plus one
    activation read and one written, against the products of every
    stored block, zero blocks included.  ``extra_inputs`` adds that many
    more activation reads (1 for the hop's x0, 2 with the adjoint hop's
    c).  ``useful_edge_flops_frac`` is the share of those products that
    the graph's nonzeros need."""
    e = torch.empty(0, dtype=op.compute_dtype).element_size()
    C = feature_width
    nb, br, bc = _operator_blocks(op)
    flops = 2 * nb * br * bc * C
    nbytes = nb * br * bc * e + (2 + extra_inputs) * op.m_padded * C * e
    out = roofline(flops, nbytes, op.compute_dtype, seconds_per_spmm,
                   **peaks)
    out["useful_edge_flops_frac"] = 2 * op.nnz * C / flops
    return out


def sparse_roofline(op, seconds_per_spmm: float | None, feature_width: int,
                    extra_inputs: int = 0, **peaks) -> dict:
    """Roofline of one ``L @ x`` by what the inputs need: each nonzero's
    value (in the operator's dtype) and column index, the int32 row
    pointer over the ``m_padded`` rows, one activation read and one
    written (``extra_inputs`` more reads: 1 for the hop's x0), and
    ``2 nnz C`` operations.  The index is int32 (a CSR column, the BSR
    row kernel's ``nz_cols``) or, on a banded operator, the int16 window
    offset that the banded row walk reads (``ops.packing.band_row_index``;
    the band fixes every nonzero's window, in every layout).
    ``spmm_roofline`` counts the block format's work instead."""
    e = torch.empty(0, dtype=op.compute_dtype).element_size()
    index_bytes = 2 if getattr(op, "band", None) is not None else 4
    C = feature_width
    nnz = op.nnz
    nbytes = (nnz * (e + index_bytes) + (op.m_padded + 1) * 4
              + (2 + extra_inputs) * op.m_padded * C * e)
    return roofline(2 * nnz * C, nbytes, op.compute_dtype, seconds_per_spmm,
                    **peaks)
