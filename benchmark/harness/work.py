"""The work rule: operations and bytes that a request or a step needs,
counted from the graph's nonzeros and the model's widths, and the least
time an NVIDIA H100 could take for them.

* A hop (``L @ x``, ``2 L x1 - x0``, ``2 L x1 - x0 + c``) costs ``2 nnz C``
  operations.  It moves each nonzero's value once in the operator's stored
  dtype, no index bytes, plus every dense operand (input, carry, injection)
  and the output once each.  ``nnz`` is the graph's, never a format's
  blocks or padding.
* A dense product ``[m, k] @ [k, n]`` costs ``2 m k n`` operations and
  moves its operands and result once each.
* A fused conv (K2, K3) moves the operator's nonzeros once per hop, its
  input, weights and output once: its carries need not leave the chip.
* The least time is the larger of bytes over 3.35 TB/s and operations over
  the rate of their type: 989 TFLOP/s for every floating-point product,
  whatever its precision, and 1,979 TOP/s for int8 products.  These are
  the data-sheet peaks of the H100 SXM at 700 W (dense, no sparsity).

``mfu`` is the compute side alone (operations over the peak rate of their
type), which bounds every implementation, fused or not.  The rooflines of
single kernels take both sides.

Unlike ``cnn_graph_tpu_torch/utils/profiling.py sparse_roofline`` this
charges no index bytes, so a graph has the same bound under every format;
unlike ``spmm_roofline`` and ``chip_smoke.py dense_cheby_bound`` it counts
the graph's nonzeros, not a format's blocks or a dense matrix.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PEAK_FLOAT", "PEAK_INT8", "PEAK_BYTES", "Work", "hop", "dense",
           "fused_conv", "ITEMSIZE"]

PEAK_FLOAT = 989e12  # FLOP/s, bf16/fp16 tensor cores (H100 SXM data sheet)
PEAK_INT8 = 1979e12  # OP/s, int8 tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
            "int8": 1}


@dataclasses.dataclass
class Work:
    flops: float = 0.0  # floating-point operations
    int_ops: float = 0.0  # int8 operations
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.int_ops + other.int_ops,
                    self.bytes + other.bytes)

    def __mul__(self, n: float) -> "Work":
        return Work(self.flops * n, self.int_ops * n, self.bytes * n)

    __rmul__ = __mul__

    def compute_s(self) -> float:
        """Seconds at the peak rate of each operand type."""
        return self.flops / PEAK_FLOAT + self.int_ops / PEAK_INT8

    def least_s(self) -> float:
        """The least time: the larger of the compute and the bytes side."""
        return max(self.compute_s(), self.bytes / PEAK_BYTES)


def hop(nnz: int, m: int, cols: int, op_dtype: str, x_dtype: str,
        operands: int) -> Work:
    """One hop over ``nnz`` nonzeros on ``cols`` columns of ``m`` rows;
    ``operands`` counts the dense arrays read and written (2 for ``L@x``,
    3 for a hop, 4 for a hop with an injection)."""
    ops = 2.0 * nnz * cols
    nbytes = nnz * ITEMSIZE[op_dtype] + operands * m * cols * ITEMSIZE[x_dtype]
    if op_dtype == "int8":
        return Work(int_ops=ops, bytes=nbytes)
    return Work(flops=ops, bytes=nbytes)


def dense(m: int, k: int, n: int, a_dtype: str = "float32",
          b_dtype: str = "float32", c_dtype: str = "float32") -> Work:
    """``[m, k] @ [k, n]``, floating point."""
    return Work(flops=2.0 * m * k * n,
                bytes=(m * k * ITEMSIZE[a_dtype] + k * n * ITEMSIZE[b_dtype]
                       + m * n * ITEMSIZE[c_dtype]))


def fused_conv(nnz: int, m: int, batch: int, fin: int, fout: int, K: int,
               dtype: str) -> Work:
    """One fused Chebyshev conv (K2) or its weight gradient (K3):
    ``K - 1`` hops on ``batch * fin`` columns and ``K`` tap products
    ``[m*batch, fin] @ [fin, fout]``; bytes: the nonzeros once a hop, the
    input, the weights (K3: the output gradient and dW) once."""
    s = ITEMSIZE[dtype]
    cols = batch * fin
    ops = 2.0 * nnz * cols * (K - 1) + 2.0 * K * m * batch * fin * fout
    nbytes = ((K - 1) * nnz * s + m * cols * s + K * fin * fout * 4
              + m * batch * fout * s)
    return Work(flops=ops, bytes=nbytes)
