// Row-sparse gather SpMM and fused Chebyshev hop for the BSR operators,
// for Hopper (sm_90a).
//
// One kernel, bsr_rows_kernel, in three forms of one emission:
//   y = L @ x               (x0 == nullptr)
//   y = 2 (L @ x) - x0      (x0 != nullptr)
// in float32 and bfloat16 (f32 accumulation) and int8 (int8 x int8, int32
// accumulation, requant clip(rint(scale * acc [*2 - x0]), +-127) at
// emission, as pallas_band._emit_row).
//
// It replaces the four Pallas kernels of cnn_graph_tpu/ops/pallas_spmm.py:
// _kernel_colstream (K4, through _colstream_call), _kernel_grouped (K7,
// _grouped_call), _kernel (K8) and _kernel_chunked (K9, both through
// _bsr_spmm_impl).  Those multiply dense 128x128 blocks; this kernel
// walks the operator's nonzero index by output row instead (nz_rowptr,
// nz_cols, nz_pos: ops/packing.py row_index) and reads each value from
// the operator's own blocks array at its flat position, in whatever
// dtype the blocks have, so an operator whose blocks were cast or
// quantized keeps a right index.  The ops/bsr.py wrappers bsr_colstream
// (K4) and bsr_csr (K7/K8/K9) both launch it.
//
// What bounds it is bytes.  On the bench's 50k scattered kNN graph
// (699,780 nonzeros in 54,165 blocks) a 128x128 block holds 12.9
// nonzeros: a tile product does 1,266x the work the graph needs, and the
// block kernels this one replaced were bound by that work (0.91 TFLOP at
// C = 512).  The row walk does 2 nnz C operations and must move x and y
// once plus 6 bytes per nonzero: 107 MB in bf16 at C = 512, 0.032 ms at
// 3.35 TB/s.  So it uses neither tensor cores nor TMA.  What Hopper gives
// it is the 50 MB L2: every nonzero gathers one row of x (1 KB in bf16
// at C = 512, 717 MB in all), and x (51 MB in bf16) about fits L2, so
// neighbouring warps on RCM-neighbouring rows find their x rows there.
//
// Layout of the work: one warp per output row, 8 rows per 256-thread
// CTA, by the row walk of csrc/rows.cuh (shared with csrc/band.cu's K1
// and K5).  The lanes load the row's columns and positions 32 at a time
// (one coalesced read each), then the 32 values.  Pad rows have no
// nonzeros: 0 for L@x, -x0 for the hop.
//
// Build without --use_fast_math: the int8 path is bit-exact with the
// PyTorch reference only with IEEE rounding of every float operation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;

struct Args {
  const void* blocks;      // the operator's blocks, any layout
  const int* rowptr;       // [mp + 1]
  const int* cols;         // [nnz]
  const long long* pos;    // [nnz], flat positions in blocks
  const void* x;           // [>= max col + 1, C]
  const void* x0;          // [mp, C] or nullptr
  void* y;                 // [mp, C]
  int mp, C;
  float scale;             // int8 only: the blocks' scale
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) bsr_rows_kernel(Args a) {
  using E = rows::Elem<T>;
  using Acc = typename E::Acc;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  if (row >= a.mp) return;  // the whole warp leaves together
  const int lo = __ldg(a.rowptr + row), hi = __ldg(a.rowptr + row + 1);
  const T* x = static_cast<const T*>(a.x);
  const rows::Out out = {a.x0, nullptr, a.y, a.scale};
  const auto entry = [&](int e, int& col, Acc& val) {
    col = __ldg(a.cols + e);
    val = E::value(a.blocks, __ldg(a.pos + e));
  };
  for (int c0 = 0; c0 < a.C; c0 += rows::kPassCols) {
    Acc acc[rows::kLaneCols];
    rows::gather<T, kVec, false>(x, a.C, c0, lo, hi, lane, entry, acc);
    rows::store<T, kVec>(out, row, a.C, c0, lane, acc);
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t s) {
  const dim3 grid((a.mp + kRowsPerCta - 1) / kRowsPerCta);
  if (a.C % (16 / sizeof(T)) == 0) {
    bsr_rows_kernel<T, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    bsr_rows_kernel<T, false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int8.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a bad dtype or shape).
extern "C" int bsr_rows_launch(const void* blocks, const void* rowptr,
                               const void* cols, const void* pos, int mp,
                               const void* x, const void* x0, void* y, int C,
                               float scale, int dtype, void* stream) {
  if (mp < 1 || C < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.blocks = blocks;
  a.rowptr = static_cast<const int*>(rowptr);
  a.cols = static_cast<const int*>(cols);
  a.pos = static_cast<const long long*>(pos);
  a.x = x;
  a.x0 = x0;
  a.y = y;
  a.mp = mp;
  a.C = C;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, s);
    case 1:
      return launch<__nv_bfloat16>(a, s);
    case 2:
      return launch<int8_t>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
