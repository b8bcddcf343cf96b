// Banded SpMM and fused Chebyshev hop for Hopper (sm_90a), in the three
// band layouts of the banded operator.
//
// Replaces the TPU kernels of cnn_graph_tpu/ops/pallas_band.py:
//   layout 0, deep-K window  _kernel_dkw     (banded_call_dkw)     K1
//   layout 1, uniform        _kernel         (banded_call)         K5
//   layout 2, ragged         _kernel_ragged  (banded_call_ragged)  K6
// all with the epilogue _emit_row.  Forms:
//   y = L @ x                 (x0 == nullptr)
//   y = 2 (L @ x) - x0        (x0 != nullptr)
//   y = 2 (L @ x) - x0 + c    (x0, c != nullptr; float only: the backward
//                              adjoint chain's hop)
// in float32 and bfloat16 (f32 accumulation) and int8 (int32
// accumulation, requant clip(rint(band_scale * acc [*2 - x0]), +-127) at
// emission).  y may be x0 itself (the in-place form): each output element
// is written by the lane that read its x0 element just before, and no
// warp reads another's rows of x0.  x must not overlap x0 or y.
//
// Layouts.  The blocks are br x bc, both given at run time (the TPU
// kernels read them from the band's shape; 128 x 128 by default, any shape
// ops/packing.py packs).  Block-row r (br rows of L) has the band operand
// [br, W*bc] over the contiguous x window rows [base[r]*bc,
// (base[r]+W)*bc).
//   dkw:     step s = r / G has level li = sched[1][s]; the operand is
//            row sched[0][s] + r % G of bands[li] ([n_rows, br, W_l*bc]),
//            its blocks side by side along the contraction axis.
//   uniform: band [n_rows, W, br, bc]; the operand is band[r], W taps.
//   ragged:  one flat band [total, br, bc]; step s has width
//            W_s = levels[sched[1][s]] and row r = s*G + g takes the W_s
//            blocks from sched[0][s] + g*W_s on.
// For the two tap layouts element (i, k) of the operand is at block
// k / bc, row i, column k % bc: in the flat ragged band that is
// ((sched[0][s] + g*W_s + k/bc)*br + i)*bc + k % bc.  x may have more
// rows than the output (x_rows): base indexes x's block rows, as the
// sharded halo operators feed [left halo | local | right halo].  Window
// rows past x_rows read as zero.  The TPU kernels' VMEM x ring, its mirror
// copies, prefetch-ahead, DMA semaphores and the high-water row of sched
// exist only because x arrives there in column blocks; here the window is
// contiguous in device memory, so none has a counterpart.
//
// All three layouts (K1, K5, K6) launch one kernel, band_rows_kernel, a
// walk over the band's nonzeros row by row, csrc/rows.cuh's scheme (one
// warp per output row, 8 rows per 256-thread CTA).  The walk reads the
// operator's row index (ops/packing.py band_row_index): nz_rowptr
// [n_rows*br + 1] and, per nonzero in row order, its offset k in its
// block-row's window (int16).  The warp loads base[r] and the block-row's
// band pointer once (row_setup); each lane reads one k and its value
// band[band_off(i, k)] from the layout's own band, where the TPU kernel
// would read it, and x row base[r]*bc + k is gathered by the whole warp.
// The walk's order, the nonzeros of a row by column, does not depend on
// the block shape, so one graph gives the same sums at every shape.
// An x row at or past x_rows adds nothing (one compare per nonzero), so
// the index, which holds window offsets and no x rows, stays right when
// the bases shift.  The index holds no values, so an int8 or cast band
// reads its own, and one index serves every layout of one graph.
//
// What bounds the walk is bytes, and how fast L2 serves the gathers.  On
// the bench's 50,176-node city graph (436,582 nonzeros) at C = 512 it
// does 2 nnz C = 0.45 GFLOP and must move x and y once plus a value and
// an int16 offset per nonzero: 105 MB in bf16, 0.031 ms at 3.35 TB/s.  Each
// nonzero gathers one x row (1 KB in bf16, 447 MB in all), most of it
// from the 50 MB L2, since a block-row's window (at most 9 blocks here)
// is shared by its 128 rows and by its neighbours': the walk ran at
// 5.4 TB/s of gathers (K1 bf16 L@x, 0.0823 ms on the H100), so L2's rate
// for them bounds it.  Neither tensor cores nor a tile serve the band: it
// is 0.93% full, so a [128, W*128] tile product does 48 GFLOP (dkw, 2,856
// blocks) to 59 GFLOP (uniform, 3,528) where the graph needs 0.45, and
// reads the 94 MB (dkw, bf16) band.  In f32 that block work alone takes
// 0.72 ms at the 67 TFLOP/s of FMA (TF32 would change the results), 3.3x
// torch.sparse.mm's 0.21 ms.  The tile kernels this walk replaced took
// 0.53 (K1), 0.57 (K5) and 0.52 ms (K6) in bf16.  Staging each
// block-row's whole window in shared memory instead (one CTA per
// block-row, 64-byte slabs of every window row, double-buffered with
// cp.async) moves as many bytes as the gathers, 365k-452k window rows
// against 437k nonzeros, at one CTA per SM: measured 6.7x slower in
// bf16 L@x, so the walk gathers straight from L2.
//
// Build without --use_fast_math: the int8 path is bit-exact with the
// PyTorch reference only with IEEE rounding of every float operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;  // the row walk's warps
constexpr int kMaxLevels = 4;  // ops/packing.py MAX_LEVELS

// ops/band.py _LAYOUT_CODE
constexpr int kDkw = 0;
constexpr int kUniform = 1;
constexpr int kRagged = 2;

struct Args {
  const void* band[kMaxLevels];  // dkw: one per level; else band[0] only
  int width[kMaxLevels];         // dkw, ragged: W per level; uniform: W
  const int* base;               // [n_block_rows]
  const int* sched;              // [3, nsb]: row or block offset, level
  const int* nz_rowptr;          // [n_rows + 1]
  const int16_t* nz_win;         // [nnz]: window offset k of each nonzero
  int nsb;
  int G;
  int br;          // block rows
  int bc;          // block columns
  int br_shift;    // log2(br) where br is a power of two, else -1
  int bc_shift;    // log2(bc) likewise
  int n_rows;      // output rows, n_block_rows * br
  const void* x;   // [x_rows, C]
  const void* x0;  // [n_rows, C] or nullptr
  const void* c;   // [n_rows, C] or nullptr (needs x0)
  void* y;         // [n_rows, C], may be x0
  int x_rows;
  int C;
  float band_scale;  // int8 only
};

// n / d for d = 1 << shift where shift >= 0: a shift, as a fixed block
// edge compiled to, instead of an integer division (about 20 instructions,
// once a row and once a nonzero of the tap layouts, measurable on rows of
// ~9 nonzeros).  The branch is the same for every thread of a launch.
__device__ __forceinline__ int div_by(int n, int d, int shift) {
  return shift >= 0 ? n >> shift : n / d;
}

// Offset of operand element (row, k) from the block-row's band pointer.
template <int L>
__device__ __forceinline__ size_t band_off(const Args& a, int row, int k,
                                           int K) {
  if constexpr (L == kDkw) {
    return (size_t)row * K + k;
  } else {
    const int t = div_by(k, a.bc, a.bc_shift);
    return ((size_t)t * a.br + row) * a.bc + (k - t * a.bc);
  }
}

// Band operand, contraction depth and first x row of block-row r.
template <int L, typename T>
__device__ __forceinline__ void row_setup(const Args& a, int r,
                                          const T*& band, int& K,
                                          int& xrow0) {
  xrow0 = a.base[r] * a.bc;
  if constexpr (L == kUniform) {
    K = a.width[0] * a.bc;
    band = static_cast<const T*>(a.band[0]) + (size_t)r * a.br * K;
  } else {
    const int s = r / a.G;
    const int li = a.sched[a.nsb + s];
    int w = a.width[0];
    const void* b = a.band[0];
    if (li == 1) { w = a.width[1]; b = a.band[1]; }
    if (li == 2) { w = a.width[2]; b = a.band[2]; }
    if (li == 3) { w = a.width[3]; b = a.band[3]; }
    K = w * a.bc;
    if constexpr (L == kDkw) {
      band = static_cast<const T*>(b) +
             (size_t)(a.sched[s] + r % a.G) * a.br * K;
    } else {
      band = static_cast<const T*>(a.band[0]) +
             (size_t)(a.sched[s] + (r % a.G) * w) * a.br * a.bc;
    }
  }
}

// ------------------------------------------------------------ the row walk
template <int L, typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) band_rows_kernel(Args a) {
  using E = rows::Elem<T>;
  using Acc = typename E::Acc;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  // The last CTA's warps past the output (n_rows not a multiple of 8)
  // leave whole: every lane of a warp shares its row.
  if (row >= a.n_rows) return;
  const int r = div_by(row, a.br, a.br_shift), i = row - r * a.br;
  const T* band;
  int K, xrow0;
  row_setup<L>(a, r, band, K, xrow0);
  const int lo = __ldg(a.nz_rowptr + row), hi = __ldg(a.nz_rowptr + row + 1);
  const rows::Out out = {a.x0, a.c, a.y, a.band_scale};
  const auto entry = [&](int e, int& xrow, Acc& val) {
    const int k = __ldg(a.nz_win + e);
    xrow = xrow0 + k < a.x_rows ? xrow0 + k : -1;
    val = E::value(band, (long long)band_off<L>(a, i, k, K));
  };
  for (int c0 = 0; c0 < a.C; c0 += rows::kPassCols) {
    Acc acc[rows::kLaneCols];
    rows::gather<T, kVec, true>(static_cast<const T*>(a.x), a.C, c0, lo, hi,
                                lane, entry, acc);
    rows::store<T, kVec>(out, row, a.C, c0, lane, acc);
  }
}

template <int L, typename T>
void start_rows(const Args& a, cudaStream_t s) {
  const dim3 grid((a.n_rows + kRowsPerCta - 1) / kRowsPerCta);
  if (a.C % (16 / sizeof(T)) == 0) {
    band_rows_kernel<L, T, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    band_rows_kernel<L, T, false><<<grid, kThreads, 0, s>>>(a);
  }
}

template <int L>
int launch_rows(const Args& a, int dtype, cudaStream_t s) {
  // nz_win may be null: an index without a nonzero (a block of padding
  // rows, as the last shard of a sharded operator can hold) is an empty
  // tensor, whose data pointer is null, and the walk then never reads it.
  if (a.nz_rowptr == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      start_rows<L, float>(a, s);
      break;
    case 1:
      start_rows<L, __nv_bfloat16>(a, s);
      break;
    case 2:
      start_rows<L, int8_t>(a, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// log2(v) where v is a power of two, else -1.
int exact_log2(int v) {
  if (v <= 0 || (v & (v - 1)) != 0) return -1;
  int s = 0;
  while ((1 << s) != v) ++s;
  return s;
}

}  // namespace

// layout: 0 dkw, 1 uniform, 2 ragged.  dtype: 0 float32, 1 bfloat16,
// 2 int8.  Unused band slots take a null pointer and width 0 (uniform and
// ragged pass one band; uniform one width, W).  nz_rowptr (int32) and
// nz_win (int16) are the row index that every layout walks (nz_win null
// when the index holds no nonzero).  br x bc is the block shape.  The
// output has n_block_rows * br rows; y may equal x0.  c needs x0 and a
// float dtype.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for bad arguments).
extern "C" int band_launch(int layout, const void* band0, const void* band1,
                           const void* band2, const void* band3, int w0,
                           int w1, int w2, int w3, const void* base,
                           const void* sched, const void* nz_rowptr,
                           const void* nz_win, int n_block_rows, int nsb,
                           int G, int br, int bc, const void* x, int x_rows,
                           const void* x0, const void* c, void* y, int C,
                           float band_scale, int dtype, void* stream) {
  if (n_block_rows < 1 || C < 1 || br < 1 || bc < 1 ||
      (long long)n_block_rows * br > 0x7fffffffLL ||
      (c != nullptr && (x0 == nullptr || dtype == 2))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.band[0] = band0;
  a.band[1] = band1;
  a.band[2] = band2;
  a.band[3] = band3;
  a.width[0] = w0;
  a.width[1] = w1;
  a.width[2] = w2;
  a.width[3] = w3;
  a.base = static_cast<const int*>(base);
  a.sched = static_cast<const int*>(sched);
  a.nz_rowptr = static_cast<const int*>(nz_rowptr);
  a.nz_win = static_cast<const int16_t*>(nz_win);
  a.nsb = nsb;
  a.G = G;
  a.br = br;
  a.bc = bc;
  a.br_shift = exact_log2(br);
  a.bc_shift = exact_log2(bc);
  a.n_rows = n_block_rows * br;
  a.x = x;
  a.x0 = x0;
  a.c = c;
  a.y = y;
  a.x_rows = x_rows;
  a.C = C;
  a.band_scale = band_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kDkw:
      return launch_rows<kDkw>(a, dtype, s);
    case kUniform:
      return launch_rows<kUniform>(a, dtype, s);
    case kRagged:
      return launch_rows<kRagged>(a, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
