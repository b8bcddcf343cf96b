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
// is written by the thread that read its x0 element just before, and no
// warp (layouts 0, 1) or CTA (layout 2) reads another's rows of x0.  x
// must not overlap x0 or y.
//
// Layouts.  Block-row r (128 rows of L) has the band operand [128, W*128]
// over the contiguous x window rows [base[r]*128, (base[r]+W)*128).
//   dkw:     step s = r / G has level li = sched[1][s]; the operand is
//            row sched[0][s] + r % G of bands[li] ([n_rows, 128, W_l*128]),
//            its blocks side by side along the contraction axis.
//   uniform: band [n_rows, W, 128, 128]; the operand is band[r], W taps.
//   ragged:  one flat band [total, 128, 128]; step s has width
//            W_s = levels[sched[1][s]] and row r = s*G + g takes the W_s
//            blocks from sched[0][s] + g*W_s on.
// For the two tap layouts element (i, k) of the operand is at block
// k / 128, row i, column k % 128.  x may have more rows than the output
// (x_rows): base indexes x's block rows, as the sharded halo operators
// feed [left halo | local | right halo].  Window rows past x_rows read as
// zero.  The TPU kernels' VMEM x ring, its mirror copies, prefetch-ahead,
// DMA semaphores and the high-water row of sched exist only because x
// arrives there in column blocks; here the window is contiguous in device
// memory, so none has a counterpart.
//
// Layouts 0 and 1 (K1, K5): band_rows_kernel, a walk over the band's
// nonzeros row by row, csrc/rows.cuh's scheme (one warp per output row,
// 8 rows per 256-thread CTA).  The walk reads the operator's row index
// (ops/packing.py band_row_index): nz_rowptr [n_rows*128 + 1] and, per
// nonzero in row order, its offset k in its block-row's window (int16).
// The warp loads base[r] and the block-row's band pointer once
// (row_setup); each lane reads one k and its value band[band_off(i, k)]
// from the layout's own band, where the TPU kernel would read it, and x
// row base[r]*128 + k is gathered by the whole warp.  An x row at or past
// x_rows adds nothing (one compare per nonzero), so the index, which
// holds window offsets and no x rows, stays right when the bases shift.
// The index holds no values, so an int8 or cast band reads its own.
//
// What bounds the walk is bytes, and how fast L2 serves the gathers.  On
// the bench's 50,176-node city graph (436,582 nonzeros) at C = 512 it
// does 2 nnz C = 0.45 GFLOP and must move x and y once plus a value and
// an int16 offset per nonzero: 105 MB in bf16, 0.031 ms at 3.35 TB/s.  Each
// nonzero gathers one x row (1 KB in bf16, 447 MB in all), most of it
// from the 50 MB L2, since a block-row's window (at most 9 blocks here)
// is shared by its 128 rows and by its neighbours'.  Neither tensor cores
// nor a tile serve K1/K5: the band is 0.93% full, so a [128, W*128] tile
// product does 48 GFLOP (dkw, 2,856 blocks) or 59 GFLOP (uniform, 3,528)
// where the graph needs 0.45, and reads the 94 MB (dkw, bf16) band.  In
// f32 that block work alone takes 0.72 ms at the 67 TFLOP/s of FMA (TF32
// would change the results), 3.3x torch.sparse.mm's 0.21 ms; in bf16 even
// cuBLAS's 936 TFLOP/s leaves the band to read.  The tile kernels this
// walk replaced took 0.53 (K1) and 0.57 ms (K5) in bf16.  Staging each
// block-row's whole window in shared memory instead (one CTA per
// block-row, 64-byte slabs of every window row, double-buffered with
// cp.async) moves as many bytes as the gathers, 365k-452k window rows
// against 437k nonzeros, at one CTA per SM: measured 6.7x slower in
// bf16 L@x, so the walk gathers straight from L2.
//
// Layout 2 (K6): the tile kernels band_f32_kernel and band_tc_kernel,
// one CTA per (block-row, column tile)
// computing [128, W*128] @ [W*128, tile], staging 32-deep (16 for f32) K
// chunks of band and x through shared memory, with no pipelining across
// chunks; wmma (bf16, int8) or FMA (f32).  It is bound by the band re-read
// per column tile and the unpipelined staging, as K1/K5 were.
//
// Build without --use_fast_math: the int8 path is bit-exact with the
// PyTorch reference only with IEEE rounding of every float operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "rows.cuh"

using namespace nvcuda;

namespace {

constexpr int kBlock = 128;   // ops/packing.py BLOCK: band block edge
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
  const int* nz_rowptr;          // [n_block_rows*128 + 1] (layouts 0, 1)
  const int16_t* nz_win;         // [nnz]: window offset k of each nonzero
  int nsb;
  int G;
  const void* x;   // [x_rows, C]
  const void* x0;  // [n_block_rows*128, C] or nullptr
  const void* c;   // [n_block_rows*128, C] or nullptr (needs x0)
  void* y;         // [n_block_rows*128, C], may be x0
  int x_rows;
  int C;
  float band_scale;  // int8 only
};

// Offset of operand element (row, k) from the block-row's band pointer.
template <int L>
__device__ __forceinline__ size_t band_off(int row, int k, int K) {
  if constexpr (L == kDkw) {
    return (size_t)row * K + k;
  } else {
    return (size_t)(k / kBlock) * (kBlock * kBlock) + (size_t)row * kBlock +
           (k % kBlock);
  }
}

// Band operand, contraction depth and first x row of block-row r.
template <int L, typename T>
__device__ __forceinline__ void row_setup(const Args& a, int r,
                                          const T*& band, int& K,
                                          int& xrow0) {
  xrow0 = a.base[r] * kBlock;
  if constexpr (L == kUniform) {
    K = a.width[0] * kBlock;
    band = static_cast<const T*>(a.band[0]) + (size_t)r * kBlock * K;
  } else {
    const int s = r / a.G;
    const int li = a.sched[a.nsb + s];
    int w = a.width[0];
    const void* b = a.band[0];
    if (li == 1) { w = a.width[1]; b = a.band[1]; }
    if (li == 2) { w = a.width[2]; b = a.band[2]; }
    if (li == 3) { w = a.width[3]; b = a.band[3]; }
    K = w * kBlock;
    if constexpr (L == kDkw) {
      band = static_cast<const T*>(b) +
             (size_t)(a.sched[s] + r % a.G) * kBlock * K;
    } else {
      band = static_cast<const T*>(a.band[0]) +
             (size_t)(a.sched[s] + (r % a.G) * w) * kBlock * kBlock;
    }
  }
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ __nv_bfloat16 zero() {
  return __float2bfloat16_rn(0.0f);
}
template <> __device__ __forceinline__ int8_t zero() { return 0; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The tile kernels' emission of element i, by rows::emit.
template <typename T>
__device__ __forceinline__ void emit_float(const Args& a, size_t i,
                                           float acc) {
  const bool hop = a.x0 != nullptr, add_c = a.c != nullptr;
  const float y = rows::emit<T>(
      acc, 0.0f, hop, hop ? to_float(static_cast<const T*>(a.x0)[i]) : 0.0f,
      add_c, add_c ? to_float(static_cast<const T*>(a.c)[i]) : 0.0f);
  store(static_cast<T*>(a.y) + i, y);
}

__device__ __forceinline__ void emit_quant(const Args& a, size_t i,
                                           int acc) {
  const bool hop = a.x0 != nullptr;
  const float y = rows::emit<int8_t>(
      acc, a.band_scale, hop,
      hop ? (float)static_cast<const int8_t*>(a.x0)[i] : 0.0f, false, 0.0f);
  static_cast<int8_t*>(a.y)[i] = (int8_t)y;
}

// ------------------------------------------------ layouts 0, 1: the row walk
template <int L, typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) band_rows_kernel(Args a) {
  using E = rows::Elem<T>;
  using Acc = typename E::Acc;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  const int r = row / kBlock, i = row % kBlock;
  const T* band;
  int K, xrow0;
  row_setup<L>(a, r, band, K, xrow0);
  const int lo = __ldg(a.nz_rowptr + row), hi = __ldg(a.nz_rowptr + row + 1);
  const rows::Out out = {a.x0, a.c, a.y, a.band_scale};
  const auto entry = [&](int e, int& xrow, Acc& val) {
    const int k = __ldg(a.nz_win + e);
    xrow = xrow0 + k < a.x_rows ? xrow0 + k : -1;
    val = E::value(band, (long long)band_off<L>(i, k, K));
  };
  for (int c0 = 0; c0 < a.C; c0 += rows::kPassCols) {
    Acc acc[rows::kLaneCols];
    rows::gather<T, kVec, true>(static_cast<const T*>(a.x), a.C, c0, lo, hi,
                                lane, entry, acc);
    rows::store<T, kVec>(out, row, a.C, c0, lane, acc);
  }
}

template <int L, typename T>
void start_rows(const Args& a, int n_block_rows, cudaStream_t s) {
  const dim3 grid(n_block_rows * (kBlock / kRowsPerCta));
  if (a.C % (16 / sizeof(T)) == 0) {
    band_rows_kernel<L, T, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    band_rows_kernel<L, T, false><<<grid, kThreads, 0, s>>>(a);
  }
}

template <int L>
int launch_rows(const Args& a, int n_block_rows, int dtype, cudaStream_t s) {
  if (a.nz_rowptr == nullptr || a.nz_win == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      start_rows<L, float>(a, n_block_rows, s);
      break;
    case 1:
      start_rows<L, __nv_bfloat16>(a, n_block_rows, s);
      break;
    case 2:
      start_rows<L, int8_t>(a, n_block_rows, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------ layout 2: the tile kernels
// ---------------------------------------------------------------- float32
// Register-tiled FMA: tile 128 x 64, each thread 8 rows x 4 columns.
constexpr int kF32Cols = 64;
constexpr int kF32Depth = 16;

__global__ void __launch_bounds__(kThreads) band_f32_kernel(Args a) {
  constexpr int L = kRagged;
  __shared__ float As[kF32Depth][kBlock + 4];  // band chunk, [k][row]
  __shared__ float Bs[kF32Depth][kF32Cols + 4];  // x chunk, [k][col]
  const int r = blockIdx.y;
  const int n0 = blockIdx.x * kF32Cols;
  const float* band;
  int K, xrow0;
  row_setup<L>(a, r, band, K, xrow0);
  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3
  const int ty = tid / 16;  // rows ty*8 .. +7

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // Each thread loads column tid % 16 of band rows tid / 16 + 16 t, from
  // one pointer per chunk: nvcc schedules this form faster than an
  // address computed per element (measured on the card).  A tap's rows
  // are kBlock apart.
  const float* bthr = band + (size_t)(tid / kF32Depth) * kBlock +
                      tid % kF32Depth;
  for (int k0 = 0; k0 < K; k0 += kF32Depth) {
    const float* chunk = bthr + band_off<L>(0, k0, K);
#pragma unroll
    for (int t = 0; t < kBlock * kF32Depth / kThreads; ++t) {
      As[tid % kF32Depth][tid / kF32Depth + t * (kThreads / kF32Depth)] =
          chunk[(size_t)t * (kThreads / kF32Depth) * kBlock];
    }
#pragma unroll
    for (int t = 0; t < kF32Depth * kF32Cols / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int kr = e / kF32Cols, c = e % kF32Cols;
      const int xr = xrow0 + k0 + kr, col = n0 + c;
      Bs[kr][c] = (xr < a.x_rows && col < a.C) ? x[(size_t)xr * a.C + col]
                                                : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32Depth; ++kk) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[kk][ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (size_t)r * kBlock + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < a.C) emit_float<float>(a, row * a.C + col, acc[i][j]);
    }
  }
}

// ------------------------------------------------- bfloat16 and int8 (wmma)
// Tile 128 x 128, 8 warps as 4 (rows) x 2 (columns), each warp 32 x 64 as
// 2 x 4 fragments of 16 x 16.  Shared operands are kept as 16-wide panels
// with a padded leading dimension (kLd elements) so that every fragment
// pointer is 32-byte aligned for both element sizes.
constexpr int kTcCols = 128;
constexpr int kTcDepth = 32;

template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kLd = 24;
};
template <> struct Tc<int8_t> {
  using Acc = int;
  static constexpr int kLd = 32;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) band_tc_kernel(Args a) {
  constexpr int L = kRagged;
  using Acc = typename Tc<T>::Acc;
  constexpr int kLd = Tc<T>::kLd;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(128) T As[kTcDepth / 16][kBlock * kLd];  // [row][k]
  __shared__ __align__(128) T Bs[kTcCols / 16][kTcDepth * kLd];  // [k][n]
  __shared__ __align__(128) Acc Cs[kThreads / 32][16 * 16];

  const int r = blockIdx.y;
  const int n0 = blockIdx.x * kTcCols;
  const T* band;
  int K, xrow0;
  row_setup<L>(a, r, band, K, xrow0);
  const T* x = static_cast<const T*>(a.x);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const bool x_vec = (a.C % kVec) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  for (int k0 = 0; k0 < K; k0 += kTcDepth) {
    constexpr int kVa = kTcDepth / kVec;  // 16-byte vectors per band row
    for (int v = tid; v < kBlock * kVa; v += kThreads) {
      const int row = v / kVa, kv = (v % kVa) * kVec;
      *reinterpret_cast<uint4*>(&As[kv / 16][row * kLd + kv % 16]) =
          *reinterpret_cast<const uint4*>(band +
                                          band_off<L>(row, k0 + kv, K));
    }
    constexpr int kVb = kTcCols / kVec;  // 16-byte vectors per x row
    for (int v = tid; v < kTcDepth * kVb; v += kThreads) {
      const int kr = v / kVb, nv = (v % kVb) * kVec;
      const int xr = xrow0 + k0 + kr, col = n0 + nv;
      T* dst = &Bs[nv / 16][kr * kLd + nv % 16];
      const T* src = x + (size_t)xr * a.C + col;
      if (x_vec) {
        uint4 val = make_uint4(0, 0, 0, 0);
        if (xr < a.x_rows && col < a.C) {
          val = *reinterpret_cast<const uint4*>(src);
        }
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        for (int e = 0; e < kVec; ++e) {
          dst[e] = (xr < a.x_rows && col + e < a.C) ? src[e] : zero<T>();
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcDepth / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[kk][(wm * 32 + i * 16) * kLd], kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[wn * 4 + j][kk * 16 * kLd], kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Emission: each warp stages one fragment at a time in its own scratch.
  Acc* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const size_t row = (size_t)r * kBlock + wm * 32 + i * 16 + e / 16;
        const int col = n0 + wn * 64 + j * 16 + e % 16;
        if (col < a.C) {
          if constexpr (std::is_same<T, int8_t>::value) {
            emit_quant(a, row * a.C + col, cs[e]);
          } else {
            emit_float<T>(a, row * a.C + col, cs[e]);
          }
        }
      }
      __syncwarp();
    }
  }
}

int launch_tile(const Args& a, int n_block_rows, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0: {
      dim3 grid((a.C + kF32Cols - 1) / kF32Cols, n_block_rows);
      band_f32_kernel<<<grid, kThreads, 0, s>>>(a);
      break;
    }
    case 1: {
      dim3 grid((a.C + kTcCols - 1) / kTcCols, n_block_rows);
      band_tc_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
      break;
    }
    case 2: {
      dim3 grid((a.C + kTcCols - 1) / kTcCols, n_block_rows);
      band_tc_kernel<int8_t><<<grid, kThreads, 0, s>>>(a);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// layout: 0 dkw, 1 uniform, 2 ragged.  dtype: 0 float32, 1 bfloat16,
// 2 int8.  Unused band slots take a null pointer and width 0 (uniform and
// ragged pass one band; uniform one width, W).  nz_rowptr (int32) and
// nz_win (int16) are the row index that layouts 0 and 1 walk; layout 2
// takes null pointers.  The output has n_block_rows * 128 rows; y may
// equal x0.  c needs x0 and a float dtype.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for bad arguments).
extern "C" int band_launch(int layout, const void* band0, const void* band1,
                           const void* band2, const void* band3, int w0,
                           int w1, int w2, int w3, const void* base,
                           const void* sched, const void* nz_rowptr,
                           const void* nz_win, int n_block_rows, int nsb,
                           int G, const void* x, int x_rows, const void* x0,
                           const void* c, void* y, int C, float band_scale,
                           int dtype, void* stream) {
  if (n_block_rows < 1 || C < 1 ||
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
      return launch_rows<kDkw>(a, n_block_rows, dtype, s);
    case kUniform:
      return launch_rows<kUniform>(a, n_block_rows, dtype, s);
    case kRagged:
      return launch_tile(a, n_block_rows, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
