// Ragged banded SpMM and fused Chebyshev hop on the deep-K-window layout,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel cnn_graph_tpu/ops/pallas_band.py:_kernel_dkw,
// reached through banded_call_dkw (epilogue _emit_row).  Forms ported:
//   y = L @ x                 (x0 == nullptr)
//   y = 2 (L @ x) - x0        (x0 != nullptr)
//   y = 2 (L @ x) - x0 + c    (x0, c != nullptr; float only: the backward
//                              adjoint chain's hop, band_cheby_hop_c)
// in float32 (FMA, f32 accumulation), bfloat16 (tensor cores, f32
// accumulation) and int8 (tensor cores, int32 accumulation, requant
// clip(rint(band_scale * acc [*2 - x0]), +-127) at emission).
//
// Layout.  Block-row r (128 rows of L) belongs to schedule step
// s = r / G; its level is li = sched[1][s], its row in that level's
// array bands[li] ([n_rows, 128, W_l*128]) is sched[0][s] + r % G, and
// its band multiplies the contiguous x window rows
// [base[r]*128, (base[r] + W_l)*128).  The TPU kernel's VMEM x ring, its
// mirror copies, prefetch-ahead and DMA semaphores exist only because x
// arrives there in column blocks; here the window is contiguous in
// device memory, so none of them has a counterpart.  Rows of the
// window past the end of x are read as zeros (the band is zero there).
//
// Design.  One CTA per (block-row, column tile) computes
// [128, W_l*128] @ [W_l*128, tile], staging 32-deep K chunks of band and x
// through shared memory, with no pipelining across chunks.
//
// Bounds.  At the 50,176-node serving graph and C = 512 one call is
// 2 * 2856 blocks * 128^2 * 512 ~ 48 GFLOP and reads the band (47 MB
// int8, 94 MB bf16) once per column tile, i.e. 4x at the 128-wide tiles
// used here: the band re-read and the unpipelined shared-memory staging
// bound it long before the tensor cores do.  Left for later: TMA loads
// into a multi-stage ring, wgmma, a column tile as wide as C so the band
// is read once, and the in-place form (output over x0).  The + c form
// adds one read of c per output element to the emission; the band
// re-read still dominates its bytes.
//
// Build without --use_fast_math: the int8 path is bit-exact with the
// PyTorch reference only with IEEE rounding of every float operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kBlock = 128;   // ops/packing.py BLOCK: band block edge
constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;  // ops/packing.py MAX_LEVELS

struct Args {
  const void* band[kMaxLevels];  // per level [n_rows_l, 128, W_l*128]
  int width[kMaxLevels];         // W_l, in blocks
  const int* base;               // [n_block_rows]
  const int* sched;              // [3, nsb]: row offset, level, (unused)
  int nsb;
  int G;
  const void* x;   // [mp, C]
  const void* x0;  // [mp, C] or nullptr
  const void* c;   // [mp, C] or nullptr (needs x0)
  void* y;         // [mp, C]
  int mp;
  int C;
  float band_scale;  // int8 only
};

// Band row, contraction depth and first x row of block-row r.
template <typename T>
__device__ __forceinline__ void row_setup(const Args& a, int r,
                                          const T*& band, int& K,
                                          int& xrow0) {
  const int s = r / a.G;
  const int li = a.sched[a.nsb + s];
  const int off = a.sched[s] + r % a.G;
  int w = a.width[0];
  const void* b = a.band[0];
  if (li == 1) { w = a.width[1]; b = a.band[1]; }
  if (li == 2) { w = a.width[2]; b = a.band[2]; }
  if (li == 3) { w = a.width[3]; b = a.band[3]; }
  K = w * kBlock;
  band = static_cast<const T*>(b) + (size_t)off * kBlock * K;
  xrow0 = a.base[r] * kBlock;
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

// Float emission: y = acc, 2 acc - x0, or (2 acc - x0) + c in f32, in
// that order with IEEE rounding and no contraction, rounded once to T.
template <typename T>
__device__ __forceinline__ void emit_float(const Args& a, size_t i,
                                           float acc) {
  float y = acc;
  if (a.x0 != nullptr) {
    y = __fsub_rn(__fmul_rn(2.0f, acc),
                  to_float(static_cast<const T*>(a.x0)[i]));
    if (a.c != nullptr) {
      y = __fadd_rn(y, to_float(static_cast<const T*>(a.c)[i]));
    }
  }
  store(static_cast<T*>(a.y) + i, y);
}

// Int8 emission in input-scale units (pallas_band._emit_row, quant branch).
__device__ __forceinline__ void emit_quant(const Args& a, size_t i,
                                           int acc) {
  float y = __fmul_rn(a.band_scale, __int2float_rn(acc));
  if (a.x0 != nullptr) {
    y = __fsub_rn(__fmul_rn(2.0f, y),
                  (float)static_cast<const int8_t*>(a.x0)[i]);
  }
  y = fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  static_cast<int8_t*>(a.y)[i] = (int8_t)y;
}

// ---------------------------------------------------------------- float32
// Register-tiled FMA: tile 128 x 64, each thread 8 rows x 4 columns.
constexpr int kF32Cols = 64;
constexpr int kF32Depth = 16;

__global__ void __launch_bounds__(kThreads) dkw_f32_kernel(Args a) {
  __shared__ float As[kF32Depth][kBlock + 4];  // band chunk, [k][row]
  __shared__ float Bs[kF32Depth][kF32Cols + 4];  // x chunk, [k][col]
  const int r = blockIdx.y;
  const int n0 = blockIdx.x * kF32Cols;
  const float* band;
  int K, xrow0;
  row_setup(a, r, band, K, xrow0);
  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3
  const int ty = tid / 16;  // rows ty*8 .. +7

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kF32Depth) {
#pragma unroll
    for (int t = 0; t < kBlock * kF32Depth / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int row = e / kF32Depth, kk = e % kF32Depth;
      As[kk][row] = band[(size_t)row * K + k0 + kk];
    }
#pragma unroll
    for (int t = 0; t < kF32Depth * kF32Cols / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int kr = e / kF32Cols, c = e % kF32Cols;
      const int xr = xrow0 + k0 + kr, col = n0 + c;
      Bs[kr][c] = (xr < a.mp && col < a.C) ? x[(size_t)xr * a.C + col]
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
__global__ void __launch_bounds__(kThreads) dkw_tc_kernel(Args a) {
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
  row_setup(a, r, band, K, xrow0);
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
          *reinterpret_cast<const uint4*>(band + (size_t)row * K + k0 + kv);
    }
    constexpr int kVb = kTcCols / kVec;  // 16-byte vectors per x row
    for (int v = tid; v < kTcDepth * kVb; v += kThreads) {
      const int kr = v / kVb, nv = (v % kVb) * kVec;
      const int xr = xrow0 + k0 + kr, col = n0 + nv;
      T* dst = &Bs[nv / 16][kr * kLd + nv % 16];
      const T* src = x + (size_t)xr * a.C + col;
      if (x_vec) {
        uint4 val = make_uint4(0, 0, 0, 0);
        if (xr < a.mp && col < a.C) val = *reinterpret_cast<const uint4*>(src);
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        for (int e = 0; e < kVec; ++e) {
          dst[e] = (xr < a.mp && col + e < a.C) ? src[e] : zero<T>();
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

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int8.  Unused level slots take a null
// band and width 0.  c needs x0 and a float dtype.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int band_dkw_launch(const void* band0, const void* band1,
                               const void* band2, const void* band3,
                               int w0, int w1, int w2, int w3,
                               const void* base, const void* sched, int nsb,
                               int G, const void* x, const void* x0,
                               const void* c, void* y, int mp, int C,
                               float band_scale, int dtype, void* stream) {
  if (c != nullptr && (x0 == nullptr || dtype == 2)) {
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
  a.nsb = nsb;
  a.G = G;
  a.x = x;
  a.x0 = x0;
  a.c = c;
  a.y = y;
  a.mp = mp;
  a.C = C;
  a.band_scale = band_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_block_rows = mp / kBlock;
  switch (dtype) {
    case 0: {
      dim3 grid((C + kF32Cols - 1) / kF32Cols, n_block_rows);
      dkw_f32_kernel<<<grid, kThreads, 0, s>>>(a);
      break;
    }
    case 1: {
      dim3 grid((C + kTcCols - 1) / kTcCols, n_block_rows);
      dkw_tc_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
      break;
    }
    case 2: {
      dim3 grid((C + kTcCols - 1) / kTcCols, n_block_rows);
      dkw_tc_kernel<int8_t><<<grid, kThreads, 0, s>>>(a);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
