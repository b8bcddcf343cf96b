// Block-sparse (BSR) SpMM and fused Chebyshev hop, for Hopper (sm_90a).
//
// Two kernels over 128x128 blocks, each in two forms:
//   y = L @ x               (x0 == nullptr)
//   y = 2 (L @ x) - x0      (x0 != nullptr)
// in float32 (FMA, f32 accumulation), bfloat16 (tensor cores through wmma,
// f32 accumulation) and int8 (tensor cores, int32 accumulation, requant
// clip(rint(scale * acc [*2 - x0]), +-127) at emission, as
// pallas_band._emit_row).  Columns of x past C are masked, as the TPU
// kernels pad C to their column tile.
//
// bsr_colstream replaces cnn_graph_tpu/ops/pallas_spmm.py:_kernel_colstream
// (K4, reached through _colstream_call), the default BSR kernel.  It reads
// the column-streamed layout unchanged: group s of G block-rows owns the
// blocks groupptr[s]..groupptr[s+1], ordered by (column, row); block b adds
// blocks[b] @ x[tile gcols[gcolptr[s] + (meta[b] & 0xFFFF)]] to block-row
// s*G + (meta[b] >> 16).  Pad blocks are zero and sit in the group's row 0,
// so they add zero.
//
// bsr_csr replaces _kernel_grouped (K7, _grouped_call), _kernel (K8) and
// _kernel_chunked (K9, both through _bsr_spmm_impl).  The three differ only
// in how the TPU moves blocks into VMEM (a slab per G rows, a per-block DMA
// pipeline, a slab per row); all compute y = L @ x over block-CSR, K7 also
// the hop and int8.  Block-row i owns blocks block_rowptr[i]..
// block_rowptr[i+1]; the zero tails that the TPU layouts carry past the
// last block are never read.
//
// Design.  Both are the banded kernel's design (band.cu) with an
// indexed x tile per block in place of a contiguous window: one CTA per
// (block-row, column tile) walks its blocks, staging 32-deep (16 in f32)
// chunks of block and x tile through shared memory, the accumulators in
// registers.  They differ only in the walk: bsr_csr takes its row's
// extent; bsr_colstream walks its group's run and skips the blocks of the
// group's other rows (a uniform branch on one int per block).  What the
// column-streamed layout is for on the TPU, one fetch of each x tile per
// group, comes here from L2: the G CTAs of one group run side by side and
// read the same tiles, and at C = 512 all of x (51 MB in bf16) about fits
// the 50 MB L2.  A first design that staged each distinct column's tile
// once per group kept the G*128 x 32 accumulators in shared memory and so
// re-staged every block once per 32-column tile: 2.35x slower in bf16,
// 2.51x in int8, 2.86x in f32 (PERF.md section 6).
//
// Bounds.  At the 50k scattered kNN graph (54,328 blocks with the pads)
// and C = 512 one call multiplies 0.91 TFLOP (TOP in int8) and reads each
// block once per 128-column tile (4x, mostly from L2: the 4 CTAs of one
// row run side by side).  Loads and tensor cores do not overlap: one
// staging, one barrier pair, one product per 32-deep chunk.  Left for
// later: cp.async or TMA rings, wgmma, a column tile as wide as C.
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

constexpr int kBlock = 128;  // block edge (ops/packing.py BLOCK)
constexpr int kThreads = 256;

struct Out {
  const void* x0;  // [mp, C] or nullptr
  void* y;         // [mp, C]
  int C;
  float scale;  // int8 only: the block scale
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero() { return 0.0f; }
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

// Emission of element i from its f32 or int32 accumulator: float y = acc
// or 2 acc - x0 in f32 with IEEE rounding, rounded once to T; int8 in
// input-scale units (pallas_band._emit_row, quant branch).
template <typename T, typename Acc>
__device__ __forceinline__ void emit(const Out& o, size_t i, Acc acc) {
  if constexpr (std::is_same<T, int8_t>::value) {
    float y = __fmul_rn(o.scale, __int2float_rn(acc));
    if (o.x0 != nullptr) {
      y = __fsub_rn(__fmul_rn(2.0f, y),
                    (float)static_cast<const int8_t*>(o.x0)[i]);
    }
    y = fminf(fmaxf(rintf(y), -127.0f), 127.0f);
    static_cast<int8_t*>(o.y)[i] = (int8_t)y;
  } else {
    float y = acc;
    if (o.x0 != nullptr) {
      y = __fsub_rn(__fmul_rn(2.0f, y),
                    to_float(static_cast<const T*>(o.x0)[i]));
    }
    store(static_cast<T*>(o.y) + i, y);
  }
}

// Tensor-core element types: accumulator and the padded leading dimension
// of the 16-wide shared panels (every fragment pointer 32-byte aligned).
template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kLd = 24;
};
template <> struct Tc<int8_t> {
  using Acc = int;
  static constexpr int kLd = 32;
};

// Copy rows [0, nrows) x columns [n0, n0 + ncols) of the row-major
// [*, C] matrix src (row 0 at src_row0) into 16-wide panels
// dst[n / 16][r * kLd + n % 16], zeros past column C.  16-byte vectors
// when C allows (the wrapper checks that src starts on 16 bytes).
template <typename T, int kLd>
__device__ __forceinline__ void stage_panels(T* dst, int panel_stride,
                                             const T* src, int src_row0,
                                             int nrows, int n0, int ncols,
                                             int C) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = ncols / kVec;
  const bool vec = (C % kVec) == 0;
  for (int v = threadIdx.x; v < nrows * per_row; v += kThreads) {
    const int r = v / per_row, nv = (v % per_row) * kVec;
    const int col = n0 + nv;
    T* d = dst + (nv / 16) * panel_stride + r * kLd + nv % 16;
    const T* s = src + (size_t)(src_row0 + r) * C + col;
    if (vec) {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (col < C) val = *reinterpret_cast<const uint4*>(s);
      *reinterpret_cast<uint4*>(d) = val;
    } else {
      for (int e = 0; e < kVec; ++e) d[e] = (col + e < C) ? s[e] : zero<T>();
    }
  }
}

// ================================================================ walkers

struct Args {
  const void* blocks;  // [>= blocks walked, 128, 128]
  // block-CSR (bsr_csr)
  const int* rowptr;  // [n_rb + 1]
  const int* cols;    // [>= nb]
  // column-streamed (bsr_colstream)
  const int* meta;      // (row in group << 16) | column slot
  const int* gcols;     // each group's distinct columns
  const int* gcolptr;   // [nsb + 1]
  const int* groupptr;  // [nsb + 1]
  int G;
  const void* x;  // [mp, C]
  Out o;
};

// The run of blocks that block-row r walks.
template <bool kColstream>
__device__ __forceinline__ void row_extent(const Args& a, int r, int& lo,
                                           int& hi) {
  if constexpr (kColstream) {
    lo = a.groupptr[r / a.G];
    hi = a.groupptr[r / a.G + 1];
  } else {
    lo = a.rowptr[r];
    hi = a.rowptr[r + 1];
  }
}

// The first x row of block b's tile, or -1 for a block of another row of
// the group.  Uniform across the CTA.
template <bool kColstream>
__device__ __forceinline__ int block_xrow(const Args& a, int r, int b) {
  if constexpr (kColstream) {
    const int m = a.meta[b];
    if ((int)((unsigned)m >> 16) != r % a.G) return -1;
    return a.gcols[a.gcolptr[r / a.G] + (m & 0xFFFF)] * kBlock;
  } else {
    return a.cols[b] * kBlock;
  }
}

// ============================================================== float32
// Register-tiled FMA: tile 128 x 64, each thread 8 rows x 4 columns.
constexpr int kF32Cols = 64;
constexpr int kF32Depth = 16;

template <bool kColstream>
__global__ void __launch_bounds__(kThreads) bsr_f32_kernel(Args a) {
  __shared__ float As[kF32Depth][kBlock + 4];    // block chunk, [k][row]
  __shared__ float Bs[kF32Depth][kF32Cols + 4];  // x chunk, [k][col]
  const int r = blockIdx.y;
  const int n0 = blockIdx.x * kF32Cols;
  const int C = a.o.C;
  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3
  const int ty = tid / 16;  // rows ty*8 .. +7
  int lo, hi;
  row_extent<kColstream>(a, r, lo, hi);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int b = lo; b < hi; ++b) {
    const int xrow0 = block_xrow<kColstream>(a, r, b);
    if (xrow0 < 0) continue;
    const float* blk =
        static_cast<const float*>(a.blocks) + (size_t)b * kBlock * kBlock;
    for (int k0 = 0; k0 < kBlock; k0 += kF32Depth) {
#pragma unroll
      for (int t = 0; t < kBlock * kF32Depth / kThreads; ++t) {
        const int e = tid + t * kThreads;
        const int row = e / kF32Depth, kk = e % kF32Depth;
        As[kk][row] = blk[row * kBlock + k0 + kk];
      }
#pragma unroll
      for (int t = 0; t < kF32Depth * kF32Cols / kThreads; ++t) {
        const int e = tid + t * kThreads;
        const int kr = e / kF32Cols, c = e % kF32Cols;
        const int col = n0 + c;
        Bs[kr][c] = col < C ? x[(size_t)(xrow0 + k0 + kr) * C + col] : 0.0f;
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
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (size_t)r * kBlock + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < C) emit<float>(a.o, row * C + col, acc[i][j]);
    }
  }
}

// ================================================= bfloat16 and int8 (wmma)
// Tile 128 x 128, 8 warps as 4 (rows) x 2 (columns), each warp 32 x 64 as
// 2 x 4 fragments of 16 x 16.
constexpr int kTcCols = 128;
constexpr int kTcDepth = 32;

template <typename T, bool kColstream>
__global__ void __launch_bounds__(kThreads) bsr_tc_kernel(Args a) {
  using Acc = typename Tc<T>::Acc;
  constexpr int kLd = Tc<T>::kLd;
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(128) T As[kTcDepth / 16][kBlock * kLd];   // [row][k]
  __shared__ __align__(128) T Bs[kTcCols / 16][kTcDepth * kLd];  // [k][n]
  __shared__ __align__(128) Acc Cs[kThreads / 32][16 * 16];

  const int r = blockIdx.y;
  const int n0 = blockIdx.x * kTcCols;
  const int C = a.o.C;
  const T* x = static_cast<const T*>(a.x);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  int lo, hi;
  row_extent<kColstream>(a, r, lo, hi);

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  for (int b = lo; b < hi; ++b) {
    const int xrow0 = block_xrow<kColstream>(a, r, b);
    if (xrow0 < 0) continue;
    const T* blk = static_cast<const T*>(a.blocks) + (size_t)b * kBlock * kBlock;
    for (int k0 = 0; k0 < kBlock; k0 += kTcDepth) {
      constexpr int kVa = kTcDepth / kVec;  // 16-byte vectors per block row
      for (int v = tid; v < kBlock * kVa; v += kThreads) {
        const int row = v / kVa, kv = (v % kVa) * kVec;
        *reinterpret_cast<uint4*>(&As[kv / 16][row * kLd + kv % 16]) =
            *reinterpret_cast<const uint4*>(blk + row * kBlock + k0 + kv);
      }
      stage_panels<T, kLd>(&Bs[0][0], kTcDepth * kLd, x, xrow0 + k0,
                           kTcDepth, n0, kTcCols, C);
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
        if (col < C) emit<T>(a.o, row * C + col, cs[e]);
      }
      __syncwarp();
    }
  }
}

template <bool kColstream>
int launch(const Args& a, int n_rb, int dtype, cudaStream_t s) {
  const int C = a.o.C;
  switch (dtype) {
    case 0:
      bsr_f32_kernel<kColstream>
          <<<dim3((C + kF32Cols - 1) / kF32Cols, n_rb), kThreads, 0, s>>>(a);
      break;
    case 1:
      bsr_tc_kernel<__nv_bfloat16, kColstream>
          <<<dim3((C + kTcCols - 1) / kTcCols, n_rb), kThreads, 0, s>>>(a);
      break;
    case 2:
      bsr_tc_kernel<int8_t, kColstream>
          <<<dim3((C + kTcCols - 1) / kTcCols, n_rb), kThreads, 0, s>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int8.  Each launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad dtype).

extern "C" int bsr_csr_launch(const void* blocks, const void* rowptr,
                              const void* cols, int n_rb, const void* x,
                              const void* x0, void* y, int C, float scale,
                              int dtype, void* stream) {
  Args a = {};
  a.blocks = blocks;
  a.rowptr = static_cast<const int*>(rowptr);
  a.cols = static_cast<const int*>(cols);
  a.x = x;
  a.o = Out{x0, y, C, scale};
  return launch<false>(a, n_rb, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int bsr_colstream_launch(const void* blocks, const void* meta,
                                    const void* gcols, const void* gcolptr,
                                    const void* groupptr, int nsb, int G,
                                    const void* x, const void* x0, void* y,
                                    int C, float scale, int dtype,
                                    void* stream) {
  Args a = {};
  a.blocks = blocks;
  a.meta = static_cast<const int*>(meta);
  a.gcols = static_cast<const int*>(gcols);
  a.gcolptr = static_cast<const int*>(gcolptr);
  a.groupptr = static_cast<const int*>(groupptr);
  a.G = G;
  a.x = x;
  a.o = Out{x0, y, C, scale};
  return launch<true>(a, nsb * G, dtype, static_cast<cudaStream_t>(stream));
}
