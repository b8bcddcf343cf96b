// Int8 activation quantisation and dequantisation for Hopper (sm_90a): the
// int8 twins' two conversions (ops/laplacian.py QuantOpMixin.quantize and
// .dequantize, ops/quant.py), each one pass over device memory.
//
// Replaces no TPU kernel: the JAX package leaves both conversions to XLA,
// which fuses each into one pass.  Plain PyTorch runs them as two passes
// (a type-casting copy, then a multiply by the scale) and four (divide,
// round, clamp, cast), moving 13 and 29 bytes an element where 5 is the
// least.  Both kernels give that plain PyTorch's results bit for bit:
//
//   dequant_kernel  y = T(float(q) * s)
//   quant_kernel    q = int8(clamp(rint(T(x / s)), -127, 127))
//
// T is float32, or bfloat16 / float16 rounded to nearest even by the
// intrinsics c10::BFloat16 and c10::Half use on the card.  x / s is an IEEE
// f32 division when s is a device tensor (ATen's DivFunctor, s first cast
// to x's dtype by the caller) and x * (1.0f / s) when s is a host number
// (ATen's div_true_kernel_cuda multiplies by the f32 reciprocal of a CPU
// scalar): the launch takes a device pointer to s for the first and the
// reciprocal for the second.  The kernel reads s through the pointer, so
// the host never waits for it.  rint rounds half to even, as torch.round;
// clamp leaves a NaN as it is, as ATen's does.
//
// Layout.  The input is [B, R, C] with element strides sb, sr and 1; the
// output is contiguous.  ops/quant.py rows_view folds a contiguous input
// into one row (B = R = 1) and rows that follow each other into one.
//
// What bounds them is bytes: 1 read and 4 written an element (dequantise
// to f32), 4 read and 1 written (quantise from f32).  The 50k serving
// request's carries are 50,176 x 512 elements: 128 MB a conversion, 38 us
// at 3.35 TB/s.  Each warp moves tiles of 32 chunks of 16 elements
// (16 int8 bytes): on the int8 side each lane loads or stores one chunk as
// one 16-byte vector, on the wide side the warp's lanes load or store
// consecutive 16-byte vectors, and the tile passes through shared memory
// between the two, so both sides of a warp touch consecutive addresses.
// Several tiles a warp are in flight before the first is used.  Inputs
// whose rows do not start on 16-byte boundaries, or whose rows are not a
// whole number of chunks, take a scalar loop, one element a thread; a
// contiguous input, being one row, takes it only for its last n % 16
// elements.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;          // int8 elements in one 16-byte vector
constexpr int kTile = 32 * kChunk;  // elements a warp moves at once
// Tiles a warp loads before it stores: each quant tile loads 4x the
// bytes.  At 50,176 x 512 (f32) dequant took 47.3 us with 2 or 4 tiles and
// 49.5 with 8; quant 45.5 with 1, 47.1 with 2 and 51.7 with 4.
constexpr int kDequantUnroll = 4;
constexpr int kQuantUnroll = 1;
constexpr long long kMaxBlocks = 132 * 32;

struct Rows {
  long long n;       // B * R * C elements
  long long C, R;    // row length, rows of one batch
  long long sb, sr;  // batch and row strides, elements
  long long nvec;    // leading chunks moved as vectors (the rest: scalar)
  bool flat;         // one row: element e is at offset e
};

__device__ __forceinline__ long long offset_of(const Rows& g, long long e) {
  if (g.flat) return e;
  const long long row = e / g.C;
  return (row / g.R) * g.sb + (row % g.R) * g.sr + (e - row * g.C);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// T from the low bits of a word, and a 16-bit T's bits.
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(
    uint32_t b) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(b));
}
template <>
__device__ __forceinline__ __half from_bits<__half>(uint32_t b) {
  return __ushort_as_half(static_cast<unsigned short>(b));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits(__half v) {
  return __half_as_ushort(v);
}

// Byte k (0-3) of a word as int8.
__device__ __forceinline__ float int8_at(uint32_t w, int k) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * k)) & 0xffu));
}

__device__ __forceinline__ uint32_t byte_to(int8_t v, int k) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * k);
}

template <typename T>
__device__ __forceinline__ T dequant_one(float q, float s) {
  return from_f32<T>(__fmul_rn(q, s));
}

// kDiv: s is the scale (x / s), else its f32 reciprocal (x * s).
template <typename T, bool kDiv>
__device__ __forceinline__ int8_t quant_one(T x, float s) {
  const float f = to_f32(x);
  float v = to_f32(from_f32<T>(kDiv ? __fdiv_rn(f, s) : __fmul_rn(f, s)));
  v = rintf(v);
  if (!isnan(v)) v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<int8_t>(v);
}

// The 16 / sizeof(T) int8 values at src (shared memory) dequantised into
// the 16 bytes at dst.
template <typename T>
__device__ __forceinline__ void dequant16(T* dst, const int8_t* src,
                                          float s) {
  if constexpr (sizeof(T) == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
    float4 o;
    o.x = dequant_one<float>(int8_at(w, 0), s);
    o.y = dequant_one<float>(int8_at(w, 1), s);
    o.z = dequant_one<float>(int8_at(w, 2), s);
    o.w = dequant_one<float>(int8_at(w, 3), s);
    *reinterpret_cast<float4*>(dst) = o;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    const uint32_t in[2] = {w.x, w.y};
    uint32_t out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t word = in[i / 2];
      const int k = 2 * (i % 2);
      out[i] = bits(dequant_one<T>(int8_at(word, k), s)) |
               (bits(dequant_one<T>(int8_at(word, k + 1), s)) << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2],
                                                out[3]);
  }
}

// The 16 / sizeof(T) values of raw quantised into int8 at dst (shared
// memory).
template <typename T, bool kDiv>
__device__ __forceinline__ void quant16(int8_t* dst, int4 raw, float s) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x),
                         static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z),
                         static_cast<uint32_t>(raw.w)};
  if constexpr (sizeof(T) == 4) {
    uint32_t o = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o |= byte_to(quant_one<T, kDiv>(from_bits<T>(w[k]), s), k);
    }
    *reinterpret_cast<uint32_t*>(dst) = o;
  } else {
    uint32_t o[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k / 2] |=
          byte_to(quant_one<T, kDiv>(from_bits<T>(w[k]), s), 2 * (k % 2)) |
          byte_to(quant_one<T, kDiv>(from_bits<T>(w[k] >> 16), s),
                  2 * (k % 2) + 1);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int8_t* __restrict__ q, T* __restrict__ y, Rows g,
                   const float* __restrict__ scale_ptr, float scale) {
  constexpr int kU = kDequantUnroll;
  constexpr int kE = 16 / sizeof(T);  // outputs in one 16-byte store
  __shared__ int4 stage[kWarps][kU][32];
  const float s = scale_ptr != nullptr ? *scale_ptr : scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (g.nvec + 31) / 32, nv = g.nvec * kChunk;
  for (long long t = ((long long)blockIdx.x * kWarps + warp) * kU; t < tiles;
       t += (long long)gridDim.x * kWarps * kU) {
    int4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long c = (t + u) * 32 + lane;
      v[u] = c < g.nvec ? __ldg(reinterpret_cast<const int4*>(
                              q + offset_of(g, c * kChunk)))
                        : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) stage[warp][u][lane] = v[u];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int8_t* tile = reinterpret_cast<const int8_t*>(stage[warp][u]);
#pragma unroll
      for (int j = 0; j < kChunk / kE; ++j) {
        const int w = j * 32 + lane;  // the tile's w-th run of kE
        const long long e = (t + u) * kTile + (long long)w * kE;
        if (e < nv) dequant16<T>(y + e, tile + w * kE, s);
      }
    }
    __syncwarp();
  }
  for (long long e = nv + (long long)blockIdx.x * kThreads + threadIdx.x;
       e < g.n; e += (long long)gridDim.x * kThreads) {
    y[e] = dequant_one<T>(static_cast<float>(q[offset_of(g, e)]), s);
  }
}

template <typename T, bool kDiv>
__global__ void __launch_bounds__(kThreads)
    quant_kernel(const T* __restrict__ x, int8_t* __restrict__ y, Rows g,
                 const float* __restrict__ scale_ptr, float scale) {
  constexpr int kU = kQuantUnroll;
  constexpr int kE = 16 / sizeof(T);       // inputs in one 16-byte load
  constexpr int kLoads = kChunk / kE;      // a lane's loads of one tile
  __shared__ int4 stage[kWarps][kU][32];
  const float s = scale_ptr != nullptr ? *scale_ptr : scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (g.nvec + 31) / 32, nv = g.nvec * kChunk;
  for (long long t = ((long long)blockIdx.x * kWarps + warp) * kU; t < tiles;
       t += (long long)gridDim.x * kWarps * kU) {
    int4 v[kU][kLoads];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const long long e = (t + u) * kTile + (long long)(j * 32 + lane) * kE;
        v[u][j] = e < nv ? __ldg(reinterpret_cast<const int4*>(
                               x + offset_of(g, e)))
                         : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      int8_t* tile = reinterpret_cast<int8_t*>(stage[warp][u]);
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        quant16<T, kDiv>(tile + (j * 32 + lane) * kE, v[u][j], s);
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long c = (t + u) * 32 + lane;
      if (c < g.nvec) {
        *reinterpret_cast<int4*>(y + c * kChunk) = stage[warp][u][lane];
      }
    }
    __syncwarp();
  }
  for (long long e = nv + (long long)blockIdx.x * kThreads + threadIdx.x;
       e < g.n; e += (long long)gridDim.x * kThreads) {
    y[e] = quant_one<T, kDiv>(x[offset_of(g, e)], s);
  }
}

// The rows of an input at p of esize-byte elements, and how many leading
// chunks can be loaded as 16-byte vectors: every row starts on a 16-byte
// boundary and holds whole chunks, or there is one row.
bool rows_of(const void* p, int esize, long long B, long long R, long long C,
             long long sb, long long sr, Rows* g) {
  if (B < 1 || R < 1 || C < 1 || sb < 0 || sr < 0) return false;
  g->n = B * R * C;
  g->C = C;
  g->R = R;
  g->sb = sb;
  g->sr = sr;
  g->flat = B == 1 && R == 1;
  const bool vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   (B == 1 || sb * esize % 16 == 0) &&
                   (R == 1 || sr * esize % 16 == 0) &&
                   (g->flat || C % kChunk == 0);
  g->nvec = vec ? g->n / kChunk : 0;
  return true;
}

int grid_of(const Rows& g, int unroll) {
  const long long tiles = (g.nvec + 31) / 32;
  long long b = (tiles + kWarps * unroll - 1) / (kWarps * unroll);
  const long long rest = (g.n - g.nvec * kChunk + kThreads - 1) / kThreads;
  if (rest > b) b = rest;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

}  // namespace

// dtype (of y for dequant_launch, of x for quant_launch): 0 float32,
// 1 bfloat16, 2 float16.  q, x: [B, R, C] with element strides sb, sr and
// 1; y contiguous, on a 16-byte boundary.  dequant_launch: y = q * s, s
// read at scale_ptr where it is not null, else `scale`.  quant_launch:
// x / s with s read at scale_ptr where it is not null, else x * inv_scale.
// Launch on `stream` and return cudaGetLastError()
// (cudaErrorInvalidValue for bad arguments).
extern "C" int dequant_launch(const void* q, void* y, long long B,
                              long long R, long long C, long long sb,
                              long long sr, const void* scale_ptr,
                              float scale, int dtype, void* stream) {
  Rows g;
  if (!rows_of(q, 1, B, R, C, sb, sr, &g) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_of(g, kDequantUnroll);
  switch (dtype) {
    case 0:
      dequant_kernel<float><<<grid, kThreads, 0, s>>>(
          qp, static_cast<float*>(y), g, sp, scale);
      break;
    case 1:
      dequant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          qp, static_cast<__nv_bfloat16*>(y), g, sp, scale);
      break;
    case 2:
      dequant_kernel<__half><<<grid, kThreads, 0, s>>>(
          qp, static_cast<__half*>(y), g, sp, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant(const void* x, void* y, const Rows& g, const float* sp,
                 float inv_scale, cudaStream_t s) {
  const int grid = grid_of(g, kQuantUnroll);
  const auto* xp = static_cast<const T*>(x);
  auto* yp = static_cast<int8_t*>(y);
  if (sp != nullptr) {
    quant_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, yp, g, sp, 0.0f);
  } else {
    quant_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, yp, g, nullptr,
                                                     inv_scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int quant_launch(const void* x, void* y, long long B, long long R,
                            long long C, long long sb, long long sr,
                            const void* scale_ptr, float inv_scale,
                            int dtype, void* stream) {
  static const int esize[3] = {4, 2, 2};
  Rows g;
  if (dtype < 0 || dtype > 2 ||
      !rows_of(x, esize[dtype], B, R, C, sb, sr, &g) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* sp = static_cast<const float*>(scale_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_quant<float>(x, y, g, sp, inv_scale, s);
    case 1:
      return launch_quant<__nv_bfloat16>(x, y, g, sp, inv_scale, s);
    default:
      return launch_quant<__half>(x, y, g, sp, inv_scale, s);
  }
}
