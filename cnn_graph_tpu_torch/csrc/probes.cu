// Tensor-core probes for Hopper (sm_90a): the in-kernel rate of the
// banded kernels' CTA tile, measured with the operands next to the SM.
//
// Replaces the three Pallas probes of experiments/_probe.py:
//   P1  _mxu_probe     (:136, kernel body :153-184)  mxu_kernel
//   P2  _pred_probe    (:235, kernel body :253-271)  pred_kernel
//   P3  main_loopcost  (:372, kernel body :393-409)  loopcost_kernel
// Each computes the TPU probe's function (utils/probes.py has the plain
// PyTorch version of each, *_reference), not its block structure.
//
// P1: a [taps, m, k/taps], b [taps, k/taps, n]; the carry starts at
// zeros [128, n].  Each iteration computes
//   taps > 1:  acc = sum_d a[d] @ (b[d] + carry)   (k/taps == 128; bf16
//              add rounded once, int8 add wrapped back to int8)
//   taps == 1: acc = a[0] @ b[0] + a[0][:, :128] @ carry
// then carry = bf16(acc[:128] * 1e-6), or int8(acc[:128] >> 12) wrapped.
// f32 accumulation for bf16, int32 for int8.  Rows 128.. of acc feed no
// carry; they are folded into `extra`, extra += acc[128c : 128c + 128] for
// c = m/128 - 1 down to 1, every iteration, so that nothing is dead.
// P2: a [taps, 128, 128], b [taps, 128, n] bf16; each iteration
//   acc = a[0] @ carry, then acc += a[d] @ b[d] for d < taps where
//   !cond or d < widths[i % nw]; carry = bf16(acc * 1e-6).
// P3: a [16, 128, 128], b [16, 128, n] bf16; acc = f32(seed); n_dots/U
//   iterations of U dots acc += a[j % 16] @ b[j % 16], j = i*U + d;
//   out = bf16(acc * 1e-3).
//
// Design.  The TPU probes keep every operand resident in VMEM.  Here the
// operands (under 10 MB for every probe) stay in L2 and are walked
// through shared memory with the CTA tiling of the banded tile kernels
// that K1, K5, K6 and K4 ran until the row walks replaced them: a 128 x
// 128 output tile, 8 warps as 4 x 2, each warp 2 x 4 wmma 16x16x16
// fragments, 32-deep K chunks staged once per chunk with no pipelining.
// So the probes measure the ceiling of that tile, which no kernel of the
// port runs any more.  Every column tile evolves independently (the
// carry's columns feed only their own tile), so one CTA owns one column
// tile for all iterations and keeps its carry in shared memory; for m >
// 128 it walks the row chunks in turn, chunk 0 last so that the carry is
// updated in place.  gridDim.y replicas of the same work, each writing its own
// output, fill the card.  What bounds it: the tensor cores' rate through
// wmma with unpipelined shared-memory staging; the operand bytes come
// from L2 every iteration.
//
// Build without --use_fast_math: the int8 arithmetic and the bf16
// roundings must be IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 128;  // CTA output rows and columns; carry rows
constexpr int kThreads = 256;
constexpr int kDepth = 32;  // K chunk staged per step (band.cu kTcDepth)

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
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16,
                               typename Tc<T>::Acc>;

// Dynamic shared memory: A and B chunk panels as in band.cu, a 16 x 16
// accumulator scratch per warp, and the [128, 128] carry tile.
template <typename T>
constexpr size_t smem_bytes() {
  return ((kDepth / 16) * kTile * Tc<T>::kLd +
          (kTile / 16) * kDepth * Tc<T>::kLd + kTile * kTile) *
             sizeof(T) +
         (kThreads / 32) * 256 * sizeof(typename Tc<T>::Acc);
}

template <typename T>
struct Smem {
  using Acc = typename Tc<T>::Acc;
  T* As;      // [kDepth/16][128 rows * kLd]: panel kk holds k % 16
  T* Bs;      // [128/16][kDepth * kLd]: panel p holds columns p*16..
  T* carry;   // [128][128] row-major
  Acc* Cs;    // [8 warps][256]
  __device__ explicit Smem(unsigned char* base) {
    As = reinterpret_cast<T*>(base);
    Bs = As + (kDepth / 16) * kTile * Tc<T>::kLd;
    carry = Bs + (kTile / 16) * kDepth * Tc<T>::kLd;
    Cs = reinterpret_cast<Acc*>(carry + kTile * kTile);
  }
};

// Elementwise b + carry of 16 bytes: bf16 in f32 rounded once to bf16,
// int8 in int32 wrapped back to int8 (JAX's astype).
template <typename T> __device__ uint4 add_vec(uint4 x, uint4 y);
template <>
__device__ __forceinline__ uint4 add_vec<__nv_bfloat16>(uint4 x, uint4 y) {
  const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&x);
  const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(&y);
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    o[e] = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(p[e]), __bfloat162float(q[e])));
  }
  return out;
}
template <>
__device__ __forceinline__ uint4 add_vec<int8_t>(uint4 x, uint4 y) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&x);
  const int8_t* q = reinterpret_cast<const int8_t*>(&y);
  uint4 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    o[e] = static_cast<int8_t>(static_cast<int>(p[e]) + static_cast<int>(q[e]));
  }
  return out;
}

// The carry from the accumulator: bf16(acc * 1e-6) or int8(acc >> 12).
__device__ __forceinline__ __nv_bfloat16 to_carry(float v) {
  return __float2bfloat16_rn(__fmul_rn(v, 1e-6f));
}
__device__ __forceinline__ int8_t to_carry(int v) {
  return static_cast<int8_t>(v >> 12);
}

__device__ __forceinline__ float acc_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ int acc_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Where B's chunk comes from.
constexpr int kB = 0;           // B from global memory
constexpr int kBPlusCarry = 1;  // B + carry (P1's tap form)
constexpr int kCarry = 2;       // the carry alone

// acc += A[128, K] @ B[K, 128]: A row-major with leading dimension lda
// (its first row is the CTA's first output row), B row-major with ldb
// (its first column the CTA's first column) or the carry tile.  K is a
// multiple of 32; the carry modes read carry rows 0..K-1 (K <= 128).
template <typename T, int kMode>
__device__ __forceinline__ void tile_mma(AccFrag<T> (&acc)[2][4],
                                         const Smem<T>& sm, const T* A,
                                         int lda, int K, const T* B,
                                         int ldb) {
  constexpr int kLd = Tc<T>::kLd;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    constexpr int kVa = kDepth / kVec;
    for (int v = tid; v < kTile * kVa; v += kThreads) {
      const int row = v / kVa, kv = (v % kVa) * kVec;
      *reinterpret_cast<uint4*>(sm.As + (kv / 16) * kTile * kLd + row * kLd +
                                kv % 16) =
          *reinterpret_cast<const uint4*>(A + (size_t)row * lda + k0 + kv);
    }
    constexpr int kVb = kTile / kVec;
    for (int v = tid; v < kDepth * kVb; v += kThreads) {
      const int kr = v / kVb, nv = (v % kVb) * kVec;
      uint4 val;
      if constexpr (kMode == kCarry) {
        val = *reinterpret_cast<const uint4*>(sm.carry + (k0 + kr) * kTile +
                                              nv);
      } else {
        val = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + kr) * ldb +
                                              nv);
        if constexpr (kMode == kBPlusCarry) {
          val = add_vec<T>(val, *reinterpret_cast<const uint4*>(
                                    sm.carry + (k0 + kr) * kTile + nv));
        }
      }
      *reinterpret_cast<uint4*>(sm.Bs + (nv / 16) * kDepth * kLd + kr * kLd +
                                nv % 16) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i],
                               sm.As + kk * kTile * kLd +
                                   (wm * 32 + i * 16) * kLd,
                               kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j],
                               sm.Bs + (wn * 4 + j) * kDepth * kLd +
                                   kk * 16 * kLd,
                               kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void zero_frags(AccFrag<T> (&acc)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::fill_fragment(acc[i][j], typename Tc<T>::Acc(0));
}

// f(row, col, value) for every element of the CTA's 128 x 128 tile, each
// warp staging one fragment at a time in its scratch (band.cu's emission).
template <typename T, typename F>
__device__ __forceinline__ void visit(AccFrag<T> (&acc)[2][4],
                                      const Smem<T>& sm, F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  typename Tc<T>::Acc* cs = sm.Cs + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        f(wm * 32 + i * 16 + e / 16, wn * 64 + j * 16 + e % 16, cs[e]);
      }
      __syncwarp();
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero_carry(const Smem<T>& sm) {
  for (int v = threadIdx.x; v < kTile * kTile * (int)sizeof(T) / 16;
       v += kThreads) {
    reinterpret_cast<uint4*>(sm.carry)[v] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
}

// The carry tile to out[replica, 128, n] at the CTA's columns.
template <typename T>
__device__ __forceinline__ void store_carry(const Smem<T>& sm, T* out,
                                            int n, int col0) {
  constexpr int kVec = 16 / sizeof(T);
  T* dst = out + (size_t)blockIdx.y * kTile * n + col0;
  for (int v = threadIdx.x; v < kTile * kTile / kVec; v += kThreads) {
    const int row = v / (kTile / kVec), c = (v % (kTile / kVec)) * kVec;
    *reinterpret_cast<uint4*>(dst + (size_t)row * n + c) =
        *reinterpret_cast<const uint4*>(sm.carry + row * kTile + c);
  }
}

// ------------------------------------------------------------------- P1
template <typename T, bool kTaps, bool kExtra>
__global__ void __launch_bounds__(kThreads)
    mxu_kernel(const T* __restrict__ a, const T* __restrict__ b, T* out,
               typename Tc<T>::Acc* extra, int m, int k, int n, int taps,
               int iters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> sm(smem);
  const int col0 = blockIdx.x * kTile;
  const int kd = k / taps;  // contraction depth of one tap
  const int chunks = m / kTile;
  zero_carry(sm);
  AccFrag<T> acc[2][4], chk[2][4];
  zero_frags<T>(chk);
  for (int it = 0; it < iters; ++it) {
    // Chunk 0 last: its rows make the new carry, written in place once
    // every chunk has read the old one.
    for (int c = chunks - 1; c >= 0; --c) {
      zero_frags<T>(acc);
      const T* arow = a + (size_t)c * kTile * kd;
      if constexpr (kTaps) {
        for (int d = 0; d < taps; ++d) {
          tile_mma<T, kBPlusCarry>(acc, sm, arow + (size_t)d * m * kd, kd,
                                   kd, b + (size_t)d * kd * n + col0, n);
        }
      } else {
        tile_mma<T, kB>(acc, sm, arow, k, k, b + col0, n);
        tile_mma<T, kCarry>(acc, sm, arow, k, kTile, nullptr, 0);
      }
      if (c > 0) {
        if constexpr (kExtra) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int t = 0; t < acc[i][j].num_elements; ++t)
                chk[i][j].x[t] = acc_add(chk[i][j].x[t], acc[i][j].x[t]);
        }
      } else {
        visit<T>(acc, sm, [&](int r, int col, typename Tc<T>::Acc v) {
          sm.carry[r * kTile + col] = to_carry(v);
        });
        __syncthreads();
      }
    }
  }
  store_carry(sm, out, n, col0);
  if constexpr (kExtra) {
    typename Tc<T>::Acc* dst = extra + (size_t)blockIdx.y * kTile * n + col0;
    visit<T>(chk, sm, [&](int r, int col, typename Tc<T>::Acc v) {
      dst[(size_t)r * n + col] = v;
    });
  }
}

// ------------------------------------------------------------------- P2
__global__ void __launch_bounds__(kThreads)
    pred_kernel(const int* __restrict__ widths, int nw,
                const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, __nv_bfloat16* out,
                int taps, int n, int iters, int cond) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> sm(smem);
  const int col0 = blockIdx.x * kTile;
  zero_carry(sm);
  AccFrag<T> acc[2][4];
  for (int it = 0; it < iters; ++it) {
    zero_frags<T>(acc);
    tile_mma<T, kCarry>(acc, sm, a, kTile, kTile, nullptr, 0);
    const int w = widths[it % nw];  // block-uniform: the branch is too
    for (int d = 0; d < taps; ++d) {
      if (!cond || d < w) {
        tile_mma<T, kB>(acc, sm, a + (size_t)d * kTile * kTile, kTile, kTile,
                        b + (size_t)d * kTile * n + col0, n);
      }
    }
    visit<T>(acc, sm, [&](int r, int col, float v) {
      sm.carry[r * kTile + col] = to_carry(v);
    });
    __syncthreads();
  }
  store_carry(sm, out, n, col0);
}

// ------------------------------------------------------------------- P3
template <int U>
__global__ void __launch_bounds__(kThreads)
    loopcost_kernel(const __nv_bfloat16* __restrict__ seed,
                    const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* out,
                    int pairs, int n, int n_dots) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> sm(smem);
  const int col0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * kTile * n + col0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  AccFrag<T> acc[2][4];
  float* cs = sm.Cs + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      for (int e = lane; e < 256; e += 32) {
        const int r = wm * 32 + i * 16 + e / 16;
        const int col = wn * 64 + j * 16 + e % 16;
        cs[e] = __bfloat162float(seed[base + (size_t)r * n + col]);
      }
      __syncwarp();
      wmma::load_matrix_sync(acc[i][j], cs, 16, wmma::mem_row_major);
      __syncwarp();
    }
  }
  for (int i = 0; i < n_dots / U; ++i) {
#pragma unroll
    for (int d = 0; d < U; ++d) {
      const int idx = (i * U + d) % pairs;
      tile_mma<T, kB>(acc, sm, a + (size_t)idx * kTile * kTile, kTile, kTile,
                      b + (size_t)idx * kTile * n + col0, n);
    }
  }
  visit<T>(acc, sm, [&](int r, int col, float v) {
    out[base + (size_t)r * n + col] = __float2bfloat16_rn(__fmul_rn(v, 1e-3f));
  });
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool kTaps, bool kExtra>
int launch_mxu(const void* a, const void* b, void* out, void* extra, int m,
               int k, int n, int taps, int iters, int replicas,
               cudaStream_t s) {
  auto kernel = mxu_kernel<T, kTaps, kExtra>;
  const size_t smem = smem_bytes<T>();
  const int rc = prepare(kernel, smem);
  if (rc != 0) return rc;
  dim3 grid(n / kTile, replicas);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<typename Tc<T>::Acc*>(extra), m, k,
      n, taps, iters);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mxu_t(const void* a, const void* b, void* out, void* extra,
                 int m, int k, int n, int taps, int iters, int replicas,
                 cudaStream_t s) {
  const bool ex = m > kTile;
  if (taps > 1) {
    return ex ? launch_mxu<T, true, true>(a, b, out, extra, m, k, n, taps,
                                          iters, replicas, s)
              : launch_mxu<T, true, false>(a, b, out, extra, m, k, n, taps,
                                           iters, replicas, s);
  }
  return ex ? launch_mxu<T, false, true>(a, b, out, extra, m, k, n, taps,
                                         iters, replicas, s)
            : launch_mxu<T, false, false>(a, b, out, extra, m, k, n, taps,
                                          iters, replicas, s);
}

template <int U>
int launch_loopcost(const void* seed, const void* a, const void* b,
                    void* out, int pairs, int n, int n_dots, int replicas,
                    cudaStream_t s) {
  using T = __nv_bfloat16;
  auto kernel = loopcost_kernel<U>;
  const size_t smem = smem_bytes<T>();
  const int rc = prepare(kernel, smem);
  if (rc != 0) return rc;
  dim3 grid(n / kTile, replicas);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(seed), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), pairs, n, n_dots);
  return (int)cudaGetLastError();
}

}  // namespace

// P1.  a [taps, m, k/taps], b [taps, k/taps, n], out [replicas, 128, n]
// in the operands' dtype (0 bfloat16, 1 int8); extra [replicas, 128, n]
// f32 (bf16) or int32 (int8), written only when m > 128.  m and n are
// multiples of 128; taps > 1 needs k/taps == 128, taps == 1 k a multiple
// of 32 and at least 128.  Returns cudaGetLastError() of the launch.
extern "C" int probe_mxu_launch(const void* a, const void* b, void* out,
                                void* extra, int m, int k, int n, int taps,
                                int iters, int replicas, int dtype,
                                void* stream) {
  if (m < kTile || m % kTile || n < kTile || n % kTile || taps < 1 ||
      k % taps || iters < 0 || replicas < 1 ||
      (taps > 1 && k / taps != kTile) ||
      (taps == 1 && (k % kDepth || k < kTile))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_mxu_t<__nv_bfloat16>(a, b, out, extra, m, k, n, taps,
                                         iters, replicas, s);
    case 1:
      return launch_mxu_t<int8_t>(a, b, out, extra, m, k, n, taps, iters,
                                  replicas, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// P2.  widths int32 [nw] on the device, a [taps, 128, 128], b [taps, 128,
// n] bfloat16, out [replicas, 128, n]; cond 0 runs every tap.
extern "C" int probe_pred_launch(const void* widths, int nw, const void* a,
                                 const void* b, void* out, int taps, int n,
                                 int iters, int cond, int replicas,
                                 void* stream) {
  if (nw < 1 || taps < 1 || n < kTile || n % kTile || iters < 0 ||
      replicas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  using T = __nv_bfloat16;
  const size_t smem = smem_bytes<T>();
  const int rc = prepare(pred_kernel, smem);
  if (rc != 0) return rc;
  dim3 grid(n / kTile, replicas);
  pred_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(widths), nw, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), taps, n, iters, cond);
  return (int)cudaGetLastError();
}

// P3.  seed and out [replicas, 128, n], a [pairs, 128, 128], b [pairs,
// 128, n], all bfloat16; n_dots a multiple of unroll (1, 2, 4 or 8).
extern "C" int probe_loopcost_launch(const void* seed, const void* a,
                                     const void* b, void* out, int pairs,
                                     int n, int n_dots, int unroll,
                                     int replicas, void* stream) {
  if (pairs < 1 || n < kTile || n % kTile || n_dots < 0 || replicas < 1 ||
      unroll < 1 || n_dots % unroll) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unroll) {
    case 1:
      return launch_loopcost<1>(seed, a, b, out, pairs, n, n_dots, replicas,
                                s);
    case 2:
      return launch_loopcost<2>(seed, a, b, out, pairs, n, n_dots, replicas,
                                s);
    case 4:
      return launch_loopcost<4>(seed, a, b, out, pairs, n, n_dots, replicas,
                                s);
    case 8:
      return launch_loopcost<8>(seed, a, b, out, pairs, n, n_dots, replicas,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
