// Fused dense Chebyshev convolution (K2) and its weight gradient (K3), for
// Hopper (sm_90a).
//
// Replaces the TPU kernels cnn_graph_tpu/ops/pallas_cheby.py:_kernel (K2,
// reached through cheby_conv_fused) and :_dw_kernel (K3, cheby_dw_fused):
//   K2:  y[:, b*O + o]  = sum_k (T_k(L) x)[:, b*F + f] W_k[f, o]
//   K3:  out[cta, k, f, s*O + o] = sum_m (T_k(L) x)[m, b*F + f] g[m, b*O + o]
//        for the CTA's samples b = cta*S + s; the wrapper folds CTAs and
//        samples with a plain sum, as the JAX package folds its tiles.
// with T_0 = x, T_1 = L x, T_k = 2 L T_{k-1} - T_{k-2}.  Columns are
// batch-major (c = b*F + f), so a sample's F columns are contiguous.
//
// Arithmetic (as _kernel :74-95 and _dw_kernel :229-239): the carries T_k
// are float32 for both operator types.  A bfloat16 operator rounds only
// the operands of each product to bfloat16 (L is stored so; the carry, the
// tap weights and, for K3, g are rounded when loaded) and accumulates in
// float32 with FMA: the product of two bfloat16 values is exact in f32.
// K3 also rounds each (CTA, sample, hop) partial to bfloat16 once, as the
// TPU kernel rounds P * diag_mask before its fold.  float32 operators take
// every value as it is.
//
// Design.  Columns of the recurrence are independent, so one CTA owns the
// columns of S whole samples (tc = S*F: one sample when F >= 32) and runs
// all K hops itself, with __syncthreads() between a hop and the next: no
// grid-wide sync and no atomics.  This replaces the TPU's sequential grid
// over column tiles.  The TPU keeps L resident in VMEM; here the 976-node
// f32 L is 3.8 MB against 227 KB of shared memory, so L stays in the 50 MB
// L2 and every CTA rereads it once per hop.  The two carries of a sample
// (976 x 32 f32 = 125 KB each) do not both fit in shared memory either:
// they live in a per-CTA scratch the wrapper allocates, [n_ctas, 2, mp,
// tc] f32, which stays in L2 too.  T_k overwrites T_{k-2} in place, each
// element read and written by the same thread.  Every product (the hop
// L @ T, the tap T_k W_k, K3's g^T T_k) is one register-tiled FMA GEMM:
// a 256-thread CTA covers a (4096/BN) x BN output tile, 4 x 4 per thread,
// staging 16-deep chunks of both operands in shared memory with the next
// chunk prefetched into registers.  The tap accumulates into the CTA's
// own output columns of y in device memory, read and written by the same
// thread at every hop.
//
// Bounds.  At the bench's dense_fused shape (976 nodes, B = 100, F = O =
// 32, K = 25) the hops are 146 GFLOP and the taps 5 GFLOP: FMA throughput
// bounds the kernel, on the 100 SMs that 100 one-sample CTAs occupy (of
// 132), with one 8-warp CTA per SM to hide the L2 latency of L and the
// carries.  Left for later: wmma/wgmma for the bfloat16 operator, TMA
// loads of L into a multi-stage ring, several CTAs per sample joined by a
// cluster, and the taps fused into the hop's epilogue.
//
// Build without --use_fast_math: the rounding above is IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 16;    // contraction chunk staged in shared memory
constexpr int kMaxRows = 128;  // BM for BN = 32
constexpr int kMaxCols = 64;   // BN for tc > 32

struct Args {
  const void* L;   // [mp, mp], compute dtype
  const float* x;  // [mp, B*F]
  const void* w;   // [K, F, O], compute dtype (K2 only)
  const float* g;  // [mp, B*O] (K3 only)
  float* out;      // K2: y [mp, B*O]; K3: [n_ctas, K, F, S*O]
  float* scratch;  // [n_ctas, 2, mp, S*F]
  int mp, K, F, O, B, S;
};

struct Smem {
  float a[kDepth][kMaxRows + 4];  // [k][row]
  float b[kDepth][kMaxCols + 4];  // [k][col]
};

// An operand as the product sees it: bfloat16 storage is exact in f32;
// f32 values are rounded to bfloat16 first when kRound.
template <bool kRound>
__device__ __forceinline__ float op(float v) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <bool kRound>
__device__ __forceinline__ float op(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[i][j] = sum_{q < Kd} A(r0 + ty*4 + i, q) * B(q, c0 + tx*4 + j) with
// A(r, q) = A[r*sar + q*saq] (zero for r >= M) and B(q, c) = B[q*sbq + c]
// (zero for c >= N).  Ends with __syncthreads(), so the caller may start
// another tile at once.
template <int BN, bool kRound, typename TA, typename TB>
__device__ void gemm_tile(const TA* A, long sar, long saq, const TB* B,
                          long sbq, int M, int N, int Kd, int r0, int c0,
                          Smem& sm, float (&acc)[4][4]) {
  constexpr int BM = kThreads * 16 / BN;
  constexpr int NA = BM * kDepth / kThreads;
  constexpr int NB = kDepth * BN / kThreads;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4), ty = tid / (BN / 4);
  // Neighbouring threads read neighbouring addresses of A along whichever
  // axis is contiguous.
  const bool q_fast = saq == 1;
  float ra[NA], rb[NB];

  auto load = [&](int q0) {
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      const int e = tid + t * kThreads;
      const int r = q_fast ? e / kDepth : e % BM;
      const int q = q_fast ? e % kDepth : e / BM;
      const int gr = r0 + r, gq = q0 + q;
      ra[t] = (gr < M && gq < Kd) ? op<kRound>(A[gr * sar + gq * saq]) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const int e = tid + t * kThreads;
      const int q = e / BN, c = e % BN;
      const int gq = q0 + q, gc = c0 + c;
      rb[t] = (gq < Kd && gc < N) ? op<kRound>(B[gq * sbq + gc]) : 0.0f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      const int e = tid + t * kThreads;
      const int r = q_fast ? e / kDepth : e % BM;
      const int q = q_fast ? e % kDepth : e / BM;
      sm.a[q][r] = ra[t];
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const int e = tid + t * kThreads;
      sm.b[e / BN][e % BN] = rb[t];
    }
  };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load(0);
  store();
  __syncthreads();
  for (int q0 = 0; q0 < Kd; q0 += kDepth) {
    const bool more = q0 + kDepth < Kd;
    if (more) load(q0 + kDepth);
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[q][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[q][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }
}

// One CTA per S samples; kDw selects K3's emission over K2's tap.
template <int BN, typename T, bool kDw>
__global__ void __launch_bounds__(kThreads) cheby_fused_kernel(Args a) {
  constexpr bool kRound = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BM = kThreads * 16 / BN;
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4), ty = tid / (BN / 4);
  const int cta = blockIdx.x;
  const int mp = a.mp, F = a.F, O = a.O;
  const int tc = a.S * F;
  const long ldx = (long)a.B * F, ldo = (long)a.B * O;
  const long col0 = (long)cta * tc;
  const int ncols = ldx - col0 < tc ? (int)(ldx - col0) : tc;
  const int nsamp = ncols / F;
  const T* L = static_cast<const T*>(a.L);
  const float* x = a.x + col0;
  float* buf[2] = {a.scratch + (size_t)cta * 2 * mp * tc,
                   a.scratch + ((size_t)cta * 2 + 1) * mp * tc};
  float acc[4][4];

  for (int k = 0; k < a.K; ++k) {
    if (k >= 1) {
      // T_k = L T_{k-1} (k = 1) or 2 L T_{k-1} - T_{k-2}, into buf[k % 2].
      const float* src = k == 1 ? x : buf[(k - 1) % 2];
      const long lds = k == 1 ? ldx : tc;
      const float* prev = k == 2 ? x : buf[k % 2];
      const long ldp = k == 2 ? ldx : tc;
      float* dst = buf[k % 2];
      for (int r0 = 0; r0 < mp; r0 += BM) {
        for (int c0 = 0; c0 < ncols; c0 += BN) {
          gemm_tile<BN, kRound>(L, mp, 1, src, lds, mp, ncols, mp, r0, c0,
                                sm, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + ty * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + tx * 4 + j;
              if (r < mp && c < ncols) {
                float v = acc[i][j];
                if (k >= 2) v = __fsub_rn(2.0f * v, prev[r * ldp + c]);
                dst[(long)r * tc + c] = v;
              }
            }
          }
        }
      }
      __syncthreads();  // T_k complete before anyone reads it
    }
    const float* tk = k == 0 ? x : buf[k % 2];
    const long ldt = k == 0 ? ldx : tc;
    for (int s = 0; s < nsamp; ++s) {
      const long b = (long)cta * a.S + s;
      if (!kDw) {
        // Tap: y[:, b*O + o] += T_k[:, s*F + f] W_k[f, o].
        const T* wk = static_cast<const T*>(a.w) + (long)k * F * O;
        for (int r0 = 0; r0 < mp; r0 += BM) {
          for (int c0 = 0; c0 < O; c0 += BN) {
            gemm_tile<BN, kRound>(tk + s * F, ldt, 1, wk, O, mp, O, F, r0,
                                  c0, sm, acc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = r0 + ty * 4 + i;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = c0 + tx * 4 + j;
                if (r < mp && c < O) {
                  float* yp = a.out + r * ldo + b * O + c;
                  *yp = k == 0 ? acc[i][j] : __fadd_rn(*yp, acc[i][j]);
                }
              }
            }
          }
        }
      } else {
        // dW_k^T for sample b: rows o, columns f, contraction over nodes.
        const float* gb = a.g + b * O;
        float* outk = a.out + ((long)cta * a.K + k) * F * a.S * O + s * O;
        for (int r0 = 0; r0 < O; r0 += BM) {
          for (int c0 = 0; c0 < F; c0 += BN) {
            gemm_tile<BN, kRound>(gb, 1, ldo, tk + s * F, ldt, O, F, mp, r0,
                                  c0, sm, acc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int o = r0 + ty * 4 + i;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int f = c0 + tx * 4 + j;
                if (o < O && f < F) {
                  outk[(long)f * a.S * O + o] = op<kRound>(acc[i][j]);
                }
              }
            }
          }
        }
      }
    }
  }
}

template <int BN, typename T>
cudaError_t launch_dtype(const Args& a, int n_ctas, bool dw, cudaStream_t s) {
  if (dw) {
    cheby_fused_kernel<BN, T, true><<<n_ctas, kThreads, 0, s>>>(a);
  } else {
    cheby_fused_kernel<BN, T, false><<<n_ctas, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(const Args& a, int n_ctas, int dtype, bool dw,
                      cudaStream_t s) {
  if (dtype == 0) return launch_dtype<BN, float>(a, n_ctas, dw, s);
  return launch_dtype<BN, __nv_bfloat16>(a, n_ctas, dw, s);
}

}  // namespace

// K2 (dw == 0: w given, g null, out = y [mp, B*O]) or K3 (dw == 1: g
// given, w null, out = [ceil(B/S), K, F, S*O], zeroed by the caller for
// the samples past B).  dtype: 0 float32, 1 bfloat16 (L and w).  x, g and
// out are float32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int cheby_fused_launch(const void* L, const void* x, const void* w,
                                  const void* g, void* out, void* scratch,
                                  int mp, int K, int F, int O, int B, int S,
                                  int dtype, int dw, void* stream) {
  if (K < 1 || F < 1 || O < 1 || B < 1 || S < 1 || mp < 1 ||
      (dtype != 0 && dtype != 1) || (dw ? g == nullptr : w == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.L = L;
  a.x = static_cast<const float*>(x);
  a.w = w;
  a.g = static_cast<const float*>(g);
  a.out = static_cast<float*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.mp = mp;
  a.K = K;
  a.F = F;
  a.O = O;
  a.B = B;
  a.S = S;
  const int n_ctas = (B + S - 1) / S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = S * F <= 32
                              ? launch_bn<32>(a, n_ctas, dtype, dw != 0, s)
                              : launch_bn<64>(a, n_ctas, dtype, dw != 0, s);
  return (int)err;
}
