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
// the operands of each product to bfloat16 and accumulates in float32.
// float32 operators take every value as it is.
//
// ----------------------------------------------------------------- K2
// cheby_conv_kernel.  The columns of the recurrence are independent, so
// the wrapper cuts them into column groups of S = 128 / F whole samples
// (128 columns at F = 32 or 64), laid out as [G, mp, np] (np = S*F rounded
// up to 8, pad columns zero).  One thread-block cluster owns a group and
// runs all K hops; its CL CTAs (CL <= 8) split the group's rows, each a
// run of BM-row tiles (BM = 128, or 64 where 128 would leave the card
// under-filled).  The recurrence's dependency (hop k+1 reads every row of
// T_k) is the cluster barrier: each thread writes its rows of T_k, fences,
// arrives (barrier.cluster.arrive.release), runs its tap, and waits
// (barrier.cluster.wait.acquire) before hop k+1.  No grid-wide sync and
// no atomics; one launch.  The carries live in a scratch the wrapper
// allocates, [G, 2, mp, np] float32 (T_k overwrites T_{k-2}, each element
// read and written by one thread) and, for bfloat16, a second [G, 2, mp,
// np] bfloat16 copy written once per hop beside the float32 one: the next
// hop's and the tap's operand, rounded once as the TPU's src.astype(cdt).
// A float32 operator keeps a transposed copy instead, [G, 2, np, mp], the
// tap's A^T.  The carries of a group (1.9 MB at the bench shape) stay in
// the 50 MB L2.
//
// Every product (the hop L[rows] @ T_{k-1}[:, 128-column pass], and the
// tap T_k[rows] @ Wbd_k, Wbd_k the wrapper's block-diagonal [np, S*O]
// expansion of W_k, so that the S samples tap in one product; a
// 128-column pass of it contracts over its own samples' rows only) is one
// CTA tile GEMM (gemm) with a ring of kStages stages of kChunkBytes-deep A
// and B chunks, loaded with 16-byte cp.async.cg (zero-filled past the
// edges), one __syncthreads per chunk.  bfloat16 operands run
// mma.sync.m16n8k16 bf16 x bf16 -> f32 from ldmatrix fragments, 8 warps
// as 2 x 4 of (BM/2) x 32.  float32 operands run IEEE FMA, an 8 x 8
// register tile per thread (4 x 8 at BM = 64) from float4 reads of A^T
// and B: the hop's A^T is L^T, which the wrapper passes in place of L
// (so the kernel takes any L, as the TPU kernel does), the tap's the
// transposed carry.  Split TF32 (three mma.sync.m16n8k8 per product) held
// K2 to 2e-6 of the plain version's max but moved ChebNet's f32 training
// gradients by 1.15e-3 of their max, past chip_smoke.py's 1e-3; FMA in
// the plain version's summation order matches it exactly, so f32 stays
// on FMA.  Two CTAs per SM (__launch_bounds__, 128 registers), so that
// the bench shape's 25 clusters of 8 fit at once (cheby_conv_resident_
// clusters; chip_smoke.py phase 7 prints it).
//
// Bounds at the bench's dense_fused shape (976 nodes, B = 100, F = O =
// 32, K = 25): the hops are 146 GFLOP, the taps 5 GFLOP (20 GFLOP with
// the block-diagonal taps): 0.153 ms of bf16 tensor-core time, 2.26 ms of
// float32 FMA time; the bytes (L, x, W, y once) are far less.  The
// design's own limits: 25 groups x 8 CTAs = 200 CTAs of one 128 x 128
// tile each on 132 SMs, so 68 SMs run two and the rest one; and each CTA
// streams its L rows (250 KB bf16) and the group's carry (250 KB) from
// L2 once per hop, 2.4 GB over the call (4.8 GB in f32).  Measured by
// chip_smoke.py phase 7 on an H100 SXM at 700 W: bf16 1.65 ms (9% of its
// bound; the first design took 25.56), f32 5.98 ms (38% of its bound;
// the SMs that run two CTAs do 870M FMA each, 57% of the data sheet's
// per-SM FMA rate; the first design took 15.57, torch's f32 matmul chain
// 5.23).  Left for later:
// sharing each carry chunk across the cluster (TMA multicast) instead of
// 8 L2 reads, and the block-diagonal waste inside a tap pass (4x at the
// bench shape).
//
// ----------------------------------------------------------------- K3
// cheby_dw_kernel, the earlier design, to be moved onto K2's: one CTA owns
// the columns of S whole samples (tc = S*F, S = max(1, 32 / F)) and runs
// all K hops itself, with __syncthreads() between a hop and the next; the
// carries live in a per-CTA scratch [n_ctas, 2, mp, tc] f32; every product
// is one register-tiled FMA GEMM (gemm_tile: a 256-thread CTA covers a
// (4096/BN) x BN output tile, 4 x 4 per thread, 16-deep chunks staged in
// shared memory with the next chunk prefetched into registers).  A
// bfloat16 operator rounds the carry and g when loaded; each (CTA, sample,
// hop) partial is rounded to bfloat16 once, as the TPU kernel rounds P *
// diag_mask before its fold.
//
// Build without --use_fast_math: the rounding above is IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// ================================================================== K2

constexpr int kStages = 3;
constexpr int kMinBlocks = 2;  // CTAs per SM (__launch_bounds__)
constexpr int kCols = 128;     // columns of a CTA tile (B chunk width)
// Contraction depth of a stage, in bytes (a multiple of 32: whole bf16
// k16 steps).
constexpr int kChunkBytes = 128;
constexpr int kAPitch = kChunkBytes + 16;  // A row in shared memory, bytes
constexpr int kBLd = kCols + 8;  // B row in shared memory, elements
constexpr int kMaxCluster = 8;

template <typename T>
constexpr int kDepth = kChunkBytes / (int)sizeof(T);

// A stage: bf16 A as BM rows of kAPitch bytes, f32 A^T as kDepth rows of
// BM + 4 floats; B as kDepth rows of kBLd elements, kChunkBytes * kBLd
// bytes for either type.
template <typename T, int BM>
constexpr int kABytes = std::is_same<T, float>::value
                            ? kChunkBytes * (BM + 4)
                            : BM * kAPitch;
template <typename T, int BM>
constexpr int kStageBytes = kABytes<T, BM> + kChunkBytes * kBLd;
template <typename T, int BM>
constexpr int kSmem = kStages * kStageBytes<T, BM>;  // dynamic, per CTA

struct ConvArgs {
  const void* L;   // [mp, mp]: bf16 L, or f32 L^T (the hop's A^T)
  const float* x;  // [G, mp, np]: T_0 per column group
  const void* xc;  // bf16: [G, mp, np], T_0 rounded; f32: [G, np, mp], T_0^T
  const void* w;   // [K, np, nop]: block-diagonal tap weights, compute dtype
  float* y;        // [G, mp, nop]
  float* carry;    // [G, 2, mp, np]
  void* carryc;    // bf16: [G, 2, mp, np] rounded; f32: [G, 2, np, mp], T^T
  int mp, K, np, nop, tiles_per_cta;
  int S, F, O;  // samples per group, their input and output widths
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix from a shared-memory address (bytes).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}

// acc's element f of the FMA tile, (f / 8) its row and f % 8 its column
// slot (below).
#define FMA_ACC(f) acc[(f) / 16][((f) / 4) % 4][(f) % 4]

// One CTA tile product: acc = A[0:BM, 0:Kd] @ B[0:Kd, 0:kCols], B(q, c) =
// B[q*ldb + c] (zero for c >= b_cols); q >= Kd reads as zero.  bf16 takes
// A(r, q) = A[r*lda + q], f32 its transpose, A(r, q) = A[q*lda + r]; A
// reads zero for r >= a_rows.  lda, ldb, a_rows, Kd, b_cols and the row
// starts are multiples of 8 elements and the pointers 16-byte aligned, so
// every 16-byte vector is whole inside or outside.
//   bf16: warp w owns rows (w/4)*(BM/2) + [0, BM/2) and columns (w%4)*32 +
// [0, 32); acc[mi][ni] is the m16n8 fragment (rows mi*16 + lane/4 (+8),
// columns ni*8 + 2*(lane%4) (+1)) of mma.sync.m16n8k16 products.
//   f32: thread (ty, tx) = (tid / 16, tid % 16) owns rows rq*64 + ty*4 +
// [0, 4) for rq < BM/64 and columns cq*64 + tx*4 + [0, 4) for cq < 2,
// accumulated by FMA from float4 reads of A^T and B: FMA_ACC((rq*4 + i)*8
// + cq*4 + j).
// Ends with every copy landed and __syncthreads().
template <typename T, int BM>
__device__ __forceinline__ void gemm(const T* A, int lda, int a_rows,
                                     const T* B, int ldb, int b_cols, int Kd,
                                     unsigned char* smem,
                                     float (&acc)[BM / 32][4][4]) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kBK = kDepth<T>;
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int kALd = kBf16 ? kAPitch / (int)sizeof(T) : BM + 4;
  constexpr int MI = BM / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nk = (Kd + kBK - 1) / kBK;

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  auto sa = [&](int s) {
    return reinterpret_cast<T*>(smem + s * kStageBytes<T, BM>);
  };
  auto sb = [&](int s) {
    return reinterpret_cast<T*>(smem + s * kStageBytes<T, BM> +
                                kABytes<T, BM>);
  };
  auto load = [&](int s, int q0) {
    T* a = sa(s);
    T* b = sb(s);
    if constexpr (kBf16) {
      constexpr int kAVecs = BM * (kChunkBytes / 16);
      for (int v = tid; v < kAVecs; v += kThreads) {
        const int r = v / (kChunkBytes / 16);
        const int q = (v % (kChunkBytes / 16)) * kVec;
        const bool ok = r < a_rows && q0 + q < Kd;
        cp_async16(a + r * kALd + q, ok ? A + (size_t)r * lda + q0 + q : A,
                   ok);
      }
    } else {
      constexpr int kAVecs = kBK * (BM / kVec);
      for (int v = tid; v < kAVecs; v += kThreads) {
        const int q = v / (BM / kVec), r = (v % (BM / kVec)) * kVec;
        const bool ok = r < a_rows && q0 + q < Kd;
        cp_async16(a + q * kALd + r, ok ? A + (size_t)(q0 + q) * lda + r : A,
                   ok);
      }
    }
    constexpr int kBRowVecs = kCols / kVec;
    constexpr int kBVecs = kBK * kBRowVecs;
    for (int v = tid; v < kBVecs; v += kThreads) {
      const int q = v / kBRowVecs, c = (v % kBRowVecs) * kVec;
      const bool ok = q0 + q < Kd && c < b_cols;
      cp_async16(b + q * kBLd + c, ok ? B + (size_t)(q0 + q) * ldb + c : B,
                 ok);
    }
  };
  // This lane's ldmatrix row addresses in stage 0 (bf16), so that every
  // fragment's address is a constant offset from them.
  const int wm = warp / 4, wn = warp % 4;
  const uint32_t a_lane =
      smem_addr(smem) +
      ((wm * (BM / 2) + lane % 16) * kALd + 8 * (lane / 16)) * 2;
  const uint32_t b_lane =
      smem_addr(smem) + kABytes<T, BM> +
      ((lane % 8 + 8 * ((lane / 8) % 2)) * kBLd + wn * 32 + 8 * (lane / 16)) *
          2;
  auto compute = [&](int s) {
    if constexpr (kBf16) {
      const uint32_t as = a_lane + s * kStageBytes<T, BM>;
      const uint32_t bs = b_lane + s * kStageBytes<T, BM>;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t bf[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bs + (kk * kBLd + p * 16) * 2);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t af[4];
          ldmatrix_x4(af, as + (mi * 16 * kALd + kk) * 2);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], af, bf[ni][0], bf[ni][1]);
        }
      }
    } else {
      const T* a = sa(s);
      const T* b = sb(s);
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[BM / 64][4], bv[2][4];
#pragma unroll
        for (int rq = 0; rq < BM / 64; ++rq) {
          const float4 v = *reinterpret_cast<const float4*>(
              a + kk * kALd + rq * 64 + ty * 4);
          av[rq][0] = v.x;
          av[rq][1] = v.y;
          av[rq][2] = v.z;
          av[rq][3] = v.w;
        }
#pragma unroll
        for (int cq = 0; cq < 2; ++cq) {
          const float4 v = *reinterpret_cast<const float4*>(
              b + kk * kBLd + cq * 64 + tx * 4);
          bv[cq][0] = v.x;
          bv[cq][1] = v.y;
          bv[cq][2] = v.z;
          bv[cq][3] = v.w;
        }
#pragma unroll
        for (int rq = 0; rq < BM / 64; ++rq)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cq = 0; cq < 2; ++cq)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                FMA_ACC((rq * 4 + i) * 8 + cq * 4 + j) =
                    fmaf(av[rq][i], bv[cq][j],
                         FMA_ACC((rq * 4 + i) * 8 + cq * 4 + j));
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kt landed; every warp done with chunk kt-1
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next * kBK);
    cp_async_commit();
    compute(kt % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Visit each element of a bf16 gemm tile: f(row, col, v0, v1) for the
// column pair (col, col + 1) of row `row`, both tile-relative.
template <int BM, typename Fn>
__device__ __forceinline__ void for_pairs(float (&acc)[BM / 32][4][4],
                                          Fn f) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = (warp / 4) * (BM / 2) + lane / 4;
  const int c0 = (warp % 4) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < BM / 32; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      f(r0 + mi * 16, c0 + ni * 8, acc[mi][ni][0], acc[mi][ni][1]);
      f(r0 + mi * 16 + 8, c0 + ni * 8, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// Visit each 4 x 4 block of an f32 gemm tile: f(row, col, v), v[i][j] the
// element (row + i, col + j), both tile-relative.
template <int BM, typename Fn>
__device__ __forceinline__ void for_blocks(float (&acc)[BM / 32][4][4],
                                           Fn f) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int rq = 0; rq < BM / 64; ++rq)
#pragma unroll
    for (int cq = 0; cq < 2; ++cq) {
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[i][j] = FMA_ACC((rq * 4 + i) * 8 + cq * 4 + j);
      f(rq * 64 + ty * 4, cq * 64 + tx * 4, v);
    }
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cheby_conv_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int mp = a.mp, np = a.np, nop = a.nop;
  const size_t gs = (size_t)mp * np;  // one carry of one group
  const int grp = blockIdx.y;
  const T* L = static_cast<const T*>(a.L);
  const float* x = a.x + grp * gs;
  const T* xc = static_cast<const T*>(a.xc) + grp * gs;
  float* buf = a.carry + grp * 2 * gs;
  T* bufc = static_cast<T*>(a.carryc) + grp * 2 * gs;
  float* y = a.y + (size_t)grp * mp * nop;
  const int n_tiles = (mp + BM - 1) / BM;
  const int t0 = blockIdx.x * a.tiles_per_cta;
  const int t1 = min(t0 + a.tiles_per_cta, n_tiles);
  float acc[BM / 32][4][4];

  for (int k = 0; k < a.K; ++k) {
    if (k >= 1) {
      // T_k = L T_{k-1} (k = 1) or 2 L T_{k-1} - T_{k-2}, into buf[k % 2].
      // The f32 product reads A = L as its transpose, a.L = L^T.
      const T* src;
      if constexpr (kBf16) {
        src = k == 1 ? xc : bufc + ((k - 1) & 1) * gs;
      } else {
        src = k == 1 ? x : buf + ((k - 1) & 1) * gs;
      }
      const float* prev = k == 2 ? x : buf + (k & 1) * gs;
      float* dst = buf + (k & 1) * gs;
      T* dstc = bufc + (k & 1) * gs;
      for (int tile = t0; tile < t1; ++tile) {
        const int row0 = tile * BM;
        for (int c0 = 0; c0 < np; c0 += kCols) {
          gemm<T, BM>(L + (kBf16 ? (size_t)row0 * mp : row0), mp, mp - row0,
                      src + c0, np, np - c0, mp, smem, acc);
          if constexpr (kBf16) {
            for_pairs<BM>(acc, [&](int r, int c, float v0, float v1) {
              const int row = row0 + r, col = c0 + c;
              if (row >= mp || col >= np) return;
              const size_t i = (size_t)row * np + col;
              float2 v = make_float2(v0, v1);
              if (k >= 2) {
                const float2 p = *reinterpret_cast<const float2*>(prev + i);
                v.x = __fsub_rn(2.0f * v.x, p.x);
                v.y = __fsub_rn(2.0f * v.y, p.y);
              }
              *reinterpret_cast<float2*>(dst + i) = v;
              *reinterpret_cast<__nv_bfloat162*>(dstc + i) =
                  __floats2bfloat162_rn(v.x, v.y);
            });
          } else {
            // Rows of T_k as float4s, and its transpose [np, mp], the
            // tap's A^T, as float4 columns of 4 rows.
            for_blocks<BM>(acc, [&](int r, int c, float (&v)[4][4]) {
              const int row = row0 + r, col = c0 + c;
              if (row >= mp || col >= np) return;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float4* d = reinterpret_cast<float4*>(
                    dst + (size_t)(row + i) * np + col);
                if (k >= 2) {
                  const float4 p = *reinterpret_cast<const float4*>(
                      prev + (size_t)(row + i) * np + col);
                  v[i][0] = __fsub_rn(2.0f * v[i][0], p.x);
                  v[i][1] = __fsub_rn(2.0f * v[i][1], p.y);
                  v[i][2] = __fsub_rn(2.0f * v[i][2], p.z);
                  v[i][3] = __fsub_rn(2.0f * v[i][3], p.w);
                }
                *d = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                *reinterpret_cast<float4*>(dstc + (size_t)(col + j) * mp +
                                           row) =
                    make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
              }
            });
          }
        }
      }
      if (k + 1 < a.K) {
        __threadfence();
        cluster_arrive();  // this thread's rows of T_k are written
      }
      __syncthreads();  // the tap below reads this CTA's rows of T_k
    }
    // Tap: y[rows, s*O + o] += T_k[rows, s*F + f] W_k[f, o] for the
    // group's samples s, one product with the block-diagonal W_k.  tk is
    // T_k (bf16) or T_k^T (f32).
    const T* tk = k == 0 ? xc : bufc + (k & 1) * gs;
    const T* wk = static_cast<const T*>(a.w) + (size_t)k * np * nop;
    for (int tile = t0; tile < t1; ++tile) {
      const int row0 = tile * BM;
      for (int c0 = 0; c0 < nop; c0 += kCols) {
        // W_k's rows are nonzero in this pass only for the samples whose
        // outputs it writes: contract over those, rounded out to whole
        // 16-byte vectors (the rows added there are zero here).
        const int first = c0 / a.O;
        const int last = (min(c0 + kCols, a.S * a.O) - 1) / a.O;
        const int q0 = first * a.F / 8 * 8;
        const int q1 = min(np, ((last + 1) * a.F + 7) / 8 * 8);
        const T* wq = wk + (size_t)q0 * nop + c0;
        if constexpr (kBf16) {
          gemm<T, BM>(tk + (size_t)row0 * np + q0, np, mp - row0, wq, nop,
                      nop - c0, q1 - q0, smem, acc);
        } else {
          gemm<T, BM>(tk + (size_t)q0 * mp + row0, mp, mp - row0, wq, nop,
                      nop - c0, q1 - q0, smem, acc);
        }
        auto tap = [&](int row, int col, int n, const float* v) {
          float* yp = y + (size_t)row * nop + col;
#pragma unroll
          for (int j = 0; j < n; ++j) {
            yp[j] = k == 0 ? v[j] : __fadd_rn(yp[j], v[j]);
          }
        };
        if constexpr (kBf16) {
          for_pairs<BM>(acc, [&](int r, int c, float v0, float v1) {
            const int row = row0 + r, col = c0 + c;
            if (row >= mp || col >= nop) return;
            const float v[2] = {v0, v1};
            tap(row, col, 2, v);
          });
        } else {
          for_blocks<BM>(acc, [&](int r, int c, float (&v)[4][4]) {
            const int row = row0 + r, col = c0 + c;
            if (row >= mp || col >= nop) return;
#pragma unroll
            for (int i = 0; i < 4; ++i) tap(row + i, col, 4, v[i]);
          });
        }
      }
    }
    if (k >= 1 && k + 1 < a.K) cluster_wait();  // every row of T_k written
  }
}

template <typename T, int BM>
cudaError_t launch_conv(const ConvArgs& a, int cluster, int groups,
                        cudaStream_t s) {
  auto kernel = cheby_conv_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<T, BM>);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem<T, BM>;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t resident(int cluster, int* n) {
  auto kernel = cheby_conv_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<T, BM>);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem<T, BM>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// ================================================================== K3

constexpr int kDwDepth = 16;   // contraction chunk staged in shared memory
constexpr int kMaxRows = 128;  // BM for BN = 32
constexpr int kMaxCols = 64;   // BN for tc > 32

struct DwArgs {
  const void* L;   // [mp, mp], compute dtype
  const float* x;  // [mp, B*F]
  const float* g;  // [mp, B*O]
  float* out;      // [n_ctas, K, F, S*O]
  float* scratch;  // [n_ctas, 2, mp, S*F]
  int mp, K, F, O, B, S;
};

struct Smem {
  float a[kDwDepth][kMaxRows + 4];  // [k][row]
  float b[kDwDepth][kMaxCols + 4];  // [k][col]
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
  constexpr int NA = BM * kDwDepth / kThreads;
  constexpr int NB = kDwDepth * BN / kThreads;
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
      const int r = q_fast ? e / kDwDepth : e % BM;
      const int q = q_fast ? e % kDwDepth : e / BM;
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
      const int r = q_fast ? e / kDwDepth : e % BM;
      const int q = q_fast ? e % kDwDepth : e / BM;
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
  for (int q0 = 0; q0 < Kd; q0 += kDwDepth) {
    const bool more = q0 + kDwDepth < Kd;
    if (more) load(q0 + kDwDepth);
#pragma unroll
    for (int q = 0; q < kDwDepth; ++q) {
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

// One CTA per S samples: the recurrence in the CTA's scratch, then K3's
// emission per sample and hop.
template <int BN, typename T>
__global__ void __launch_bounds__(kThreads) cheby_dw_kernel(DwArgs a) {
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
      // dW_k^T for sample b: rows o, columns f, contraction over nodes.
      const long b = (long)cta * a.S + s;
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

template <int BN>
cudaError_t launch_dw(const DwArgs& a, int n_ctas, int dtype,
                      cudaStream_t s) {
  if (dtype == 0) {
    cheby_dw_kernel<BN, float><<<n_ctas, kThreads, 0, s>>>(a);
  } else {
    cheby_dw_kernel<BN, __nv_bfloat16><<<n_ctas, kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// K2.  L: [mp, mp], bfloat16 L or float32 L^T; x: [groups, mp, np] f32;
// xc: bf16 [groups, mp, np], x rounded, or f32 [groups, np, mp], x
// transposed; w: [K, np, nop] compute dtype, block-diagonal over the S
// samples of a group (F inputs, O outputs each); y: [groups, mp, nop] f32;
// carry: [groups, 2, mp, np] f32; carryc: [groups, 2, mp, np] bf16 or
// [groups, 2, np, mp] f32.  np and nop are multiples of 8, at least S*F
// and S*O; mp a multiple of 8.  rows_per_tile 64 or 128; the grid is
// cluster x groups CTAs, one cluster (cluster <= 8 CTAs) per group, each
// CTA tiles_per_cta row tiles.  dtype: 0 float32, 1 bfloat16.  Launches
// on `stream`; returns the launch's error (a cluster the card cannot
// place is refused, not run otherwise).
extern "C" int cheby_conv_launch(const void* L, const void* x, const void* xc,
                                 const void* w, void* y, void* carry,
                                 void* carryc, int mp, int K, int np, int nop,
                                 int S, int F, int O, int groups, int cluster,
                                 int rows_per_tile, int tiles_per_cta,
                                 int dtype, void* stream) {
  if (K < 1 || mp < 8 || mp % 8 || np < 8 || np % 8 || nop < 8 || nop % 8 ||
      S < 1 || F < 1 || O < 1 || (long)S * F > np || (long)S * O > nop ||
      groups < 1 || cluster < 1 || cluster > kMaxCluster ||
      tiles_per_cta < 1 || (dtype != 0 && dtype != 1) ||
      (rows_per_tile != 64 && rows_per_tile != 128) ||
      (long)cluster * tiles_per_cta * rows_per_tile < mp ||
      (long)(cluster - 1) * tiles_per_cta * rows_per_tile >= mp) {
    return (int)cudaErrorInvalidValue;
  }
  ConvArgs a;
  a.L = L;
  a.x = static_cast<const float*>(x);
  a.xc = xc;
  a.w = w;
  a.y = static_cast<float*>(y);
  a.carry = static_cast<float*>(carry);
  a.carryc = carryc;
  a.mp = mp;
  a.K = K;
  a.np = np;
  a.nop = nop;
  a.tiles_per_cta = tiles_per_cta;
  a.S = S;
  a.F = F;
  a.O = O;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = rows_per_tile == 128
              ? launch_conv<float, 128>(a, cluster, groups, s)
              : launch_conv<float, 64>(a, cluster, groups, s);
  } else {
    err = rows_per_tile == 128
              ? launch_conv<__nv_bfloat16, 128>(a, cluster, groups, s)
              : launch_conv<__nv_bfloat16, 64>(a, cluster, groups, s);
  }
  return (int)err;
}

// How many clusters of `cluster` K2 CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
extern "C" int cheby_conv_resident_clusters(int cluster, int rows_per_tile,
                                            int dtype) {
  int n = 0;
  cudaError_t err;
  if (dtype == 0) {
    err = rows_per_tile == 128 ? resident<float, 128>(cluster, &n)
                               : resident<float, 64>(cluster, &n);
  } else {
    err = rows_per_tile == 128 ? resident<__nv_bfloat16, 128>(cluster, &n)
                               : resident<__nv_bfloat16, 64>(cluster, &n);
  }
  return err == cudaSuccess ? n : -(int)err;
}

// The dynamic shared memory of one K2 CTA, in bytes (its ring of kStages
// stages), or -1 for an instantiation that does not exist.
extern "C" int cheby_conv_smem_bytes(int rows_per_tile, int dtype) {
  if (rows_per_tile != 64 && rows_per_tile != 128) return -1;
  if (dtype == 0) {
    return rows_per_tile == 128 ? kSmem<float, 128> : kSmem<float, 64>;
  }
  if (dtype != 1) return -1;
  return rows_per_tile == 128 ? kSmem<__nv_bfloat16, 128>
                              : kSmem<__nv_bfloat16, 64>;
}

// K3.  out = [ceil(B/S), K, F, S*O], zeroed by the caller for the samples
// past B.  dtype: 0 float32, 1 bfloat16 (L).  x, g and out are float32.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int cheby_dw_launch(const void* L, const void* x, const void* g,
                               void* out, void* scratch, int mp, int K, int F,
                               int O, int B, int S, int dtype, void* stream) {
  if (K < 1 || F < 1 || O < 1 || B < 1 || S < 1 || mp < 1 ||
      (dtype != 0 && dtype != 1) || g == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  DwArgs a;
  a.L = L;
  a.x = static_cast<const float*>(x);
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
  const cudaError_t err = S * F <= 32 ? launch_dw<32>(a, n_ctas, dtype, s)
                                      : launch_dw<64>(a, n_ctas, dtype, s);
  return (int)err;
}
