// Fused dense Chebyshev convolution (K2) and its weight gradient (K3), for
// Hopper (sm_90a): one kernel template, cheby_conv_kernel, whose tap kind
// (kConvTap or kDwTap) is a template parameter.
//
// Replaces the TPU kernels cnn_graph_tpu/ops/pallas_cheby.py:_kernel (K2,
// reached through cheby_conv_fused) and :_dw_kernel (K3, cheby_dw_fused):
//   K2:  y[:, b*O + o]  = sum_k (T_k(L) x)[:, b*F + f] W_k[f, o]
//   K3:  parts[grp, rank, k, s, o, f] = sum_{m in the CTA's rows}
//            g[m, b*O + o] (T_k(L) x)[m, b*F + f],  b = grp*S + s;
//        the wrapper folds ranks, then samples and groups, with plain
//        sums, as the JAX package folds its tiles.
// with T_0 = x, T_1 = L x, T_k = 2 L T_{k-1} - T_{k-2}.  Columns are
// batch-major (c = b*F + f), so a sample's F columns are contiguous.
//
// Arithmetic (as _kernel :74-95 and _dw_kernel :229-239): the carries T_k
// are float32 for both operator types.  A bfloat16 operator rounds only
// the operands of each product to bfloat16 and accumulates in float32.
// float32 operators take every value as it is.
//
// The recurrence, shared by both taps.  The columns are independent, so
// the wrapper cuts them into column groups of S = 128 / F whole samples
// (128 columns at F = 32 or 64), laid out as [G, mp, np] (np = S*F rounded
// up to 8, pad columns zero).  One thread-block cluster owns a group and
// runs all K hops; its CL CTAs (CL <= 8) split the group's rows, each a
// run of BM-row tiles (BM = 128, or 64 where 128 would leave the card
// under-filled).  The recurrence's dependency (hop k+1 reads every row of
// T_k) is the cluster barrier: each thread writes its rows of T_k, fences,
// arrives (barrier.cluster.arrive.release), runs its tap, and waits
// (barrier.cluster.wait.acquire) before hop k+1.  No grid-wide sync and
// no atomics; one launch.  The carries live in buffers the wrapper
// allocates, [G, 2, mp, np] float32 (T_k overwrites T_{k-2}, each element
// read and written by one thread) and, for bfloat16, a second [G, 2, mp,
// np] bfloat16 copy written once per hop beside the float32 one: the next
// hop's and the tap's operand, rounded once as the TPU's src.astype(cdt).
// A float32 K2 keeps a transposed copy instead, [G, 2, np, mp], its tap's
// A^T; a float32 K3 needs no copy (its tap reads the carry as it is).  The
// carries of a group (1.9 MB at the bench shape) stay in the 50 MB L2.
//
// The taps, after hop k, over the CTA's own rows of T_k:
//   K2: T_k[rows] @ Wbd_k, Wbd_k the wrapper's block-diagonal [np, S*O]
// expansion of W_k, so that the S samples tap in one product; a 128-column
// pass of it contracts over its own samples' rows only; added into y.
//   K3: g[rows, S*O columns] and T_k[rows, np columns] contracted over
// the CTA's rows (tiles_per_cta * BM, clipped to mp); the product's S
// diagonal [O, F] blocks are dW_k^T's partials over those rows, written
// to parts[G, CL, K, S, O, F] float32 (the off-diagonal blocks are
// computed and dropped, as K2's tap computes its block-diagonal zeros).
// bfloat16 computes P_k = g^T T_k [S*O, np], from the wrapper's rounded
// transpose of g [G, nop, mp] (gemm's bf16 A is row-major) and the
// rounded carry copy; float32 computes P_k^T = T_k^T g [np, S*O], its A^T
// the f32 carry as it is and B g [G, mp, nop], so it copies nothing, and
// its rows run over F (ChebNet's layer 1, F = 32 < O = 64: half P_k's
// passes).  Row passes of BM rows take the columns of their own samples
// only.  The wrapper sums the ranks in float32, rounds each (sample, hop)
// sum to the operator's dtype (the TPU's (P * diag_mask).astype(cdt),
// over all the nodes), then sums samples and groups.  No atomics: the
// result is the same run to run.
//
// Every product (the hop L[rows] @ T_{k-1}[:, 128-column pass], and either
// tap) is one CTA tile GEMM (gemm) with a ring of kStages stages of
// kChunkBytes-deep A and B chunks, loaded with 16-byte cp.async.cg
// (zero-filled past the edges), one __syncthreads per chunk.  The library
// holds 2- and 3-stage rings of every kernel (tools/ring_depth.py times
// them); the wrappers launch one.  bfloat16 operands run
// mma.sync.m16n8k16 bf16 x bf16 -> f32 from ldmatrix fragments, 8 warps
// as 2 x 4 of (BM/2) x 32.  float32 operands run IEEE FMA, an 8 x 8
// register tile per thread (4 x 8 at BM = 64) from float4 reads of A^T
// and B: the hop's A^T is L^T, which the wrapper passes in place of L
// (so the kernel takes any L, as the TPU kernel does).  Split TF32 (three
// mma.sync.m16n8k8 per product) held K2 to 2e-6 of the plain version's
// max but moved ChebNet's f32 training gradients by 1.15e-3 of their max,
// past chip_smoke.py's 1e-3; FMA in the plain version's summation order
// matches it exactly, so f32 stays on FMA.  Two CTAs per SM
// (__launch_bounds__, 128 registers), so that the bench shape's 25
// clusters of 8 fit at once (cheby_resident_clusters; chip_smoke.py
// phase 7 prints it).
//
// Bounds at the bench's dense_fused shape (976 nodes, B = 100, F = O =
// 32, K = 25): the hops are 146 GFLOP, the taps 5 GFLOP (20 GFLOP with
// the block-diagonal waste, in either tap): 0.153 ms of bf16 tensor-core
// time, 2.26 ms of float32 FMA time; the bytes (L, x, W or g, y or dW
// once) are far less.  The design's own limits: 25 groups x 8 CTAs = 200
// CTAs of one 128 x 128 tile each on 132 SMs, so 68 SMs run two and the
// rest one; and each CTA streams its L rows (250 KB bf16) and the group's
// carry (250 KB) from L2 once per hop, 2.4 GB over the call (4.8 GB in
// f32).  K2 measured by chip_smoke.py phase 7 on an H100 SXM at 700 W:
// bf16 1.65 ms (9% of its bound; the first design took 25.56), f32 5.98
// ms (38% of its bound; the first design took 15.57, torch's f32 matmul
// chain 5.23); K3's times are in PERF.md.  Left for later: sharing each
// carry chunk across the cluster (TMA multicast) instead of 8 L2 reads,
// and the block-diagonal waste inside a tap pass (4x at the bench shape).
//
// Build without --use_fast_math: the rounding above is IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // CTAs per SM (__launch_bounds__)
constexpr int kCols = 128;     // columns of a CTA tile (B chunk width)
// Contraction depth of a stage, in bytes (a multiple of 32: whole bf16
// k16 steps).
constexpr int kChunkBytes = 128;
constexpr int kAPitch = kChunkBytes + 16;  // A row in shared memory, bytes
constexpr int kBLd = kCols + 8;  // B row in shared memory, elements
constexpr int kMaxCluster = 8;

// The tap kinds, the kernel's last template parameter.
enum : int { kConvTap = 0, kDwTap = 1 };

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
template <typename T, int BM, int kStages>
constexpr int kRingBytes = kStages * kStageBytes<T, BM>;  // dynamic, per CTA

struct ConvArgs {
  const void* L;   // [mp, mp]: bf16 L, or f32 L^T (the hop's A^T)
  const float* x;  // [G, mp, np]: T_0 per column group
  // T_0 in the compute dtype: bf16 [G, mp, np] rounded; f32 K2 [G, np, mp]
  // transposed; unused by f32 K3.
  const void* xc;
  // The tap's other operand, compute dtype.  K2: [K, np, nop]
  // block-diagonal tap weights.  K3: g, bf16 [G, nop, mp] rounded and
  // transposed, or f32 [G, mp, nop].
  const void* tap;
  float* out;      // K2: y [G, mp, nop]; K3: parts [G, CL, K, S, O, F]
  float* carry;    // [G, 2, mp, np]
  // bf16: [G, 2, mp, np] rounded; f32 K2: [G, 2, np, mp], T^T; f32 K3:
  // unused.
  void* carryc;
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
template <typename T, int BM, int kStages>
__device__ __forceinline__ void gemm(const T* A, int lda, int a_rows,
                                     const T* B, int ldb, int b_cols, int Kd,
                                     unsigned char* smem,
                                     float (&acc)[BM / 32][4][4]) {
  static_assert(kStages >= 2, "the ring overlaps one load with compute");
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

// Visit each element of a gemm tile: f(row, col, v), tile-relative.
template <typename T, int BM, typename Fn>
__device__ __forceinline__ void for_each(float (&acc)[BM / 32][4][4], Fn f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    for_pairs<BM>(acc, [&](int r, int c, float v0, float v1) {
      f(r, c, v0);
      f(r, c + 1, v1);
    });
  } else {
    for_blocks<BM>(acc, [&](int r, int c, float (&v)[4][4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) f(r + i, c + j, v[i][j]);
    });
  }
}

// K2's tap after hop k: y[rows, s*O + o] += T_k[rows, s*F + f] W_k[f, o]
// for the group's samples s, one product with the block-diagonal W_k.  tk
// is T_k (bf16) or T_k^T (f32); y the group's [mp, nop].
template <typename T, int BM, int kStages>
__device__ __forceinline__ void conv_tap(const ConvArgs& a, int k,
                                         const T* tk, float* y, int t0,
                                         int t1, unsigned char* smem,
                                         float (&acc)[BM / 32][4][4]) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int mp = a.mp, np = a.np, nop = a.nop;
  const T* wk = static_cast<const T*>(a.tap) + (size_t)k * np * nop;
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
        gemm<T, BM, kStages>(tk + (size_t)row0 * np + q0, np, mp - row0, wq,
                             nop, nop - c0, q1 - q0, smem, acc);
      } else {
        gemm<T, BM, kStages>(tk + (size_t)q0 * mp + row0, mp, mp - row0, wq,
                             nop, nop - c0, q1 - q0, smem, acc);
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
}

// n / d for 0 <= n, d < 2^16 by one multiply: with m = ceil(2^32 / d),
// (n * m) >> 32 is exact in that range.  K3's emission divides every
// element's row and column by a sample's width; a runtime division there
// cost as much as the tap's product.
struct FastDiv {
  uint64_t m;
  __device__ explicit FastDiv(int d) : m((0x100000000ull + d - 1) / d) {}
  __device__ int operator()(int n) const {
    return (int)(((uint64_t)n * m) >> 32);
  }
};

// K3's tap after hop k: the CTA's rows [row_lo, row_hi) of T_k and g
// contracted, and the S diagonal [O, F] blocks into part, this (group,
// rank, hop)'s [S, O, F].  tk is T_k [mp, np] (bf16 rounded, or the f32
// carry).  bf16 computes P = g^T T_k [nop, np] from gt, the group's
// rounded g^T [nop, mp]: gemm's A is row-major in bf16.  f32 computes P^T
// = T_k^T g [np, nop] from gt, the group's g [mp, nop]: its A^T is T_k
// itself and B is g, so no operand is copied, and the tile's rows run
// over the narrower F (layer 1: F = 32, O = 64, half the passes of P).
template <typename T, int BM, int kStages>
__device__ __forceinline__ void dw_tap(const ConvArgs& a, const T* tk,
                                       const T* gt, float* part, int row_lo,
                                       int row_hi, unsigned char* smem,
                                       float (&acc)[BM / 32][4][4]) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int mp = a.mp, np = a.np, nop = a.nop, F = a.F, O = a.O;
  // The tile's rows (A's side) and columns (B's side): a sample's width
  // and the padded extent of each.
  const int rw = kBf16 ? O : F, cw = kBf16 ? F : O;
  const int rn = kBf16 ? nop : np, cn = kBf16 ? np : nop;
  const int rows = a.S * rw;
  const T* tr = tk + (size_t)row_lo * np;
  const T* A = kBf16 ? gt + row_lo : tr;
  const T* B = kBf16 ? tr : gt + (size_t)row_lo * nop;
  const int lda = kBf16 ? mp : np, ldb = kBf16 ? np : nop;
  const FastDiv by_rw(rw), by_cw(cw);
  for (int r0 = 0; r0 < rows; r0 += BM) {
    // The rows r0 + [0, BM) belong to samples first..last: only their
    // columns hold diagonal blocks, and only those are loaded (whole
    // 16-byte vectors; the rest of the tile is zero-filled).
    const int first = r0 / rw;
    const int last = (min(r0 + BM, rows) - 1) / rw;
    const int q1 = min(cn, (last + 1) * cw);
    const int c1 = min(cn, (q1 + 7) / 8 * 8);
    for (int c0 = first * cw / 8 * 8; c0 < q1; c0 += kCols) {
      gemm<T, BM, kStages>(A + (kBf16 ? (size_t)r0 * mp : r0), lda, rn - r0,
                           B + c0, ldb, c1 - c0, row_hi - row_lo, smem, acc);
      for_each<T, BM>(acc, [&](int r, int c, float v) {
        // Row i = s*rw + i' and column j = s'*cw + j': kept where the
        // samples match, at [s, o', f'] = o*F + f - s*F.
        const int i = r0 + r, j = c0 + c, s = by_rw(i);
        if (i >= rows || by_cw(j) != s) return;
        const int o = kBf16 ? i : j, f = kBf16 ? j : i;
        part[(size_t)o * F + f - s * F] = v;
      });
    }
  }
}

template <typename T, int BM, int kStages, int kTap>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cheby_conv_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // Whether the kernel keeps a compute-dtype copy of the carries: bf16's
  // rounded operand, or f32 K2's transpose (its tap's A^T).
  constexpr bool kCopy = kBf16 || kTap == kConvTap;
  const int mp = a.mp, np = a.np;
  const size_t gs = (size_t)mp * np;  // one carry of one group
  const int grp = blockIdx.y;
  const T* L = static_cast<const T*>(a.L);
  const float* x = a.x + grp * gs;
  float* buf = a.carry + grp * 2 * gs;
  const T* xc = nullptr;
  T* bufc = nullptr;
  if constexpr (kCopy) {
    xc = static_cast<const T*>(a.xc) + grp * gs;
    bufc = static_cast<T*>(a.carryc) + grp * 2 * gs;
  }
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
      T* dstc = kCopy ? bufc + (k & 1) * gs : nullptr;
      for (int tile = t0; tile < t1; ++tile) {
        const int row0 = tile * BM;
        for (int c0 = 0; c0 < np; c0 += kCols) {
          gemm<T, BM, kStages>(L + (kBf16 ? (size_t)row0 * mp : row0), mp,
                               mp - row0, src + c0, np, np - c0, mp, smem,
                               acc);
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
            // Rows of T_k as float4s and, for K2, its transpose [np, mp],
            // the tap's A^T, as float4 columns of 4 rows.
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
              if constexpr (kCopy) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  *reinterpret_cast<float4*>(dstc + (size_t)(col + j) * mp +
                                             row) =
                      make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
                }
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
    // T_k as the tap reads it: the compute-dtype copy where there is one
    // (T_0: xc), else the f32 carry (T_0: x).
    const T* tk;
    if constexpr (kCopy) {
      tk = k == 0 ? xc : bufc + (k & 1) * gs;
    } else {
      tk = k == 0 ? x : buf + (k & 1) * gs;
    }
    if constexpr (kTap == kConvTap) {
      conv_tap<T, BM, kStages>(a, k, tk, a.out + (size_t)grp * mp * a.nop,
                               t0, t1, smem, acc);
    } else {
      float* part = a.out + (((size_t)grp * gridDim.x + blockIdx.x) * a.K +
                             k) * a.S * a.O * a.F;
      dw_tap<T, BM, kStages>(a, tk,
                             static_cast<const T*>(a.tap) +
                                 (size_t)grp * mp * a.nop,
                             part, t0 * BM, min(t1 * BM, mp), smem, acc);
    }
    if (k >= 1 && k + 1 < a.K) cluster_wait();  // every row of T_k written
  }
}

// Every instantiation, looked up at run time: cheby_conv_kernel<T, BM,
// kStages, kTap> for T = float (dtype 0) or bf16 (1), BM 64 or 128, 2 or 3
// stages, either tap.
using Kernel = void (*)(ConvArgs);

template <typename T, int BM, int kStages>
Kernel pick_tap(int tap) {
  return tap == kConvTap ? cheby_conv_kernel<T, BM, kStages, kConvTap>
                         : cheby_conv_kernel<T, BM, kStages, kDwTap>;
}

template <typename T, int BM>
Kernel pick_stages(int stages, int tap, int* smem) {
  *smem = stages == 2 ? kRingBytes<T, BM, 2> : kRingBytes<T, BM, 3>;
  return stages == 2 ? pick_tap<T, BM, 2>(tap) : pick_tap<T, BM, 3>(tap);
}

template <typename T>
Kernel pick_rows(int rows, int stages, int tap, int* smem) {
  return rows == 128 ? pick_stages<T, 128>(stages, tap, smem)
                     : pick_stages<T, 64>(stages, tap, smem);
}

// The instantiation and its dynamic shared memory (*smem bytes), or null
// for one that does not exist.
Kernel pick(int tap, int rows, int stages, int dtype, int* smem) {
  if ((tap != kConvTap && tap != kDwTap) || (rows != 64 && rows != 128) ||
      (stages != 2 && stages != 3) || (dtype != 0 && dtype != 1)) {
    return nullptr;
  }
  return dtype == 0 ? pick_rows<float>(rows, stages, tap, smem)
                    : pick_rows<__nv_bfloat16>(rows, stages, tap, smem);
}

// A launch configuration of `cluster` x `groups` CTAs in clusters of
// `cluster` along x.
struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterConfig(int cluster, int groups, int smem, cudaStream_t s) {
    cfg.gridDim = dim3(cluster, groups, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

int launch(int tap, const void* L, const void* x, const void* xc,
           const void* tap_operand, void* out, void* carry, void* carryc,
           int mp, int K, int np, int nop, int S, int F, int O, int groups,
           int cluster, int rows_per_tile, int tiles_per_cta, int stages,
           int dtype, void* stream) {
  int smem = 0;
  const Kernel kernel = pick(tap, rows_per_tile, stages, dtype, &smem);
  if (kernel == nullptr || K < 1 || mp < 8 || mp % 8 || np < 8 || np % 8 ||
      nop < 8 || nop % 8 ||
      (tap == kDwTap && (np > 32768 || nop > 32768)) ||  // FastDiv's range
      S < 1 || F < 1 || O < 1 || (long)S * F > np ||
      (long)S * O > nop || groups < 1 || cluster < 1 ||
      cluster > kMaxCluster || tiles_per_cta < 1 ||
      (long)cluster * tiles_per_cta * rows_per_tile < mp ||
      (long)(cluster - 1) * tiles_per_cta * rows_per_tile >= mp) {
    return (int)cudaErrorInvalidValue;
  }
  ConvArgs a;
  a.L = L;
  a.x = static_cast<const float*>(x);
  a.xc = xc;
  a.tap = tap_operand;
  a.out = static_cast<float*>(out);
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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterConfig c(cluster, groups, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&c.cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Both launches: L [mp, mp], bfloat16 L or float32 L^T; x [groups, mp,
// np] f32; carry [groups, 2, mp, np] f32.  np and nop are multiples of 8,
// at least S*F and S*O; mp a multiple of 8.  rows_per_tile 64 or 128; the
// grid is cluster x groups CTAs, one cluster (cluster <= 8 CTAs) per
// group, each CTA tiles_per_cta row tiles.  stages: the ring's depth, 2
// or 3.  dtype: 0 float32, 1 bfloat16.  Launches on `stream`; returns the
// launch's error (a cluster the card cannot place is refused, not run
// otherwise).
//
// K2.  xc: bf16 [groups, mp, np], x rounded, or f32 [groups, np, mp], x
// transposed; w: [K, np, nop] compute dtype, block-diagonal over the S
// samples of a group (F inputs, O outputs each); y: [groups, mp, nop] f32;
// carryc: [groups, 2, mp, np] bf16 or [groups, 2, np, mp] f32.
extern "C" int cheby_conv_launch(const void* L, const void* x, const void* xc,
                                 const void* w, void* y, void* carry,
                                 void* carryc, int mp, int K, int np, int nop,
                                 int S, int F, int O, int groups, int cluster,
                                 int rows_per_tile, int tiles_per_cta,
                                 int stages, int dtype, void* stream) {
  return launch(kConvTap, L, x, xc, w, y, carry, carryc, mp, K, np, nop, S, F,
                O, groups, cluster, rows_per_tile, tiles_per_cta, stages,
                dtype, stream);
}

// K3 (np, nop <= 32768).  bf16: xc [groups, mp, np], x rounded; g
// [groups, nop, mp], g rounded and transposed; carryc [groups, 2, mp, np].
// f32: g [groups, mp, nop]; xc and carryc unused (null).  parts: [groups,
// cluster, K, S, O, F] f32, every element written: rank c's sum over its
// rows of g[m, s*O + o] T_k[m, s*F + f] for the group's sample s.
extern "C" int cheby_dw_launch(const void* L, const void* x, const void* xc,
                               const void* g, void* parts, void* carry,
                               void* carryc, int mp, int K, int np, int nop,
                               int S, int F, int O, int groups, int cluster,
                               int rows_per_tile, int tiles_per_cta,
                               int stages, int dtype, void* stream) {
  if (dtype == 1 && (xc == nullptr || carryc == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(kDwTap, L, x, xc, g, parts, carry, carryc, mp, K, np, nop, S,
                F, O, groups, cluster, rows_per_tile, tiles_per_cta, stages,
                dtype, stream);
}

// How many clusters of `cluster` CTAs of the instantiation for tap (0 K2,
// 1 K3), rows_per_tile, stages and dtype the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
extern "C" int cheby_resident_clusters(int tap, int cluster, int rows_per_tile,
                                       int stages, int dtype) {
  int smem = 0, n = 0;
  const Kernel kernel = pick(tap, rows_per_tile, stages, dtype, &smem);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    ClusterConfig c(cluster, 1, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &c.cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}

// The dynamic shared memory of one CTA, in bytes (its ring of `stages`
// stages; the same for both taps), or -1 for an instantiation that does
// not exist.
extern "C" int cheby_smem_bytes(int rows_per_tile, int stages, int dtype) {
  int smem = 0;
  return pick(kConvTap, rows_per_tile, stages, dtype, &smem) ? smem : -1;
}
