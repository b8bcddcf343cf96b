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
// Layout of the work.  One warp per output row, 8 rows per 256-thread
// CTA.  The lanes load the row's columns and positions 32 at a time (one
// coalesced read each), then the 32 values, and pass each nonzero to the
// whole warp with __shfl_sync; longer rows loop.  Each lane owns 16
// columns of a 512-column pass, as 16-byte vectors spaced 32 vectors
// apart (f32 4 vectors, bf16 2, int8 1), so one warp-wide load reads 512
// contiguous bytes of an x row; its 16 accumulators sit in registers.  A
// wider C loops over passes; a C that is not a multiple of the vector's
// elements leaves the rows off 16-byte boundaries and takes the scalar
// form (16 scalar columns per lane, 32 apart).  A gather SpMM is bound by
// the loads in flight: each lane issues the loads of several nonzeros
// (8 vectors, 16 scalars) before it multiplies, through the read-only
// path (__ldg).  Pad rows have no nonzeros: 0 for L@x, -x0 for the hop.
//
// Build without --use_fast_math: the int8 path is bit-exact with the
// PyTorch reference only with IEEE rounding of every float operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;
constexpr int kLaneCols = 16;               // accumulators per lane
constexpr int kPassCols = 32 * kLaneCols;   // columns per pass
constexpr int kLoadsInFlight = 8;           // 16-byte loads per lane per round

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

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
__device__ __forceinline__ unsigned& word(uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Per element type: the accumulator, a value of the blocks, element e of
// a 16-byte vector and of a scalar load, and the bits of an output.
template <typename T> struct Elem;

template <> struct Elem<float> {
  using Acc = float;
  using Bits = unsigned;
  static __device__ __forceinline__ Acc value(const void* b, long long p) {
    return __ldg(static_cast<const float*>(b) + p);
  }
  static __device__ __forceinline__ Acc at(const uint4& u, int e) {
    return __uint_as_float(word(u, e));
  }
  static __device__ __forceinline__ Acc scalar(Bits s) {
    return __uint_as_float(s);
  }
  static __device__ __forceinline__ void madd(Acc& acc, Acc v, Acc x) {
    acc = fmaf(v, x, acc);
  }
  static __device__ __forceinline__ Bits bits(float y) {
    return __float_as_uint(y);
  }
};

template <> struct Elem<__nv_bfloat16> {
  using Acc = float;
  using Bits = unsigned short;
  static __device__ __forceinline__ Acc scalar(Bits s) {
    return __uint_as_float(static_cast<unsigned>(s) << 16);
  }
  static __device__ __forceinline__ Acc value(const void* b, long long p) {
    return scalar(__ldg(static_cast<const unsigned short*>(b) + p));
  }
  static __device__ __forceinline__ Acc at(const uint4& u, int e) {
    const unsigned w = word(u, e / 2);
    return __uint_as_float(e % 2 ? (w & 0xFFFF0000u) : (w << 16));
  }
  static __device__ __forceinline__ void madd(Acc& acc, Acc v, Acc x) {
    acc = fmaf(v, x, acc);  // a bf16 product is exact in f32
  }
  static __device__ __forceinline__ Bits bits(float y) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(y));
  }
};

template <> struct Elem<int8_t> {
  using Acc = int;
  using Bits = unsigned char;
  static __device__ __forceinline__ Acc scalar(Bits s) {
    return static_cast<int8_t>(s);
  }
  static __device__ __forceinline__ Acc value(const void* b, long long p) {
    return scalar(__ldg(static_cast<const unsigned char*>(b) + p));
  }
  static __device__ __forceinline__ Acc at(const uint4& u, int e) {
    return static_cast<int8_t>((word(u, e / 4) >> (8 * (e % 4))) & 0xFFu);
  }
  static __device__ __forceinline__ void madd(Acc& acc, Acc v, Acc x) {
    acc += v * x;
  }
  static __device__ __forceinline__ Bits bits(float y) {
    return static_cast<unsigned char>(static_cast<int8_t>(y));
  }
};

// Emission of one element from its accumulator: float y = acc or
// 2 acc - x0 in f32 with IEEE rounding (rounded to T by Elem::bits); int8
// in input-scale units, rounded half to even and clipped
// (pallas_band._emit_row, quant branch).
template <typename T, typename Acc>
__device__ __forceinline__ float emit(const Args& a, Acc acc, float x0) {
  if constexpr (std::is_same<T, int8_t>::value) {
    float y = __fmul_rn(a.scale, __int2float_rn(acc));
    if (a.x0 != nullptr) y = __fsub_rn(__fmul_rn(2.0f, y), x0);
    return fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  } else {
    float y = acc;
    if (a.x0 != nullptr) y = __fsub_rn(__fmul_rn(2.0f, y), x0);
    return y;
  }
}

// Loads of x: a 16-byte vector of V elements (kVec) or one element.
template <typename T, bool kVec> struct Load;
template <typename T> struct Load<T, true> {
  using Type = uint4;
  static constexpr int V = 16 / sizeof(T);
  static __device__ __forceinline__ uint4 get(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 none() {
    return make_uint4(0, 0, 0, 0);
  }
};
template <typename T> struct Load<T, false> {
  using Type = typename Elem<T>::Bits;
  static constexpr int V = 1;
  static __device__ __forceinline__ Type get(const T* p) {
    return __ldg(reinterpret_cast<const Type*>(p));
  }
  static __device__ __forceinline__ Type none() { return 0; }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) bsr_rows_kernel(Args a) {
  using E = Elem<T>;
  using Acc = typename E::Acc;
  using L = Load<T, kVec>;
  constexpr int V = L::V;
  constexpr int NV = kLaneCols / V;  // loads per lane per nonzero
  constexpr int U = NV >= kLoadsInFlight ? 1 : kLoadsInFlight / NV;

  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  if (row >= a.mp) return;  // the whole warp leaves together
  const int C = a.C;
  const int lo = __ldg(a.rowptr + row), hi = __ldg(a.rowptr + row + 1);
  const T* x = static_cast<const T*>(a.x);

  for (int c0 = 0; c0 < C; c0 += kPassCols) {
    Acc acc[kLaneCols];
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) acc[i] = Acc(0);

    for (int base = lo; base < hi; base += 32) {
      const int n = min(32, hi - base);
      int my_col = 0;
      Acc my_val = Acc(0);
      if (lane < n) {
        my_col = __ldg(a.cols + base + lane);
        my_val = E::value(a.blocks, __ldg(a.pos + base + lane));
      }
      for (int k = 0; k < n; k += U) {
        typename L::Type buf[U][NV];
        Acc v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int src = k + u;
          const int col = __shfl_sync(0xFFFFFFFFu, my_col, src & 31);
          v[u] = __shfl_sync(0xFFFFFFFFu, my_val, src & 31);
          const T* xr = x + (size_t)col * C + c0;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int cc = (j * 32 + lane) * V;
            buf[u][j] = (src < n && c0 + cc < C) ? L::get(xr + cc) : L::none();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            if constexpr (kVec) {
#pragma unroll
              for (int e = 0; e < V; ++e)
                E::madd(acc[j * V + e], v[u], E::at(buf[u][j], e));
            } else {
              E::madd(acc[j], v[u], E::scalar(buf[u][j]));
            }
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = c0 + (j * 32 + lane) * V;
      if (col >= C) continue;
      const size_t i = (size_t)row * C + col;
      if constexpr (kVec) {
        uint4 x0v = L::none(), out = L::none();
        if (a.x0 != nullptr) x0v = L::get(static_cast<const T*>(a.x0) + i);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const unsigned b = E::bits(
              emit<T>(a, acc[j * V + e], static_cast<float>(E::at(x0v, e))));
          constexpr int kBits = 8 * sizeof(T);
          const int w = e * kBits / 32, sh = (e * kBits) % 32;
          if constexpr (kBits == 32) {
            word(out, w) = b;
          } else {
            word(out, w) |= b << sh;
          }
        }
        *reinterpret_cast<uint4*>(static_cast<T*>(a.y) + i) = out;
      } else {
        using Bits = typename E::Bits;
        const float x0 =
            a.x0 == nullptr ? 0.0f
                            : static_cast<float>(E::scalar(L::get(
                                  static_cast<const T*>(a.x0) + i)));
        reinterpret_cast<Bits*>(a.y)[i] =
            static_cast<Bits>(E::bits(emit<T>(a, acc[j], x0)));
      }
    }
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
