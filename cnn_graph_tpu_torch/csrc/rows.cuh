// The row-sparse gather SpMM that csrc/bsr.cu and csrc/band.cu share: one
// warp computes one output row from the row's nonzeros, each of which
// gathers one row of x.
//
// Each lane owns 16 columns of a 512-column pass, as 16-byte vectors
// spaced 32 vectors apart (f32 4 vectors, bf16 2, int8 1), so one
// warp-wide load reads 512 contiguous bytes of an x row; its 16
// accumulators sit in registers.  A wider C loops over passes; a C that
// is not a multiple of the vector's elements leaves the rows off 16-byte
// boundaries and takes the scalar form (16 scalar columns per lane, 32
// apart).  The lanes read the row's nonzeros 32 at a time (each lane one
// x row and one value, by the caller's `entry`) and pass each to the
// whole warp with __shfl_sync; longer rows loop.  A gather SpMM is bound
// by the loads in flight: each lane issues the loads of several nonzeros
// (8 vectors, 16 scalars) before it multiplies, through the read-only
// path (__ldg).
//
// The emission is pallas_band._emit_row's: float y = acc, 2 acc - x0 or
// (2 acc - x0) + c in f32, in that order with IEEE rounding and no
// contraction, rounded once to the output type; int8 in input-scale
// units, clip(rint(scale * acc [*2 - x0]), +-127).  A lane reads its x0
// vector and then writes y at the same address, and reads no other
// row's x0, so y may be x0 (the in-place hop).  Build without
// --use_fast_math: the int8 path is bit-exact with the PyTorch reference
// only with IEEE rounding of every float operation.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace rows {

constexpr int kLaneCols = 16;              // accumulators per lane
constexpr int kPassCols = 32 * kLaneCols;  // columns per pass
constexpr int kLoadsInFlight = 8;          // 16-byte loads per lane per round

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
__device__ __forceinline__ unsigned& word(uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Per element type: the accumulator, a value of the operator, element e
// of a 16-byte vector and of a scalar load, and the bits of an output.
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

// Loads of x: a 16-byte vector of V elements (kVec) or one element.
// `get` takes the read-only path; `plain` is for x0, which may be y.
template <typename T, bool kVec> struct Load;
template <typename T> struct Load<T, true> {
  using Type = uint4;
  static constexpr int V = 16 / sizeof(T);
  static __device__ __forceinline__ uint4 get(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 plain(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
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
  static __device__ __forceinline__ Type plain(const T* p) {
    return *reinterpret_cast<const Type*>(p);
  }
  static __device__ __forceinline__ Type none() { return 0; }
};

// One element's emission from its accumulator (see the note above).
template <typename T, typename Acc>
__device__ __forceinline__ float emit(Acc acc, float scale, bool hop,
                                      float x0, bool add_c, float c) {
  if constexpr (std::is_same<T, int8_t>::value) {
    float y = __fmul_rn(scale, __int2float_rn(acc));
    if (hop) y = __fsub_rn(__fmul_rn(2.0f, y), x0);
    return fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  } else {
    float y = acc;
    if (hop) y = __fsub_rn(__fmul_rn(2.0f, y), x0);
    if (add_c) y = __fadd_rn(y, c);
    return y;
  }
}

// The lane's accumulators for the pass at column c0 of one output row:
// the sum over the row's nonzeros e in [lo, hi) of value * x[xrow],
// where entry(e, xrow, value) reads nonzero e.  With kGuard an entry may
// set xrow < 0, and then adds nothing.
template <typename T, bool kVec, bool kGuard, typename Entry>
__device__ __forceinline__ void gather(
    const T* x, int C, int c0, int lo, int hi, int lane, const Entry& entry,
    typename Elem<T>::Acc (&acc)[kLaneCols]) {
  using E = Elem<T>;
  using Acc = typename E::Acc;
  using L = Load<T, kVec>;
  constexpr int V = L::V;
  constexpr int NV = kLaneCols / V;  // loads per lane per nonzero
  constexpr int U = NV >= kLoadsInFlight ? 1 : kLoadsInFlight / NV;
#pragma unroll
  for (int i = 0; i < kLaneCols; ++i) acc[i] = Acc(0);

  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    int my_row = 0;
    Acc my_val = Acc(0);
    if (lane < n) entry(base + lane, my_row, my_val);
    for (int k = 0; k < n; k += U) {
      typename L::Type buf[U][NV];
      Acc v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = k + u;
        const int row = __shfl_sync(0xFFFFFFFFu, my_row, src & 31);
        v[u] = __shfl_sync(0xFFFFFFFFu, my_val, src & 31);
        const bool live = src < n && (!kGuard || row >= 0);
        const T* xr = x + (size_t)(live ? row : 0) * C + c0;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int cc = (j * 32 + lane) * V;
          buf[u][j] = (live && c0 + cc < C) ? L::get(xr + cc) : L::none();
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
}

// Where a pass's results go: x0 (the hop) and c (the adjoint hop, float
// only) or nullptr, y, and the int8 scale.
struct Out {
  const void* x0;
  const void* c;
  void* y;
  float scale;
};

// Writes the lane's columns of the pass at c0 of output row `row`.
template <typename T, bool kVec>
__device__ __forceinline__ void store(
    const Out& o, size_t row, int C, int c0, int lane,
    const typename Elem<T>::Acc (&acc)[kLaneCols]) {
  using E = Elem<T>;
  using L = Load<T, kVec>;
  constexpr int V = L::V;
  constexpr int NV = kLaneCols / V;
  const bool hop = o.x0 != nullptr, add_c = o.c != nullptr;
  const T* x0 = static_cast<const T*>(o.x0);
  const T* c = static_cast<const T*>(o.c);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = c0 + (j * 32 + lane) * V;
    if (col >= C) continue;
    const size_t i = row * C + col;
    if constexpr (kVec) {
      uint4 x0v = L::none(), cv = L::none(), out = L::none();
      if (hop) x0v = L::plain(x0 + i);
      if (add_c) cv = L::get(c + i);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const unsigned b = E::bits(emit<T>(
            acc[j * V + e], o.scale, hop, static_cast<float>(E::at(x0v, e)),
            add_c, static_cast<float>(E::at(cv, e))));
        constexpr int kBits = 8 * sizeof(T);
        const int w = e * kBits / 32, sh = (e * kBits) % 32;
        if constexpr (kBits == 32) {
          word(out, w) = b;
        } else {
          word(out, w) |= b << sh;
        }
      }
      *reinterpret_cast<uint4*>(static_cast<T*>(o.y) + i) = out;
    } else {
      using Bits = typename E::Bits;
      const float x0s = hop ? static_cast<float>(E::scalar(L::plain(x0 + i)))
                            : 0.0f;
      const float cs =
          add_c ? static_cast<float>(E::scalar(L::get(c + i))) : 0.0f;
      reinterpret_cast<Bits*>(o.y)[i] = static_cast<Bits>(
          E::bits(emit<T>(acc[j], o.scale, hop, x0s, add_c, cs)));
    }
  }
}

}  // namespace rows
