// Device helpers shared by the two lattice ring sweep kernels for NVIDIA
// Hopper (sm_90a): lattice_ring.cu (one CTA holds a whole level) and
// lattice_ring_tiled.cu (a thread-block cluster holds it in column tiles).
// Operand rounding, the TF32 split, the tensor-core products (mma.sync
// m16n8k8 TF32, m16n8k16 bf16, m16n8k4 f64) and the tile geometry.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxFaces = 3;

struct Shifts {
  int s[kMaxFaces];
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// product-operand rounding: identity in exact mode, bf16 in cast mode
template <bool CAST>
__device__ __forceinline__ float op_round(float x) {
  if constexpr (CAST) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi, lo TF32, both truncated by masking the low 13 bits:
// |lo| < 2^-10 |x| and the truncation of lo costs < 2^-20 |x|. (cvt.rna
// costs ~7 issue cycles on the H100: rounding both parts made the f32
// kernel 25% slower, measured.) lattice_ring.cu splits its factor block
// once per CTA and rounds both parts (split_tf32_rna); lattice_ring_tiled.cu
// keeps the factor unsplit and truncates it at each use, as the A operand.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32_rna(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// two floats -> bf16x2, the first in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B on the FP64 tensor cores, one m16n8k4 product. A (16 x 4, row):
// a0, a1 are rows gq, gq + 8 of k column tq; B (4 x 8, col): b is k row tq
// of column gq; d[q] is row gq + 8 (q >> 1), column 2 tq + (q & 1) (gq =
// lane / 4, tq = lane % 4).
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1,
                                        double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Tile geometry of one (D, mode) for f32 and bf16 state
template <int D, bool CAST>
struct Geo {
  static constexpr int KSTEP = CAST ? 16 : 8;  // mma depth
  static constexpr int KP = (D + KSTEP - 1) / KSTEP * KSTEP;  // face depth
  static constexpr int KT_FACE = KP / KSTEP;  // k-steps per face block
  static constexpr int NT = (D + 7) / 8;      // 8-column n-tiles of D
  // one lane's B fragment of one (k-step, n-tile): hi and lo of b0, b1
  // (TF32) or b0, b1 (bf16x2)
  static constexpr int BFRAG_BYTES = CAST ? 8 : 16;
};

// Tile geometry of one D for float64 state (m16n8k4)
template <int D>
struct GeoF64 {
  static constexpr int KP = (D + 3) / 4 * 4;  // face depth in 4-deep k-steps
  static constexpr int KT_FACE = KP / 4;      // k-steps per face block
  static constexpr int NT = (D + 7) / 8;      // 8-column n-tiles of D
};

// row stride of the f32 tiles: a multiple of 32 words plus 8, so the 8
// rows x 4 columns of a fragment read fall in 32 distinct banks
__host__ __device__ constexpr int tile_stride(int W) {
  return (W + 31) / 32 * 32 + 8;
}
// row stride of the shifted inflow coefficients: W rounded to m-tiles
__host__ __device__ constexpr int cin_stride(int W) {
  return (W + 15) / 16 * 16;
}
// row stride of the float64 tiles: W rounded to m-tiles plus 4 doubles,
// which is 4 mod 16: the 16 lanes of a half-warp's 8-byte fragment read
// fall on 16 distinct 8-byte bank pairs
__host__ __device__ constexpr int f64_tile_stride(int W) {
  return (W + 15) / 16 * 16 + 4;
}

}  // namespace
