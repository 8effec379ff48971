// Lattice ring sweep for NVIDIA Hopper (sm_90a): one outer-iteration sweep
// of one Km bucket of the single-class Cartesian-lattice source iteration.
//
// Replaces pbte_tpu/ops/lattice_ring.py::lattice_ring_sweep (the Pallas TPU
// kernel, body `_kernel`). Plain PyTorch version and dispatching wrapper:
// pbte_tpu_torch/ops/lattice_ring.py.
//
// What it computes, per (group g, slot k, band b), levels l = 0 .. L-1 in
// order (the ring starts at zero):
//   rhs[i, w]   = src_w[b] ttc[l,g,i,w] + relax_w[b] v[l,g,k,b,i,w]
//                 - (vg bc_w)[b] bsrc[l,g,k,i,w]  (- vg[b] dsrc[l,g,k,i,w])
//                 (+ xval[g,u,k,b,i] where u = xmap[l,g,w] >= 0)
//   nb_f[i, w]  = cin[l,g,k,f,w] * ring[i, w - s_f]   (zero where w < s_f)
//   sol[:, w]   = bcat[g,k,b] (D, J) @ [rhs; nb_0; nb_1; nb_2][:, w]
//   ys[l,g,k,b] = sol;  ring = sol;  ms[g,k,l] += macro_w[g,k,b] * sol
// with J = (1 + nf) D and f32 accumulation. In cast mode (bf16 state) the
// product operands (rhs, nb_f, bcat) and the ring are rounded to bf16 as the
// TPU kernel does; in exact mode everything stays f32. (xmap, xval) is the
// lagged closure source (periodic wraps, diffuse and specular walls) the
// solver builds from the previous iterate, kept sparse: xmap (L, Gb, W)
// int32 names the closure row u of a slab slot (or -1), xval
// (Gb, U, Km, BS, D) f32 holds each row's rhs addition. It cannot fold into
// v because relax_w is exactly 0 on the band with the largest inverse
// Knudsen number. A dense state-sized operand instead cost ~5 ms more per
// diffuse-wall flagship step (zero fill, strided scatter, its kernel read;
// measured on an NVIDIA H100 80GB HBM3 at 700 W). A null xmap (or dsrc)
// skips the loads.
//
// Parallel unit. The level axis is a dependence chain, but (g, k, b) are
// independent except for the band sum in ms. One CTA runs one (g, k, b) over
// all L levels; blockDim = W, so thread w owns slab column w. The previous
// level's slab (the ring) is double-buffered in shared memory and never
// leaves the SM: like the TPU kernel's VMEM ring, the only device-memory
// streams are the state in (v) and out (ys), the slot-constant factor block,
// the small per-level side inputs and the ms partials. The CTA's (D, J)
// factor block sits transposed in shared memory and every thread reads the
// same address (a broadcast). Per level a thread loads its 27-value rhs
// column (W-minor, coalesced across the warp) and accumulates sol += bcat_f
// x_f face block by face block, so about 2 D values are live in registers.
//
// What bounds it on an H100 SXM at the flagship (hex 16^3, p=2 D=27,
// 64 directions x 40 bands, W=256, L=46): one outer step does 8.8e10 FMAs
// in the transport product and streams ~6.7 GB, so the compute floor is
// ~2.6 ms at 67 TFLOP/s f32 (CUDA cores; no tensor cores here) and the byte
// floor ~2.0 ms at 3.35 TB/s. The ms partials cost ~8e8 f32 atomicAdds per
// step, 40 bands contending for each address; those atomics, the shared-
// memory broadcast loads (one 16-byte load per 4 FMAs) and the 2.9x slab
// padding (4096 of 11,776 slots are valid) are the likely first bottlenecks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kMaxFaces = 3;
constexpr int kMaxThreads = 256;

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

template <int D>
struct Tile {
  static constexpr int DP = (D + 3) / 4 * 4;  // factor column stride (float4)
  // CTAs per SM the register budget is sized for (shared memory allows 3
  // at D = 27 with W = 256 and an f32 ring)
  static constexpr int kMinBlocks = 3;
};

// sol[0:D] += col_j[0:D] * x[j] over the D columns of one face block
template <int D>
__device__ __forceinline__ void accumulate(float (&sol)[Tile<D>::DP],
                                           const float* __restrict__ cols,
                                           const float (&x)[D]) {
  constexpr int DP = Tile<D>::DP;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float4* col = reinterpret_cast<const float4*>(cols + j * DP);
#pragma unroll
    for (int q = 0; q < DP / 4; ++q) {
      const float4 c = col[q];
      sol[4 * q + 0] = fmaf(c.x, x[j], sol[4 * q + 0]);
      sol[4 * q + 1] = fmaf(c.y, x[j], sol[4 * q + 1]);
      sol[4 * q + 2] = fmaf(c.z, x[j], sol[4 * q + 2]);
      sol[4 * q + 3] = fmaf(c.w, x[j], sol[4 * q + 3]);
    }
  }
}

template <int D, typename State, bool CAST>
__global__ void __launch_bounds__(kMaxThreads, Tile<D>::kMinBlocks)
lattice_ring_kernel(const State* __restrict__ v, const float* __restrict__ ttc,
                    const float* __restrict__ bsrc,
                    const float* __restrict__ cin,
                    const float* __restrict__ bcat,
                    const float* __restrict__ macro_w,
                    const float* __restrict__ wvec,
                    const float* __restrict__ dsrc,
                    const int* __restrict__ xmap,
                    const float* __restrict__ xval, int n_u,
                    State* __restrict__ ys,
                    float* __restrict__ ms, int L, int Gb, int Km, int BS,
                    int W, int nf, Shifts sh) {
  using Ring = typename std::conditional<CAST, __nv_bfloat16, State>::type;
  constexpr int DP = Tile<D>::DP;
  const int J = (1 + nf) * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bcT = reinterpret_cast<float*>(smem_raw);  // (J, DP)
  Ring* ring_a = reinterpret_cast<Ring*>(bcT + J * DP);  // (D, W)
  Ring* ring_b = ring_a + D * W;                         // (D, W)

  const int w = threadIdx.x;
  const int b = blockIdx.x % BS;
  const int gk = blockIdx.x / BS;  // g * Km + k
  const int g = gk / Km;
  const int k = gk % Km;

  // stage this (g, k, b)'s factor block transposed: bcT[j, i] = bcat[i, j]
  const float* blk = bcat + (static_cast<size_t>(gk) * BS + b) * D * J;
  for (int idx = threadIdx.x; idx < J * DP; idx += blockDim.x) {
    const int j = idx / DP;
    const int i = idx - j * DP;
    bcT[idx] = i < D ? op_round<CAST>(blk[static_cast<size_t>(i) * J + j])
                     : 0.f;
  }
  // level 0 reads ring_b: the ring starts at zero
  for (int idx = threadIdx.x; idx < D * W; idx += blockDim.x) {
    ring_b[idx] = from_f32<Ring>(0.f);
  }
  __syncthreads();

  const float w_src = wvec[b];
  const float w_rel = wvec[BS + b];
  const float w_bcv = wvec[2 * BS + b];
  const float w_dir = wvec[3 * BS + b];
  const float mw = macro_w[static_cast<size_t>(gk) * BS + b];
  const size_t DW = static_cast<size_t>(D) * W;

  for (int l = 0; l < L; ++l) {
    const Ring* prev = (l & 1) ? ring_a : ring_b;
    Ring* cur = (l & 1) ? ring_b : ring_a;
    const size_t lg = static_cast<size_t>(l) * Gb + g;
    const size_t lgk = lg * Km + k;
    const size_t state_off = (lgk * BS + b) * DW + w;

    float sol[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) sol[i] = 0.f;

    // rhs block: lagged temperature + relaxation - boundary inflow
    {
      const State* v_l = v + state_off;
      const float* ttc_l = ttc + lg * DW + w;
      const float* bsrc_l = bsrc + lgk * DW + w;
      float x[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        x[j] = w_src * ttc_l[j * W] + w_rel * to_f32(v_l[j * W]) -
               w_bcv * bsrc_l[j * W];
      }
      if (dsrc != nullptr) {
        const float* dsrc_l = dsrc + lgk * DW + w;
#pragma unroll
        for (int j = 0; j < D; ++j) x[j] -= w_dir * dsrc_l[j * W];
      }
      if (xmap != nullptr) {
        const int u = xmap[lg * W + w];
        if (u >= 0) {
          const float* xv =
              xval + ((static_cast<size_t>(g) * n_u + u) * Km + k) * BS * D +
              static_cast<size_t>(b) * D;
#pragma unroll
          for (int j = 0; j < D; ++j) x[j] += xv[j];
        }
      }
#pragma unroll
      for (int j = 0; j < D; ++j) x[j] = op_round<CAST>(x[j]);
      accumulate<D>(sol, bcT, x);
    }

    // upwind neighbour blocks: the previous level's slab shifted along W
    // by the static lattice shift (zero fill), scaled by the inflow
    // coefficient of this face
    const float* cin_l = cin + lgk * nf * W + w;
#pragma unroll
    for (int f = 0; f < kMaxFaces; ++f) {
      if (f < nf) {
        const int s = sh.s[f];
        const bool inside = w >= s;
        const Ring* src = prev + (inside ? w - s : 0);
        const float c = op_round<CAST>(cin_l[f * W]);
        float x[D];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float r = to_f32(src[j * W]);
          x[j] = inside ? op_round<CAST>(r * c) : 0.f;
        }
        accumulate<D>(sol, bcT + (f + 1) * D * DP, x);
      }
    }

    // new state, then the ring, then the f32 macroscopic partial
    State* ys_l = ys + state_off;
    float* ms_l = ms + (static_cast<size_t>(gk) * L + l) * DW + w;
#pragma unroll
    for (int i = 0; i < D; ++i) ys_l[i * W] = from_f32<State>(sol[i]);
#pragma unroll
    for (int i = 0; i < D; ++i) cur[i * W + w] = from_f32<Ring>(sol[i]);
#pragma unroll
    for (int i = 0; i < D; ++i) atomicAdd(ms_l + i * W, mw * sol[i]);
    __syncthreads();
  }
}

template <int D, typename State, bool CAST>
cudaError_t launch(const void* v, const float* ttc, const float* bsrc,
                   const float* cin, const float* bcat, const float* macro_w,
                   const float* wvec, const float* dsrc, const int* xmap,
                   const float* xval, int n_u, void* ys, float* ms, int L,
                   int Gb, int Km, int BS, int W, int nf, Shifts sh,
                   cudaStream_t stream) {
  using Ring = typename std::conditional<CAST, __nv_bfloat16, State>::type;
  const size_t smem = static_cast<size_t>((1 + nf) * D) * Tile<D>::DP *
                          sizeof(float) +
                      2 * static_cast<size_t>(D) * W * sizeof(Ring);
  auto kernel = lattice_ring_kernel<D, State, CAST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<Gb * Km * BS, W, smem, stream>>>(
      static_cast<const State*>(v), ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
      xmap, xval, n_u, static_cast<State*>(ys), ms, L, Gb, Km, BS, W, nf, sh);
  return cudaGetLastError();
}

template <typename State, bool CAST>
cudaError_t dispatch_d(int D, const void* v, const float* ttc,
                       const float* bsrc, const float* cin, const float* bcat,
                       const float* macro_w, const float* wvec,
                       const float* dsrc, const int* xmap, const float* xval,
                       int n_u, void* ys, float* ms, int L, int Gb, int Km,
                       int BS, int W, int nf, Shifts sh, cudaStream_t stream) {
  switch (D) {
    case 8:
      return launch<8, State, CAST>(v, ttc, bsrc, cin, bcat, macro_w, wvec,
                                    dsrc, xmap, xval, n_u, ys, ms, L, Gb, Km,
                                    BS, W, nf, sh, stream);
    case 27:
      return launch<27, State, CAST>(v, ttc, bsrc, cin, bcat, macro_w, wvec,
                                     dsrc, xmap, xval, n_u, ys, ms, L, Gb,
                                     Km, BS, W, nf, sh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// cast_bf16 = 0: f32 state, exact f32 operands.
// cast_bf16 = 1: bf16 state, bf16 operands and ring, f32 accumulation.
// dsrc may be null (no Dirichlet faces), xmap and xval null (no lagged
// closures; n_u is then ignored). Returns a cudaError_t.
int pbte_lattice_ring_sweep(int cast_bf16, int D, const void* v,
                            const float* ttc, const float* bsrc,
                            const float* cin, const float* bcat,
                            const float* macro_w, const float* wvec,
                            const float* dsrc, const int* xmap,
                            const float* xval, int n_u, void* ys, float* ms,
                            int L, int Gb, int Km, int BS, int W, int nf,
                            int s0, int s1, int s2, void* stream) {
  if (nf < 1 || nf > kMaxFaces || W < 1 || W > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shifts sh{{s0, s1, s2}};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cast_bf16
          ? dispatch_d<__nv_bfloat16, true>(D, v, ttc, bsrc, cin, bcat,
                                            macro_w, wvec, dsrc, xmap, xval,
                                            n_u, ys, ms, L, Gb, Km, BS, W, nf,
                                            sh, st)
          : dispatch_d<float, false>(D, v, ttc, bsrc, cin, bcat, macro_w,
                                     wvec, dsrc, xmap, xval, n_u, ys, ms, L,
                                     Gb, Km, BS, W, nf, sh, st);
  return static_cast<int>(err);
}

const char* pbte_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
