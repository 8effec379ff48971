// Lattice ring sweep over a thread-block cluster, for NVIDIA Hopper (sm_90a):
// the shapes whose level does not fit one CTA's shared memory, which is
// hex p = 3 (D = 64) at any slab width W and any D at W > 256.
//
// Replaces pbte_tpu/ops/lattice_ring.py::lattice_ring_sweep (the Pallas TPU
// kernel, body `_kernel`) at those shapes; lattice_ring.cu's one-CTA kernels
// take the others. The recurrence, its arguments and its three state types
// are those of lattice_ring.cu (f32 state as 3xTF32 products, bf16 state with
// bf16 operands and ring and f32 sums, f64 state on the FP64 tensor cores);
// plain PyTorch version and dispatching wrapper:
// pbte_tpu_torch/ops/lattice_ring.py.
//
// Design. One cluster of C CTAs runs one (g, k, b) over all L levels; CTA r
// holds columns [r Wt, (r + 1) Wt) of every level (Wt a multiple of the
// mma's 16 rows, chosen by the wrapper so that the factor block, two solution
// tiles, the rhs tile and the shifted inflow coefficients fit 232,448 B; C =
// ceil(W / Wt) <= 16). Per level, all 16 warps of a CTA:
//   1. build the rhs tile and the shifted inflow coefficients of its columns
//      (from device memory; zeros outside the level's hull window);
//   2. __syncthreads, then run the product (W x J) @ (J x D) on the tensor
//      cores for the window's 16-row m-tiles of its columns, one work item
//      (an m-tile and up to 4 of D's 8-column n-tiles) per warp in turn, and
//      write the solution into the tile of the level's parity. A ring read at
//      column p - s_f (the lattice shifts are 0, 1 and a slab axis's length)
//      comes from the previous level's solution tile of the CTA that holds
//      column p - s_f: its own, or a peer's through distributed shared memory
//      (cluster.map_shared_rank);
//   3. one cluster barrier (barrier.cluster.arrive.release /
//      wait.acquire): every peer's level-l solution is then visible, and
//      every peer has finished reading level l - 1's tile, so level l + 1
//      may overwrite that buffer (the solution tiles are double-buffered by
//      level parity);
//   4. stream the level out of its own tile: ys (zeros outside the window)
//      and the ms band sum by atomics (C CTAs x BS bands add into ms).
// The factor block stays in each CTA's shared memory, in mma fragment
// order, for all L levels. A CTA whose columns lie outside a level's window
// skips steps 1 and 2 but still arrives at the barrier. Rows of a tile
// that a level does not compute keep an earlier level's finite solution;
// the next level reads them only where its inflow coefficient is zero (the
// windows' contract), as in lattice_ring.cu, so the windowed results equal
// the full slab's (ys bit for bit, ms up to the order of its atomics).
//
// It is written to be right, not fast: one role per warp (no producer /
// consumer split), one rhs tile, the loads of a level not in flight while
// the previous level multiplies. What bounds it on an H100 SXM is what
// bounds lattice_ring.cu (the state streams at 3.35 TB/s, the product at the
// tensor cores' peak); its times against that bound are in PERF.md.
//
// Shared memory, f32 at D = 64 and Wt = 96 (three faces): the factor in
// TF32 hi/lo fragment order 4 x 8 k-steps x 8 n-tiles x 32 lanes x 16 B =
// 131,072 B, three tiles 64 x 104 x 4 B = 79,872 B, the inflow coefficients
// 3 x 96 x 4 B and the windows.

#include <cooperative_groups.h>

#include "lattice_ring_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 16;  // non-portable beyond 8
constexpr int kNChunk = 4;       // n-tiles of one work item

// state types: 0 f32 (3xTF32), 1 bf16, 2 f64
template <int MODE>
struct Traits;
template <>
struct Traits<0> {
  using State = float;
  using Op = float;  // operands, tiles and sums
  static constexpr int KSTEP = 8;
  static constexpr int BFRAG_BYTES = 16;  // TF32 hi and lo of b0, b1
};
template <>
struct Traits<1> {
  using State = __nv_bfloat16;
  using Op = float;
  static constexpr int KSTEP = 16;
  static constexpr int BFRAG_BYTES = 8;  // bf16x2 b0, b1
};
template <>
struct Traits<2> {
  using State = double;
  using Op = double;
  static constexpr int KSTEP = 4;
  static constexpr int BFRAG_BYTES = 8;  // one double
};

template <int D, int MODE>
struct TGeo {
  static constexpr int KSTEP = Traits<MODE>::KSTEP;
  static constexpr int KP = (D + KSTEP - 1) / KSTEP * KSTEP;  // face depth
  static constexpr int KT_FACE = KP / KSTEP;  // k-steps per face block
  static constexpr int NT = (D + 7) / 8;      // 8-column n-tiles of D
  static constexpr int NCH = NT < kNChunk ? NT : kNChunk;  // n-tiles an item
  static constexpr int NCHUNKS = (NT + NCH - 1) / NCH;
};

template <int MODE>
__host__ __device__ constexpr int row_stride(int Wt) {
  return MODE == 2 ? f64_tile_stride(Wt) : tile_stride(Wt);
}

// Shared-memory carve-up (byte offsets), the same on host and device: the
// factor in fragment order, two solution tiles (level parity), one rhs
// tile, one tile of shifted inflow coefficients and the L windows
template <int D, int MODE>
struct SmemTiled {
  size_t bfrag, sol, rhs, cinc, wins, tile, cin_tile, total;
  __host__ __device__ SmemTiled(int Wt, int nf, int L) {
    using G = TGeo<D, MODE>;
    using Op = typename Traits<MODE>::Op;
    tile = align16(sizeof(Op) * D * row_stride<MODE>(Wt));
    cin_tile = align16(sizeof(Op) * nf * cin_stride(Wt));
    bfrag = 0;
    sol = align16(static_cast<size_t>(1 + nf) * G::KT_FACE * G::NT * 32 *
                  Traits<MODE>::BFRAG_BYTES);
    rhs = sol + 2 * tile;
    cinc = rhs + tile;
    wins = cinc + cin_tile;
    total = wins + align16(sizeof(int2) * L);
  }
};

__device__ __forceinline__ float to_op(float x) { return x; }
__device__ __forceinline__ float to_op(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double to_op(double x) { return x; }

// products and sums rounded one at a time (never fused into an FMA)
__device__ __forceinline__ float rmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double rmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float radd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double radd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float rsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double rsub(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename State, typename Op>
__device__ __forceinline__ State to_state(Op x) {
  if constexpr (sizeof(State) == 2) {
    return __float2bfloat16(x);  // round to nearest even
  } else {
    return x;
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
lattice_ring_tiled_kernel(
    const typename Traits<MODE>::State* __restrict__ v,
    const typename Traits<MODE>::Op* __restrict__ ttc,
    const typename Traits<MODE>::Op* __restrict__ bsrc,
    const typename Traits<MODE>::Op* __restrict__ cin,
    const typename Traits<MODE>::Op* __restrict__ bcat,
    const typename Traits<MODE>::Op* __restrict__ macro_w,
    const typename Traits<MODE>::Op* __restrict__ wvec,
    const typename Traits<MODE>::Op* __restrict__ dsrc,
    const int* __restrict__ xmap,
    const typename Traits<MODE>::Op* __restrict__ xval, int n_u,
    const int* __restrict__ win, typename Traits<MODE>::State* __restrict__ ys,
    typename Traits<MODE>::Op* __restrict__ ms, int L, int Gb, int Km, int BS,
    int W, int nf, Shifts sh, int Wt, int C) {
  using T = Traits<MODE>;
  using State = typename T::State;
  using Op = typename T::Op;
  using G = TGeo<D, MODE>;
  constexpr bool CAST = MODE == 1;
  constexpr int NT = G::NT;
  constexpr int KT_FACE = G::KT_FACE;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int WP = row_stride<MODE>(Wt);
  const int WC = cin_stride(Wt);
  const int J = (1 + nf) * D;
  const SmemTiled<D, MODE> lay(Wt, nf, L);

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_n = lay.tile / sizeof(Op);
  Op* sol0 = reinterpret_cast<Op*>(smem + lay.sol);  // tile s: sol0 + s tile_n
  Op* rhs = reinterpret_cast<Op*>(smem + lay.rhs);   // (D, WP)
  Op* cinc = reinterpret_cast<Op*>(smem + lay.cinc);  // (nf, WC)
  int2* wins = reinterpret_cast<int2*>(smem + lay.wins);  // [lo, hi) per level

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment group: rows gq, gq + 8
  const int tq = lane & 3;   // thread in group: k (and n) columns
  const int gkb = blockIdx.x / C;
  const int b = gkb % BS;
  const int gk = gkb / BS;  // g * Km + k
  const int g = gk / Km;
  const int k = gk % Km;
  const int c0 = rank * Wt;          // this CTA's first slab column
  const int Wl = min(Wt, W - c0);    // its columns (>= 1: C = ceil(W / Wt))
  const size_t DW = static_cast<size_t>(D) * W;

  // the factor block in mma fragment order, as lattice_ring.cu lays it out:
  // B[kk][n] = bcat[n, f D + jj] for the k index kk = f KP + jj of face
  // block f (zero where jj >= D or n >= D)
  {
    const Op* blk = bcat + (static_cast<size_t>(gk) * BS + b) * D * J;
    auto bval = [&](int kk, int n) -> Op {
      const int f = kk / G::KP;
      const int jj = kk - f * G::KP;
      return (jj < D && n < D) ? blk[static_cast<size_t>(n) * J + f * D + jj]
                               : Op(0);
    };
    const int n_frag = (1 + nf) * KT_FACE * NT * 32;
    for (int idx = tid; idx < n_frag; idx += kThreads) {
      const int ln = idx & 31;
      const int nt = (idx >> 5) % NT;
      const int kt = (idx >> 5) / NT;
      const int n = nt * 8 + (ln >> 2);
      const int t = ln & 3;
      if constexpr (MODE == 0) {
        const int k0 = kt * 8 + t;
        uint4 f;
        split_tf32_rna(bval(k0, n), f.x, f.z);
        split_tf32_rna(bval(k0 + 4, n), f.y, f.w);
        reinterpret_cast<uint4*>(smem + lay.bfrag)[idx] = f;
      } else if constexpr (MODE == 1) {
        const int k0 = kt * 16 + 2 * t;
        uint2 f;
        f.x = pack_bf16(bval(k0, n), bval(k0 + 1, n));
        f.y = pack_bf16(bval(k0 + 8, n), bval(k0 + 9, n));
        reinterpret_cast<uint2*>(smem + lay.bfrag)[idx] = f;
      } else {
        reinterpret_cast<double*>(smem + lay.bfrag)[idx] = bval(kt * 4 + t, n);
      }
    }
  }
  // both solution tiles zero (tile 1 is level 0's ring), and the rhs and
  // inflow tiles (their padding columns stay zero)
  for (size_t i = tid; i < 3 * tile_n; i += kThreads) sol0[i] = Op(0);
  for (int i = tid; i < static_cast<int>(lay.cin_tile / sizeof(Op));
       i += kThreads) {
    cinc[i] = Op(0);
  }
  for (int l = tid; l < L; l += kThreads) {
    wins[l] = win != nullptr ? make_int2(__ldg(win + 2 * l),
                                         __ldg(win + 2 * l + 1))
                             : make_int2(0, W);
  }
  // every peer's tiles are zero before any ring read reaches them
  cluster.sync();

  const Op w_src = wvec[b];
  const Op w_rel = wvec[BS + b];
  const Op w_bcv = wvec[2 * BS + b];
  const Op w_dir = wvec[3 * BS + b];
  const Op mw = macro_w[static_cast<size_t>(gk) * BS + b];

  for (int l = 0; l < L; ++l) {
    Op* sol = sol0 + (l & 1) * tile_n;         // level l's solution
    Op* prev = sol0 + ((l & 1) ^ 1) * tile_n;  // level l-1's: the ring
    const int2 wl = wins[l];
    // the window's columns of this CTA, local [a, e), and their m-tiles
    const int a = max(wl.x - c0, 0);
    const int e = min(wl.y - c0, Wl);
    const bool any = e > a;
    const int ta = a & ~15;
    const int te = (e + 15) & ~15;
    const size_t lg = static_cast<size_t>(l) * Gb + g;
    const size_t lgk = lg * Km + k;

    // ---- 1. rhs and shifted inflow coefficients of the window's m-tiles
    if (any) {
      const int nc = te - ta;
      for (int i = tid; i < nf * nc; i += kThreads) {
        const int f = i / nc;
        const int c = ta + (i - f * nc);
        const int w = c0 + c;
        Op x = Op(0);
        if (c >= a && c < e && w >= sh.s[f]) {
          x = __ldg(cin + (lgk * nf + f) * W + w);
        }
        if constexpr (CAST) x = op_round<true>(x);
        cinc[f * WC + c] = x;
      }
      const State* v_l = v + (lgk * BS + b) * DW;
      const Op* ttc_l = ttc + lg * DW;
      const Op* bsrc_l = bsrc + lgk * DW;
      for (int i = tid; i < D * nc; i += kThreads) {
        const int j = i / nc;
        const int c = ta + (i - j * nc);
        const int w = c0 + c;
        Op x = Op(0);
        if (c >= a && c < e) {
          // each product and sum rounded on its own, as the plain version
          // computes them (no fused multiply-add): in cast mode an f32
          // rhs one ulp off would round to the other bf16 value now and
          // then, and the recurrence carries such flips on
          const size_t o = static_cast<size_t>(j) * W + w;
          x = rsub(radd(rmul(w_src, __ldg(ttc_l + o)),
                        rmul(w_rel, to_op(v_l[o]))),
                   rmul(w_bcv, __ldg(bsrc_l + o)));
          if (dsrc != nullptr) {
            x = rsub(x, rmul(w_dir, __ldg(dsrc + lgk * DW + o)));
          }
          if (xmap != nullptr) {
            const int u = __ldg(xmap + lg * W + w);
            if (u >= 0) {
              x = radd(x, __ldg(xval +
                                ((static_cast<size_t>(g) * n_u + u) * Km +
                                 k) * BS * D +
                                static_cast<size_t>(b) * D + j));
            }
          }
        }
        if constexpr (CAST) x = op_round<true>(x);
        rhs[j * WP + c] = x;
      }
    }
    __syncthreads();

    // ---- 2. the product of the window's m-tiles on the tensor cores
#ifndef PBTE_K1_NO_PRODUCT
    if (any) {
      const int mt0 = ta >> 4;
      const int n_items = ((te - ta) >> 4) * G::NCHUNKS;
      for (int it = warp; it < n_items; it += kWarps) {
        const int mt = mt0 + it / G::NCHUNKS;
        const int nc0 = (it % G::NCHUNKS) * G::NCH;  // first n-tile
        Op acc[G::NCH][4];
#pragma unroll
        for (int n = 0; n < G::NCH; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[n][q] = Op(0);
#pragma unroll
        for (int f = 0; f <= kMaxFaces; ++f) {
          if (f > nf) break;
          // this lane's two A rows (local columns mt 16 + gq + 8 h): the
          // rhs tile, or the ring row they read and its inflow coefficient
          const Op* rp[2];
          Op cf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = mt * 16 + gq + 8 * h;
            if (f == 0) {
              rp[h] = rhs + c;
              cf[h] = Op(1);
            } else {
              cf[h] = cinc[(f - 1) * WC + c];
              // zero coefficient where the column has no upwind slot
              const int q = max(c0 + c - sh.s[f - 1], 0);
              const int rr = q / Wt;
              const Op* t = rr == rank ? prev
                                       : cluster.map_shared_rank(prev, rr);
              rp[h] = t + (q - rr * Wt);
            }
          }
#pragma unroll
          for (int kt = 0; kt < KT_FACE; ++kt) {
            const int kt_all = f * KT_FACE + kt;
            if constexpr (MODE == 0) {
              const int j0 = kt * 8 + tq;
              const int jr0 = (j0 < D ? j0 : D - 1) * WP;
              const int jr1 = (j0 + 4 < D ? j0 + 4 : D - 1) * WP;
              // a0 (row gq, k t), a1 (gq+8, t), a2 (gq, t+4), a3 (gq+8, t+4)
              float x[4] = {rp[0][jr0], rp[1][jr0], rp[0][jr1], rp[1][jr1]};
              if (f > 0) {
                x[0] *= cf[0];
                x[1] *= cf[1];
                x[2] *= cf[0];
                x[3] *= cf[1];
              }
              uint32_t hi[4], lo[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) split_tf32(x[q], hi[q], lo[q]);
#pragma unroll
              for (int n = 0; n < G::NCH; ++n) {
                if (nc0 + n >= NT) break;
                const uint4 bq = reinterpret_cast<const uint4*>(
                    smem + lay.bfrag)[(kt_all * NT + nc0 + n) * 32 + lane];
                // small terms first
                mma_tf32(acc[n], lo, bq.x, bq.y);
                mma_tf32(acc[n], hi, bq.z, bq.w);
                mma_tf32(acc[n], hi, bq.x, bq.y);
              }
            } else if constexpr (MODE == 1) {
              float x[2][4];  // [row half][k: 2t, 2t+1, 2t+8, 2t+9]
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int j = kt * 16 + 2 * tq + (q & 1) + 8 * (q >> 1);
                const int jr = (j < D ? j : D - 1) * WP;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float r = rp[h][jr];
                  x[h][q] = f == 0 ? r
                                   : op_round<true>(cf[h] * op_round<true>(r));
                }
              }
              const uint32_t am[4] = {
                  pack_bf16(x[0][0], x[0][1]), pack_bf16(x[1][0], x[1][1]),
                  pack_bf16(x[0][2], x[0][3]), pack_bf16(x[1][2], x[1][3])};
#pragma unroll
              for (int n = 0; n < G::NCH; ++n) {
                if (nc0 + n >= NT) break;
                const uint2 bq = reinterpret_cast<const uint2*>(
                    smem + lay.bfrag)[(kt_all * NT + nc0 + n) * 32 + lane];
                mma_bf16(acc[n], am, bq.x, bq.y);
              }
            } else {
              const int j = kt * 4 + tq;
              const int jr = (j < D ? j : D - 1) * WP;
              double a0 = rp[0][jr];
              double a1 = rp[1][jr];
              if (f > 0) {
                a0 *= cf[0];
                a1 *= cf[1];
              }
#pragma unroll
              for (int n = 0; n < G::NCH; ++n) {
                if (nc0 + n >= NT) break;
                const double bq = reinterpret_cast<const double*>(
                    smem + lay.bfrag)[(kt_all * NT + nc0 + n) * 32 + lane];
                mma_f64(acc[n], a0, a1, bq);
              }
            }
          }
        }
        // the item's part of the level's solution tile
#pragma unroll
        for (int n = 0; n < G::NCH; ++n) {
          const int i0 = (nc0 + n) * 8 + 2 * tq;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = mt * 16 + gq + 8 * (q >> 1);
            const int i = i0 + (q & 1);
            if (c < Wl && i < D) sol[i * WP + c] = acc[n][q];
          }
        }
      }
    }
#endif
    // ---- 3. level l's solution is in every peer's tile, and every read of
    // level l-1's tiles is done
    cluster.sync();

    // ---- 4. level l out of this CTA's tile: ys (zeros outside the window)
    // and the ms partials of the window's columns
    {
      State* ys_l = ys + (lgk * BS + b) * DW + c0;
      Op* ms_l = ms + (static_cast<size_t>(gk) * L + l) * DW + c0;
      for (int i = tid; i < D * Wl; i += kThreads) {
        const int j = i / Wl;
        const int c = i - j * Wl;
        const bool inw = c >= a && c < e;
        const Op x = inw ? sol[j * WP + c] : Op(0);
        const size_t o = static_cast<size_t>(j) * W + c;
#ifndef PBTE_K1_NO_YS
        ys_l[o] = to_state<State>(x);
#endif
#ifndef PBTE_K1_NO_MS
        if (inw) atomicAdd(ms_l + o, mw * x);
#endif
      }
    }
  }
}

template <int D, int MODE>
size_t tiled_smem_bytes(int Wt, int nf, int L) {
  return SmemTiled<D, MODE>(Wt, nf, L).total;
}

template <int D, int MODE>
cudaError_t launch_tiled(const void* v, const void* ttc, const void* bsrc,
                         const void* cin, const void* bcat,
                         const void* macro_w, const void* wvec,
                         const void* dsrc, const int* xmap, const void* xval,
                         int n_u, const int* win, void* ys, void* ms, int L,
                         int Gb, int Km, int BS, int W, int nf, Shifts sh,
                         int Wt, int C, cudaStream_t stream) {
  using State = typename Traits<MODE>::State;
  using Op = typename Traits<MODE>::Op;
  const size_t smem = tiled_smem_bytes<D, MODE>(Wt, nf, L);
  auto kernel = lattice_ring_tiled_kernel<D, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(Gb * Km * BS * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const State*>(v),
      static_cast<const Op*>(ttc), static_cast<const Op*>(bsrc),
      static_cast<const Op*>(cin), static_cast<const Op*>(bcat),
      static_cast<const Op*>(macro_w), static_cast<const Op*>(wvec),
      static_cast<const Op*>(dsrc), xmap, static_cast<const Op*>(xval), n_u,
      win, static_cast<State*>(ys), static_cast<Op*>(ms), L, Gb, Km, BS, W,
      nf, sh, Wt, C);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// element DOF counts the cluster kernel is instantiated for: quad p = 1-3
// (4, 9, 16) and hex p = 1-3 (8, 27, 64)
#define PBTE_K1_TILED_D(X) X(4) X(8) X(9) X(16) X(27) X(64)

template <int MODE>
cudaError_t dispatch_tiled(int D, const void* v, const void* ttc,
                           const void* bsrc, const void* cin,
                           const void* bcat, const void* macro_w,
                           const void* wvec, const void* dsrc,
                           const int* xmap, const void* xval, int n_u,
                           const int* win, void* ys, void* ms, int L, int Gb,
                           int Km, int BS, int W, int nf, Shifts sh, int Wt,
                           int C, cudaStream_t stream) {
  switch (D) {
#define PBTE_K1_CASE(d)                                                      \
  case d:                                                                    \
    return launch_tiled<d, MODE>(v, ttc, bsrc, cin, bcat, macro_w, wvec,     \
                                 dsrc, xmap, xval, n_u, win, ys, ms, L, Gb,  \
                                 Km, BS, W, nf, sh, Wt, C, stream);
    PBTE_K1_TILED_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One sweep over clusters of C CTAs, Wt slab columns each. mode 0: f32
// state and operands (3xTF32 products); 1: bf16 state, f32 operands, bf16
// product operands and ring; 2: f64 state and operands (ms in float64).
// Pointers and the rest of the contract as pbte_lattice_ring_sweep (ms
// zeroed by the caller, ys written in full). Wt must be a multiple of 16 and
// C = ceil(W / Wt) <= 16. Returns a cudaError_t.
int pbte_lattice_ring_sweep_tiled(int mode, int D, const void* v,
                                  const void* ttc, const void* bsrc,
                                  const void* cin, const void* bcat,
                                  const void* macro_w, const void* wvec,
                                  const void* dsrc, const int* xmap,
                                  const void* xval, int n_u, const int* win,
                                  void* ys, void* ms, int L, int Gb, int Km,
                                  int BS, int W, int nf, int s0, int s1,
                                  int s2, int Wt, int C, void* stream) {
  if (nf < 1 || nf > kMaxFaces || W < 1 || L < 1 || Wt < 16 || Wt % 16 ||
      C < 1 || C > kMaxCluster || (C - 1) * Wt >= W || C * Wt < W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shifts sh{{s0, s1, s2}};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case 0:
      err = dispatch_tiled<0>(D, v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
                              xmap, xval, n_u, win, ys, ms, L, Gb, Km, BS, W,
                              nf, sh, Wt, C, st);
      break;
    case 1:
      err = dispatch_tiled<1>(D, v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
                              xmap, xval, n_u, win, ys, ms, L, Gb, Km, BS, W,
                              nf, sh, Wt, C, st);
      break;
    case 2:
      err = dispatch_tiled<2>(D, v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
                              xmap, xval, n_u, win, ys, ms, L, Gb, Km, BS, W,
                              nf, sh, Wt, C, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one CTA of a launch (the wrapper's check).
long long pbte_lattice_ring_tiled_smem_bytes(int mode, int D, int Wt, int nf,
                                             int L) {
  switch (D) {
#define PBTE_K1_CASE(d)                                                    \
  case d:                                                                  \
    return mode == 0   ? static_cast<long long>(                           \
                           tiled_smem_bytes<d, 0>(Wt, nf, L))              \
           : mode == 1 ? static_cast<long long>(                           \
                             tiled_smem_bytes<d, 1>(Wt, nf, L))            \
                       : static_cast<long long>(                           \
                             tiled_smem_bytes<d, 2>(Wt, nf, L));
    PBTE_K1_TILED_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      return -1;
  }
}

const char* pbte_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
