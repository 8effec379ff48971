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
// with J = (1 + nf) D and f32 accumulation (float64 state: a kernel of its
// own, lattice_ring_f64_kernel below, accumulates in float64). In cast mode
// (bf16 state) the product operands (rhs, nb_f, bcat) and the ring are
// rounded to bf16 as the TPU kernel does; in exact mode every operand is
// f32. (xmap, xval) is the lagged closure source (periodic wraps, diffuse
// and specular walls), kept sparse: xmap (L, Gb, W) int32 names the closure
// row u of a slab slot (or -1), xval (Gb, U, Km, BS, D) f32 holds each
// row's rhs addition. It cannot fold into v because relax_w is exactly 0 on
// the band with the largest inverse Knudsen number. A null xmap (or dsrc)
// skips the loads.
//
// Hull windows. win (L, 2) int32 gives each level's window [lo_l, hi_l) of
// slab columns (null: every level runs the full slab). The caller warrants
// that every slot outside a window is padding: v, ttc, bsrc, dsrc and cin
// are zero there and xmap is -1. Level l then runs on its window alone: the
// producers load, and add ms for, the window's columns only and store zeros
// as ys for the others; the consumers run the window's 16-row m-tiles only,
// handed to the warps from the window's first tile on (tile t0 + warp, then
// t0 + warp + 8), so a window of up to 8 tiles costs each warp one tile.
// Columns of those tiles outside the window get a zero rhs and zero inflow
// coefficients, so their solution is an exact zero. Rows of a solution tile
// that a level does not compute keep the solution of two levels before (the
// tiles are double-buffered by level parity): the next level reads them as
// its ring only where its cin is zero, and 0 * x = 0 for the finite x they
// hold, in the TF32 split as in bf16. So the windowed results equal the
// full-slab results (ys bit for bit, ms up to the order of its atomics).
//
// Shapes. Instantiated for D in {4, 9, 16} (quad p = 1-3, two faces) and
// {8, 27} (hex p = 1, 2, three faces), W <= 256; hex p = 3 (D = 64) and
// levels wider than 256 slots take the cluster kernel of
// lattice_ring_tiled.cu (the wrapper's launch_plan chooses). Helpers shared
// with it: lattice_ring_common.cuh.
//
// Design. One CTA runs one (g, k, b) over all L levels (the level axis is a
// dependence chain; the band sum of ms is the only coupling between CTAs,
// done with f32 atomics). Per level the product is a (W x J) @ (J x D)
// matrix product on the tensor cores with W as the M dimension: mma.sync
// m16n8k8 TF32 for f32 state as 3xTF32 (each operand split into TF32 hi and
// lo parts, hi*hi + hi*lo + lo*hi summed in f32: the f32 answer to ~1e-6,
// where one TF32 pass keeps ~3 digits), m16n8k16 bf16 with f32 accumulation
// for bf16 state (the operands are bf16 already, so the products are exact,
// as in the plain version). D is padded to 8-column n-tiles and each face
// block to whole k-steps; the padding of the factor is zero, so the A rows
// it meets only need to be finite. The factor block sits in shared memory in
// mma fragment order, split (or rounded) once per CTA. A fragments come from
// shared memory: the rhs tile, and the previous level's solution (the ring)
// read at row w - s_f and scaled by cin[f, w], zero for w < s_f.
//
// Warp specialisation, loads in flight: 8 consumer warps own 16-row slices
// of W and run the product; 8 producer warps build level l+1's rhs tile
// (reading v, ttc, bsrc, dsrc, cin, xmap and the closure rows from device
// memory and L2) while the consumers run level l, then stream level l's
// solution out of shared memory as ys (coalesced along W) and as the ms
// atomics. The rhs, shifted-cin and solution tiles are double-buffered by
// level parity; named barriers hand each tile between the roles (full /
// empty per buffer), and one consumer barrier orders a level's solution
// writes before its reads as the next ring. One CTA (16 warps) per SM.
//
// Shared memory at the flagship (D = 27, W = 256, three faces, padded row
// stride 264 so fragment reads are free of bank conflicts): the factor
// 32 KB (f32: hi and lo) or 8 KB (bf16), 2 x 28.5 KB solution tiles,
// 2 x 28.5 KB rhs tiles, 2 x 3 KB shifted cin: 149 KB f32, 125 KB bf16.
//
// What bounds it on an H100 SXM at the flagship bucket 0 (46 levels x 1600
// CTAs): the state streams (v in, ys out, 4.07 GB; 4.20 GB with every
// operand) take 1.25 ms at 3.35 TB/s; the product (1.1e11 flop) 0.67 ms as
// 3xTF32 at the 495 TFLOP/s TF32 peak. By those it is bound by bytes, but
// the kernel reaches neither (PERF.md, PR 5): in f32 the product alone
// takes ~3 ms (mma.sync TF32 issues at about A100 rates; wgmma was tried and
// was no faster, its 3-term chains being latency-bound), the producers'
// side alone ~3 ms (per-level load latency with one CTA per SM, ttc and
// bsrc re-read from L2 by every band), and the two overlap only in part.
// With the flagship's hull windows (7,246 of 11,776 slots; 496 of 736
// m-tiles) the bounds fall to 0.77 ms (bytes) and 0.41 ms (product), and
// the kernel gains 6-10% (PERF.md). The producers' side alone stays
// at ~2.9 ms: what it costs per level is the latency of one level's loads
// and stores on the threads that stay, not its bytes. The product alone
// stays at ~3.7 ms: with one m-tile a warp keeps 4 accumulator chains of 48
// dependent mma in flight where two tiles keep 8, so a narrow level is
// bound by the chains' latency, not by its tile count (and the order of a
// chain cannot depend on the window, or ys would differ from the full
// slab's). Spreading the producer threads over a narrow window's columns
// (row groups of 256, 128 or 64 columns, the row stride a compile-time
// constant) was measured 10% slower in f32 and 8% faster in bf16 and is not
// taken; with a run-time condition on each row it was 1.9x slower: loads
// behind a condition do not stay in flight together.

#include "lattice_ring_common.cuh"

// Measurement variants (bench_k1.py builds them with -D; the default build
// defines none; each gives wrong results and only times what is left):
// PBTE_K1_NO_MS drops the ms atomics, PBTE_K1_NO_YS the ys stores,
// PBTE_K1_NO_PRODUCT the tensor-core product, PBTE_K1_NO_LOADS the
// producers' loads from device memory (with NO_YS and NO_MS: the product
// and the hand-over of the tiles alone).

namespace {

constexpr int kMaxW = 256;
// element DOF counts the kernels are instantiated for: quad p = 1, 2, 3
// (4, 9, 16) and hex p = 1, 2 (8, 27); hex p = 3 (64) and every level
// wider than kMaxW take the cluster kernel of lattice_ring_tiled.cu
#define PBTE_K1_ONE_CTA_D(X) X(4) X(8) X(9) X(16) X(27)
constexpr int kConsumerWarps = 8;
constexpr int kProducerWarps = 8;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kProducerThreads = 32 * kProducerWarps;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
// 16-row m-tiles of W per consumer warp
constexpr int kMTilesPerWarp = kMaxW / 16 / kConsumerWarps;

// Named barriers between the two warp roles (barrier 0 is __syncthreads).
// bar.arrive signals without waiting; bar.sync waits for `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory carve-up (byte offsets), the same on host and device: the
// factor block in fragment order, two solution tiles, two rhs tiles and two
// shifted-cin tiles (level parity selects the tile), and the L windows
template <int D, bool CAST>
struct Smem {
  size_t bfrag, sol, rhs, cinc, wins, tile, cin_tile, total;
  __host__ __device__ Smem(int W, int nf, int L) {
    using G = Geo<D, CAST>;
    tile = align16(sizeof(float) * D * tile_stride(W));
    cin_tile = align16(sizeof(float) * nf * cin_stride(W));
    bfrag = 0;
    sol = align16(static_cast<size_t>(1 + nf) * G::KT_FACE * G::NT * 32 *
                  G::BFRAG_BYTES);
    rhs = sol + 2 * tile;
    cinc = rhs + 2 * tile;
    wins = cinc + 2 * cin_tile;
    total = wins + align16(sizeof(int2) * L);
  }
};

// barrier ids: rhs tile s full / empty, solution tile s full / empty, and
// the consumers' own level barrier
constexpr int kRhsFull = 1, kRhsEmpty = 3, kSolFull = 5, kSolEmpty = 7,
              kConsumers = 9;

template <int D, typename State, bool CAST>
__global__ void __launch_bounds__(kThreads, 1)
lattice_ring_kernel(const State* __restrict__ v, const float* __restrict__ ttc,
                    const float* __restrict__ bsrc,
                    const float* __restrict__ cin,
                    const float* __restrict__ bcat,
                    const float* __restrict__ macro_w,
                    const float* __restrict__ wvec,
                    const float* __restrict__ dsrc,
                    const int* __restrict__ xmap,
                    const float* __restrict__ xval, int n_u,
                    const int* __restrict__ win, State* __restrict__ ys,
                    float* __restrict__ ms, int L,
                    int Gb, int Km, int BS, int W, int nf, Shifts sh) {
  using G = Geo<D, CAST>;
  constexpr int NT = G::NT;
  constexpr int KT_FACE = G::KT_FACE;
  const int WP = tile_stride(W);
  const int WC = cin_stride(W);
  const int J = (1 + nf) * D;
  const Smem<D, CAST> lay(W, nf, L);

  extern __shared__ __align__(16) unsigned char smem[];
  auto sol_t = [&](int s) {  // (D, WP) f32
    return reinterpret_cast<float*>(smem + lay.sol + s * lay.tile);
  };
  auto rhs_t = [&](int s) {  // (D, WP) f32
    return reinterpret_cast<float*>(smem + lay.rhs + s * lay.tile);
  };
  auto cinc_t = [&](int s) {  // (nf, WC) f32
    return reinterpret_cast<float*>(smem + lay.cinc + s * lay.cin_tile);
  };
  int2* wins = reinterpret_cast<int2*>(smem + lay.wins);  // [lo, hi) per level

  const int tid = threadIdx.x;
  const int b = blockIdx.x % BS;
  const int gk = blockIdx.x / BS;  // g * Km + k
  const int g = gk / Km;
  const int k = gk % Km;
  const size_t DW = static_cast<size_t>(D) * W;

  // the factor block in mma fragment order: B[kk][n] = bcat[n, f D + jj]
  // for the k index kk = f KP + jj of face block f (zero where jj >= D or
  // n >= D); TF32 mode keeps hi and lo parts, bf16 mode the rounded values
  {
    const float* blk = bcat + (static_cast<size_t>(gk) * BS + b) * D * J;
    auto bval = [&](int kk, int n) -> float {
      const int f = kk / G::KP;
      const int jj = kk - f * G::KP;
      return (jj < D && n < D) ? blk[static_cast<size_t>(n) * J + f * D + jj]
                               : 0.f;
    };
    const int n_frag = (1 + nf) * KT_FACE * NT * 32;
    for (int idx = tid; idx < n_frag; idx += kThreads) {
      const int ln = idx & 31;
      const int nt = (idx >> 5) % NT;
      const int kt = (idx >> 5) / NT;
      const int n = nt * 8 + (ln >> 2);
      const int t = ln & 3;
      if constexpr (CAST) {
        const int k0 = kt * 16 + 2 * t;
        uint2 f;
        f.x = pack_bf16(bval(k0, n), bval(k0 + 1, n));
        f.y = pack_bf16(bval(k0 + 8, n), bval(k0 + 9, n));
        reinterpret_cast<uint2*>(smem + lay.bfrag)[idx] = f;
      } else {
        const int k0 = kt * 8 + t;
        uint4 f;
        split_tf32_rna(bval(k0, n), f.x, f.z);
        split_tf32_rna(bval(k0 + 4, n), f.y, f.w);
        reinterpret_cast<uint4*>(smem + lay.bfrag)[idx] = f;
      }
    }
  }
  // both solution tiles zero (tile 1 is level 0's ring); the padding
  // columns [W, WP) of the rhs tiles and [W, WC) of the cin tiles stay zero
  // (no pass writes them)
  for (int i = tid; i < static_cast<int>(2 * lay.tile / 4); i += kThreads) {
    sol_t(0)[i] = 0.f;
  }
  for (int i = tid; i < 2 * D * (WP - W); i += kThreads) {
    const int r = i / (WP - W);  // (tile, row) pair
    rhs_t(r / D)[(r % D) * WP + W + (i - r * (WP - W))] = 0.f;
  }
  for (int i = tid; i < static_cast<int>(2 * lay.cin_tile / 4);
       i += kThreads) {
    cinc_t(0)[i] = 0.f;
  }
  for (int l = tid; l < L; l += kThreads) {
    wins[l] = win != nullptr ? make_int2(__ldg(win + 2 * l),
                                         __ldg(win + 2 * l + 1))
                             : make_int2(0, W);
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer warps: level l+1's rhs in, level l's solution out ----
    const int p = tid - kConsumerThreads;
    const int R = kProducerThreads / W;  // rows per pass (W <= 256)
    const int pw = p % W;
    const int pj = p / W;
    const bool on = pj < R;
    const float w_src = wvec[b];
    const float w_rel = wvec[BS + b];
    const float w_bcv = wvec[2 * BS + b];
    const float w_dir = wvec[3 * BS + b];
    const float mw = macro_w[static_cast<size_t>(gk) * BS + b];

    // one column pass over the rows j = pj, pj + R, ... < D (unrolled when
    // one pass covers every row)
    auto rows = [&](auto&& body) {
      if (R == 1) {
#pragma unroll
        for (int j = 0; j < D; ++j) body(j);
      } else {
        for (int j = pj; j < D; j += R) body(j);
      }
    };
    // one level's streamed inputs: in cast mode with one row pass (W = 256,
    // the flagship's), level l+1's v, ttc and bsrc are loaded into
    // registers while level l is stored, so their latency hides behind the
    // store and the wait for the consumers (5% faster in bf16; in exact mode
    // the registers it holds cost the consumers more than it saves, 3%)
    State f_v[D];
    float f_ttc[D], f_bsrc[D];
    // defined from the start: prep reads them (and discards what it read)
    // on a column outside the window, which fetch skips
#pragma unroll
    for (int j = 0; j < D; ++j) {
      f_v[j] = from_f32<State>(0.f);
      f_ttc[j] = 0.f;
      f_bsrc[j] = 0.f;
    }
    auto in_window = [&](int l) {
      const int2 wl = wins[l];
      return pw >= wl.x && pw < wl.y;
    };
    auto fetch = [&](int l) {
      if (R != 1 || !CAST || !in_window(l)) return;
#ifdef PBTE_K1_NO_LOADS
      return;
#endif
      const size_t lg = static_cast<size_t>(l) * Gb + g;
      const size_t lgk = lg * Km + k;
      const State* v_l = v + (lgk * BS + b) * DW + pw;
      const float* ttc_l = ttc + lg * DW + pw;
      const float* bsrc_l = bsrc + lgk * DW + pw;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const size_t o = static_cast<size_t>(j) * W;
        f_v[j] = v_l[o];
        f_ttc[j] = __ldg(ttc_l + o);
        f_bsrc[j] = __ldg(bsrc_l + o);
      }
    };
    // rhs tile and shifted inflow coefficients of level l into tile l & 1
    auto prep = [&](int l) {
      if (!on) return;
      float* rhs = rhs_t(l & 1);
      float* cinc = cinc_t(l & 1);
      const int2 wl = wins[l];
      const bool inw = pw >= wl.x && pw < wl.y;
      if (!inw) {
        // a column of the window's m-tiles that lies outside the window:
        // zero rhs and inflow coefficients make its solution an exact zero.
        // The path that holds a level in registers writes these zeros
        // through the in-window code below, by a select on inw and with no
        // load: a second body beside the held registers spilled 68 bytes
        // (bf16, D = 27) and cost 4.5% of the launch on an H100
        if (pw < (wl.x & ~15) || pw >= ((wl.y + 15) & ~15)) return;
        if (!(R == 1 && CAST)) {
          for (int f = pj; f < nf; f += R) cinc[f * WC + pw] = 0.f;
          rows([&](int j) { rhs[j * WP + pw] = 0.f; });
          return;
        }
      }
#ifdef PBTE_K1_NO_LOADS
      for (int f = pj; f < nf; f += R) cinc[f * WC + pw] = 0.f;
      rows([&](int j) { rhs[j * WP + pw] = 0.f; });
      return;
#endif
      const size_t lg = static_cast<size_t>(l) * Gb + g;
      const size_t lgk = lg * Km + k;
      for (int f = pj; f < nf; f += R) {
        const float c = inw ? __ldg(cin + (lgk * nf + f) * W + pw) : 0.f;
        cinc[f * WC + pw] = pw >= sh.s[f] ? op_round<CAST>(c) : 0.f;
      }
      const float* xv = nullptr;
      if (xmap != nullptr && inw) {
        const int u = __ldg(xmap + lg * W + pw);
        if (u >= 0) {
          xv = xval + ((static_cast<size_t>(g) * n_u + u) * Km + k) * BS * D +
               static_cast<size_t>(b) * D;
        }
      }
      const State* v_l = v + (lgk * BS + b) * DW + pw;
      const float* ttc_l = ttc + lg * DW + pw;
      const float* bsrc_l = bsrc + lgk * DW + pw;
      const float* dsrc_l =
          dsrc != nullptr && inw ? dsrc + lgk * DW + pw : nullptr;
      auto put = [&](int j, float x) {
        if (dsrc_l != nullptr) {
          x -= w_dir * __ldg(dsrc_l + static_cast<size_t>(j) * W);
        }
        if (xv != nullptr) x += xv[j];
        rhs[j * WP + pw] = op_round<CAST>(x);
      };
      if (R == 1 && CAST) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          put(j, inw ? w_src * f_ttc[j] + w_rel * to_f32(f_v[j]) -
                           w_bcv * f_bsrc[j]
                     : 0.f);
        }
      } else {
        // unrolled when one pass covers every row: the loads of all rows
        // are in flight at once
        rows([&](int j) {
          const size_t o = static_cast<size_t>(j) * W;
          put(j, w_src * __ldg(ttc_l + o) + w_rel * to_f32(v_l[o]) -
                     w_bcv * __ldg(bsrc_l + o));
        });
      }
    };
    // level l's solution out: ys (state dtype) and the ms partial
    auto store = [&](int l) {
      if (!on) return;
      const float* sol = sol_t(l & 1);
      const size_t lgk = (static_cast<size_t>(l) * Gb + g) * Km + k;
      State* ys_l = ys + (lgk * BS + b) * DW + pw;
      if (!in_window(l)) {  // ys is zero outside the window, ms untouched
#ifndef PBTE_K1_NO_YS
        rows([&](int j) {
          ys_l[static_cast<size_t>(j) * W] = from_f32<State>(0.f);
        });
#endif
        return;
      }
      float* ms_l = ms + (static_cast<size_t>(gk) * L + l) * DW + pw;
      rows([&](int j) {
        const float s = sol[j * WP + pw];
#ifndef PBTE_K1_NO_YS
        ys_l[static_cast<size_t>(j) * W] = from_f32<State>(s);
#endif
#ifndef PBTE_K1_NO_MS
        atomicAdd(ms_l + static_cast<size_t>(j) * W, mw * s);
#endif
      });
    };

    fetch(0);
    prep(0);
    bar_arrive(kRhsFull + 0, kThreads);
    if (L > 1) fetch(1);
    for (int l = 0; l < L; ++l) {
      if (l + 1 < L) {
        const int s1 = (l + 1) & 1;
        if (l + 1 >= 2) bar_sync(kRhsEmpty + s1, kThreads);
        prep(l + 1);
        bar_arrive(kRhsFull + s1, kThreads);
        if (l + 2 < L) fetch(l + 2);
      }
      bar_sync(kSolFull + (l & 1), kThreads);
      store(l);
      if (l + 2 < L) bar_arrive(kSolEmpty + (l & 1), kThreads);
    }
    return;
  }

  // ---- consumer warps: the product of each level on the tensor cores ----
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment group: rows gq, gq + 8
  const int tq = lane & 3;   // thread in group: k (and n) columns

  for (int l = 0; l < L; ++l) {
    const int s = l & 1;
    const float* rhs = rhs_t(s);
    const float* cinc = cinc_t(s);
    const float* ring = sol_t(s ^ 1);  // level l-1 (zero at level 0)
    // the window's m-tiles [t0, t0 + nt): this warp runs tile t0 + warp
    // and, in a window of more than 8 tiles, tile t0 + warp + 8
    const int2 wl = wins[l];
    const int t0 = wl.x >> 4;
    const int nt = wl.y > wl.x ? ((wl.y + 15) >> 4) - t0 : 0;
    bar_sync(kRhsFull + s, kThreads);

    // acc[w, i] = sum_kk A[w, kk] B[kk, i] over the face blocks (face 0:
    // the rhs tile; face f >= 1: the ring, shifted and scaled)
    float acc[kMTilesPerWarp][NT][4];
#pragma unroll
    for (int m = 0; m < kMTilesPerWarp; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

#ifndef PBTE_K1_NO_PRODUCT
#pragma unroll
    for (int f = 0; f <= kMaxFaces; ++f) {
      if (f > nf) break;
      // per m-tile: this lane's two A rows, the ring rows they read and
      // their inflow coefficients
      int row[kMTilesPerWarp][2];
      float cf[kMTilesPerWarp][2];
#pragma unroll
      for (int m = 0; m < kMTilesPerWarp; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = (t0 + warp + m * kConsumerWarps) * 16 + gq + 8 * h;
          if (f == 0) {
            row[m][h] = w;
            cf[m][h] = 1.f;
          } else {
            const int wc = w < WC ? w : WC - 1;
            cf[m][h] = cinc[(f - 1) * WC + wc];
            row[m][h] = w >= sh.s[f - 1] ? w - sh.s[f - 1] : 0;
          }
        }
      }
      const float* src = f == 0 ? rhs : ring;
#pragma unroll
      for (int kt = 0; kt < KT_FACE; ++kt) {
        const int kt_all = f * KT_FACE + kt;
        if constexpr (CAST) {
          int jr[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = kt * 16 + 2 * tq + (q & 1) + 8 * (q >> 1);
            jr[q] = (j < D ? j : D - 1) * WP;
          }
          uint32_t a[kMTilesPerWarp][4];
#pragma unroll
          for (int m = 0; m < kMTilesPerWarp; ++m) {
            if (warp + m * kConsumerWarps >= nt) continue;
            float x[2][4];  // [row half][k: 2t, 2t+1, 2t+8, 2t+9]
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float r = src[jr[q] + row[m][h]];
                x[h][q] = f == 0 ? r : op_round<true>(cf[m][h] *
                                                      op_round<true>(r));
              }
            a[m][0] = pack_bf16(x[0][0], x[0][1]);
            a[m][1] = pack_bf16(x[1][0], x[1][1]);
            a[m][2] = pack_bf16(x[0][2], x[0][3]);
            a[m][3] = pack_bf16(x[1][2], x[1][3]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint2 q = reinterpret_cast<const uint2*>(
                smem + lay.bfrag)[(kt_all * NT + n) * 32 + lane];
#pragma unroll
            for (int m = 0; m < kMTilesPerWarp; ++m) {
              if (warp + m * kConsumerWarps < nt) {
                mma_bf16(acc[m][n], a[m], q.x, q.y);
              }
            }
          }
        } else {
          const int j0 = kt * 8 + tq;
          const int jr0 = (j0 < D ? j0 : D - 1) * WP;
          const int jr1 = (j0 + 4 < D ? j0 + 4 : D - 1) * WP;
          uint32_t hi[kMTilesPerWarp][4], lo[kMTilesPerWarp][4];
#pragma unroll
          for (int m = 0; m < kMTilesPerWarp; ++m) {
            if (warp + m * kConsumerWarps >= nt) continue;
            // a0 (row gq, k t), a1 (gq+8, t), a2 (gq, t+4), a3 (gq+8, t+4)
            float x[4] = {src[jr0 + row[m][0]], src[jr0 + row[m][1]],
                          src[jr1 + row[m][0]], src[jr1 + row[m][1]]};
            if (f > 0) {
              x[0] *= cf[m][0];
              x[1] *= cf[m][1];
              x[2] *= cf[m][0];
              x[3] *= cf[m][1];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(x[q], hi[m][q], lo[m][q]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint4 q = reinterpret_cast<const uint4*>(
                smem + lay.bfrag)[(kt_all * NT + n) * 32 + lane];
#pragma unroll
            for (int m = 0; m < kMTilesPerWarp; ++m) {
              if (warp + m * kConsumerWarps < nt) {
                // small terms first
                mma_tf32(acc[m][n], lo[m], q.x, q.y);
                mma_tf32(acc[m][n], hi[m], q.z, q.w);
                mma_tf32(acc[m][n], hi[m], q.x, q.y);
              }
            }
          }
        }
      }
    }
#endif
    // the rhs and cin tiles of this level are free for level l+2
    if (l + 2 < L) bar_arrive(kRhsEmpty + s, kThreads);
    // the producers are done with level l-2's solution in tile s
    if (l >= 2) bar_sync(kSolEmpty + s, kThreads);
    float* sol = sol_t(s);
#pragma unroll
    for (int m = 0; m < kMTilesPerWarp; ++m) {
      if (warp + m * kConsumerWarps >= nt) continue;
      const int w0 = (t0 + warp + m * kConsumerWarps) * 16 + gq;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int i0 = n * 8 + 2 * tq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int w = w0 + 8 * (q >> 1);
          const int i = i0 + (q & 1);
          if (w < W && i < D) sol[i * WP + w] = acc[m][n][q];
        }
      }
    }
    bar_arrive(kSolFull + s, kThreads);
    // every consumer's part of tile s is written before it is read as the
    // next level's ring (and every read of tile s ^ 1 is done)
    bar_sync(kConsumers, kConsumerThreads);
  }
}

template <int D, typename State, bool CAST>
size_t smem_bytes(int W, int nf, int L) {
  return Smem<D, CAST>(W, nf, L).total;
}

template <int D, typename State, bool CAST>
cudaError_t launch(const void* v, const float* ttc, const float* bsrc,
                   const float* cin, const float* bcat, const float* macro_w,
                   const float* wvec, const float* dsrc, const int* xmap,
                   const float* xval, int n_u, const int* win, void* ys,
                   float* ms, int L, int Gb, int Km, int BS, int W, int nf,
                   Shifts sh, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, State, CAST>(W, nf, L);
  auto kernel = lattice_ring_kernel<D, State, CAST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<Gb * Km * BS, kThreads, smem, stream>>>(
      static_cast<const State*>(v), ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
      xmap, xval, n_u, win, static_cast<State*>(ys), ms, L, Gb, Km, BS, W, nf,
      sh);
  return cudaGetLastError();
}

template <typename State, bool CAST>
cudaError_t dispatch_d(int D, const void* v, const float* ttc,
                       const float* bsrc, const float* cin, const float* bcat,
                       const float* macro_w, const float* wvec,
                       const float* dsrc, const int* xmap, const float* xval,
                       int n_u, const int* win, void* ys, float* ms, int L,
                       int Gb, int Km, int BS, int W, int nf, Shifts sh,
                       cudaStream_t stream) {
  switch (D) {
#define PBTE_K1_CASE(d)                                                     \
  case d:                                                                   \
    return launch<d, State, CAST>(v, ttc, bsrc, cin, bcat, macro_w, wvec,   \
                                  dsrc, xmap, xval, n_u, win, ys, ms, L, Gb, \
                                  Km, BS, W, nf, sh, stream);
    PBTE_K1_ONE_CTA_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- float64 state ---------------------------------------------------------
//
// The same recurrence with float64 state, float64 operands (ttc, bsrc, cin,
// bcat, macro_w, wvec, dsrc, xval) and float64 accumulation: the counterpart
// of lattice_ring_sweep_ref(..., cast_bf16=False) on float64 tensors, and of
// pbte_tpu's float64 XLA ring (its Pallas kernel takes float32 state only).
// The Krylov-accelerated solve needs it: in float32 the outer step is affine
// only to a ~2.7e-3 defect, where every Krylov recurrence stalls.
//
// Design: the pattern of the f32 kernel above in float64. One CTA runs one
// (g, k, b) over all L levels. Per level the product sol (W x D) = X (W x J)
// . B^T (J x D) runs on the FP64 tensor cores (DMMA, mma.sync m16n8k4 .f64;
// wgmma has no float64): W is the M dimension in 16-row m-tiles, D is padded
// to 8-column n-tiles (27 -> 32) and each face block to whole 4-deep k-steps
// (27 -> 28; the factor's padding is zero, so the A rows it meets only need
// to be finite). m16n8k4 pads K least: on an H100 it ran the flagship's
// bucket 0 7% faster than m16n8k8 (whose consumers spilled 28 B) and 1.67x
// faster than m16n8k16 (336 B spilled; PERF.md section 6). The factor sits
// in shared memory in B-fragment order, written once per CTA. A fragments
// come from shared memory: the rhs tile, and the ring (the previous
// level's solution) read at row w - s_f and scaled by cin[f, w], zero for
// w < s_f. Sums are float64 throughout; the order of a column's sum is
// fixed by the tile code, whatever the window.
//
// Warp specialisation, loads in flight: 8 producer warps build level l+1's
// rhs tile and shifted inflow coefficients (reading v, ttc, bsrc, dsrc, cin,
// xmap and the closure rows from device memory and L2) while the 8 consumer
// warps multiply level l. The rhs and cin tiles are double-buffered by level
// parity, handed over by named barriers (full / empty per buffer, 512
// threads in every phase). There is one solution tile, which is also the
// next level's ring: the consumers write level l's solution into it after a
// consumer barrier that ends every read of it as level l's ring, and a second
// one orders those writes before level l+1 reads them.
//
// The consumers, not the producers, stream the solution out: each warp,
// after writing its own m-tiles' columns of the solution tile, reads them
// back (the warp's own writes, so no barrier) and stores them as ys and as
// the ms atomics, 2 rows x 16 columns per instruction, whole 128-byte lines.
// With one solution tile a producer pass over it would have to end before
// the consumers write the next level, so the producers' loads and those
// stores would run one after the other and set the pace together; the
// consumers' stores cost them issue slots only. The producers store the zeros
// of ys outside the window's m-tiles.
//
// Hull windows as in the f32 kernel: the consumers run the window's m-tiles
// only; columns of those tiles outside the window get a zero rhs and zero
// inflow coefficients, so their solution is an exact zero, and ys there is
// stored as such; ms is added for the window's columns only. Rows of the
// solution tile that a level does not compute keep an earlier level's
// finite solution, which the next level reads only where its cin is zero.
// So windowed ys equals the full slab's bit for bit, and ys is exact zeros
// outside the windows (Krylov vectors stay zero on the padding).
//
// Shared memory at the flagship (D = 27, W = 256, three faces, row stride
// 260 doubles, which is 4 mod 16: the 16 lanes of a half-warp's 8-byte
// fragment read fall on 16 distinct 8-byte bank pairs; a stride of 8 mod 16
// would put two lanes on each): the factor 4 faces x 7 k-steps x 4 n-tiles
// x 32 lanes x 8 B = 28,672 B, one solution tile 27 x 260 x 8 = 56,160 B,
// two rhs tiles 112,320 B, two shifted-cin tiles 12,288 B and 46 windows:
// 209,808 B, one CTA (16 warps) per SM.
//
// What bounds it on an H100 SXM at the flagship bucket 0 with the hull
// windows: 5.18 GB (v in, ys out, the float64 ms partials and operands) take
// 1.55 ms at 3.35 TB/s; its 6.76e10 flop take 1.01 ms at the FP64 tensor-core
// peak of 67 TFLOP/s (1.3 ms with the padding of D, K and the m-tiles).
// Measured on an H100 (PERF.md section 6): 5.43 ms, 0.29 of the bound,
// against 10.71 for the one-role FP64-FMA kernel it replaces; the memory
// side alone (no product) 4.86 ms, the product alone 3.29 (28 TFLOP/s of
// padded work), so the two overlap well and neither reaches its bound:
// every band re-reads ttc, bsrc and dsrc from L2, which the bound counts
// once. Giving the producers more registers (setmaxnreg 144/112, 152/104),
// an L2 prefetch of level l+2's v rows and the producers streaming ys and
// ms out of the solution tile (1.45x) were slower and are not kept.
//
// Measurement variants: PBTE_K1_NO_MS, PBTE_K1_NO_YS, PBTE_K1_NO_PRODUCT and
// PBTE_K1_NO_LOADS as above.

// Shared-memory carve-up of the float64 kernel (byte offsets), the same on
// host and device: the factor in fragment order, one solution tile, two rhs
// tiles and two shifted-cin tiles (level parity), and the L windows
template <int D>
struct SmemF64 {
  size_t bfrag, sol, rhs, cinc, wins, tile, cin_tile, total;
  __host__ __device__ SmemF64(int W, int nf, int L) {
    using G = GeoF64<D>;
    tile = align16(sizeof(double) * D * f64_tile_stride(W));
    cin_tile = align16(sizeof(double) * nf * cin_stride(W));
    bfrag = 0;
    sol = align16(sizeof(double) * (1 + nf) * G::KT_FACE * G::NT * 32);
    rhs = sol + tile;
    cinc = rhs + 2 * tile;
    wins = cinc + 2 * cin_tile;
    total = wins + align16(sizeof(int2) * L);
  }
};

template <int D, bool DIR>
__global__ void __launch_bounds__(kThreads, 1)
lattice_ring_f64_kernel(const double* __restrict__ v,
                        const double* __restrict__ ttc,
                        const double* __restrict__ bsrc,
                        const double* __restrict__ cin,
                        const double* __restrict__ bcat,
                        const double* __restrict__ macro_w,
                        const double* __restrict__ wvec,
                        const double* __restrict__ dsrc,
                        const int* __restrict__ xmap,
                        const double* __restrict__ xval, int n_u,
                        const int* __restrict__ win, double* __restrict__ ys,
                        double* __restrict__ ms, int L, int Gb, int Km,
                        int BS, int W, int nf, Shifts sh) {
  using G = GeoF64<D>;
  constexpr int NT = G::NT;
  constexpr int KT_FACE = G::KT_FACE;
  const int WP = f64_tile_stride(W);
  const int WC = cin_stride(W);
  const int J = (1 + nf) * D;
  const SmemF64<D> lay(W, nf, L);

  extern __shared__ __align__(16) unsigned char smem[];
  double* sol = reinterpret_cast<double*>(smem + lay.sol);  // (D, WP)
  auto rhs_t = [&](int s) {  // (D, WP)
    return reinterpret_cast<double*>(smem + lay.rhs + s * lay.tile);
  };
  auto cinc_t = [&](int s) {  // (nf, WC)
    return reinterpret_cast<double*>(smem + lay.cinc + s * lay.cin_tile);
  };
  int2* wins = reinterpret_cast<int2*>(smem + lay.wins);  // [lo, hi) per level

  const int tid = threadIdx.x;
  const int b = blockIdx.x % BS;
  const int gk = blockIdx.x / BS;  // g * Km + k
  const int g = gk / Km;
  const int k = gk % Km;
  const size_t DW = static_cast<size_t>(D) * W;

  // the factor in B-fragment order: entry (kt NT + n) 32 + lane holds
  // B[kk][i] = bcat[i, f D + jj] for k-step kt of face block f, k index
  // jj = 4 (kt mod KT_FACE) + tq and column i = 8 n + gq (zero where
  // jj >= D or i >= D)
  {
    const double* blk = bcat + (static_cast<size_t>(gk) * BS + b) * D * J;
    double* bf = reinterpret_cast<double*>(smem + lay.bfrag);
    const int n_frag = (1 + nf) * KT_FACE * NT * 32;
    for (int idx = tid; idx < n_frag; idx += kThreads) {
      const int ln = idx & 31;
      const int nt = (idx >> 5) % NT;
      const int kt = (idx >> 5) / NT;
      const int f = kt / KT_FACE;
      const int jj = (kt - f * KT_FACE) * 4 + (ln & 3);
      const int i = nt * 8 + (ln >> 2);
      bf[idx] = (jj < D && i < D)
                    ? blk[static_cast<size_t>(i) * J + f * D + jj]
                    : 0.0;
    }
  }
  // the solution tile zero (level 0's ring), the padding columns [W, WP) of
  // the rhs tiles and both cin tiles zero (no pass writes the padding)
  for (int i = tid; i < D * WP; i += kThreads) sol[i] = 0.0;
  for (int i = tid; i < 2 * D * (WP - W); i += kThreads) {
    const int r = i / (WP - W);  // (tile, row) pair
    rhs_t(r / D)[(r % D) * WP + W + (i - r * (WP - W))] = 0.0;
  }
  for (int i = tid; i < static_cast<int>(2 * lay.cin_tile / 8);
       i += kThreads) {
    cinc_t(0)[i] = 0.0;
  }
  for (int l = tid; l < L; l += kThreads) {
    wins[l] = win != nullptr ? make_int2(__ldg(win + 2 * l),
                                         __ldg(win + 2 * l + 1))
                             : make_int2(0, W);
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer warps: level l+1's rhs in, ys zeros out ----
    const int p = tid - kConsumerThreads;
    const int R = kProducerThreads / W;  // rows per pass (W <= 256)
    const int pw = p % W;
    const int pj = p / W;
    const bool on = pj < R;
    const double w_src = wvec[b];
    const double w_rel = wvec[BS + b];
    const double w_bcv = wvec[2 * BS + b];
    const double w_dir = wvec[3 * BS + b];

    // one column pass over the rows j = pj, pj + R, ... < D (unrolled when
    // one pass covers every row: every row's loads are in flight at once)
    auto rows = [&](auto&& body) {
      if (R == 1) {
#pragma unroll
        for (int j = 0; j < D; ++j) body(j);
      } else {
        for (int j = pj; j < D; j += R) body(j);
      }
    };
    // the window's m-tiles as columns [lo, hi) (empty: none)
    auto tiles = [&](int l) {
      const int2 wl = wins[l];
      return wl.y > wl.x ? make_int2(wl.x & ~15, (wl.y + 15) & ~15)
                         : make_int2(0, 0);
    };
    // rhs tile and shifted inflow coefficients of level l into tile l & 1:
    // the columns of the window's m-tiles (no consumer reads the others);
    // a column outside the window gets zeros by a select, with its loads
    // (of the padding, zero by the windows' contract) left in place: a
    // second body for such columns spilled in the f32 kernel
    auto prep = [&](int l) {
      const int2 tw = tiles(l);
      if (!on || pw < tw.x || pw >= tw.y) return;
      const int2 wl = wins[l];
      const bool inw = pw >= wl.x && pw < wl.y;
      double* rhs = rhs_t(l & 1);
      double* cinc = cinc_t(l & 1);
#ifdef PBTE_K1_NO_LOADS
      for (int f = pj; f < nf; f += R) cinc[f * WC + pw] = 0.0;
      rows([&](int j) { rhs[j * WP + pw] = 0.0; });
      return;
#endif
      const size_t lg = static_cast<size_t>(l) * Gb + g;
      const size_t lgk = lg * Km + k;
      for (int f = pj; f < nf; f += R) {
        const double c = __ldg(cin + (lgk * nf + f) * W + pw);
        cinc[f * WC + pw] = inw && pw >= sh.s[f] ? c : 0.0;
      }
      const double* xv = nullptr;
      if (xmap != nullptr) {
        const int u = __ldg(xmap + lg * W + pw);
        if (u >= 0 && inw) {
          xv = xval + ((static_cast<size_t>(g) * n_u + u) * Km + k) * BS * D +
               static_cast<size_t>(b) * D;
        }
      }
      const double* v_l = v + (lgk * BS + b) * DW + pw;
      const double* ttc_l = ttc + lg * DW + pw;
      const double* bsrc_l = bsrc + lgk * DW + pw;
      const double* dsrc_l = DIR ? dsrc + lgk * DW + pw : nullptr;
      rows([&](int j) {
        const size_t o = static_cast<size_t>(j) * W;
        double x = w_src * __ldg(ttc_l + o) + w_rel * __ldg(v_l + o) -
                   w_bcv * __ldg(bsrc_l + o);
        if constexpr (DIR) x -= w_dir * __ldg(dsrc_l + o);
        if (xv != nullptr) x += __ldg(xv + j);
        rhs[j * WP + pw] = inw ? x : 0.0;
      });
    };
    // ys of level l outside the window's m-tiles: zeros (the consumers
    // store the rest)
    auto zeros = [&](int l) {
#ifndef PBTE_K1_NO_YS
      const int2 tw = tiles(l);
      if (!on || (pw >= tw.x && pw < tw.y)) return;
      const size_t lgk = (static_cast<size_t>(l) * Gb + g) * Km + k;
      double* ys_l = ys + (lgk * BS + b) * DW + pw;
      rows([&](int j) { ys_l[static_cast<size_t>(j) * W] = 0.0; });
#endif
    };

    prep(0);
    bar_arrive(kRhsFull + 0, kThreads);
    for (int l = 0; l < L; ++l) {
      if (l + 1 < L) {
        const int s1 = (l + 1) & 1;
        if (l + 1 >= 2) bar_sync(kRhsEmpty + s1, kThreads);
        prep(l + 1);
        bar_arrive(kRhsFull + s1, kThreads);
      }
      zeros(l);
    }
    return;
  }

  // ---- consumer warps: each level's product on the FP64 tensor cores,
  // then its solution into the tile and out as ys and ms ----
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment group: rows gq, gq + 8
  const int tq = lane & 3;   // thread in group: k (and n) columns
  const double mw = macro_w[static_cast<size_t>(gk) * BS + b];

  for (int l = 0; l < L; ++l) {
    const int s = l & 1;
    const double* rhs = rhs_t(s);
    const double* cinc = cinc_t(s);
    // the window's m-tiles [t0, t0 + nt): this warp runs tile t0 + warp
    // and, in a window of more than 8 tiles, tile t0 + warp + 8
    const int2 wl = wins[l];
    const int t0 = wl.x >> 4;
    const int nt = wl.y > wl.x ? ((wl.y + 15) >> 4) - t0 : 0;
    bar_sync(kRhsFull + s, kThreads);

    // acc[w, i] = sum_kk A[w, kk] B[kk, i] over the face blocks (face 0:
    // the rhs tile; face f >= 1: the ring, shifted and scaled)
    double acc[kMTilesPerWarp][NT][4];
#pragma unroll
    for (int m = 0; m < kMTilesPerWarp; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.0;

#ifndef PBTE_K1_NO_PRODUCT
#pragma unroll
    for (int f = 0; f <= kMaxFaces; ++f) {
      if (f > nf) break;
      // per m-tile: this lane's two A rows, the ring rows they read and
      // their inflow coefficients
      int row[kMTilesPerWarp][2];
      double cf[kMTilesPerWarp][2];
#pragma unroll
      for (int m = 0; m < kMTilesPerWarp; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = (t0 + warp + m * kConsumerWarps) * 16 + gq + 8 * h;
          if (f == 0) {
            row[m][h] = w;
            cf[m][h] = 1.0;
          } else {
            const int wc = w < WC ? w : WC - 1;
            cf[m][h] = cinc[(f - 1) * WC + wc];
            row[m][h] = w >= sh.s[f - 1] ? w - sh.s[f - 1] : 0;
          }
        }
      }
      const double* src = f == 0 ? rhs : sol;
#pragma unroll
      for (int kt = 0; kt < KT_FACE; ++kt) {
        const int kt_all = f * KT_FACE + kt;
        const int j = kt * 4 + tq;  // the tile row of this lane's k column
        const int jr = (j < D ? j : D - 1) * WP;
        double a[kMTilesPerWarp][2];
#pragma unroll
        for (int m = 0; m < kMTilesPerWarp; ++m) {
          if (warp + m * kConsumerWarps >= nt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const double x = src[jr + row[m][h]];
            a[m][h] = f == 0 ? x : cf[m][h] * x;
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const double q = reinterpret_cast<const double*>(
              smem + lay.bfrag)[(kt_all * NT + n) * 32 + lane];
#pragma unroll
          for (int m = 0; m < kMTilesPerWarp; ++m) {
            if (warp + m * kConsumerWarps < nt) {
              mma_f64(acc[m][n], a[m][0], a[m][1], q);
            }
          }
        }
      }
    }
#endif
    // the rhs and cin tiles of this level are free for level l+2
    if (l + 2 < L) bar_arrive(kRhsEmpty + s, kThreads);
    // every consumer's read of the solution tile as level l's ring is done
    bar_sync(kConsumers, kConsumerThreads);
#pragma unroll
    for (int m = 0; m < kMTilesPerWarp; ++m) {
      if (warp + m * kConsumerWarps >= nt) continue;
      const int w0 = (t0 + warp + m * kConsumerWarps) * 16 + gq;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int i0 = n * 8 + 2 * tq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int w = w0 + 8 * (q >> 1);
          const int i = i0 + (q & 1);
          if (w < W && i < D) sol[i * WP + w] = acc[m][n][q];
        }
      }
    }
    __syncwarp();
    // this warp's m-tiles out of the tile: ys (zeros included) and the ms
    // partials of the window's columns, 2 rows x 16 columns a step
    {
      const size_t lgk = (static_cast<size_t>(l) * Gb + g) * Km + k;
      double* ys_l = ys + (lgk * BS + b) * DW;
      double* ms_l = ms + (static_cast<size_t>(gk) * L + l) * DW;
      const int c = lane & 15;
      const int jh = lane >> 4;
#pragma unroll
      for (int m = 0; m < kMTilesPerWarp; ++m) {
        if (warp + m * kConsumerWarps >= nt) continue;
        const int w = (t0 + warp + m * kConsumerWarps) * 16 + c;
        const bool inw = w >= wl.x && w < wl.y;
        if (w >= W) continue;
#pragma unroll
        for (int it = 0; it < (D + 1) / 2; ++it) {
          const int j = 2 * it + jh;
          if (j >= D) break;
          const double x = sol[j * WP + w];
          const size_t o = static_cast<size_t>(j) * W + w;
#ifndef PBTE_K1_NO_YS
          ys_l[o] = x;
#endif
#ifndef PBTE_K1_NO_MS
          if (inw) atomicAdd(ms_l + o, mw * x);
#endif
        }
      }
    }
    // level l's solution is in the tile before level l+1 reads it
    bar_sync(kConsumers, kConsumerThreads);
  }
}

template <int D, bool DIR>
cudaError_t launch_f64(const double* v, const double* ttc, const double* bsrc,
                       const double* cin, const double* bcat,
                       const double* macro_w, const double* wvec,
                       const double* dsrc, const int* xmap,
                       const double* xval, int n_u, const int* win,
                       double* ys, double* ms, int L, int Gb, int Km, int BS,
                       int W, int nf, Shifts sh, cudaStream_t stream) {
  const size_t smem = SmemF64<D>(W, nf, L).total;
  auto kernel = lattice_ring_f64_kernel<D, DIR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<Gb * Km * BS, kThreads, smem, stream>>>(
      v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc, xmap, xval, n_u, win, ys,
      ms, L, Gb, Km, BS, W, nf, sh);
  return cudaGetLastError();
}

// the kernel of one D, with or without the Dirichlet source (a compile-time
// choice: a load behind a run-time test on each row does not stay in
// flight with the others)
template <int D>
cudaError_t launch_f64_d(const double* v, const double* ttc,
                         const double* bsrc, const double* cin,
                         const double* bcat, const double* macro_w,
                         const double* wvec, const double* dsrc,
                         const int* xmap, const double* xval, int n_u,
                         const int* win, double* ys, double* ms, int L,
                         int Gb, int Km, int BS, int W, int nf, Shifts sh,
                         cudaStream_t stream) {
  return dsrc != nullptr
             ? launch_f64<D, true>(v, ttc, bsrc, cin, bcat, macro_w, wvec,
                                   dsrc, xmap, xval, n_u, win, ys, ms, L, Gb,
                                   Km, BS, W, nf, sh, stream)
             : launch_f64<D, false>(v, ttc, bsrc, cin, bcat, macro_w, wvec,
                                    dsrc, xmap, xval, n_u, win, ys, ms, L, Gb,
                                    Km, BS, W, nf, sh, stream);
}


}  // namespace

extern "C" {

// cast_bf16 = 0: f32 state, exact f32 operands (3xTF32 products).
// cast_bf16 = 1: bf16 state, bf16 operands and ring, f32 accumulation.
// dsrc may be null (no Dirichlet faces), xmap and xval null (no lagged
// closures; n_u is then ignored), win null (full slab) or (L, 2) int32 on
// the device. ms must be zeroed by the caller (the band sum is atomic); ys
// is written in full. Returns a cudaError_t.
int pbte_lattice_ring_sweep(int cast_bf16, int D, const void* v,
                            const float* ttc, const float* bsrc,
                            const float* cin, const float* bcat,
                            const float* macro_w, const float* wvec,
                            const float* dsrc, const int* xmap,
                            const float* xval, int n_u, const int* win,
                            void* ys, float* ms, int L, int Gb, int Km,
                            int BS, int W, int nf, int s0, int s1, int s2,
                            void* stream) {
  if (nf < 1 || nf > kMaxFaces || W < 1 || W > kMaxW || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shifts sh{{s0, s1, s2}};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cast_bf16
          ? dispatch_d<__nv_bfloat16, true>(D, v, ttc, bsrc, cin, bcat,
                                            macro_w, wvec, dsrc, xmap, xval,
                                            n_u, win, ys, ms, L, Gb, Km, BS,
                                            W, nf, sh, st)
          : dispatch_d<float, false>(D, v, ttc, bsrc, cin, bcat, macro_w,
                                     wvec, dsrc, xmap, xval, n_u, win, ys, ms,
                                     L, Gb, Km, BS, W, nf, sh, st);
  return static_cast<int>(err);
}

// Dynamic shared memory one launch takes (the wrapper's check).
long long pbte_lattice_ring_smem_bytes(int cast_bf16, int D, int W, int nf,
                                       int L) {
  switch (D) {
#define PBTE_K1_CASE(d)                                            \
  case d:                                                          \
    return static_cast<long long>(                                 \
        cast_bf16 ? smem_bytes<d, __nv_bfloat16, true>(W, nf, L)   \
                  : smem_bytes<d, float, false>(W, nf, L));
    PBTE_K1_ONE_CTA_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      return -1;
  }
}

// float64 state, float64 operands and accumulation (ms in float64); the
// arguments of pbte_lattice_ring_sweep less cast_bf16, with the same
// contract (ms zeroed by the caller, ys written in full).
int pbte_lattice_ring_sweep_f64(int D, const double* v, const double* ttc,
                                const double* bsrc, const double* cin,
                                const double* bcat, const double* macro_w,
                                const double* wvec, const double* dsrc,
                                const int* xmap, const double* xval, int n_u,
                                const int* win, double* ys, double* ms, int L,
                                int Gb, int Km, int BS, int W, int nf, int s0,
                                int s1, int s2, void* stream) {
  if (nf < 1 || nf > kMaxFaces || W < 1 || W > kMaxW || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shifts sh{{s0, s1, s2}};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
#define PBTE_K1_CASE(d)                                                      \
  case d:                                                                    \
    err = launch_f64_d<d>(v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc, xmap, \
                          xval, n_u, win, ys, ms, L, Gb, Km, BS, W, nf, sh,  \
                          st);                                               \
    break;
    PBTE_K1_ONE_CTA_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

long long pbte_lattice_ring_smem_bytes_f64(int D, int W, int nf, int L) {
  switch (D) {
#define PBTE_K1_CASE(d) \
  case d:               \
    return static_cast<long long>(SmemF64<d>(W, nf, L).total);
    PBTE_K1_ONE_CTA_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      return -1;
  }
}

const char* pbte_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
