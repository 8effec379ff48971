// Lattice ring sweep in column tiles, for NVIDIA Hopper (sm_90a): the
// shapes whose level does not fit one CTA's shared memory, which is hex
// p = 3 (D = 64) at any slab width W and any D at W > 256.
//
// Replaces pbte_tpu/ops/lattice_ring.py::lattice_ring_sweep (the Pallas TPU
// kernel, body `_kernel`) at those shapes; lattice_ring.cu's one-CTA kernels
// take the others. The recurrence, its arguments and its three state types
// are those of lattice_ring.cu (f32 state as 3xTF32 products, bf16 state with
// bf16 operands and ring and f32 sums, f64 state on the FP64 tensor cores);
// plain PyTorch version and dispatching wrapper:
// pbte_tpu_torch/ops/lattice_ring.py.
//
// Design. A level of W slab columns is cut into C tiles of Wt columns (Wt a
// multiple of the mma's 16 rows, at most WT_MAX of TGeo for the (D, state
// type), chosen by the wrapper). One CTA runs one tile (g, k, b, t) over all
// L levels; the tiles of a level need not be resident together, so C has no
// ceiling. The ring read at column w - s_f (the lattice shifts are 0, 1 and
// a slab axis's length, all >= 0) lands in this tile or in a lower one:
//   - in this tile: the previous level's solution tile in shared memory;
//   - in tile t - 1 ... t - ceil(s_max / Wt): the halo, read back from ys of
//     the previous level in device memory. ys holds each level's solution in
//     the state type, which is the ring's value in every type: the solution
//     itself in f32 and f64, and in bf16 __float2bfloat16 of the f32
//     solution, the rounding the ring operand takes (op_round). Each level
//     has its own slab of ys, so a read never races a later write, and ys is
//     zero outside a level's window, which is what a ring read there must
//     see.
// Per (g, k, b, tile) a flag in a scratch tensor counts the levels whose ys
// the tile has stored (a release store after them); a tile waits, with an
// acquire load, only on the lower tiles its halo reads. Each CTA first takes
// a ticket from a counter in the same scratch and runs the tile the ticket
// names (t fastest), so it waits only on CTAs that started before it and are
// resident or done, however many fit the card: no deadlock (the decoupled
// look-back argument). The wrapper zeroes the scratch before every launch.
//
// Warp roles, a level's loads in flight (after lattice_ring.cu):
//   - 8 consumer warps run the product (W x J) @ (J x D) on the tensor cores.
//     Each owns whole 16-row m-tiles of the window across its share of D's
//     8-column n-tiles (MPW m-tiles and NT / NSPLIT n-tiles a warp, so every
//     warp has work at every shape). Face 0, B rhs, does not read the ring
//     and runs before the wait for the halo; the nf ring faces after it.
//     f32 keeps the factor's b0, b1 unsplit in shared memory and splits them
//     into TF32 hi and lo by truncation at each use (the split factor is
//     131 KB at D = 64, which the halo's second buffer needs).
//   - 3 "in" warps (4 in f64) load level l + 2's operands (v, ttc, bsrc,
//     dsrc, cin, the closure rows) into the rhs and inflow tiles of its
//     parity while the consumers multiply level l + 1: 16-byte loads of 4
//     (f64: 2) neighbouring columns where W allows, a column group's rows
//     with no condition inside.
//   - 2 halo warps load level l's halo (lower tiles' ys, through L2, 16
//     bytes at a time where aligned) as soon as those tiles' flags say it
//     is stored, into the halo buffer of level l + 1's parity.
//   - the 3 (f64: 2) "out" warps stream level l out of its solution tile:
//     ys (zeros outside the window), then the flag, then the ms band sum by
//     atomics (16-byte float4 atomics where the toolkit has them).
// The rhs, inflow, solution and (where they fit) halo tiles are
// double-buffered by level parity; named barriers hand each buffer between
// roles. The factor block stays in shared memory in mma fragment order for
// all L levels. Rows of a tile that a level does not compute keep an earlier
// level's finite solution; the next level reads them only where its inflow
// coefficient is zero (the windows' contract), so the windowed results equal
// the full slab's (ys bit for bit, ms up to the order of its atomics), and a
// column's sum runs in one fixed order whatever the window.
//
// Shared memory, f32 at D = 64 and Wt = 64 (three faces, shifts 0, 1, n):
// the factor 4 x 8 k-steps x 8 n-tiles x 32 lanes x 8 B = 65,536 B, two
// solution and two rhs tiles of 64 x 72 x 4 B, two halo tiles (the faces'
// halo columns side by side, a tile more where they do not fit one row
// stride) and the inflow tiles: 177,680 B, one CTA (16 warps) per SM.
//
// What bounds it on an H100 SXM (ops/lattice_ring.py::sweep_bound_ms, with
// the lattice's hull windows): at hex 16^3 p = 3 (D = 64, W = 256, the
// p3_f32 row's bucket) the product, 0.92 ms as 3xTF32 (f64 2.27 ms on the
// FP64 tensor cores), bf16 its bytes, 0.39 ms; at the wide hex 24^3 p = 2's
// last bucket (D = 27, W = 576) the bytes, 1.62 / 0.84 / 3.25 ms (f32, bf16,
// f64). Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6): p = 3
// 7.20 / 5.28 / 11.40 ms, wide 13.51 / 12.00 / 23.31 ms (0.07-0.20 of the
// bound), against 12.14 / 7.86 / 23.52 and 21.48 / 19.94 / 24.84 ms for the
// earlier cluster design it replaces (a cluster of up to 16 CTAs held a level,
// the ring read through distributed shared memory, one role per warp, one
// cluster barrier a level). Without the product the p = 3 f32 launch takes
// 5.81 ms and without the operand loads 6.48: neither side alone sets its
// pace, but the per-level hand-offs between the roles and the tiles; in
// bf16 the operand loads do (2.60 ms without them). Measured slower and not
// kept: the halo and the operands loaded by one role (9.6 ms at p = 3
// f32), 2 or 7 load warps, scalar loads (14.1 ms), 1 halo warp (f64 1.45x),
// unrolling the vector loads 4 rows deep (spills), scalar ms atomics (bf16
// 1.08x).

#include <type_traits>

#include "lattice_ring_common.cuh"

// float4 atomicAdd on global memory (sm_90, CUDA 12.1 and later) adds the
// ms band sum 16 bytes at a time
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201)
#define PBTE_K1_F4_ATOMICS 1
#else
#define PBTE_K1_F4_ATOMICS 0
#endif

// Measurement variants (bench_k1.py builds them with -D; the default build
// defines none; each gives wrong results and only times what is left):
// PBTE_K1_NO_MS drops the ms atomics, PBTE_K1_NO_YS the ys stores (the
// halo then reads whatever ys held), PBTE_K1_NO_PRODUCT the tensor-core
// product, PBTE_K1_NO_LOADS the in warps' operand loads.

namespace {

// The producer side's 8 warps: the in warps load the operands (3 in f32
// and bf16 state, 4 in f64, whose operands are twice the bytes), 2 halo
// warps load the halo, the rest store the solution
constexpr int kConsumerWarps = 8;
constexpr int kNC = 32 * kConsumerWarps;
constexpr int kThreads = 512;
template <int MODE>
struct Roles {
  static constexpr int IN = MODE == 2 ? 4 : 3;
  static constexpr int HALO = 2;
  static constexpr int OUT = 8 - IN - HALO;
  static constexpr int NIN = 32 * IN, NHALO = 32 * HALO, NOUT = 32 * OUT;
};

// Named barriers (0 is __syncthreads): rhs tile s full / empty, solution
// tile s full / empty, the halo full / empty, and each role's own
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
constexpr int kRhsFull = 1, kRhsEmpty = 3, kSolFull = 5, kSolEmpty = 7,
              kHaloFull = 9, kHaloEmpty = 11, kConsumers = 13, kHaloSync = 14,
              kOutSync = 15;
constexpr size_t kSmemLimit = 232448;  // shared memory a CTA may use

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// state types: 0 f32 (3xTF32), 1 bf16, 2 f64
template <int MODE>
struct Traits;
template <>
struct Traits<0> {
  using State = float;
  using Op = float;  // operands, tiles and sums
  static constexpr int KSTEP = 8;
  static constexpr int BFRAG_BYTES = 8;  // b0, b1 in f32, split at each use
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
  // a consumer warp runs NT / NSPLIT n-tiles of MPW m-tiles; the 8 warps
  // form NSPLIT x MGROUPS, so a tile holds WT_MAX columns at most. D = 64
  // splits its n-tiles so that a tile narrow enough for the factor's shared
  // memory still keeps every warp busy (f32 64 columns, f64 32)
  static constexpr int NSPLIT = D == 64 ? (MODE == 0 ? 2 : MODE == 2 ? 4 : 1)
                                        : 1;
  static constexpr int NCH = NT / NSPLIT;
  static constexpr int MGROUPS = kConsumerWarps / NSPLIT;
  static constexpr int MPW = (D == 64 || (D == 27 && MODE == 2)) ? 1 : 2;
  static constexpr int WT_MAX = 16 * MPW * MGROUPS;
  static_assert(NT % NSPLIT == 0, "n-tiles split evenly");
};

template <int MODE>
__host__ __device__ constexpr int row_stride(int Wt) {
  return MODE == 2 ? f64_tile_stride(Wt) : tile_stride(Wt);
}

// The halo: face f (shift s_f > 0) reads min(s_f, Wt) columns of lower
// tiles, local columns [0, min(s_f, Wt)). Faces sit side by side in rows of
// the tile's stride, each at a column that is a multiple of 4, a new block of
// D rows where the next does not fit. A launch of one tile needs none.
// Returns the blocks; blk[f] / col[f] place face f (blk[f] = -1: no halo).
__host__ __device__ inline int halo_layout(int Wt, int C, int nf, int WP,
                                           const int* s, int* blk,
                                           int* col) {
  int b = 0, c = 0, placed = 0;
  for (int f = 0; f < kMaxFaces; ++f) {
    blk[f] = -1;
    col[f] = 0;
    const int hw = f < nf && C > 1 ? (s[f] < Wt ? s[f] : Wt) : 0;
    if (hw <= 0) continue;
    if (c + hw > WP) {
      ++b;
      c = 0;
    }
    blk[f] = b;
    col[f] = c;
    c = (c + hw + 3) / 4 * 4;
    placed = 1;
  }
  return placed ? b + 1 : 0;
}

// Shared-memory carve-up (byte offsets), the same on host and device: the
// factor in fragment order, two solution tiles and two rhs tiles (level
// parity), the halo blocks (two sets, by level parity, where they fit; else
// one), two tiles of shifted inflow coefficients, and the CTA's ticket
template <int D, int MODE>
struct SmemTiled {
  size_t bfrag, sol, rhs, halo, cinc, misc, tile, cin_tile, total;
  int nh, hb, hblk[kMaxFaces], hcol[kMaxFaces];
  __host__ __device__ SmemTiled(int Wt, int C, int nf, const int* s) {
    using G = TGeo<D, MODE>;
    using Op = typename Traits<MODE>::Op;
    const int WP = row_stride<MODE>(Wt);
    tile = align16(sizeof(Op) * D * WP);
    cin_tile = align16(sizeof(Op) * nf * cin_stride(Wt));
    nh = halo_layout(Wt, C, nf, WP, s, hblk, hcol);
    bfrag = 0;
    sol = align16(static_cast<size_t>(1 + nf) * G::KT_FACE * G::NT * 32 *
                  Traits<MODE>::BFRAG_BYTES);
    rhs = sol + 2 * tile;
    halo = rhs + 2 * tile;
    hb = nh > 0 && halo + 2 * nh * tile + 2 * cin_tile + 16 <= kSmemLimit ? 2
                                                                         : 1;
    cinc = halo + hb * nh * tile;
    misc = cinc + 2 * cin_tile;
    total = misc + 16;
  }
};

// V values of ys through L2 only (ld.global.cg): the halo reads ys that
// other CTAs stored during this launch, which the non-coherent path may
// hold stale
template <int V>
__device__ __forceinline__ void ldcg_v(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else {
    o[0] = __ldcg(p);
  }
}
template <int V>
__device__ __forceinline__ void ldcg_v(const double* p, double (&o)[V]) {
  if constexpr (V == 2) {
    const double2 t = __ldcg(reinterpret_cast<const double2*>(p));
    o[0] = t.x;
    o[1] = t.y;
  } else {
    o[0] = __ldcg(p);
  }
}
template <int V>
__device__ __forceinline__ void ldcg_v(const __nv_bfloat16* p,
                                       float (&o)[V]) {
  if constexpr (V == 4) {
    const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  } else {
    o[0] = __bfloat162float(__ushort_as_bfloat16(
        __ldcg(reinterpret_cast<const unsigned short*>(p))));
  }
}

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

// product-operand rounding of the state type: bf16 in cast mode, else none
template <bool CAST, typename Op>
__device__ __forceinline__ Op round_op(Op x) {
  if constexpr (CAST) {
    return op_round<true>(x);
  } else {
    return x;
  }
}

// V neighbouring columns at once: 16-byte loads and stores where the slab
// width allows (4 floats, 2 doubles; bf16 state 4 values in 8 bytes), one
// value otherwise. ldg_v reads read-only inputs, lds_v / sts_v shared
// memory, stg_v writes ys (bf16: rounded to nearest even).
template <int V>
struct Width {
  static constexpr int value = V;
};
__device__ __forceinline__ void ldg_v(const float* p, float (&o)[1]) {
  o[0] = __ldg(p);
}
__device__ __forceinline__ void ldg_v(const float* p, float (&o)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ __forceinline__ void ldg_v(const double* p, double (&o)[1]) {
  o[0] = __ldg(p);
}
__device__ __forceinline__ void ldg_v(const double* p, double (&o)[2]) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = t.x;
  o[1] = t.y;
}
__device__ __forceinline__ void ldg_v(const __nv_bfloat16* p, float (&o)[1]) {
  o[0] = __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void ldg_v(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}
template <typename T, int V>
__device__ __forceinline__ void lds_v(const T* p, T (&o)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    using Q = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    const Q t = *reinterpret_cast<const Q*>(p);
    static_assert(sizeof(Q) == 16, "16-byte vector");
    memcpy(o, &t, 16);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) o[q] = p[q];
  }
}
template <typename T, int V>
__device__ __forceinline__ void sts_v(T* p, const T (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    using Q = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    Q t;
    memcpy(&t, x, 16);
    *reinterpret_cast<Q*>(p) = t;
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = x[q];
  }
}
template <int V>
__device__ __forceinline__ void stg_v(float* p, const float (&x)[V]) {
  sts_v(p, x);
}
template <int V>
__device__ __forceinline__ void stg_v(double* p, const double (&x)[V]) {
  sts_v(p, x);
}
template <int V>
__device__ __forceinline__ void stg_v(__nv_bfloat16* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = __float2bfloat16(x[q]);
  }
}

// Thread p of n over the columns [lo, hi) and all D rows, neighbouring
// threads on neighbouring columns: body(c, j0, R) runs rows j0, j0 + R, ...
// of column c (R rows per pass where the columns are fewer than the
// threads)
template <class F>
__device__ __forceinline__ void for_columns(int p, int n, int lo, int hi,
                                            F&& body) {
  const int w = hi - lo;
  if (w <= 0) return;
  if (w <= n) {
    const int R = n / w;
    const int j0 = p / w;
    if (j0 < R) body(lo + p - j0 * w, j0, R);
  } else {
    for (int c = lo + p; c < hi; c += n) body(c, 0, 1);
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
    const int* __restrict__ win, typename Traits<MODE>::State* ys,
    typename Traits<MODE>::Op* __restrict__ ms, int* scratch, int L, int Gb,
    int Km, int BS, int W, int nf, Shifts sh, int Wt, int C) {
  using T = Traits<MODE>;
  using State = typename T::State;
  using Op = typename T::Op;
  using G = TGeo<D, MODE>;
  constexpr bool CAST = MODE == 1;
  constexpr int NT = G::NT;
  constexpr int KT_FACE = G::KT_FACE;
  constexpr int MPW = G::MPW;
  constexpr int NCH = G::NCH;
  constexpr int kInWarps = Roles<MODE>::IN, kHaloWarps = Roles<MODE>::HALO;
  constexpr int kNIn = Roles<MODE>::NIN, kNHalo = Roles<MODE>::NHALO,
                kNOut = Roles<MODE>::NOUT;
  constexpr int kInPair = kNC + kNIn;      // consumers with the in warps
  constexpr int kHaloPair = kNC + kNHalo;  // with the halo warps
  constexpr int kOutPair = kNC + kNOut;    // with the out warps

  const int WP = row_stride<MODE>(Wt);
  const int WC = cin_stride(Wt);
  const int J = (1 + nf) * D;
  const int shv[kMaxFaces] = {sh.s[0], sh.s[1], sh.s[2]};
  const SmemTiled<D, MODE> lay(Wt, C, nf, shv);

  extern __shared__ __align__(16) unsigned char smem[];
  Op* S = reinterpret_cast<Op*>(smem);  // the offsets below count Op's
  const int tile_n = static_cast<int>(lay.tile / sizeof(Op));
  const int sol_o = static_cast<int>(lay.sol / sizeof(Op));
  const int rhs_o = static_cast<int>(lay.rhs / sizeof(Op));
  const int cinc_o = static_cast<int>(lay.cinc / sizeof(Op));
  const int cin_n = static_cast<int>(lay.cin_tile / sizeof(Op));
  int* s_ticket = reinterpret_cast<int*>(smem + lay.misc);

  const int tid = threadIdx.x;
  if (tid == 0) *s_ticket = atomicAdd(scratch, 1);
  __syncthreads();
  // the tile this CTA runs: tickets in launch order, t fastest
  const int ticket = *s_ticket;
  const int gkb = ticket / C;
  const int t = ticket - gkb * C;
  const int b = gkb % BS;
  const int gk = gkb / BS;  // g * Km + k
  const int g = gk / Km;
  const int k = gk % Km;
  const int c0 = t * Wt;        // this tile's first slab column
  const int Wl = min(Wt, W - c0);  // its columns (>= 1: C = ceil(W / Wt))
  const size_t DW = static_cast<size_t>(D) * W;
  int* flags = scratch + 1 + static_cast<size_t>(gkb) * C;
  const bool has_halo = t > 0 && lay.nh > 0;
  // halo offset of each face (-1: none), and the lowest tile it reads
  int hoff[kMaxFaces];
  int s_max = 0;
#pragma unroll
  for (int f = 0; f < kMaxFaces; ++f) {
    hoff[f] = lay.hblk[f] >= 0
                  ? static_cast<int>(lay.halo / sizeof(Op)) +
                        lay.hblk[f] * tile_n + lay.hcol[f]
                  : -1;
    if (f < nf) s_max = max(s_max, sh.s[f]);
  }

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
      const int tt = ln & 3;
      if constexpr (MODE == 0) {
        const int k0 = kt * 8 + tt;
        reinterpret_cast<float2*>(smem + lay.bfrag)[idx] =
            make_float2(bval(k0, n), bval(k0 + 4, n));
      } else if constexpr (MODE == 1) {
        const int k0 = kt * 16 + 2 * tt;
        uint2 f;
        f.x = pack_bf16(bval(k0, n), bval(k0 + 1, n));
        f.y = pack_bf16(bval(k0 + 8, n), bval(k0 + 9, n));
        reinterpret_cast<uint2*>(smem + lay.bfrag)[idx] = f;
      } else {
        reinterpret_cast<double*>(smem + lay.bfrag)[idx] = bval(kt * 4 + tt, n);
      }
    }
  }
  // every tile zero: the solution tiles (level 0's ring), the rhs tiles,
  // the halo and the inflow tiles (no pass writes their padding)
  for (int i = tid; i < static_cast<int>((lay.misc - lay.sol) / sizeof(Op));
       i += kThreads) {
    S[sol_o + i] = Op(0);
  }
  __syncthreads();

  // level l's window as this tile's local columns [a, e), and the columns
  // [ta, te) of its 16-row m-tiles (empty where the tile has none)
  auto tile_window = [&](int l, int& a, int& e, int& ta, int& te) {
    const int2 wl = win != nullptr ? make_int2(__ldg(win + 2 * l),
                                               __ldg(win + 2 * l + 1))
                                   : make_int2(0, W);
    a = min(max(wl.x - c0, 0), Wl);
    e = min(max(wl.y - c0, 0), Wl);
    if (e <= a) a = e = 0;
    ta = a & ~15;
    te = (e + 15) & ~15;
  };

  const int warp = tid >> 5;
  // 16-byte columns groups where the slab width allows (W a multiple of the
  // vector width: every row, tile and m-tile then starts aligned)
  constexpr int VW = MODE == 2 ? 2 : 4;
  const bool vec = W % VW == 0;
  const int HB = lay.hb;  // halo buffers: level l reads buffer l % HB
  const int hstep = lay.nh * tile_n;

  if (warp >= kConsumerWarps + kInWarps + kHaloWarps) {
    // ---- out warps: level l's solution out as ys, the flag, then ms ----
    const int p = tid - kNC - kNIn - kNHalo;
    const Op mw = macro_w[static_cast<size_t>(gk) * BS + b];
    // ys of the tile's columns in groups of V (zeros outside the window)
    auto store_ys = [&](auto width, const Op* sol, State* ys_l, int a,
                        int e) {
      constexpr int V = decltype(width)::value;
      for_columns(p, kNOut, 0, Wl / V, [&](int cg, int j0, int R) {
        const int c = cg * V;
        bool inw[V];
#pragma unroll
        for (int q = 0; q < V; ++q) inw[q] = c + q >= a && c + q < e;
#pragma unroll 4
        for (int j = j0; j < D; j += R) {
          Op x[V];
          lds_v(sol + j * WP + c, x);
#pragma unroll
          for (int q = 0; q < V; ++q) x[q] = inw[q] ? x[q] : Op(0);
          stg_v(ys_l + static_cast<size_t>(j) * W + c, x);
        }
      });
    };
    for (int l = 0; l < L; ++l) {
      const int s = l & 1;
      const Op* sol = S + sol_o + s * tile_n;
      int a, e, ta, te;
      tile_window(l, a, e, ta, te);
      const size_t lgk = (static_cast<size_t>(l) * Gb + g) * Km + k;
      bar_sync(kSolFull + s, kOutPair);
#ifndef PBTE_K1_NO_YS
      State* ys_l = ys + (lgk * BS + b) * DW + c0;
      if (vec) {
        store_ys(Width<VW>{}, sol, ys_l, a, e);
      } else {
        store_ys(Width<1>{}, sol, ys_l, a, e);
      }
#endif
      // every out thread's ys of level l is stored: release it to the
      // tiles above
      bar_sync(kOutSync, kNOut);
      if (p == 0) {
        __threadfence();
        st_release(flags + t, l + 1);
      }
#ifndef PBTE_K1_NO_MS
      Op* ms_l = ms + (static_cast<size_t>(gk) * L + l) * DW + c0;
#if PBTE_K1_F4_ATOMICS
      if (MODE != 2 && vec && e > a) {
        // 16-byte atomics over the window's groups of 4 columns, zeros
        // added for the group's columns outside it
        for_columns(p, kNOut, a / 4, (e + 3) / 4, [&](int cg, int j0,
                                                      int R) {
          const int c = cg * 4;
          bool inw[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) inw[q] = c + q >= a && c + q < e;
#pragma unroll 4
          for (int j = j0; j < D; j += R) {
            float x[4];
            lds_v(reinterpret_cast<const float*>(sol) + j * WP + c, x);
            atomicAdd(reinterpret_cast<float4*>(ms_l + static_cast<size_t>(j) * W +
                                                c),
                      make_float4(inw[0] ? mw * x[0] : 0.f,
                                  inw[1] ? mw * x[1] : 0.f,
                                  inw[2] ? mw * x[2] : 0.f,
                                  inw[3] ? mw * x[3] : 0.f));
          }
        });
      } else
#endif
      {
        for_columns(p, kNOut, a, e, [&](int c, int j0, int R) {
#pragma unroll 4
          for (int j = j0; j < D; j += R) {
            atomicAdd(ms_l + static_cast<size_t>(j) * W + c,
                      mw * sol[j * WP + c]);
          }
        });
      }
#endif
      if (l + 2 < L) bar_arrive(kSolEmpty + s, kOutPair);
    }
    return;
  }

  if (warp >= kConsumerWarps && warp < kConsumerWarps + kInWarps) {
    // ---- in warps: level l + 2's rhs and inflow tiles, level l's halo ----
    const int p = tid - kNC;
    const Op w_src = wvec[b];
    const Op w_rel = wvec[BS + b];
    const Op w_bcv = wvec[2 * BS + b];
    const Op w_dir = wvec[3 * BS + b];

    // rhs and shifted inflow coefficients of level l's window m-tiles into
    // the tiles of parity l & 1, V columns at a time; a column of those
    // m-tiles outside the window gets zeros by a select (its loads read the
    // padding, zero by the windows' contract)
    auto prep_cols = [&](auto width, int l, int a, int e, int ta, int hi) {
      constexpr int V = decltype(width)::value;
      // rows in flight a thread: 3 loads of V values each
      constexpr int UNROLL = V == 1 ? 4 : 2;
      Op* rhs = S + rhs_o + (l & 1) * tile_n;
      Op* cinc = S + cinc_o + (l & 1) * cin_n;
      const size_t lg = static_cast<size_t>(l) * Gb + g;
      const size_t lgk = lg * Km + k;
      const State* v_l = v + (lgk * BS + b) * DW + c0;
      const Op* ttc_l = ttc + lg * DW + c0;
      const Op* bsrc_l = bsrc + lgk * DW + c0;
      const Op* dsrc_l = dsrc != nullptr ? dsrc + lgk * DW + c0 : nullptr;
      for_columns(p, kNIn, ta / V, hi / V, [&](int cg, int j0, int R) {
        const int c = cg * V;
        const int w = c0 + c;
        bool inw[V];
#pragma unroll
        for (int q = 0; q < V; ++q) inw[q] = c + q >= a && c + q < e;
        if (j0 == 0) {
#pragma unroll
          for (int f = 0; f < kMaxFaces; ++f) {
            if (f < nf) {
              Op x[V];
              ldg_v(cin + (lgk * nf + f) * W + w, x);
#pragma unroll
              for (int q = 0; q < V; ++q) {
                x[q] = inw[q] && w + q >= sh.s[f] ? round_op<CAST>(x[q])
                                                  : Op(0);
              }
              sts_v(cinc + f * WC + c, x);
            }
          }
        }
        const Op* xv[V];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          xv[q] = nullptr;
          if (xmap != nullptr && inw[q]) {
            const int u = __ldg(xmap + lg * W + w + q);
            if (u >= 0) {
              xv[q] = xval +
                      ((static_cast<size_t>(g) * n_u + u) * Km + k) * BS * D +
                      static_cast<size_t>(b) * D;
            }
          }
        }
#pragma unroll UNROLL
        for (int j = j0; j < D; j += R) {
          // each product and sum rounded on its own, as the plain version
          // computes them (no fused multiply-add): in cast mode an f32 rhs
          // one ulp off would round to the other bf16 value now and then,
          // and the recurrence carries such flips on
          const size_t o = static_cast<size_t>(j) * W + c;
          Op tv[V], bv[V], vv[V], dv[V], x[V];
          ldg_v(ttc_l + o, tv);
          ldg_v(bsrc_l + o, bv);
          ldg_v(v_l + o, vv);
          if (dsrc_l != nullptr) ldg_v(dsrc_l + o, dv);
#pragma unroll
          for (int q = 0; q < V; ++q) {
            x[q] = rsub(radd(rmul(w_src, tv[q]), rmul(w_rel, vv[q])),
                        rmul(w_bcv, bv[q]));
            if (dsrc_l != nullptr) x[q] = rsub(x[q], rmul(w_dir, dv[q]));
            if (xv[q] != nullptr) x[q] = radd(x[q], __ldg(xv[q] + j));
            x[q] = inw[q] ? round_op<CAST>(x[q]) : Op(0);
          }
          sts_v(rhs + j * WP + c, x);
        }
      });
    };
    auto prep = [&](int l) {
      int a, e, ta, te;
      tile_window(l, a, e, ta, te);
#ifndef PBTE_K1_NO_LOADS
      if (vec) {
        prep_cols(Width<VW>{}, l, a, e, ta, min(te, Wl));
      } else {
        prep_cols(Width<1>{}, l, a, e, ta, min(te, Wl));
      }
#endif
    };
    prep(0);
    bar_arrive(kRhsFull + 0, kInPair);
    if (L > 1) {
      prep(1);
      bar_arrive(kRhsFull + 1, kInPair);
    }
    for (int l = 0; l + 2 < L; ++l) {
      bar_sync(kRhsEmpty + (l & 1), kInPair);
      prep(l + 2);
      bar_arrive(kRhsFull + (l & 1), kInPair);
    }
    return;
  }

  if (warp >= kConsumerWarps + kInWarps) {
    // ---- halo warps: level l's halo, for the consumers' level l + 1 ----
    if (!has_halo) return;
    const int p = tid - kNC - kNIn;
    // the halo columns [0, hw) of one face, V at a time: ys of slab
    // columns q0 + c (zero left of the slab, where the inflow coefficient
    // is zero too)
    auto halo_cols = [&](auto width, const State* ys_l, Op* h, int q0,
                         int hw) {
      constexpr int V = decltype(width)::value;
      for_columns(p, kNHalo, 0, hw / V, [&](int cg, int j0, int R) {
        const int c = cg * V;
        const int q = q0 + c;
        const State* col = ys_l + max(q, 0);
#pragma unroll 8
        for (int j = j0; j < D; j += R) {
          Op x[V];
          ldcg_v(col + static_cast<size_t>(j) * W, x);
          if (q < 0) x[0] = Op(0);  // V = 1 there
          sts_v(h + j * WP + c, x);
        }
      });
    };
    // ys of level l of the lower tiles into halo buffer hb
    auto load_halo = [&](int l, int hb) {
      const State* ys_l =
          ys + (((static_cast<size_t>(l) * Gb + g) * Km + k) * BS + b) * DW;
#pragma unroll
      for (int f = 0; f < kMaxFaces; ++f) {
        if (hoff[f] < 0) continue;
        Op* h = S + hoff[f] + hb * hstep;
        const int q0 = c0 - sh.s[f];
        const int hw = min(sh.s[f], Wt);
        if (vec && q0 >= 0 && q0 % VW == 0 && hw % VW == 0) {
          halo_cols(Width<VW>{}, ys_l, h, q0, hw);
        } else {
          halo_cols(Width<1>{}, ys_l, h, q0, hw);
        }
      }
    };
    // the lower tiles the halo reads have stored level target - 1
    const int t_lo = max(c0 - s_max, 0) / Wt;
    auto wait_flags = [&](int target) {
      if (p < 32) {
        for (int tt = t_lo + p; tt < t; tt += 32) {
          const long long t0 = clock64();
          while (ld_acquire(flags + tt) < target) {
            __nanosleep(32);
            // no launch waits this long (~17 s): a fault, not a hang
            if (clock64() - t0 > (1ll << 35)) __trap();
          }
        }
        __threadfence();
      }
      bar_sync(kHaloSync, kNHalo);
    };

    for (int l = 0; l + 1 < L; ++l) {
      // into the buffer level l + 1 reads, once its reader HB levels
      // before is done
      const int hb = (l + 1) % HB;
      wait_flags(l + 1);
      if (l + 1 >= HB) bar_sync(kHaloEmpty + hb, kHaloPair);
      load_halo(l, hb);
      bar_arrive(kHaloFull + hb, kHaloPair);
    }
    return;
  }

  // ---- consumer warps: each level's product on the tensor cores ----
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment group: rows gq, gq + 8
  const int tq = lane & 3;   // thread in group: k (and n) columns
  const int n0 = (warp % G::NSPLIT) * NCH;  // this warp's first n-tile
  const int mg = warp / G::NSPLIT;          // and m-tile group

  for (int l = 0; l < L; ++l) {
    const int s = l & 1;
    const int rhs_off = rhs_o + s * tile_n;
    const int prev_off = sol_o + (s ^ 1) * tile_n;  // level l-1: the ring
    const int hb = l % HB;  // and the halo left of it
    const int halo_off = hb * hstep;
    const Op* cinc = S + cinc_o + s * cin_n;
    int a, e, ta, te;
    tile_window(l, a, e, ta, te);
    // this warp's m-tiles: mt0 + mg + i MGROUPS < mt0 + nmt
    const int mt0 = ta >> 4;
    const int nmt = (te - ta) >> 4;
    bool on[MPW];
#pragma unroll
    for (int i = 0; i < MPW; ++i) on[i] = mg + i * G::MGROUPS < nmt;
    bar_sync(kRhsFull + s, kInPair);

    // acc[w, i] = sum_kk A[w, kk] B[kk, i] over the face blocks (face 0:
    // the rhs tile; face f >= 1: the ring, shifted and scaled)
    Op acc[MPW][NCH][4];
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
      for (int n = 0; n < NCH; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][n][q] = Op(0);

#pragma unroll
    for (int f = 0; f <= kMaxFaces; ++f) {
      if (f > nf) break;
      // face 0 ran while the halo was on its way; the ring faces need it
      if (f == 1 && has_halo && l > 0) bar_sync(kHaloFull + hb, kHaloPair);
#ifndef PBTE_K1_NO_PRODUCT
      if (nmt == 0) continue;
      // this lane's two A rows of each m-tile (local columns c): the rhs
      // tile, or the ring row they read (this tile's previous solution, or
      // the halo left of it) and its inflow coefficient
      int off[MPW][2];
      Op cf[MPW][2];
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = (mt0 + mg + i * G::MGROUPS) * 16 + gq + 8 * h;
          if (f == 0) {
            off[i][h] = rhs_off + c;
            cf[i][h] = Op(1);
          } else {
            const int sf = sh.s[f - 1];
            cf[i][h] = cinc[(f - 1) * WC + (c < WC ? c : WC - 1)];
            // left of the tile: the halo (tile 0: a zero coefficient)
            off[i][h] = c >= sf ? prev_off + c - sf
                                : (has_halo ? halo_off + hoff[f - 1] + c
                                            : prev_off);
          }
        }
      }
#pragma unroll
      for (int kt = 0; kt < KT_FACE; ++kt) {
        const int kt_all = f * KT_FACE + kt;
        if constexpr (MODE == 0) {
          const int j0 = kt * 8 + tq;
          const int jr0 = (j0 < D ? j0 : D - 1) * WP;
          const int jr1 = (j0 + 4 < D ? j0 + 4 : D - 1) * WP;
          uint32_t hi[MPW][4], lo[MPW][4];
#pragma unroll
          for (int i = 0; i < MPW; ++i) {
            if (!on[i]) continue;
            // a0 (row gq, k t), a1 (gq+8, t), a2 (gq, t+4), a3 (gq+8, t+4)
            float x[4] = {S[off[i][0] + jr0], S[off[i][1] + jr0],
                          S[off[i][0] + jr1], S[off[i][1] + jr1]};
            if (f > 0) {
              x[0] *= cf[i][0];
              x[1] *= cf[i][1];
              x[2] *= cf[i][0];
              x[3] *= cf[i][1];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(x[q], hi[i][q], lo[i][q]);
          }
#pragma unroll
          for (int n = 0; n < NCH; ++n) {
            // the factor's b0, b1 split into TF32 hi and lo here, by
            // truncation as the A operand is: the split factor would take
            // twice the shared memory (131 KB at D = 64), which the halo's
            // second buffer needs, and rounding both parts to nearest here
            // made the p = 3 f32 launch 1.35x slower on an H100 for no
            // measurable gain in its error against the plain version
            // (PERF.md)
            const float2 bq = reinterpret_cast<const float2*>(
                smem + lay.bfrag)[(kt_all * NT + n0 + n) * 32 + lane];
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bq.x, bh0, bl0);
            split_tf32(bq.y, bh1, bl1);
#pragma unroll
            for (int i = 0; i < MPW; ++i) {
              if (!on[i]) continue;
              // small terms first
              mma_tf32(acc[i][n], lo[i], bh0, bh1);
              mma_tf32(acc[i][n], hi[i], bl0, bl1);
              mma_tf32(acc[i][n], hi[i], bh0, bh1);
            }
          }
        } else if constexpr (MODE == 1) {
          int jr[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = kt * 16 + 2 * tq + (q & 1) + 8 * (q >> 1);
            jr[q] = (j < D ? j : D - 1) * WP;
          }
          uint32_t am[MPW][4];
#pragma unroll
          for (int i = 0; i < MPW; ++i) {
            if (!on[i]) continue;
            float x[2][4];  // [row half][k: 2t, 2t+1, 2t+8, 2t+9]
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float r = S[off[i][h] + jr[q]];
                x[h][q] = f == 0 ? r
                                 : op_round<true>(cf[i][h] * op_round<true>(r));
              }
            am[i][0] = pack_bf16(x[0][0], x[0][1]);
            am[i][1] = pack_bf16(x[1][0], x[1][1]);
            am[i][2] = pack_bf16(x[0][2], x[0][3]);
            am[i][3] = pack_bf16(x[1][2], x[1][3]);
          }
#pragma unroll
          for (int n = 0; n < NCH; ++n) {
            const uint2 bq = reinterpret_cast<const uint2*>(
                smem + lay.bfrag)[(kt_all * NT + n0 + n) * 32 + lane];
#pragma unroll
            for (int i = 0; i < MPW; ++i) {
              if (on[i]) mma_bf16(acc[i][n], am[i], bq.x, bq.y);
            }
          }
        } else {
          const int j = kt * 4 + tq;  // the tile row of this lane's k column
          const int jr = (j < D ? j : D - 1) * WP;
          double am[MPW][2];
#pragma unroll
          for (int i = 0; i < MPW; ++i) {
            if (!on[i]) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const double x = S[off[i][h] + jr];
              am[i][h] = f == 0 ? x : cf[i][h] * x;
            }
          }
#pragma unroll
          for (int n = 0; n < NCH; ++n) {
            const double bq = reinterpret_cast<const double*>(
                smem + lay.bfrag)[(kt_all * NT + n0 + n) * 32 + lane];
#pragma unroll
            for (int i = 0; i < MPW; ++i) {
              if (on[i]) mma_f64(acc[i][n], am[i][0], am[i][1], bq);
            }
          }
        }
      }
#endif
    }
    // the halo, rhs and inflow tiles of this level are free
    if (has_halo && l + HB < L) bar_arrive(kHaloEmpty + hb, kHaloPair);
    if (l + 2 < L) bar_arrive(kRhsEmpty + s, kInPair);
    // the out warps are done with level l-2's solution in tile s
    if (l >= 2) bar_sync(kSolEmpty + s, kOutPair);
    Op* sol = S + sol_o + s * tile_n;
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (!on[i]) continue;
      const int w0 = (mt0 + mg + i * G::MGROUPS) * 16 + gq;
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        const int i0 = (n0 + n) * 8 + 2 * tq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = w0 + 8 * (q >> 1);
          const int r = i0 + (q & 1);
          if (c < Wl && r < D) sol[r * WP + c] = acc[i][n][q];
        }
      }
    }
    bar_arrive(kSolFull + s, kOutPair);
    // every consumer's part of tile s is written before it is read as the
    // next level's ring (and every read of tile s ^ 1 is done)
    bar_sync(kConsumers, kNC);
  }
}

template <int D, int MODE>
size_t tiled_smem_bytes(int Wt, int C, int nf, const int* s) {
  return SmemTiled<D, MODE>(Wt, C, nf, s).total;
}

template <int D, int MODE>
cudaError_t launch_tiled(const void* v, const void* ttc, const void* bsrc,
                         const void* cin, const void* bcat,
                         const void* macro_w, const void* wvec,
                         const void* dsrc, const int* xmap, const void* xval,
                         int n_u, const int* win, void* ys, void* ms,
                         int* scratch, int L, int Gb, int Km, int BS, int W,
                         int nf, Shifts sh, int Wt, int C,
                         cudaStream_t stream) {
  using State = typename Traits<MODE>::State;
  using Op = typename Traits<MODE>::Op;
  if (Wt > TGeo<D, MODE>::WT_MAX) return cudaErrorInvalidValue;
  const size_t smem = tiled_smem_bytes<D, MODE>(Wt, C, nf, sh.s);
  auto kernel = lattice_ring_tiled_kernel<D, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long grid = static_cast<long long>(Gb) * Km * BS * C;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const State*>(v), static_cast<const Op*>(ttc),
      static_cast<const Op*>(bsrc), static_cast<const Op*>(cin),
      static_cast<const Op*>(bcat), static_cast<const Op*>(macro_w),
      static_cast<const Op*>(wvec), static_cast<const Op*>(dsrc), xmap,
      static_cast<const Op*>(xval), n_u, win, static_cast<State*>(ys),
      static_cast<Op*>(ms), scratch, L, Gb, Km, BS, W, nf, sh, Wt, C);
  return cudaGetLastError();
}

// element DOF counts the tiled kernel is instantiated for: quad p = 1-3
// (4, 9, 16) and hex p = 1-3 (8, 27, 64)
#define PBTE_K1_TILED_D(X) X(4) X(8) X(9) X(16) X(27) X(64)

template <int MODE>
cudaError_t dispatch_tiled(int D, const void* v, const void* ttc,
                           const void* bsrc, const void* cin,
                           const void* bcat, const void* macro_w,
                           const void* wvec, const void* dsrc,
                           const int* xmap, const void* xval, int n_u,
                           const int* win, void* ys, void* ms, int* scratch,
                           int L, int Gb, int Km, int BS, int W, int nf,
                           Shifts sh, int Wt, int C, cudaStream_t stream) {
  switch (D) {
#define PBTE_K1_CASE(d)                                                      \
  case d:                                                                    \
    return launch_tiled<d, MODE>(v, ttc, bsrc, cin, bcat, macro_w, wvec,     \
                                 dsrc, xmap, xval, n_u, win, ys, ms, scratch, \
                                 L, Gb, Km, BS, W, nf, sh, Wt, C, stream);
    PBTE_K1_TILED_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One sweep in C tiles of Wt slab columns, one CTA a tile. mode 0: f32
// state and operands (3xTF32 products); 1: bf16 state, f32 operands, bf16
// product operands and ring; 2: f64 state and operands (ms in float64).
// Pointers and the rest of the contract as pbte_lattice_ring_sweep (ms
// zeroed by the caller, ys written in full); scratch: n_scratch >= 1 + Gb
// Km BS C int32, zeroed by the caller before every launch (the ticket
// counter, then one level flag a tile). Wt must be a multiple of 16, at
// most pbte_lattice_ring_tiled_wt_max, and C = ceil(W / Wt). Returns a
// cudaError_t.
int pbte_lattice_ring_sweep_tiled(int mode, int D, const void* v,
                                  const void* ttc, const void* bsrc,
                                  const void* cin, const void* bcat,
                                  const void* macro_w, const void* wvec,
                                  const void* dsrc, const int* xmap,
                                  const void* xval, int n_u, const int* win,
                                  void* ys, void* ms, int* scratch,
                                  long long n_scratch, int L, int Gb, int Km,
                                  int BS, int W, int nf, int s0, int s1,
                                  int s2, int Wt, int C, void* stream) {
  const Shifts sh{{s0, s1, s2}};
  bool ok = nf >= 1 && nf <= kMaxFaces && W >= 1 && L >= 1 && Wt >= 16 &&
            Wt % 16 == 0 && C >= 1 && (C - 1) * Wt < W && C * Wt >= W &&
            scratch != nullptr &&
            n_scratch >= 1 + static_cast<long long>(Gb) * Km * BS * C;
  for (int f = 0; f < nf && f < kMaxFaces; ++f) {
    ok = ok && sh.s[f] >= 0 && sh.s[f] < W;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case 0:
      err = dispatch_tiled<0>(D, v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
                              xmap, xval, n_u, win, ys, ms, scratch, L, Gb,
                              Km, BS, W, nf, sh, Wt, C, st);
      break;
    case 1:
      err = dispatch_tiled<1>(D, v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
                              xmap, xval, n_u, win, ys, ms, scratch, L, Gb,
                              Km, BS, W, nf, sh, Wt, C, st);
      break;
    case 2:
      err = dispatch_tiled<2>(D, v, ttc, bsrc, cin, bcat, macro_w, wvec, dsrc,
                              xmap, xval, n_u, win, ys, ms, scratch, L, Gb,
                              Km, BS, W, nf, sh, Wt, C, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one CTA of a launch (the wrapper's check).
long long pbte_lattice_ring_tiled_smem_bytes(int mode, int D, int Wt, int C,
                                             int nf, int s0, int s1, int s2) {
  const int s[kMaxFaces] = {s0, s1, s2};
  switch (D) {
#define PBTE_K1_CASE(d)                                                    \
  case d:                                                                  \
    return mode == 0   ? static_cast<long long>(                           \
                           tiled_smem_bytes<d, 0>(Wt, C, nf, s))           \
           : mode == 1 ? static_cast<long long>(                           \
                             tiled_smem_bytes<d, 1>(Wt, C, nf, s))         \
                       : static_cast<long long>(                           \
                             tiled_smem_bytes<d, 2>(Wt, C, nf, s));
    PBTE_K1_TILED_D(PBTE_K1_CASE)
#undef PBTE_K1_CASE
    default:
      return -1;
  }
}

// The widest tile an instantiation takes (the wrapper's table).
int pbte_lattice_ring_tiled_wt_max(int mode, int D) {
  switch (D) {
#define PBTE_K1_CASE(d)                                          \
  case d:                                                        \
    return mode == 0   ? TGeo<d, 0>::WT_MAX                      \
           : mode == 1 ? TGeo<d, 1>::WT_MAX                      \
                       : TGeo<d, 2>::WT_MAX;
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
