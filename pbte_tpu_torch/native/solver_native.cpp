// Native C++ source-iteration sweep solver — the MEASURED performance
// baseline for bench.py.
//
// This is a faithful re-implementation of the reference's solve algorithm
// (ref: src/PBTESolver.cpp:208-332 serial structure; loop nest ordered like
// the legacy OpenMP variant's collapse over ordinates,
// ref: reference/DGSolver/PBTE_NonGraySMRT.cpp:86-136): for each
// (direction, band), visit elements in the precomputed upwind order, build
// the DOF-sized rhs from lagged Tc, the pseudo-time term, and inflow faces
// (neighbor coupling or isothermal BC), then solve the dense D x D system
// with a cached LU (CachePolicy::FullLU analog) or an on-the-fly
// factorization. Macroscopic Tc accumulates with the same weights as
// MacroscopicQuantities::AccumulateDirectionalCoeff
// (ref: src/MacroscopicQuantities.cpp:104-128).
//
// Built with plain -O3 (no vendor BLAS; the reference uses MFEM's own dense
// LU, also not BLAS-backed). OpenMP pragmas mirror the reference's
// parallelism; on this image's single-core host they run with one thread.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

// in-place LU with partial pivoting; A row-major (n x n)
bool lu_factor(double* A, int32_t* piv, int n) {
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int col = 0; col < n; ++col) {
    int p = col;
    double mx = std::fabs(A[col * n + col]);
    for (int r = col + 1; r < n; ++r) {
      double v = std::fabs(A[r * n + col]);
      if (v > mx) { mx = v; p = r; }
    }
    if (mx == 0.0) return false;
    if (p != col) {
      for (int c = 0; c < n; ++c) std::swap(A[col * n + c], A[p * n + c]);
      std::swap(piv[col], piv[p]);
    }
    const double d = 1.0 / A[col * n + col];
    for (int r = col + 1; r < n; ++r) {
      const double f = A[r * n + col] * d;
      A[r * n + col] = f;
      for (int c = col + 1; c < n; ++c) A[r * n + c] -= f * A[col * n + c];
    }
  }
  return true;
}

void lu_solve(const double* LU, const int32_t* piv, int n, const double* b,
              double* x) {
  for (int i = 0; i < n; ++i) x[i] = b[piv[i]];
  for (int i = 1; i < n; ++i) {
    double s = x[i];
    for (int j = 0; j < i; ++j) s -= LU[i * n + j] * x[j];
    x[i] = s;
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = x[i];
    for (int j = i + 1; j < n; ++j) s -= LU[i * n + j] * x[j];
    x[i] = s / LU[i * n + i];
  }
}

// assemble A = dt_inv*M - vg * sum_d dir_d S_d + vg * sum_f max(fd,0) Mf_f
// (ref: src/PBTESolver.cpp:146-168; half-sum outflow form :550-561)
void assemble_A(int64_t D, int64_t dim, int64_t nf, double dt_inv, double vgb,
                const double* dirk, const double* fd_e, const double* mass_e,
                const double* stiff_e, const double* fmass_e, double* A) {
  const int64_t DD = D * D;
  for (int64_t i = 0; i < DD; ++i) A[i] = dt_inv * mass_e[i];
  for (int64_t d = 0; d < dim; ++d) {
    const double c = -vgb * dirk[d];
    const double* S = stiff_e + d * DD;
    for (int64_t i = 0; i < DD; ++i) A[i] += c * S[i];
  }
  for (int64_t f = 0; f < nf; ++f) {
    const double fd = fd_e[f];
    if (fd > 0.0) {
      const double c = vgb * fd;
      const double* Mf = fmass_e + f * DD;
      for (int64_t i = 0; i < DD; ++i) A[i] += c * Mf[i];
    }
  }
}

}  // namespace

extern "C" {

// One full source-iteration run of n_iter outer iterations.
// Layouts (row-major): u (K, BS, ne, D); Tc (ne, D); all operator tensors as
// documented in fem.assembly.ElementOps. orders (K, ne) upwind visit order.
// fdot (K, ne, nf) = s_k . n_{e,f}.  mw (K, BS) macroscopic weights.
// Returns 0 on success, -1 on singular A, -2 on allocation failure.
// iter_seconds/resid_out must hold n_iter doubles.
int32_t pbte_cpp_source_iteration(
    int64_t ne, int64_t nf, int64_t D, int64_t dim, int64_t K, int64_t BS,
    int64_t n_iter, int32_t use_full_lu, const int32_t* neighbor,
    const int32_t* orders, const double* dirs, const double* fdot,
    const double* mass, const double* stiff, const double* face_mass,
    const double* face_int, const double* coupling, const double* bc_T,
    const double* basis_int, const double* inv_kn, const double* vg,
    const double* heat_cap, const double* mw, double dt_inv, double omega,
    double* u, double* Tc, double* Tv, double* resid_out,
    double* iter_seconds) {
  const int64_t DD = D * D;

  // optional FullLU cache: (K, BS, ne) factorizations
  std::vector<double> lu_cache;
  std::vector<int32_t> piv_cache;
  if (use_full_lu) {
    const size_t need = size_t(K) * BS * ne * DD;
    lu_cache.resize(need);
    piv_cache.resize(size_t(K) * BS * ne * D);
    int32_t factor_fail = 0;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t k = 0; k < K; ++k)
      for (int64_t b = 0; b < BS; ++b) {
        const double vgb = vg[b];
        for (int64_t e = 0; e < ne; ++e) {
          double* A = lu_cache.data() + ((size_t(k) * BS + b) * ne + e) * DD;
          int32_t* pv = piv_cache.data() + ((size_t(k) * BS + b) * ne + e) * D;
          assemble_A(D, dim, nf, dt_inv, vgb, dirs + k * dim,
                     fdot + (k * ne + e) * nf, mass + e * DD,
                     stiff + e * dim * DD, face_mass + e * nf * DD, A);
          if (!lu_factor(A, pv, int(D))) {
#pragma omp atomic write
            factor_fail = 1;
          }
        }
      }
    if (factor_fail) return -1;
  }

  std::vector<double> Tc_prev(size_t(ne) * D);
  std::vector<double> Tv_prev(ne);
  std::memcpy(Tv_prev.data(), Tv, sizeof(double) * ne);

  int n_threads = 1;
#ifdef _OPENMP
  n_threads = omp_get_max_threads();
#endif
  std::vector<double> acc(size_t(n_threads) * ne * D);

  for (int64_t it = 0; it < n_iter; ++it) {
    const double t0 = now_s();
    std::memcpy(Tc_prev.data(), Tc, sizeof(double) * ne * D);
    std::fill(acc.begin(), acc.end(), 0.0);
    int32_t fail = 0;

#pragma omp parallel
    {
      int tid = 0;
#ifdef _OPENMP
      tid = omp_get_thread_num();
#endif
      double* my_acc = acc.data() + size_t(tid) * ne * D;
      std::vector<double> rhs(D), x(D), Awork(DD);
      std::vector<int32_t> pv(D);

#pragma omp for collapse(2) schedule(static)
      for (int64_t k = 0; k < K; ++k)
        for (int64_t b = 0; b < BS; ++b) {
          const double vgb = vg[b];
          const double src_w = inv_kn[b] * heat_cap[b] / omega;
          const double relax_w = dt_inv - inv_kn[b];
          const double bc_w = heat_cap[b] / omega;
          const double mwkb = mw[k * BS + b];
          double* u_kb = u + (size_t(k) * BS + b) * ne * D;
          const int32_t* order_k = orders + k * ne;

          for (int64_t idx = 0; idx < ne; ++idx) {
            const int64_t e = order_k[idx];
            const double* M = mass + e * DD;
            const double* Tc_e = Tc_prev.data() + e * D;
            const double* u_e = u_kb + e * D;
            // rhs = src_w * M^T Tc + relax_w * M^T u_old
            for (int64_t i = 0; i < D; ++i) {
              double s1 = 0.0, s2 = 0.0;
              for (int64_t j = 0; j < D; ++j) {
                const double m_ji = M[j * D + i];
                s1 += m_ji * Tc_e[j];
                s2 += m_ji * u_e[j];
              }
              rhs[i] = src_w * s1 + relax_w * s2;
            }
            // inflow faces: neighbor coupling or isothermal BC
            const double* fd_e = fdot + (k * ne + e) * nf;
            for (int64_t f = 0; f < nf; ++f) {
              const double fd = fd_e[f];
              if (fd >= 0.0) continue;
              const int32_t n = neighbor[e * nf + f];
              if (n >= 0) {
                const double c = -vgb * fd;
                const double* C = coupling + (e * nf + f) * DD;
                const double* u_n = u_kb + size_t(n) * D;
                for (int64_t i = 0; i < D; ++i) {
                  double s = 0.0;
                  for (int64_t j = 0; j < D; ++j) s += C[i * D + j] * u_n[j];
                  rhs[i] += c * s;
                }
              } else {
                const double c = -vgb * fd * bc_w * bc_T[e * nf + f];
                const double* Fi = face_int + (e * nf + f) * D;
                for (int64_t i = 0; i < D; ++i) rhs[i] += c * Fi[i];
              }
            }
            // solve
            if (use_full_lu) {
              const double* LU =
                  lu_cache.data() + ((size_t(k) * BS + b) * ne + e) * DD;
              const int32_t* pvc =
                  piv_cache.data() + ((size_t(k) * BS + b) * ne + e) * D;
              lu_solve(LU, pvc, int(D), rhs.data(), x.data());
            } else {
              assemble_A(D, dim, nf, dt_inv, vgb, dirs + k * dim, fd_e, M,
                         stiff + e * dim * DD, face_mass + e * nf * DD,
                         Awork.data());
              if (!lu_factor(Awork.data(), pv.data(), int(D))) {
#pragma omp atomic write
                fail = 1;
                continue;
              }
              lu_solve(Awork.data(), pv.data(), int(D), rhs.data(), x.data());
            }
            double* u_out = u_kb + e * D;
            double* a_e = my_acc + e * D;
            for (int64_t i = 0; i < D; ++i) {
              u_out[i] = x[i];
              a_e[i] += mwkb * x[i];
            }
          }
        }
    }
    if (fail) return -1;

    // merge thread accumulators -> Tc; Tv; residual
    std::memset(Tc, 0, sizeof(double) * ne * D);
    for (int t = 0; t < n_threads; ++t) {
      const double* a = acc.data() + size_t(t) * ne * D;
      for (int64_t i = 0; i < ne * D; ++i) Tc[i] += a[i];
    }
    double num = 0.0, den = 0.0;
    for (int64_t e = 0; e < ne; ++e) {
      double tv = 0.0;
      for (int64_t i = 0; i < D; ++i) tv += Tc[e * D + i] * basis_int[e * D + i];
      Tv[e] = tv;
      const double d = tv - Tv_prev[e];
      num += d * d;
      den += tv * tv;
      Tv_prev[e] = tv;
    }
    resid_out[it] = den > 0.0 ? std::sqrt(num / den) : INFINITY;
    iter_seconds[it] = now_s() - t0;
  }
  return 0;
}

}  // extern "C"
