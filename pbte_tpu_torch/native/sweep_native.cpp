// Native sweep-planning kernels (host-side setup hot path).
//
// The reference's sweep ordering is C++ (src/AngularSweepOrder.cpp,
// Reference Project/include/SpatialMesh/SpatialMesh.hpp:409-536); this module
// is its TPU-framework equivalent for the host-side scheduler: upwind
// levelization and greedy topological ordering over (directions x elements),
// which dominates setup for production meshes (K ~ hundreds, ne ~ 1e5-1e6).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Build: handled by pbte_tpu.native (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Wavefront levels per direction.
//   neighbor: (ne, nf) int32, -1 = boundary
//   normals:  (ne, nf, dim) float64 outward unit normals
//   dirs:     (K, dim) float64
//   levels:   (K, ne) int32 output
// Returns max level count over all directions, or -1 if a cycle is detected.
int32_t pbte_compute_levels(int64_t ne, int64_t nf, int64_t dim, int64_t K,
                            const int32_t* neighbor, const double* normals,
                            const double* dirs, int32_t* levels) {
  std::vector<int32_t> indeg(ne);
  std::vector<int32_t> queue(ne);
  // downstream adjacency built per direction (CSR over inflow edges reversed)
  std::vector<int32_t> out_off(ne + 1), out_edges(ne * nf);
  int32_t global_max = 0;

  for (int64_t k = 0; k < K; ++k) {
    const double* d = dirs + k * dim;
    int32_t* lvl = levels + k * ne;

    // indegree = number of upwind (inflow) interior faces; also build the
    // reversed edge list (upwind neighbor -> element)
    std::fill(out_off.begin(), out_off.end(), 0);
    for (int64_t e = 0; e < ne; ++e) {
      int32_t deg = 0;
      for (int64_t f = 0; f < nf; ++f) {
        const int32_t nb = neighbor[e * nf + f];
        if (nb < 0) continue;
        const double* n = normals + (e * nf + f) * dim;
        double dot = 0.0;
        for (int64_t c = 0; c < dim; ++c) dot += n[c] * d[c];
        if (dot < 0.0) {
          ++deg;
          ++out_off[nb + 1];  // count edge nb -> e
        }
      }
      indeg[e] = deg;
    }
    for (int64_t e = 0; e < ne; ++e) out_off[e + 1] += out_off[e];
    {
      std::vector<int32_t> cursor(out_off.begin(), out_off.end() - 1);
      for (int64_t e = 0; e < ne; ++e) {
        for (int64_t f = 0; f < nf; ++f) {
          const int32_t nb = neighbor[e * nf + f];
          if (nb < 0) continue;
          const double* n = normals + (e * nf + f) * dim;
          double dot = 0.0;
          for (int64_t c = 0; c < dim; ++c) dot += n[c] * d[c];
          if (dot < 0.0) out_edges[cursor[nb]++] = static_cast<int32_t>(e);
        }
      }
    }

    // Kahn layering
    int64_t head = 0, tail = 0;
    for (int64_t e = 0; e < ne; ++e) {
      lvl[e] = 0;
      if (indeg[e] == 0) queue[tail++] = static_cast<int32_t>(e);
    }
    int32_t kmax = 0;
    while (head < tail) {
      const int32_t e = queue[head++];
      const int32_t le = lvl[e];
      if (le > kmax) kmax = le;
      for (int32_t i = out_off[e]; i < out_off[e + 1]; ++i) {
        const int32_t t = out_edges[i];
        if (lvl[t] < le + 1) lvl[t] = le + 1;
        if (--indeg[t] == 0) queue[tail++] = t;
      }
    }
    if (tail != ne) return -1;  // cycle
    if (kmax + 1 > global_max) global_max = kmax + 1;
  }
  return global_max;
}

// Greedy topological sweep orders, exact mirror of the reference semantics
// (repeated index-order passes with within-pass readiness propagation,
// ref: src/AngularSweepOrder.cpp:93-144).
//   orders: (K, ne) int32 output
// Returns 0 on success, -1 on stall (cycle).
int32_t pbte_greedy_orders(int64_t ne, int64_t nf, int64_t dim, int64_t K,
                           const int32_t* neighbor, const double* normals,
                           const double* dirs, int32_t* orders) {
  std::vector<uint8_t> processed(ne);
  std::vector<uint8_t> upwind(ne * nf);

  for (int64_t k = 0; k < K; ++k) {
    const double* d = dirs + k * dim;
    int32_t* ord = orders + k * ne;
    for (int64_t e = 0; e < ne; ++e) {
      for (int64_t f = 0; f < nf; ++f) {
        const int32_t nb = neighbor[e * nf + f];
        double dot = 0.0;
        const double* n = normals + (e * nf + f) * dim;
        for (int64_t c = 0; c < dim; ++c) dot += n[c] * d[c];
        upwind[e * nf + f] = (nb >= 0 && dot < 0.0) ? 1 : 0;
      }
    }
    std::fill(processed.begin(), processed.end(), 0);
    int64_t count = 0;
    while (count < ne) {
      bool progressed = false;
      for (int64_t e = 0; e < ne; ++e) {
        if (processed[e]) continue;
        bool ready = true;
        for (int64_t f = 0; f < nf; ++f) {
          if (upwind[e * nf + f] &&
              !processed[neighbor[e * nf + f]]) {
            ready = false;
            break;
          }
        }
        if (ready) {
          ord[count++] = static_cast<int32_t>(e);
          processed[e] = 1;
          progressed = true;
        }
      }
      if (!progressed) return -1;
    }
  }
  return 0;
}

// Upwind dependency sign signature per direction (for DAG grouping):
// packs the inflow booleans of (ne*nf) faces into bytes, row per direction.
void pbte_inflow_signature(int64_t ne, int64_t nf, int64_t dim, int64_t K,
                           const int32_t* neighbor, const double* normals,
                           const double* dirs, uint8_t* packed,
                           int64_t packed_stride) {
  const int64_t nbits = ne * nf;
  for (int64_t k = 0; k < K; ++k) {
    const double* d = dirs + k * dim;
    uint8_t* row = packed + k * packed_stride;
    std::memset(row, 0, packed_stride);
    for (int64_t b = 0; b < nbits; ++b) {
      const int32_t nb = neighbor[b];
      if (nb < 0) continue;
      const double* n = normals + b * dim;
      double dot = 0.0;
      for (int64_t c = 0; c < dim; ++c) dot += n[c] * d[c];
      if (dot < 0.0) row[b >> 3] |= static_cast<uint8_t>(1u << (7 - (b & 7)));
    }
  }
}

}  // extern "C"
