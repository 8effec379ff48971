// Native multilevel k-way graph partitioner (the METIS recipe the
// reference links against natively: SHEM coarsening, greedy growing,
// balancing, boundary-FM refinement per level — ref: Reference
// Project/include/SpatialMesh/SpatialMesh.hpp:638-709, options :673-682).
// Same algorithm family as pbte_tpu/parallel/partition.py's numpy
// implementation; this is the production-speed path (the numpy version is
// the always-available fallback and the semantics oracle). C-ABI, loaded
// via ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC partition_native.cpp -o ...

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <numeric>

namespace {

struct Graph {
    std::vector<int64_t> xadj;    // n+1
    std::vector<int32_t> adjncy;  // edges
    std::vector<int64_t> adjwgt;  // edge weights
    std::vector<int64_t> vwgt;    // vertex weights
    int64_t n() const { return (int64_t)vwgt.size(); }
};

// xorshift64* — deterministic, seedable
struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed * 2685821657736338717ULL + 1) {}
    uint64_t next() {
        s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
        return s * 2685821657736338717ULL;
    }
    int64_t below(int64_t m) { return (int64_t)(next() % (uint64_t)m); }
};

Graph graph_from_neighbor(int64_t ne, int64_t nf, const int32_t* neighbor) {
    // adjacency with per-pair edge weights = number of shared faces
    Graph g;
    g.vwgt.assign(ne, 1);
    g.xadj.assign(ne + 1, 0);
    std::vector<std::pair<int32_t, int32_t>> pairs;  // (v, u)
    pairs.reserve(ne * nf);
    for (int64_t e = 0; e < ne; ++e)
        for (int64_t f = 0; f < nf; ++f) {
            int32_t u = neighbor[e * nf + f];
            if (u >= 0) pairs.emplace_back((int32_t)e, u);
        }
    // sort per-vertex neighbor lists and merge duplicates into weights
    std::sort(pairs.begin(), pairs.end());
    g.adjncy.reserve(pairs.size());
    g.adjwgt.reserve(pairs.size());
    size_t i = 0;
    for (int64_t v = 0; v < ne; ++v) {
        while (i < pairs.size() && pairs[i].first == v) {
            int32_t u = pairs[i].second;
            int64_t w = 0;
            while (i < pairs.size() && pairs[i].first == v &&
                   pairs[i].second == u) { ++w; ++i; }
            g.adjncy.push_back(u);
            g.adjwgt.push_back(w);
        }
        g.xadj[v + 1] = (int64_t)g.adjncy.size();
    }
    return g;
}

// Sorted heavy-edge matching; returns coarse graph + fine->coarse map.
bool coarsen_shem(const Graph& g, Rng& rng, Graph& cg,
                  std::vector<int32_t>& cmap) {
    int64_t n = g.n();
    std::vector<int32_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    for (int64_t v = n - 1; v > 0; --v)
        std::swap(order[v], order[rng.below(v + 1)]);
    // visit low-degree vertices first with the random shuffle as the
    // tie-break (METIS SHEM's order; measured 8.5k vs 12.1k edge cut at
    // 1e5 tets against the heavy-first alternative)
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return (g.xadj[a + 1] - g.xadj[a]) < (g.xadj[b + 1] - g.xadj[b]);
    });
    std::vector<int32_t> match(n, -1);
    int64_t nmerged = 0;
    for (int32_t v : order) {
        if (match[v] >= 0) continue;
        int32_t best = -1;
        int64_t bw = -1;
        for (int64_t j = g.xadj[v]; j < g.xadj[v + 1]; ++j) {
            int32_t u = g.adjncy[j];
            if (u != v && match[u] < 0 && g.adjwgt[j] > bw) {
                bw = g.adjwgt[j];
                best = u;
            }
        }
        if (best >= 0) { match[v] = best; match[best] = v; ++nmerged; }
        else match[v] = v;
    }
    if (nmerged == 0) return false;  // no progress: stop coarsening
    cmap.assign(n, -1);
    int32_t nc = 0;
    for (int64_t v = 0; v < n; ++v) {
        if (cmap[v] >= 0) continue;
        cmap[v] = nc;
        if (match[v] != (int32_t)v) cmap[match[v]] = nc;
        ++nc;
    }
    // coarse weights + merged adjacency
    cg.vwgt.assign(nc, 0);
    for (int64_t v = 0; v < n; ++v) cg.vwgt[cmap[v]] += g.vwgt[v];
    std::vector<std::pair<int64_t, int64_t>> ce;  // (cv*nc + cu, w)
    ce.reserve(g.adjncy.size());
    for (int64_t v = 0; v < n; ++v)
        for (int64_t j = g.xadj[v]; j < g.xadj[v + 1]; ++j) {
            int32_t cu = cmap[g.adjncy[j]], cv = cmap[v];
            if (cu != cv)
                ce.emplace_back((int64_t)cv * nc + cu, g.adjwgt[j]);
        }
    std::sort(ce.begin(), ce.end());
    cg.xadj.assign(nc + 1, 0);
    cg.adjncy.clear();
    cg.adjwgt.clear();
    size_t i = 0;
    for (int32_t cv = 0; cv < nc; ++cv) {
        while (i < ce.size() && ce[i].first / nc == cv) {
            int64_t key = ce[i].first;
            int64_t w = 0;
            while (i < ce.size() && ce[i].first == key) { w += ce[i].second; ++i; }
            cg.adjncy.push_back((int32_t)(key % nc));
            cg.adjwgt.push_back(w);
        }
        cg.xadj[cv + 1] = (int64_t)cg.adjncy.size();
    }
    return true;
}

void greedy_grow(const Graph& g, int64_t nparts, Rng& rng,
                 std::vector<int32_t>& part) {
    int64_t n = g.n();
    int64_t total = std::accumulate(g.vwgt.begin(), g.vwgt.end(), (int64_t)0);
    double target = (double)total / (double)nparts;
    part.assign(n, -1);
    std::vector<int64_t> conn(n, 0);
    int64_t unassigned = n;
    for (int64_t p = 0; p + 1 < nparts && unassigned > 0; ++p) {
        // random unassigned seed
        int64_t seed = -1, skip = rng.below(unassigned);
        for (int64_t v = 0; v < n; ++v)
            if (part[v] < 0 && skip-- == 0) { seed = v; break; }
        if (seed < 0) break;
        std::fill(conn.begin(), conn.end(), 0);
        part[seed] = (int32_t)p;
        --unassigned;
        int64_t wsum = g.vwgt[seed];
        std::vector<int32_t> frontier;
        auto push_nbrs = [&](int64_t v) {
            for (int64_t j = g.xadj[v]; j < g.xadj[v + 1]; ++j) {
                int32_t u = g.adjncy[j];
                if (part[u] < 0) {
                    if (conn[u] == 0) frontier.push_back(u);
                    conn[u] += g.adjwgt[j];
                }
            }
        };
        push_nbrs(seed);
        while (wsum < target && !frontier.empty()) {
            // strongest-connection frontier vertex (linear scan: the
            // coarsest graph is tiny)
            size_t bi = 0;
            for (size_t q = 1; q < frontier.size(); ++q)
                if (conn[frontier[q]] > conn[frontier[bi]]) bi = q;
            int32_t u = frontier[bi];
            frontier[bi] = frontier.back();
            frontier.pop_back();
            if (part[u] >= 0) continue;
            part[u] = (int32_t)p;
            --unassigned;
            wsum += g.vwgt[u];
            push_nbrs(u);
        }
    }
    for (int64_t v = 0; v < n; ++v)
        if (part[v] < 0) part[v] = (int32_t)(nparts - 1);
}

// Explicit balancing: move least-damaging boundary vertices out of
// over-cap parts (plain gain-FM cannot shed weight; see the numpy twin).
void balance(const Graph& g, int64_t nparts, double cap_f,
             std::vector<int32_t>& part) {
    int64_t n = g.n();
    std::vector<int64_t> ws(nparts, 0);
    for (int64_t v = 0; v < n; ++v) ws[part[v]] += g.vwgt[v];
    int64_t vmax = *std::max_element(g.vwgt.begin(), g.vwgt.end());
    int64_t cap = std::max((int64_t)cap_f, (int64_t)cap_f + vmax - 1);
    std::vector<int64_t> conn(nparts);
    for (int64_t iter = 0; iter < 4 * n; ++iter) {
        int64_t p = -1, wmax = cap;
        for (int64_t q = 0; q < nparts; ++q)
            if (ws[q] > wmax) { wmax = ws[q]; p = q; }
        if (p < 0) break;
        // best (gain, under-cap) move out of p
        int64_t best_v = -1, best_t = -1;
        std::pair<int, int64_t> best_key{-1, INT64_MIN};
        for (int64_t v = 0; v < n; ++v) {
            if (part[v] != p) continue;
            std::fill(conn.begin(), conn.end(), 0);
            bool bnd = false;
            for (int64_t j = g.xadj[v]; j < g.xadj[v + 1]; ++j) {
                int32_t t = part[g.adjncy[j]];
                conn[t] += g.adjwgt[j];
                if (t != p) bnd = true;
            }
            if (!bnd) continue;
            for (int64_t t = 0; t < nparts; ++t) {
                if (t == p || conn[t] == 0) continue;
                if (ws[t] + g.vwgt[v] >= ws[p]) continue;
                std::pair<int, int64_t> key{
                    ws[t] + g.vwgt[v] <= cap ? 1 : 0, conn[t] - conn[p]};
                if (best_v < 0 || key > best_key) {
                    best_key = key; best_v = v; best_t = t;
                }
            }
        }
        if (best_v < 0) {
            // no lighter ADJACENT part: last resort, move the p-vertex
            // with the least internal connectivity to the globally
            // lightest part (cut grows, but the cap is a hard contract —
            // ws[p] strictly decreases, so this always progresses)
            int64_t t = (int64_t)(
                std::min_element(ws.begin(), ws.end()) - ws.begin());
            if (ws[t] >= ws[p]) break;
            int64_t min_int = INT64_MAX;
            for (int64_t v = 0; v < n; ++v) {
                if (part[v] != p) continue;
                int64_t internal = 0;
                for (int64_t j = g.xadj[v]; j < g.xadj[v + 1]; ++j)
                    if (part[g.adjncy[j]] == p) internal += g.adjwgt[j];
                if (internal < min_int) { min_int = internal; best_v = v; }
            }
            if (best_v < 0) break;
            best_t = t;
        }
        ws[p] -= g.vwgt[best_v];
        ws[best_t] += g.vwgt[best_v];
        part[best_v] = (int32_t)best_t;
    }
}

void refine_fm(const Graph& g, int64_t nparts, double max_ratio,
               std::vector<int32_t>& part, int passes = 8) {
    int64_t n = g.n();
    int64_t total = std::accumulate(g.vwgt.begin(), g.vwgt.end(), (int64_t)0);
    int64_t cap = (int64_t)((double)total / (double)nparts * max_ratio + 0.999);
    std::vector<int64_t> ws(nparts, 0);
    for (int64_t v = 0; v < n; ++v) ws[part[v]] += g.vwgt[v];
    std::vector<int64_t> conn(nparts);
    for (int pass = 0; pass < passes; ++pass) {
        int64_t moved = 0;
        for (int64_t v = 0; v < n; ++v) {
            int32_t pv = part[v];
            if (ws[pv] - g.vwgt[v] <= 0) continue;
            bool bnd = false;
            std::fill(conn.begin(), conn.end(), 0);
            for (int64_t j = g.xadj[v]; j < g.xadj[v + 1]; ++j) {
                int32_t t = part[g.adjncy[j]];
                conn[t] += g.adjwgt[j];
                if (t != pv) bnd = true;
            }
            if (!bnd) continue;
            int64_t internal = conn[pv];
            int64_t best_gain = 0;
            int64_t best_t = -1;
            for (int64_t t = 0; t < nparts; ++t) {
                if (t == pv || conn[t] == 0) continue;
                if (ws[t] + g.vwgt[v] > cap) continue;
                int64_t gain = conn[t] - internal;
                if (gain > best_gain) { best_gain = gain; best_t = t; }
                else if (best_t < 0 && gain == 0 &&
                         ws[pv] > ws[t] + g.vwgt[v]) best_t = t;
            }
            if (best_t >= 0) {
                part[v] = (int32_t)best_t;
                ws[pv] -= g.vwgt[v];
                ws[best_t] += g.vwgt[v];
                ++moved;
            }
        }
        if (moved == 0) break;
    }
}

}  // namespace

extern "C" int32_t pbte_partition_multilevel(
    int64_t ne, int64_t nf, const int32_t* neighbor, int64_t nparts,
    int64_t seed, int64_t coarse_target_per_part, double max_ratio,
    int32_t* part_out) {
    if (ne <= 0 || nparts <= 0) return -1;
    if (nparts == 1) {
        std::memset(part_out, 0, (size_t)ne * sizeof(int32_t));
        return 0;
    }
    Rng rng((uint64_t)seed + 0x9E3779B97F4A7C15ULL);
    std::vector<Graph> levels;
    std::vector<std::vector<int32_t>> cmaps;
    levels.push_back(graph_from_neighbor(ne, nf, neighbor));
    int64_t stop_n = std::max(coarse_target_per_part * nparts, (int64_t)64);
    while (levels.back().n() > stop_n) {
        Graph cg;
        std::vector<int32_t> cmap;
        if (!coarsen_shem(levels.back(), rng, cg, cmap)) break;
        cmaps.push_back(std::move(cmap));
        levels.push_back(std::move(cg));
    }
    std::vector<int32_t> part;
    {
        const Graph& g = levels.back();
        greedy_grow(g, nparts, rng, part);
        int64_t total =
            std::accumulate(g.vwgt.begin(), g.vwgt.end(), (int64_t)0);
        balance(g, nparts, (double)total / (double)nparts * max_ratio, part);
        refine_fm(g, nparts, max_ratio, part);
    }
    for (int64_t lev = (int64_t)cmaps.size() - 1; lev >= 0; --lev) {
        const Graph& g = levels[lev];
        const std::vector<int32_t>& cmap = cmaps[lev];
        std::vector<int32_t> fine((size_t)g.n());
        for (int64_t v = 0; v < g.n(); ++v) fine[v] = part[cmap[v]];
        part = std::move(fine);
        int64_t total =
            std::accumulate(g.vwgt.begin(), g.vwgt.end(), (int64_t)0);
        balance(g, nparts, (double)total / (double)nparts * max_ratio, part);
        refine_fm(g, nparts, max_ratio, part);
    }
    std::memcpy(part_out, part.data(), (size_t)ne * sizeof(int32_t));
    return 0;
}
