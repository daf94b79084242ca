// Native host-side graph sampling: the CSR build, GraphSAINT random walks,
// induced subgraphs and the neighbour fan-out hop.
//
// A copy of biomedkg_tpu/sampling/native/sampler.cpp (the same functions,
// byte for byte, so one seed gives the same walks and neighbour samples in
// both packages). The Python samplers call these through ctypes
// (native/__init__.py, which builds this file with g++ at first use) and
// fall back to vectorised numpy when the library is unavailable.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// SplitMix64 — deterministic, seedable, cheap.
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Counting-sort CSR build keyed by `key` (src for out-CSR, dst for in-CSR).
// indptr: (num_nodes+1), nbr/etypes_out/eperm_out: (num_edges).
void build_csr(const int64_t* key, const int64_t* other,
               const int32_t* etype, int64_t num_edges, int64_t num_nodes,
               int64_t* indptr, int64_t* nbr, int32_t* etypes_out,
               int64_t* eperm_out) {
  std::memset(indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < num_edges; ++e) indptr[key[e] + 1]++;
  for (int64_t n = 0; n < num_nodes; ++n) indptr[n + 1] += indptr[n];
  std::vector<int64_t> cursor(indptr, indptr + num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t pos = cursor[key[e]]++;
    nbr[pos] = other[e];
    etypes_out[pos] = etype[e];
    eperm_out[pos] = e;
  }
}

// Random walks over out-CSR; dead ends stay in place (torch_cluster
// random_walk semantics). walks_out: (num_roots, walk_length+1).
void random_walk(const int64_t* indptr, const int64_t* nbr,
                 const int64_t* roots, int64_t num_roots, int32_t walk_length,
                 uint64_t seed, int64_t* walks_out) {
  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  if (num_roots < 256) nthreads = 1;
  std::vector<std::thread> pool;
  int64_t chunk = (num_roots + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(num_roots, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) {
        // Per-ROOT counter-based stream, scrambled once: (a) output is
        // invariant to the thread partition (same seed → same walks on
        // any core count, so epoch-keyed resume replay holds across
        // machines); (b) per-thread seeds spaced by the SplitMix64
        // increment made thread t's stream equal thread t+1's shifted
        // by one draw — systematically correlated chunks.
        uint64_t t0 = seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(i + 1);
        uint64_t s = splitmix64(&t0);
        int64_t cur = roots[i];
        int64_t* w = walks_out + i * (walk_length + 1);
        w[0] = cur;
        for (int32_t k = 0; k < walk_length; ++k) {
          int64_t deg = indptr[cur + 1] - indptr[cur];
          if (deg > 0) cur = nbr[indptr[cur] + (int64_t)(splitmix64(&s) % (uint64_t)deg)];
          w[k + 1] = cur;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Induced subgraph over `nodes` (unique, any order): emits local-id edges.
// lookup: caller-provided int64 array of size num_nodes_global, must be
// filled with -1 (reused across calls; this function restores it).
// Returns the number of edges written (bounded by max_edges; excess
// silently dropped — callers size max_edges from Σ deg(nodes)).
int64_t induced_subgraph(const int64_t* indptr, const int64_t* nbr,
                         const int32_t* etypes, const int64_t* nodes,
                         int64_t num_sub, int64_t* lookup,
                         int64_t* src_out, int64_t* dst_out,
                         int32_t* et_out, int64_t max_edges) {
  for (int64_t i = 0; i < num_sub; ++i) lookup[nodes[i]] = i;
  int64_t m = 0;
  for (int64_t i = 0; i < num_sub && m < max_edges; ++i) {
    int64_t v = nodes[i];
    for (int64_t p = indptr[v]; p < indptr[v + 1] && m < max_edges; ++p) {
      int64_t u_local = lookup[nbr[p]];
      if (u_local >= 0) {
        src_out[m] = i;
        dst_out[m] = u_local;
        et_out[m] = etypes[p];
        ++m;
      }
    }
  }
  for (int64_t i = 0; i < num_sub; ++i) lookup[nodes[i]] = -1;
  return m;
}

// One fan-out hop: for each frontier node sample <=k in-edges without
// replacement (full take when deg <= k; partial Fisher-Yates otherwise).
// Outputs parallel arrays (src_global, frontier_pos, etype); returns count.
int64_t sample_neighbors(const int64_t* indptr, const int64_t* nbr,
                         const int32_t* etypes, const int64_t* frontier,
                         int64_t num_frontier, int32_t k, uint64_t seed,
                         int64_t* src_out, int64_t* fpos_out,
                         int32_t* et_out) {
  uint64_t s = seed;
  int64_t m = 0;
  std::vector<int64_t> idx;
  for (int64_t i = 0; i < num_frontier; ++i) {
    int64_t v = frontier[i];
    int64_t lo = indptr[v], deg = indptr[v + 1] - lo;
    if (k < 0 || deg <= k) {
      for (int64_t p = lo; p < lo + deg; ++p) {
        src_out[m] = nbr[p];
        fpos_out[m] = i;
        et_out[m] = etypes[p];
        ++m;
      }
    } else {
      idx.resize(deg);
      for (int64_t j = 0; j < deg; ++j) idx[j] = j;
      for (int32_t j = 0; j < k; ++j) {  // partial Fisher-Yates
        int64_t r = j + (int64_t)(splitmix64(&s) % (uint64_t)(deg - j));
        std::swap(idx[j], idx[r]);
        int64_t p = lo + idx[j];
        src_out[m] = nbr[p];
        fpos_out[m] = i;
        et_out[m] = etypes[p];
        ++m;
      }
    }
  }
  return m;
}

}  // extern "C"
