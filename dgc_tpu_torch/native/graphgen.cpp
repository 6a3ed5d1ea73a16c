// Native graph generation + CSR construction for dgc_tpu.
//
// The reference repo is pure Python (SURVEY.md §2.6 — no native components);
// its generator (graph.py:30-43) is a host-side rejection sampler that becomes
// the pipeline bottleneck at TPU scale (the device colors 1M vertices faster
// than CPython can build them). This library provides the three generators
// with the same semantics as dgc_tpu.models.generators, at C++ speed:
//
//  - reference: visit vertices in id order, target degree ~ U{0..max_degree},
//    rejection-sample partners (no self loop / duplicate / partner at cap),
//    symmetric insert, bounded retries.
//  - fast: uniform edge sampling with dedup and an *exact sequential greedy*
//    degree cap (the Python fallback uses a stricter one-pass rank cap).
//  - rmat: recursive quadrant sampling (R-MAT), optional greedy cap.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). Graphs are
// returned as an opaque handle; callers read CSR sizes, copy out, and free.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

struct DgcGraph {
  int64_t num_vertices = 0;
  std::vector<int32_t> indptr;   // [V+1]
  std::vector<int32_t> indices;  // [E2]
};

// splitmix64: ~1ns/draw vs ~5-10ns for mt19937_64 — edge sampling draws
// billions (scale levels x 2 decisions x |E|), so the PRNG dominates
// generation wall-clock at TPU-bench sizes (4M vertices / 64M edges).
// Statistical quality is ample for benchmark graphs.
struct SplitMix64 {
  uint64_t s;
  explicit SplitMix64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased-enough range reduction via 128-bit multiply (Lemire)
  int64_t below(int64_t n) {
    return (int64_t)(((__uint128_t)next() * (uint64_t)n) >> 64);
  }
  double uniform() { return (double)(next() >> 11) * 0x1.0p-53; }
};

// LSB-radix sort of (u64 key, u32 payload) pairs, 4 x 16-bit passes —
// ~4x faster than std::sort at the 10^8-edge dedup this feeds.
void radix_sort_keyed(std::vector<std::pair<uint64_t, uint32_t>>& a) {
  const size_t n = a.size();
  std::vector<std::pair<uint64_t, uint32_t>> tmp(n);
  auto* src = a.data();
  auto* dst = tmp.data();
  // heap histogram: 512 KB would be unsafe on small-stack threads
  std::vector<size_t> count(65536);
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 16;
    std::fill(count.begin(), count.end(), 0);
    for (size_t i = 0; i < n; ++i) count[(src[i].first >> shift) & 0xFFFF]++;
    size_t pos = 0;
    for (size_t b = 0; b < 65536; ++b) {
      size_t c = count[b];
      count[b] = pos;
      pos += c;
    }
    for (size_t i = 0; i < n; ++i)
      dst[count[(src[i].first >> shift) & 0xFFFF]++] = src[i];
    std::swap(src, dst);
  }
  // 4 passes = even number of swaps: result is back in `a`
}

// Build symmetric CSR from an undirected (deduped) edge list.
DgcGraph build_csr(int64_t v, const std::vector<std::pair<int32_t, int32_t>>& edges) {
  DgcGraph g;
  g.num_vertices = v;
  std::vector<int32_t> deg(v, 0);
  for (auto& e : edges) {
    deg[e.first]++;
    deg[e.second]++;
  }
  g.indptr.resize(v + 1);
  g.indptr[0] = 0;
  for (int64_t i = 0; i < v; ++i) g.indptr[i + 1] = g.indptr[i] + deg[i];
  g.indices.resize(g.indptr[v]);
  std::vector<int32_t> cursor(g.indptr.begin(), g.indptr.end() - 1);
  for (auto& e : edges) {
    g.indices[cursor[e.first]++] = e.second;
    g.indices[cursor[e.second]++] = e.first;
  }
  // sort each neighbor list for deterministic output (matches the Python path)
  for (int64_t i = 0; i < v; ++i)
    std::sort(g.indices.begin() + g.indptr[i], g.indices.begin() + g.indptr[i + 1]);
  return g;
}

// Dedup undirected edges (and drop self loops), preserving first-seen order.
// Sort-based: at 10^8 sampled edges an unordered_set spends most of the
// generator's wall-clock on hashing/chasing; sort+mark is ~10x faster.
void dedup_edges(int64_t v, std::vector<std::pair<int32_t, int32_t>>& edges) {
  const size_t n = edges.size();
  std::vector<std::pair<uint64_t, uint32_t>> keyed;  // (canonical key, position)
  keyed.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    auto& e = edges[i];
    if (e.first == e.second) continue;
    uint64_t lo = std::min(e.first, e.second), hi = std::max(e.first, e.second);
    keyed.emplace_back(lo * (uint64_t)v + hi, (uint32_t)i);
  }
  // radix is stable, so equal keys stay in position order — same result as
  // std::sort on (key, pos) pairs, ~4x faster at 10^8 edges
  radix_sort_keyed(keyed);
  std::vector<uint32_t> keep_pos;
  keep_pos.reserve(keyed.size());
  for (size_t i = 0; i < keyed.size(); ++i) {
    if (i == 0 || keyed[i].first != keyed[i - 1].first)
      keep_pos.push_back(keyed[i].second);
    else
      // duplicates keep the earliest occurrence (first-seen order)
      keep_pos.back() = std::min(keep_pos.back(), keyed[i].second);
  }
  std::sort(keep_pos.begin(), keep_pos.end());
  std::vector<std::pair<int32_t, int32_t>> out;
  out.reserve(keep_pos.size());
  for (uint32_t p : keep_pos) out.push_back(edges[p]);
  edges.swap(out);
}

// Exact sequential greedy degree cap (keeps an edge iff both endpoints are
// under max_degree at its position — the reference partner-cap semantics,
// graph.py:38, applied in sampled order).
void greedy_cap(int64_t v, std::vector<std::pair<int32_t, int32_t>>& edges,
                int32_t max_degree) {
  std::vector<int32_t> deg(v, 0);
  size_t out = 0;
  for (auto& e : edges) {
    if (deg[e.first] < max_degree && deg[e.second] < max_degree) {
      deg[e.first]++;
      deg[e.second]++;
      edges[out++] = e;
    }
  }
  edges.resize(out);
}

}  // namespace

extern "C" {

// Exceptions (std::bad_alloc at multi-GB scale) must not cross the C ABI —
// they would std::terminate() the host Python process instead of letting the
// bindings fall back to the Python generators. NULL signals failure.
#define DGC_GUARD_BEGIN try {
#define DGC_GUARD_END \
  }                   \
  catch (...) { return nullptr; }

void* dgc_generate_fast(int64_t node_count, double avg_degree, uint64_t seed,
                        int32_t max_degree) {
  DGC_GUARD_BEGIN
  SplitMix64 rng(seed);
  int64_t m = (int64_t)(node_count * avg_degree / 2.0);
  std::vector<std::pair<int32_t, int32_t>> edges;
  edges.reserve(m);
  for (int64_t i = 0; i < m; ++i)
    edges.emplace_back((int32_t)rng.below(node_count),
                       (int32_t)rng.below(node_count));
  dedup_edges(node_count, edges);
  if (max_degree >= 0) greedy_cap(node_count, edges, max_degree);
  return new DgcGraph(build_csr(node_count, edges));
  DGC_GUARD_END
}

void* dgc_generate_reference(int64_t node_count, int32_t max_degree, uint64_t seed,
                             int64_t max_retries_per_vertex) {
  DGC_GUARD_BEGIN
  std::mt19937_64 rng(seed);
  if (max_retries_per_vertex < 0) max_retries_per_vertex = 50L * std::max(max_degree, 1);
  std::vector<std::vector<int32_t>> nbrs(node_count);
  std::vector<std::unordered_set<int32_t>> sets(node_count);
  std::uniform_int_distribution<int64_t> pick(0, node_count - 1);
  for (int64_t vtx = 0; vtx < node_count; ++vtx) {
    std::uniform_int_distribution<int32_t> degd(0, max_degree);
    int32_t target = degd(rng);
    int64_t tries = 0;
    while ((int32_t)nbrs[vtx].size() < target && tries < max_retries_per_vertex) {
      ++tries;
      int64_t u = pick(rng);
      if (u == vtx || sets[vtx].count((int32_t)u) ||
          (int32_t)nbrs[u].size() >= max_degree)
        continue;
      nbrs[vtx].push_back((int32_t)u);
      sets[vtx].insert((int32_t)u);
      nbrs[u].push_back((int32_t)vtx);
      sets[u].insert((int32_t)vtx);
    }
  }
  auto* g = new DgcGraph();
  g->num_vertices = node_count;
  g->indptr.resize(node_count + 1);
  g->indptr[0] = 0;
  for (int64_t i = 0; i < node_count; ++i)
    g->indptr[i + 1] = g->indptr[i] + (int32_t)nbrs[i].size();
  g->indices.resize(g->indptr[node_count]);
  for (int64_t i = 0; i < node_count; ++i) {
    std::sort(nbrs[i].begin(), nbrs[i].end());
    std::copy(nbrs[i].begin(), nbrs[i].end(), g->indices.begin() + g->indptr[i]);
  }
  return g;
  DGC_GUARD_END
}

void* dgc_generate_rmat(int64_t node_count, double avg_degree, uint64_t seed,
                        double a, double b, double c, int32_t max_degree) {
  DGC_GUARD_BEGIN
  SplitMix64 rng(seed);
  int scale = 1;
  while ((1L << scale) < node_count) ++scale;
  int64_t m = (int64_t)(node_count * avg_degree / 2.0);
  double ab = a + b;
  double abc = a + b + c;
  double right_top = b / ab;
  double right_bot = (1.0 - ab) > 0 ? (1.0 - abc) / (1.0 - ab) : 0.5;
  std::vector<std::pair<int32_t, int32_t>> edges;
  edges.reserve(m);
  for (int64_t i = 0; i < m; ++i) {
    int64_t src = 0, dst = 0;
    for (int s = 0; s < scale; ++s) {
      double r = rng.uniform();
      bool bottom = r >= ab;
      src = src * 2 + (bottom ? 1 : 0);
      double pr = bottom ? right_bot : right_top;
      dst = dst * 2 + (rng.uniform() < pr ? 1 : 0);
    }
    edges.emplace_back((int32_t)(src % node_count), (int32_t)(dst % node_count));
  }
  dedup_edges(node_count, edges);
  if (max_degree >= 0) greedy_cap(node_count, edges, max_degree);
  return new DgcGraph(build_csr(node_count, edges));
  DGC_GUARD_END
}

// Degree-descending CSR relabel for the bucketed engines: row nr of the
// output is old row perm[nr] with neighbor ids mapped through inv(perm)
// and sorted ascending — the same result as the NumPy path's global
// (new_row, new_col) argsort, but via per-row copy+sort (rows are short;
// no 16M-entry global sort). The hot host-side step of engine build.
void* dgc_relabel_csr(int64_t v, const int32_t* indptr, const int32_t* indices,
                      const int32_t* perm) {
  DGC_GUARD_BEGIN
  std::vector<int32_t> inv(v);
  for (int64_t nr = 0; nr < v; ++nr) inv[perm[nr]] = (int32_t)nr;
  // unique_ptr: a bad_alloc mid-build (the multi-GB case the guard exists
  // for) must not leak the partially built graph
  auto g = std::make_unique<DgcGraph>();
  g->num_vertices = v;
  g->indptr.resize(v + 1);
  g->indptr[0] = 0;
  for (int64_t nr = 0; nr < v; ++nr) {
    int32_t u = perm[nr];
    g->indptr[nr + 1] = g->indptr[nr] + (indptr[u + 1] - indptr[u]);
  }
  g->indices.resize(g->indptr[v]);
  for (int64_t nr = 0; nr < v; ++nr) {
    int32_t u = perm[nr];
    int32_t* out = g->indices.data() + g->indptr[nr];
    const int32_t* in = indices + indptr[u];
    const int32_t d = indptr[u + 1] - indptr[u];
    for (int32_t j = 0; j < d; ++j) out[j] = inv[in[j]];
    std::sort(out, out + d);
  }
  return g.release();
  DGC_GUARD_END
}


// Fill one bucket's combined (neighbor id | priority bit) ELL table in a
// single pass over the relabeled CSR: out[r*width + j] = nbr | (beats << 30)
// for the j-th neighbor of relabeled row row0+r, sentinel for pad slots.
// beats = (deg[nbr], -nbr) > (deg[row], -row) — the (degree desc, id asc)
// total order every engine derives its priorities from. Writes directly
// into the caller's buffer (no handle) so the multi-GB tables of a 4M-
// vertex power-law graph are built without NumPy's chain of full-size
// temporaries (bool mask -> int32 cast -> shift -> or). Returns 0 on
// success, 1 on failure (caller falls back to the NumPy path).
int32_t dgc_build_combined(int64_t v, const int64_t* indptr,
                           const int32_t* indices, const int32_t* degrees,
                           int64_t row0, int64_t nrows, int64_t width,
                           int32_t sentinel, int32_t* out) {
  (void)v;
  try {
    for (int64_t r = 0; r < nrows; ++r) {
      const int64_t g = row0 + r;
      const int64_t b = indptr[g];
      const int64_t d = indptr[g + 1] - b;
      if (d > width) return 1;  // NumPy path raises here; never overrun
      const int32_t my_deg = degrees[g];
      int32_t* row = out + r * width;
      for (int64_t j = 0; j < d; ++j) {
        const int32_t nb = indices[b + j];
        const int32_t nd = degrees[nb];
        const bool beats = nd > my_deg || (nd == my_deg && (int64_t)nb < g);
        row[j] = nb | ((int32_t)beats << 30);
      }
      for (int64_t j = d; j < width; ++j) row[j] = sentinel;
    }
    return 0;
  } catch (...) {
    return 1;
  }
}

int64_t dgc_num_vertices(void* h) { return static_cast<DgcGraph*>(h)->num_vertices; }

int64_t dgc_num_directed_edges(void* h) {
  return (int64_t) static_cast<DgcGraph*>(h)->indices.size();
}

void dgc_copy_csr(void* h, int32_t* indptr_out, int32_t* indices_out) {
  auto* g = static_cast<DgcGraph*>(h);
  std::memcpy(indptr_out, g->indptr.data(), g->indptr.size() * sizeof(int32_t));
  std::memcpy(indices_out, g->indices.data(), g->indices.size() * sizeof(int32_t));
}

void dgc_free(void* h) { delete static_cast<DgcGraph*>(h); }

// Kempe-assisted top-class elimination — the native fast path of
// dgc_tpu/ops/reduce_colors.py::eliminate_top_class, bit-identical by
// construction: phase 1 runs first-fit for every member of the top class
// (members are pairwise non-adjacent, so in-place sequential assignment
// equals the Python module's vectorized simultaneous scan); phase 2 walks
// the stubborn residue with the same (count-stable-sorted a, b) pair order
// and the same LIFO chain traversal, spending the same visit budget.
// Returns 1 when the class emptied (colors updated in place), 0 when a
// member resisted or the budget ran dry (colors then left PARTIALLY
// modified — the caller passes a scratch copy, exactly like the Python
// path), -1 on allocation failure.
int32_t dgc_reduce_top_class(int64_t v, const int32_t* indptr,
                             const int32_t* indices, int32_t* colors,
                             int32_t c, int32_t max_pair_tries,
                             int32_t chain_cap, int64_t kempe_max_class,
                             int64_t* budget_remaining) {
  try {
    if (c < 1) return 0;
    std::vector<int32_t> members;
    for (int64_t i = 0; i < v; ++i)
      if (colors[i] == c) members.push_back((int32_t)i);
    bool kempe_ok = (int64_t)members.size() <= kempe_max_class;

    // phase 1: first-fit below c for every member
    std::vector<int32_t> used_epoch(c, -1);
    std::vector<int32_t> stubborn;
    int32_t epoch = 0;
    for (int32_t m : members) {
      ++epoch;
      for (int32_t e = indptr[m]; e < indptr[m + 1]; ++e) {
        int32_t nc = colors[indices[e]];
        if (nc >= 0 && nc < c) used_epoch[nc] = epoch;
      }
      int32_t pick = -1;
      for (int32_t col = 0; col < c; ++col)
        if (used_epoch[col] != epoch) { pick = col; break; }
      if (pick >= 0)
        colors[m] = pick;
      else
        stubborn.push_back(m);
    }
    if (stubborn.empty()) return 1;
    if (!kempe_ok) return 0;

    // phase 2: Kempe moves for the stubborn residue
    std::vector<int32_t> seen_epoch(v, -1), bn_epoch(v, -1);
    std::vector<int32_t> stack, comp, counts(c);
    int32_t ep = 0;
    for (int32_t m : stubborn) {
      // prior swaps may have freed a color here since phase 1
      ++epoch;
      for (int32_t e = indptr[m]; e < indptr[m + 1]; ++e) {
        int32_t nc = colors[indices[e]];
        if (nc >= 0 && nc < c) used_epoch[nc] = epoch;
      }
      int32_t pick = -1;
      for (int32_t col = 0; col < c; ++col)
        if (used_epoch[col] != epoch) { pick = col; break; }
      if (pick >= 0) { colors[m] = pick; continue; }
      if (*budget_remaining <= 0) return 0;

      // (a, b) pairs cheapest-first: stable sort by neighbor-color count
      std::fill(counts.begin(), counts.end(), 0);
      for (int32_t e = indptr[m]; e < indptr[m + 1]; ++e) {
        int32_t nc = colors[indices[e]];
        if (nc >= 0 && nc < c) ++counts[nc];
      }
      std::vector<int32_t> order(c);
      for (int32_t i = 0; i < c; ++i) order[i] = i;
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t x, int32_t y) { return counts[x] < counts[y]; });

      bool moved = false;
      int32_t tries = 0;
      for (int32_t ai = 0; ai < c && !moved && tries <= max_pair_tries; ++ai) {
        int32_t a = order[ai];
        for (int32_t bi = 0; bi < c; ++bi) {
          int32_t b = order[bi];
          if (b == a) continue;
          if (++tries > max_pair_tries) break;
          // one chain attempt: swap every {a,b} component holding an
          // a-colored neighbor of m, unless one also holds a b-neighbor
          ++ep;
          stack.clear();
          comp.clear();
          for (int32_t e = indptr[m]; e < indptr[m + 1]; ++e) {
            int32_t w = indices[e];
            if (colors[w] == b) bn_epoch[w] = ep;
          }
          for (int32_t e = indptr[m]; e < indptr[m + 1]; ++e) {
            int32_t w = indices[e];
            if (colors[w] == a) stack.push_back(w);
          }
          bool ok = true;
          int64_t visited = 0;
          while (!stack.empty()) {
            int32_t u = stack.back();
            stack.pop_back();
            if (seen_epoch[u] == ep) continue;
            seen_epoch[u] = ep;
            ++visited;
            if (colors[u] == b && bn_epoch[u] == ep) { ok = false; break; }
            comp.push_back(u);
            if ((int32_t)comp.size() > chain_cap) { ok = false; break; }
            for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
              int32_t w = indices[e];
              int32_t cw = colors[w];
              if ((cw == a || cw == b) && seen_epoch[w] != ep)
                stack.push_back(w);
            }
          }
          *budget_remaining -= visited;
          if (ok) {
            for (int32_t u : comp) colors[u] = (colors[u] == a) ? b : a;
            colors[m] = a;
            moved = true;
            break;
          }
          if (*budget_remaining <= 0) return 0;
        }
      }
      if (!moved) return 0;
    }
    return 1;
  } catch (...) {
    return -1;
  }
}

// Sequential first-fit greedy over CSR in the caller-supplied vertex
// order — the native fast path of the recolor pass's greedy-resweep tier
// (dgc_tpu/ops/reduce_colors.py) and bit-identical to
// dgc_tpu/engine/oracle.py::greedy_color given the same order. The order
// stays Python-computed (np.lexsort) so the (degree desc, id asc) total
// order lives in exactly one place. colors_out must hold v entries; it is
// fully overwritten. Returns the color count, or -1 on failure.
int32_t dgc_greedy_color(int64_t v, const int32_t* indptr,
                         const int32_t* indices, const int32_t* order,
                         int32_t* colors_out) {
  try {
    for (int64_t i = 0; i < v; ++i) colors_out[i] = -1;
    // stamp[c] == i  ⇔  color c seen among neighbors of the i-th vertex;
    // first-fit colors never exceed the max degree < v
    std::vector<int32_t> stamp(v + 1, -1);
    int32_t maxc = -1;
    for (int64_t i = 0; i < v; ++i) {
      int32_t u = order[i];
      for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int32_t nc = colors_out[indices[e]];
        if (nc >= 0) stamp[nc] = (int32_t)i;
      }
      int32_t col = 0;
      while (stamp[col] == (int32_t)i) ++col;
      colors_out[u] = col;
      if (col > maxc) maxc = col;
    }
    return maxc + 1;
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
