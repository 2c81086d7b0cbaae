// Maximum-clique solver: k-core peeling, greedy heuristic, and exact
// branch & bound with greedy-coloring bounds (Tomita-style).
//
// Host-side C++ component of clipper_tpu_torch, the port's own copy of
// clipper_tpu/native/maxclique.cpp (same code and C ABI). The reference
// wraps the external PMC library (reference: src/maxclique.cpp:47-147);
// this is our own self-contained implementation with the same method
// semantics:
//   EXACT (0): k-core prune + coloring branch & bound ("ROBIN*")
//   HEU   (1): k-core-ordered greedy heuristic lower bound ("ROBIN" heu)
//   KCORE (2): vertices with core number >= max core
//
// The exact search is parallel: top-level branches of the coloring B&B are
// distributed over std::threads with a shared atomic incumbent (same role as
// PMC's OpenMP-parallel search, reference: src/maxclique.cpp:126-139,
// maxclique.h:20 threads=24 — but our own shared-incumbent design, not a
// wrapper). threads=1 reproduces the serial search exactly.
//
// C ABI for ctypes:
//   mc_solve(n, adj, method, time_limit_s, threads, out_nodes) -> clique size
//     adj: row-major n*n uint8 adjacency (nonzero = edge), diagonal ignored
//   mc_core_numbers(n, adj, out_core) -> max core

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct BitGraph {
  int64_t n;
  int64_t words;
  std::vector<uint64_t> adj;  // n rows of `words` 64-bit words

  BitGraph(int64_t n_, const uint8_t* a) : n(n_), words((n_ + 63) / 64),
                                           adj(n_ * words, 0) {
    for (int64_t i = 0; i < n; ++i)
      for (int64_t j = 0; j < n; ++j)
        if (i != j && a[i * n + j])
          adj[i * words + j / 64] |= (1ull << (j % 64));
  }

  bool connected(int64_t i, int64_t j) const {
    return (adj[i * words + j / 64] >> (j % 64)) & 1;
  }

  const uint64_t* row(int64_t i) const { return &adj[i * words]; }
};

// Peeling-based core decomposition (bucket queue, O(V + E)).
int64_t core_numbers(int64_t n, const uint8_t* a, std::vector<int64_t>& core) {
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j)
      if (i != j && a[i * n + j]) deg[i]++;

  const int64_t maxdeg = n ? *std::max_element(deg.begin(), deg.end()) : 0;
  std::vector<std::vector<int64_t>> bins(maxdeg + 1);
  for (int64_t v = 0; v < n; ++v) bins[deg[v]].push_back(v);

  core.assign(n, 0);
  std::vector<uint8_t> removed(n, 0);
  std::vector<int64_t> d = deg;
  int64_t maxcore = 0;
  for (int64_t k = 0; k <= maxdeg; ++k) {
    for (size_t bi = 0; bi < bins[k].size(); ++bi) {  // bin grows during loop
      const int64_t v = bins[k][bi];
      if (removed[v] || d[v] > k) continue;
      removed[v] = 1;
      core[v] = k;
      maxcore = std::max(maxcore, k);
      for (int64_t u = 0; u < n; ++u) {
        if (u != v && a[v * n + u] && !removed[u]) {
          if (--d[u] <= k) bins[k].push_back(u);
          else bins[d[u]].push_back(u);
        }
      }
    }
  }
  return maxcore;
}

// Greedy clique heuristic: grow from each of the highest-core seeds.
std::vector<int64_t> greedy_heuristic(const BitGraph& g,
                                      const std::vector<int64_t>& core) {
  const int64_t n = g.n;
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int64_t x, int64_t y) { return core[x] > core[y]; });

  std::vector<int64_t> best;
  const int64_t seeds = std::min<int64_t>(n, 64);
  for (int64_t s = 0; s < seeds; ++s) {
    const int64_t v = order[s];
    if (core[v] + 1 <= static_cast<int64_t>(best.size())) break;
    std::vector<int64_t> clique{v};
    for (int64_t t = 0; t < n; ++t) {
      const int64_t u = order[t];
      if (u == v) continue;
      bool ok = true;
      for (int64_t w : clique)
        if (!g.connected(u, w)) { ok = false; break; }
      if (ok) clique.push_back(u);
    }
    if (clique.size() > best.size()) best = clique;
  }
  return best;
}

// Shared incumbent for the parallel exact search: workers bound against a
// lock-free size (monotone, so a stale read only weakens pruning, never
// correctness) and take the mutex only on an actual improvement.
struct Incumbent {
  std::mutex mu;
  std::vector<int64_t> best;
  std::atomic<int64_t> size{0};
  std::atomic<bool> timed_out{false};
  Clock::time_point deadline;

  explicit Incumbent(double time_limit_s)
      : deadline(Clock::now() +
                 std::chrono::duration_cast<Clock::duration>(
                     std::chrono::duration<double>(
                         time_limit_s > 0 ? time_limit_s : 1e9))) {}

  void seed(const std::vector<int64_t>& c) {
    best = c;
    size.store(static_cast<int64_t>(c.size()), std::memory_order_relaxed);
  }

  void offer(const std::vector<int64_t>& c) {
    std::lock_guard<std::mutex> lk(mu);
    if (c.size() > best.size()) {
      best = c;
      size.store(static_cast<int64_t>(c.size()), std::memory_order_relaxed);
    }
  }
};

// Exact branch & bound with greedy coloring upper bounds (per-worker state).
struct BnB {
  const BitGraph& g;
  Incumbent& inc;
  std::vector<int64_t> current;

  BnB(const BitGraph& g_, Incumbent& inc_) : g(g_), inc(inc_) {}

  // candidates sorted ascending by color bound; expand highest-bound last
  void expand(std::vector<int64_t>& cand) {
    if (Clock::now() > inc.deadline) {
      inc.timed_out.store(true, std::memory_order_relaxed);
      return;
    }
    // greedy coloring: assign each candidate the smallest color class whose
    // members it has no edge to; bound = current clique + color count
    const size_t nc = cand.size();
    std::vector<int64_t> color(nc);
    std::vector<std::vector<int64_t>> classes;
    for (size_t i = 0; i < nc; ++i) {
      const int64_t v = cand[i];
      size_t c = 0;
      for (; c < classes.size(); ++c) {
        bool clash = false;
        for (int64_t u : classes[c])
          if (g.connected(v, u)) { clash = true; break; }
        if (!clash) break;
      }
      if (c == classes.size()) classes.emplace_back();
      classes[c].push_back(v);
      color[i] = static_cast<int64_t>(c) + 1;
    }
    // order candidates by color (ascending); process from the back
    std::vector<int64_t> idx(nc);
    std::iota(idx.begin(), idx.end(), 0);
    std::sort(idx.begin(), idx.end(),
              [&](int64_t a, int64_t b) { return color[a] < color[b]; });
    std::vector<int64_t> ordered(nc), ocolor(nc);
    for (size_t i = 0; i < nc; ++i) {
      ordered[i] = cand[idx[i]];
      ocolor[i] = color[idx[i]];
    }

    for (int64_t i = static_cast<int64_t>(nc) - 1; i >= 0; --i) {
      if (inc.timed_out.load(std::memory_order_relaxed)) return;
      if (static_cast<int64_t>(current.size()) + ocolor[i] <=
          inc.size.load(std::memory_order_relaxed))
        return;  // bound: cannot beat incumbent
      const int64_t v = ordered[i];
      current.push_back(v);
      std::vector<int64_t> next;
      for (int64_t k = 0; k < i; ++k)
        if (g.connected(v, ordered[k])) next.push_back(ordered[k]);
      if (next.empty()) {
        if (static_cast<int64_t>(current.size()) >
            inc.size.load(std::memory_order_relaxed))
          inc.offer(current);
      } else {
        expand(next);
      }
      current.pop_back();
    }
  }
};

// Root coloring + ordering for the exact search (same greedy coloring the
// recursion uses, hoisted so root branches can be distributed over workers).
void color_order(const BitGraph& g, const std::vector<int64_t>& cand,
                 std::vector<int64_t>& ordered, std::vector<int64_t>& ocolor) {
  const size_t nc = cand.size();
  std::vector<int64_t> color(nc);
  std::vector<std::vector<int64_t>> classes;
  for (size_t i = 0; i < nc; ++i) {
    const int64_t v = cand[i];
    size_t c = 0;
    for (; c < classes.size(); ++c) {
      bool clash = false;
      for (int64_t u : classes[c])
        if (g.connected(v, u)) { clash = true; break; }
      if (!clash) break;
    }
    if (c == classes.size()) classes.emplace_back();
    classes[c].push_back(v);
    color[i] = static_cast<int64_t>(c) + 1;
  }
  std::vector<int64_t> idx(nc);
  std::iota(idx.begin(), idx.end(), 0);
  std::sort(idx.begin(), idx.end(),
            [&](int64_t a, int64_t b) { return color[a] < color[b]; });
  ordered.resize(nc);
  ocolor.resize(nc);
  for (size_t i = 0; i < nc; ++i) {
    ordered[i] = cand[idx[i]];
    ocolor[i] = color[idx[i]];
  }
}

// Parallel exact search: root branches taken descending (highest color bound
// first, matching the serial order) from an atomic counter by each worker.
// Colors ascend with the index, so once one root's bound fails every
// lower-index root fails too — `exhausted` stops all workers.
std::vector<int64_t> bnb_parallel(const BitGraph& g,
                                  const std::vector<int64_t>& cand,
                                  const std::vector<int64_t>& heu,
                                  double time_limit_s, int64_t threads) {
  Incumbent inc(time_limit_s);
  inc.seed(heu);
  std::vector<int64_t> ordered, ocolor;
  color_order(g, cand, ordered, ocolor);
  const int64_t nc = static_cast<int64_t>(ordered.size());

  std::atomic<int64_t> next{nc - 1};
  std::atomic<bool> exhausted{false};

  auto work = [&]() {
    BnB bnb(g, inc);
    while (!exhausted.load(std::memory_order_relaxed) &&
           !inc.timed_out.load(std::memory_order_relaxed)) {
      const int64_t i = next.fetch_sub(1, std::memory_order_relaxed);
      if (i < 0) break;
      if (ocolor[i] <= inc.size.load(std::memory_order_relaxed)) {
        exhausted.store(true, std::memory_order_relaxed);
        break;
      }
      const int64_t v = ordered[i];
      bnb.current.assign(1, v);
      std::vector<int64_t> sub;
      for (int64_t k = 0; k < i; ++k)
        if (g.connected(v, ordered[k])) sub.push_back(ordered[k]);
      if (sub.empty()) {
        if (1 > inc.size.load(std::memory_order_relaxed)) inc.offer(bnb.current);
      } else {
        bnb.expand(sub);
      }
    }
  };

  const int64_t hw = std::max(1u, std::thread::hardware_concurrency());
  const int64_t T = std::max<int64_t>(1, std::min(threads, hw));
  if (T == 1 || nc <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(T);
    for (int64_t t = 0; t < T; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return inc.best;
}

}  // namespace

extern "C" {

int64_t mc_core_numbers(int64_t n, const uint8_t* adj, int64_t* out_core) {
  std::vector<int64_t> core;
  const int64_t maxcore = core_numbers(n, adj, core);
  std::copy(core.begin(), core.end(), out_core);
  return maxcore;
}

int64_t mc_solve(int64_t n, const uint8_t* adj, int64_t method,
                 double time_limit_s, int64_t threads, int64_t* out_nodes) {
  std::vector<int64_t> core;
  const int64_t maxcore = core_numbers(n, adj, core);

  if (method == 2) {  // KCORE: vertices with core number >= max core
    int64_t num = 0;
    for (int64_t v = 0; v < n; ++v)
      if (core[v] >= maxcore) out_nodes[num++] = v;
    return num;
  }

  BitGraph g(n, adj);
  std::vector<int64_t> heu = greedy_heuristic(g, core);

  if (method == 1 ||  // HEU only
      static_cast<int64_t>(heu.size()) == maxcore + 1) {  // heu hit the ub
    std::sort(heu.begin(), heu.end());
    std::copy(heu.begin(), heu.end(), out_nodes);
    return static_cast<int64_t>(heu.size());
  }

  // EXACT: k-core prune to vertices that could extend past the incumbent,
  // then parallel coloring branch & bound
  std::vector<int64_t> cand;
  for (int64_t v = 0; v < n; ++v)
    if (core[v] + 1 > static_cast<int64_t>(heu.size())) cand.push_back(v);
  std::vector<int64_t> best = heu;
  if (!cand.empty())
    best = bnb_parallel(g, cand, heu, time_limit_s, threads);

  std::sort(best.begin(), best.end());
  std::copy(best.begin(), best.end(), out_nodes);
  return static_cast<int64_t>(best.size());
}

}  // extern "C"
