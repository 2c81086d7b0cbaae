// Exact densest edge-weighted subgraph via Goldberg's flow-based algorithm.
//
// Host-side C++ component of clipper_tpu_torch, the port's own copy of
// clipper_tpu/native/dsd.cpp (same code and C ABI): the max-flow binary
// search is an inherently sequential combinatorial algorithm, so it runs on
// the host (used for DSD rounding and cross-checks) while the solver runs
// on the card.
//
// Algorithm (semantics match reference src/dsd.cpp:18-270, implementation is
// our own):
//   maximize w(S') / |S'| over vertex subsets S' of the given support S.
//   Binary search on the density guess g with termination
//   n(n-1)(U-L) < 1; each step answers "is there a subgraph of density > g"
//   with one s-t min-cut on the standard Goldberg gadget:
//     source -> v   with capacity m/2              (m = #directed edges)
//     v -> sink     with capacity m/2 + 2g - deg(v)
//     u -> v        with capacity w(u,v) for every directed edge
//   If the source-side cut contains only the source, density <= g.
//
// Max-flow: iterative Dinic (BFS level graph + current-arc DFS augmentation).
//
// C ABI for ctypes:
//   dsd_solve(n, nS, S, W, out_nodes, out_len) -> density
//     W: row-major n*n symmetric nonneg weight matrix (diagonal ignored)
//     S: nS vertex indices to restrict to (the induced subgraph support)
//     out_nodes: caller-allocated int64[n]; out_len: number written

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <vector>

namespace {

struct Dinic {
  struct Arc { int32_t to; double cap; int32_t next; };
  std::vector<Arc> arcs;
  std::vector<int32_t> head;   // head[v] = first arc index or -1
  std::vector<int32_t> level;
  std::vector<int32_t> iter;   // current-arc pointer per vertex
  int32_t n;

  explicit Dinic(int32_t nverts) : head(nverts, -1), level(nverts),
                                   iter(nverts), n(nverts) {}

  void add_arc(int32_t u, int32_t v, double cap) {
    arcs.push_back({v, cap, head[u]});
    head[u] = static_cast<int32_t>(arcs.size()) - 1;
    arcs.push_back({u, 0.0, head[v]});
    head[v] = static_cast<int32_t>(arcs.size()) - 1;
  }

  bool bfs(int32_t s, int32_t t) {
    std::fill(level.begin(), level.end(), -1);
    std::vector<int32_t> q;
    q.reserve(n);
    level[s] = 0;
    q.push_back(s);
    for (size_t qi = 0; qi < q.size(); ++qi) {
      int32_t u = q[qi];
      for (int32_t e = head[u]; e >= 0; e = arcs[e].next) {
        if (arcs[e].cap > 1e-12 && level[arcs[e].to] < 0) {
          level[arcs[e].to] = level[u] + 1;
          q.push_back(arcs[e].to);
        }
      }
    }
    return level[t] >= 0;
  }

  // iterative DFS augmentation along the level graph
  double augment(int32_t s, int32_t t) {
    std::vector<int32_t> path_arcs;  // arcs along current path
    std::vector<int32_t> stack{s};
    while (!stack.empty()) {
      int32_t u = stack.back();
      if (u == t) {
        double f = 1e300;
        for (int32_t e : path_arcs) f = std::min(f, arcs[e].cap);
        for (int32_t e : path_arcs) {
          arcs[e].cap -= f;
          arcs[e ^ 1].cap += f;
        }
        return f;
      }
      bool advanced = false;
      for (int32_t& e = iter[u]; e >= 0; e = arcs[e].next) {
        if (arcs[e].cap > 1e-12 && level[arcs[e].to] == level[u] + 1) {
          stack.push_back(arcs[e].to);
          path_arcs.push_back(e);
          advanced = true;
          break;
        }
      }
      if (!advanced) {
        level[u] = -1;  // dead end; prune
        stack.pop_back();
        if (!path_arcs.empty()) path_arcs.pop_back();
      }
    }
    return 0.0;
  }

  double max_flow(int32_t s, int32_t t) {
    double flow = 0.0;
    while (bfs(s, t)) {
      for (int32_t v = 0; v < n; ++v) iter[v] = head[v];
      double f;
      while ((f = augment(s, t)) > 0.0) flow += f;
    }
    return flow;
  }

  // vertices reachable from s in the residual graph (the source-side cut)
  void min_cut(int32_t s, std::vector<uint8_t>& cut) {
    cut.assign(n, 0);
    std::vector<int32_t> q{s};
    cut[s] = 1;
    for (size_t qi = 0; qi < q.size(); ++qi) {
      int32_t u = q[qi];
      for (int32_t e = head[u]; e >= 0; e = arcs[e].next) {
        if (arcs[e].cap > 1e-12 && !cut[arcs[e].to]) {
          cut[arcs[e].to] = 1;
          q.push_back(arcs[e].to);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

double dsd_solve(int64_t n, int64_t nS, const int64_t* S, const double* W,
                 int64_t* out_nodes, int64_t* out_len) {
  // directed edge list over the support (both orientations, diagonal skipped),
  // zero-weight pairs included — they count toward m and the gadget caps,
  // matching reference src/dsd.cpp:286-308.
  const int64_t m = nS * nS - nS;  // number of directed edges
  std::vector<double> degree(n, 0.0);
  for (int64_t a = 0; a < nS; ++a) {
    for (int64_t b = 0; b < nS; ++b) {
      if (a == b) continue;
      const int64_t i = S[a], j = S[b];
      degree[i] += W[i * n + j];
    }
  }

  const double cap_src = static_cast<double>(m) / 2.0;
  const int32_t nverts = static_cast<int32_t>(n) + 2;
  const int32_t src = 0, dst = nverts - 1;

  double L = 0.0, U = cap_src;
  std::vector<uint8_t> cut, final_cut(nverts, 0);

  while (static_cast<double>(n) * static_cast<double>(n - 1) * (U - L) >= 1.0) {
    const double g = (U + L) / 2.0;

    Dinic dinic(nverts);
    dinic.arcs.reserve(2 * (m + 2 * n));
    for (int64_t a = 0; a < nS; ++a) {
      for (int64_t b = 0; b < nS; ++b) {
        if (a == b) continue;
        const int64_t i = S[a], j = S[b];
        dinic.add_arc(static_cast<int32_t>(i) + 1,
                      static_cast<int32_t>(j) + 1, W[i * n + j]);
      }
    }
    for (int64_t v = 0; v < n; ++v) {
      dinic.add_arc(src, static_cast<int32_t>(v) + 1, cap_src);
      dinic.add_arc(static_cast<int32_t>(v) + 1, dst,
                    cap_src + 2.0 * g - degree[v]);
    }

    dinic.max_flow(src, dst);
    dinic.min_cut(src, cut);

    int64_t cut_size = 0;
    for (uint8_t c : cut) cut_size += c;
    if (cut_size == 1) {
      U = g;  // only the source: no subgraph denser than g
    } else {
      L = g;
      final_cut = cut;
    }
  }

  int64_t num = 0;
  double weight = 0.0;
  for (int64_t v = 0; v < n; ++v) {
    if (final_cut[v + 1]) {
      out_nodes[num++] = v;
    }
  }
  for (int64_t a = 0; a < num; ++a) {
    for (int64_t b = 0; b < num; ++b) {
      if (a != b) weight += W[out_nodes[a] * n + out_nodes[b]];
    }
  }
  *out_len = num;
  return (num > 0) ? weight / (2.0 * static_cast<double>(num)) : 0.0;
}

}  // extern "C"
