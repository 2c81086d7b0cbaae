"""DSD: the exact densest edge-weighted subgraph (Goldberg's algorithm).

Counterpart of ``clipper_tpu/solvers/dsd.py``: DSD rounding of the MSRC
solution and an exact cross-check (reference: include/clipper/dsd.h:25-56,
src/dsd.cpp:274-320). The max-flow binary search is sequential and
combinatorial, so it runs on the host in C++ (the port's
``native/dsd.cpp``, loaded by ``native/build.py``). :func:`_solve_python`
is the same algorithm in Python, the plain version the tests hold the
native code to.

The search stops when n (n - 1) (U - L) < 1, n being the order of the
matrix it gets. The facade hands it the (|S|, |S|) block of the support
gathered on the device, where the JAX package's dense path hands it the
whole (m, m) M with S: the tolerance is then 1/(|S| (|S| - 1)), not
1/(m (m - 1)), and the node sets differ only where the densest subgraph's
density lies within that of the next breakpoint of the parametric cut.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from clipper_tpu_torch.native import build as native_build


def _host_f64(A) -> np.ndarray:
    if isinstance(A, torch.Tensor):
        A = A.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(np.asarray(A, dtype=np.float64))


def solve(A, S: Optional[Sequence[int]] = None) -> List[int]:
    """Densest edge-weighted subgraph of the weighted adjacency A: maximize
    w(S') / |S'|, optionally over subsets of the support S (reference:
    src/dsd.cpp:274-320). A (numpy, or a tensor on any device) is read as
    symmetric from its strict upper triangle (reference: src/dsd.cpp:305);
    the diagonal is ignored. Returns the sorted vertex indices."""
    A = _host_f64(A)
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError(f"A must be square; got {A.shape}")
    W = np.triu(A, k=1)
    W = np.ascontiguousarray(W + W.T)
    if S is None or len(S) == 0:
        S = np.arange(n, dtype=np.int64)
    else:
        S = np.asarray(sorted(S), dtype=np.int64)
    return _solve_native(native_build.load(), n, S, W)


def _solve_native(lib: ctypes.CDLL, n: int, S: np.ndarray,
                  W: np.ndarray) -> List[int]:
    S = np.ascontiguousarray(S, dtype=np.int64)
    W = np.ascontiguousarray(W, dtype=np.float64)
    out_nodes = np.zeros(n, dtype=np.int64)
    out_len = ctypes.c_int64(0)
    lib.dsd_solve(
        n, len(S),
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        W.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(out_len))
    return sorted(int(v) for v in out_nodes[: out_len.value])


# ----------------------------------------------------------------------------
# the plain version (the same algorithm; small graphs, tests)
# ----------------------------------------------------------------------------


class _Dinic:
    def __init__(self, n: int):
        self.n = n
        self.to: List[int] = []
        self.cap: List[float] = []
        self.nxt: List[int] = []
        self.head = [-1] * n

    def add_arc(self, u: int, v: int, c: float):
        for (a, b, cc) in ((u, v, c), (v, u, 0.0)):
            self.to.append(b)
            self.cap.append(cc)
            self.nxt.append(self.head[a])
            self.head[a] = len(self.to) - 1

    def bfs(self, s: int, t: int) -> bool:
        self.level = [-1] * self.n
        self.level[s] = 0
        q = [s]
        for u in q:
            e = self.head[u]
            while e >= 0:
                if self.cap[e] > 1e-12 and self.level[self.to[e]] < 0:
                    self.level[self.to[e]] = self.level[u] + 1
                    q.append(self.to[e])
                e = self.nxt[e]
        return self.level[t] >= 0

    def dfs(self, u: int, t: int, f: float) -> float:
        if u == t:
            return f
        while self.it[u] >= 0:
            e = self.it[u]
            v = self.to[e]
            if self.cap[e] > 1e-12 and self.level[v] == self.level[u] + 1:
                d = self.dfs(v, t, min(f, self.cap[e]))
                if d > 0:
                    self.cap[e] -= d
                    self.cap[e ^ 1] += d
                    return d
            self.it[u] = self.nxt[e]
        return 0.0

    def max_flow(self, s: int, t: int) -> float:
        flow = 0.0
        while self.bfs(s, t):
            self.it = list(self.head)
            while True:
                f = self.dfs(s, t, float("inf"))
                if f <= 0:
                    break
                flow += f
        return flow

    def min_cut(self, s: int) -> np.ndarray:
        cut = np.zeros(self.n, dtype=bool)
        cut[s] = True
        q = [s]
        for u in q:
            e = self.head[u]
            while e >= 0:
                if self.cap[e] > 1e-12 and not cut[self.to[e]]:
                    cut[self.to[e]] = True
                    q.append(self.to[e])
                e = self.nxt[e]
        return cut


def _solve_python(n: int, S: np.ndarray, W: np.ndarray) -> List[int]:
    nS = len(S)
    m = nS * nS - nS  # directed edge count, zero-weight pairs included
    degree = np.zeros(n)
    WS = W[np.ix_(S, S)]
    degree[S] = WS.sum(axis=1)

    cap_src = m / 2.0
    nverts = n + 2
    src, dst = 0, nverts - 1

    L, U = 0.0, cap_src
    final_cut = np.zeros(nverts, dtype=bool)

    while n * (n - 1) * (U - L) >= 1.0:
        g = (U + L) / 2.0
        din = _Dinic(nverts)
        for a in range(nS):
            for b in range(nS):
                if a == b:
                    continue
                din.add_arc(int(S[a]) + 1, int(S[b]) + 1, float(W[S[a], S[b]]))
        for v in range(n):
            din.add_arc(src, v + 1, cap_src)
            din.add_arc(v + 1, dst, cap_src + 2.0 * g - degree[v])
        din.max_flow(src, dst)
        cut = din.min_cut(src)
        if cut.sum() == 1:
            U = g
        else:
            L = g
            final_cut = cut
    return sorted(int(v) - 1 for v in np.flatnonzero(final_cut) if 1 <= v <= n)
