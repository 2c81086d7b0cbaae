"""Maximum-clique solver (exact, heuristic, k-core).

Counterpart of ``clipper_tpu/solvers/maxclique.py`` with the reference's
method surface (reference: include/clipper/maxclique.h:15-25,
src/maxclique.cpp:47-147, which wraps the PMC library):

  EXACT  — k-core prune + greedy-coloring branch & bound ("ROBIN*")
  HEU    — k-core-ordered greedy clique lower bound ("ROBIN" heuristic)
  KCORE  — vertices with core number >= max core ("ROBIN")

The search is sequential and combinatorial, so it runs on the host in C++
(the port's ``native/maxclique.cpp``; the exact search's top-level branches
spread over ``threads`` std::threads sharing an atomic incumbent). The
k-core numbers are also a PyTorch op on the device (ops/kcore.py).
:func:`_solve_python` and :func:`_core_numbers_python` are the plain
versions the tests hold the native code to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
from typing import List

import numpy as np
import torch

from clipper_tpu_torch.native import build as native_build


class Method(enum.IntEnum):
    EXACT = 0
    HEU = 1
    KCORE = 2


@dataclasses.dataclass(frozen=True)
class Params:
    """reference: include/clipper/maxclique.h:17-23 (same defaults)."""

    method: Method = Method.EXACT
    threads: int = 24           # workers for the parallel exact B&B
    time_limit: int = 3600      # [s] cap on exact search
    verbose: bool = False


def _adjacency(A) -> np.ndarray:
    """(n, n) uint8 host adjacency: nonzero = edge, diagonal cleared."""
    if isinstance(A, torch.Tensor):
        A = (A != 0).cpu().numpy()
    adj = np.ascontiguousarray(np.asarray(A) != 0, dtype=np.uint8)
    np.fill_diagonal(adj, 0)
    return adj


def solve(A, params: Params = Params()) -> List[int]:
    """Max clique of the adjacency A (numpy or a tensor on any device;
    nonzero = edge, diagonal ignored). Returns sorted vertex indices."""
    adj = _adjacency(A)
    n = adj.shape[0]
    out = np.zeros(n, dtype=np.int64)
    num = native_build.load().mc_solve(
        n, adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(params.method), float(params.time_limit),
        max(1, int(params.threads)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return sorted(int(v) for v in out[:num])


def core_numbers(A) -> np.ndarray:
    """Core number of every vertex, on the host (the native library)."""
    adj = _adjacency(A)
    n = adj.shape[0]
    core = np.zeros(n, dtype=np.int64)
    native_build.load().mc_core_numbers(
        n, adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        core.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return core


# ----------------------------------------------------------------------------
# the plain versions
# ----------------------------------------------------------------------------


def _core_numbers_python(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    deg = adj.sum(1).astype(np.int64)
    core = np.zeros(n, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    k = 0
    while alive.any():
        peel = alive & (deg <= k)
        if not peel.any():
            k += 1
            continue
        core[peel] = k
        alive &= ~peel
        deg = (adj * alive[None, :]).sum(1)
    return core


def _solve_python(adj: np.ndarray, params: Params) -> List[int]:
    n = adj.shape[0]
    core = _core_numbers_python(adj)
    maxcore = core.max() if n else 0
    if params.method == Method.KCORE:
        return sorted(np.flatnonzero(core >= maxcore))

    # greedy heuristic
    order = np.argsort(-core, kind="stable")
    best: List[int] = []
    for s in order[: min(n, 64)]:
        if core[s] + 1 <= len(best):
            break
        clique = [int(s)]
        for u in order:
            if u == s:
                continue
            if all(adj[u, w] for w in clique):
                clique.append(int(u))
        if len(clique) > len(best):
            best = clique
    if params.method == Method.HEU:
        return sorted(best)

    if n > 128:
        raise RuntimeError("the plain exact max clique is limited to "
                           "n <= 128")

    # simple exact B&B with coloring bound
    def expand(cand: List[int], current: List[int]):
        nonlocal best
        if not cand:
            if len(current) > len(best):
                best = list(current)
            return
        # greedy coloring bound
        classes: List[List[int]] = []
        color = {}
        for v in cand:
            for ci, cl in enumerate(classes):
                if not any(adj[v, u] for u in cl):
                    cl.append(v)
                    color[v] = ci + 1
                    break
            else:
                classes.append([v])
                color[v] = len(classes)
        ordered = sorted(cand, key=lambda v: color[v])
        for i in range(len(ordered) - 1, -1, -1):
            v = ordered[i]
            if len(current) + color[v] <= len(best):
                return
            nxt = [u for u in ordered[:i] if adj[v, u]]
            expand(nxt, current + [v])

    cand = [int(v) for v in range(n) if core[v] + 1 > len(best)]
    expand(cand, [])
    return sorted(best)
