"""The pairwise scores of the upstream Euclidean invariant, in plain
PyTorch.

Written from the upstream definition (mit-acl/clipper
src/invariants/euclidean_distance.cpp:13-31) and the build's rules
(src/clipper.cpp:21-65): a pair of associations that shares an endpoint
in either dataset scores 0, and M keeps a score only strictly above
``affinityeps``; C is the 0/1 pattern of M. Everything is computed in the
dtype of the endpoints handed in (float64 for the judge), by direct
differences, with no kernel and nothing taken from the program.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _lengths(Xr: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """(r, c) Euclidean lengths between the rows of Xr (r, 3) and Xc
    (c, 3), by direct differences."""
    return torch.linalg.vector_norm(Xr[:, None, :] - Xc[None, :, :], dim=-1)


def _gauss(x: torch.Tensor, sigma: float) -> torch.Tensor:
    return torch.exp(-0.5 * x * x / (sigma * sigma))


def score_block(config: dict, P1r, P1c, P2r, P2c) -> torch.Tensor:
    """The invariant's (r, c) scores between rows (P1r, P2r) and columns
    (P1c, P2c) of gathered endpoints, before distinctness and
    ``affinityeps``. config: the configuration's ``invariant`` group."""
    kind = config["kind"]
    if kind == "euclidean":
        l1 = _lengths(P1r[:, :3], P1c[:, :3])
        l2 = _lengths(P2r[:, :3], P2c[:, :3])
        c = (l1 - l2).abs()
        s = torch.where(c < config["epsilon"], _gauss(c, config["sigma"]),
                        torch.zeros((), dtype=c.dtype, device=c.device))
        if config.get("mindist", 0.0) > 0:
            s = torch.where((l1 < config["mindist"])
                            | (l2 < config["mindist"]), 0.0, s)
        return s
    raise ValueError(f"unknown invariant {kind!r}")


def mc_block(config: dict, P1, P2, A, rows, affinityeps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, C) rows ``rows`` (a 1-D index tensor) against every column:
    P1, P2 (m, d) gathered endpoints, A (m, 2). M holds the kept scores
    (zero on the diagonal and for pairs that share an endpoint), C its
    0/1 pattern as bool."""
    Ar = A[rows]
    distinct = ((Ar[:, None, 0] != A[None, :, 0])
                & (Ar[:, None, 1] != A[None, :, 1]))
    s = score_block(config, P1[rows], P1, P2[rows], P2)
    keep = distinct & (s > affinityeps)
    return torch.where(keep, s, torch.zeros((), dtype=s.dtype,
                                            device=s.device)), keep


def block_rows(m: int, budget: int = 1 << 25) -> int:
    """Rows a block of an (m, m) reference may hold within ``budget``
    entries."""
    return max(1, min(m, budget // max(m, 1)))


def dense_mc(config: dict, P1, P2, A, affinityeps: float, dtype=None,
             budget: int = 1 << 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (m, m) M and C (C in M's dtype), built a block of rows at a
    time and stored in ``dtype`` (the endpoints' by default)."""
    m = A.shape[0]
    dtype = dtype or P1.dtype
    M = torch.empty((m, m), dtype=dtype, device=P1.device)
    C = torch.empty((m, m), dtype=dtype, device=P1.device)
    step = block_rows(m, budget)
    for s in range(0, m, step):
        rows = torch.arange(s, min(m, s + step), device=P1.device)
        Mb, Cb = mc_block(config, P1, P2, A, rows, affinityeps)
        M[s:s + len(rows)] = Mb.to(dtype)
        C[s:s + len(rows)] = Cb.to(dtype)
    return M, C
