"""k-core decomposition by iterative peeling, on the device.

Counterpart of ``clipper_tpu/ops/kcore.py``. The reference's KCORE
max-clique method keeps the vertices whose core number reaches the maximum
core (reference: src/maxclique.cpp:89-100, via PMC). Each step either
removes every live vertex of degree <= k or advances k, so the peel ends
within 2n + max degree steps; the JAX ``while_loop`` is a host loop here
that reads "any vertex alive" once every few steps (a step after the last
vertex is gone changes no core number). Degrees are exact integer counts
(a masked bool sum), on whatever device the adjacency lives.
"""

from __future__ import annotations

from typing import Tuple

import torch

from clipper_tpu_torch.types import resolve_device

_ALIVE_EVERY = 8    # steps between reads of "any vertex alive"


def _adjacency(adj, device) -> torch.Tensor:
    """(n, n) bool adjacency without its diagonal. A tensor stays on its
    device unless ``device`` is given; numpy input goes to ``device``
    ("cuda" when None; raises when CUDA is missing)."""
    if isinstance(adj, torch.Tensor):
        dev = adj.device if device is None else resolve_device(device)
    else:
        dev = resolve_device("cuda" if device is None else device)
    a = torch.as_tensor(adj, device=dev) != 0
    return a & ~torch.eye(a.shape[0], dtype=torch.bool, device=dev)


def core_numbers(adj, device=None) -> torch.Tensor:
    """Core number (int32) of every vertex of the (n, n) adjacency (nonzero
    = edge, diagonal ignored)."""
    a = _adjacency(adj, device)
    n = a.shape[0]
    core = torch.zeros(n, dtype=torch.int32, device=a.device)
    alive = torch.ones(n, dtype=torch.bool, device=a.device)
    k = torch.zeros((), dtype=torch.int32, device=a.device)
    while bool(alive.any()):
        for _ in range(_ALIVE_EVERY):
            deg = (a & alive[None, :]).sum(1)
            peel = alive & (deg <= k)
            core = torch.where(peel, k, core)
            alive = alive & ~peel
            k = torch.where(peel.any(), k, k + 1)
    return core


def kcore_prune_mask(adj, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask of the vertices with core >= max core, max core)."""
    core = core_numbers(adj, device)
    maxcore = core.max()
    return core >= maxcore, maxcore
