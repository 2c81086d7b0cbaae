"""Core types: the parameter and solution surface of the reference.

Counterpart of ``clipper_tpu/types.py`` (reference:
include/clipper/clipper.h:27-73) with the same names and defaults.
``Solution`` holds torch tensors; batched pipelines return one Solution
whose fields carry a leading problem dimension.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Rounding(enum.IntEnum):
    """Rounding strategies for extracting an inlier set from the solved u.

    reference: include/clipper/clipper.h:50-59
    """

    NONZERO = 0
    DSD = 1
    DSD_HEU = 2


@dataclasses.dataclass(frozen=True)
class Params:
    """Core MSRC solver parameters (reference: include/clipper/clipper.h:27-60)."""

    tol_u: float = 1e-8          # stop when change in u < tol
    tol_F: float = 1e-9          # stop when change in F < tol
    tol_Fop: float = 1e-10       # (kept for API parity; unused, as in reference)
    maxiniters: int = 200        # max gradient-ascent steps per d
    maxoliters: int = 1000       # max outer (homotopy) iterations
    beta: float = 0.25           # backtracking step-size reduction, in (0,1)
    maxlsiters: int = 99         # max line-search iterations per grad step
    eps: float = 1e-9            # numerical threshold around 0
    affinityeps: float = 1e-4    # sparsity-promoting threshold for affinities
    rescale_u0: bool = True      # rescale u0 with one power-iteration step
    rounding: Rounding = Rounding.DSD_HEU


@dataclasses.dataclass
class Solution:
    """Result of a dense-clique solve (reference: clipper.h:65-73).

    ``mask`` is a fixed-size boolean over the m graph vertices; ``nodes``
    derives the selected indices on the host.
    """

    ifinal: torch.Tensor   # () or (W,) int32 — outer iterations run
    mask: torch.Tensor     # (m,) or (W, m) bool — selected vertices
    u0: torch.Tensor       # initial iterate
    u: torch.Tensor        # final characteristic vector
    score: torch.Tensor    # objective value F
    t: float = 0.0

    @property
    def nodes(self) -> np.ndarray:
        """Indices of selected graph vertices (host-side, ascending)."""
        return np.flatnonzero(self.mask.cpu().numpy())


def as_association(A, device=None) -> torch.Tensor:
    """Coerce to an (m, 2) int32 association tensor."""
    A = torch.as_tensor(A, device=device).to(torch.int32)
    if A.dim() != 2 or A.shape[1] != 2:
        raise ValueError(f"Association must be (m, 2); got {tuple(A.shape)}")
    return A


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and missing (the port never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
