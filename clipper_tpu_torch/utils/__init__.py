"""Utilities (reference: include/clipper/utils.h:30-163, src/utils.cpp:22-108).

Counterpart of ``clipper_tpu/utils/__init__.py``: explicit random
generators instead of std::random_device, closed-form index maps, and the
host-side selection helpers.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from clipper_tpu_torch.types import Solution


def randvec(generator: Optional[torch.Generator], n: int,
            dtype=torch.float64, device=None) -> torch.Tensor:
    """U[0, 1) random vector (reference: src/utils.cpp:22-29) drawn from an
    explicit ``torch.Generator`` on the generator's own device, then moved
    to ``device``: a CPU generator gives the same vector for every device.

    The draws cannot reproduce the JAX package's ``jax.random`` stream for
    the same seed; to compare the two packages, make u0 with numpy and hand
    it to both.
    """
    gen_dev = generator.device if generator is not None else "cpu"
    v = torch.rand(n, generator=generator, dtype=dtype, device=gen_dev)
    return v if device is None else v.to(device)


def k2ij(k, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Map flat strict-upper-triangle index k to (i, j), row-major.

    Closed form identical to the reference (reference: src/utils.cpp:87-97).
    Vectorized over k, on the host in int64/f64 so it stays exact for
    n >= 100k.
    """
    k = np.asarray(k, dtype=np.int64)
    kk = k + 1
    l = n * (n - 1) // 2 - kk
    o = np.floor((np.sqrt(1.0 + 8.0 * l.astype(np.float64)) - 1.0) / 2.0
                 ).astype(np.int64)
    p = l - o * (o + 1) // 2
    i = n - (o + 1)
    j = n - p
    return i - 1, j - 1


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def find_indices_of_k_largest(x, k: int) -> List[int]:
    """Indices of the k largest entries, largest first
    (reference: src/utils.cpp:33-55)."""
    x = _host(x)
    if k < 1:
        return []
    k = min(k, x.shape[0])
    idx = np.argpartition(-x, k - 1)[:k]
    return list(idx[np.argsort(-x[idx])])


def find_indices_where_above_threshold(x, thr: float) -> List[int]:
    """reference: src/utils.cpp:59-68."""
    return list(np.flatnonzero(_host(x) > thr))


def select_from_indicator(x, ind) -> np.ndarray:
    """Entries of x where indicator is nonzero (reference: src/utils.cpp:72-83)."""
    return _host(x)[_host(ind) != 0]


def select_inlier_associations(soln: Solution, A) -> np.ndarray:
    """Rows of A at the solution's selected nodes (reference: src/utils.cpp:101-108)."""
    return _host(A)[soln.nodes]


class Timer:
    """Named start/stop accumulator (reference: include/clipper/utils.h:107-163)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self._t0 = None
        self.elapsed = 0.0
        self.count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            return self.elapsed
        dt = time.perf_counter() - self._t0
        self.elapsed += dt
        self.count += 1
        self._t0 = None
        return dt

    def get_elapsed_seconds(self) -> float:
        return self.elapsed

    def __add__(self, other: "Timer") -> "Timer":
        t = Timer(self.name or other.name)
        t.elapsed = self.elapsed + other.elapsed
        t.count = self.count + other.count
        return t

    def __repr__(self):
        avg = self.elapsed / self.count if self.count else 0.0
        return (f"Timer({self.name!r}: total={self.elapsed:.6f}s "
                f"count={self.count} avg={avg:.6f}s)")
