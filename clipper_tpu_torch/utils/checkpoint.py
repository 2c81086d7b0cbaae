"""Solution and solver-state checkpoint/resume.

Counterpart of ``clipper_tpu/utils/checkpoint.py``, in the same ``.npz``
format with the same field names, so a file either package saved loads
in the other. The reference's nearest concept is warm-starting: solve(u0)
accepts an initial iterate and Solution retains u0/u (reference:
include/clipper/clipper.h:102,70-71).

Two levels:
  * Solution save/load: final results only. Re-solving from a saved
    Solution's u is a WARM START, not a resume: the homotopy penalty d and
    the line-search alpha are re-derived from u.
  * Solver-state save/load: the flat solver's full carry
    (msrc_flat._FlatState: u, gradF, F, d, alpha, loop counters, single
    lane or batched). Drive a long solve in chunks with
    msrc_flat.flat_solve_ticks, checkpoint the carry between chunks, and a
    resume reproduces the uninterrupted trajectory bit for bit (with the
    same tick options). Dtypes are kept exactly: an f64 carry loads as
    f64, whatever torch's default dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from clipper_tpu_torch.types import Solution, resolve_device


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def save_solution(path, soln: Solution) -> None:
    np.savez(path, ifinal=_host(soln.ifinal), mask=_host(soln.mask),
             u0=_host(soln.u0), u=_host(soln.u), score=_host(soln.score),
             t=np.asarray(soln.t))


def load_solution(path, device="cuda") -> Solution:
    dev = resolve_device(device)
    with np.load(path) as z:
        return Solution(ifinal=_tensor(z["ifinal"], dev),
                        mask=_tensor(z["mask"], dev),
                        u0=_tensor(z["u0"], dev), u=_tensor(z["u"], dev),
                        score=_tensor(z["score"], dev), t=float(z["t"]))


def save_solver_state(path, state) -> None:
    """Checkpoint a flat-solver carry (msrc_flat._FlatState, possibly
    batched) to ``path`` (.npz); see the module docstring."""
    np.savez(path, **{k: _host(v) for k, v in zip(state._fields, state)})


def load_solver_state(path, device="cuda"):
    """Load a carry saved by :func:`save_solver_state` (by either package)
    onto ``device``, every array's dtype kept exactly."""
    from clipper_tpu_torch.solvers.msrc_flat import _FlatState

    dev = resolve_device(device)
    with np.load(path) as z:
        return _FlatState(**{k: _tensor(z[k], dev)
                             for k in _FlatState._fields})
