"""Faults planted under the timed path, to see ``correct`` come out false.

Each is a context manager that swaps one function of the program for a
broken one and puts it back on the way out. The CPU tests drive a run
with each of them (``tests/test_e2e_faults.py``); ``control.py
--faults`` reads them on the card at a cell's own size. The faults a
cell of this benchmark can have (a facade request holds one problem on
one card, so no half of a batch and no exchange between cards can be
left out):

- ``state``: the solver's step returns its state unchanged (the dense
  PGA runs no step), so each answer is its init;
- ``truncate``: the solve is cut short, one gradient step for each
  value of the homotopy's penalty where the solver takes up to 200, so
  its u has a consistent support that the solver has not climbed;
- ``alter``: each mask is altered where it is produced (the rounding
  flips vertex 0).
"""

from __future__ import annotations

import contextlib
import dataclasses

FAULTS = ("state", "truncate", "alter")


@contextlib.contextmanager
def _swap(module, name: str, fn):
    real = getattr(module, name)
    setattr(module, name, fn(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _dense_params(**changes):
    from clipper_tpu_torch.solvers import msrc

    def dense(real):
        def find_dense_clique(M, C, u0, params, **kw):
            return real(M, C, u0, dataclasses.replace(params, **changes),
                        **kw)
        return find_dense_clique

    return _swap(msrc, "find_dense_clique", dense)


def state():
    return _dense_params(maxiniters=0, maxoliters=1)


def truncate():
    return _dense_params(maxiniters=1)


@contextlib.contextmanager
def alter():
    from clipper_tpu_torch.solvers import msrc

    def rounding(real):
        def round_solution(u, F, *args, **kw):
            mask = real(u, F, *args, **kw).clone()
            mask[..., 0] = ~mask[..., 0]
            return mask
        return round_solution

    with _swap(msrc, "round_solution", rounding):
        yield


def plant(name: str):
    """The context manager of fault ``name`` (one of FAULTS)."""
    return {"state": state, "truncate": truncate, "alter": alter}[name]()
