"""Faults planted in the 2D sharded engine, to see ``correct`` come out
false in the cell ``bunny.sharded_m262144``.

Each is a context manager that swaps one function of the program for a
broken one on this rank and puts it back on the way out; every rank
enters it alike. ``control_sharded.py --faults`` reads them on the cards
at the cell's own size, and ``tests/kinds/sharded2d_fault.py`` plants
them in the CPU tests. The faults:

- ``offset``: rank 1 builds its block at the wrong place, the next
  block-row's ((ri + 1) mod R, ci), so that one block of M is another
  block's, and the ranks still agree on everything they exchange;
- ``truncate``: the solve is cut short, one gradient step for each
  value of the homotopy's penalty where the solver takes up to 200 (at
  the cell's size such a solve still reaches the program's cluster);
- ``state``: the solve stops at its first step, at the first value of
  the penalty (``faults.py``'s ``state``), so each answer is about its
  init.
"""

from __future__ import annotations

import dataclasses

from benchmark.faults import _swap

FAULTS = ("offset", "truncate", "state")


def offset(rank: int):
    from clipper_tpu_torch.parallel import sharded

    def build(real):
        def wrong(invariant, P1, P2, A, m_true, mr, mc, affinityeps,
                  storage_dtype, ri, ci, *args, **kw):
            if rank == 1:
                ri = (ri + 1) % (P1.shape[0] // mr)
            return real(invariant, P1, P2, A, m_true, mr, mc, affinityeps,
                        storage_dtype, ri, ci, *args, **kw)
        return wrong

    return _swap(sharded, "_affinity_block_stored", build)


def _flat_params(**changes):
    from clipper_tpu_torch.parallel import sharded

    def short(real):
        def solve(mv, u0, params, *args, **kw):
            return real(mv, u0, dataclasses.replace(params, **changes),
                        *args, **kw)
        return solve

    return _swap(sharded, "_solve_flat", short)


def truncate(rank: int):
    return _flat_params(maxiniters=1)


def state(rank: int):
    return _flat_params(maxiniters=0, maxoliters=1)


def plant(name: str, rank: int):
    """The context manager of fault ``name`` (one of FAULTS) on ``rank``."""
    return {"offset": offset, "truncate": truncate,
            "state": state}[name](rank)
