"""The least time of the 2D sharded engine's work on one H100, per rank.

A rank of an (R, C) mesh holds the stacked (2 m/R, m/C) [M; C] block of
its problem in the storage dtype (``item`` bytes an entry; int8: 1). The
counts come from the traffic's m, mesh and storage, not from the
program, so the yardstick reads the same work whatever implements it;
the peaks are ``roofline.py``'s (HBM 3.35 TB/s, float32 67 TFLOP/s):

- a block matvec reads the stored block once: 2 (m/R)(m/C) item bytes;
- a block build writes it once, and scores its (m/R)(m/C) pairs at
  ``roofline.OPS_PER_PAIR`` float32 operations each: the larger of the
  two times.

Neither can be beaten without skipping work, so a share of either
cannot pass 100%.
"""

from __future__ import annotations

from benchmark import roofline

ITEM = {"int8": 1, "bfloat16": 2, "float32": 4, "float64": 8}


def block_pairs(m: int, R: int, C: int) -> int:
    """Entries of one rank's M block: (m/R)(m/C), m padded as the engine
    pads it to a multiple of R and C."""
    return -(-m // R) * -(-m // C)


def block_matvec(m: int, R: int, C: int, storage: str) -> float:
    """Seconds of one block matvec at the bound: the stored [M; C] block
    read once."""
    n_bytes = 2 * block_pairs(m, R, C) * ITEM[storage]
    return roofline.bound_s(n_bytes, 0, roofline.F32_FLOPS)


def block_build(m: int, R: int, C: int, storage: str) -> float:
    """Seconds of one rank's block build at the bound: the block written
    once, or its pairs' scores at the float32 peak, whichever is longer."""
    pairs = block_pairs(m, R, C)
    return roofline.bound_s(2 * pairs * ITEM[storage],
                            pairs * roofline.OPS_PER_PAIR,
                            roofline.F32_FLOPS)
