"""Invariant protocol: vectorized geometric-consistency scoring.

Counterpart of ``clipper_tpu/invariants/base.py`` (reference:
include/clipper/invariants/abstract.h:56-72). An invariant is a callable on
tensors of endpoints with broadcasting,

    scores = invariant(ai, aj, bi, bj)   # (..., d) x4 -> (...)

and built-ins override :meth:`score_matrix` / :meth:`score_block` with
structured forms. Leading batch dimensions broadcast through every method.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

# a device score's kind in the build kernels' C interface (csrc/
# user_score.cuh: kUserKind; the built-ins are 0 and 1), and its widest d
# (kMaxUserD: kernel 8's sub-tile branch holds 80-byte records at d = 9 in
# a block's shared memory beside its bf16 stages)
USER_KIND = 2
MAX_USER_D = 9


class BuiltinScore(NamedTuple):
    """A built-in invariant's score in the build kernels' C interface:
    its kind (0 Euclidean, csrc/euclid_score.cuh; 1 point-normal,
    csrc/pointnormal_score.cuh), its width d and its four parameters
    (squares formed in double, as the plain versions form them)."""
    kind: int
    d: int
    params: Tuple[float, float, float, float]


class DeviceScore(NamedTuple):
    """An invariant's own score for the build kernels 2, 8, 4 and 6.

    ``source``: C++ text defining ``template <typename T> struct Score``
    (``static constexpr int D``, ``using Value = T``, a constructor from
    ``const double (&)[4]``, ``operator()(r1, c1, r2, c2)`` over D values
    each, and optionally ``screen`` / ``gate`` / ``tail`` and
    ``kExactScreen``), as csrc/user_score.cuh states; ``d``: the endpoint
    width, 1 <= d <= MAX_USER_D, equal to its D; ``params``: up to four
    numbers, handed to the constructor as doubles. The library of the four
    builds over it is compiled at first use on the card
    (``_kernels.user_lib``); its codes are the invariant's plain version's
    where the source repeats that arithmetic step by step."""
    source: str
    d: int
    params: Tuple[float, ...] = ()

    @property
    def kind(self) -> int:
        return USER_KIND


Score = Union[BuiltinScore, DeviceScore]


class PairwiseInvariant:
    """Base class for pairwise geometric invariants.

    ``symmetric``: True when score(i, j) == score(j, i) exactly; symmetric
    invariants allow the one-pass (no upper-triangle mirror) builds.

    :meth:`cuda_score` says how the build kernels compute the invariant on
    the card: None (the default) for none, so that it builds through its
    plain version (on the card too, under ``build="auto"``), as a JAX
    invariant without ``score_block_t`` gets no Pallas build. A subclass
    inherits its parent's device score unless it overrides the method.
    """

    symmetric: bool = False

    def cuda_score(self) -> Optional[Score]:
        """The invariant's score in the build kernels: a
        :class:`BuiltinScore` (the built-ins), a :class:`DeviceScore`
        (an invariant's own C++ score), or None."""
        return None

    def __call__(self, ai, aj, bi, bj):
        """Score consistency of associations (ai->bi) and (aj->bj):
        (..., d) endpoints -> (...,) scores in [0, 1]."""
        raise NotImplementedError

    def score_matrix(self, P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
        """(..., m, m) pairwise scores from gathered (..., m, d) endpoints."""
        return self(P1[..., :, None, :], P1[..., None, :, :],
                    P2[..., :, None, :], P2[..., None, :, :])

    def score_block(self, P1r, P1c, P2r, P2c) -> torch.Tensor:
        """(..., mr, mc) score tile between a row block and a column block;
        equals the corresponding tile of :meth:`score_matrix`."""
        return self(P1r[..., :, None, :], P1c[..., None, :, :],
                    P2r[..., :, None, :], P2c[..., None, :, :])


Invariant = PairwiseInvariant
