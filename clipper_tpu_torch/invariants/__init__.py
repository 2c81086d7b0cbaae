"""Pairwise invariants, and the scores the build kernels compute.

An invariant says through :meth:`PairwiseInvariant.cuda_score` how the
CUDA build kernels (kernels 2, 8, 4 and 6) compute it on the card: the two
built-in symmetric invariants give their :class:`BuiltinScore`, whose
arithmetic csrc/euclid_score.cuh and csrc/pointnormal_score.cuh repeat
step by step; a user's symmetric invariant may give a
:class:`DeviceScore`, its own C++ score (csrc/user_score.cuh states the
contract), which the builds take through a library compiled for it at
first use; an invariant that gives None builds through its plain PyTorch
version. :func:`kernel_score` hands the kernels a score's kind and
parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from clipper_tpu_torch.invariants.base import (MAX_USER_D, USER_KIND,
                                               BuiltinScore, DeviceScore,
                                               PairwiseInvariant, Score)
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.invariants.pointnormal import (
    PointNormalDistance, PointNormalDistanceParams)


class Builtin(NamedTuple):
    """A built-in invariant's classes, by the kind name interop takes."""
    cls: type
    params_cls: type


# the one table of built-in invariants, by the kind name interop takes
BUILTINS = {
    "euclidean": Builtin(EuclideanDistance, EuclideanDistanceParams),
    "pointnormal": Builtin(PointNormalDistance, PointNormalDistanceParams),
}


def _score(invariant) -> Optional[Score]:
    get = getattr(invariant, "cuda_score", None)
    return None if get is None else get()


def kernel_builds(invariant: PairwiseInvariant) -> bool:
    """True when the build kernels compute this invariant's scores: a
    symmetric invariant with a device score (built-in or its own)."""
    return (_score(invariant) is not None
            and bool(getattr(invariant, "symmetric", False)))


def device_score(invariant: PairwiseInvariant) -> Score:
    """The invariant's score for the build kernels, checked: a
    :class:`BuiltinScore`, or a :class:`DeviceScore` of a symmetric
    invariant with 1 <= d <= MAX_USER_D and at most four parameters.
    Raises NotImplementedError for an invariant without one."""
    score = _score(invariant)
    name = type(invariant).__name__
    if score is None:
        raise NotImplementedError(
            "the CUDA build kernels compute EuclideanDistance, "
            "PointNormalDistance and invariants whose cuda_score() gives a "
            f"DeviceScore, not {name}; build it on the CPU (the plain "
            "version)")
    if isinstance(score, DeviceScore):
        if not getattr(invariant, "symmetric", False):
            raise ValueError(
                f"{name}: the build kernels score each pair once and mirror "
                "it, so a device score needs a symmetric invariant")
        if not 1 <= score.d <= MAX_USER_D:
            raise ValueError(
                f"{name}: a device score takes 1 <= d <= {MAX_USER_D} "
                f"(kernel 8 holds two 64-row sub-tiles of records a unit, "
                f"8 units a block, beside its bf16 stages in a block's 227 "
                f"KB of shared memory: 80-byte records at d = {MAX_USER_D}); "
                f"got d={score.d}")
        if len(score.params) > 4 or not isinstance(score.source, str):
            raise ValueError(f"{name}: a device score has C++ source text "
                             "and at most four parameters")
    return score


def kernel_score(invariant: PairwiseInvariant) -> Tuple[int, int, tuple]:
    """(kind, d, (p0, p1, p2, p3)) of an invariant's score for the build
    kernels (:func:`device_score`): EuclideanDistance kind 0, (sigma^2,
    epsilon, mindist, 0); PointNormalDistance kind 1, (sigp^2, epsp,
    sign^2, epsn); a DeviceScore USER_KIND, its parameters padded with
    zeros. Raises NotImplementedError for an invariant without one."""
    score = device_score(invariant)
    params = tuple(float(x) for x in score.params)
    return score.kind, score.d, params + (0.0,) * (4 - len(params))


__all__ = ["BUILTINS", "BuiltinScore", "DeviceScore", "EuclideanDistance",
           "EuclideanDistanceParams", "MAX_USER_D", "PairwiseInvariant",
           "PointNormalDistance", "PointNormalDistanceParams", "USER_KIND",
           "device_score", "kernel_builds", "kernel_score"]
