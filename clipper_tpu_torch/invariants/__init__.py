"""Pairwise invariants, and the built-in ones the build kernels compute.

The CUDA build kernels (csrc/euclid_score.cuh, csrc/pointnormal_score.cuh)
repeat the arithmetic of the two built-in symmetric invariants step by
step; :func:`kernel_score` hands them an invariant's kind and parameters.
A user's own PairwiseInvariant builds through the plain PyTorch path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.invariants.pointnormal import (
    PointNormalDistance, PointNormalDistanceParams)


class Builtin(NamedTuple):
    """A built-in invariant: its classes, its score kind in the kernels'
    C interface, its endpoint width d, and its parameters for the kernels
    as four Python floats (squares formed in double, as the plain versions
    form them)."""
    cls: type
    params_cls: type
    kind: int
    d: int
    kernel_params: Callable[[object], Tuple[float, float, float, float]]


# the one table of built-in invariants, by the kind name interop takes
BUILTINS = {
    "euclidean": Builtin(
        EuclideanDistance, EuclideanDistanceParams, 0, 3,
        lambda p: (p.sigma * p.sigma, p.epsilon, p.mindist, 0.0)),
    "pointnormal": Builtin(
        PointNormalDistance, PointNormalDistanceParams, 1, 6,
        lambda p: (p.sigp * p.sigp, p.epsp, p.sign * p.sign, p.epsn)),
}


def _builtin(invariant: PairwiseInvariant) -> Optional[Builtin]:
    for b in BUILTINS.values():
        if isinstance(invariant, b.cls):
            return b
    return None


def kernel_builds(invariant: PairwiseInvariant) -> bool:
    """True when the build kernels compute this invariant's scores."""
    return _builtin(invariant) is not None


def kernel_score(invariant: PairwiseInvariant) -> Tuple[int, int, tuple]:
    """(kind, d, (p0, p1, p2, p3)) of a built-in invariant for the build
    kernels. EuclideanDistance: (sigma^2, epsilon, mindist, 0);
    PointNormalDistance: (sigp^2, epsp, sign^2, epsn). Raises
    NotImplementedError for any other invariant."""
    b = _builtin(invariant)
    if b is None:
        raise NotImplementedError(
            "the CUDA build kernels compute EuclideanDistance and "
            f"PointNormalDistance, not {type(invariant).__name__}; build it "
            "on the CPU (the plain version)")
    return b.kind, b.d, b.kernel_params(invariant.params)
