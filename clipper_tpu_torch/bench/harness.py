"""Bench protocols: the reference's bunny registration benchmark, and the
point-normal scan alignment.

Counterpart of ``clipper_tpu/bench/harness.py:30-63`` (reference:
benchmarks/main.cpp): bun10k scaled to the unit cube, bounded normal noise
(sigma=0.01, beta=5.54 sigma), GT = mutual 1-NN within beta, Euclidean
invariant sigma=0.015 / epsilon=0.05; and of its point-normal
configuration (``harness.py:117-185``, BASELINE.json config 3: surfel
scans, n=2000 points, m=5000 associations at 80% outliers).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from clipper_tpu_torch.bench import data
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.invariants.pointnormal import (
    PointNormalDistance, PointNormalDistanceParams)

NOISE_SIGMA = 0.01
NOISE_BETA = 5.54 * NOISE_SIGMA
INV_SIGMA = 0.015
INV_EPSILON = 0.05


def default_invariant() -> EuclideanDistance:
    return EuclideanDistance(EuclideanDistanceParams(
        sigma=INV_SIGMA, epsilon=INV_EPSILON))


def load_bunny() -> np.ndarray:
    return data.scale_to_cube(data.read_ply(data.BUN10K), 1.0)


def make_problem(pcd0: np.ndarray, m: int, rho: float,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """One synthetic registration problem: (pcd1, A, Agt)."""
    eta = data.generate_bounded_normal_noise(rng, pcd0.shape[0],
                                             NOISE_SIGMA, NOISE_BETA)
    pcd1 = pcd0 + eta
    Agt0 = data.distance_based_correspondences(pcd0, pcd1, 1, NOISE_BETA, True)
    A, Agt = data.generate_synthetic_correspondences(
        rng, pcd0.shape[0], pcd1.shape[0], Agt0, m, rho)
    return pcd1, A, Agt


def pointnormal_invariant() -> PointNormalDistance:
    """The point-normal protocol's invariant (the JAX package's
    run_pointnormal_trial, harness.py:154-155)."""
    return PointNormalDistance(PointNormalDistanceParams(
        sigp=0.03, epsp=0.06, sign=0.05, epsn=0.15))


def make_pointnormal_problem(rng: np.random.Generator, n: int = 2000,
                             m: int = 5000, rho: float = 0.8,
                             noise: float = 0.01):
    """Synthetic surfel-cloud alignment: points and unit normals under a
    random rigid transform, with outlier associations injected. The same
    numpy draws in the same order as the JAX package's generator, so one
    ``default_rng(seed)`` gives both packages the same problem.

    Returns (D1, D2, A, Agt): (n, 6) point-normal datasets, (m, 2)
    putative associations (outliers first), the ground-truth subset.
    """
    pts = rng.uniform(-5.0, 5.0, size=(n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    # random rotation (QR of a gaussian) and translation
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    t = rng.uniform(-2, 2, size=3)
    pts2 = pts @ Q.T + t + rng.normal(0, noise, size=(n, 3))
    nrm2 = nrm @ Q.T

    D1 = np.concatenate([pts, nrm], axis=1)
    D2 = np.concatenate([pts2, nrm2], axis=1)
    Agood = np.stack([np.arange(n), np.arange(n)], axis=1).astype(np.int32)
    A, Agt = data.generate_synthetic_correspondences(rng, n, n, Agood, m, rho)
    return D1, D2, A, Agt
