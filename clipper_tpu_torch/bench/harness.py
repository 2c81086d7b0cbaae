"""Bench protocol: the reference's bunny registration benchmark.

Counterpart of ``clipper_tpu/bench/harness.py:30-63`` (reference:
benchmarks/main.cpp): bun10k scaled to the unit cube, bounded normal noise
(sigma=0.01, beta=5.54 sigma), GT = mutual 1-NN within beta, Euclidean
invariant sigma=0.015 / epsilon=0.05.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from clipper_tpu_torch.bench import data
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)

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
