"""clipperpy.utils-compatible namespace
(reference: bindings/python/py_clipper.cpp:87-99), over the port's
ops.affinity and utils; host numpy in and out."""

import numpy as np

from clipper_tpu_torch import utils as _u
from clipper_tpu_torch.ops.affinity import create_all_to_all as _all_to_all


def create_all_to_all(n1: int, n2: int) -> np.ndarray:
    return _all_to_all(n1, n2).numpy()


def k2ij(k: int, n: int):
    i, j = _u.k2ij(k, n)
    return int(i), int(j)


def randvec(n: int, seed=None) -> np.ndarray:
    """U[0,1) vector (reference: src/utils.cpp:22-29); the reference uses
    a global C++ RNG, here an optional seed gives reproducibility."""
    return np.random.default_rng(seed).uniform(size=n)


def find_indices_of_k_largest(x, k: int):
    return _u.find_indices_of_k_largest(np.asarray(x), int(k))


def find_indices_where_above_threshold(x, thr: float):
    return _u.find_indices_where_above_threshold(np.asarray(x), float(thr))


def select_from_indicator(x, ind):
    return _u.select_from_indicator(np.asarray(x), np.asarray(ind))


def select_inlier_associations(soln, A) -> np.ndarray:
    return _u.select_inlier_associations(soln, np.asarray(A))
