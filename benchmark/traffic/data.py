"""Data of the upstream registration benchmark, in NumPy alone.

A frozen copy of the port's ``bench/data.py`` (upstream:
mit-acl/clipper benchmarks/bm_utils.cpp): a PLY reader, unit-cube
scaling, bounded normal noise, ground truth by nearest neighbours within
a radius, synthetic outlier associations. The loops of the original are
vectorised, so one seed draws its problems in bulk: the draws follow
the same rules but not the same order as the port's copy, so a seed
gives other problems than the port's drivers do.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

DATA_DIR = Path(__file__).resolve().parent.parent / "data"

_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def read_ply(path) -> np.ndarray:
    """Vertex x, y, z of an ascii or binary little-endian PLY file as
    (n, 3) float64 (upstream bm_utils.cpp:24-107). List properties in the
    vertex element are refused."""
    path = Path(path)
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt, elements = None, []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: end of file inside the header")
            tok = line.decode("ascii", "replace").split()
            if not tok or tok[0] in ("comment", "obj_info"):
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    raise ValueError(f"{path}: list properties are not read")
                elements[-1][2].append((tok[2], tok[1]))
            elif tok[0] == "end_header":
                break
        if not elements or elements[0][0] != "vertex":
            raise ValueError(f"{path}: the first element is not vertex")
        _, count, props = elements[0]
        names = [p[0] for p in props]
        if fmt == "binary_little_endian":
            dt = np.dtype([(n, "<" + _PLY_TYPES[t]) for n, t in props])
            rec = np.frombuffer(f.read(dt.itemsize * count), dt, count)
            arr = np.stack([rec[n].astype(np.float64) for n in names], 1)
        elif fmt == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
            arr = arr[:, :len(names)]
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return arr[:, [names.index("x"), names.index("y"), names.index("z")]]


def scale_to_cube(pts: np.ndarray, s: float = 1.0) -> np.ndarray:
    """Scale so that the largest axis-aligned extent is s (upstream
    bm_utils.cpp:111-116)."""
    d = pts.max(axis=0) - pts.min(axis=0)
    return pts * (s / d.max())


def bounded_normal_noise(rng: np.random.Generator, n: int, sigma: float,
                         beta: float) -> np.ndarray:
    """n N(0, sigma^2 I) 3-vectors, each drawn again until its norm is at
    most beta (upstream bm_utils.cpp:131-143)."""
    eta = np.zeros((n, 3))
    todo = np.arange(n)
    while todo.size:
        v = rng.normal(0.0, sigma, size=(todo.size, 3))
        ok = np.linalg.norm(v, axis=1) <= beta
        eta[todo[ok]] = v[ok]
        todo = todo[~ok]
    return eta


def nearest_correspondences(pcd0: np.ndarray, pcd1: np.ndarray,
                            radius: float, workers: int = 1) -> np.ndarray:
    """Each point of pcd0 with its nearest neighbour in pcd1 within
    ``radius``, one-to-one: a point of pcd1 keeps its closest source, the
    lowest index on a tie (upstream bm_utils.cpp:147-232 with knn = 1 and
    enforce_1to1). (p, 2) int32 rows ordered by the pcd1 index."""
    dist, j = cKDTree(pcd1).query(pcd0, k=1, workers=workers)
    i = np.flatnonzero(dist * dist <= radius * radius)
    j, d2 = j[i], (dist * dist)[i]
    order = np.lexsort((i, d2, j))
    j, i = j[order], i[order]
    first = np.ones(j.size, bool)
    first[1:] = j[1:] != j[:-1]
    return np.stack([i[first], j[first]], axis=1).astype(np.int32)


def synthetic_correspondences(rng: np.random.Generator, n0: int, n1: int,
                              Agood: np.ndarray, m: int,
                              rho: float) -> Tuple[np.ndarray, np.ndarray]:
    """round(m (1 - rho)) inliers drawn from Agood without replacement and
    m - that many distinct outliers drawn uniformly from the n0 x n1
    pairs not in Agood (upstream bm_utils.cpp:277-349), in an order drawn
    from ``rng`` (upstream puts the outliers first, so an answer that
    picked the last rows of any problem would read right). Returns (A,
    Agt): the (m, 2) int32 associations and the inlier rows."""
    if not 0.0 <= rho <= 1.0:
        raise ValueError(f"outlier ratio {rho} is not in [0, 1]")
    ni = int(round(m * (1 - rho)))
    no = m - ni
    if ni > Agood.shape[0]:
        raise ValueError(f"{Agood.shape[0]} ground-truth pairs cannot give "
                         f"{ni} inliers")
    Agt = Agood[rng.permutation(Agood.shape[0])[:ni]]
    good = Agood[:, 0].astype(np.int64) * n1 + Agood[:, 1]
    picked = np.empty(0, np.int64)
    while picked.size < no:
        k = rng.integers(0, n0 * n1, size=2 * (no - picked.size) + 16)
        k = k[~np.isin(k, good)]
        k = np.concatenate([picked, k])
        _, first = np.unique(k, return_index=True)
        picked = k[np.sort(first)][:no]
    A = np.empty((m, 2), np.int32)
    A[:no, 0], A[:no, 1] = picked // n1, picked % n1
    A[no:] = Agt
    return A[rng.permutation(m)], Agt


def precision_recall(A: np.ndarray, Agt: np.ndarray) -> Tuple[float, float]:
    """Precision and recall of the selected associations A against the
    ground truth Agt (upstream bm_utils.cpp:353-371)."""
    if A.size == 0 or Agt.size == 0:
        return 0.0, 0.0
    gt = set(map(tuple, np.asarray(Agt).tolist()))
    tp = sum(tuple(a) in gt for a in np.asarray(A).tolist())
    return tp / A.shape[0], tp / Agt.shape[0]
