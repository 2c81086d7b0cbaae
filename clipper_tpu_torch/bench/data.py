"""Benchmark data utilities (numpy only).

Counterpart of ``clipper_tpu/bench/data.py`` (reference:
benchmarks/bm_utils.cpp): PLY IO, unit-cube scaling, bounded normal noise,
kd-tree ground-truth correspondences, synthetic outlier injection and
precision/recall. PLY files are read by the port's native reader
(native/plyio.cpp), and by the pure-Python parser for a layout that
reader declines.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

DATA_DIR = Path(__file__).resolve().parent.parent.parent / "data"
BUN10K = DATA_DIR / "bun10k.ply"

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
}


def read_ply(path) -> np.ndarray:
    """Vertex x/y/z of an ascii or binary-little-endian PLY file as (n, 3)
    float64 (reference: benchmarks/bm_utils.cpp:24-107). The native reader
    (native/plyio.cpp, the reference's tinyply role) reads it; a layout it
    declines (a vertex count < 0: list properties, another format) goes to
    the pure-Python parser, the JAX package's format coverage. A failed
    build of the native library raises."""
    pts = _read_ply_native(path)
    return pts if pts is not None else _read_ply_py(path)


def _read_ply_native(path) -> Optional[np.ndarray]:
    """(n, 3) points, or None where the native reader declines the file."""
    from clipper_tpu_torch.native import build as native_build
    lib = native_build.load()
    p = str(Path(path)).encode()
    n = lib.clipper_ply_vertex_count(p)
    if n < 0:
        return None
    out = np.empty((int(n), 3), np.float64)
    if lib.clipper_ply_read_xyz(p, out, n) != 0:
        return None
    return out


def _read_ply_py(path) -> np.ndarray:
    path = Path(path)
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, type_str), ...])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append((tok[-1], ("list", tok[2], tok[3])))
                else:
                    elements[-1][2].append((tok[2], tok[1]))
            elif tok[0] == "end_header":
                break

        vert = next((e for e in elements if e[0] == "vertex"), None)
        if vert is None:
            raise ValueError("PLY file has no vertex element")
        _, count, props = vert
        names = [p[0] for p in props]
        if any(isinstance(p[1], tuple) for p in props):
            raise ValueError("list properties in vertex element unsupported")

        if fmt == "ascii":
            rows = []
            for _ in range(count):
                vals = f.readline().split()
                rows.append([float(v) for v in vals[: len(props)]])
            arr = np.asarray(rows, dtype=np.float64)
        elif fmt == "binary_little_endian":
            fmt_str = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
            stride = struct.calcsize(fmt_str)
            buf = f.read(stride * count)
            arr = np.array(
                [struct.unpack_from(fmt_str, buf, i * stride)
                 for i in range(count)], dtype=np.float64)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
    return arr[:, [ix, iy, iz]]


def scale_to_cube(pts: np.ndarray, s: float = 1.0) -> np.ndarray:
    """Scale so the largest axis-aligned extent is s (reference:111-116)."""
    d = pts.max(axis=0) - pts.min(axis=0)
    return pts * (s / d.max())


def generate_bounded_normal_noise(rng: np.random.Generator, n: int,
                                  sigma: float, beta: float) -> np.ndarray:
    """N(0, sigma^2) 3-vectors rejection-sampled to norm <= beta
    (reference: benchmarks/bm_utils.cpp:131-143)."""
    eta = np.zeros((n, 3))
    todo = np.arange(n)
    while todo.size:
        v = rng.normal(0.0, sigma, size=(todo.size, 3))
        ok = np.linalg.norm(v, axis=1) <= beta
        eta[todo[ok]] = v[ok]
        todo = todo[~ok]
    return eta


def distance_based_correspondences(pcd0: np.ndarray, pcd1: np.ndarray,
                                   knn: int = 1, radius: float = np.inf,
                                   enforce_1to1: bool = True) -> np.ndarray:
    """For each point of pcd0, its knn nearest neighbors in pcd1 within
    radius; optionally one-to-one (closest source point per target point)
    (reference: benchmarks/bm_utils.cpp:147-232)."""
    sqd, idx = cKDTree(pcd1).query(pcd0, k=knn)
    sqd = np.square(sqd)
    idx = idx.reshape(pcd0.shape[0], knn)
    sqd = sqd.reshape(pcd0.shape[0], knn)

    rsq = radius * radius
    pairs, dists = [], []
    for i in range(pcd0.shape[0]):
        for j in range(knn):
            if sqd[i, j] <= rsq:
                pairs.append((i, int(idx[i, j])))
                dists.append(sqd[i, j])
    if not enforce_1to1:
        return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)

    best = {}  # c1 -> (sqdist, c0)
    for (c0, c1), sd in zip(pairs, dists):
        if c1 not in best or sd < best[c1][0]:
            best[c1] = (sd, c0)
    return np.asarray([[c0, c1] for c1, (_, c0) in sorted(best.items())],
                      dtype=np.int32).reshape(-1, 2)


def generate_synthetic_correspondences(
        rng: np.random.Generator, n0: int, n1: int, Agood: np.ndarray,
        m: int, rho: float) -> Tuple[np.ndarray, np.ndarray]:
    """Mix round(m*(1-rho)) true inliers with random non-GT outliers
    (reference: benchmarks/bm_utils.cpp:277-349).

    Returns (A, Agt): the m putative associations (outliers first) and the
    ground-truth inlier subset.
    """
    assert 0.0 <= rho <= 1.0
    ni = int(round(m * (1 - rho)))
    no = m - ni
    p = Agood.shape[0]
    if ni > p:
        raise ValueError(f"not enough initial inliers ({p}) for requested "
                         f"outlier ratio {rho} (need {ni})")

    perm = rng.permutation(p)
    Agt = Agood[perm[:ni]]
    good = {(int(a), int(b)) for a, b in Agood}

    A = np.zeros((m, 2), dtype=np.int32)
    A[no:] = Agt

    seen = set()
    nele = 0
    while nele < no:
        k = int(rng.integers(0, n0 * n1))
        if k in seen:
            continue
        seen.add(k)
        row = (k // n1, k % n1)
        if row in good:
            continue
        A[nele] = row
        nele += 1
    return A, Agt


def get_precision_recall(A: np.ndarray, Agt: np.ndarray) -> Tuple[float, float]:
    """reference: benchmarks/bm_utils.cpp:353-371."""
    if A.size == 0 or Agt.size == 0:
        return 0.0, 0.0
    gt = {(int(a), int(b)) for a, b in Agt}
    tp = sum((int(a), int(b)) in gt for a, b in A)
    return tp / A.shape[0], tp / Agt.shape[0]
