"""Bench protocols: the reference's bunny registration benchmark, the
point-normal scan alignment, and the Monte-Carlo grid over both.

Counterpart of ``clipper_tpu/bench/harness.py`` (reference:
benchmarks/main.cpp): bun10k scaled to the unit cube, bounded normal noise
(sigma=0.01, beta=5.54 sigma), GT = mutual 1-NN within beta, Euclidean
invariant sigma=0.015 / epsilon=0.05; its point-normal configuration
(BASELINE.json config 3: surfel scans, n=2000 points, m=5000 associations
at 80% outliers); and its measurements: one trial's affinity-build and
solver times with precision and recall (:func:`run_trial`,
:func:`run_pointnormal_trial`), B problems through the batched engine
(:func:`run_batched`), and the reference's grid of trials over m and the
outlier ratio (:func:`run_grid`).

A trial's build goes through the dense build kernel
(``ops.affinity_pallas.build_affinity_pallas``, csrc/affinity_build.cu)
on the card and its plain version on the CPU, as the facade's dense
engine builds, and its solve through ``solvers.msrc.solve_msrc``. Each
timed stage is one warm call, then one timed call fenced by
``torch.cuda.synchronize()``. Where the JAX functions took a
``jax.random`` key, these take an optional ``u0`` (numpy), so that a test
can hand both packages the same vector, and otherwise draw it from an
explicit ``torch.Generator``. They run on ``device`` ("cuda" by default;
raises if missing).

The drivers of ``clipper_tpu_torch.bench`` share :func:`parse_argv`,
:func:`bench_device` and :func:`time_ms`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from clipper_tpu_torch.bench import data
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.invariants.pointnormal import (
    PointNormalDistance, PointNormalDistanceParams)
from clipper_tpu_torch.ops.affinity import (distinctness_mask,
                                            gather_endpoints)
from clipper_tpu_torch.ops.affinity_pallas import build_affinity_pallas
from clipper_tpu_torch.ops.pairwise import (cross_distance_matrix,
                                            cross_inner_matrix)
from clipper_tpu_torch.parallel import batched as batched_mod
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params, resolve_device

NOISE_SIGMA = 0.01
NOISE_BETA = 5.54 * NOISE_SIGMA
INV_SIGMA = 0.015
INV_EPSILON = 0.05


@dataclasses.dataclass
class Trial:
    t_affinity: float = 0.0
    t_solver: float = 0.0
    p: float = 0.0
    r: float = 0.0


def parse_argv(argv=None) -> Tuple[List[str], Dict[str, object]]:
    """(positional arguments, {name: value} of the ``--name=value`` flags,
    True for a bare ``--name``) of a driver's argv (sys.argv[1:] if None).
    Names keep their dashes."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    pos = [a for a in argv if not a.startswith("--")]
    opts: Dict[str, object] = {}
    for a in argv:
        if a.startswith("--"):
            name, eq, value = a[2:].partition("=")
            opts[name] = value if eq else True
    return pos, opts


def bench_device(opts: Dict[str, object]) -> torch.device:
    """The ``--device=cuda|cpu`` of a driver's flags, "cuda" by default,
    through types.resolve_device (raises when CUDA is missing)."""
    dev = str(opts.get("device", "cuda"))
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, not {dev!r}")
    return resolve_device(dev)


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the CPU (host times, not device times)")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn: Callable[[], object], dev: torch.device,
            reps: int = 5) -> float:
    """Mean milliseconds of fn() over ``reps`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    sync(dev)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def timed_call(fn: Callable[[], object], dev: torch.device):
    """(result, seconds) of one call of fn() after one warm call, each
    fenced by a synchronise."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


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


# row pairs that gate_boundary_endpoints plants, before those past m drop:
# in one sub-tile, across sub-tiles and t-tiles of 16 to 256, the last row
_PLANT_ROWS = ((0, 1), (2, 3), (10, 70), (63, 64), (100, 199), (127, 128),
               (20, 21), (30, 90), (40, 41), (50, 200), (150, 300),
               (255, 256), (190, 260), (400, 401), (511, 512), (600, 999),
               (700, 800), (900, 901))


def gate_boundary_endpoints(invariant, W: int, m: int, seed: int,
                            dtype=np.float32):
    """Gathered endpoints whose pairs sit on the edges of the built-in
    scores' gates, for holding the build kernels to their plain version:
    random problems with planted pairs, as numpy (P1, P2) (W, m, d) in
    ``dtype`` (f32, or f64 for the f64 builds, whose gate compares in
    f64) and int32 A (W, m, 2), and the planted pairs' list of (i, j,
    what). The draws do not depend on ``dtype``.

    The plants, one row pair each (the pairs of ``_PLANT_ROWS`` below m,
    taking the kinds below in turn): the gate's difference (c of a
    Euclidean score, dp of a point-normal one) exactly at the gate's bound
    in ``dtype`` ("at"), one ulp under it ("below") and one ulp over
    ("above"), planted as a length x in set 1 against coincident
    endpoints in set 2 (sqrt(fl(x x)) = x in IEEE arithmetic, and l = 0),
    and again as lengths 2^-10 + x and 2^-10 ("at_both", "below_both",
    "above_both": both lengths exact and non-zero, their difference
    exact); both sets coincident ("coincident", l1 = l2 = 0). Point-normal
    rows carry the
    same normal on both rows of a plant, so dn = 0 ("at" scores 0 whatever
    dn), and two more kinds take normals whose dot is -1
    ("antiparallel") and a unit normal whose f32 dot with itself rounds
    to 1 + 2^-23 ("clamp"). Other rows: set-1 points in a cube of side 0.2
    (Euclidean) or 1, set 2 the same points moved by 0.01 noise on half
    the rows (so many pairs pass the gates), random unit normals, and
    associations drawn from m / 2 ids, so some pairs are not distinct;
    planted rows get ids of their own."""
    pn = isinstance(invariant, PointNormalDistance)
    dtype = np.dtype(dtype).type
    bound = dtype(invariant.params.epsp if pn else invariant.params.epsilon)
    rng = np.random.default_rng(seed)
    d = 6 if pn else 3
    side = 1.0 if pn else 0.2
    P1 = np.zeros((W, m, d), dtype)
    P1[..., :3] = rng.uniform(0, side, (W, m, 3))
    P2 = P1.copy()
    moved = rng.random((W, m)) < 0.5
    P2[..., :3] += np.where(moved[..., None],
                            rng.normal(0, 0.01, (W, m, 3)), 0.0)
    P2[..., :3][~moved] = rng.uniform(0, side, (int((~moved).sum()), 3))
    if pn:
        nrm = rng.normal(size=(W, m, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        P1[..., 3:] = nrm
        P2[..., 3:] = nrm
    A = rng.integers(0, max(m // 2, 1), (W, m, 2)).astype(np.int32)
    edge = {"at": bound, "below": np.nextafter(bound, dtype(0)),
            "above": np.nextafter(bound, dtype(1))}
    kinds = [*edge, *(f"{k}_both" for k in edge), "coincident"]
    if pn:
        kinds += ["antiparallel", "clamp"]
    normals = {"antiparallel": np.float32([0, 1, 0]),
               "clamp": np.float32([0.96672255, -0.04501169, -0.25183624])}
    base = dtype(2.0 ** -10)
    plants = []
    for k, (i, j) in enumerate(ij for ij in _PLANT_ROWS if ij[1] < m):
        what = kinds[k % len(kinds)]
        for P in (P1, P2):
            P[:, i, :3] = P[:, j, :3] = rng.uniform(0, side, (W, 3))
        x = edge.get(what.replace("_both", ""))
        if x is not None:
            both = what.endswith("_both")
            for P, length in ((P1, x + base if both else x),
                              (P2, base if both else None)):
                if length is not None:
                    P[:, i, :3] = 0.0
                    P[:, j, :3] = (length, 0.0, 0.0)
        if pn:
            nv = normals.get(what, np.float32([1, 0, 0]))
            for P in (P1, P2):
                P[:, i, 3:] = nv
                P[:, j, 3:] = -nv if what == "antiparallel" else nv
        A[:, i] = (m + 2 * i, m + 2 * i)
        A[:, j] = (m + 2 * j, m + 2 * j)
        plants.append((i, j, what))
    return P1, P2, A, plants


def gate_shares(invariant, P1, P2, A, m_trues,
                chunk: int = 32) -> Dict[str, float]:
    """Shares of a build's distinct pairs (i < j, W m (m - 1) / 2 of
    them) that reach each stage of the build kernels' gated score (csrc/
    tri_pair_build.cuh), counted by plain PyTorch on the endpoints'
    device: ``gate``, the gate passes (Euclidean |l1 - l2| < epsilon and
    no length under mindist; point-normal dp < epsp); ``queued``, the
    cheap masks (distinct, below m_true) and the gate pass: the pairs
    whose tail runs; point-normal ``both``, queued and dn < epsn too.
    P1, P2 (W, m, d) gathered endpoints, A (W, m, 2), m_trues (W,)."""
    pn = isinstance(invariant, PointNormalDistance)
    p = invariant.params
    W, m, _ = P1.shape
    dev = P1.device
    upper = torch.triu(torch.ones(m, m, dtype=torch.bool, device=dev), 1)
    lim = torch.as_tensor(m_trues, device=dev).reshape(-1)
    idx = torch.arange(m, device=dev)
    counts = dict(gate=0, queued=0, **({"both": 0} if pn else {}))
    for s in range(0, W, chunk):
        X1, X2 = P1[s:s + chunk], P2[s:s + chunk]
        l1 = cross_distance_matrix(X1[..., :3], X1[..., :3])
        l2 = cross_distance_matrix(X2[..., :3], X2[..., :3])
        gate = (l1 - l2).abs() < (p.epsp if pn else p.epsilon)
        if not pn and p.mindist > 0:
            gate &= (l1 >= p.mindist) & (l2 >= p.mindist)
        live = idx < lim[s:s + chunk, None]
        queued = (gate & upper & distinctness_mask(A[s:s + chunk])
                  & live[:, :, None] & live[:, None, :])
        counts["gate"] += int((gate & upper).sum())
        counts["queued"] += int(queued.sum())
        if pn:
            a1 = torch.arccos(torch.clamp(cross_inner_matrix(
                X1[..., 3:6], X1[..., 3:6]), -1.0, 1.0))
            a2 = torch.arccos(torch.clamp(cross_inner_matrix(
                X2[..., 3:6], X2[..., 3:6]), -1.0, 1.0))
            counts["both"] += int((queued & ((a1 - a2).abs()
                                             < p.epsn)).sum())
    pairs = W * m * (m - 1) // 2
    return {k: v / pairs for k, v in counts.items()}


# ----------------------------------------------------------------------
# measurements: one trial, the batched engine, the Monte-Carlo grid
# ----------------------------------------------------------------------


def _init_vector(u0, generator: Optional[torch.Generator], shape, dtype,
                 dev: torch.device) -> torch.Tensor:
    """u0 (numpy) when given, else U[0, 1) draws of ``shape`` from
    ``generator`` (a CPU generator gives the same draws on every device)."""
    if u0 is not None:
        u0 = torch.tensor(np.asarray(u0), dtype=dtype)
        if tuple(u0.shape) != tuple(shape):
            raise ValueError(f"u0 must be {tuple(shape)}; got "
                             f"{tuple(u0.shape)}")
        return u0.to(dev)
    gen_dev = generator.device if generator is not None else "cpu"
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=gen_dev).to(dev)


def _trial(invariant, D1, D2, A, Agt, u0, dtype, dev) -> Trial:
    """Time the build and the solve of one problem (reference
    main.cpp:176-193) and score its selected associations."""
    D1t = torch.as_tensor(np.asarray(D1), dtype=dtype, device=dev)
    D2t = torch.as_tensor(np.asarray(D2), dtype=dtype, device=dev)
    At = torch.as_tensor(np.asarray(A), dtype=torch.int32, device=dev)

    def build():
        P1, P2 = gather_endpoints(D1t, D2t, At)
        return build_affinity_pallas(invariant, P1, P2, At,
                                     affinityeps=1e-4)

    trial = Trial()
    (M, C), trial.t_affinity = timed_call(build, dev)
    soln, trial.t_solver = timed_call(
        lambda: msrc.solve_msrc(M, C, u0, Params()), dev)
    mask = soln.mask.cpu().numpy()
    trial.p, trial.r = data.get_precision_recall(np.asarray(A)[mask], Agt)
    return trial


def run_trial(pcd0: np.ndarray, m: int, rho: float,
              rng: np.random.Generator,
              generator: Optional[torch.Generator] = None,
              dtype=torch.float32, *, u0=None, device="cuda") -> Trial:
    """One Monte-Carlo trial of the bunny protocol (timing mirrors
    reference main.cpp:176-193): the problem from ``rng``, u0 as given
    (numpy, (m,)) or drawn from ``generator``."""
    dev = resolve_device(device)
    pcd1, A, Agt = make_problem(pcd0, m, rho, rng)
    u = _init_vector(u0, generator, (m,), dtype, dev)
    return _trial(default_invariant(), pcd0, pcd1, A, Agt, u, dtype, dev)


def run_pointnormal_trial(rng: np.random.Generator,
                          generator: Optional[torch.Generator] = None,
                          n: int = 2000, m: int = 5000, rho: float = 0.8,
                          dtype=torch.float32, *, u0=None,
                          device="cuda") -> Trial:
    """One point-normal trial with build and solver timing (m=5000 by
    default: BASELINE.json config 3)."""
    dev = resolve_device(device)
    D1, D2, A, Agt = make_pointnormal_problem(rng, n, m, rho)
    u = _init_vector(u0, generator, (m,), dtype, dev)
    return _trial(pointnormal_invariant(), D1, D2, A, Agt, u, dtype, dev)


def run_batched(pcd0: np.ndarray, m: int, rho: float, batch: int,
                rng: np.random.Generator,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32, n_timing_reps: int = 3,
                solver: str = "flat", matvec: str = "stacked", *, u0=None,
                device="cuda"):
    """``batch`` independent problems through the batched engine
    (parallel/batched.make_batched_pipeline, D1 shared) in one call.

    u0: optional (batch, m) numpy inits. Returns (problems per second,
    mean precision, mean recall, elapsed seconds a call), the elapsed time
    covering build, solve and rounding of the whole batch, the mean of
    ``n_timing_reps`` calls after one warm call."""
    dev = resolve_device(device)
    problems = [make_problem(pcd0, m, rho, rng) for _ in range(batch)]
    D1 = torch.as_tensor(pcd0, dtype=dtype, device=dev)
    D2s = torch.as_tensor(np.stack([p[0] for p in problems]), dtype=dtype,
                          device=dev)
    As = torch.as_tensor(np.stack([p[1] for p in problems]),
                         dtype=torch.int32, device=dev)
    u0s = _init_vector(u0, generator, (batch, m), dtype, dev)
    pipe = batched_mod.make_batched_pipeline(
        default_invariant(), Params(), solver=solver, matvec=matvec,
        device=dev)

    solns = pipe(D1, D2s, As, u0s)     # warm-up
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_timing_reps):
        solns = pipe(D1, D2s, As, u0s)
        sync(dev)
    elapsed = (time.perf_counter() - t0) / n_timing_reps

    masks = solns.mask.cpu().numpy()
    pr = [data.get_precision_recall(A[masks[b]], Agt)
          for b, (_, A, Agt) in enumerate(problems)]
    ps, rs = zip(*pr)
    return (batch / elapsed, float(np.mean(ps)), float(np.mean(rs)),
            elapsed)


def run_grid(num_assocs=(64, 256, 512, 1024, 2048),
             outrats=(0.0, 0.2, 0.4, 0.8, 0.9), n_trials: int = 20,
             seed: int = 0, dtype=torch.float32, verbose: bool = True, *,
             device="cuda") -> List[dict]:
    """The reference's Monte-Carlo grid (reference: main.cpp:206-294), one
    :func:`run_trial` after another; problems from numpy
    ``default_rng(seed)``, inits from a CPU ``torch.Generator`` seeded
    with ``seed``. Rows: rho, m, t_affinity_ms, t_solver_ms, precision,
    recall (the means over the trials)."""
    dev = resolve_device(device)
    pcd0 = load_bunny()
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for rho in outrats:
        for m in num_assocs:
            trials = [run_trial(pcd0, m, rho, rng, gen, dtype, device=dev)
                      for _ in range(n_trials)]
            row = dict(
                rho=rho, m=m,
                t_affinity_ms=1e3 * float(np.mean([t.t_affinity
                                                   for t in trials])),
                t_solver_ms=1e3 * float(np.mean([t.t_solver
                                                 for t in trials])),
                precision=float(np.mean([t.p for t in trials])),
                recall=float(np.mean([t.r for t in trials])),
            )
            rows.append(row)
            if verbose:
                print(f"rho={rho:.1f} m={m:5d}  affinity="
                      f"{row['t_affinity_ms']:8.2f}ms  solver="
                      f"{row['t_solver_ms']:8.2f}ms  P="
                      f"{row['precision'] * 100:5.1f}%  R="
                      f"{row['recall'] * 100:5.1f}%", flush=True)
    return rows
