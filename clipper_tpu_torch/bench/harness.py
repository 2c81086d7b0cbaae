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
from clipper_tpu_torch.ops.affinity import gather_endpoints
from clipper_tpu_torch.ops.affinity_pallas import build_affinity_pallas
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
