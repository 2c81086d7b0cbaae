"""The frozen reference agrees with itself on tiny bunny problems: its
blocked build against a pair-by-pair one, its judge on its own answers
and on answers cut short, its rounding."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import judge, scores, solve
from benchmark.traffic import data, generate

BUNNY = {"protocol": "bunny", "cloud": "bun10k.ply", "points": 9992,
         "scale": 1.0, "noise_sigma": 0.01, "noise_beta_sigmas": 5.54}
INV = {"kind": "euclidean", "sigma": 0.015, "epsilon": 0.05}
EPS = 1e-4


def tiny(m=160, rho=0.8, seed=3):
    traffic = {"problems": 1, "m": m, "rho": rho, "distinct_requests": 1,
               "entry": "facade", "bank_seed": seed}
    req = generate.make_requests(BUNNY, traffic, seed)[0]
    return (*generate.problem(req, 0), req.u0s[0])


def pairwise(inv, D1, D2, A):
    """M entry by entry from the upstream formulas, in float64."""
    m = len(A)
    M = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if A[i, 0] == A[j, 0] or A[i, 1] == A[j, 1]:
                continue
            a, b = D1[A[i, 0]].astype(float), D1[A[j, 0]].astype(float)
            c, d = D2[A[i, 1]].astype(float), D2[A[j, 1]].astype(float)
            dp = abs(np.linalg.norm(a - b) - np.linalg.norm(c - d))
            s = (math.exp(-0.5 * dp * dp / inv["sigma"] ** 2)
                 if dp < inv["epsilon"] else 0.0)
            M[i, j] = s if s > EPS else 0.0
    return M


def test_blocked_build_equals_pair_by_pair():
    D1, D2, A, _ = tiny(m=48)
    P1, P2, At = judge.endpoints(D1, D2, A, "cpu")
    M, C = scores.dense_mc(INV, P1, P2, At, EPS, budget=48 * 7)
    ref = pairwise(INV, D1, D2, A)
    assert np.allclose(M.numpy(), ref, rtol=1e-12, atol=1e-15)
    assert np.array_equal(C.numpy() != 0, ref > 0)
    assert np.array_equal(M.numpy(), M.numpy().T)


def test_judge_passes_the_references_own_answer():
    D1, D2, A, u0 = tiny()
    P1, P2, At = judge.endpoints(D1, D2, A, "cpu")
    M, C = scores.dense_mc(INV, P1, P2, At, EPS)
    u, F, _ = solve.pga(M, C, torch.as_tensor(u0))
    u = u.numpy()
    Fexact = float(u @ (M.numpy() @ u) + u @ u)
    best = judge.best_objective(INV, EPS, D1, D2, A, u0, "cpu")
    assert best == pytest.approx(Fexact, rel=1e-12)
    got = judge.answer_numbers(INV, EPS, D1, D2, A, u, Fexact,
                               judge.round_dsd_heu(u, Fexact), "cpu", best)
    assert got["objective_err"] < 1e-12
    assert got["solve_shortfall"] < 1e-12
    assert got["mask_err"] == 0
    assert got["support_inconsistency"] < 1e-6
    assert abs(F - Fexact) / Fexact < 1e-6
    build = judge.build_numbers(INV, EPS, D1, D2, A, M, C, "cpu")
    assert build == {"build_err": 0.0, "c_err": 0.0}


def test_judge_reads_broken_answers():
    D1, D2, A, u0 = tiny()
    m = len(A)
    u = np.zeros(m)
    assert all(math.isinf(v) for v in judge.answer_numbers(
        INV, EPS, D1, D2, A, u, 1.0, u > 0, "cpu", 1.0).values())
    u = np.random.default_rng(1).random(m)
    got = judge.answer_numbers(INV, EPS, D1, D2, A, u, 1.0,
                               judge.round_dsd_heu(u, 1.0), "cpu", 1.0)
    assert got["support_inconsistency"] > 0.5
    assert got["objective_err"] > 0.5


def test_shortfall_reads_a_smaller_cluster():
    """The reference's own u with half of its support taken away is still
    consistent, and reads a shortfall against the whole solve."""
    D1, D2, A, u0 = tiny()
    P1, P2, At = judge.endpoints(D1, D2, A, "cpu")
    M, C = scores.dense_mc(INV, P1, P2, At, EPS)
    best = judge.best_objective(INV, EPS, D1, D2, A, u0, "cpu")
    u, _, _ = solve.pga(M, C, torch.as_tensor(u0))
    u = u.numpy()
    support = np.flatnonzero(u > 0)
    u[support[::2]] = 0.0
    u /= np.linalg.norm(u)
    F = float(u @ (M.numpy() @ u) + u @ u)
    got = judge.answer_numbers(INV, EPS, D1, D2, A, u, F,
                               judge.round_dsd_heu(u, F), "cpu", best)
    assert got["support_inconsistency"] < 1e-6
    assert got["solve_shortfall"] > 0.3


def test_rounding_takes_round_F_largest_ties_by_index():
    u = np.array([0.0, 0.5, 0.2, 0.5, 0.0, 0.1])
    assert judge.round_dsd_heu(u, 2.49).tolist() == [
        False, True, False, True, False, False]
    assert judge.round_dsd_heu(u, 4.49).tolist() == [
        False, True, True, True, False, True]
    # F = 4.5 rounds half up to 5: the first zero, by index, comes in
    assert judge.round_dsd_heu(u, 4.5).tolist() == [
        True, True, True, True, False, True]


def test_traffic_is_the_seeds_and_keeps_its_sizes():
    cfg = dict(BUNNY)
    traffic = {"problems": 4, "m": 256, "rho": 0.9, "distinct_requests": 2,
               "entry": "facade", "bank_seed": 7}

    def draw(seed):
        return generate.make_requests(cfg, traffic, seed)

    a, b, c = draw(2 ** 31 + 5), draw(2 ** 31 + 5), draw(2 ** 31 + 6)
    for x, y in zip(a, b):      # the same seed, the same inputs
        assert np.array_equal(x.As, y.As) and np.array_equal(x.u0s, y.u0s)
    # another seed: the same bank of problems and starts, in another
    # order and grouping
    def bank(reqs):
        return sorted(A.tobytes() + u.tobytes() for r in reqs
                      for A, u in zip(r.As, r.u0s))
    assert bank(a) == bank(c)
    assert not np.array_equal(a[0].As, c[0].As)
    for r in a:
        assert r.As.shape == (4, 256, 2) and r.u0s.shape == (4, 256)
        for A in r.As:
            assert len({tuple(x) for x in A.tolist()}) == len(A)


def test_ply_reader_and_ground_truth():
    pts = data.read_ply(data.DATA_DIR / "bun10k.ply")
    assert pts.shape == (9992, 3) and np.isfinite(pts).all()
    rng = np.random.default_rng(0)
    a, b = rng.random((300, 3)), rng.random((300, 3))
    got = data.nearest_correspondences(a, b, 0.05)
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    best = {}
    for i in range(300):
        j = int(d[i].argmin())
        if d[i, j] <= 0.05 and (j not in best or d[i, j] < d[best[j], j]):
            best[j] = i
    assert got.tolist() == [[best[j], j] for j in sorted(best)]
