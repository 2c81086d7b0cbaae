"""Port parity: solvers/sdp.py against clipper_tpu.solvers.sdp on the CPU.

Each test of tests/test_sdp.py (the facade's are in
test_torch_facade_sdp.py) runs through both packages on the same numpy
inputs, with its own assertions on the port's result, and the port is
held to JAX: in f64 equal iterations and nodes with pobj and dobj within
1e-9; in f32 equal nodes with pobj within 1e-4 relative; the same
warnings. The golden 20 x 20 matrix with Anderson acceleration (AA) on is
the stated exception (ROADMAP Queue 3): its residual stalls from
iteration ~20 with the iterate at its fixed point to 1e-15, the AA
history rows are rounding noise, and the safeguard compares two norms
equal to 15 digits, so the acceptance at iteration 80 is decided by the
last bit of two eigensolvers (JAX 85 iterations, the port 84). Those
tests hold iterations within 1, nodes equal, pobj within 1e-9 and dobj
within the measured spread. Step-level parity (the simplex projection,
the x-step, both z-steps, one AA body step) and a resume from a JAX
mid-solve state carried by interop.sdp_state_to_torch complete it.
"""

import contextlib
import dataclasses
import io
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipper_tpu.solvers import sdp as jsdp
from clipper_tpu_torch import interop
from clipper_tpu_torch.solvers import sdp

from test_dsd import golden_matrix

F64_TOL = 1e-9       # pobj / dobj, f64
F32_REL = 1e-4       # pobj relative, f32
GOLDEN_CLIQUE = {8, 9, 16}


def _planted(seed, n, p_edge, wmax, clique=None):
    """tests/test_sdp.py's planted-clique matrices (identity diagonal)."""
    rng = np.random.default_rng(seed)
    W = np.triu(rng.uniform(0, wmax, size=(n, n)) *
                (rng.uniform(size=(n, n)) < p_edge), 1)
    if clique is None:
        clique = rng.choice(n, 5, replace=False)
    for a in range(len(clique)):
        for b in range(a + 1, len(clique)):
            W[min(clique[a], clique[b]), max(clique[a], clique[b])] = 1.0
    M = W + W.T + np.eye(n)
    return M, (M > 0).astype(float)


def _golden():
    M = golden_matrix()
    return M, (M > 0).astype(float)


def _both(M, C, dtype=np.float64, **kw):
    """(JAX solution, port solution) of one problem, the same Params."""
    M, C = M.astype(dtype), C.astype(dtype)
    return (jsdp.solve(M, C, jsdp.Params(**kw)),
            sdp.solve(M, C, sdp.Params(**kw), device="cpu"))


def _hold(j, t, dtype, iters_slack=0, dobj_tol=F64_TOL):
    """The port's solution t held to JAX's j (see the module docstring)."""
    assert t.nodes == j.nodes
    if dtype == np.float64:
        assert abs(t.iters - j.iters) <= iters_slack, (t.iters, j.iters)
        assert abs(t.pobj - j.pobj) <= F64_TOL, (t.pobj, j.pobj)
        assert abs(t.dobj - j.dobj) <= dobj_tol, (t.dobj, j.dobj)
    else:
        assert abs(t.pobj - j.pobj) <= F32_REL * max(1.0, abs(j.pobj))


DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32],
                                 ids=["f64", "f32"])


@DTYPES
def test_sdr_smoke_20x20(dtype):
    M, C = _golden()
    j, soln = _both(M, C, dtype)
    # golden + AA: the Queue 3 exception, iterations 85 (JAX) and 84,
    # dobj 3.3e-9 apart
    _hold(j, soln, dtype, iters_slack=1, dobj_tol=1e-8)
    assert soln.iters > 0
    assert abs(float(torch.trace(soln.X)) - 1.0) < 1e-2
    assert float(soln.lambdas.min()) > -1e-6
    assert len(soln.nodes) >= 3
    for a in soln.nodes:
        for b in soln.nodes:
            assert C[a, b] != 0
    assert set(soln.nodes) == GOLDEN_CLIQUE
    w = sum(M[a, b] for a in soln.nodes for b in soln.nodes if a < b)
    assert soln.pobj >= 1 + 2 * w / 3 - 1e-2


@DTYPES
def test_sdr_planted_clique(dtype):
    clique = [4, 11, 19, 26, 33, 38]
    M, C = _planted(0, 40, 0.2, 0.2, clique)
    j, soln = _both(M, C, dtype)
    _hold(j, soln, dtype)
    assert set(soln.nodes) == set(clique)


def _batch(seed, B):
    rng = np.random.default_rng(seed)
    Ms, Cs = [], []
    for _ in range(B):
        n = 24
        W = np.triu(rng.uniform(0, 0.3, size=(n, n)) *
                    (rng.uniform(size=(n, n)) < 0.25), 1)
        clique = rng.choice(n, 5, replace=False)
        for a in range(5):
            for b in range(a + 1, 5):
                W[min(clique[a], clique[b]), max(clique[a], clique[b])] = 1.0
        M = W + W.T + np.eye(n)
        Ms.append(M)
        Cs.append((M > 0).astype(float))
    return np.stack(Ms), np.stack(Cs)


@DTYPES
def test_sdr_batched_matches_single(dtype):
    """Each problem of the lock-step batch ends as its own single solve
    (iterations and nodes, f64 pobj within 1e-12), and the batch is held
    to JAX's vmapped solve_batched."""
    Ms, Cs = _batch(3, 3)
    Ms, Cs = Ms.astype(dtype), Cs.astype(dtype)
    solns = sdp.solve_batched(Ms, Cs, device="cpu")
    jsolns = jsdp.solve_batched(Ms, Cs)
    for b in range(3):
        single = sdp.solve(Ms[b], Cs[b], device="cpu")
        assert solns[b].nodes == single.nodes
        assert solns[b].iters == single.iters
        if dtype == np.float64:
            assert solns[b].pobj == pytest.approx(single.pobj, abs=1e-12)
        _hold(jsolns[b], solns[b], dtype)


def test_sdr_batched_freezes_finished_problems():
    """Problems that finish at different iterations: the batch runs until
    the last is done and each keeps its own count (a vmapped while_loop's
    semantics)."""
    M0, C0 = _planted(0, 40, 0.2, 0.2, [4, 11, 19, 26, 33, 38])
    M1, C1 = _golden()
    M1 = np.pad(M1, ((0, 20), (0, 20))) + np.diag([0.0] * 20 + [1.0] * 20)
    C1 = (M1 > 0).astype(float)
    Ms, Cs = np.stack([M0, M1]), np.stack([C0, C1])
    solns = sdp.solve_batched(Ms, Cs, sdp.Params(acceleration_interval=0),
                              device="cpu")
    singles = [sdp.solve(Ms[b], Cs[b], sdp.Params(acceleration_interval=0),
                         device="cpu") for b in range(2)]
    assert solns[0].iters != solns[1].iters
    for s, r in zip(solns, singles):
        assert (s.iters, s.nodes) == (r.iters, r.nodes)


def test_sdr_certified_gap_oracle():
    M, C = _golden()
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iters=20000)
    j, soln = _both(M, C, **kw)
    # golden + AA: the Queue 3 exception, iterations 91 (JAX) and 90
    _hold(j, soln, np.float64, iters_slack=1)
    assert abs(soln.gap) < 1e-3, (soln.pobj, soln.dobj)
    assert soln.gap > -1e-8
    assert set(soln.nodes) == GOLDEN_CLIQUE


@DTYPES
def test_sdr_aa_and_adaptive_rho_match_plain(dtype):
    clique = [2, 9, 17, 25, 30]
    M, C = _planted(5, 32, 0.25, 0.3, clique)
    tight = dict(eps_abs=1e-6, eps_rel=1e-6, max_iters=20000)
    jp, plain = _both(M, C, dtype, acceleration_interval=0,
                      adaptive_rho=False, **tight)
    ja, accel = _both(M, C, dtype, **tight)
    _hold(jp, plain, dtype)
    _hold(ja, accel, dtype)
    assert set(accel.nodes) == set(plain.nodes) == set(clique)
    if dtype == np.float64:
        assert abs(accel.pobj - plain.pobj) < 1e-4
        assert abs(accel.gap) < 1e-3


def test_sdr_chunked_driver_matches_oneshot():
    """verbose/time_limit run the same loop: iters, nodes, pobj and dobj
    equal to the plain run; the residual line printed."""
    M, C = _golden()
    ref = sdp.solve(M, C, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chk = sdp.solve(M, C, sdp.Params(verbose=True, time_limit_secs=3600.0),
                        device="cpu")
    assert chk.iters == ref.iters
    assert chk.nodes == ref.nodes
    assert chk.pobj == pytest.approx(ref.pobj, abs=1e-12)
    assert chk.dobj == pytest.approx(ref.dobj, abs=1e-12)
    assert "r_prim" in buf.getvalue()
    # the JAX chunked driver prints a line at each chunk boundary too
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jsdp.solve(M, C, jsdp.Params(verbose=True, time_limit_secs=3600.0))
    assert (len(buf.getvalue().splitlines())
            == len(jbuf.getvalue().splitlines()))


def test_sdr_time_limit_interrupts():
    M, C = _golden()
    kw = dict(eps_abs=1e-10, eps_rel=1e-10, max_iters=2000)
    jfull, full = _both(M, C, **kw)
    jlim, lim = _both(M, C, time_limit_secs=1e-9, **kw)
    assert lim.iters < full.iters
    assert lim.iters <= 60
    assert abs(float(torch.trace(lim.X)) - 1.0) < 1e-6
    # cut at the first chunk (50 iterations), before the AA tie at 80
    _hold(jlim, lim, np.float64)
    # golden + AA run on: equal iterations, dobj 1.7e-7 apart (Queue 3)
    _hold(jfull, full, np.float64, dobj_tol=1e-6)


@DTYPES
def test_sdr_lowrank_zstep_matches_full(dtype):
    clique = [4, 11, 19, 26, 33, 38]
    M, C = _planted(0, 40, 0.2, 0.2, clique)
    jfull, full = _both(M, C, dtype)
    jlow, low = _both(M, C, dtype, z_rank=8)
    _hold(jfull, full, dtype)
    _hold(jlow, low, dtype)
    assert set(low.nodes) == set(clique) == set(full.nodes)
    assert low.gap <= max(2 * abs(full.gap), 0.1)


def _warned(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec]


def test_auto_tune_param_resolution():
    p = sdp.Params()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sdp._resolve_params(p, 512, 4) == p
    with pytest.warns(UserWarning, match="eps tightened"):
        with pytest.warns(UserWarning, match="z_rank"):
            r = sdp._resolve_params(p, 2048, 4)
    assert r.eps_abs == pytest.approx(1e-4)
    assert r.eps_rel == pytest.approx(1e-4)
    assert r.z_rank == 64
    with pytest.warns(UserWarning, match="Anderson"):
        r = sdp._resolve_params(p, 8192, 4)
    assert r.acceleration_interval == 0
    p2 = sdp.Params(auto_tune=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sdp._resolve_params(p2, 8192, 4) == p2
    p3 = sdp.Params(z_rank=-1, eps_abs=1e-4, eps_rel=1e-4)
    assert sdp._resolve_params(p3, 4096, 4).z_rank == -1
    # the same fields and the same warning texts as the JAX package
    for n, itemsize in ((512, 4), (2048, 4), (4096, 4), (8192, 4),
                        (4096, 8)):
        r, msgs = _warned(lambda: sdp._resolve_params(p, n, itemsize))
        jr, jmsgs = _warned(lambda: jsdp._resolve_params(jsdp.Params(), n,
                                                         itemsize))
        assert msgs == jmsgs
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)


def test_underconvergence_warning_fires_and_clears():
    clique = [2, 5, 11, 17, 20]
    M, C = _planted(7, 24, 0.25, 0.3, clique)
    with pytest.warns(UserWarning, match="under-converged"):
        sdp.solve(M, C, sdp.Params(max_iters=2), device="cpu")
    _, msgs = _warned(lambda: sdp.solve(M, C, sdp.Params(max_iters=2),
                                        device="cpu"))
    _, jmsgs = _warned(lambda: jsdp.solve(M, C, jsdp.Params(max_iters=2)))
    assert msgs == jmsgs
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        soln = sdp.solve(M, C, device="cpu")
        j = jsdp.solve(M, C)
    _hold(j, soln, np.float64)
    assert set(soln.nodes) == set(clique)


# ---------------------------------------------------------------------------
# step-level parity: the JAX expressions of clipper_tpu/solvers/sdp.py
# (:190-199, :232-263), evaluated by JAX on the same numpy inputs
# ---------------------------------------------------------------------------


def _rand_sym(rng, n):
    A = rng.normal(size=(n, n))
    return (A + A.T) / 2


@pytest.mark.parametrize("n", [1, 7, 40])
def test_project_simplex_matches_jax(n):
    rng = np.random.default_rng(n)
    lam = rng.normal(size=(3, n)) * 2
    lam[0, :] = 0.1                  # ties
    got = sdp._project_simplex(torch.tensor(lam)).numpy()
    for b in range(3):
        want = np.asarray(jsdp._project_simplex(jnp.asarray(lam[b])))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-15)
        assert got[b].sum() == pytest.approx(1.0, abs=1e-12)
        assert (got[b] >= 0).all()


def _admm(M, C, **kw):
    return sdp._ADMM(torch.tensor(M)[None], torch.tensor(C)[None],
                     sdp.Params(**kw))


def test_x_step_matches_jax():
    M, C = _planted(0, 40, 0.2, 0.2)
    rng = np.random.default_rng(1)
    Z, U = _rand_sym(rng, 40), _rand_sym(rng, 40)
    rho = 1.7
    got = _admm(M, C).x_step(torch.tensor(Z)[None], torch.tensor(U)[None],
                             torch.tensor([rho], dtype=torch.float64))
    got = got[0].numpy()
    want = np.asarray(jnp.where(jnp.asarray(C) != 0, jnp.maximum(
        jnp.asarray(Z) - jnp.asarray(U) + jnp.asarray(M) / rho, 0.0), 0.0))
    np.testing.assert_array_equal(got, want)


def test_z_step_full_matches_jax():
    M, C = _planted(0, 40, 0.2, 0.2)
    V = np.random.default_rng(2).normal(size=(40, 40))
    Zt, _ = _admm(M, C).z_step_full(torch.tensor(V)[None], None)
    Vj = jnp.asarray(V)
    lam, Qe = jnp.linalg.eigh((Vj + Vj.T) / 2)
    Zj = (Qe * jsdp._project_simplex(lam)) @ Qe.T
    np.testing.assert_allclose(Zt[0].numpy(), np.asarray(Zj), rtol=0,
                               atol=1e-13)
    assert float(torch.trace(Zt[0])) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("power_iters", [1, 2])
def test_z_step_lowrank_matches_jax(power_iters):
    """The same numpy Q warm start; Z compared (Q's column signs are the
    eigensolver's and QR's to choose)."""
    n, r = 40, 8
    M, C = _planted(0, n, 0.2, 0.2)
    rng = np.random.default_rng(3)
    V = _rand_sym(rng, n) + 5 * np.outer(np.ones(n), np.ones(n)) / n
    Q = np.linalg.qr(rng.normal(size=(n, r)))[0]
    admm = _admm(M, C, z_rank=r, z_power_iters=power_iters)
    Zt, Qt = admm.z_step_lowrank(torch.tensor(V)[None], torch.tensor(Q)[None])
    A = jnp.asarray((V + V.T) / 2)
    c = jnp.sqrt(jnp.sum(A * A)) + 1e-6
    Qj = jnp.asarray(Q)
    for _ in range(power_iters):
        Qj = jnp.linalg.qr(A @ Qj + c * Qj)[0]
    S = Qj.T @ (A @ Qj)
    lam, W = jnp.linalg.eigh((S + S.T) / 2)
    Qr = Qj @ W
    Zj = (Qr * jsdp._project_simplex(lam)) @ Qr.T
    np.testing.assert_allclose(Zt[0].numpy(), np.asarray(Zj), rtol=0,
                               atol=1e-12)
    # the subspaces agree whatever the signs
    P_t = Qt[0].numpy() @ Qt[0].numpy().T
    np.testing.assert_allclose(P_t, np.asarray(Qj @ Qj.T), atol=1e-10)


def _jax_state(M, C, params, k):
    """JAX's ADMM carry after k iterations, as numpy."""
    Mj, Cj = jnp.asarray(M), jnp.asarray(C)
    s = jsdp._admm_init(Mj, Cj, params)
    if k:
        s = jsdp._admm_chunk(Mj, Cj, s, params, k)
    return {name: np.asarray(v) for name, v in s._asdict().items()}


def test_aa_body_step_matches_jax():
    """One body step at an AA attempt (it = 9, a full 9-row history), from
    the JAX state carried across: the attempt's acceptance, hist, rho and
    the new (Z, U) as JAX's."""
    M, C = _planted(5, 32, 0.25, 0.3, [2, 9, 17, 25, 30])
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iters=20000)
    jp = jsdp.Params(**kw)
    before = _jax_state(M, C, jp, 9)
    after = _jax_state(M, C, jp, 10)
    assert int(before["it"]) == 9 and int(before["hist"]) > 0
    s = interop.sdp_state_to_torch(before)
    t = _admm(M, C, **kw).body(s)
    assert int(t.it[0]) == int(after["it"]) == 10
    assert int(t.hist[0]) == int(after["hist"])
    assert bool(t.done[0]) == bool(after["done"])
    assert float(t.rho[0]) == float(after["rho"])
    for name in ("Z", "U", "dF", "dG", "f_prev", "g_prev"):
        np.testing.assert_allclose(getattr(t, name)[0].numpy(), after[name],
                                   rtol=0, atol=1e-12, err_msg=name)
    # the candidate was accepted here: the plain step lands elsewhere
    plain = _admm(M, C, **kw).fixed_point(s.Z, s.U, s.rho, s.Qsub)
    assert float((plain[1] - t.Z).abs().max()) > 1e-6


@pytest.mark.parametrize("z_rank,k", [(0, 5), (8, 4)])
def test_resume_from_jax_state(z_rank, k):
    """A JAX mid-solve ADMM state (k iterations in), carried across by
    interop.sdp_state_to_torch, runs on in the port to JAX's iterations
    and nodes of the uninterrupted solve, pobj and dobj within 1e-9."""
    clique = [2, 9, 17, 25, 30]
    M, C = _planted(5, 32, 0.25, 0.3, clique)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iters=20000, z_rank=z_rank)
    ref = jsdp.solve(M, C, jsdp.Params(**kw))
    state = _jax_state(M, C, jsdp.Params(**kw), k)
    s = interop.sdp_state_to_torch(state)
    assert s.Z.shape == (1, 32, 32) and int(s.it[0]) == k
    admm = _admm(M, C, **kw)
    s = sdp._admm_chunk(admm, s, None)
    soln = sdp._solutions(admm, torch.tensor(C)[None], s, 0.0)[0]
    _hold(ref, soln, np.float64)
    assert set(soln.nodes) == set(clique)


def test_solve_raises_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    M, C = _golden()
    for call in (lambda: sdp.solve(M, C),
                 lambda: sdp.solve_batched(M[None], C[None])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
