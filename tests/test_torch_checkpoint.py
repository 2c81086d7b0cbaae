"""Port parity: solver-state checkpoint/resume (utils/checkpoint.py with
msrc_flat.flat_solve_ticks), mirroring tests/test_checkpoint.py: a
killed-and-resumed f64 solve reproduces the uninterrupted trajectory bit
for bit, a carry saved by the JAX package's save_solver_state loads in
the port and resumes bit-exactly to JAX's straight-through f64
trajectory, and an f64 carry stays f64."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops.affinity import score_pairwise_consistency as jscore
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu.types import Params as JParams
from clipper_tpu.utils import checkpoint as jcheckpoint
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops.affinity import score_pairwise_consistency
from clipper_tpu_torch.solvers import msrc_flat
from clipper_tpu_torch.types import Params
from clipper_tpu_torch.utils import checkpoint


def _problem(m=200, rho=0.9, seed=0):
    rng = np.random.default_rng(seed)
    pcd0 = harness.load_bunny()
    pcd1, A, _ = harness.make_problem(pcd0, m, rho, rng)
    return pcd0, pcd1, A


def _port_mc(m=200):
    pcd0, pcd1, A = _problem(m)
    M, C = score_pairwise_consistency(
        harness.default_invariant(), torch.tensor(pcd0, dtype=torch.float64),
        torch.tensor(pcd1, dtype=torch.float64), torch.tensor(A))
    return M, C


def _u0(m, seed=0):
    return torch.tensor(np.random.default_rng(seed).random(m))


def test_kill_and_resume_bitexact_f64(tmp_path):
    M, C = _port_mc()
    params = Params()
    u0 = _u0(M.shape[0])
    mv = msrc_flat.stacked_dual_matvec(M, C)
    u_ref, F_ref, i_ref, ticks_ref, _ = msrc_flat.flat_solve_single(
        mv, u0, params, return_ticks=True)

    state = msrc_flat.flat_init(mv, u0, params)
    path = tmp_path / "carry.npz"
    nchunks = 0
    while not bool(state.done):
        state = msrc_flat.flat_solve_ticks(mv, state, params, ticks=7)
        checkpoint.save_solver_state(path, state)
        state = checkpoint.load_solver_state(path, device="cpu")
        nchunks += 1
        assert nchunks < 1000
    assert nchunks > 2
    assert state.u.dtype == torch.float64

    assert torch.equal(state.u, u_ref)
    assert torch.equal(state.F, F_ref)
    assert int(state.i) == int(i_ref)
    assert int(state.ticks) == int(ticks_ref)


def test_batched_carry_roundtrip(tmp_path):
    """A batched carry: dtypes and values survive the round-trip."""
    M, C = _port_mc(128)
    mv = msrc_flat.stacked_dual_matvec(M, C)

    def lanes(idx, U):          # three lanes over the one problem
        return tuple(x.T for x in mv(U.T))

    U0 = torch.tensor(np.random.default_rng(1).random((3, 128)))
    states = msrc_flat.flat_init_batched(lanes, None, U0, Params())
    path = tmp_path / "batch.npz"
    checkpoint.save_solver_state(path, states)
    back = checkpoint.load_solver_state(path, device="cpu")
    for a, b in zip(states, back):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_jax_saved_carry_resumes_bitexact(tmp_path):
    """The JAX package saves a mid-solve f64 carry; the port loads it bit
    for bit (f64 kept) and drives it to the end. Resumed in chunks through
    the port's own save/load it is bit-equal to the port's uninterrupted
    drive of that carry; against JAX's straight-through run it ends at the
    same outer iteration, tick count, rejected probes and support, u and F
    within 1e-12: the f64 matvecs sum in another order than XLA's (ROADMAP
    Queue 3; 6.5e-15 apart in u at the end), so the bits cannot be
    JAX's."""
    pcd0, pcd1, A = _problem()
    M, C = jscore(jharness.default_invariant(), jnp.asarray(pcd0),
                  jnp.asarray(pcd1), jnp.asarray(A, jnp.int32))
    u0 = np.random.default_rng(0).random(M.shape[0])
    jmv = jmsrc_flat.stacked_dual_matvec(M, C)
    u_ref, F_ref, i_ref, ticks_ref, nback_ref = jmsrc_flat.flat_solve_single(
        jmv, jnp.asarray(u0), JParams(), return_ticks=True)
    state = jmsrc_flat.flat_init(jmv, jnp.asarray(u0), JParams())
    state = jmsrc_flat.flat_solve_ticks(jmv, state, JParams(), ticks=10)
    assert not bool(state.done)
    path = tmp_path / "jax_carry.npz"
    jcheckpoint.save_solver_state(path, state)

    back = checkpoint.load_solver_state(path, device="cpu")
    for name, want in state._asdict().items():
        got = getattr(back, name)
        assert str(got.dtype).split(".")[1] == str(np.asarray(want).dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    mv = msrc_flat.stacked_dual_matvec(torch.tensor(np.asarray(M)),
                                       torch.tensor(np.asarray(C)))
    straight = msrc_flat.flat_solve_ticks(mv, back, Params(), ticks=None)
    s = back
    while not bool(s.done):
        s = msrc_flat.flat_solve_ticks(mv, s, Params(), ticks=7)
        checkpoint.save_solver_state(path, s)
        s = checkpoint.load_solver_state(path, device="cpu")
    for a, b in zip(straight, s):
        assert torch.equal(a, b)
    assert (int(s.i), int(s.ticks), int(s.nback)) == (
        int(i_ref), int(ticks_ref), int(nback_ref))
    np.testing.assert_array_equal(s.u.numpy() > 0, np.asarray(u_ref) > 0)
    np.testing.assert_allclose(s.u.numpy(), np.asarray(u_ref), rtol=0,
                               atol=1e-12)
    assert abs(float(s.F) - float(F_ref)) <= 1e-12


def test_f64_carry_stays_f64_under_f32_default(tmp_path):
    """The JAX loader downcasts f64 when x64 is off; the port's keeps the
    saved dtypes whatever torch's default dtype is."""
    M, C = _port_mc(64)
    mv = msrc_flat.stacked_dual_matvec(M, C)
    state = msrc_flat.flat_init(mv, _u0(64), Params())
    path = tmp_path / "f64.npz"
    checkpoint.save_solver_state(path, state)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        back = checkpoint.load_solver_state(path, device="cpu")
    finally:
        torch.set_default_dtype(old)
    for name, a, b in zip(state._fields, state, back):
        assert b.dtype == a.dtype, name
        assert torch.equal(a, b), name
    assert back.u.dtype == torch.float64
