"""Port parity: the fused pattern dual matvec (M u, C u from one read of M).

Mirrors tests/test_fused_matvec.py: the JAX package's Pallas kernel
(interpret mode on the CPU) against clipper_tpu_torch.ops.fused_matvec,
whose CPU tensors take the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.ops import fused_matvec as jfused
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu_torch import _kernels
from clipper_tpu_torch.ops import fused_matvec
from clipper_tpu_torch.solvers import msrc, msrc_flat


def _sym(rng, m, density, B=None):
    shape = (m, m) if B is None else (B, m, m)
    W = np.where(rng.uniform(size=shape) < density, rng.uniform(size=shape),
                 0.0)
    Wu = np.triu(W, 1)
    return (Wu + np.swapaxes(Wu, -1, -2)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pattern_dual_matvec_matches_jax(dtype):
    """B=2, m=256: the plain version against the JAX kernel within 1e-5
    (f32 sums of the same f32 products in another order), and against an
    f64 oracle; no kernel launch on the CPU."""
    rng = np.random.default_rng(0)
    B, m = 2, 256
    M = _sym(rng, m, 0.1, B)
    u = rng.uniform(size=(B, m)).astype(np.float32)
    Mj = jnp.asarray(M).astype(getattr(jnp, dtype))
    jMu, jCu = jfused.pattern_dual_matvec(Mj, jnp.asarray(u))
    Mt = torch.from_numpy(M).to(getattr(torch, dtype))
    before = dict(_kernels.LAUNCHES)
    Mu, Cu = fused_matvec.pattern_dual_matvec(Mt, torch.from_numpy(u))
    assert _kernels.LAUNCHES == before
    assert Mu.dtype == Cu.dtype == torch.float32 and Mu.shape == (B, m)
    np.testing.assert_allclose(Mu.numpy(), np.asarray(jMu), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(Cu.numpy(), np.asarray(jCu), rtol=0,
                               atol=1e-5)
    M64 = Mt.double()
    u64 = torch.from_numpy(u).double()
    np.testing.assert_allclose(Mu.numpy(), (M64 @ u64[..., None])[..., 0],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(Cu.numpy(),
                               ((M64 > 0).double() @ u64[..., None])[..., 0],
                               rtol=0, atol=1e-5)


def test_flat_solver_with_fused_closure_matches_jax():
    """The flat solver over the single-problem closure: the same mask as
    JAX's over its kernel, F within 1e-4 relative, and the same mask as
    the port's own stacked matvec."""
    rng = np.random.default_rng(1)
    m = 256
    M = _sym(rng, m, 0.2)
    C = (M > 0).astype(np.float32)
    u0 = rng.uniform(size=m).astype(np.float32)
    ju, jF, _ = jmsrc_flat.flat_solve_single(
        jfused.make_pattern_dual_matvec(jnp.asarray(M)), jnp.asarray(u0),
        ct.Params())
    jmask = np.asarray(jmsrc.round_solution(ju, jF))
    Mt, Ct, u0t = map(torch.from_numpy, (M, C, u0))
    mv = fused_matvec.make_pattern_dual_matvec(Mt)
    Mu, Cu = mv(u0t)
    assert Mu.shape == (m,) and Mu.dtype == u0t.dtype
    u, F, _ = msrc_flat.flat_solve_single(mv, u0t)
    mask = msrc.round_solution(u, F).numpy()
    np.testing.assert_array_equal(mask, jmask)
    assert abs(float(F) - float(jF)) <= 1e-4 * abs(float(jF))
    us, Fs, _ = msrc_flat.flat_solve_single(
        msrc_flat.stacked_dual_matvec(Mt, Ct), u0t)
    np.testing.assert_array_equal(msrc.round_solution(us, Fs).numpy(), mask)


def test_bf16_storage_with_f32_polish():
    """bf16 M through the fused closure, F recomputed from the f32 [M; C]:
    the planted clique is selected, as in the f32 solve and in JAX's."""
    rng = np.random.default_rng(2)
    m = 256
    W = np.where(rng.uniform(size=(m, m)) < 0.15, rng.uniform(size=(m, m)),
                 0.0)
    Wu = np.triu(W, 1)
    nodes = [3, 50, 99, 140, 200, 230]
    for a in range(len(nodes)):
        for b in range(a + 1, len(nodes)):
            Wu[min(nodes[a], nodes[b]), max(nodes[a], nodes[b])] = 0.97
    M = (Wu + Wu.T).astype(np.float32)
    C = (M > 0).astype(np.float32)
    u0 = rng.uniform(size=m).astype(np.float32)

    Mj = jnp.asarray(M)
    jmv = jfused.make_pattern_dual_matvec(Mj.astype(jnp.bfloat16))
    ju, _, _ = jmsrc_flat.flat_solve_single(
        lambda u: tuple(x.astype(jnp.float32) for x in jmv(u)),
        jnp.asarray(u0), ct.Params())
    jF = jmsrc_flat.recompute_objective(
        jmsrc_flat.stacked_dual_matvec(Mj, jnp.asarray(C)), ju)
    jmask = np.asarray(jmsrc.round_solution(ju, jF))

    Mt, Ct, u0t = map(torch.from_numpy, (M, C, u0))
    mv16 = fused_matvec.make_pattern_dual_matvec(Mt.to(torch.bfloat16))
    u16, _, _ = msrc_flat.flat_solve_single(mv16, u0t)
    F16 = msrc_flat.recompute_objective(msrc_flat.stacked_dual_matvec(Mt, Ct),
                                        u16)
    mask16 = msrc.round_solution(u16, F16).numpy()
    u32, F32, _ = msrc_flat.flat_solve_single(
        msrc_flat.stacked_dual_matvec(Mt, Ct), u0t)
    assert set(np.flatnonzero(mask16)) >= set(nodes)
    np.testing.assert_array_equal(mask16, msrc.round_solution(u32,
                                                              F32).numpy())
    np.testing.assert_array_equal(mask16, jmask)


def test_cuda_wrapper_guards():
    """The kernel's wrapper refuses CPU tensors and f64 (the TPU kernel
    computes in f32 too) rather than fall back."""
    M = torch.zeros(1, 8, 8)
    u = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="on the card"):
        fused_matvec.pattern_dual_matvec_cuda(M, u)
    with pytest.raises(NotImplementedError, match="f32/bf16"):
        fused_matvec.pattern_dual_matvec_cuda(M.double(), u)
