"""Port parity: flat-triangle storage, the tri matvec and the tri build.

The same numpy inputs go through clipper_tpu.ops.flattri (its XLA path and
its Pallas kernels in interpret mode) and clipper_tpu_torch.ops.flattri
(the plain PyTorch versions the CPU takes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import flattri as jflattri
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu_torch import _kernels, interop
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops import flattri
from clipper_tpu_torch.ops.affinity import gather_endpoints


def _random_stacked(rng, m, density=0.3, dtype=np.float64):
    M = rng.random((m, m)).astype(dtype)
    M = np.triu(M, 1)
    M[M < 1.0 - density] = 0.0
    M = M + M.T
    C = (M > 0).astype(dtype)
    return np.concatenate([M, C], axis=0)


def _storage(rng, P, m, t, kind):
    """(P, 2t, S) storage of random stacked pairs, as numpy, per kind."""
    MCs = [_random_stacked(rng, m) for _ in range(P)]
    if kind == "int8":
        MCs = [np.asarray(jmsrc_flat.quantize_stacked(jnp.asarray(MC)))
               for MC in MCs]
    elif kind == "f32":
        MCs = [MC.astype(np.float32) for MC in MCs]
    elif kind == "bf16":
        MCs = [jnp.asarray(MC, jnp.bfloat16) for MC in MCs]
    return np.stack([np.asarray(jflattri.repack_stacked(jnp.asarray(MC), t))
                     for MC in MCs])


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_layout_helpers_match(nt):
    assert flattri.tri_tile_offsets(nt) == jflattri.tri_tile_offsets(nt)
    assert flattri.tri_ncols(nt, 128) == jflattri.tri_ncols(nt, 128)
    for a, b in zip(flattri.tri_coords(nt), jflattri.tri_coords(nt)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(nt)
    t = 16
    MC = _random_stacked(rng, nt * t)
    ref = np.asarray(jflattri.repack_stacked(jnp.asarray(MC), t))
    got = flattri.repack_stacked(torch.from_numpy(MC), t)
    np.testing.assert_array_equal(got.numpy(), ref)
    # dense_stacked inverts the repack
    np.testing.assert_array_equal(flattri.dense_stacked(got, nt).numpy(), MC)


@pytest.mark.parametrize("kind,K", [(k, K) for k in ("f64", "f32", "int8",
                                                     "bf16")
                                    for K in (1, 16)])
def test_plain_matvec_matches_jax(kind, K):
    rng = np.random.default_rng(10 + K)
    t, nt, P, B = 128, 2, 3, 4
    m = t * nt
    tri_np = _storage(rng, P, m, t, kind)
    idx = rng.integers(0, P, B).astype(np.int32)
    wdt = np.float64 if kind == "f64" else np.float32
    U = rng.random((B, K, m)).astype(wdt)
    U /= np.linalg.norm(U, axis=-1, keepdims=True)
    Uj = jnp.asarray(U if K > 1 else U[:, 0])
    tol = 1e-12 if kind == "f64" else 1e-4

    tri_t = interop.tri_to_torch(tri_np)
    bmv = flattri.make_tri_pool_matvec(tri_t, nt, torch.from_numpy(U).dtype)
    MU, CU = bmv(torch.from_numpy(idx), torch.from_numpy(U if K > 1
                                                          else U[:, 0]))
    for maker in (jflattri.make_tri_pool_matvec_xla,
                  jflattri.make_tri_pool_matvec):
        rM, rC = maker(jnp.asarray(tri_np), nt, Uj.dtype)(jnp.asarray(idx),
                                                          Uj)
        np.testing.assert_allclose(MU.numpy(), np.asarray(rM), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(CU.numpy(), np.asarray(rC), rtol=0,
                                   atol=tol)


def _bunny_problems(W, m, seed):
    rng = np.random.default_rng(seed)
    pcd0 = harness.load_bunny().astype(np.float32)
    probs = [harness.make_problem(pcd0, m, 0.9, rng) for _ in range(W)]
    D2s = np.stack([p[0] for p in probs]).astype(np.float32)
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    return pcd0, D2s, As


def test_plain_build_matches_jax():
    W, m, t = 2, 256, 128
    pcd0, D2s, As = _bunny_problems(W, m, seed=2)
    inv_j = jharness.default_invariant()
    D1j = jnp.asarray(pcd0, jnp.float32)
    xla = np.stack([np.asarray(jflattri.build_tri_xla(
        inv_j, D1j, jnp.asarray(D2s[w]), jnp.asarray(As[w]), m, t=t))
        for w in range(W)])
    P1j = D1j[jnp.asarray(As[..., 0])]
    P2j = jnp.stack([jnp.asarray(D2s[w])[As[w, :, 1]] for w in range(W)])
    pallas = np.asarray(jflattri.build_tri_pallas(
        inv_j, P1j, P2j, jnp.asarray(As), jnp.full((W,), m, jnp.int32), t=t))

    P1, P2 = gather_endpoints(torch.from_numpy(pcd0), torch.from_numpy(D2s),
                              torch.from_numpy(As))
    got = flattri.build_tri_plain(harness.default_invariant(), P1, P2,
                                  torch.from_numpy(As),
                                  torch.full((W,), m), t=t).numpy()
    assert got.shape == xla.shape == (W, 2 * t, flattri.tri_ncols(2, t))
    for ref in (xla, pallas):
        np.testing.assert_array_equal(got[:, t:], ref[:, t:])      # C exact
        d = np.abs(got[:, :t].astype(int) - ref[:, :t].astype(int))
        assert d.max() <= 1
        # +-1 codes only at round(127 s) ties moved by an ulp of exp
        assert (d > 0).sum() <= 1e-3 * (ref[:, t:] > 0).sum()


def test_plain_build_bf16_matches_jax():
    """The plain tri build in bf16 against the JAX package's
    build_tri_pallas(storage_dtype=bfloat16) in interpret mode: C exact;
    M equal, or one bf16 ulp apart where exp's last f32 bit moved the
    rounding, on at most 1 in 1000 stored edges."""
    W, m, t = 2, 256, 128
    pcd0, D2s, As = _bunny_problems(W, m, seed=2)
    D1j = jnp.asarray(pcd0, jnp.float32)
    P1j = D1j[jnp.asarray(As[..., 0])]
    P2j = jnp.stack([jnp.asarray(D2s[w])[As[w, :, 1]] for w in range(W)])
    ref = interop.tri_to_torch(np.asarray(jflattri.build_tri_pallas(
        jharness.default_invariant(), P1j, P2j, jnp.asarray(As),
        jnp.full((W,), m, jnp.int32), t=t, storage_dtype=jnp.bfloat16)))
    P1, P2 = gather_endpoints(torch.from_numpy(pcd0), torch.from_numpy(D2s),
                              torch.from_numpy(As))
    got = flattri.build_tri_plain(harness.default_invariant(), P1, P2,
                                  torch.from_numpy(As), torch.full((W,), m),
                                  t=t, storage_dtype=torch.bfloat16)
    assert got.dtype == ref.dtype == torch.bfloat16
    assert got.shape == ref.shape == (W, 2 * t, flattri.tri_ncols(2, t))
    assert torch.equal(got[:, t:], ref[:, t:])                 # C exact
    nnz = int((ref[:, t:] > 0).sum())
    assert nnz > 0
    # M >= 0: adjacent bf16 values are adjacent 16-bit patterns
    ulps = (got[:, :t].view(torch.int16).int()
            - ref[:, :t].view(torch.int16).int()).abs()
    assert int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) <= 1e-3 * nnz


def test_build_wrapper_takes_plain_on_cpu():
    W, m, t = 2, 256, 128
    pcd0, D2s, As = _bunny_problems(W, m, seed=3)
    P1, P2 = gather_endpoints(torch.from_numpy(pcd0), torch.from_numpy(D2s),
                              torch.from_numpy(As))
    A = torch.from_numpy(As)
    mts = torch.tensor([m, 200])
    inv = harness.default_invariant()
    before = dict(_kernels.LAUNCHES)
    a = flattri.build_tri(inv, P1, P2, A, mts, t=t)
    b = flattri.build_tri_plain(inv, P1, P2, A, mts, t=t)
    assert torch.equal(a, b)
    assert _kernels.LAUNCHES == before          # no kernel on the CPU
    # rows/cols >= m_true carry no edges
    dense = flattri.dense_stacked(a, m // t)
    assert not dense[1, :, 200:].any() and not dense[1, 200:m].any()
