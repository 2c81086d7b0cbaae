"""Port parity: block-sparse (occupied-tile) storage, its matvec and solves.

Mirrors tests/test_blocksparse.py against clipper_tpu.ops.blocksparse on
the same numpy inputs: the build functions' storage byte for byte
(from_dense and from_scipy), the matvec against the dense matvec in f32
and int8 and against JAX's (multiprobe columns, padding), the
fixed-order row sums bit-identical on a rerun, the dense fall-back at
high occupancy, and solve_single from the same u0. Tolerances: 1e-5 for f32 sums of one
product in another order; the solves' supports and ifinal compare
exactly, their DSD_HEU masks by size (see the solve test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clipper_tpu as ct
from clipper_tpu.ops import blocksparse as jbs
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu_torch.bench import blocksparse_bench
from clipper_tpu_torch.ops import blocksparse
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params

from test_blocksparse import structured_graph

STORAGE = {"f32": (None, None), "int8": (torch.int8, jnp.int8),
           "bf16": (torch.bfloat16, jnp.bfloat16),
           "f64": (torch.float64, jnp.float64)}


@pytest.mark.parametrize("storage", list(STORAGE))
def test_build_functions_match_jax(storage):
    """from_dense and from_scipy give JAX's tiles, rows and cols; each
    tile row's slots list its tiles in order."""
    sd, jsd = STORAGE[storage]
    M, C = structured_graph(np.random.default_rng(0), m=256, blocks=4)
    bs, info = blocksparse.from_dense(M, C, tile=32, storage_dtype=sd,
                                      device="cpu")
    jb, jinfo = jbs.from_dense(M, C, tile=32, storage_dtype=jsd)
    assert {k: info[k] for k in jinfo} == jinfo
    assert info["occupancy"] <= 0.25 + 1e-9
    np.testing.assert_array_equal(bs.tiles.to(torch.float64).numpy(),
                                  np.asarray(jb.tiles, np.float64))
    np.testing.assert_array_equal(bs.rows.numpy(), np.asarray(jb.rows))
    np.testing.assert_array_equal(bs.cols.numpy(), np.asarray(jb.cols))
    for r in range(info["nt"]):
        mine = bs.slots[r][bs.slots[r] < len(bs.rows)].numpy()
        np.testing.assert_array_equal(mine, np.flatnonzero(bs.rows == r))
    bss, _ = blocksparse.from_scipy(sp.csr_matrix(M), sp.csr_matrix(C),
                                    tile=32, storage_dtype=sd, device="cpu")
    for a, b in zip(bss, bs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [None, 5])
def test_matvec_matches_dense_f32(K):
    """f32 tiles: (M u, C u) of a vector and of K multiprobe columns
    against numpy's f32 products (1e-5), and against JAX's matvec."""
    rng = np.random.default_rng(1)
    M, C = structured_graph(rng, m=256, blocks=4)
    bs, info = blocksparse.from_dense(M, C, tile=32, storage_dtype=None,
                                      device="cpu")
    U = rng.uniform(size=256 if K is None else (256, K)).astype(np.float32)
    Mu, Cu = blocksparse.make_matvec(bs, info["nt"], torch.float32)(
        torch.as_tensor(U))
    np.testing.assert_allclose(Mu.numpy(), M.astype(np.float32) @ U,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Cu.numpy(), C.astype(np.float32) @ U,
                               rtol=1e-5, atol=1e-5)
    jb, _ = jbs.from_dense(M, C, tile=32, storage_dtype=None)
    jMu, jCu = jax.jit(jbs.make_matvec(jb, info["nt"], jnp.float32))(
        jnp.asarray(U))
    np.testing.assert_allclose(Mu.numpy(), np.asarray(jMu), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(Cu.numpy(), np.asarray(jCu), rtol=0,
                               atol=1e-5)


def test_int8_matches_dense_int8_matvec_and_jax():
    """int8 tiles against the dense stacked int8 matvec over the same codes
    (1e-5), and equal to JAX's tile matvec to 1e-6 (the same bf16
    products and f32 row sums, added in the same order)."""
    rng = np.random.default_rng(2)
    M, C = structured_graph(rng, m=128, blocks=4)
    u = rng.uniform(size=128).astype(np.float32)
    bs, info = blocksparse.from_dense(M, C, tile=32,
                                      storage_dtype=torch.int8, device="cpu")
    Mu, Cu = blocksparse.make_matvec(bs, info["nt"], torch.float32)(
        torch.as_tensor(u))
    MC = msrc_flat.quantize_stacked(torch.cat([
        torch.as_tensor(M, dtype=torch.float32),
        torch.as_tensor(C, dtype=torch.float32)]))
    Mu_d, Cu_d = msrc_flat.make_stacked_matvec(MC, torch.float32)(
        torch.as_tensor(u))
    np.testing.assert_allclose(Mu.numpy(), Mu_d.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Cu.numpy(), Cu_d.numpy(), rtol=1e-5,
                               atol=1e-5)
    jb, _ = jbs.from_dense(M, C, tile=32, storage_dtype=jnp.int8)
    jMu, jCu = jax.jit(jbs.make_matvec(jb, info["nt"], jnp.float32))(
        jnp.asarray(u))
    np.testing.assert_allclose(Mu.numpy(), np.asarray(jMu), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(Cu.numpy(), np.asarray(jCu), rtol=0,
                               atol=1e-6)


def test_rerun_is_bit_identical():
    """The row sums run in a fixed order: two calls agree bit for bit."""
    rng = np.random.default_rng(3)
    M, C = structured_graph(rng, m=256, blocks=4)
    bs, info = blocksparse.from_dense(M, C, tile=32,
                                      storage_dtype=torch.int8, device="cpu")
    mv = blocksparse.make_matvec(bs, info["nt"], torch.float32)
    U = torch.as_tensor(rng.uniform(size=(256, 16)).astype(np.float32))
    a, b = mv(U), mv(U)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_high_occupancy_falls_back_dense():
    rng = np.random.default_rng(3)
    m = 64
    W = rng.uniform(size=(m, m))
    M = np.triu((W + W.T) / 2, 1)
    M = M + M.T
    C = (M > 0).astype(np.float64)
    for build in (blocksparse.from_dense,
                  lambda M, C, **kw: blocksparse.from_scipy(
                      sp.csr_matrix(M), sp.csr_matrix(C), **kw)):
        bs, info = build(M, C, tile=16, storage_dtype=torch.int8,
                         device="cpu")
        assert bs is None and info["occupancy"] == 1.0
        assert info["dense"].shape == (2 * m, m)
        assert info["dense"].dtype == torch.int8
        jb, jinfo = jbs.from_dense(M, C, tile=16, storage_dtype=jnp.int8)
        np.testing.assert_array_equal(info["dense"].numpy(),
                                      np.asarray(jinfo["dense"]))


def test_padding_non_divisible_m():
    rng = np.random.default_rng(4)
    M, C = structured_graph(rng, m=96, blocks=3)
    bs, info = blocksparse.from_dense(M, C, tile=64, storage_dtype=None,
                                      device="cpu")
    assert info["m_pad"] == 128
    u = np.zeros(128, np.float32)
    u[:96] = rng.uniform(size=96)
    Mu, _ = blocksparse.make_matvec(bs, info["nt"], torch.float32)(
        torch.as_tensor(u))
    np.testing.assert_allclose(Mu.numpy()[:96], M.astype(np.float32) @ u[:96],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(Mu.numpy()[96:], 0.0)


@pytest.mark.parametrize("storage, probes, power", [
    ("f32", 1, 0), ("int8", 1, 0), ("int8", 8, 4), ("bf16", 8, 4)])
def test_solve_single_matches_jax(storage, probes, power):
    """tests/test_blocksparse.py's structured scene with a planted clique,
    the same f32 u0 through both solve_single: supports equal and the
    planted clique, ifinal equal, F within 1e-5 relative, and the DSD_HEU
    masks of equal size inside the clique (omega's cut among the clique's
    near-equal entries may pick other members, as the JAX test notes).
    f64 storage is left out: both packages round its tile products to f32,
    and an f64 solve over them (no stall guard in f64) can run out its
    outer iterations on either package's rounding."""
    sd, jsd = STORAGE[storage]
    rng = np.random.default_rng(5)
    m = 256
    M, C = structured_graph(rng, m=m, blocks=4, density=0.3)
    cl = np.arange(128, 148)
    M[np.ix_(cl, cl)] = 0.9
    M[cl, cl] = 0.0
    C = (M > 0).astype(np.float64)
    u0 = rng.uniform(size=m).astype(np.float32)
    u, F, ifinal, info = blocksparse.solve_single(
        M, C, u0, Params(), tile=32, storage_dtype=sd, probes=probes,
        power_steps=power, device="cpu")
    ju, jF, ji, _ = jbs.solve_single(M, C, u0, ct.Params(), tile=32,
                                     storage_dtype=jsd, probes=probes,
                                     power_steps=power)
    assert info["occupancy"] < 0.5
    np.testing.assert_array_equal(u.numpy() > 0, np.asarray(ju) > 0)
    assert set(np.flatnonzero(u.numpy() > 0)) == set(cl)
    assert int(ifinal) == int(ji)
    assert abs(float(F) - float(jF)) <= 1e-5 * abs(float(jF))
    mask = msrc.round_solution(u, F).numpy()
    jmask = np.asarray(jmsrc_flat.msrc.round_solution(ju, jF))
    assert mask.sum() == jmask.sum() > 0
    assert set(np.flatnonzero(mask)) <= set(cl)


def test_solve_prepared_multi_lanes_are_their_own():
    """K restarts as lanes of one solve: each lane reaches the planted
    clique's support, and lane 0 equals solve_prepared of its init."""
    rng = np.random.default_rng(6)
    M, C = structured_graph(rng, m=128, blocks=4, density=0.3)
    cl = np.arange(32, 50)
    M[np.ix_(cl, cl)] = 0.95
    M[cl, cl] = 0.0
    C = (M > 0).astype(np.float64)
    bs, info = blocksparse.from_dense(M, C, tile=32,
                                      storage_dtype=torch.int8, device="cpu")
    u0s = torch.as_tensor(rng.uniform(size=(3, 128)).astype(np.float32))
    us, Fs, ifs = blocksparse.solve_prepared_multi(bs, info, u0s, Params(),
                                                   power_steps=4)
    u, F, i = blocksparse.solve_prepared(bs, info, u0s[0], Params(),
                                         power_steps=4)
    assert us.shape == (3, 128) and Fs.shape == (3,)
    np.testing.assert_array_equal(us[0].numpy() > 0, u.numpy() > 0)
    for k in range(3):
        assert set(np.flatnonzero(us[k].numpy() > 0)) == set(cl)


def test_blocksparse_bench_small_cpu():
    """bench/blocksparse_bench.main at m=512, k=4, tile=64 on the CPU: the
    scene is block-sparse and both storages find an object's clique."""
    row = blocksparse_bench.main(["512", "4", "1", "--tile=64",
                                  "--probes=8", "--device=cpu"])
    assert row["occupancy"] <= 0.5 and row["n_tiles"] > 0
    assert row["P_dense"] == row["P_block"] == 1.0
    assert row["R_block"] > 0.8
