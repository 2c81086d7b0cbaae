"""Port parity: successive clique extraction (solvers/extract.py).

Mirrors tests/test_extract.py. One peel (_extract_step) from the same numpy
u0 and keep mask against clipper_tpu.solvers.extract: the same support and
ifinal, and over f64 storage F to 1e-9 relative. The support
polish against JAX's to 1e-6 relative (f32). The peel loop recovers the
planted cliques of tests/test_extract.py, disjoint and densest first,
with the port's own torch.Generator draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.solvers import extract as jex
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu_torch.solvers import extract, msrc_flat
from clipper_tpu_torch.types import Params, Rounding

from test_extract import planted_graph

NZ = Params(rounding=Rounding.NONZERO)


def _stores(M, C, storage):
    """The stacked [M; C] both packages solve over: f64 (exact), f32 or
    int8 codes."""
    jdt = jnp.float64 if storage == "f64" else jnp.float32
    tdt = torch.float64 if storage == "f64" else torch.float32
    MCj = jnp.concatenate([jnp.asarray(M, jdt), jnp.asarray(C, jdt)])
    MCt = torch.cat([torch.as_tensor(M, dtype=tdt),
                     torch.as_tensor(C, dtype=tdt)])
    if storage == "int8":
        return jmsrc_flat.quantize_stacked(MCj), msrc_flat.quantize_stacked(
            MCt)
    return MCj, MCt


@pytest.mark.parametrize("storage", ["f64", "f32", "int8"])
@pytest.mark.parametrize("probes, power", [(1, 0), (8, 4)])
def test_extract_step_matches_jax(storage, probes, power):
    """f64 storage and u0: the same support, ifinal and F to 1e-9
    relative. f32 and int8 storage with an f32 u0: the same support and
    ifinal (the f32 sums, in another order, move the in-loop F)."""
    rng = np.random.default_rng(0)
    M, C, planted = planted_graph(rng)
    m = M.shape[0]
    keep = np.ones(m)
    keep[sorted(planted[1])] = 0.0      # the 20-clique already peeled
    u0 = rng.uniform(0.01, 1.0, size=m)
    jdt, tdt = ((jnp.float64, torch.float64) if storage == "f64"
                else (jnp.float32, torch.float32))
    MCj, MCt = _stores(M, C, storage)
    ju, jF, ji = jex._extract_step(MCj, jnp.asarray(keep, jdt),
                                   jnp.asarray(u0, jdt), params=ct.Params(),
                                   probes=probes, power_steps=power)
    u, F, i = extract._extract_step(MCt, torch.as_tensor(keep, dtype=tdt),
                                    torch.as_tensor(u0, dtype=tdt),
                                    params=Params(), probes=probes,
                                    power_steps=power)
    np.testing.assert_array_equal(u.numpy() > 0, np.asarray(ju) > 0)
    assert int(i) == int(ji)
    assert not (u.numpy()[keep == 0] > 0).any()
    if storage == "f64":
        assert abs(float(F) - float(jF)) <= 1e-9 * abs(float(jF))


def test_support_quadform_and_bucket_match_jax():
    rng = np.random.default_rng(1)
    M, _, _ = planted_graph(rng)
    m = M.shape[0]
    u = np.where(rng.uniform(size=m) < 0.2, rng.uniform(size=m), 0.0)
    keep = (rng.uniform(size=m) < 0.8).astype(np.float32)
    nnz = int((u * keep > 0).sum())
    k = extract._polish_bucket(nnz, m)
    assert k == jex._polish_bucket(nnz, m) >= nnz
    assert extract._polish_bucket(5, 40) == 40
    got = extract._support_quadform(
        torch.as_tensor(M, dtype=torch.float32),
        torch.as_tensor(u, dtype=torch.float32), torch.as_tensor(keep), k=k)
    ref = jex._support_quadform(jnp.asarray(M, jnp.float32),
                                jnp.asarray(u, jnp.float32),
                                jnp.asarray(keep), k=k)
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


@pytest.mark.parametrize("storage, seed", [(None, 0), (torch.int8, 3)])
def test_extracts_all_planted_cliques(storage, seed):
    rng = np.random.default_rng(0 if storage is None else 1)
    M, C, planted = planted_graph(rng)
    res = extract.extract_cliques(M, C, torch.Generator().manual_seed(seed),
                                  NZ, max_cliques=6, min_size=5,
                                  storage_dtype=storage, device="cpu")
    found = [set(np.flatnonzero(r.mask).tolist()) for r in res]
    for p in planted:
        assert any(f == p for f in found), (p, found)
    nodes = [i for f in found for i in f]
    assert len(nodes) == len(set(nodes))
    assert len(found[0]) == 20


def test_min_size_stops_extraction():
    rng = np.random.default_rng(2)
    M, C, planted = planted_graph(rng, cliques=((12, 0.95),),
                                  noise_density=0.0)
    res = extract.extract_cliques(M, C, torch.Generator().manual_seed(1), NZ,
                                  max_cliques=8, min_size=5,
                                  storage_dtype=None, device="cpu")
    assert len(res) == 1
    assert set(np.flatnonzero(res[0].mask).tolist()) == planted[0]
    assert res[0].score > 10.0


def test_scores_monotone_on_equal_weight_cliques():
    rng = np.random.default_rng(3)
    M, C, _ = planted_graph(rng, cliques=((24, 0.9), (12, 0.9)),
                            noise_density=0.0)
    res = extract.extract_cliques(M, C, torch.Generator().manual_seed(2), NZ,
                                  max_cliques=4, min_size=3,
                                  storage_dtype=None, device="cpu")
    assert int(res[0].mask.sum()) >= int(res[1].mask.sum())
    assert res[0].score >= res[1].score


def test_dsd_rounding_remap_warns():
    rng = np.random.default_rng(5)
    M, C, _ = planted_graph(rng, m=64, cliques=((10, 0.9),),
                            noise_density=0.0)
    with pytest.warns(UserWarning, match="DSD"):
        extract.extract_cliques(M, C, torch.Generator().manual_seed(0),
                                Params(rounding=Rounding.DSD), max_cliques=1,
                                min_size=3, storage_dtype=None, device="cpu")


def test_mask_clamped_to_support_for_superunit_weights():
    """M entries > 1 make omega = round(u'(M + I)u) exceed the clique; the
    clamp keeps each mask on its peel's support."""
    m = 96
    M = np.zeros((m, m))
    cl1, cl2 = np.arange(0, 10), np.arange(20, 28)
    for cl, w in ((cl1, 3.0), (cl2, 2.5)):
        M[np.ix_(cl, cl)] = w
        np.fill_diagonal(M[np.ix_(cl, cl)], 0.0)
    np.fill_diagonal(M, 0.0)
    C = (M > 0).astype(np.float64)
    res = extract.extract_cliques(M, C, torch.Generator().manual_seed(4), NZ,
                                  max_cliques=4, min_size=3,
                                  storage_dtype=None, device="cpu")
    found = [set(np.flatnonzero(r.mask).tolist()) for r in res]
    assert found == [set(cl1.tolist()), set(cl2.tolist())]
