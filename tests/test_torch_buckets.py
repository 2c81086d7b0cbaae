"""Port parity: the bucketed mixed-m pipeline over the pool engine.

Mirrors tests/test_buckets.py: clipper_tpu.parallel.buckets against
clipper_tpu_torch.parallel.buckets (device="cpu": the plain versions) on
the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clipper_tpu as ct
from clipper_tpu.parallel import buckets as jbuckets
from clipper_tpu_torch import EuclideanDistance, EuclideanDistanceParams
from clipper_tpu_torch.parallel import buckets
from clipper_tpu_torch.types import Params

INV_J = ct.EuclideanDistance(ct.EuclideanDistanceParams(sigma=0.015,
                                                        epsilon=0.05))
INV_T = EuclideanDistance(EuclideanDistanceParams(sigma=0.015, epsilon=0.05))


def _problems(rng, D1, sizes):
    n = D1.shape[0]
    out = []
    for m, ni in sizes:
        th = rng.uniform(0, np.pi)
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        D2 = (D1 @ R.T + rng.normal(0, 0.002, size=(n, 3))).astype(np.float32)
        A = np.zeros((m, 2), dtype=np.int32)
        A[:ni, 0] = A[:ni, 1] = np.arange(ni)
        A[ni:, 0] = rng.integers(0, n, m - ni)
        A[ni:, 1] = rng.integers(0, n, m - ni)
        out.append((D2, A, rng.uniform(size=m).astype(np.float32)))
    return out


@pytest.mark.parametrize("m", [1, 100, 128, 129, 200, 2048])
def test_bucket_size_and_pad_rows_match_jax(m):
    for mb in (64, 128):
        assert buckets.bucket_size(m, mb) == jbuckets.bucket_size(m, mb)
    x = np.arange(6, dtype=np.int32).reshape(3, 2)
    np.testing.assert_array_equal(buckets.pad_rows(x, 5, fill=-1),
                                  jbuckets.pad_rows(x, 5, fill=-1))


@pytest.mark.parametrize("storage", ["full", "default"])
def test_bucketed_matches_jax(storage):
    """Mixed m (100, 128, 200) in the 128 and 256 buckets through both
    BucketedPipelines with the same pool options. In full-precision f32
    storage the masks are equal. With the defaults, which the port fills
    in as the JAX package's (stacked layout, bf16 storage), the two sum
    the same exact bf16 products in another f32 order and stop at other
    points on the same clique, so one entry can swap at the omega cut:
    at most 2 differing entries a problem, the bar of
    tests/test_buckets.py:65-69."""
    rng = np.random.default_rng(33)
    D1 = rng.uniform(size=(120, 3)).astype(np.float32)
    sizes = [(100, 22), (128, 25), (200, 30), (100, 18)]
    problems = _problems(rng, D1, sizes)
    jopts = dict(storage_dtype=None) if storage == "full" else {}
    sj = jbuckets.make_bucketed_pipeline(INV_J, ct.Params(), lanes=4,
                                         window=4, **jopts)(D1, problems)
    bp = buckets.make_bucketed_pipeline(INV_T, Params(), lanes=4, window=4,
                                        device="cpu", **jopts)
    assert bp._pool_kwargs["layout"] == "stacked"
    assert bp._pool_kwargs["storage_dtype"] == (
        None if storage == "full" else torch.bfloat16)
    st = bp(D1, problems)
    assert len(st) == len(problems)
    for i, (m, ni) in enumerate(sizes):
        assert st[i].mask.shape == (m,) and st[i].u.shape == (m,)
        diff = int((st[i].mask.numpy() != np.asarray(sj[i].mask)).sum())
        assert diff <= (0 if storage == "full" else 2), (i, diff)
        sel = set(np.flatnonzero(st[i].mask.numpy()))
        assert len(sel & set(range(ni))) >= ni - 3, (i, sel)
        assert len(sel - set(range(ni))) <= 2, (i, sel)


def test_batch_padding_dummies_inert():
    """W=3 problems of one bucket pad to W=4: the dummy changes no real
    problem's result (against pad_batch=False, exactly) and is not
    returned."""
    rng = np.random.default_rng(6)
    D1 = rng.uniform(size=(80, 3)).astype(np.float32)
    problems = _problems(rng, D1, [(128, 20)] * 3)
    out = {}
    for pad in (True, False):
        out[pad] = buckets.make_bucketed_pipeline(
            INV_T, Params(), lanes=4, window=4, pad_batch=pad,
            device="cpu")(D1, problems)
    assert len(out[True]) == 3
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a.u, b.u, rtol=0, atol=0)
        assert torch.equal(a.mask, b.mask)
        sel = set(np.flatnonzero(a.mask.numpy()))
        assert len(sel & set(range(20))) >= 17, sel


def test_bucketed_tri_layout_passthrough():
    """Pool options (layout='tri', tri_probes, d_scale, int8) flow through
    the bucketed dispatcher in both packages: equal masks."""
    rng = np.random.default_rng(3)
    D1 = rng.uniform(size=(64, 3)).astype(np.float32)
    problems = _problems(rng, D1, [(128, 20)] * 3)
    opts = dict(lanes=4, window=2, layout="tri", tri_probes=4, d_scale=0.15,
                power_steps=2)
    sj = jbuckets.make_bucketed_pipeline(INV_J, ct.Params(),
                                         storage_dtype=jnp.int8,
                                         **opts)(D1, problems)
    st = buckets.make_bucketed_pipeline(INV_T, Params(),
                                        storage_dtype=torch.int8,
                                        device="cpu", **opts)(D1, problems)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
