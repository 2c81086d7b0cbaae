"""Port parity: the build-anatomy probe's inputs and its five variants.

The JAX probe (clipper_tpu/bench/build_probe.py) runs its Pallas kernel
only on a TPU, so its pieces are held here one by one: its draws, the
production build it ablates (ops.affinity.score_consistency_stored and
the Pallas stacked build in interpret mode, as tests/test_affinity_pallas
runs it), and the ablated formulas of build_probe.py:85-115 written in
jnp and run on JAX's CPU. The port's side is build_probe_plain, the
kernel's plain version, which CPU tensors take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops import affinity_pallas as jap
from clipper_tpu.ops.affinity import score_consistency_stored
from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import build_probe as bp
from clipper_tpu_torch.bench import harness

SIGMA, EPS, AFFEPS = 0.015, 0.05, 1e-4     # build_probe.py:42


def _bunny(m, seed, W=2):
    """W bunny problems: D1, D2s, As and the gathered (W, m, 3) endpoints
    P1 = D1[A[:, 0]], P2 = D2[A[:, 1]]."""
    rng = np.random.default_rng(seed)
    pcd0 = harness.load_bunny().astype(np.float32)
    probs = [harness.make_problem(pcd0, m, 0.9, rng) for _ in range(W)]
    D2s = np.stack([p[0] for p in probs]).astype(np.float32)
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    P1 = pcd0[As[..., 0]]
    P2 = np.stack([D2s[w][As[w, :, 1]] for w in range(W)])
    return pcd0, D2s, As, P1, P2


def _jax_variant(variant, P1, P2, A):
    """build_probe.py's kernel body (:72-115) in jnp over whole problems:
    q summed in coordinate order, the variant's score, the masks and the
    int8 quantization; (W, 2m, m) int8."""
    P1, P2, A = jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(A)
    m = P1.shape[1]
    q1 = jnp.zeros(P1.shape[:1] + (m, m), jnp.float32)
    q2 = jnp.zeros_like(q1)
    for k in range(3):
        d1 = P1[:, :, k, None] - P1[:, None, :, k]
        d2 = P2[:, :, k, None] - P2[:, None, :, k]
        q1 = q1 + d1 * d1
        q2 = q2 + d2 * d2
    if variant == "sqrt1":
        csq = jnp.maximum(q1 + q2 - 2.0 * jnp.sqrt(q1 * q2), 0.0)
        scr = jnp.where(csq < EPS * EPS,
                        jnp.exp(csq * (-0.5 / (SIGMA * SIGMA))), 0.0)
    elif variant == "noexp":
        csq = jnp.maximum(q1 + q2 - 2.0 * jnp.sqrt(q1 * q2), 0.0)
        scr = jnp.where(csq < EPS * EPS, csq, 0.0)
    else:
        dq = q1 - q2
        scr = jnp.where(dq * dq < EPS * EPS, dq, 0.0)
    distinct = ~((A[:, :, 0, None] == A[:, None, :, 0])
                 | (A[:, :, 1, None] == A[:, None, :, 1]))
    keep = distinct & ~jnp.eye(m, dtype=bool) & (scr > AFFEPS)
    Mq = jnp.clip(jnp.round(jnp.where(keep, scr, 0.0) * 127.0), 0, 127)
    Cq = jnp.where(keep, 127.0, 0.0)
    return np.asarray(jnp.concatenate([Mq, Cq], axis=1).astype(jnp.int8))


def _assert_codes(got, ref, m, max_diff):
    """C half exact; M codes within ``max_diff``."""
    got = got.numpy().astype(np.int32)
    ref = np.asarray(ref).astype(np.int32)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, m:], ref[:, m:])
    assert np.abs(got[:, :m] - ref[:, :m]).max() <= max_diff


def test_make_inputs_matches_jax_draws():
    """The JAX probe's default_rng(0) sequence (build_probe.py:45-48), each
    array converted as jnp.asarray converts it."""
    B, m = 3, 40
    rng = np.random.default_rng(0)
    ref = (np.asarray(jnp.asarray(rng.uniform(size=(B, m, 3)), jnp.float32)),
           np.asarray(jnp.asarray(rng.uniform(size=(B, m, 3)), jnp.float32)),
           np.asarray(jnp.asarray(rng.integers(0, 10000, size=(B, m, 2)),
                                  jnp.int32)))
    got = bp.make_inputs(B, m)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert bp.write_bound_ms(512, 1024) == pytest.approx(0.3205, abs=1e-4)


@pytest.mark.parametrize("m", [128, 200])
@pytest.mark.parametrize("variant", bp.VARIANTS)
def test_plain_matches_jax(variant, m):
    """Each variant's plain version against the JAX package on bunny
    problems gathered by valid associations, m = 200 dividing by no tile:
    full against score_consistency_stored and the Pallas stacked build
    (interpret mode), C exact and no M code differing; sqrt1, noexp and
    nosqrt against their jnp formulas, C exact and M codes within one
    (XLA's CPU sqrt and exp against PyTorch's); writeonly all zeros. No
    launch is counted."""
    D1, D2s, As, P1, P2 = _bunny(m, seed=m)
    before = dict(_kernels.LAUNCHES)
    got = bp.build_probe(variant, torch.from_numpy(P1), torch.from_numpy(P2),
                         torch.from_numpy(As))
    assert _kernels.LAUNCHES == before
    assert got.dtype == torch.int8 and got.shape == (len(As), 2 * m, m)
    if variant == "writeonly":
        assert not got.any()
        return
    if variant == "full":
        inv = jharness.default_invariant()
        for w in range(len(As)):
            args = (inv, jnp.asarray(D1), jnp.asarray(D2s[w]),
                    jnp.asarray(As[w]))
            for ref in (score_consistency_stored(*args, affinityeps=AFFEPS),
                        jap.score_consistency_stored_pallas(
                            *args, affinityeps=AFFEPS, tile=128)):
                _assert_codes(got[w:w + 1], np.asarray(ref)[None], m, 0)
        assert (got[:, m:] != 0).any()
        return
    _assert_codes(got, _jax_variant(variant, P1, P2, As), m, 1)
    assert (got[:, m:] != 0).any()


def test_probe_inputs_full_equals_stored_build():
    """On the probe's own random inputs the full variant is the stacked
    build of the bench invariant (kernel 4's plain version)."""
    P1, P2, A = (torch.from_numpy(x) for x in bp.make_inputs(2, 96, seed=3))
    from clipper_tpu_torch.ops import affinity_pallas
    ref = affinity_pallas.stored_build(harness.default_invariant(), P1, P2,
                                       A, torch.full((2,), 96))
    assert torch.equal(bp.build_probe_plain("full", P1, P2, A), ref)


def test_cuda_wrapper_rejects_cpu_and_unknown_variants():
    P1, P2, A = (torch.from_numpy(x) for x in bp.make_inputs(1, 16))
    with pytest.raises(ValueError, match="on the card"):
        bp.build_probe_cuda("full", P1, P2, A)
    with pytest.raises(ValueError, match="unknown variant"):
        bp.build_probe_plain("fast", P1, P2, A)


@pytest.mark.parametrize("variant", bp.VARIANTS)
def test_plain_halves_symmetric_bit_for_bit(variant):
    """Every variant's M and C halves equal their transposes bit for bit,
    on the probe's own draws and on bunny problems (m = 200, no tile
    divides it): the premise of the kernel's scoring each pair once and
    writing the tile and its transpose from one score."""
    m = 200
    probe = [torch.from_numpy(x) for x in bp.make_inputs(2, m, seed=4)]
    _, _, As, P1, P2 = _bunny(m, seed=11)
    bunny = [torch.from_numpy(x) for x in (P1, P2, As)]
    for P1t, P2t, At in (probe, bunny):
        out = bp.build_probe_plain(variant, P1t, P2t, At)
        for half in (out[:, :m], out[:, m:]):
            assert torch.equal(half, half.transpose(1, 2))
        assert bool(out[:, m:].any()) == (variant != "writeonly")
