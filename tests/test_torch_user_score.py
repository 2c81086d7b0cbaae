"""A user's own invariant inside the build kernels 2, 8, 4 and 6, on the CPU.

The port's build kernels take an invariant's device score
(invariants.DeviceScore: C++ source, d, parameters; csrc/user_score.cuh)
where the JAX package's Pallas builds traced its ``score_block_t``. The
sample invariants of clipper_tpu_torch.bench.user_scores are given here
in their JAX form too, and on the same numpy inputs:

- the port's plain versions of kernels 2 and 8 (int8, bf16), 4 (int8,
  bf16) and 6 (f32, f64), what the kernels are held to on the card,
  against the JAX package's build_tri_pallas, build_tri_pallas_fused,
  score_consistency_stored_pallas and build_affinity_pallas in interpret
  mode, at t = 64 and t = 40 (which does not divide 64), m_true < m;
- the tri pool with PlanarCauchy against JAX's pool with build="pallas";
- the device score library's generated source, key and flags, its build
  raising with nvcc's log, the pools' build resolution, and the rule
  that a subclass inherits its parent's device score.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipper_tpu.invariants.base import PairwiseInvariant as JInvariant
from clipper_tpu.ops import affinity_pallas as jap
from clipper_tpu.ops import flattri as jflattri
from clipper_tpu.parallel import pool as jpool
from clipper_tpu.types import Params as JParams
from clipper_tpu_torch import _kernels, interop, invariants
from clipper_tpu_torch.bench import data, harness, user_scores
from clipper_tpu_torch.invariants.base import DeviceScore, PairwiseInvariant
from clipper_tpu_torch.ops import affinity_pallas, flattri
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.types import Params


def _jlengths(Pr, Pc):
    """(..., mr, mc) lengths of row and column blocks, summed from 0 in
    coordinate order (the port's ops.pairwise for d <= 8)."""
    sq = 0.0
    for k in range(Pr.shape[-1]):
        diff = Pr[..., :, k, None] - Pc[..., None, :, k]
        sq = sq + diff * diff
    return jnp.sqrt(sq)


def _jlength(a, b):
    sq = 0.0
    for k in range(a.shape[-1]):
        sq = sq + (a[..., k] - b[..., k]) * (a[..., k] - b[..., k])
    return jnp.sqrt(sq)


class JUserEuclidean(JInvariant):
    """UserEuclidean in its JAX form."""
    symmetric = True

    def __init__(self, p):
        self.p = p

    def _score(self, l1, l2):
        c = jnp.abs(l1 - l2)
        s2 = self.p.sigma * self.p.sigma
        return jnp.where(c < self.p.epsilon, jnp.exp(-0.5 * c * c / s2), 0.0)

    def __call__(self, ai, aj, bi, bj):
        return self._score(_jlength(ai, aj), _jlength(bi, bj))

    def score_block(self, P1r, P1c, P2r, P2c):
        return self._score(_jlengths(P1r, P1c), _jlengths(P2r, P2c))

    def score_block_t(self, P1r, P1ct, P2r, P2ct):
        return self.score_block(P1r, jnp.swapaxes(P1ct, -1, -2),
                                P2r, jnp.swapaxes(P2ct, -1, -2))


class JPlanarCauchy(JUserEuclidean):
    """PlanarCauchy in its JAX form."""

    def _score(self, l1, l2):
        c = jnp.abs(l1 - l2)
        s2 = self.p.sigma * self.p.sigma
        return jnp.where(c < self.p.epsilon, 1.0 / (1.0 + c * c / s2), 0.0)


SCORES = ["user_euclidean", "planar_cauchy"]


def _pair(kind):
    """(JAX, port) invariants and the endpoints' width."""
    if kind == "user_euclidean":
        p = harness.default_invariant().params
        return JUserEuclidean(p), user_scores.UserEuclidean(p), 3
    p = user_scores.PlanarCauchyParams()
    return JPlanarCauchy(p), user_scores.PlanarCauchy(p), 2


def _problems(kind, W, m, seed):
    """W bunny problems at 90% outliers (their x, y projection for the
    planar score): D1 (n, d), D2s (W, n, d), As (W, m, 2), ground truths."""
    _, _, d = _pair(kind)
    pcd0 = harness.load_bunny().astype(np.float32)
    rng = np.random.default_rng(seed)
    probs = [harness.make_problem(pcd0, m, 0.9, rng) for _ in range(W)]
    D2s = np.stack([p[0] for p in probs]).astype(np.float32)[..., :d]
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    return pcd0[:, :d], D2s, As, [p[2] for p in probs]


def _gathered(kind, W, m, seed):
    D1, D2s, As, _ = _problems(kind, W, m, seed)
    P1 = np.stack([D1[A[:, 0]] for A in As])
    P2 = np.stack([D2[A[:, 1]] for D2, A in zip(D2s, As)])
    return P1, P2, As


def _assert_storage_bar(got, ref, c_rows, m_rows):
    """C equal; M within one code (one bf16 ulp) on at most max(2, 1e-3
    edges) entries (the storage bar of ROADMAP.md)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got[c_rows], ref[c_rows])
    edges = int((ref[c_rows] > 0).sum())
    assert edges > 0
    bits = torch.int8 if got.dtype == torch.int8 else torch.int16
    d = (got[m_rows].view(bits).int() - ref[m_rows].view(bits).int()).abs()
    assert int(d.max()) <= 1
    assert int((d > 0).sum()) <= max(2, 1e-3 * edges)


def _no_launch(run):
    before = dict(_kernels.LAUNCHES)
    out = run()
    assert _kernels.LAUNCHES == before, "a launch counted on the CPU"
    return out


@pytest.mark.parametrize("m,t", [(128, 64), (120, 40)])
@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
@pytest.mark.parametrize("kind", SCORES)
def test_tri_builds_match_jax(kind, storage, m, t):
    """Kernels 2 and 8's plain version (build_tri, build_tri_pallas_fused
    on CPU tensors) against JAX's build_tri_pallas and
    build_tri_pallas_fused in interpret mode, m_true < m on one
    problem."""
    inv_j, inv_t, _ = _pair(kind)
    P1, P2, A = _gathered(kind, 2, m, 5)
    mts = np.array([m, m - 30], np.int32)
    args = (jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(A),
            jnp.asarray(mts))
    tensors = (torch.from_numpy(P1), torch.from_numpy(P2),
               torch.from_numpy(A), torch.from_numpy(mts))
    for jfn, fn in ((jflattri.build_tri_pallas, flattri.build_tri),
                    (jflattri.build_tri_pallas_fused,
                     flattri.build_tri_pallas_fused)):
        ref = interop.tri_to_torch(np.asarray(jfn(
            inv_j, *args, t=t, storage_dtype=getattr(jnp, storage))))
        got = _no_launch(lambda: fn(inv_t, *tensors, t=t,
                                    storage_dtype=getattr(torch, storage)))
        _assert_storage_bar(got, ref, (slice(None), slice(t, None)),
                            (slice(None), slice(None, t)))


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
@pytest.mark.parametrize("kind", SCORES)
def test_stored_build_matches_jax(kind, storage):
    """Kernel 4's plain version against JAX's
    score_consistency_stored_pallas, m_true < m."""
    inv_j, inv_t, _ = _pair(kind)
    D1, D2s, As, _ = _problems(kind, 1, 128, 6)
    ref = torch.from_numpy(np.asarray(jap.score_consistency_stored_pallas(
        inv_j, jnp.asarray(D1), jnp.asarray(D2s[0]), jnp.asarray(As[0]),
        m_true=100, storage_dtype=getattr(jnp, storage), tile=128)
        .astype(jnp.float32))).to(getattr(torch, storage))
    got = _no_launch(lambda: affinity_pallas.score_consistency_stored_pallas(
        inv_t, torch.from_numpy(D1), torch.from_numpy(D2s[0]),
        torch.from_numpy(As[0]), m_true=100,
        storage_dtype=getattr(torch, storage)))
    _assert_storage_bar(got, ref, slice(128, None), slice(None, 128))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", SCORES)
def test_dense_build_matches_jax(kind, dtype):
    """Kernel 6's plain version against JAX's build_affinity_pallas: C
    equal; M within rtol 3e-5 in f32 and 1e-12 in f64 (the dense bar of
    test_torch_dense_build_gate: XLA's exp and the score's constants,
    formed as x64 promotes them, round apart from PyTorch's)."""
    inv_j, inv_t, _ = _pair(kind)
    P1, P2, A = _gathered(kind, 1, 120, 7)
    P1, P2, A = (P1[0].astype(dtype), P2[0].astype(dtype), A[0])
    Mj, Cj = (np.asarray(x) for x in jap.build_affinity_pallas(
        inv_j, jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(A)))
    M, C = _no_launch(lambda: affinity_pallas.build_affinity_pallas(
        inv_t, torch.from_numpy(P1), torch.from_numpy(P2),
        torch.from_numpy(A)))
    assert M.dtype == getattr(torch, dtype) and Mj.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(C.numpy(), Cj)
    assert (Cj > 0).any()
    np.testing.assert_allclose(M.numpy(), Mj, atol=0,
                               rtol=3e-5 if dtype == "float32" else 1e-12)


def test_planar_pool_matches_jax():
    """The tri pool (bench.py's settings, int8) at W=16, m=128 with
    PlanarCauchy, build="pallas": the port on the CPU (its plain build)
    against JAX's pool with its Pallas build in interpret mode: masks
    equal on >= 15 of 16, mean P/R within 1 point."""
    W, m = 16, 128
    inv_j, inv_t, _ = _pair("planar_cauchy")
    D1, D2s, As, Agts = _problems("planar_cauchy", W, m, 8)
    u0 = np.random.default_rng(9).random((W, m)).astype(np.float32)
    engine = dict(lanes=8, window=2, power_steps=4, layout="tri",
                  tri_probes=16, d_scale=0.15, build="pallas")
    sj = jpool.make_pool_pipeline(inv_j, JParams(), storage_dtype=jnp.int8,
                                  **engine)(
        jnp.asarray(D1), jnp.asarray(D2s), jnp.asarray(As), jnp.asarray(u0))
    st = _no_launch(lambda: pool.make_pool_pipeline(
        inv_t, Params(), storage_dtype=torch.int8, device="cpu", **engine)(
        D1, D2s, As, u0))
    mj, mt = np.asarray(sj.mask), st.mask.numpy()
    assert (mj == mt).all(1).sum() >= W - 1
    pr = [np.array([data.get_precision_recall(As[b][mk[b]], Agts[b])
                    for b in range(W)]).mean(0) for mk in (mj, mt)]
    assert np.abs(pr[0] - pr[1]).max() <= 0.01, pr


def test_generated_source_key_and_flags(monkeypatch):
    """A device score's library: its .cu names every entry of the four
    builds with the user_ prefix around the score's source, its key moves
    with the source, the parameters' shape and the flags, and nvcc runs
    under the build kernels' --fmad=false with csrc/ on the include
    path."""
    cauchy = user_scores.PlanarCauchy().cuda_score()
    euclid = user_scores.UserEuclidean().cuda_score()
    src = _kernels.user_source(cauchy)
    assert cauchy.source.strip() in src
    for kernel in _kernels.USER_KERNELS:
        for suffix in (("f32", "f64") if kernel == "affinity_build"
                       else ("int8", "bf16")):
            assert f"int user_{kernel}_{suffix}(" in src
            assert f"user_{kernel}_{suffix}" in _kernels._SIGNATURES
    for header in ("user_score.cuh", "tri_build.cuh", "tri_build_fused.cuh",
                   "stored_pair_build.cuh", "affinity_build.cuh"):
        assert f'#include "{header}"' in src
        assert (_kernels.CSRC / header).is_file()
    assert "Score<float>::D == 2" in src and "== 32," in src
    key = _kernels.user_target(cauchy)
    assert key.parent == _kernels.BUILD_DIR
    assert key == _kernels.user_target(user_scores.PlanarCauchy().cuda_score())
    assert key != _kernels.user_target(euclid)
    assert key != _kernels.user_target(cauchy._replace(
        source=cauchy.source + "// another source\n"))
    assert (_kernels.user_target(user_scores.UserEuclidean(d=5).cuda_score())
            != _kernels.user_target(euclid))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    cmd = _kernels.user_command(cauchy, key)
    assert "--fmad=false" in cmd and "sm_90a" in " ".join(cmd)
    assert cmd[cmd.index("-I") + 1] == str(_kernels.CSRC)
    assert cmd[-1] == str(key.with_suffix(".cu"))
    monkeypatch.setattr(_kernels, "_USER_FLAGS", ["--fmad=true"])
    assert _kernels.user_target(cauchy) != key


def test_failed_build_raises_with_its_log(monkeypatch, tmp_path):
    """A device score's library whose compiler fails raises with the
    compiler's output and leaves no library behind (here a stand-in
    compiler that prints and exits 1); without nvcc it raises too."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    fake = tmp_path / "fake_nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no Score here' \nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(fake))
    score = user_scores.PlanarCauchy().cuda_score()
    with pytest.raises(RuntimeError, match="no Score here"):
        _kernels.user_lib(score)
    assert not _kernels.user_target(score).exists()
    assert _kernels.user_target(score).with_suffix(".cu").is_file()
    monkeypatch.undo()
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "CUDA_BIN", str(tmp_path))
    monkeypatch.setattr(_kernels.shutil, "which", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_user(score)


def test_resolve_build_by_device_score():
    """build="auto" takes the kernel on the card for any symmetric
    invariant with a device score, a built-in or a user's, and the plain
    build for one without (or on the CPU); build="pallas" for one without
    raises on the card, naming the built-ins."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    with_score = (harness.default_invariant(), user_scores.UserEuclidean(),
                  user_scores.PlanarCauchy())
    for inv in with_score:
        for storage in (torch.int8, torch.bfloat16):
            assert pool._resolve_build("auto", storage, inv, cuda) == "pallas"
            assert pool._resolve_build("auto", storage, inv, cpu) == "xla"
        assert pool._resolve_build("auto", None, inv, cuda) == "xla"

    class Plain(PairwiseInvariant):
        symmetric = True

        def __call__(self, ai, aj, bi, bj):
            return torch.ones(ai.shape[:-1])

    assert pool._resolve_build("auto", torch.int8, Plain(), cuda) == "xla"
    assert pool._resolve_build("pallas", torch.int8, Plain(), cuda) == \
        "pallas"
    P = torch.zeros(1, 128, 3)
    with pytest.raises(NotImplementedError, match="EuclideanDistance"):
        flattri.build_tri_cuda(Plain(), P, P, None, None, t=128)


def test_subclass_inherits_the_device_score():
    """Dispatch reads cuda_score(): a subclass keeps its parent's device
    score (a built-in's or a user's) unless it overrides it; an
    asymmetric invariant, a d past MAX_USER_D or more than four
    parameters are refused."""
    class MyEuclid(invariants.EuclideanDistance):
        pass

    class MyCauchy(user_scores.PlanarCauchy):
        pass

    class NoScore(user_scores.PlanarCauchy):
        def cuda_score(self):
            return None

    assert invariants.kernel_score(MyEuclid()) == invariants.kernel_score(
        invariants.EuclideanDistance())
    assert invariants.kernel_score(MyCauchy()) == invariants.kernel_score(
        user_scores.PlanarCauchy())
    assert invariants.kernel_score(MyCauchy())[0] == invariants.USER_KIND
    assert invariants.kernel_builds(MyCauchy())
    assert not invariants.kernel_builds(NoScore())
    with pytest.raises(NotImplementedError, match="PointNormalDistance"):
        invariants.kernel_score(NoScore())

    class Asym(user_scores.PlanarCauchy):
        symmetric = False

    assert not invariants.kernel_builds(Asym())
    with pytest.raises(ValueError, match="symmetric"):
        invariants.device_score(Asym())

    def with_score(score):
        inv = user_scores.PlanarCauchy()
        inv.cuda_score = lambda: score
        return inv

    good = user_scores.PlanarCauchy().cuda_score()
    for d in (1, invariants.MAX_USER_D):
        assert invariants.device_score(with_score(good._replace(d=d)))
    for bad in (good._replace(d=0), good._replace(d=invariants.MAX_USER_D + 1)):
        with pytest.raises(ValueError, match=f"d <= {invariants.MAX_USER_D}"):
            invariants.device_score(with_score(bad))
    with pytest.raises(ValueError, match="four parameters"):
        invariants.device_score(with_score(good._replace(params=(1.0,) * 5)))


def test_record_bytes():
    """The pair body's record in f32 (csrc/tri_pair_build.cuh: Ends), as
    kernel 8 is told it: 32 bytes Euclidean, 64 point-normal, else 2 d + 2
    values padded to 16 bytes."""
    rb = _kernels.record_bytes
    assert rb(harness.default_invariant().cuda_score()) == 32
    assert rb(harness.pointnormal_invariant().cuda_score()) == 64
    assert [rb(DeviceScore("", d)) for d in range(1, 10)] == \
        [16, 32, 32, 48, 48, 64, 64, 80, 80]


def test_user_euclidean_plain_equals_the_builtin():
    """UserEuclidean's plain methods are the built-in Euclidean's (so its
    kernels' codes equal the built-in kernel's on the card); its params
    reach the kernels in the built-in's order."""
    P1, P2, A = _gathered("user_euclidean", 2, 128, 10)
    ue, eu = user_scores.UserEuclidean(), harness.default_invariant()
    ue = user_scores.UserEuclidean(eu.params)
    mts = torch.tensor([128, 100])
    t = [torch.from_numpy(x) for x in (P1, P2, A)]
    assert torch.equal(flattri.build_tri_plain(ue, *t, mts, t=64),
                       flattri.build_tri_plain(eu, *t, mts, t=64))
    assert invariants.kernel_score(ue)[1:] == invariants.kernel_score(eu)[1:]
    assert not isinstance(ue, invariants.EuclideanDistance)
    assert dataclasses.asdict(ue.params) == dataclasses.asdict(eu.params)
