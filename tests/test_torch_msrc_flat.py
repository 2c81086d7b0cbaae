"""Port parity: the flat solver's batched init and ticks, and rounding.

f64 storage and the same u0 through clipper_tpu.solvers.msrc_flat (over
the JAX package's XLA tri matvec) and clipper_tpu_torch.solvers.msrc_flat
(over the plain PyTorch tri matvec): the same lane trajectories.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipper_tpu.ops import flattri as jflattri
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu.solvers import msrc_flat as jmsrc_flat
from clipper_tpu.types import Params as JParams, Rounding as JRounding
from clipper_tpu_torch import interop
from clipper_tpu_torch.ops import flattri
from clipper_tpu_torch.solvers import msrc, msrc_flat
from clipper_tpu_torch.types import Params, Rounding


def _bunny_tri_f64(W, m, t, seed):
    """f64 flat-triangle storage of W bunny problems, built by the JAX
    package (numpy out)."""
    from clipper_tpu.bench import harness as jharness
    rng = np.random.default_rng(seed)
    pcd0 = jharness.load_bunny()
    inv = jharness.default_invariant()
    tris = []
    for _ in range(W):
        pcd1, A, _ = jharness.make_problem(pcd0, m, 0.9, rng)
        tris.append(np.asarray(jflattri.build_tri_xla(
            inv, jnp.asarray(pcd0), jnp.asarray(pcd1), jnp.asarray(A), m,
            t=t, storage_dtype=None)))
    return np.stack(tris)


@pytest.mark.parametrize("probes,warm_alpha", [(1, False), (16, False),
                                              (16, True)])
def test_init_and_ticks_match_jax_f64(probes, warm_alpha):
    W, m, t = 4, 256, 128
    nt = m // t
    tri_np = _bunny_tri_f64(W, m, t, seed=11)
    u0 = np.random.default_rng(12).random((W, m))
    params = Params()
    jparams = JParams(**{k: v for k, v in
                         interop.params_to_dict(params).items()
                         if k != "rounding"})

    jbmv = jflattri.make_tri_pool_matvec_xla(jnp.asarray(tri_np), nt,
                                             jnp.float64)
    jidx = jnp.arange(W, dtype=jnp.int32)
    ju = jmsrc_flat.power_init_batched(jbmv, jidx, jnp.asarray(u0), 4)
    js = jmsrc_flat.flat_init_batched(jbmv, jidx, ju, jparams)
    if probes > 1:
        jtick = jmsrc_flat.make_flat_tick_multiprobe_batched(
            jbmv, jparams, jnp.float64, probes, warm_alpha=warm_alpha,
            d_scale=0.15)
    else:
        jtick = jmsrc_flat.make_flat_tick_batched(jbmv, jparams, jnp.float64,
                                                  warm_alpha=warm_alpha)
    jtick = jax.jit(jtick)

    tri = interop.tri_to_torch(tri_np)
    bmv = flattri.make_tri_pool_matvec(tri, nt, torch.float64)
    idx = torch.arange(W, dtype=torch.int32)
    u = msrc_flat.power_init_batched(bmv, idx, torch.from_numpy(u0), 4)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-12)
    s = msrc_flat.flat_init_batched(bmv, idx, u, params)
    if probes > 1:
        tick = msrc_flat.make_flat_tick_multiprobe_batched(
            bmv, params, torch.float64, probes, warm_alpha=warm_alpha,
            d_scale=0.15)
    else:
        tick = msrc_flat.make_flat_tick_batched(bmv, params, torch.float64,
                                                warm_alpha=warm_alpha)

    for step in range(21):
        if step:
            js = jtick(jidx, js)
            s = tick(idx, s)
        got = interop.state_to_numpy(s)
        for name in ("ticks", "i", "j", "done", "lsk", "stall", "nback"):
            np.testing.assert_array_equal(got[name], np.asarray(
                getattr(js, name)), err_msg=f"{name} at tick {step}")
        for name in ("u", "gradF", "F", "d", "alpha"):
            ref = np.asarray(getattr(js, name))
            np.testing.assert_allclose(
                got[name], ref, rtol=1e-12, atol=1e-12,
                err_msg=f"{name} at tick {step}")
    assert int(s.i.max()) >= 1          # the lanes reached an outer step


def test_state_interop_round_trip():
    rng = np.random.default_rng(13)
    B, m = 3, 8
    js = jmsrc_flat._FlatState(
        u=jnp.asarray(rng.random((B, m))), gradF=jnp.asarray(rng.random((B, m))),
        F=jnp.asarray(rng.random(B)), d=jnp.asarray(rng.random(B)),
        alpha=jnp.ones(B), lsk=jnp.arange(B, dtype=jnp.int32),
        j=jnp.zeros(B, jnp.int32), i=jnp.ones(B, jnp.int32),
        done=jnp.asarray([True, False, True]), stall=jnp.zeros(B, jnp.int32),
        ticks=jnp.full(B, 5, jnp.int32), nback=jnp.zeros(B, jnp.int32))
    s = interop.state_to_torch({k: np.asarray(v)
                                for k, v in js._asdict().items()})
    assert s.done.dtype == torch.bool and s.lsk.dtype == torch.int32
    back = interop.state_to_numpy(s)
    for k, v in js._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    p = Params(maxlsiters=7, rounding=Rounding.NONZERO)
    assert interop.params_from_dict(interop.params_to_dict(p)) == p
    jp = interop.params_from_dict(dataclasses.asdict(JParams()))
    assert jp == Params()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_thresholds_match_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    scale = np.array([0.0, 1.0, 37.5, 1e4])
    for fn, jfn in ((msrc._eps_like, jmsrc._eps_like),
                    (msrc._eps_active, jmsrc._eps_active)):
        got = fn(1e-9, torch.from_numpy(scale).to(dtype), dtype)
        ref = jfn(1e-9, jnp.asarray(scale, jdt), jdt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert msrc._stall_guard_enabled(dtype) == jmsrc._stall_guard_enabled(jdt)
    assert msrc._STALL_OUTERS == jmsrc._STALL_OUTERS


def test_round_solution_matches_jax_with_ties():
    """DSD_HEU ranks with a stable descending sort: equal entries at the
    omega boundary (here zeros and a tied value) pick the lower indices,
    as jnp.argsort does."""
    u = np.array([[0.0, 0.5, 0.0, 0.5, 0.9, 0.0, 0.5, 0.1],
                  [0.0, 0.0, 0.0, 0.0, 0.3, 0.0, 0.0, 0.0],
                  [0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2]])
    F = np.array([2.5, 3.2, 4.49])      # omega = 3, 3, 4
    for rnd, jrnd in ((Rounding.DSD_HEU, JRounding.DSD_HEU),
                      (Rounding.NONZERO, JRounding.NONZERO)):
        got = msrc.round_solution(torch.from_numpy(u), torch.from_numpy(F),
                                  rnd).numpy()
        ref = np.stack([np.asarray(jmsrc.round_solution(
            jnp.asarray(u[b]), jnp.asarray(F[b]), jrnd))
            for b in range(len(F))])
        np.testing.assert_array_equal(got, ref)
    got = msrc.round_solution(torch.from_numpy(u), torch.from_numpy(F))
    assert got[1].tolist() == [True, True, False, False, True, False, False,
                               False]
    with pytest.raises(ValueError):
        msrc.round_solution(torch.from_numpy(u), torch.from_numpy(F),
                            Rounding.DSD)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("stall_outers", [0, 1, 5])
def test_stall_outers_ticks_match_jax(dtype, stall_outers):
    """The batched multiprobe tick with stall_outers (0: the default, 3
    frozen outers) over the same tri storage and u0, driven until every
    lane is done: each lane's support, ifinal and tick count equal JAX's.
    In f64 the guard is off (exact storage, equal u to 1e-12); in f32 it
    stops a lane after stall_outers frozen outers (supports, ifinal and
    ticks exact; u to 1e-6, f32 sums in another order)."""
    W, m, t = 4, 256, 128
    nt = m // t
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    tri_np = _bunny_tri_f64(W, m, t, seed=11).astype(
        np.float64 if dtype == "f64" else np.float32)
    u0 = np.random.default_rng(12).random((W, m))
    params = Params()
    jparams = JParams(**{k: v for k, v in
                         interop.params_to_dict(params).items()
                         if k != "rounding"})
    jbmv = jflattri.make_tri_pool_matvec_xla(jnp.asarray(tri_np), nt, jdt)
    jidx = jnp.arange(W, dtype=jnp.int32)
    js = jmsrc_flat.flat_init_batched(jbmv, jidx, jnp.asarray(u0, jdt),
                                      jparams)
    jtick = jax.jit(jmsrc_flat.make_flat_tick_multiprobe_batched(
        jbmv, jparams, jdt, 16, d_scale=0.15, stall_outers=stall_outers))
    bmv = flattri.make_tri_pool_matvec(interop.tri_to_torch(tri_np), nt, tdt)
    idx = torch.arange(W, dtype=torch.int32)
    s = msrc_flat.flat_init_batched(bmv, idx, torch.as_tensor(u0, dtype=tdt),
                                    params)
    tick = msrc_flat.make_tick(bmv, params, tdt, probes=16, d_scale=0.15,
                               stall_outers=stall_outers)
    for _ in range(2000):
        if bool(s.done.all()) and bool(np.asarray(js.done).all()):
            break
        js = jtick(jidx, js)
        s = tick(idx, s)
    got = interop.state_to_numpy(s)
    assert got["done"].all()
    np.testing.assert_array_equal(got["u"] > 0, np.asarray(js.u) > 0)
    for name in ("i", "ticks"):
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(js, name)), err_msg=name)
    np.testing.assert_allclose(got["u"], np.asarray(js.u), rtol=0,
                               atol=1e-12 if dtype == "f64" else 1e-6)
