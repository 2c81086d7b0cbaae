"""The JAX package's f64 dense solve of tests/test_torch_pga_device.py's
problems, kept in tests/data/pga_dense_jax.json as an independent witness
for that file's card tests (which import no JAX).

Each entry is the JAX package's score_pairwise_consistency and
find_dense_clique (default Params, f64, on the CPU) on the problem's
points and u0: ifinal, F and the rounded mask's indices. The tests here
recompute each entry with JAX and hold the file to it, and hold the
port's host loop on the CPU, on JAX's M and C, to the same ifinal and
mask. To rewrite the file after a change to the problems:

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 PYTHONPATH=. \
        python tests/test_torch_pga_jax.py
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipper_tpu.bench import harness as jharness
from clipper_tpu.ops.affinity import score_pairwise_consistency as jscore
from clipper_tpu.solvers import msrc as jmsrc
from clipper_tpu_torch.solvers import msrc
from clipper_tpu_torch.types import Params

from test_torch_pga_device import JAX_WITNESS, PROBLEMS, problem


def jax_matrices(m, seed):
    """JAX's f64 (M, C) of the problem and its u0, as numpy arrays."""
    D1, D2, A, u0 = problem(m, seed)
    M, C = jscore(jharness.default_invariant(), jnp.asarray(D1.T),
                  jnp.asarray(D2.T), jnp.asarray(A))
    return np.array(M), np.array(C), u0


def jax_solve(m, seed):
    """The witness entry: JAX's (ifinal, F, mask's indices)."""
    M, C, u0 = jax_matrices(m, seed)
    u, F, ifinal = jmsrc.find_dense_clique(jnp.asarray(M), jnp.asarray(C),
                                           jnp.asarray(u0))
    mask = np.asarray(jmsrc.round_solution(u, F))
    return dict(ifinal=int(ifinal), F=float(F),
                mask=np.flatnonzero(mask).tolist())


@pytest.fixture(scope="module")
def witness():
    with open(JAX_WITNESS) as f:
        return json.load(f)


@pytest.mark.parametrize("m, seed", PROBLEMS)
def test_witness_is_jax(witness, m, seed):
    assert jax.config.jax_enable_x64
    w, got = witness[f"{m}/{seed}"], jax_solve(m, seed)
    assert (w["ifinal"], w["mask"]) == (got["ifinal"], got["mask"])
    assert abs(w["F"] - got["F"]) <= 1e-12 * abs(got["F"])


@pytest.mark.parametrize("m, seed", PROBLEMS)
def test_host_loop_matches_witness(witness, m, seed):
    """The port's host loop on the CPU, on JAX's M and C: JAX's ifinal
    and mask, F within 1e-10."""
    M, C, u0 = (torch.from_numpy(x) for x in jax_matrices(m, seed))
    u, F, ifinal = msrc.find_dense_clique(M, C, u0, Params())
    w = witness[f"{m}/{seed}"]
    assert int(ifinal) == w["ifinal"]
    assert torch.nonzero(msrc.round_solution(u, F)).flatten().tolist() \
        == w["mask"]
    assert abs(float(F) - w["F"]) <= 1e-10 * abs(w["F"])


if __name__ == "__main__":
    assert jax.config.jax_enable_x64, "set JAX_ENABLE_X64=1"
    out = {f"{m}/{seed}": jax_solve(m, seed) for m, seed in PROBLEMS}
    os.makedirs(os.path.dirname(JAX_WITNESS), exist_ok=True)
    with open(JAX_WITNESS, "w") as f:
        f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v)}"
                                   for k, v in out.items()) + "\n}\n")
