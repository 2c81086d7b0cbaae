"""The build-anatomy probe: where does the stacked build's time go?

Counterpart of ``clipper_tpu/bench/build_probe.py``. It times five
ablations of the stacked int8 [M; C] Euclidean build of B random problems
(csrc/build_probe.cu on the card) to attribute the build's time to its
arithmetic classes:

  full       the production math (two sqrt, exp and the masks): kernel 4's
  sqrt1      c^2 = q1 + q2 - 2 sqrt(q1 q2)  (one sqrt, no abs)
  noexp      the gate only, writing the quantized c^2 (wrong values)
  nosqrt     the gate on squared distances only (no sqrt, no exp)
  writeonly  zero tiles: the write floor

and prints each beside kernel 4's time (``ops.affinity_pallas.
stored_build``) on the same inputs and the write bound, 2 B m^2 bytes
over 3.35 TB/s. Every variant runs kernel 4's own kernel
(csrc/stored_pair_build.cuh: each unordered pair of 64 x 64 tiles scored
once, the tile and its transpose written as 16-byte chunks) with its
score swapped, so ``full`` is kernel 4 and the others say where kernel
4's time goes; ``writeonly`` is its write floor. The JAX probe's
``.jax_cache`` settings and its tile have no counterpart here: the
kernel checks its edge tiles instead of needing m to divide by a tile.

Usage: python -m clipper_tpu_torch.bench.build_probe [B] [m] \\
           [--device=cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from clipper_tpu_torch import _kernels
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.ops import affinity_pallas
from clipper_tpu_torch.ops.affinity import (distinctness_mask,
                                            stored_from_endpoints)
from clipper_tpu_torch.ops.pairwise import pairwise_sqdist_matrix

# the order of build_probe_int8's variant argument
VARIANTS = ("full", "sqrt1", "noexp", "nosqrt", "writeonly")
# the JAX probe's constants (build_probe.py:42): the bench invariant's
SIGMA, EPS, AFFEPS = harness.INV_SIGMA, harness.INV_EPSILON, 1e-4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def make_inputs(B: int, m: int, seed: int = 0):
    """(P1, P2, A): (B, m, 3) f32 endpoints uniform in the unit cube and
    (B, m, 2) int32 associations in [0, 10000): the JAX probe's draws in
    its order (build_probe.py:45-48)."""
    rng = np.random.default_rng(seed)
    P1 = rng.uniform(size=(B, m, 3)).astype(np.float32)
    P2 = rng.uniform(size=(B, m, 3)).astype(np.float32)
    A = rng.integers(0, 10000, size=(B, m, 2)).astype(np.int32)
    return P1, P2, A


def write_bound_ms(B: int, m: int) -> float:
    """The (B, 2m, m) int8 output over the card's memory rate, in ms."""
    return 2 * B * m * m / HBM_BYTES_PER_S * 1e3


def build_probe_plain(variant: str, P1, P2, A) -> torch.Tensor:
    """The kernel's function in PyTorch, its IEEE steps in its order: the
    squared distances summed in coordinate order (ops/pairwise.py),
    ``full`` through the plain stacked build (``stored_from_endpoints``,
    kernel 4's plain version). Returns (B, 2m, m) int8."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    B, m, _ = P1.shape
    if variant == "full":
        return stored_from_endpoints(harness.default_invariant(), P1, P2, A,
                                     affinityeps=AFFEPS,
                                     storage_dtype=torch.int8)
    if variant == "writeonly":
        return torch.zeros(B, 2 * m, m, dtype=torch.int8, device=P1.device)
    q1, q2 = pairwise_sqdist_matrix(P1), pairwise_sqdist_matrix(P2)
    eps2 = EPS * EPS
    if variant == "nosqrt":
        dq = q1 - q2
        s = torch.where(dq * dq < eps2, dq, 0.0)
    else:
        csq = torch.clamp((q1 + q2) - 2.0 * torch.sqrt(q1 * q2), min=0.0)
        ok = csq < eps2
        if variant == "sqrt1":
            s = torch.where(ok, torch.exp(csq * (-0.5 / (SIGMA * SIGMA))),
                            0.0)
        else:
            s = torch.where(ok, csq, 0.0)
    keep = distinctness_mask(A) & (s > AFFEPS)
    Mq = torch.clamp(torch.round(torch.where(keep, s, 0.0) * 127.0), 0,
                     127).to(torch.int8)
    Cq = torch.where(keep, 127, 0).to(torch.int8)
    return torch.cat([Mq, Cq], dim=-2)


def build_probe_cuda(variant: str, P1, P2, A) -> torch.Tensor:
    """Launch csrc/build_probe.cu: P1/P2 (B, m, 3) f32 and A (B, m, 2) on
    the card -> (B, 2m, m) int8."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if not (P1.is_cuda and P2.is_cuda and A.is_cuda):
        raise ValueError("build probe kernel: inputs must lie on the card")
    B, m, d = P1.shape
    if (d != 3 or P2.shape != P1.shape or P1.dtype != torch.float32
            or P2.dtype != torch.float32 or tuple(A.shape) != (B, m, 2)):
        raise ValueError("build probe kernel takes (B, m, 3) float32 "
                         "endpoints and (B, m, 2) associations")
    # held in locals until the launch (see stored_build_cuda)
    P1c, P2c = P1.contiguous(), P2.contiguous()
    Ac = A.to(torch.int32).contiguous()
    mts = torch.full((B,), m, dtype=torch.int32, device=P1.device)
    out = torch.empty(B, 2 * m, m, dtype=torch.int8, device=P1.device)
    code = _kernels.lib("build_probe").build_probe_int8(
        VARIANTS.index(variant), P1c.data_ptr(), P2c.data_ptr(),
        Ac.data_ptr(), mts.data_ptr(), out.data_ptr(), B, m, SIGMA, EPS,
        AFFEPS, _kernels.stream_ptr(P1.device))
    _kernels.check(code, "build_probe")
    _kernels.LAUNCHES["build_probe"] += 1
    return out


def build_probe(variant: str, P1, P2, A) -> torch.Tensor:
    """The kernel for CUDA inputs, the plain version for CPU inputs."""
    if P1.is_cuda:
        return build_probe_cuda(variant, P1, P2, A)
    return build_probe_plain(variant, P1, P2, A)


def main(argv=None) -> dict:
    """Times each variant (one warm-up, then the mean of 5 calls; CUDA
    events on the card, the host clock on the CPU) and returns
    {variant: ms}."""
    pos, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    B = int(pos[0]) if pos else 512
    m = int(pos[1]) if len(pos) > 1 else 1024
    P1, P2, A = (torch.from_numpy(x).to(dev) for x in make_inputs(B, m))
    bound = write_bound_ms(B, m)
    inv = harness.default_invariant()
    mts = torch.full((B,), m, dtype=torch.int32, device=dev)
    t4 = harness.time_ms(lambda: affinity_pallas.stored_build(
        inv, P1, P2, A, mts, affinityeps=AFFEPS), dev, reps=5)
    print(f"B={B} m={m} on {harness.device_name(dev)}: int8 out = "
          f"{2 * B * m * m / 1e9:.2f} GB, write bound {bound:.4f} ms, "
          f"stored_build (kernel 4) {t4:.4f} ms", flush=True)
    results = {}
    for variant in ("writeonly", "nosqrt", "noexp", "sqrt1", "full"):
        ms = harness.time_ms(lambda: build_probe(variant, P1, P2, A), dev,
                             reps=5)
        results[variant] = ms
        print(f"{variant:10s}: {ms:8.4f} ms  ({ms / t4:.2f}x stored_build "
              f"{t4:.4f} ms, {ms / bound:.2f}x write bound {bound:.4f} ms)",
              flush=True)
    return results


if __name__ == "__main__":
    main()
