#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (clipper_tpu_torch) on one NVIDIA GPU.

Phases, each of which must pass (any failure exits non-zero):

1. build   — compile the hand-written kernels from clipper_tpu_torch/csrc.
2. kernels — each kernel against its plain PyTorch version on the card, on
             real bunny storage (W=16 problems, m=1024): the tri matvec for
             K=16 and K=1 (max abs error <= 1e-4 on unit-norm u, and against
             an f64 oracle on the same int8 content and bf16-rounded u), its
             f32/f64 storage kinds, and the tri build (C half exact, no M
             code differing: both run the same IEEE f32 steps).
3. main    — the bench protocol through make_pool_pipeline: W=512 problems,
             m=1024, 90% outliers, bench.py's settings (1 warm-up call and 3
             timed calls). Prints P/R, problems/s, per-stage times and the
             kernels' launch counts; requires P >= 0.995, R >= 0.88 and every
             kernel launched.
4. parity  — W=16 problems through the pipeline on cuda and on cpu: masks
             equal on >= 15 of 16 problems, mean P/R within 1 point.
5. timing  — each kernel at the main path's shapes (the build at W=512,
             the matvec at B=128, K=16 and B=512, K=1) held against its plain
             version as in phase 2, then timed beside its bound, its plain
             version and, where one exists, one PyTorch call computing the
             same function.

The line before the last is a JSON object of the kernels' numbers; the last
line is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--quick] [--profile]
  --quick    phases 1-2 only
  --profile  also run the main path once under torch.profiler and print the
             device's busy share and the kernels that take its time
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

M = 1024            # associations per problem (bench.py)
RHO = 0.9           # outlier ratio
W_MAIN = 512        # problems on the main path (bench.py's default batch)
W_CHECK = 16        # problems for the kernel and CPU-parity checks
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak
F32_FLOPS = 67e12             # f32 outside the tensor cores
BUILD_OPS_PER_ENTRY = 30      # f32 operations per stored entry (tri_build.cu)
MATVEC_TOL = 1e-4             # max |kernel - plain| of the tri matvec


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_problems(W: int, seed: int):
    from clipper_tpu_torch.bench import harness
    pcd0 = harness.load_bunny()
    rng = np.random.default_rng(seed)
    probs = [harness.make_problem(pcd0, M, RHO, rng) for _ in range(W)]
    D2s = np.stack([p[0] for p in probs]).astype(np.float32)
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    Agts = [p[2] for p in probs]
    u0s = np.random.default_rng(seed).random((W, M)).astype(np.float32)
    return pcd0.astype(np.float32), D2s, As, Agts, u0s


def precision_recall(As, masks, Agts):
    from clipper_tpu_torch.bench import data
    pr = np.array([data.get_precision_recall(As[b][masks[b]], Agts[b])
                   for b in range(len(Agts))])
    return pr[:, 0], pr[:, 1]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def endpoints(D1, D2s, As, dev):
    import torch
    from clipper_tpu_torch.ops.affinity import gather_endpoints
    return gather_endpoints(torch.as_tensor(D1, device=dev),
                            torch.as_tensor(D2s, device=dev),
                            torch.as_tensor(As, device=dev))


def unit_rows(gen, B, K, dev):
    import torch
    U = torch.rand(B, K, M, generator=gen, device=dev)
    return U / torch.linalg.vector_norm(U, dim=-1, keepdim=True)


def check_build(tri_k, tri_p, t, label):
    """tri_build output against the plain build: same shape, C half
    exact, and no M code differing (kernel and plain take the same IEEE
    f32 steps, true division and no FMA contraction, and round half to
    even). Returns the max |code diff|."""
    import torch
    require(tri_k.shape == tri_p.shape, f"tri_build {label}: shape "
            f"{tuple(tri_k.shape)} vs plain {tuple(tri_p.shape)}")
    c_equal = bool(torch.equal(tri_k[:, t:], tri_p[:, t:]))
    dM = (tri_k[:, :t].int() - tri_p[:, :t].int()).abs()
    n_diff = int((dM > 0).sum())
    build_err = int(dM.max())
    nnz = int((tri_p[:, t:] > 0).sum())
    print(f"tri_build vs plain ({label}): C exact={c_equal}, "
          f"M codes differing={n_diff} of {nnz} stored edges, "
          f"max |code diff|={build_err}", flush=True)
    require(c_equal, f"tri_build {label}: C half differs from the plain build")
    require(n_diff == 0, f"tri_build {label}: {n_diff} M codes differ")
    return build_err


def check_matvec(tri, nt, idx, U, label):
    """tri_matvec against the plain version on the same inputs; returns
    the max abs error."""
    import torch
    from clipper_tpu_torch.ops import flattri
    MUk, CUk = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, torch.float32)
    MUp, CUp = flattri.tri_pool_matvec_plain(tri, nt, idx, U, torch.float32)
    require(bool(torch.isfinite(MUk).all() & torch.isfinite(CUk).all()),
            f"tri_matvec {label}: non-finite output")
    err = max(float((MUk - MUp).abs().max()), float((CUk - CUp).abs().max()))
    print(f"tri_matvec vs plain ({label}): max|kernel - plain|={err:.3e}",
          flush=True)
    require(err <= MATVEC_TOL, f"tri_matvec {label} disagrees with plain")
    return err


def phase_kernels(inv, check, dev):
    """Kernel-vs-plain checks on W_CHECK problems. Returns max errors."""
    import torch
    from clipper_tpu_torch.ops import flattri

    D1, D2s, As, _, _ = check
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    mts = torch.full((W_CHECK,), M, dtype=torch.int32, device=dev)
    t, nt = 256, M // 256

    tri_k = flattri.build_tri_cuda(inv, P1s, P2s, At, mts, t=t)
    tri_p = flattri.build_tri_plain(inv, P1s, P2s, At, mts, t=t)
    require(tri_k.shape == (W_CHECK, 2 * t, flattri.tri_ncols(nt, t)),
            f"tri_build shape {tuple(tri_k.shape)}")
    build_err = check_build(tri_k, tri_p, t, f"W={W_CHECK}, m={M}")

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for B, K in ((128, 16), (W_CHECK, 1)):
        idx = torch.randint(0, W_CHECK, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        U = unit_rows(gen, B, K, dev)
        errs[K] = check_matvec(tri_k, nt, idx, U, f"int8, B={B}, K={K}")
        MUk, CUk = flattri.tri_pool_matvec_cuda(tri_k, nt, idx, U,
                                                torch.float32)
        MUo, CUo = flattri.tri_pool_matvec_plain(
            tri_k.double(), nt, idx, U.bfloat16().double(), torch.float64)
        e_oracle = max(float((MUk.double() - MUo / 127).abs().max()),
                       float((CUk.double() - CUo / 127).abs().max()))
        print(f"tri_matvec int8 B={B} K={K}: max|kernel - f64 oracle|="
              f"{e_oracle:.3e}", flush=True)

    # float storage kinds (the f32 / f64 kernels), on the full-precision
    # storage of the first 4 problems
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        tri_f = flattri.build_tri_plain(inv, P1s[:4].to(dtype),
                                        P2s[:4].to(dtype), At[:4], mts[:4],
                                        t=t, storage_dtype=None)
        idx = torch.randint(0, 4, (32,), generator=gen, device=dev,
                            dtype=torch.int32)
        U = unit_rows(gen, 32, 16, dev).to(dtype)
        a = flattri.tri_pool_matvec_cuda(tri_f, nt, idx, U, dtype)
        b = flattri.tri_pool_matvec_plain(tri_f, nt, idx, U, dtype)
        torch.cuda.synchronize()
        e = max(float((a[0] - b[0]).abs().max()),
                float((a[1] - b[1]).abs().max()))
        print(f"tri_matvec {dtype} storage: max|kernel - plain|={e:.3e}",
              flush=True)
        require(e <= tol, f"tri_matvec {dtype} disagrees with plain")
    return max(errs.values()), build_err


def run_pipeline(inv, data_, dev, W, timings=None):
    import torch
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params
    D1, D2s, As, _, u0s = data_
    pipe = pool.make_pool_pipeline(inv, Params(), lanes=128, window=2,
                                   storage_dtype=torch.int8, power_steps=4,
                                   layout="tri", tri_probes=16, d_scale=0.15,
                                   device=dev)
    return pipe(D1, D2s[:W], As[:W], u0s[:W], timings=timings)


def phase_main(inv, main, dev):
    import torch
    from clipper_tpu_torch import _kernels

    D1, D2s, As, Agts, u0s = main
    # the counted run (also the warm-up): launches of one main-path call
    _kernels.reset_launches()
    sol = run_pipeline(inv, main, dev, W_MAIN)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    reps = 3
    timings = {}
    t0 = time.perf_counter()
    for _ in range(reps):
        sol = run_pipeline(inv, main, dev, W_MAIN, timings=timings)
        torch.cuda.synchronize()
    elapsed = (time.perf_counter() - t0) / reps

    masks = sol.mask.cpu().numpy()
    score = sol.score.cpu().numpy()
    require(masks.shape == (W_MAIN, M) and score.shape == (W_MAIN,),
            f"main path shapes {masks.shape} {score.shape}")
    require(bool(np.isfinite(score).all()) and bool(
        torch.isfinite(sol.u).all()), "main path: non-finite u or score")
    require(float(score.max()) <= M, "main path: objective F > m")
    P, R = precision_recall(As, masks, Agts)
    print(f"main path: W={W_MAIN} m={M} rho={RHO}: precision="
          f"{P.mean() * 100:.2f}% recall={R.mean() * 100:.2f}%  "
          f"{W_MAIN / elapsed:.1f} problems/s ({elapsed * 1e3:.1f} ms/batch,"
          f" mean of {reps} after 1 warm-up)", flush=True)
    print("main path stage ms (last timed call, CUDA events): "
          + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()), flush=True)
    print(f"main path kernel launches (one call): {launches}", flush=True)
    print(f"main path ifinal: mean={float(sol.ifinal.float().mean()):.2f} "
          f"max={int(sol.ifinal.max())}", flush=True)
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path was never launched: {launches}")
    require(P.mean() >= 0.995, f"precision {P.mean():.4f} < 0.995")
    require(R.mean() >= 0.88, f"recall {R.mean():.4f} < 0.88")
    return launches


def phase_parity(inv, check, dev):
    _, _, As, Agts, _ = check
    sg = run_pipeline(inv, check, dev, W_CHECK)
    sc = run_pipeline(inv, check, "cpu", W_CHECK)
    mg = sg.mask.cpu().numpy()
    mc = sc.mask.numpy()
    same = int((mg == mc).all(1).sum())
    Pg, Rg = precision_recall(As, mg, Agts)
    Pc, Rc = precision_recall(As, mc, Agts)
    print(f"cuda vs cpu (W={W_CHECK}): masks equal on {same}/{W_CHECK}; "
          f"P {Pg.mean() * 100:.2f}/{Pc.mean() * 100:.2f}%  "
          f"R {Rg.mean() * 100:.2f}/{Rc.mean() * 100:.2f}%", flush=True)
    for w in np.flatnonzero(~(mg == mc).all(1)):
        print(f"  problem {w}: {int((mg[w] != mc[w]).sum())} vertices differ;"
              f" |mask| cuda {int(mg[w].sum())} cpu {int(mc[w].sum())}; "
              f"ifinal cuda {int(sg.ifinal[w])} cpu {int(sc.ifinal[w])}",
              flush=True)
    require(same >= W_CHECK - 1, "cuda/cpu masks differ on > 1 problem")
    require(abs(Pg.mean() - Pc.mean()) <= 0.01 and
            abs(Rg.mean() - Rc.mean()) <= 0.01, "cuda/cpu P/R differ > 1pt")


def phase_timing(inv, main, dev):
    """Per-kernel checks and times at the main path's shapes. Returns
    the rows of the kernels' JSON line and the max errors at these shapes
    (build code diff, matvec abs error)."""
    import torch
    from clipper_tpu_torch.ops import flattri

    D1, D2s, As, _, _ = main
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    mts = torch.full((W_MAIN,), M, dtype=torch.int32, device=dev)
    t, nt = 256, M // 256
    T = nt * (nt + 1) // 2
    S = flattri.tri_ncols(nt, t)
    rows = {}

    def build():
        return flattri.build_tri_cuda(inv, P1s, P2s, At, mts, t=t)

    tri = build()
    build_err = check_build(tri, flattri.build_tri_plain(
        inv, P1s, P2s, At, mts, t=t), t, f"W={W_MAIN}, m={M}")
    b_bytes = (W_MAIN * 2 * t * S + 2 * W_MAIN * M * 3 * 4
               + W_MAIN * M * 2 * 4 + W_MAIN * 4)
    b_ops = W_MAIN * T * t * t * BUILD_OPS_PER_ENTRY
    rows["tri_build"] = dict(
        ms=cuda_ms(build, 10),
        plain_ms=cuda_ms(lambda: flattri.build_tri_plain(
            inv, P1s, P2s, At, mts, t=t), 2),
        bound_ms=max(b_bytes / HBM_BYTES_PER_S, b_ops / F32_FLOPS) * 1e3,
        bound_by=("bytes" if b_bytes / HBM_BYTES_PER_S > b_ops / F32_FLOPS
                  else "operations"),
        library_ms=None)

    gen = torch.Generator(device=dev).manual_seed(1)
    extra = []
    mv_err = 0.0
    for B, K in ((128, 16), (W_MAIN, 1)):
        idx = torch.randperm(W_MAIN, generator=gen, device=dev)[:B].to(
            torch.int32)
        U = unit_rows(gen, B, K, dev)
        mv_err = max(mv_err, check_matvec(tri, nt, idx, U,
                                          f"int8, B={B}, K={K}"))
        mv_bytes = B * 2 * t * S + B * K * M * 2 + B * K * 2 * M * 4
        mv_ops = 2 * K * B * (2 * t * S + 2 * t * t * (T - nt))
        ms = cuda_ms(lambda: flattri.tri_pool_matvec_cuda(
            tri, nt, idx, U, torch.float32), 50)
        plain = cuda_ms(lambda: flattri.tri_pool_matvec_plain(
            tri, nt, idx, U, torch.float32), 5)
        dense = flattri.dense_stacked(tri[idx.long()], nt).to(torch.bfloat16)
        Ut = U.to(torch.bfloat16).transpose(1, 2).contiguous()
        lib = cuda_ms(lambda: torch.bmm(dense, Ut), 20)
        del dense
        bound_s = max(mv_bytes / HBM_BYTES_PER_S, mv_ops / BF16_FLOPS)
        r = dict(ms=ms, plain_ms=plain, bound_ms=bound_s * 1e3,
                 bound_by=("bytes" if mv_bytes / HBM_BYTES_PER_S
                           > mv_ops / BF16_FLOPS else "operations"),
                 library_ms=lib)
        if K == 16:
            rows["tri_matvec"] = r
        extra.append((B, K, r))
    for name, r in rows.items():
        print(f"timing {name}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}", flush=True)
    for B, K, r in extra:
        print(f"timing tri_matvec B={B} K={K}: kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bmm over dense bf16 [M; C] {r['library_ms']:.4f} ms",
              flush=True)
    return rows, build_err, mv_err


def phase_profile(inv, main, dev):
    """One main-path call under torch.profiler: the union of the device's
    kernel and copy intervals over the wall time of the call (profiler
    overhead included, so the busy share is a lower bound), and the device
    items by time. Only device-side events count: a CPU op's own
    device-time column repeats its kernels' time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_pipeline(inv, main, dev, W_MAIN)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pipeline(inv, main, dev, W_MAIN)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"profile: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} "
          f"ms wall = {busy / wall_us * 100:.1f}% busy, {len(spans)} device "
          f"items (one main-path call under the profiler)", flush=True)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<6d} {name[:90]}", flush=True)


def main() -> None:
    quick = "--quick" in sys.argv[1:]
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    secs = _kernels.build_all()
    print(f"build: {len(_kernels.SOURCES)} kernels in {secs:.1f} s", flush=True)
    for name, log in _kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    inv = harness.default_invariant()
    t0 = time.perf_counter()
    check = make_problems(W_CHECK, seed=1)
    print(f"check data: {W_CHECK} problems in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mv_err, build_err = phase_kernels(inv, check, dev)
    if quick:
        print("quick: build and kernel checks passed", flush=True)
        return

    t0 = time.perf_counter()
    main_data = make_problems(W_MAIN, seed=0)
    print(f"main data: {W_MAIN} problems in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = phase_main(inv, main_data, dev)
    phase_parity(inv, check, dev)
    rows, build_err_main, mv_err_main = phase_timing(inv, main_data, dev)
    build_err = max(build_err, build_err_main)
    mv_err = max(mv_err, mv_err_main)
    if "--profile" in sys.argv[1:]:
        phase_profile(inv, main_data, dev)

    src = "clipper_tpu_torch/csrc/"
    kernels = [
        dict(name="tri_matvec", route="cuda", source=src + "tri_matvec.cu",
             replaces="clipper_tpu/ops/flattri.py:152",
             launches=launches["tri_matvec"], max_abs_err=mv_err,
             **rows["tri_matvec"]),
        dict(name="tri_build", route="cuda", source=src + "tri_build.cu",
             replaces="clipper_tpu/ops/flattri.py:463",
             launches=launches["tri_build"], max_abs_err=build_err,
             **rows["tri_build"]),
    ]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None:
                k[key] = float(k[key])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
