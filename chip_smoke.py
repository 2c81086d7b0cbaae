#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (clipper_tpu_torch) on one NVIDIA GPU.

Phases, each of which must pass (any failure exits non-zero):

1. build    — compile the hand-written kernels from clipper_tpu_torch/csrc.
2. kernels  — each kernel against its plain PyTorch version on the card, on
              real bunny storage: the tri matvec (W=16 problems, m=1024) for
              K=16 and K=1 (max abs error <= 1e-4 on unit-norm u, and against
              an f64 oracle on the same int8 content and bf16-rounded u), its
              f32/f64 storage kinds, the tri build (C half exact, no M code
              differing: both run the same IEEE f32 steps), the rows
              matvec on one m=1024 problem's row-chunked storage (t=128,
              G=8) for K=1 and K=16, int8 (<= 1e-4) and f32/f64, and
              over the D=3 chunk slices of the sharded engine (int8, f64),
              the tile-list matvec on the same problem (int8, f32, f64;
              K=16 and K=1; whole list, D=3 slices summed, a rerun
              bit-identical; <= 1e-4 against the plain version, <= 1.1e-5
              against an f64 oracle, <= 1e-4 against the rows matvec; the
              slices' raw f64 sums printed against the whole list's), both
              at an edge of their work units (one m=1152 problem, nt=9,
              int8, K=5 and K=20: rows at G=4, the tile list with its D=3
              slices; reruns bit-identical), the
              stacked build (the 16 problems in int8 and bf16, and their
              first 1000 associations with m_true < m on four: C half
              exact, no M code differing, output equal to its transpose),
              the stacked int8 matvec (plain, cuBLAS) against an f64 oracle
              (<= 1.1e-5), and the pattern matvec on the 16 problems' dense
              f32 M and its bf16 cast (<= 1e-4 against the plain version
              and an f64 oracle); the dense build on one bunny problem
              (m=1024) and one point-normal problem cut to m=1000, f32
              and f64 (C exact, no M entry differing); the tri build on
              16 point-normal problems and the stacked build on them in
              int8 and bf16, at m=1024 and at their first 1000
              associations, m_true < m on four (C exact, no M code
              differing, output equal to its transpose); the fused tri
              build byte-equal to the tri build (both invariants), and
              both at the first 1000 associations with t=200 (no 64-row
              sub-tile divides it), m_true < m on four, int8 and bf16,
              held to the plain build too; and the
              tiles matvec on the tile-major form of the check storage,
              int8, f32 and f64 (<= 1e-4 against its plain version and the
              tri matvec at K=1, bit-equal to the latter in int8 and bf16,
              <= 1.1e-5 against an f64 oracle, all three <= 1e-12 for f64
              storage, a rerun bit-identical). In bf16 storage (the JAX
              package's default): the tri build and the fused build (both
              invariants, C exact, no M value differing, byte-equal to
              each other), the tri matvec (B=128, K=16 and B=16, K=1), the
              tri matvec at nt=9 (one m=2304 problem, t=256, int8 and
              bf16), each against its plain version (<= 1e-4), an f64
              oracle (<= 1.1e-5) and a rerun bit for bit, the tiles
              matvec, and the rows and tile-list matvecs on one m=1024
              problem's bf16 storage (t=128; K=16, K=1, D=3 slices).
3. pool     — the bench protocol through make_pool_pipeline: W=512
              problems, m=1024, 90% outliers, bench.py's settings (1 warm-up
              call and 3 timed calls). Prints P/R, problems/s, per-stage times
              and the kernels' launch counts; requires P >= 0.995, R >= 0.88
              and both pool kernels launched.
3g. bf16    — the same protocol with storage_dtype=torch.bfloat16 (one
              counted call and 2 timed calls): the P/R bars, tri_build
              launched once a call (no plain build) and tri_matvec
              launched; prints problems/s and stage ms. (Run right after
              phase 3.)
3b. stacked — the same 512 problems through make_pool_pipeline(
              layout="stacked", int8, power_steps=4, window=12, lanes=128),
              bench/pool_ab.py's settings, same protocol: the P/R bars and
              the stacked build launched once a call; prints problems/s,
              stage times, windows, ticks and the stacked matvec's time a
              tick.
3c. multistart — the first 128 problems with K=4 restarts through
              make_pool_multistart_pipeline (bench/multistart_bench.py's
              settings), u0 (128, 4, m) from numpy default_rng(0): the P/R
              bars; prints ms a problem against the single-start stacked
              pool on the same 128 problems.
3d. batched — the 512 problems through make_batched_pipeline(
              matvec="fused") in f32 (bench/harness.py's call): the P/R bars
              and the pattern matvec launched; prints problems/s and the
              lock-step tick count.
3e. point-normal — BASELINE.json config 3: one m=5000, 80% outlier
              problem through Clipper(pointnormal_invariant(), f32) (the
              dense build launched once a score_pairwise_consistency,
              P >= 0.99, R >= 0.85; prints the build's, the solve's and the
              plain build's ms), and W=512 problems at m=1024, 90%
              outliers, per-problem datasets, through the tri pool
              (bench.py's settings; tri_build and tri_matvec launched) and
              the stacked pool (3b's settings; stored_build once a call),
              each at the bench bars, printing problems/s and stage ms.
3f. variants — the 512 bunny problems: the fused tri build byte-equal to
              the tri build, then the pool solved over its tile-major form
              (solve_pool_tri(matvec="tiles")) beside the flat storage
              (matvec="pallas"), one probe a tick (window 12): both at the
              bench bars, tri_build_fused and tri_tiles_matvec launched;
              prints each call's ms and stage ms, and whether the two
              pools' masks, ifinal, windows and ticks are equal.
4. capacity — one problem through the Clipper facade in f32: m=65,536,
              95% outliers, the bunny (seed 0), u0 from numpy
              default_rng(0), four ways: engine="auto" (the triangle
              engine, row-chunked, the rows matvec and its reduction
              launched); the triangle engine's tile list (matvec="xla",
              the tile-list matvec and its reduction launched); the
              sharded engine on a 1-rank NCCL group in its "xla" and
              "pallas" modes (the tile-list and the rows matvec launched,
              with their reductions), the "xla" mode with masks equal to the tile-list
              solve's and F within 1e-6 relative. Each requires P >= 0.995
              and R >= 0.88 and prints the stage times and shares of one
              warm call, its ticks, ifinal, F, storage GB and wall time.
5. parity   — W=16 pool problems on cuda and on cpu, int8 and bf16 tri
              pools: masks equal on >= 15 of 16, mean P/R within 1 point;
              the same for the stacked pool and the fused batched engine
              at W=16, and for multistart at
              W=8, K=4 (the chosen restart and the mask equal on >= 7 of
              8); the facade's triangle engine at m=8192 on cuda and on
              cpu, row-chunked and tile list: mask IoU >= 0.95 and
              P >= 0.995, R >= 0.88 on both, with the f32 solve's own
              spread printed beside the bar (each device's IoU under +-1
              ulp of noise on the matvec outputs: 4 trials on cuda and 2 on
              cpu row-chunked, 2 and 1 for the tile list); its dense
              engine in f64 at
              m=1024, 90% outliers: masks equal, P >= 0.995 and R >= 0.85 on
              cuda, and with solve(multistart=4): masks equal; the
              point-normal tri pool and the tile-major pool at W=16 (masks
              equal on >= 15 of 16, mean P/R within 1 point) and the
              point-normal dense facade in f64 at m=1024 (masks equal, the
              dense build launched on cuda).
6. timing   — each kernel at its path's shapes (the builds at W=512, the tri
              matvec at B=128, K=16 and B=512, K=1, the rows and the
              tile-list matvecs on the m=65,536 storage at K=16 and K=1
              (the tile list also on its D=3 slices; each timed with its
              plan built beforehand, the plan's own time printed with and
              without the layout's plan cache, beside its earlier two-read
              design's time, and the bytes its design moves a call printed
              against the stored tiles': at most 1.4x in int8 at K=16,
              1.25x in bf16, 1.05x at K=1, with the rate reached), the
              pattern matvec at B=512 in f32 and bf16 (each beside one bmm
              over the dense [M; C] in its type), the stacked build at
              W=512 in int8 and bf16, the fused tri build beside the tri
              build at W=512, the tiles matvec at B=128 and B=512 beside the
              tri matvec at K=1, the dense build at m=5000 point-normal and
              m=1024 bunny in f32 and f64 (held to its plain version at
              m=5000 in both, a rerun bit-identical; the m=5000 problem's
              survivor shares printed; the kernel timed through its
              wrapper as the facade calls it, the C entry's time beside
              it; the f64 operations over
              the f64 peak, 34 TFLOP/s), the point-normal tri and fused
              tri builds (int8 and bf16, the fused one byte-equal to the
              tri build)
              and the point-normal stacked build (int8 and bf16) at W=512;
              the tri builds beside each problem set's survivor shares,
              harness.gate_shares) held against its
              plain version as in phase 2, then
              timed beside its bound, its plain version and, where one
              exists, one PyTorch call computing the same function. The
              tri matvec, the tri and fused builds and the tiles matvec
              again over bf16 storage, the stacked build and the pattern
              matvec in bf16, and the rows and tile-list matvecs over the
              m=65,536 problem's bf16 storage at K=16: their numbers go
              into a "bf16" field of each row of the kernels' line (the
              point-normal tri, fused tri and stacked builds into
              "pointnormal" and "pointnormal_bf16" of their rows, the
              survivor shares into "gate_shares"; the dense build's bunny
              and f64 times into "shapes" of its row).
7. probe    — the build-anatomy probe (csrc/build_probe.cu) on the JAX
              probe's inputs at B=512, m=1024 and at an edge tile (B=16,
              m=1000): full byte-equal to the stacked build, writeonly all
              zeros, sqrt1, noexp and nosqrt with the C half exact and M
              codes within one of their plain versions (the count of
              differing codes printed, 0 expected); then
              bench/build_probe.main(["512", "1024"]), which prints each
              variant's ms beside the stacked build's and the write bound
              (every variant is the stacked build's own kernel with its
              score swapped, so full is kernel 4 and writeonly its write
              floor).
8. drivers  — each ported bench driver's main() in-process on the card at
              a small setting: grid_tpu (4 trials a cell, the whole 5 x 5
              grid), pool_ab (W=128, all five configurations), tickstats
              (B=128), gridcell_probe (8 problems at m=2048), mixed_bench
              (8 a size, 1 rep), multistart_bench (W=32, K=4, 1 rep),
              symstore_bench (m=8192, --mv-only), symshard_bench
              (m=8192 on a 1-rank NCCL group) and blocksparse_bench
              (m=2048, k=4 objects), sdp_bench (--sizes=256
              --batch=2); then the harness's
              run_grid at m=1024, rho=0.9 (4 trials, the dense build
              kernel launched) and one run_pointnormal_trial (m=5000).
              Each prints its launch counts and finite P/R; the rows at
              the bench protocol's point (m=1024, rho=0.9) meet
              P >= 0.995 and R >= 0.88 (the dense engine's R >= 0.85).
9. surface  — the facade's remaining surface at full width: (a) the
              point-normal facade (m=5000, rho=0.8, f32) with Rounding.DSD,
              the dense build kernel launched once, the host DSD on M[S, S]
              gathered on the card: P >= 0.99, R >= 0.85, the set inside
              the support of u and at least as dense as the DSD_HEU mask of
              the same u, a rerun of the DSD equal (prints the build, solve
              and host-DSD times); (b) solve_as_maximum_clique on that
              problem and on the bunny at m=2048, rho=0.9: a clique of C
              (checked on the card), no smaller than the heuristic's, and
              Method.KCORE's set equal to kcore_prune_mask on the card;
              (c) the triangle engine (engine="auto", m=8192, rho=0.95)
              with Rounding.DSD, the rows matvec launched, R >= 0.88
              (prints |S|); (d) the multi-object scene (bunny, k=8 objects,
              m=8192, rho=0.9) built by the dense build kernel, given to
              set_sparse_matrix_data as scipy matrices (prints the tile
              occupancy): the tile matvec at K=16 within 1e-4 of the dense
              stacked int8 matvec and 1.1e-5 of an f64 oracle, a rerun
              bit-identical, both timed; then solve(multistart=3) with
              Rounding.DSD; (e) extract_cliques on the scene's dense M and
              C (disjoint cliques; prints how many); (f) the tri pool at
              stall_outers=1 on cuda and cpu (W=16, masks equal on >= 15).
              Precision bars (b)-(e): P >= 0.995 against the labeled ground
              truth, or every selected association outside the labels
              consistent with every labeled inlier of its object (the
              bunny problems hold outlier draws that are correct matches,
              which exact roundings select: see precision_bar).
10. sdp     — the SDP relaxation (solvers/sdp.py) and the modules around
              it, at full width: (a) Clipper.solve_as_msrc_sdr on the bunny
              at m=1024, rho=0.9 (seed 0), f32, exact eigh, eps 1e-4: the
              dense build kernel once, iters < max_iters and no warning,
              |tr X - 1| <= 1e-4, lambdas.min() >= -1e-5, the nodes a
              clique of C (on the card), weak duality at the rounded
              clique (dobj >= <M, x x^T>, x its unit indicator; the
              iterate's own gap is printed: Z meets the sign and zero
              pattern only to r_prim, so it may read negative, in the JAX
              package too), precision_bar and R >= 0.85; (b) the rank-r
              route at m=4096 with default Params: auto_tune's three
              warnings (eps 1e-4, z_rank=64, AA off at 2.5 GiB),
              precision_bar and R >= 0.88; (c)
              Clipper.solve_as_msrc_sdr_batched on B=8 problems at m=256,
              each solution's nodes equal to its own single solve's; (d)
              one of them in f64 on the card and on the CPU: nodes equal,
              |pobj difference| <= 1e-8 max(1, |pobj|), both iteration
              counts printed; (e) (a)'s problem at time_limit_secs=1e-9:
              stopped within one chunk (<= 50 iterations), |tr X - 1| <=
              1e-5; (f) compat.CLIPPER with (a)'s u0 selecting as the
              facade does, compat.SDPParams through solve_as_msrc_sdr
              giving (a)'s nodes, utils.profiling.device_trace around a
              facade build naming the dense build's kernel, and an f64
              flat solve at m=1024 killed and resumed through
              utils.checkpoint bit-identical to the straight-through run;
              (g) the examples ex1, ex3, ex4 and ex5 (m=16,384, the rows
              kernel launched) in-process at their defaults.

The line before the last is a JSON object of the kernels' numbers (rows 3
and 7 also carry reduce_launches, the main path's launches of their
reduction kernel, and tb_per_s, the bytes their design moves a call over
the measured ms); the last line is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--quick] [--profile]
  --quick    phases 1-2 only
  --profile  also run the pool path (int8 and bf16), the stacked pool,
             the fused batched engine, the capacity path (row-chunked,
             tile list, and sharded "xla" at D=1) and phase 10's facade
             SDR (a) once each under torch.profiler and print the
             device's busy share and the kernels that take its time (the
             capacity kernels' unit pass and reduction as sym_unit_kernel
             and sym_reduce_kernel)
"""

from __future__ import annotations

import contextlib
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
F64_FLOPS = 34e12             # f64 outside the tensor cores (data sheet)
BUILD_OPS_PER_PAIR = 30       # f32 operations a Euclidean pair (tri_build.cu)
MATVEC_TOL = 1e-4             # max |kernel - plain| of the matvecs
CAP_M = 65536       # the capacity path: one problem at m=65,536 ...
CAP_RHO = 0.95      # ... with 95% outliers
CAP_PARITY_M = 8192           # facade cuda/cpu comparison, triangle engine
CAP_PARITY_IOU = 0.95         # ... its mask IoU bar
SPREAD_TRIALS_CUDA = 4        # ... and its spread: u0 moved by +-1 ulp
SPREAD_TRIALS_CPU = 2
SPREAD_TRIALS_TILES = 2       # ... on cuda for the tile list (1 on cpu)
DENSE_M = 1024                # facade cuda/cpu comparison, dense engine
ROWS_T = 128                  # the capacity engine's tile
# the stacked pool: bench/pool_ab.py:26, 78-80
STACKED = dict(layout="stacked", lanes=128, window=12, power_steps=4)
W_MULTI, K_MULTI = 128, 4     # multistart: bench/multistart_bench.py:63-65
W_PARITY_MULTI = 8            # multistart problems in the cuda/cpu check
M_EDGE = 1000                 # the stacked build where no tile divides m
STACKED_MV_TOL = 1.1e-5       # stacked int8 matvec vs f64 (BENCH.md:591-595)
ORACLE_TOL = 1.1e-5           # tile-list matvec vs an f64 oracle, m <= 4096
F64_MATVEC_TOL = 1e-12        # a matvec over f64 storage, summed in f64
# the point-normal configuration (BASELINE.json config 3,
# clipper_tpu/bench/harness.py:117-185): n=2000 surfels a scan
PN_N = 2000
PN_M, PN_RHO = 5000, 0.8      # the facade's one problem
PN_EDGE = 1000                # the dense build where no tile divides m
# f32 operations a pair of the point-normal score (pointnormal_score.cuh):
# two distances (3 sub, 3 mul, 2 add, sqrt: 9 each), two angles (3 mul,
# 2 add, 2 clamp, acos: 8 each), 2 sub + 2 abs, two gaussians (2 mul, div,
# exp: 4 each), 1 mul, 2 compares, and the masks' 4 compares: 51, each
# transcendental counted once; 56 with the int8 quantization
PN_OPS_PER_PAIR = 56


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def build_bound(b_bytes, W, m, ops_per_pair):
    """(bound_ms, bound_by) of a build of W problems of m associations:
    the larger of its bytes over the memory rate and its operations over
    the f32 peak, the operations counted over the m (m - 1) / 2 distinct
    pairs a problem needs (the kernels also score the pairs they mirror:
    a diagonal tile's lower half, the stacked form's lower triangle)."""
    t_bytes = b_bytes / HBM_BYTES_PER_S
    t_ops = W * (m * (m - 1) // 2) * ops_per_pair / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def bound_of(n_bytes, n_ops, peak=None):
    """bound_ms and bound_by of a kernel moving n_bytes and doing n_ops
    operations (bf16 tensor-core peak unless ``peak``)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / (peak or BF16_FLOPS)
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes > t_ops else "operations")


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


def endpoints(D1, D2s, As, dev):
    import torch
    from clipper_tpu_torch.ops.affinity import gather_endpoints
    return gather_endpoints(torch.as_tensor(D1, device=dev),
                            torch.as_tensor(D2s, device=dev),
                            torch.as_tensor(As, device=dev))


def unit_rows(gen, B, K, dev, m=None):
    import torch
    U = torch.rand(B, K, m or M, generator=gen, device=dev)
    return U / torch.linalg.vector_norm(U, dim=-1, keepdim=True)


def check_build(tri_k, tri_p, t, label):
    """tri_build output against the plain build: same shape and dtype, C
    half exact, and no M value differing (kernel and plain take the same
    IEEE f32 steps, true division and no FMA contraction, the same CUDA
    library sqrt, exp and acos, and round half to even, to an int8 code or
    a bf16 value). Returns the max |M diff| (codes or values)."""
    import torch
    require(tri_k.shape == tri_p.shape and tri_k.dtype == tri_p.dtype,
            f"tri_build {label}: {tuple(tri_k.shape)} {tri_k.dtype} vs "
            f"plain {tuple(tri_p.shape)} {tri_p.dtype}")
    c_equal = bool(torch.equal(tri_k[:, t:], tri_p[:, t:]))
    dM = (tri_k[:, :t].float() - tri_p[:, :t].float()).abs()
    n_diff = int((dM > 0).sum())
    build_err = float(dM.max())
    nnz = int((tri_p[:, t:] > 0).sum())
    print(f"tri_build vs plain ({label}): C exact={c_equal}, "
          f"M values differing={n_diff} of {nnz} stored edges, "
          f"max |M diff|={build_err}", flush=True)
    require(c_equal, f"tri_build {label}: C half differs from the plain build")
    require(n_diff == 0, f"tri_build {label}: {n_diff} M values differ")
    return build_err


def check_matvec(tri, nt, idx, U, label, oracle=False):
    """tri_matvec against the plain version on the same inputs (<= 1e-4);
    with oracle, also against an f64 oracle on the same content and
    bf16-rounded u (<= 1.1e-5) and a rerun bit for bit. Returns the max
    |kernel - plain|."""
    import torch
    from clipper_tpu_torch.ops import flattri
    MUk, CUk = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, torch.float32)
    MUp, CUp = flattri.tri_pool_matvec_plain(tri, nt, idx, U, torch.float32)
    require(bool(torch.isfinite(MUk).all() & torch.isfinite(CUk).all()),
            f"tri_matvec {label}: non-finite output")
    err = max(float((MUk - MUp).abs().max()), float((CUk - CUp).abs().max()))
    msg = f"tri_matvec vs plain ({label}): max|kernel - plain|={err:.3e}"
    if oracle:
        MUo, CUo = flattri.tri_pool_matvec_plain(
            tri.double(), nt, idx, U.bfloat16().double(), torch.float64)
        s = 1 / 127 if tri.dtype == torch.int8 else 1.0
        e_o = max(float((MUk.double() - MUo * s).abs().max()),
                  float((CUk.double() - CUo * s).abs().max()))
        again = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, torch.float32)
        same = bool(torch.equal(MUk, again[0]) and torch.equal(CUk,
                                                               again[1]))
        msg += (f", max|kernel - f64 oracle|={e_o:.3e}, rerun "
                f"bit-identical={same}")
        require(e_o <= ORACLE_TOL, f"tri_matvec {label} exceeds "
                f"{ORACLE_TOL} against the f64 oracle")
        require(same, f"tri_matvec {label}: a rerun is not bit-identical")
    print(msg, flush=True)
    require(err <= MATVEC_TOL, f"tri_matvec {label} disagrees with plain")
    return err


def check_stored(inv, P1s, P2s, At, mts, storage, label):
    """stored_build against the plain build on the card: C half exact, no
    M code differing (the same IEEE f32 steps) and the output equal to its
    transpose. Returns (storage, max |kernel - plain|)."""
    import torch
    from clipper_tpu_torch.ops import affinity_pallas
    from clipper_tpu_torch.ops.affinity import stored_from_endpoints
    W, m = At.shape[:2]
    k = affinity_pallas.stored_build_cuda(inv, P1s, P2s, At, mts,
                                          storage_dtype=storage)
    p = stored_from_endpoints(inv, P1s, P2s, At, m_true=mts,
                              storage_dtype=storage)
    require(k.shape == p.shape == (W, 2 * m, m) and k.dtype == storage,
            f"stored_build {label}: shape {tuple(k.shape)} {k.dtype}")
    c_equal = bool(torch.equal(k[:, m:], p[:, m:]))
    n_diff = int((k[:, :m] != p[:, :m]).sum())
    err = float((k[:, :m].float() - p[:, :m].float()).abs().max())
    sym = all(bool(torch.equal(h, h.transpose(1, 2)))
              for h in (k[:, :m], k[:, m:]))
    nnz = int((p[:, m:] > 0).sum())
    del p
    print(f"stored_build vs plain ({label}): C exact={c_equal}, M codes "
          f"differing={n_diff} of {nnz} stored edges, max |diff|={err}, "
          f"equal to its transpose={sym}", flush=True)
    require(c_equal, f"stored_build {label}: C half differs from the plain "
            "build")
    require(n_diff == 0, f"stored_build {label}: {n_diff} M codes differ")
    require(sym, f"stored_build {label}: output is not symmetric")
    return k, err


def check_pattern(M, u, label, oracle=True):
    """pattern_matvec against the plain version (and an f64 oracle) on the
    same M (B, m, m) and u (B, m); returns the max abs error."""
    import torch
    from clipper_tpu_torch.ops import fused_matvec
    Mu, Cu = fused_matvec.pattern_dual_matvec_cuda(M, u)
    require(bool(torch.isfinite(Mu).all() & torch.isfinite(Cu).all()),
            f"pattern_matvec {label}: non-finite output")
    Mp, Cp = fused_matvec.pattern_dual_matvec_plain(M, u)
    err = max(float((Mu - Mp).abs().max()), float((Cu - Cp).abs().max()))
    msg = f"pattern_matvec vs plain ({label}): max|kernel - plain|={err:.3e}"
    if oracle:
        M64, u64 = M.double(), u.double()[..., None]
        e_o = max(float((Mu.double() - (M64 @ u64)[..., 0]).abs().max()),
                  float((Cu.double() - ((M64 > 0).double() @ u64)[..., 0])
                        .abs().max()))
        msg += f", max|kernel - f64 oracle|={e_o:.3e}"
        require(e_o <= MATVEC_TOL, f"pattern_matvec {label} disagrees with "
                "the f64 oracle")
    print(msg, flush=True)
    require(err <= MATVEC_TOL, f"pattern_matvec {label} disagrees with plain")
    return err


def check_stacked_matvec(store, gen, dev, label):
    """The stacked int8 matvec (plain PyTorch, cuBLAS in f32) against an
    f64 oracle on the same int8 content and bf16-rounded u."""
    import torch
    from clipper_tpu_torch.solvers import msrc_flat
    P, two_m, m = store.shape
    idx = torch.randint(0, P, (32,), generator=gen, device=dev,
                        dtype=torch.int32)
    U = unit_rows(gen, 32, 1, dev)[:, 0]
    MU, CU = msrc_flat.make_stacked_pool_matvec(store, torch.float32)(idx, U)
    Y = (store[idx.long()].double()
         @ U.bfloat16().double()[..., None])[..., 0] / 127
    err = max(float((MU.double() - Y[:, :m]).abs().max()),
              float((CU.double() - Y[:, m:]).abs().max()))
    print(f"stacked int8 matvec ({label}): max|plain - f64 oracle|="
          f"{err:.3e}", flush=True)
    require(err <= STACKED_MV_TOL, f"stacked matvec {label} exceeds "
            f"{STACKED_MV_TOL} against the f64 oracle")


def phase_kernels(inv, check, dev):
    """Kernel-vs-plain checks on W_CHECK problems. Returns the max errors
    by kernel."""
    import torch
    from clipper_tpu_torch.ops import flattri
    from clipper_tpu_torch.ops.affinity import pairwise_from_endpoints

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
        errs[K] = check_matvec(tri_k, nt, idx, U, f"int8, B={B}, K={K}",
                               oracle=True)

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

    # the rows matvec on one m=1024 problem's row-chunked storage
    prob = one_problem(M, RHO, seed=1)
    nt = M // ROWS_T
    chunks = rows_storage(inv, prob, dev, G=8)
    rows_err = max(check_rows(chunks, nt, unit_rows(gen, 1, K, dev)[0],
                              f"int8, m={M}, G=8, K={K}") for K in (16, 1))
    for dtype in (torch.float32, torch.float64):
        cf = rows_storage(inv, prob, dev, G=8, storage=dtype)
        check_rows(cf, nt, unit_rows(gen, 1, 4, dev)[0].to(dtype),
                   f"{dtype} storage, m={M}, G=8, K=4")
        if dtype == torch.float64:
            check_rows_slices(cf, nt, unit_rows(gen, 1, 4, dev)[0].to(dtype),
                              f"{dtype} storage, m={M}, G=8, K=4")
    # ... over the D=3 chunk slices of the sharded engine's 'pallas' mode
    U16 = unit_rows(gen, 1, 16, dev)[0]
    rows_err = max(rows_err, check_rows_slices(chunks, nt, U16,
                                               f"int8, m={M}, G=8, K=16"))

    # the tile-list matvec on the same problem: int8 (t=128), f32 and f64
    # storage, K=16 and K=1, the whole list and its D=3 slices, against
    # the plain version and an f64 oracle; then against the rows matvec
    # on the same codes
    from clipper_tpu_torch.ops import symstore
    tiles_err = 0.0
    for storage in (torch.int8, torch.float32, torch.float64):
        tl = tiles_storage(inv, prob, dev, storage)
        fdt = torch.float64 if storage == torch.float64 else torch.float32
        for K in (16, 1):
            U = unit_rows(gen, 1, K, dev)[0].to(fdt)
            label = f"{str(storage).split('.')[-1]}, m={M}, K={K}"
            tiles_err = max(tiles_err, check_tiles(tl, nt, U, label))
            y = symstore.sym_tiles_matvec_cuda(tl, nt, U)
            e_o = float((y.double() - tiles_oracle(tl, nt, U)).abs().max())
            print(f"sym_tiles_matvec {label}: max|kernel - f64 oracle|="
                  f"{e_o:.3e}", flush=True)
            require(e_o <= ORACLE_TOL, f"sym_tiles_matvec {label} exceeds "
                    f"{ORACLE_TOL} against the f64 oracle")
        if storage == torch.int8:
            e_x = float((symstore.sym_tiles_matvec_cuda(tl, nt, U16)
                         - symstore.sym_rows_matvec_cuda(chunks, nt, U16))
                        .abs().max())
            print(f"sym_tiles_matvec vs sym_rows_matvec on the same codes "
                  f"(m={M}, K=16): max|diff|={e_x:.3e}", flush=True)
            require(e_x <= MATVEC_TOL, "the tile-list and rows kernels "
                    "disagree on the same problem")

    # an edge of the capacity kernels' units: nt = 9 (m=1152), not a
    # multiple of the unit's 8 row blocks, at K=5 and K=20 (two groups of
    # 16 candidates), rows at G=4 and the tile list with its D=3 slices
    prob9 = one_problem(9 * ROWS_T, RHO, seed=6)
    chunks9 = rows_storage(inv, prob9, dev, G=4)
    tiles9 = tiles_storage(inv, prob9, dev)
    for K in (5, 20):
        U = unit_rows(gen, 1, K, dev, 9 * ROWS_T)[0]
        rows_err = max(rows_err, check_rows(chunks9, 9, U,
                                            f"int8, nt=9, G=4, K={K}"))
        tiles_err = max(tiles_err, check_tiles(tiles9, 9, U,
                                               f"int8, nt=9, K={K}"))
    del chunks9, tiles9

    # the stacked build: int8 and bf16 at m=1024, then the first M_EDGE
    # associations (no tile divides M_EDGE) with m_true < m on four
    stored_err = 0.0
    for storage in (torch.int8, torch.bfloat16):
        store, e = check_stored(inv, P1s, P2s, At, mts, storage,
                                f"{storage}, W={W_CHECK}, m={M}")
        stored_err = max(stored_err, e)
        if storage == torch.int8:
            check_stacked_matvec(store, gen, dev, f"W={W_CHECK}, m={M}")
        del store
    me = M_EDGE
    mts_e = torch.full((W_CHECK,), me, dtype=torch.int32, device=dev)
    mts_e[:4] = torch.tensor([me - 1, me - 24, 700, 513], device=dev)
    for storage in (torch.int8, torch.bfloat16):
        _, e = check_stored(inv, P1s[:, :me], P2s[:, :me], At[:, :me], mts_e,
                            storage, f"{storage}, W={W_CHECK}, m={me}, "
                            "m_true < m on 4")
        stored_err = max(stored_err, e)

    # the pattern matvec on the problems' dense f32 M and its bf16 cast
    Md, _ = pairwise_from_endpoints(inv, P1s, P2s, At)
    u = unit_rows(gen, W_CHECK, 1, dev)[:, 0]
    pattern_err = max(check_pattern(Md, u, f"f32, B={W_CHECK}, m={M}"),
                      check_pattern(Md.bfloat16(), u,
                                    f"bf16, B={W_CHECK}, m={M}"))
    del Md
    return {"tri_matvec": max(errs.values()), "tri_build": build_err,
            "sym_rows_matvec": rows_err, "stored_build": stored_err,
            "pattern_matvec": pattern_err, "sym_tiles_matvec": tiles_err}


def one_problem(m: int, rho: float, seed: int):
    """(pcd0, pcd1, A, Agt, u0) of one bunny problem; u0 from numpy
    default_rng(seed)."""
    from clipper_tpu_torch.bench import harness
    pcd0 = harness.load_bunny()
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho,
                                        np.random.default_rng(seed))
    u0 = np.random.default_rng(seed).random(m).astype(np.float32)
    return (pcd0.astype(np.float32), pcd1.astype(np.float32),
            A.astype(np.int32), Agt, u0)


def ulp_noise(seed: int, dev):
    """A wrap_matvec for the capacity engine: every output of the rows
    matvec moved by -1, 0 or +1 ulp at random, drawn on dev."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def nudge(y):
        step = torch.randint(-1, 2, y.shape, generator=gen, device=y.device)
        toward = torch.where(step > 0, torch.inf, -torch.inf).to(y.dtype)
        return torch.where(step == 0, y, torch.nextafter(y, toward))

    def wrap(mv):
        return lambda u: tuple(nudge(y) for y in mv(u))
    return wrap


def mask_iou(a, b) -> float:
    return float((a & b).sum() / max(1, (a | b).sum()))


def capacity_endpoints(prob, dev, storage=None):
    """(P1, P2, A) of one problem on dev, in f32 for int8 storage (the
    facade's f32 working precision) and else in the storage dtype."""
    import torch
    pcd0, pcd1, A, _, _ = prob
    dtype = storage if storage in (torch.float32, torch.float64) else \
        torch.float32
    At = torch.as_tensor(A, device=dev)
    P1 = torch.as_tensor(pcd0, dtype=dtype, device=dev)[At[:, 0].long()]
    P2 = torch.as_tensor(pcd1, dtype=dtype, device=dev)[At[:, 1].long()]
    return P1, P2, At


def rows_storage(inv, prob, dev, G, storage=None):
    """The capacity engine's row-chunked storage of one problem (int8 by
    default, else the raw scores in the float dtype ``storage``)."""
    import torch
    from clipper_tpu_torch.ops import symstore
    P1, P2, At = capacity_endpoints(prob, dev, storage)
    return symstore.build_symchunks(inv, P1, P2, At, len(At), tile=ROWS_T,
                                    G=G, storage_dtype=storage or torch.int8)


def tiles_storage(inv, prob, dev, storage=None):
    """The same problem's tile-list storage (ops/symstore.build_symtiles)."""
    import torch
    from clipper_tpu_torch.ops import symstore
    P1, P2, At = capacity_endpoints(prob, dev, storage)
    return symstore.build_symtiles(inv, P1, P2, At, len(At), tile=ROWS_T,
                                   storage_dtype=storage or torch.int8)


def tile_slices(tiles, nt, D):
    """The D contiguous slices of shard_tile_coords(nt, D), as a sharded
    rank holds them: (storage, rows, cols) each. The padded list is the
    canonical one followed by inert zero tiles, so a slice is a view of
    the whole storage, the last one copied with its zero tiles."""
    from clipper_tpu_torch.ops import symstore
    rows, cols = symstore.shard_tile_coords(nt, D)
    T, n = tiles.shape[0], len(rows) // D
    out = []
    for d in range(D):
        a, b = d * n, (d + 1) * n
        part = tiles[a:min(b, T)]
        if b > T:
            part = with_zeros(part, b - max(a, T))
        out.append((part, rows[a:b], cols[a:b]))
    return out


def chunk_slices(chunks, nt, D):
    """The D contiguous slices of the chunk list padded with inert zero
    chunks to a multiple of D (the sharded engine's 'pallas' mode): (base,
    storage) each."""
    NC, n = chunks.shape[0], -(-chunks.shape[0] // D)
    out = []
    for d in range(D):
        a, b = d * n, (d + 1) * n
        part = chunks[a:min(b, NC)]
        if b > NC:
            part = with_zeros(part, b - max(a, NC))
        out.append((a, part))
    return out


def with_zeros(part, n):
    """part followed by n zero entries along its first axis."""
    import torch
    return torch.cat([part, part.new_zeros((n,) + tuple(part.shape[1:]))])


def check_tiles(tiles, nt, U, label, D=3):
    """sym_tiles_matvec against the plain version on U (K, m), on the whole
    list and on its D slices summed (each slice's f64 sums added, then
    rounded once, as the sharded engine's all-reduce does); returns the
    max abs error."""
    import torch
    from clipper_tpu_torch.ops import symstore
    a = symstore.sym_tiles_matvec_cuda(tiles, nt, U)
    b = symstore.sym_tiles_matvec_plain(tiles, nt, U)
    require(bool(torch.isfinite(a).all()) and a.shape == b.shape,
            f"sym_tiles_matvec {label}: non-finite output or bad shape")
    require(bool(torch.equal(a, symstore.sym_tiles_matvec_cuda(tiles, nt, U))),
            f"sym_tiles_matvec {label}: a rerun is not bit-identical")
    acc = sum(symstore.sym_tiles_matvec_cuda(p, nt, U, r, c, raw=True)
              for p, r, c in tile_slices(tiles, nt, D))
    summed = symstore._finish(acc, symstore._scale(tiles.dtype))
    raw = symstore.sym_tiles_matvec_cuda(tiles, nt, U, raw=True)
    err = float((a - b).abs().max())
    e_sl = float((summed - b).abs().max())
    print(f"sym_tiles_matvec vs plain ({label}): max|kernel - plain|="
          f"{err:.3e}; {D} slices summed: {e_sl:.3e} (their raw sums vs the "
          f"whole list's: max|diff|={float((acc - raw).abs().max()):.3e})",
          flush=True)
    require(err <= MATVEC_TOL, f"sym_tiles_matvec {label} disagrees with "
            "plain")
    require(e_sl <= MATVEC_TOL, f"sym_tiles_matvec {label}: the {D} slices "
            "summed disagree with the plain whole list")
    return max(err, e_sl)


def check_rows_slices(chunks, nt, U, label, D=3):
    """sym_rows_matvec over the D chunk slices against its plain version
    on each slice, and the slices summed against the whole list."""
    from clipper_tpu_torch.ops import symstore
    scale = symstore._scale(chunks.dtype)
    err, acc = 0.0, 0
    for base, part in chunk_slices(chunks, nt, D):
        k = symstore.sym_rows_matvec_cuda(part, nt, U, base, raw=True)
        p = symstore.sym_rows_matvec_plain(part, nt, U, base, raw=True)
        err = max(err, float((symstore._finish(k, scale)
                              - symstore._finish(p, scale)).abs().max()))
        acc = acc + k
    whole = symstore.sym_rows_matvec_plain(chunks, nt, U)
    e_sum = float((symstore._finish(acc, scale) - whole).abs().max())
    raw = symstore.sym_rows_matvec_cuda(chunks, nt, U, raw=True)
    print(f"sym_rows_matvec on {D} chunk slices ({label}): max|kernel - "
          f"plain| per slice={err:.3e}, slices summed vs whole={e_sum:.3e} "
          f"(raw sums vs the whole list's: max|diff|="
          f"{float((acc - raw).abs().max()):.3e})", flush=True)
    require(max(err, e_sum) <= MATVEC_TOL, f"sym_rows_matvec slices {label} "
            "disagree with plain")
    return max(err, e_sum)


def dense_from_tiles(tiles, nt, dtype):
    """Tile-list storage -> the dense stacked (2m, m) [M; C] in dtype (both
    triangles): row block r's tiles are its diagonal tile k = r and the
    contiguous run of its strictly-upper tiles (ops/symstore.tile_coords)."""
    import torch
    T, two_t, t = tiles.shape
    m = nt * t
    D = torch.zeros(2 * m, m, dtype=dtype, device=tiles.device)
    k = nt
    for r in range(nt):
        seg = torch.cat([tiles[r:r + 1], tiles[k:k + nt - r - 1]])
        k += nt - r - 1
        seg = seg.permute(1, 0, 2).reshape(two_t, -1).to(dtype)
        for h in range(2):
            half = seg[h * t:(h + 1) * t]
            D[h * m + r * t:h * m + (r + 1) * t, r * t:] = half
            D[h * m + (r + 1) * t:h * m + m, r * t:(r + 1) * t] = \
                half[:, t:].T
    return D


def tiles_oracle(tiles, nt, U):
    """The tile-list matvec in f64 through the dense [M; C]: int8 codes
    times bf16-rounded u over 127, or the float storage times u rounded to
    the storage dtype."""
    import torch
    from clipper_tpu_torch.ops import symstore
    Uc, scale = symstore._operand(tiles.dtype, U)
    Dn = dense_from_tiles(tiles, nt, torch.float64)
    return (Uc.double() @ Dn.T) * scale                 # (K, 2m)


def check_rows(chunks, nt, U, label):
    """sym_rows_matvec against the plain version on U (K, m); returns the
    max abs error."""
    import torch
    from clipper_tpu_torch.ops import symstore
    a = symstore.sym_rows_matvec_cuda(chunks, nt, U)
    b = symstore.sym_rows_matvec_plain(chunks, nt, U)
    require(bool(torch.isfinite(a).all()), f"sym_rows_matvec {label}: "
            "non-finite output")
    require(bool(torch.equal(a, symstore.sym_rows_matvec_cuda(chunks, nt, U))),
            f"sym_rows_matvec {label}: a rerun is not bit-identical")
    err = float((a - b).abs().max())
    print(f"sym_rows_matvec vs plain ({label}): max|kernel - plain|="
          f"{err:.3e}", flush=True)
    require(err <= MATVEC_TOL, f"sym_rows_matvec {label} disagrees with plain")
    return err


def first(D1, W):
    """The shared first dataset, or the first W problems' own."""
    return D1[:W] if np.ndim(D1) == 3 else D1


def run_pipeline(inv, data_, dev, W, timings=None, storage=None,
                 stall_outers=0):
    """bench.py's tri pool (int8 storage unless ``storage`` says)."""
    import torch
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params
    D1, D2s, As, _, u0s = data_
    pipe = pool.make_pool_pipeline(inv, Params(), lanes=128, window=2,
                                   storage_dtype=storage or torch.int8,
                                   power_steps=4, layout="tri",
                                   tri_probes=16, d_scale=0.15,
                                   stall_outers=stall_outers, device=dev)
    return pipe(first(D1, W), D2s[:W], As[:W], u0s[:W], timings=timings)


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
    print(f"pool path kernel launches (one call): {launches}", flush=True)
    print(f"main path ifinal: mean={float(sol.ifinal.float().mean()):.2f} "
          f"max={int(sol.ifinal.max())}", flush=True)
    require(launches["tri_matvec"] > 0 and launches["tri_build"] > 0,
            f"a kernel of the pool path was never launched: {launches}")
    require(P.mean() >= 0.995, f"precision {P.mean():.4f} < 0.995")
    require(R.mean() >= 0.88, f"recall {R.mean():.4f} < 0.88")
    return launches


def counted_call(run):
    """One call of run() with every launch count set to 0 just before it
    and read just after it (the call is also the warm-up)."""
    import torch
    from clipper_tpu_torch import _kernels
    _kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, dict(_kernels.LAUNCHES)


def timed_calls(run, reps: int):
    """(last result, mean wall seconds) of reps calls of run(), each ending
    in a synchronise."""
    import torch
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def check_quality(label, As, sol, Agts, W):
    """Shapes, finite values, F <= m and the bench protocol's P/R bars.
    Returns mean (P, R)."""
    import torch
    masks = sol.mask.cpu().numpy()
    score = sol.score.cpu().numpy()
    require(masks.shape == (W, M) and score.shape == (W,),
            f"{label}: shapes {masks.shape} {score.shape}")
    require(bool(np.isfinite(score).all()) and bool(
        torch.isfinite(sol.u).all()), f"{label}: non-finite u or score")
    require(float(score.max()) <= M, f"{label}: objective F > m")
    P, R = precision_recall(As[:W], masks, Agts[:W])
    require(P.mean() >= 0.995, f"{label}: precision {P.mean():.4f} < 0.995")
    require(R.mean() >= 0.88, f"{label}: recall {R.mean():.4f} < 0.88")
    return P.mean(), R.mean()


def run_stacked(inv, data_, dev, W, timings=None, stats=None):
    import torch
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params
    D1, D2s, As, _, u0s = data_
    pipe = pool.make_pool_pipeline(inv, Params(), storage_dtype=torch.int8,
                                   device=dev, **STACKED)
    return pipe(first(D1, W), D2s[:W], As[:W], u0s[:W], timings=timings,
                stats=stats)


def multistart_u0(W):
    return np.random.default_rng(0).random((W, K_MULTI, M)).astype(
        np.float32)


def run_multistart(inv, data_, dev, W, u0K, timings=None, stats=None):
    import torch
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params
    D1, D2s, As, _, _ = data_
    pipe = pool.make_pool_multistart_pipeline(
        inv, Params(), restarts=K_MULTI, storage_dtype=torch.int8,
        power_steps=STACKED["power_steps"], window=STACKED["window"],
        lanes=STACKED["lanes"], device=dev)
    return pipe(D1, D2s[:W], As[:W], u0K[:W], timings=timings, stats=stats)


def run_batched(inv, data_, dev, W, stats=None):
    from clipper_tpu_torch.parallel import batched
    from clipper_tpu_torch.types import Params
    D1, D2s, As, _, u0s = data_
    pipe = batched.make_batched_pipeline(inv, Params(), matvec="fused",
                                         device=dev)
    return pipe(D1, D2s[:W], As[:W], u0s[:W], stats=stats)


def phase_stacked(inv, main, dev):
    """3b: the stacked pool on the main data. Returns its launches."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import affinity_pallas
    from clipper_tpu_torch.solvers import msrc_flat

    D1, D2s, As, Agts, _ = main
    sol, launches = counted_call(lambda: run_stacked(inv, main, dev, W_MAIN))
    timings, stats = {}, {}
    reps = 3
    sol, wall = timed_calls(lambda: run_stacked(
        inv, main, dev, W_MAIN, timings=timings, stats=stats), reps)
    P, R = check_quality("stacked pool", As, sol, Agts, W_MAIN)
    ticks = stats["ticks"].float()
    nwin = stats["windows"]
    lockstep = nwin * STACKED["window"]
    print(f"stacked pool: W={W_MAIN} m={M} rho={RHO}: precision="
          f"{P * 100:.2f}% recall={R * 100:.2f}%  {W_MAIN / wall:.1f} "
          f"problems/s ({wall * 1e3:.1f} ms/batch, mean of {reps} after 1 "
          f"warm-up)", flush=True)
    print("stacked pool stage ms (last timed call, CUDA events): "
          + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()), flush=True)
    print(f"stacked pool: {nwin} windows of {STACKED['window']} ticks "
          f"({lockstep} ticks on the lanes, {timings['solve'] / lockstep:.4f}"
          f" ms a tick in the solve stage); ticks a problem mean="
          f"{float(ticks.mean()):.1f} max={int(ticks.max())}; ifinal mean="
          f"{float(sol.ifinal.float().mean()):.2f} max="
          f"{int(sol.ifinal.max())}", flush=True)
    print(f"stacked pool kernel launches (one call): {launches}", flush=True)
    require(launches["stored_build"] == 1,
            f"stacked pool: stored_build launched "
            f"{launches['stored_build']} times in one call, not once")

    # the stacked matvec of one tick: every lane's gather and f32 matmul
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    mts = torch.full((W_MAIN,), M, dtype=torch.int32, device=dev)
    store = affinity_pallas.stored_build_cuda(inv, P1s, P2s, At, mts)
    bmv = msrc_flat.make_stacked_pool_matvec(store, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(3)
    B = STACKED["lanes"]
    idx = torch.randperm(W_MAIN, generator=gen, device=dev)[:B].to(
        torch.int32)
    U = unit_rows(gen, B, 1, dev)[:, 0]
    mv_ms = time_ms(lambda: bmv(idx, U), dev, 20)
    print(f"stacked matvec a tick (B={B} lanes, int8 storage: gather + f32 "
          f"matmul, plain PyTorch): {mv_ms:.4f} ms", flush=True)
    return launches


def phase_multistart(inv, main, dev):
    """3c: K restarts of the first W_MULTI problems, against the
    single-start stacked pool on the same problems."""
    _, _, As, Agts, _ = main
    u0K = multistart_u0(W_MULTI)
    sol, launches = counted_call(lambda: run_multistart(inv, main, dev,
                                                        W_MULTI, u0K))
    timings, stats = {}, {}
    reps = 2
    sol, wall = timed_calls(lambda: run_multistart(
        inv, main, dev, W_MULTI, u0K, timings=timings, stats=stats), reps)
    P, R = check_quality("multistart", As, sol, Agts, W_MULTI)
    counted_call(lambda: run_stacked(inv, main, dev, W_MULTI))
    _, wall1 = timed_calls(lambda: run_stacked(inv, main, dev, W_MULTI), reps)
    chosen = np.bincount(sol.ifinal.cpu().numpy(), minlength=K_MULTI)
    print(f"multistart: W={W_MULTI} K={K_MULTI} m={M}: precision="
          f"{P * 100:.2f}% recall={R * 100:.2f}%  {wall / W_MULTI * 1e3:.3f} "
          f"ms/problem against {wall1 / W_MULTI * 1e3:.3f} ms/problem single "
          f"start (ratio {wall / wall1:.2f}, mean of {reps} after 1 warm-up); "
          f"restart chosen {chosen.tolist()}; {stats['windows']} windows",
          flush=True)
    print("multistart stage ms (last timed call, CUDA events): "
          + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()), flush=True)
    print(f"multistart kernel launches (one call): {launches}", flush=True)
    require(launches["stored_build"] == 1,
            f"multistart: stored_build launched {launches['stored_build']} "
            "times in one call, not once")


def phase_batched(inv, main, dev):
    """3d: the fused batched engine on the main data. Returns its
    launches."""
    _, _, As, Agts, _ = main
    stats = {}
    sol, launches = counted_call(lambda: run_batched(inv, main, dev, W_MAIN,
                                                     stats=stats))
    sol, wall = timed_calls(lambda: run_batched(inv, main, dev, W_MAIN,
                                                stats=stats), 1)
    P, R = check_quality("fused batched", As, sol, Agts, W_MAIN)
    print(f"fused batched: W={W_MAIN} m={M} rho={RHO} f32: precision="
          f"{P * 100:.2f}% recall={R * 100:.2f}%  {W_MAIN / wall:.1f} "
          f"problems/s ({wall * 1e3:.1f} ms/batch, 1 call after 1 warm-up); "
          f"{stats['ticks']} lock-step ticks; ifinal mean="
          f"{float(sol.ifinal.float().mean()):.2f} max="
          f"{int(sol.ifinal.max())}", flush=True)
    print(f"fused batched kernel launches (one call): {launches}", flush=True)
    require(launches["pattern_matvec"] > 0,
            f"the pattern matvec was never launched: {launches}")
    return launches


def compare_devices(label, sg, sc, As, Agts, W, need, restarts=False):
    """Masks of a cuda and a cpu run: equal on >= need of W problems, mean
    P/R within 1 point. With restarts, the chosen restart must agree too:
    its index, or, where restarts that reach the same clique tie, its
    polished F within 1e-5 relative (an ulp-level difference picks another
    index among equals)."""
    mg = sg.mask.cpu().numpy()
    mc = sc.mask.cpu().numpy()
    same = (mg == mc).all(1)
    ig, ic = sg.ifinal.cpu().numpy(), sc.ifinal.cpu().numpy()
    Fg, Fc = sg.score.cpu().double().numpy(), sc.score.cpu().double().numpy()
    if restarts:
        same &= (ig == ic) | (np.abs(Fg - Fc) <= 1e-5 * np.abs(Fc))
    Pg, Rg = precision_recall(As[:W], mg, Agts[:W])
    Pc, Rc = precision_recall(As[:W], mc, Agts[:W])
    what = (f"restart and mask (same index on {int((ig == ic).sum())})"
            if restarts else "masks")
    print(f"cuda vs cpu, {label} (W={W}): {what} equal on {int(same.sum())}"
          f"/{W}; P {Pg.mean() * 100:.2f}/{Pc.mean() * 100:.2f}%  "
          f"R {Rg.mean() * 100:.2f}/{Rc.mean() * 100:.2f}%", flush=True)
    for w in np.flatnonzero(~same | (ig != ic)):
        print(f"  problem {w}: {int((mg[w] != mc[w]).sum())} vertices differ;"
              f" |mask| cuda {int(mg[w].sum())} cpu {int(mc[w].sum())}; "
              f"ifinal cuda {ig[w]} cpu {ic[w]}; F cuda {Fg[w]:.6f} cpu "
              f"{Fc[w]:.6f}", flush=True)
    require(int(same.sum()) >= need,
            f"{label}: cuda/cpu differ on {W - int(same.sum())} problems")
    require(abs(Pg.mean() - Pc.mean()) <= 0.01 and
            abs(Rg.mean() - Rc.mean()) <= 0.01,
            f"{label}: cuda/cpu P/R differ > 1pt")


def run_pipeline_bf16(inv, data_, dev, W, timings=None):
    import torch
    return run_pipeline(inv, data_, dev, W, timings, storage=torch.bfloat16)


def phase_bf16_pool(inv, main, dev):
    """3g: bench.py's tri pool protocol with bf16 storage (the JAX
    package's default): the W=512 problems, one counted call (also the
    warm-up) and 2 timed calls; the P/R bars, the tri build kernel
    launched once a call (no plain build) and the tri matvec launched."""
    _, _, As, Agts, _ = main
    sol, launches = counted_call(
        lambda: run_pipeline_bf16(inv, main, dev, W_MAIN))
    timings = {}
    sol, secs = timed_calls(lambda: run_pipeline_bf16(
        inv, main, dev, W_MAIN, timings=timings), 2)
    P, R = check_quality("bf16 tri pool", As, sol, Agts, W_MAIN)
    print(f"bf16 tri pool: W={W_MAIN} m={M}: precision={P * 100:.2f}% "
          f"recall={R * 100:.2f}%  {W_MAIN / secs:.1f} problems/s "
          f"({secs * 1e3:.1f} ms/batch, mean of 2 after 1 warm-up); stage "
          "ms " + ", ".join(f"{k}={v:.3f}" for k, v in timings.items())
          + f"; launches {launches}", flush=True)
    require(launches["tri_build"] == 1 and launches["tri_matvec"] > 0,
            f"bf16 tri pool: tri_build once and tri_matvec expected: "
            f"{launches}")
    return launches


def phase_parity(inv, check, dev):
    _, _, As, Agts, _ = check
    for label, run in (("tri pool", run_pipeline),
                       ("bf16 tri pool", run_pipeline_bf16),
                       ("stacked pool", run_stacked),
                       ("fused batched", run_batched)):
        compare_devices(label, run(inv, check, dev, W_CHECK),
                        run(inv, check, "cpu", W_CHECK), As, Agts, W_CHECK,
                        W_CHECK - 1)
    W = W_PARITY_MULTI
    u0K = multistart_u0(W)
    compare_devices(f"multistart K={K_MULTI}",
                    run_multistart(inv, check, dev, W, u0K),
                    run_multistart(inv, check, "cpu", W, u0K), As, Agts, W,
                    W - 1, restarts=True)


def shares_text(shares):
    """harness.gate_shares' shares as percentages of the distinct pairs."""
    return "survivor shares of the distinct pairs: " + ", ".join(
        f"{k} {100 * v:.2f}%" for k, v in shares.items())


def phase_timing(inv, main, dev):
    """Per-kernel checks and times at the main path's shapes: the tri
    build and matvec, the fused build beside the tri build (with the
    shares of pairs their screen and gate pass), the tiles matvec beside
    the tri matvec at K=1. Returns the rows of the kernels' JSON line and
    the max errors at these shapes (build code diff, tri matvec and tiles
    matvec abs errors)."""
    import torch
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.bench.harness import time_ms
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
    bound_ms, bound_by = build_bound(b_bytes, W_MAIN, M, BUILD_OPS_PER_PAIR)
    rows["tri_build"] = dict(
        ms=time_ms(build, dev, 10),
        plain_ms=time_ms(lambda: flattri.build_tri_plain(
            inv, P1s, P2s, At, mts, t=t), dev, 2),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

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
        ms = time_ms(lambda: flattri.tri_pool_matvec_cuda(
            tri, nt, idx, U, torch.float32), dev, 50)
        plain = time_ms(lambda: flattri.tri_pool_matvec_plain(
            tri, nt, idx, U, torch.float32), dev, 5)
        dense = flattri.dense_stacked(tri[idx.long()], nt).to(torch.bfloat16)
        Ut = U.to(torch.bfloat16).transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.bmm(dense, Ut), dev, 20)
        del dense
        bound_s = max(mv_bytes / HBM_BYTES_PER_S, mv_ops / BF16_FLOPS)
        r = dict(ms=ms, plain_ms=plain, bound_ms=bound_s * 1e3,
                 bound_by=("bytes" if mv_bytes / HBM_BYTES_PER_S
                           > mv_ops / BF16_FLOPS else "operations"),
                 library_ms=lib)
        if K == 16:
            rows["tri_matvec"] = r
        extra.append((B, K, r))
    rows["tri_matvec"]["int8_B512_K1"] = dict(extra[-1][2])
    for name, r in rows.items():
        print(f"timing {name}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}", flush=True)
    for B, K, r in extra:
        print(f"timing tri_matvec B={B} K={K}: kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bmm over dense bf16 [M; C] {r['library_ms']:.4f} ms",
              flush=True)

    # kernel 8 beside kernel 2 on the same problems, and the shares of
    # pairs their screen and gate pass
    def fused():
        return flattri.build_tri_fused_cuda(inv, P1s, P2s, At, mts, t=t)

    require(bool(torch.equal(fused(), tri)), "tri_build_fused differs from "
            "tri_build at W=512")
    r2 = rows["tri_build"]
    r2["gate_shares"] = harness.gate_shares(inv, P1s, P2s, At, mts)
    rows["tri_build_fused"] = dict(
        r2, ms=time_ms(fused, dev, 10), plain_ms=time_ms(
            lambda: flattri.build_tri_plain(inv, P1s, P2s, At, mts, t=t),
            dev, 2))
    print(f"timing tri_build_fused W={W_MAIN} m={M} t={t}: kernel "
          f"{rows['tri_build_fused']['ms']:.4f} ms beside tri_build "
          f"{time_ms(build, dev, 10):.4f} ms (bound {r2['bound_ms']:.4f} ms), "
          f"plain {rows['tri_build_fused']['plain_ms']:.4f} ms; "
          f"{shares_text(r2['gate_shares'])}", flush=True)

    # kernel 9 on the tile-major form, one probe a lane, beside kernel 1
    # at K=1 on the same content
    tiles = flat_tiles(tri, nt)
    tiles_err = 0.0
    for B in (128, W_MAIN):
        idx = torch.randperm(W_MAIN, generator=gen, device=dev)[:B].to(
            torch.int32)
        U = unit_rows(gen, B, 1, dev)[:, 0]
        tiles_err = max(tiles_err, check_tiles_matvec(
            tri, nt, idx, U, f"int8, B={B}, m={M}"))
        mv_bytes = B * T * 2 * t * t + B * M * 2 + B * 2 * M * 4 + B * 4
        mv_ops = 2 * B * 2 * t * t * (2 * T - nt)
        dense = flattri.dense_stacked(tri[idx.long()], nt).to(torch.bfloat16)
        Ub = U.to(torch.bfloat16)[..., None]
        r = dict(ms=time_ms(lambda: flattri.tri_tiles_matvec_cuda(
                     tiles, nt, idx, U, torch.float32), dev, 50),
                 plain_ms=time_ms(lambda: flattri.tri_tiles_matvec_plain(
                     tiles, nt, idx, U, torch.float32), dev, 3),
                 bound_ms=max(mv_bytes / HBM_BYTES_PER_S,
                              mv_ops / BF16_FLOPS) * 1e3,
                 bound_by=("bytes" if mv_bytes / HBM_BYTES_PER_S
                           > mv_ops / BF16_FLOPS else "operations"),
                 library_ms=time_ms(lambda: torch.bmm(dense, Ub), dev, 20))
        del dense
        k1 = time_ms(lambda: flattri.tri_pool_matvec_cuda(
            tri, nt, idx, U[:, None], torch.float32), dev, 50)
        if B == 128:
            rows["tri_tiles_matvec"] = r
        print(f"timing tri_tiles_matvec B={B} one probe: kernel {r['ms']:.4f}"
              f" ms beside tri_matvec K=1 {k1:.4f} ms on the same content, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, bmm over dense bf16 [M; C] "
              f"{r['library_ms']:.4f} ms", flush=True)
    del tiles
    torch.cuda.empty_cache()

    # the same kernels writing and reading bf16 storage: the builds (2 and
    # 8), the tri matvec (1) and the tiles matvec (9); their numbers go
    # into each row's "bf16" field
    bf = torch.bfloat16

    def build_bf():
        return flattri.build_tri_cuda(inv, P1s, P2s, At, mts, t=t,
                                      storage_dtype=bf)

    tri_bf = build_bf()
    build_err = max(build_err, check_build(tri_bf, flattri.build_tri_plain(
        inv, P1s, P2s, At, mts, t=t, storage_dtype=bf), t,
        f"bf16, W={W_MAIN}, m={M}"))
    require(bool(torch.equal(flattri.build_tri_fused_cuda(
        inv, P1s, P2s, At, mts, t=t, storage_dtype=bf), tri_bf)),
        "tri_build_fused differs from tri_build in bf16 at W=512")
    bb_ms, bb_by = build_bound(b_bytes + W_MAIN * 2 * t * S, W_MAIN, M,
                               BUILD_OPS_PER_PAIR)
    plain_bf = time_ms(lambda: flattri.build_tri_plain(
        inv, P1s, P2s, At, mts, t=t, storage_dtype=bf), dev, 2)
    for name, fn in (("tri_build", build_bf),
                     ("tri_build_fused", lambda: flattri.build_tri_fused_cuda(
                         inv, P1s, P2s, At, mts, t=t, storage_dtype=bf))):
        rows[name]["bf16"] = dict(ms=time_ms(fn, dev, 10), plain_ms=plain_bf,
                                  bound_ms=bb_ms, bound_by=bb_by,
                                  library_ms=None)
        print(f"timing {name} bf16 W={W_MAIN} m={M}: kernel "
              f"{rows[name]['bf16']['ms']:.4f} ms, bound {bb_ms:.4f} ms "
              f"({bb_by}), plain {plain_bf:.4f} ms", flush=True)
    for B, K in ((128, 16), (W_MAIN, 1)):
        idx = torch.randperm(W_MAIN, generator=gen, device=dev)[:B].to(
            torch.int32)
        U = unit_rows(gen, B, K, dev)
        mv_err = max(mv_err, check_matvec(tri_bf, nt, idx, U,
                                          f"bf16, B={B}, K={K}"))
        mv_bytes = B * 2 * t * S * 2 + B * K * M * 2 + B * K * 2 * M * 4
        mv_ops = 2 * K * B * (2 * t * S + 2 * t * t * (T - nt))
        dense = flattri.dense_stacked(tri_bf[idx.long()], nt)
        Ut = U.to(bf).transpose(1, 2).contiguous()
        r = dict(ms=time_ms(lambda: flattri.tri_pool_matvec_cuda(
                     tri_bf, nt, idx, U, torch.float32), dev, 50),
                 plain_ms=time_ms(lambda: flattri.tri_pool_matvec_plain(
                     tri_bf, nt, idx, U, torch.float32), dev, 5),
                 library_ms=time_ms(lambda: torch.bmm(dense, Ut), dev, 20),
                 **bound_of(mv_bytes, mv_ops))
        del dense
        rows["tri_matvec"]["bf16" if K == 16 else "bf16_B512_K1"] = r
        print(f"timing tri_matvec bf16 B={B} K={K}: kernel {r['ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, bmm over dense bf16 [M; C] "
              f"{r['library_ms']:.4f} ms", flush=True)
    tiles = flat_tiles(tri_bf, nt)
    for B in (128, W_MAIN):
        idx = torch.randperm(W_MAIN, generator=gen, device=dev)[:B].to(
            torch.int32)
        U = unit_rows(gen, B, 1, dev)[:, 0]
        tiles_err = max(tiles_err, check_tiles_matvec(
            tri_bf, nt, idx, U, f"bf16, B={B}, m={M}"))
        mv_bytes = B * T * 2 * t * t * 2 + B * M * 2 + B * 2 * M * 4 + B * 4
        mv_ops = 2 * B * 2 * t * t * (2 * T - nt)
        dense = flattri.dense_stacked(tri_bf[idx.long()], nt)
        Ub = U.to(bf)[..., None]
        r = dict(ms=time_ms(lambda: flattri.tri_tiles_matvec_cuda(
                     tiles, nt, idx, U, torch.float32), dev, 50),
                 plain_ms=time_ms(lambda: flattri.tri_tiles_matvec_plain(
                     tiles, nt, idx, U, torch.float32), dev, 3),
                 library_ms=time_ms(lambda: torch.bmm(dense, Ub), dev, 20),
                 **bound_of(mv_bytes, mv_ops))
        del dense
        if B == 128:
            rows["tri_tiles_matvec"]["bf16"] = r
        print(f"timing tri_tiles_matvec bf16 B={B} one probe: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, bmm over "
              f"dense bf16 [M; C] {r['library_ms']:.4f} ms", flush=True)
    del tiles, tri_bf
    torch.cuda.empty_cache()
    return rows, build_err, mv_err, tiles_err


def time_stacked_and_pattern(inv, main, dev):
    """The stacked build at W=512 (int8, and bf16 in the row's "bf16"
    field) and the pattern matvec at B=512 (f32 and bf16 M, each beside
    one bmm over the dense [M; C] in its type), held against their plain
    versions, then timed. Returns their rows of the kernels' JSON line
    and max errors."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import affinity_pallas, fused_matvec
    from clipper_tpu_torch.ops.affinity import (pairwise_from_endpoints,
                                                stored_from_endpoints)

    D1, D2s, As, _, _ = main
    W = W_MAIN
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    mts = torch.full((W,), M, dtype=torch.int32, device=dev)
    rows, errs = {}, {}
    in_bytes = 2 * W * M * 3 * 4 + W * M * 2 * 4 + W * 4
    errs["stored_build"] = 0.0
    for storage in (torch.int8, torch.bfloat16):
        name = str(storage).split(".")[-1]
        store, e = check_stored(inv, P1s, P2s, At, mts, storage,
                                f"{name}, W={W}, m={M}")
        errs["stored_build"] = max(errs["stored_build"], e)
        del store
        bound_ms, bound_by = build_bound(
            W * 2 * M * M * storage.itemsize + in_bytes,
            W, M, BUILD_OPS_PER_PAIR)
        r = dict(ms=time_ms(lambda: affinity_pallas.stored_build_cuda(
                     inv, P1s, P2s, At, mts, storage_dtype=storage), dev, 10),
                 plain_ms=time_ms(lambda: stored_from_endpoints(
                     inv, P1s, P2s, At, m_true=mts, storage_dtype=storage),
                     dev, 2),
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        torch.cuda.empty_cache()
        if storage == torch.int8:
            rows["stored_build"] = r
        else:
            rows["stored_build"]["bf16"] = r
        print(f"timing stored_build W={W} m={M} {name}: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              "None", flush=True)

    Md, _ = pairwise_from_endpoints(inv, P1s, P2s, At)
    gen = torch.Generator(device=dev).manual_seed(4)
    u = unit_rows(gen, W, 1, dev)[:, 0]
    errs["pattern_matvec"] = 0.0
    for Mx in (Md, Md.bfloat16()):
        label = f"{str(Mx.dtype).split('.')[-1]}, B={W}, m={M}"
        errs["pattern_matvec"] = max(errs["pattern_matvec"], check_pattern(
            Mx, u, label, oracle=False))
        p_bytes = Mx.numel() * Mx.element_size() + W * M * 4 + 2 * W * M * 4
        p_ops = 4 * W * M * M
        r = dict(ms=time_ms(lambda: fused_matvec.pattern_dual_matvec_cuda(
                     Mx, u), dev, 20),
                 plain_ms=time_ms(
                     lambda: fused_matvec.pattern_dual_matvec_plain(Mx, u),
                     dev, 3),
                 bound_ms=max(p_bytes / HBM_BYTES_PER_S,
                              p_ops / F32_FLOPS) * 1e3,
                 bound_by=("bytes" if p_bytes / HBM_BYTES_PER_S
                           > p_ops / F32_FLOPS else "operations"),
                 library_ms=None)
        # the yardstick: one bmm over the dense [M; C] in M's type (f32
        # with TF32 off, or bf16 with u rounded to bf16)
        MC = torch.cat([Mx, (Mx > 0).to(Mx.dtype)], dim=1)
        ux = u.to(Mx.dtype)[..., None]
        r["library_ms"] = time_ms(lambda: torch.bmm(MC, ux), dev, 10)
        del MC
        if Mx.dtype == torch.float32:
            rows["pattern_matvec"] = r
        else:
            rows["pattern_matvec"]["bf16"] = r
        print(f"timing pattern_matvec {label}: kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, bmm over dense {Mx.dtype} [M; C] "
              f"{r['library_ms']:.4f} ms", flush=True)
    del Md
    torch.cuda.empty_cache()
    return rows, errs


def capacity_solve(inv, prob, dev, engine, opts):
    """One problem through the facade in f32: the counted call (also the
    warm-up), then one timed warm call. Returns (clipper, solution, the
    warm call's stats, the counted call's launches, warm wall s, first
    call s)."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.types import Params

    pcd0, pcd1, A, _, u0 = prob
    stats = {}
    c = Clipper(inv, Params(), engine=engine, dtype=torch.float32,
                device=dev, engine_opts=dict(opts, stats=stats))
    c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    sol, launches = counted_call(lambda: c.solve(u0=u0))
    cold = sol.t
    t0 = time.perf_counter()
    sol = c.solve(u0=u0)
    torch.cuda.synchronize()
    return c, sol, stats, launches, time.perf_counter() - t0, cold


def report_capacity(label, run, Agt, kernel):
    """Shapes, finite values, F <= m, the P/R bars, ``kernel`` and its
    reduction launched;
    prints the quality, stage times, ticks, storage and launches."""
    import torch
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench import data

    c, sol, stats, launches, wall, cold = run
    m = c.get_initial_associations().shape[0]
    mask = sol.mask.cpu().numpy()
    F = float(sol.score)
    require(mask.shape == (m,) and bool(torch.isfinite(sol.u).all())
            and np.isfinite(F), f"{label}: bad shape or non-finite u/F")
    require(F <= m, f"{label}: objective F > m")
    P, R = data.get_precision_recall(c.get_selected_associations(), Agt)
    print(f"{label}: m={m} rho={CAP_RHO} layout={stats['layout']}: precision="
          f"{P * 100:.2f}% recall={R * 100:.2f}% |mask|={int(mask.sum())} "
          f"(|Agt|={len(Agt)}); ifinal={int(sol.ifinal)} F={F:.4f} "
          f"ticks={stats['ticks']} rejected probes={stats['nback']}; "
          f"storage {stats['storage_bytes'] / 1e9:.3f} GB", flush=True)
    total = sum(stats[k] for k in ("build", "init", "solve", "polish"))
    print(f"{label} wall: warm call {wall:.4f} s (first call {cold:.4f} s); "
          "stage ms of the warm call (CUDA events): "
          + ", ".join(f"{k}={stats[k]:.3f} ({stats[k] / total * 100:.1f}%)"
                      for k in ("build", "init", "solve", "polish")),
          flush=True)
    print(f"{label} kernel launches (one call): {launches}", flush=True)
    for name in (kernel, _kernels.REDUCTIONS[kernel]):
        require(launches[name] > 0, f"{label}: {name} was never launched: "
                f"{launches}")
    require(P >= 0.995, f"{label} precision {P:.4f} < 0.995")
    require(R >= 0.88, f"{label} recall {R:.4f} < 0.88")
    return mask, F


@contextlib.contextmanager
def one_rank_group(dev):
    """A 1-rank NCCL process group on dev, met through an in-memory
    HashStore (no network), destroyed on the way out."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


SHARDED_OPTS = {"build_chunk": 256, "support": 512}   # the triangle engine's


def phase_capacity(inv, prob, dev):
    """The capacity path: one m=65,536 problem through the facade, four
    ways: engine="auto" (the triangle engine's row-chunked layout), the
    triangle engine's tile list (matvec="xla"), and the sharded engine on
    a 1-rank NCCL group in its 'xla' (tile list) and 'pallas' (row-chunked)
    modes, with the triangle engine's build chunk and support so that its
    'xla' mode must reproduce the tile-list solve. Returns the launches of
    the auto and tile-list runs."""
    m, Agt = len(prob[2]), prob[3]
    run = capacity_solve(inv, prob, dev, "auto", {})
    engine = run[0]._resolve_engine(m)
    require(engine == "triangle" and run[0]._cap is not None,
            f"m={m} resolved to engine {engine!r}, not the triangle engine")
    report_capacity("capacity path (auto)", run, Agt, "sym_rows_matvec")
    launches = dict(run[3])
    run = capacity_solve(inv, prob, dev, "triangle", {"matvec": "xla"})
    mask_x, F_x = report_capacity("capacity path (tile list)", run, Agt,
                                  "sym_tiles_matvec")
    for name in ("sym_tiles_matvec", "sym_tiles_reduce"):
        launches[name] = run[3][name]

    with one_rank_group(dev):
        for mode, kernel in (("xla", "sym_tiles_matvec"),
                             ("pallas", "sym_rows_matvec")):
            run = capacity_solve(inv, prob, dev, "sharded",
                                 dict(SHARDED_OPTS, matvec=mode))
            require(run[2]["ranks"] == 1, "the sharded engine did not take "
                    "the 1-rank group")
            mask, F = report_capacity(f"sharded engine D=1 ({mode})", run,
                                      Agt, kernel)
            if mode == "xla":
                same = bool((mask == mask_x).all())
                dF = abs(F - F_x) / abs(F_x)
                print(f"sharded D=1 (xla) vs tile-list solve: masks equal "
                      f"{same} ({int((mask != mask_x).sum())} differ), F "
                      f"relative difference {dF:.3e}", flush=True)
                require(same and dF <= 1e-6, "the sharded engine at D=1 "
                        "differs from the single-device tile-list solve")
    return launches


def phase_facade_parity(inv, dev):
    """The facade on cuda and on cpu: the triangle engine at m=8192 (f32)
    and the dense engine at m=1024 (f64)."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import data
    from clipper_tpu_torch.types import Params

    def run(prob, d, engine, dtype, opts=None):
        pcd0, pcd1, A, Agt, u0 = prob
        c = Clipper(inv, Params(), engine=engine, dtype=dtype, device=d,
                    engine_opts=opts)
        c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
        sol = c.solve(u0=u0)
        return c, sol.mask.cpu().numpy(), int(sol.ifinal)

    # The kernel's and the plain version's matvecs are about an ulp apart,
    # and the f32 solve's accept and stall decisions amplify that. The
    # spread printed beside the bar: on each device, the same solve with
    # +-1 ulp of noise on every matvec output, against that device's
    # noiseless run. Both layouts of the triangle engine: row-chunked
    # ('auto') and the tile list (matvec='xla').
    prob = one_problem(CAP_PARITY_M, CAP_RHO, seed=2)
    for layout, opts, trials in (
            ("row-chunked", {}, (SPREAD_TRIALS_CUDA, SPREAD_TRIALS_CPU)),
            ("tile list", {"matvec": "xla"}, (SPREAD_TRIALS_TILES, 1))):
        cg, mg, ig = run(prob, dev, "auto", torch.float32, opts)
        require(cg._resolve_engine(CAP_PARITY_M) == "triangle",
                f"m={CAP_PARITY_M} did not take the triangle engine")
        cc, mc, ic = run(prob, "cpu", "auto", torch.float32, opts)
        iou = mask_iou(mg, mc)
        pr = [data.get_precision_recall(c.get_selected_associations(),
                                        prob[3]) for c in (cg, cc)]
        label = f"triangle engine ({layout}) m={CAP_PARITY_M}"
        print(f"facade cuda vs cpu, {label}: mask IoU={iou:.4f}, |mask| "
              f"cuda {int(mg.sum())} cpu {int(mc.sum())}, "
              f"{int((mg != mc).sum())} vertices differ; ifinal cuda {ig} "
              f"cpu {ic}; P/R cuda {pr[0][0] * 100:.2f}/"
              f"{pr[0][1] * 100:.2f}% cpu {pr[1][0] * 100:.2f}/"
              f"{pr[1][1] * 100:.2f}%", flush=True)
        spread = []
        for d, mref, n in ((dev, mg, trials[0]), ("cpu", mc, trials[1])):
            for s in range(1, n + 1):
                cn, mn, i_n = run(prob, d, "auto", torch.float32,
                                  dict(opts, wrap_matvec=ulp_noise(s, d)))
                P, R = data.get_precision_recall(
                    cn.get_selected_associations(), prob[3])
                spread.append(mask_iou(mn, mref))
                print(f"  matvec +-1 ulp ({d}, trial {s}): IoU vs noiseless "
                      f"{spread[-1]:.4f}, |mask| {int(mn.sum())}, ifinal "
                      f"{i_n}, P/R {P * 100:.2f}/{R * 100:.2f}%", flush=True)
        print(f"facade {label}: cuda vs cpu IoU {iou:.4f}; lowest IoU under "
              f"1-ulp matvec noise {min(spread):.4f} (bar {CAP_PARITY_IOU})",
              flush=True)
        require(iou >= CAP_PARITY_IOU, f"facade {label}: cuda and cpu masks "
                f"differ past IoU {CAP_PARITY_IOU}")
        require(all(p >= 0.995 and r >= 0.88 for p, r in pr),
                f"facade {label}: P/R below 0.995/0.88")

    prob = one_problem(DENSE_M, RHO, seed=3)
    prob = prob[:4] + (prob[4].astype(np.float64),)
    cg, mg, ig = run(prob, dev, "dense", torch.float64)
    _, mc, ic = run(prob, "cpu", "dense", torch.float64)
    P, R = data.get_precision_recall(cg.get_selected_associations(), prob[3])
    print(f"facade dense engine f64 m={DENSE_M} rho={RHO}: cuda precision="
          f"{P * 100:.2f}% recall={R * 100:.2f}%; masks equal to cpu: "
          f"{bool((mg == mc).all())} ({int((mg != mc).sum())} differ); "
          f"ifinal cuda {ig} cpu {ic}", flush=True)
    require(bool((mg == mc).all()), "facade dense engine: cuda and cpu "
            "masks differ")
    require(P >= 0.995 and R >= 0.85, f"facade dense engine P/R {P:.4f}/"
            f"{R:.4f} below 0.995/0.85")

    # solve(multistart=4): the four u0 come from the instance's seeded CPU
    # generator, so both devices start from the same vectors
    def run_multi(d):
        pcd0, pcd1, A, _, _ = prob
        c = Clipper(inv, Params(), engine="dense", dtype=torch.float64,
                    device=d)
        c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
        sol = c.solve(multistart=K_MULTI)
        return c, sol.mask.cpu().numpy(), int(sol.ifinal)

    cg, mg, ig = run_multi(dev)
    cc, mc, ic = run_multi("cpu")
    pr = [data.get_precision_recall(c.get_selected_associations(), prob[3])
          for c in (cg, cc)]
    print(f"facade dense engine f64 m={DENSE_M} solve(multistart="
          f"{K_MULTI}): masks equal to cpu: {bool((mg == mc).all())} "
          f"({int((mg != mc).sum())} differ); ifinal cuda {ig} cpu {ic}; "
          f"P/R cuda {pr[0][0] * 100:.2f}/{pr[0][1] * 100:.2f}% cpu "
          f"{pr[1][0] * 100:.2f}/{pr[1][1] * 100:.2f}%", flush=True)
    require(bool((mg == mc).all()), "facade dense multistart: cuda and cpu "
            "masks differ")
    require(abs(pr[0][0] - pr[1][0]) <= 0.01 and
            abs(pr[0][1] - pr[1][1]) <= 0.01,
            "facade dense multistart: cuda/cpu P/R differ > 1pt")


def dense_from_chunks(chunks, nt):
    """Row-chunked storage -> the dense stacked (2m, m) [M; C] in bf16
    (both triangles): the library call's operand."""
    import torch
    from clipper_tpu_torch.ops import symstore
    NC, two_t, Gt = chunks.shape
    t = two_t // 2
    m = nt * t
    first = symstore.row_first_chunk(nt, Gt // t)
    D = torch.zeros(2 * m, m, dtype=torch.bfloat16, device=chunks.device)
    for r in range(nt):
        seg = chunks[int(first[r]):int(first[r + 1])].permute(1, 0, 2)
        seg = seg.reshape(two_t, -1)[:, :(nt - r) * t].to(torch.bfloat16)
        for h in range(2):
            half = seg[h * t:(h + 1) * t]
            D[h * m + r * t:h * m + (r + 1) * t, r * t:] = half
            D[h * m + (r + 1) * t:h * m + m, r * t:(r + 1) * t] = \
                half[:, t:].T
    return D


# the capacity kernels' times at the m=65,536 shapes below in their earlier,
# two-read design (each off-diagonal tile read by its row's block and its
# column's block), on an H100 80GB HBM3 at 700 W: K=16, K=1, bf16 K=16
TWO_READ_MS = {"sym_rows_matvec": (5.4614, 3.9446, 11.8885),
               "sym_tiles_matvec": (5.3948, 3.9653, 10.8469)}
# the design's bytes a call over the stored tiles' bytes, at most
DESIGN_RATIO = {("int8", 16): 1.4, ("bfloat16", 16): 1.25, ("int8", 1): 1.05}


def design_bytes(plan, itemsize, K, m, t=ROWS_T):
    """(stored tile bytes, bytes a call of a capacity kernel moves by its
    design): every stored tile once, the workspace of f64 partials written
    once and read once, u read and the output written once."""
    tiles = len(plan.plan.entries) * 2 * t * t * itemsize
    ws = 2 * plan.plan.n_slots * 2 * K * t * 8
    return tiles, tiles + ws + K * m * 2 + K * 2 * m * 4


def time_plan(make, cache):
    """(device plan, (ms, cached ms)): make() with the host plans' cache
    emptied, then again from the cache, each on the host clock through
    the plan's copy to the card."""
    import torch
    ms = []
    for clear in (True, False):
        if clear:
            cache.cache_clear()
        t0 = time.perf_counter()
        plan = make()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return plan, tuple(ms)


def time_capacity(name, inv, prob, dev):
    """The rows (name "sym_rows_matvec") or tile-list ("sym_tiles_matvec")
    matvec on the capacity path's m=65,536 storage: held against its plain
    version at K=16 and K=1 (the tile list on its D=3 slices too), then
    timed with its plan built beforehand, beside its bound, its plain
    version, the dense bf16 [M; C] matmul and its two-read design's time;
    then the same over bf16 storage at K=16. Prints the time to make its
    plan (with the layout's plan cache emptied, and from the cache), the
    design's bytes a call against the stored tiles' (and fails past
    DESIGN_RATIO) and the rate it reaches. Returns the K=16 row of the kernels' JSON line and the
    max abs error."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import symstore

    rows_layout = name == "sym_rows_matvec"
    m = len(prob[2])
    t, G = ROWS_T, 32
    nt = m // t
    T = nt * (nt + 1) // 2
    gen = torch.Generator(device=dev).manual_seed(2 if rows_layout else 5)
    Us = {K: unit_rows(gen, 1, K, dev, m)[0] for K in (16, 1)}
    rows = {}
    err = 0.0
    for storage in (torch.int8, torch.bfloat16):
        label = str(storage).split(".")[-1]
        if rows_layout:
            store = rows_storage(inv, prob, dev, G=G, storage=storage)
            plan, plan_ms = time_plan(
                lambda: symstore.rows_device_plan(store, nt),
                symstore._rows_plan)
            dense = dense_from_chunks(store, nt)

            def kernel(U):
                return symstore.sym_rows_matvec_cuda(store, nt, U, plan=plan)

            def plain(U):
                return symstore.sym_rows_matvec_plain(store, nt, U)
        else:
            store = tiles_storage(inv, prob, dev, storage)
            plan, plan_ms = time_plan(
                lambda: symstore.tiles_device_plan(store, nt),
                symstore._tiles_plan)
            dense = dense_from_tiles(store, nt, torch.bfloat16)

            def kernel(U):
                return symstore.sym_tiles_matvec_cuda(store, nt, U,
                                                      plan=plan)

            def plain(U):
                return symstore.sym_tiles_matvec_plain(store, nt, U)
        print(f"{name} storage m={m}: {tuple(store.shape)} {label}, "
              f"{store.numel() * store.element_size() / 1e9:.3f} GB ({T} "
              f"tiles); plan: {len(plan.plan.units)} units, "
              f"{plan.plan.n_slots} partial slots, made in {plan_ms[0]:.1f} "
              f"ms (host plan and copy to the card), {plan_ms[1]:.1f} ms "
              "from the layout's cache", flush=True)
        for K in ((16, 1) if storage == torch.int8 else (16,)):
            U = Us[K]
            label_k = f"{label}, m={m}, K={K}"
            if rows_layout:
                err = max(err, check_rows(store, nt, U, label_k))
            else:
                err = max(err, check_tiles(store, nt, U, label_k))
            item = store.element_size()
            tile_bytes, n_bytes = design_bytes(plan, item, K, m)
            ratio = n_bytes / tile_bytes
            Ut = U.to(torch.bfloat16).T.contiguous()
            r = dict(ms=time_ms(lambda: kernel(U), dev, 10),
                     plain_ms=time_ms(lambda: plain(U), dev, 2),
                     library_ms=time_ms(lambda: torch.matmul(dense, Ut), dev,
                                        5),
                     **bound_of(T * 2 * t * t * item + K * m * 2
                                + K * 2 * m * 4,
                                2 * K * 2 * t * t * (2 * T - nt)))
            two_read = TWO_READ_MS[name][
                2 if storage == torch.bfloat16 else (0 if K == 16 else 1)]
            # the measured time over the design's bytes a call
            r["tb_per_s"] = n_bytes / r["ms"] / 1e9
            print(f"timing {name} {label_k}: kernel {r['ms']:.4f} ms "
                  f"(two-read design {two_read:.4f} ms), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f} ms, matmul over dense bf16 [M; C] "
                  f"{r['library_ms']:.4f} ms; the design moves "
                  f"{n_bytes / 1e9:.3f} GB a call, {ratio:.3f}x the "
                  f"{tile_bytes / 1e9:.3f} GB of stored tiles, at "
                  f"{r['tb_per_s']:.3f} TB/s", flush=True)
            require(ratio <= DESIGN_RATIO[(label, K)], f"{name} {label_k}: "
                    f"the design moves {ratio:.3f}x the stored tiles, past "
                    f"{DESIGN_RATIO[(label, K)]}")
            if storage == torch.int8:
                rows[K] = r
            else:
                rows[16]["bf16"] = r
        del dense, store, plan
        torch.cuda.empty_cache()
    rows[16]["K1"] = rows[1]
    return rows[16], err


def profile_call(label, fn):
    """One call of fn under torch.profiler (after one warm-up call): the
    union of the device's kernel and copy intervals over the wall time of
    the call (profiler overhead included, so the busy share is a lower
    bound), and the device items by time. Only device-side events count:
    a CPU op's own device-time column repeats its kernels' time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
          f"items (one {label} call under the profiler)", flush=True)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<6d} {name[:90]}", flush=True)


def phase_profile(inv, main, cap, dev):
    """The pool path, the stacked pool and the fused batched engine
    (W=512), and the capacity path (m=65,536: row-chunked, the tile list,
    and the sharded engine's "xla" mode at D=1) under the profiler, one
    call each."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.types import Params

    profile_call("pool-path", lambda: run_pipeline(inv, main, dev, W_MAIN))
    profile_call("bf16-pool-path", lambda: run_pipeline_bf16(inv, main, dev,
                                                             W_MAIN))
    profile_call("stacked-pool", lambda: run_stacked(inv, main, dev, W_MAIN))
    profile_call("fused-batched", lambda: run_batched(inv, main, dev,
                                                      W_MAIN))
    pcd0, pcd1, A, _, u0 = cap
    c = Clipper(inv, Params(), engine="auto", dtype=torch.float32, device=dev)
    c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    profile_call("capacity-path", lambda: c.solve(u0=u0))
    c = Clipper(inv, Params(), engine="triangle", dtype=torch.float32,
                device=dev, engine_opts={"matvec": "xla"})
    c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    profile_call("capacity-tile-list", lambda: c.solve(u0=u0))
    with one_rank_group(dev):
        c = Clipper(inv, Params(), engine="sharded", dtype=torch.float32,
                    device=dev, engine_opts=dict(SHARDED_OPTS, matvec="xla"))
        c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
        profile_call("capacity-sharded-xla-D=1", lambda: c.solve(u0=u0))


# ---------------------------------------------------------------------------
# the point-normal configuration and the tri pool's kernel variants
# ---------------------------------------------------------------------------


def make_pn_problems(W: int, seed: int, m: int = M, rho: float = RHO):
    """W point-normal scan problems (BASELINE.json config 3's generator),
    each with its own (n, 6) datasets: (D1s, D2s, As, Agts, u0s) with u0
    from numpy default_rng(seed)."""
    from clipper_tpu_torch.bench import harness
    rng = np.random.default_rng(seed)
    probs = [harness.make_pointnormal_problem(rng, n=PN_N, m=m, rho=rho)
             for _ in range(W)]
    D1s = np.stack([p[0] for p in probs]).astype(np.float32)
    D2s = np.stack([p[1] for p in probs]).astype(np.float32)
    As = np.stack([p[2] for p in probs]).astype(np.int32)
    u0s = np.random.default_rng(seed).random((W, m)).astype(np.float32)
    return D1s, D2s, As, [p[3] for p in probs], u0s


def check_dense(inv, P1, P2, A, label):
    """affinity_build against its plain version on the card: C exact, a
    zero diagonal and no M entry differing (the same IEEE steps and CUDA
    library functions); a rerun bit-identical. Returns the max |kernel -
    plain|."""
    import torch
    from clipper_tpu_torch.ops import affinity_pallas
    from clipper_tpu_torch.ops.affinity import pairwise_from_endpoints
    Mk, Ck = affinity_pallas.affinity_build_cuda(inv, P1, P2, A)
    Mr, Cr = affinity_pallas.affinity_build_cuda(inv, P1, P2, A)
    rerun = bool(torch.equal(Mk, Mr) and torch.equal(Ck, Cr))
    del Mr, Cr
    Mp, Cp = pairwise_from_endpoints(inv, P1, P2, A)
    m = P1.shape[0]
    require(Mk.shape == Ck.shape == (m, m) and Mk.dtype == P1.dtype,
            f"affinity_build {label}: shape {tuple(Mk.shape)} {Mk.dtype}")
    c_exact = bool(torch.equal(Ck, Cp))
    n_diff = int((Mk != Mp).sum())
    err = float((Mk - Mp).abs().max())
    nnz = int((Cp > 0).sum())
    print(f"affinity_build vs plain ({label}): C exact={c_exact}, M entries "
          f"differing={n_diff} of {nnz} edges, max|kernel - plain|="
          f"{err:.3e}; rerun bit-identical={rerun}", flush=True)
    require(rerun, f"affinity_build {label}: a rerun differs")
    require(c_exact, f"affinity_build {label}: C differs from the plain build")
    require(not bool(Mk.diagonal().any()), f"affinity_build {label}: "
            "nonzero diagonal")
    require(n_diff == 0, f"affinity_build {label}: {n_diff} M entries "
            "differ from the plain build")
    return err


def flat_tiles(tri, nt):
    """Flat (P, 2t, S) storage -> tile-major (P, T, 2t, t): tile k sits at
    columns [k t, (k + 1) t) of the flat layout."""
    P, two_t, S = tri.shape
    t = two_t // 2
    T = nt * (nt + 1) // 2
    return tri.view(P, two_t, T, t).permute(0, 2, 1, 3).contiguous()


def check_tiles_matvec(tri, nt, idx, U, label):
    """tri_tiles_matvec on the tile-major form of flat storage ``tri``
    against its plain version (<= 1e-4), an f64 oracle on the same content
    (<= 1.1e-5) and tri_matvec at K=1 on the flat storage (<= 1e-4, and
    bit-equal for int8 and bf16 storage: the two run one kernel over two
    address maps); all three <= 1e-12 for f64 storage; a rerun
    bit-identical. Returns the max |kernel - plain|."""
    import torch
    from clipper_tpu_torch.ops import flattri
    tiles = flat_tiles(tri, nt)
    fdt = torch.float64 if tri.dtype == torch.float64 else torch.float32
    a = flattri.tri_tiles_matvec_cuda(tiles, nt, idx, U, fdt)
    require(all(bool(torch.isfinite(x).all()) for x in a),
            f"tri_tiles_matvec {label}: non-finite output")
    again = flattri.tri_tiles_matvec_cuda(tiles, nt, idx, U, fdt)
    require(all(bool(torch.equal(x, y)) for x, y in zip(a, again)),
            f"tri_tiles_matvec {label}: a rerun is not bit-identical")
    b = flattri.tri_tiles_matvec_plain(tiles, nt, idx, U, fdt)
    c = flattri.tri_pool_matvec_cuda(tri, nt, idx, U[:, None], fdt)
    Uo = (U.bfloat16().double() if tri.dtype in (torch.int8, torch.bfloat16)
          else U.double())
    o = flattri.tri_pool_matvec_plain(tri.double(), nt, idx, Uo[:, None],
                                      torch.float64)
    scale = 127.0 if tri.dtype == torch.int8 else 1.0
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    e_o = max(float((x.double() - y[:, 0] / scale).abs().max())
              for x, y in zip(a, o))
    e_1 = max(float((x - y[:, 0]).abs().max()) for x, y in zip(a, c))
    bits = all(bool(torch.equal(x, y[:, 0])) for x, y in zip(a, c))
    print(f"tri_tiles_matvec ({label}): max|kernel - plain|={err:.3e}, "
          f"max|kernel - f64 oracle|={e_o:.3e}, max|kernel - tri_matvec "
          f"K=1|={e_1:.3e}, bit-equal to tri_matvec K=1: {bits}; rerun "
          "bit-identical", flush=True)
    if tri.dtype in (torch.int8, torch.bfloat16):
        require(bits, f"tri_tiles_matvec {label}: not bit-equal to "
                "tri_matvec at K=1 on the same content")
    f64 = tri.dtype == torch.float64
    tol = F64_MATVEC_TOL if f64 else MATVEC_TOL
    require(err <= tol, f"tri_tiles_matvec {label} disagrees with plain")
    require(e_o <= (F64_MATVEC_TOL if f64 else ORACLE_TOL),
            f"tri_tiles_matvec {label} exceeds its bound against the f64 "
            "oracle")
    require(e_1 <= tol, f"tri_tiles_matvec {label} disagrees with "
            "tri_matvec on the same content")
    return err


def phase_kernels_pn(inv, pn_inv, check, pn_check, dev):
    """Phase 2's checks of this configuration's kernels: the dense build
    (bunny m=1024 and point-normal m=1000, f32 and f64), the point-normal
    tri and stacked builds (W=16, m=1024), the fused build against the
    per-tile build (both invariants), both at m=1000 and t=200 (m_true <
    m on four, int8 and bf16), and the tiles matvec on the check storage
    (int8, f32, f64). Returns the max errors by kernel."""
    import torch
    from clipper_tpu_torch.ops import flattri

    D1, D2s, As, _, _ = check
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    D1p, D2p, Ap, _, _ = pn_check
    Q1s, Q2s = endpoints(D1p, D2p, Ap, dev)
    Apt = torch.as_tensor(Ap, device=dev)
    mts = torch.full((W_CHECK,), M, dtype=torch.int32, device=dev)
    t, nt = 256, M // 256
    errs = {"affinity_build": 0.0, "tri_build": 0, "stored_build": 0.0,
            "tri_build_fused": 0, "tri_tiles_matvec": 0.0}

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        errs["affinity_build"] = max(
            errs["affinity_build"],
            check_dense(inv, P1s[0].to(dtype), P2s[0].to(dtype), At[0],
                        f"bunny, m={M}, {name}"),
            check_dense(pn_inv, Q1s[0, :PN_EDGE].to(dtype),
                        Q2s[0, :PN_EDGE].to(dtype), Apt[0, :PN_EDGE],
                        f"point-normal, m={PN_EDGE}, {name}"))

    tri_pn = flattri.build_tri_cuda(pn_inv, Q1s, Q2s, Apt, mts, t=t)
    tri_pn_p = flattri.build_tri_plain(pn_inv, Q1s, Q2s, Apt, mts, t=t)
    errs["tri_build"] = check_build(tri_pn, tri_pn_p, t,
                                    f"point-normal, W={W_CHECK}, m={M}")
    # kernel 4 on point-normal problems, int8 and bf16, at m=1024 and at
    # their first M_EDGE associations (no tile divides M_EDGE), m_true < m
    # on four
    for me in (M, M_EDGE):
        mts_e = torch.full((W_CHECK,), me, dtype=torch.int32, device=dev)
        mts_e[:4] = torch.tensor([me - 1, me - 24, 700, 513], device=dev)
        for storage in (torch.int8, torch.bfloat16):
            _, e = check_stored(
                pn_inv, Q1s[:, :me], Q2s[:, :me], Apt[:, :me], mts_e,
                storage, f"point-normal {str(storage).split('.')[-1]}, "
                f"W={W_CHECK}, m={me}, m_true < m on 4")
            errs["stored_build"] = max(errs["stored_build"], e)

    for label, (iv, X1, X2, XA, ref) in (
            ("bunny", (inv, P1s, P2s, At, None)),
            ("point-normal", (pn_inv, Q1s, Q2s, Apt, tri_pn))):
        if ref is None:
            ref = flattri.build_tri_cuda(iv, X1, X2, XA, mts, t=t)
        fused = flattri.build_tri_fused_cuda(iv, X1, X2, XA, mts, t=t)
        same = bool(torch.equal(fused, ref))
        print(f"tri_build_fused vs tri_build ({label}, W={W_CHECK}, m={M}): "
              f"byte-equal={same}", flush=True)
        require(same, f"tri_build_fused ({label}) differs from tri_build")

    # kernels 2 and 8 at a t that 64 does not divide (a short sub-tile,
    # int8 rows of no 16-byte multiple): the first M_EDGE associations at
    # t=200, m_true < m on four, int8 and bf16, both invariants
    me, te = M_EDGE, 200
    mts_e = torch.full((W_CHECK,), me, dtype=torch.int32, device=dev)
    mts_e[:4] = torch.tensor([me - 1, me - 24, 700, 513], device=dev)
    for label, (iv, X1, X2, XA) in (
            ("bunny", (inv, P1s, P2s, At)),
            ("point-normal", (pn_inv, Q1s, Q2s, Apt))):
        X1, X2, XA = X1[:, :me], X2[:, :me], XA[:, :me]
        for sd in (torch.int8, torch.bfloat16):
            sname = str(sd).split(".")[-1]
            what = (f"{label} {sname}, W={W_CHECK}, m={me}, t={te}, m_true "
                    "< m on 4")
            k = flattri.build_tri_cuda(iv, X1, X2, XA, mts_e, t=te,
                                       storage_dtype=sd)
            errs["tri_build"] = max(errs["tri_build"], check_build(
                k, flattri.build_tri_plain(iv, X1, X2, XA, mts_e, t=te,
                                           storage_dtype=sd), te, what))
            same = bool(torch.equal(flattri.build_tri_fused_cuda(
                iv, X1, X2, XA, mts_e, t=te, storage_dtype=sd), k))
            print(f"tri_build_fused vs tri_build ({what}): byte-equal="
                  f"{same}", flush=True)
            require(same, f"tri_build_fused ({what}) differs from tri_build")

    tri = flattri.build_tri_cuda(inv, P1s, P2s, At, mts, t=t)
    gen = torch.Generator(device=dev).manual_seed(6)
    idx = torch.randint(0, W_CHECK, (128,), generator=gen, device=dev,
                        dtype=torch.int32)
    errs["tri_tiles_matvec"] = check_tiles_matvec(
        tri, nt, idx, unit_rows(gen, 128, 1, dev)[:, 0],
        f"int8, B=128, m={M}")
    for dtype in (torch.float32, torch.float64):
        tri_f = flattri.build_tri_plain(inv, P1s[:4].to(dtype),
                                        P2s[:4].to(dtype), At[:4], mts[:4],
                                        t=t, storage_dtype=None)
        idx = torch.randint(0, 4, (32,), generator=gen, device=dev,
                            dtype=torch.int32)
        errs["tri_tiles_matvec"] = max(
            errs["tri_tiles_matvec"],
            check_tiles_matvec(tri_f, nt, idx,
                               unit_rows(gen, 32, 1, dev)[:, 0].to(dtype),
                               f"{str(dtype).split('.')[-1]} storage, B=32"))
    return errs


def phase_kernels_bf16(inv, pn_inv, check, pn_check, dev):
    """Phase 2's bf16 storage checks (the JAX package's default storage):
    the tri build and the fused build (both invariants, W=16, m=1024:
    C exact, no M value differing, the two byte-equal), the tri matvec on
    that storage (B=128, K=16 and B=16, K=1) and kernel 1 at nt=9 (one
    m=2304 problem, t=256, int8 and bf16; the builds held to their plain
    versions too), each against its plain version, an f64 oracle and a
    rerun; the tiles matvec on its tile-major form; the rows and the
    tile-list matvecs on one m=1024 problem's bf16 storage (t=128, K=16
    and K=1, the D=3 slices). Returns the max errors by kernel."""
    import torch
    from clipper_tpu_torch.ops import flattri, symstore

    bf = torch.bfloat16
    D1, D2s, As, _, _ = check
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    D1p, D2p, Ap, _, _ = pn_check
    Q1s, Q2s = endpoints(D1p, D2p, Ap, dev)
    Apt = torch.as_tensor(Ap, device=dev)
    mts = torch.full((W_CHECK,), M, dtype=torch.int32, device=dev)
    t, nt = 256, M // 256
    errs = {"tri_build": 0.0, "tri_build_fused": 0.0}
    for label, (iv, X1, X2, XA) in (("bunny", (inv, P1s, P2s, At)),
                                    ("point-normal", (pn_inv, Q1s, Q2s,
                                                      Apt))):
        k = flattri.build_tri_cuda(iv, X1, X2, XA, mts, t=t,
                                   storage_dtype=bf)
        errs["tri_build"] = max(errs["tri_build"], check_build(
            k, flattri.build_tri_plain(iv, X1, X2, XA, mts, t=t,
                                       storage_dtype=bf),
            t, f"bf16 {label}, W={W_CHECK}, m={M}"))
        same = bool(torch.equal(flattri.build_tri_fused_cuda(
            iv, X1, X2, XA, mts, t=t, storage_dtype=bf), k))
        print(f"tri_build_fused vs tri_build (bf16 {label}, W={W_CHECK}, "
              f"m={M}): byte-equal={same}", flush=True)
        require(same, f"tri_build_fused (bf16 {label}) differs from "
                "tri_build")
        if label == "bunny":
            tri = k

    gen = torch.Generator(device=dev).manual_seed(7)
    errs["tri_matvec"] = 0.0
    for B, K in ((128, 16), (W_CHECK, 1)):
        idx = torch.randint(0, W_CHECK, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        errs["tri_matvec"] = max(errs["tri_matvec"], check_matvec(
            tri, nt, idx, unit_rows(gen, B, K, dev), f"bf16, B={B}, K={K}",
            oracle=True))
    idx = torch.randint(0, W_CHECK, (128,), generator=gen, device=dev,
                        dtype=torch.int32)
    errs["tri_tiles_matvec"] = check_tiles_matvec(
        tri, nt, idx, unit_rows(gen, 128, 1, dev)[:, 0],
        f"bf16, B=128, m={M}")

    # kernel 1 at nt = 9: one m=2304 problem, 8 lanes on it
    m9 = 9 * t
    P1, P2, A9 = capacity_endpoints(one_problem(m9, RHO, seed=4), dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    m9s = torch.tensor([m9], dtype=torch.int32, device=dev)
    for storage in (torch.int8, bf):
        name = str(storage).split(".")[-1]
        k = flattri.build_tri_cuda(inv, P1[None], P2[None], A9[None], m9s,
                                   t=t, storage_dtype=storage)
        errs["tri_build"] = max(errs["tri_build"], check_build(
            k, flattri.build_tri_plain(inv, P1[None], P2[None], A9[None],
                                       m9s, t=t, storage_dtype=storage),
            t, f"{name}, m={m9}, nt=9"))
        for K in (16, 1):
            errs["tri_matvec"] = max(errs["tri_matvec"], check_matvec(
                k, 9, idx, unit_rows(gen, 8, K, dev, m9),
                f"{name}, m={m9}, nt=9, B=8, K={K}", oracle=True))

    # kernels 3 and 7 on bf16 storage at t=128
    prob = one_problem(M, RHO, seed=1)
    ntr = M // ROWS_T
    chunks = rows_storage(inv, prob, dev, G=8, storage=bf)
    errs["sym_rows_matvec"] = max(
        [check_rows(chunks, ntr, unit_rows(gen, 1, K, dev)[0],
                    f"bf16, m={M}, G=8, K={K}") for K in (16, 1)]
        + [check_rows_slices(chunks, ntr, unit_rows(gen, 1, 16, dev)[0],
                             f"bf16, m={M}, G=8, K=16")])
    tl = tiles_storage(inv, prob, dev, bf)
    errs["sym_tiles_matvec"] = 0.0
    for K in (16, 1):
        U = unit_rows(gen, 1, K, dev)[0]
        label = f"bf16, m={M}, K={K}"
        errs["sym_tiles_matvec"] = max(errs["sym_tiles_matvec"],
                                       check_tiles(tl, ntr, U, label))
        y = symstore.sym_tiles_matvec_cuda(tl, ntr, U)
        e_o = float((y.double() - tiles_oracle(tl, ntr, U)).abs().max())
        print(f"sym_tiles_matvec {label}: max|kernel - f64 oracle|="
              f"{e_o:.3e}", flush=True)
        require(e_o <= ORACLE_TOL, f"sym_tiles_matvec {label} exceeds "
                f"{ORACLE_TOL} against the f64 oracle")
    return errs


def phase_pointnormal(pn_inv, pn_main, dev):
    """3e: the point-normal configuration. (a) one m=5000 problem through
    the Clipper facade's dense engine in f32 (the dense build kernel);
    (b) W=512 problems at m=1024 through the tri pool with bench.py's
    settings and per-problem datasets; (c) the same through the stacked
    pool. Returns the launches of (a), (b) and (c)."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import data, harness
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops.affinity import build_affinity
    from clipper_tpu_torch.types import Params

    t0 = time.perf_counter()
    D1, D2, A, Agt = harness.make_pointnormal_problem(
        np.random.default_rng(0), n=PN_N, m=PN_M, rho=PN_RHO)
    D1, D2 = D1.astype(np.float32), D2.astype(np.float32)
    u0 = np.random.default_rng(0).random(PN_M).astype(np.float32)
    print(f"point-normal facade data: m={PN_M} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    c = Clipper(pn_inv, Params(), dtype=torch.float32, device=dev)

    def call():
        c.score_pairwise_consistency(D1.T, D2.T, A)
        return c.solve(u0=u0)

    sol, launches = counted_call(call)
    require(c._resolve_engine(PN_M) == "dense" and c._M is not None,
            "the point-normal facade did not take the dense engine")
    require(launches["affinity_build"] == 1, "point-normal facade: "
            f"affinity_build launched {launches['affinity_build']} times "
            "in one score_pairwise_consistency, not once")
    build_ms = time_ms(
        lambda: c.score_pairwise_consistency(D1.T, D2.T, A), dev, 3)
    t0 = time.perf_counter()
    sol = c.solve(u0=u0)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    D1t = torch.as_tensor(D1, device=dev)
    D2t = torch.as_tensor(D2, device=dev)
    At = torch.as_tensor(A, device=dev)
    plain_ms = time_ms(lambda: build_affinity(pn_inv, D1t, D2t, At), dev, 2)
    mask = sol.mask.cpu().numpy()
    require(mask.shape == (PN_M,) and bool(torch.isfinite(sol.u).all())
            and np.isfinite(float(sol.score)), "point-normal facade: bad "
            "shape or non-finite u/F")
    require(float(sol.score) <= PN_M, "point-normal facade: objective F > m")
    P, R = data.get_precision_recall(c.get_selected_associations(), Agt)
    print(f"point-normal facade: m={PN_M} rho={PN_RHO} f32 dense engine: "
          f"precision={P * 100:.2f}% recall={R * 100:.2f}% |mask|="
          f"{int(mask.sum())} (|Agt|={len(Agt)}); ifinal={int(sol.ifinal)}; "
          f"build {build_ms:.3f} ms (score_pairwise_consistency, CUDA "
          f"events, mean of 3), solve {solve_ms:.3f} ms (host clock, "
          f"synchronised); the plain build on the card {plain_ms:.3f} ms",
          flush=True)
    print(f"point-normal facade kernel launches (one build and solve): "
          f"{launches}", flush=True)
    require(P >= 0.99, f"point-normal facade precision {P:.4f} < 0.99")
    require(R >= 0.85, f"point-normal facade recall {R:.4f} < 0.85")
    out = {"facade": launches}

    _, _, As, Agts, _ = pn_main
    for layout, run, kernels in (
            ("tri", run_pipeline, ("tri_build", "tri_matvec")),
            ("stacked", run_stacked, ("stored_build",))):
        sol, launches = counted_call(lambda: run(pn_inv, pn_main, dev,
                                                 W_MAIN))
        timings = {}
        reps = 2
        sol, wall = timed_calls(lambda: run(pn_inv, pn_main, dev, W_MAIN,
                                            timings=timings), reps)
        label = f"point-normal {layout} pool"
        P, R = check_quality(label, As, sol, Agts, W_MAIN)
        print(f"{label}: W={W_MAIN} m={M} rho={RHO}: precision={P * 100:.2f}%"
              f" recall={R * 100:.2f}%  {W_MAIN / wall:.1f} problems/s "
              f"({wall * 1e3:.1f} ms/batch, mean of {reps} after 1 warm-up); "
              "stage ms (last call, CUDA events): "
              + ", ".join(f"{k}={v:.3f}" for k, v in timings.items()),
              flush=True)
        print(f"{label} kernel launches (one call): {launches}", flush=True)
        for k in kernels:
            require(launches[k] > 0, f"{label}: {k} was never launched")
        if layout == "stacked":
            require(launches["stored_build"] == 1, f"{label}: stored_build "
                    f"launched {launches['stored_build']} times, not once")
        out[layout] = launches
    return out


def run_tri_variant(inv, data_, dev, W, variant, timings=None, stats=None):
    """The bunny pool problems over the flat storage's two builds and two
    layouts, one probe a tick: variant "tiles" builds with
    build_tri_pallas_fused and solves over its tile-major form through
    solve_pool_tri(matvec="tiles"); "pallas" builds with build_tri and
    solves the flat storage through matvec="pallas". Inits through the
    same matvec, the pool's polish and rounding; ``stats`` gets the pool's
    windows and ticks. Returns a Solution."""
    import torch
    from clipper_tpu_torch.ops import flattri
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.solvers import msrc, msrc_flat
    from clipper_tpu_torch.types import Params, Solution
    D1, D2s, As, _, u0s = data_
    t, nt = 256, M // 256
    clock = pool.StageClock(torch.device(dev), timings)
    clock.mark("start")
    P1s, P2s = endpoints(first(D1, W), D2s[:W], As[:W], dev)
    At = torch.as_tensor(As[:W], device=dev)
    mts = torch.full((W,), M, dtype=torch.int32, device=dev)
    if variant == "tiles":
        store = flat_tiles(flattri.build_tri_pallas_fused(
            inv, P1s, P2s, At, mts, t=t), nt)
        bmv = flattri.make_tri_pool_matvec_tiles(store, nt, torch.float32)
    else:
        store = flattri.build_tri(inv, P1s, P2s, At, mts, t=t)
        bmv = flattri.make_tri_pool_matvec(store, nt, torch.float32)
    clock.mark("build")
    u = msrc_flat.power_init_batched(bmv, None, torch.as_tensor(
        u0s[:W], device=dev), 4)
    inits = msrc_flat.flat_init_batched(bmv, None, u, Params())
    clock.mark("init")
    u, F, ifinal = pool.solve_pool_tri(store, nt, inits, Params(), lanes=128,
                                       window=STACKED["window"],
                                       matvec=variant, d_scale=0.15,
                                       stats=stats)
    clock.mark("solve")
    Fp = pool._polish_batch(inv, P1s, P2s, At, u, 256, 1e-4)
    mask = msrc.round_solution(u, Fp, Params().rounding)
    clock.mark("polish")
    clock.finish()
    return Solution(ifinal=ifinal, mask=mask, u0=None, u=u, score=Fp)


def phase_tri_variants(inv, main, dev):
    """3f: the tri pool's kernel variants on the 512 bunny problems: the
    fused build's bytes against build_tri's, then the tile-major pool
    (matvec="tiles") beside the flat one (matvec="pallas"), one probe a
    tick each, printing whether their masks, ifinal and windows are equal
    (kernel 9 runs kernel 1's instructions at K=1, so they should be).
    Returns the tile-major call's launches."""
    import torch
    from clipper_tpu_torch.ops import flattri

    D1, D2s, As, Agts, _ = main
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    mts = torch.full((W_MAIN,), M, dtype=torch.int32, device=dev)
    same = bool(torch.equal(
        flattri.build_tri_pallas_fused(inv, P1s, P2s, At, mts, t=256),
        flattri.build_tri(inv, P1s, P2s, At, mts, t=256)))
    print(f"tri_build_fused vs tri_build (W={W_MAIN}, m={M}): byte-equal="
          f"{same}", flush=True)
    require(same, "tri_build_fused differs from tri_build at W=512")
    out, sols, stats = {}, {}, {}
    for variant in ("tiles", "pallas"):
        stats[variant] = {}
        sols[variant], launches = counted_call(lambda: run_tri_variant(
            inv, main, dev, W_MAIN, variant, stats=stats[variant]))
        timings = {}
        reps = 2
        sol, wall = timed_calls(lambda: run_tri_variant(
            inv, main, dev, W_MAIN, variant, timings=timings), reps)
        label = f"tri pool, matvec={variant!r}, one probe a tick"
        P, R = check_quality(label, As, sol, Agts, W_MAIN)
        print(f"{label}: W={W_MAIN} m={M}: precision={P * 100:.2f}% recall="
              f"{R * 100:.2f}%  {wall * 1e3:.1f} ms a call ({W_MAIN / wall:.1f}"
              f" problems/s, mean of {reps} after 1 warm-up); stage ms (last "
              "call, CUDA events): " + ", ".join(
                  f"{k}={v:.3f}" for k, v in timings.items()), flush=True)
        print(f"{label} kernel launches (one call): {launches}", flush=True)
        out[variant] = launches
    a, b = sols["tiles"], sols["pallas"]
    same = (a.mask == b.mask).all(dim=1)
    ta, tb = stats["tiles"], stats["pallas"]
    print(f"tile-major vs flat pool (one probe a tick, W={W_MAIN}): masks "
          f"equal on {int(same.sum())} of {W_MAIN}, ifinal equal "
          f"{bool(torch.equal(a.ifinal, b.ifinal))}, windows {ta['windows']}"
          f" vs {tb['windows']}, ticks equal "
          f"{bool(torch.equal(ta['ticks'], tb['ticks']))}", flush=True)
    need = {"tiles": ("tri_build_fused", "tri_tiles_matvec"),
            "pallas": ("tri_build", "tri_matvec")}
    for variant, names in need.items():
        for k in names:
            require(out[variant][k] > 0, f"tri pool ({variant}): {k} was "
                    "never launched")
    return out["tiles"]


def phase_parity_pn(inv, pn_inv, check, pn_check, dev):
    """Phase 5's comparisons of this configuration: the point-normal tri
    pool and the tile-major pool at W=16, cuda against cpu, and the
    point-normal dense facade in f64 at m=1024 (masks equal)."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench import data, harness
    from clipper_tpu_torch.types import Params

    _, _, As, Agts, _ = pn_check
    compare_devices("point-normal tri pool",
                    run_pipeline(pn_inv, pn_check, dev, W_CHECK),
                    run_pipeline(pn_inv, pn_check, "cpu", W_CHECK), As, Agts,
                    W_CHECK, W_CHECK - 1)
    _, _, As, Agts, _ = check
    compare_devices("tile-major tri pool",
                    run_tri_variant(inv, check, dev, W_CHECK, "tiles"),
                    run_tri_variant(inv, check, "cpu", W_CHECK, "tiles"), As,
                    Agts, W_CHECK, W_CHECK - 1)

    D1, D2, A, Agt = harness.make_pointnormal_problem(
        np.random.default_rng(3), n=PN_N, m=DENSE_M, rho=RHO)
    u0 = np.random.default_rng(3).random(DENSE_M)
    runs = []
    for d in (dev, "cpu"):
        c = Clipper(pn_inv, Params(), engine="dense", dtype=torch.float64,
                    device=d)
        _kernels.reset_launches()
        c.score_pairwise_consistency(D1.T, D2.T, A)
        n_build = _kernels.LAUNCHES["affinity_build"]
        sol = c.solve(u0=u0)
        runs.append((sol.mask.cpu().numpy(), int(sol.ifinal), n_build,
                     data.get_precision_recall(
                         c.get_selected_associations(), Agt)))
    (mg, ig, ng, prg), (mc, ic, _, prc) = runs
    print(f"facade dense engine point-normal f64 m={DENSE_M}: masks equal to "
          f"cpu: {bool((mg == mc).all())} ({int((mg != mc).sum())} differ); "
          f"ifinal cuda {ig} cpu {ic}; P/R cuda {prg[0] * 100:.2f}/"
          f"{prg[1] * 100:.2f}% cpu {prc[0] * 100:.2f}/{prc[1] * 100:.2f}%; "
          f"affinity_build launches on cuda {ng}", flush=True)
    require(ng == 1, "the point-normal dense facade did not build through "
            "affinity_build on the card")
    require(bool((mg == mc).all()), "facade dense point-normal: cuda and cpu "
            "masks differ")


def time_pn_and_dense(inv, pn_inv, check, pn_main, dev, rows_in):
    """Phase 6's point-normal and dense rows: the dense build at m=5000
    (point-normal) and m=1024 (bunny), f32 and f64 (held to its plain
    version at m=5000 in both first, the m=5000 problem's survivor shares
    printed); the point-normal tri build and
    the fused tri build (kernels 2 and 8, int8 and bf16, kernel 8
    byte-equal to kernel 2, beside the problems' survivor shares) and the
    stacked build (int8 and bf16) at W=512, into the "pointnormal" and
    "pointnormal_bf16" fields of the rows_in rows of tri_build,
    tri_build_fused and stored_build, each first held to its plain
    version (C exact, no M code differing). Returns the dense build's row
    of the kernels' JSON line and its max error."""
    import torch
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.invariants import kernel_score
    from clipper_tpu_torch.ops import affinity_pallas, flattri
    from clipper_tpu_torch.ops.affinity import (gather_endpoints,
                                                pairwise_from_endpoints,
                                                stored_from_endpoints)

    D1, D2, A, _ = harness.make_pointnormal_problem(
        np.random.default_rng(0), n=PN_N, m=PN_M, rho=PN_RHO)
    At = torch.as_tensor(A, device=dev)
    B1, B2, BA, _, _ = check
    Q1, Q2 = endpoints(B1, B2[:1], BA[:1], dev)
    QA = torch.as_tensor(BA[0], device=dev)
    shares = None
    rows, err = {}, 0.0
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        P1, P2 = gather_endpoints(torch.as_tensor(D1, dtype=dtype,
                                                  device=dev),
                                  torch.as_tensor(D2, dtype=dtype,
                                                  device=dev), At)
        if shares is None:
            shares = harness.gate_shares(pn_inv, P1[None], P2[None],
                                         At[None], [PN_M])
            print(f"point-normal m={PN_M} (the facade's problem): "
                  f"{shares_text(shares)}", flush=True)
        err = max(err, check_dense(pn_inv, P1, P2, At,
                                   f"point-normal, m={PN_M}, {name}"))
        for label, (iv, X1, X2, XA) in (
                (f"point-normal m={PN_M}", (pn_inv, P1, P2, At)),
                (f"bunny m={M}", (inv, Q1[0].to(dtype), Q2[0].to(dtype),
                                  QA))):
            m, d = X1.shape
            size = dtype.itemsize
            # M and C written once, the endpoints and ids read once; the
            # operations over the distinct pairs at the type's peak
            bound = bound_of(
                2 * m * m * size + 2 * m * d * size + m * 2 * 4,
                (m * (m - 1) // 2) * (PN_OPS_PER_PAIR if d == 6
                                      else BUILD_OPS_PER_PAIR),
                F32_FLOPS if dtype == torch.float32 else F64_FLOPS)
            # the kernel through its wrapper, as the facade and the grid
            # trials call it; beside it through its C entry on inputs made
            # once, as bench/parent_ab times it (at m=1024 the wrapper's
            # host time, not the kernel, can set the wrapper's reading)
            kind, _, params = kernel_score(iv)
            X1c, X2c = X1.contiguous(), X2.contiguous()
            XA32 = XA.to(torch.int32).contiguous()
            Mo, Co = (torch.empty(m, m, dtype=dtype, device=dev)
                      for _ in range(2))
            entry = getattr(_kernels.lib("affinity_build"),
                            f"affinity_build_{'f32' if size == 4 else 'f64'}")
            stream = torch.cuda.current_stream(dev).cuda_stream
            r = dict(ms=time_ms(
                         lambda: affinity_pallas.affinity_build_cuda(
                             iv, X1, X2, XA), dev, 10),
                     entry_ms=time_ms(lambda: entry(
                         X1c.data_ptr(), X2c.data_ptr(), XA32.data_ptr(),
                         Mo.data_ptr(), Co.data_ptr(), m, kind, *params,
                         1e-4, stream), dev, 20),
                     plain_ms=time_ms(lambda: pairwise_from_endpoints(
                         iv, X1, X2, XA), dev, 2),
                     library_ms=None, **bound)
            del Mo, Co
            rows[f"{label} {name}"] = r
            print(f"timing affinity_build {label} {name}: kernel "
                  f"{r['ms']:.4f} ms (the C entry {r['entry_ms']:.4f} ms),"
                  f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f} ms, library None", flush=True)
        del P1, P2
        torch.cuda.empty_cache()
    # the row: point-normal m=5000 in f32, the other shapes beside it
    row = dict(rows.pop(f"point-normal m={PN_M} float32"), shapes=rows,
               gate_shares=shares)

    D1s, D2s, As, _, _ = pn_main
    P1s, P2s = endpoints(D1s, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    mts = torch.full((W_MAIN,), M, dtype=torch.int32, device=dev)
    t, nt = 256, M // 256
    S = flattri.tri_ncols(nt, t)
    label = f"point-normal, W={W_MAIN}, m={M}"
    shares = harness.gate_shares(pn_inv, P1s, P2s, At, mts)
    print(f"point-normal W={W_MAIN} m={M}: {shares_text(shares)}",
          flush=True)
    for sd in (torch.int8, torch.bfloat16):
        sname = str(sd).split(".")[-1]
        k2 = flattri.build_tri_cuda(pn_inv, P1s, P2s, At, mts, t=t,
                                    storage_dtype=sd)
        check_build(k2, flattri.build_tri_plain(pn_inv, P1s, P2s, At, mts,
                                                t=t, storage_dtype=sd), t,
                    f"{label}, {sname}")
        same = bool(torch.equal(flattri.build_tri_fused_cuda(
            pn_inv, P1s, P2s, At, mts, t=t, storage_dtype=sd), k2))
        print(f"tri_build_fused vs tri_build ({label}, {sname}): "
              f"byte-equal={same}", flush=True)
        require(same, f"tri_build_fused ({label}, {sname}) differs from "
                "tri_build")
        del k2
        torch.cuda.empty_cache()
    for storage in (torch.int8, torch.bfloat16):
        check_stored(pn_inv, P1s, P2s, At, mts, storage,
                     f"{label}, {str(storage).split('.')[-1]}")
        torch.cuda.empty_cache()
    in_bytes = 2 * W_MAIN * M * 6 * 4 + W_MAIN * M * 2 * 4 + W_MAIN * 4
    cases = []
    for sd in (torch.int8, torch.bfloat16):
        for name, fn in (("tri_build", flattri.build_tri_cuda),
                         ("tri_build_fused", flattri.build_tri_fused_cuda)):
            cases.append((
                name, sd, W_MAIN * 2 * t * S * sd.itemsize,
                lambda fn=fn, sd=sd: fn(pn_inv, P1s, P2s, At, mts, t=t,
                                        storage_dtype=sd),
                lambda sd=sd: flattri.build_tri_plain(
                    pn_inv, P1s, P2s, At, mts, t=t, storage_dtype=sd)))
    for sd in (torch.int8, torch.bfloat16):
        cases.append((
            "stored_build", sd, W_MAIN * 2 * M * M * sd.itemsize,
            lambda sd=sd: affinity_pallas.stored_build_cuda(
                pn_inv, P1s, P2s, At, mts, storage_dtype=sd),
            lambda sd=sd: stored_from_endpoints(
                pn_inv, P1s, P2s, At, m_true=mts, storage_dtype=sd)))
    for name, storage, out_bytes, kernel, plain in cases:
        bound, by = build_bound(out_bytes + in_bytes, W_MAIN, M,
                                PN_OPS_PER_PAIR)
        ms = time_ms(kernel, dev, 10)
        pms = time_ms(plain, dev, 1)
        torch.cuda.empty_cache()
        sname = str(storage).split(".")[-1]
        key = "pointnormal" + ("_bf16" if storage.is_floating_point else "")
        rows_in[name][key] = dict(ms=ms, plain_ms=pms, bound_ms=bound,
                                  bound_by=by, library_ms=None)
        note = ""
        if name != "stored_build":
            rows_in[name][key]["gate_shares"] = shares
            note = f"; {shares_text(shares)}"
        print(f"timing {name} point-normal W={W_MAIN} m={M} {sname}: kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), plain {pms:.4f} ms"
              f"{note}", flush=True)
    return row, err


# ---------------------------------------------------------------------------
# the bench layer: the build-anatomy probe and the drivers
# ---------------------------------------------------------------------------

PROBE_B, PROBE_M = 512, 1024        # the JAX probe's defaults
PROBE_EDGE_B, PROBE_EDGE_M = 16, 1000   # an edge tile: no block divides m
PROBE_CHUNK = 64                    # problems a plain-version check takes


def check_probe(B: int, m: int, dev):
    """Phase 7's bars at (B, m) on the probe's inputs: full byte-equal to
    stored_build (m_true = m), writeonly all zeros, and sqrt1, noexp,
    nosqrt and full against build_probe_plain (C half exact, M codes
    within one; the count of differing codes printed, 0 expected: the
    kernel and the plain version take the same IEEE f32 steps). Returns
    the max |code diff|."""
    import torch
    from clipper_tpu_torch.bench import build_probe as bp
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.ops import affinity_pallas

    P1, P2, A = (torch.from_numpy(x).to(dev) for x in bp.make_inputs(B, m))
    mts = torch.full((B,), m, dtype=torch.int32, device=dev)
    ref = affinity_pallas.stored_build_cuda(harness.default_invariant(),
                                            P1, P2, A, mts)
    full = bp.build_probe_cuda("full", P1, P2, A)
    nd = int((full != ref).sum())
    print(f"probe B={B} m={m}: full vs stored_build: {nd} of "
          f"{full.numel()} bytes differ", flush=True)
    require(nd == 0, f"probe full differs from stored_build at B={B}, m={m}")
    del ref, full
    require(not bool(bp.build_probe_cuda("writeonly", P1, P2, A).any()),
            f"probe writeonly wrote non-zeros at B={B}, m={m}")
    worst = 0
    for v in ("full", "sqrt1", "noexp", "nosqrt"):
        out = bp.build_probe_cuda(v, P1, P2, A)
        c_equal, ndiff, maxd = True, 0, 0
        for s in range(0, B, PROBE_CHUNK):
            e = min(B, s + PROBE_CHUNK)
            plain = bp.build_probe_plain(v, P1[s:e], P2[s:e], A[s:e])
            c_equal &= bool(torch.equal(out[s:e, m:], plain[:, m:]))
            d = (out[s:e, :m].int() - plain[:, :m].int()).abs()
            ndiff += int((d > 0).sum())
            maxd = max(maxd, int(d.max()))
            del plain, d
        kept = int((out[:, m:] != 0).sum())
        print(f"probe {v} B={B} m={m}: C half exact {c_equal} ({kept} kept),"
              f" {ndiff} M codes differ from the plain version (max "
              f"{maxd})", flush=True)
        require(c_equal and maxd <= 1, f"probe {v} disagrees with its plain "
                f"version at B={B}, m={m}")
        worst = max(worst, maxd)
        del out
    torch.cuda.empty_cache()
    return worst


def phase_probe(dev):
    """7: the probe's bars at the JAX probe's shapes and at an edge tile,
    then build_probe.main(["512", "1024"]) with the launch counts set to 0
    just before it and read just after. Returns the build_probe row of
    the kernels' line, its launches and its max error."""
    import torch
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench import build_probe as bp
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import affinity_pallas

    err = max(check_probe(PROBE_B, PROBE_M, dev),
              check_probe(PROBE_EDGE_B, PROBE_EDGE_M, dev))
    _kernels.reset_launches()
    variants = bp.main([str(PROBE_B), str(PROBE_M), "--device=cuda"])
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print(f"probe driver launches: {launches}", flush=True)
    require(launches["build_probe"] > 0 and launches["stored_build"] > 0,
            f"the probe driver launched no probe kernel: {launches}")
    require(set(variants) == set(bp.VARIANTS) and all(
        np.isfinite(v) and v > 0 for v in variants.values()),
        f"probe times {variants}")

    P1, P2, A = (torch.from_numpy(x).to(dev)
                 for x in bp.make_inputs(PROBE_B, PROBE_M))
    in_bytes = 2 * PROBE_B * PROBE_M * 3 * 4 + PROBE_B * PROBE_M * 2 * 4
    bound_ms, bound_by = build_bound(
        2 * PROBE_B * PROBE_M * PROBE_M + in_bytes, PROBE_B, PROBE_M,
        BUILD_OPS_PER_PAIR)
    plain_ms = time_ms(lambda: bp.build_probe_plain("full", P1, P2, A), dev, 2)
    # kernel 4, whose kernel full runs, on the same inputs
    mts = torch.full((PROBE_B,), PROBE_M, dtype=torch.int32, device=dev)
    k4_ms = time_ms(lambda: affinity_pallas.stored_build_cuda(
        harness.default_invariant(), P1, P2, A, mts), dev, 10)
    del P1, P2, A
    torch.cuda.empty_cache()
    row = dict(ms=variants["full"], plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None,
               variants_ms={v: float(variants[v]) for v in bp.VARIANTS},
               kernel4_ms=k4_ms)
    print(f"timing build_probe B={PROBE_B} m={PROBE_M}: full {row['ms']:.4f}"
          f" ms ({row['ms'] / k4_ms:.3f}x kernel 4's {k4_ms:.4f} ms), bound "
          f"{bound_ms:.4f} ms ({bound_by}; write bound "
          f"{bp.write_bound_ms(PROBE_B, PROBE_M):.4f} ms), plain "
          f"{plain_ms:.4f} ms, variants {row['variants_ms']}", flush=True)
    return row, launches["build_probe"], err


BENCH_P, BENCH_R = 0.995, 0.88    # the bench protocol's bars
DENSE_R = 0.85                     # the dense engine's recall bar at m=1024


def driver_call(label, run, need=()):
    """One driver call with the launch counts set to 0 just before it and
    read just after; requires each kernel of ``need`` launched. Returns
    (result, launches)."""
    import torch
    from clipper_tpu_torch import _kernels
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    print(f"driver {label}: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches}", flush=True)
    missing = [k for k in need if not launches.get(k)]
    require(not missing, f"driver {label}: kernels never launched: "
            f"{missing}")
    return out, launches


def check_bench_rows(label, rows, p_bar=BENCH_P, r_bar=BENCH_R):
    """Finite P/R on every row; the rows at the bench protocol's point
    (m=1024, rho=0.9) at the bars."""
    for row in rows:
        P, R = row["precision"], row["recall"]
        require(np.isfinite(P) and np.isfinite(R),
                f"{label}: non-finite P/R in {row}")
        if row.get("m", M) == M and row.get("rho", RHO) == RHO:
            require(P >= p_bar and R >= r_bar, f"{label}: P={P:.4f} "
                    f"R={R:.4f} at m={M}, rho={RHO} (bars {p_bar}, "
                    f"{r_bar})")


def phase_drivers(dev):
    """8: each ported driver's main() in-process on the card at a small
    setting, and the harness's trials through the dense build kernel."""
    from clipper_tpu_torch.bench import (blocksparse_bench, grid_tpu,
                                         gridcell_probe, harness,
                                         mixed_bench, multistart_bench,
                                         pool_ab, sdp_bench, symshard_bench,
                                         symstore_bench, tickstats)
    cuda = f"--device={dev.type}"
    rows, _ = driver_call("grid_tpu (4 trials a cell)",
                          lambda: grid_tpu.main(["4", cuda]),
                          ("tri_build", "tri_matvec", "stored_build"))
    require(len(rows) == 25, f"grid_tpu: {len(rows)} rows, not 25")
    check_bench_rows("grid_tpu", rows)
    rows, _ = driver_call("pool_ab W=128", lambda: pool_ab.main(["128",
                                                                   cuda]),
                          ("tri_build", "tri_matvec", "stored_build"))
    check_bench_rows("pool_ab", rows)
    out, _ = driver_call("tickstats B=128", lambda: tickstats.main(
        ["128", cuda]))
    require(int(out["ticks"].min()) > 0, "tickstats: a lane took no tick")
    rows, _ = driver_call("gridcell_probe W=8 m=2048",
                          lambda: gridcell_probe.main(["8", "2048", cuda]),
                          ("stored_build",))
    check_bench_rows("gridcell_probe", rows)
    out, _ = driver_call("mixed_bench 8 a size", lambda: mixed_bench.main(
        ["8", "1", cuda]), ("stored_build",))
    check_bench_rows("mixed_bench", [dict(out, m=None)])
    out, _ = driver_call("multistart_bench W=32 K=4",
                         lambda: multistart_bench.main(["32", "4", "1",
                                                        cuda]),
                         ("stored_build",))
    check_bench_rows("multistart_bench", [out["single"], out["multi"]])
    driver_call("symstore_bench m=8192 --mv-only",
                lambda: symstore_bench.main(["8192", "--mv-only", cuda]),
                ("sym_tiles_matvec", "sym_rows_matvec", "stored_build"))
    with one_rank_group(dev):
        out, _ = driver_call("symshard_bench m=8192 (1-rank NCCL group)",
                             lambda: symshard_bench.main(["8192", cuda]),
                             ("sym_rows_matvec",))
    require(out["ranks"] == 1, "symshard_bench did not take the group")
    check_bench_rows("symshard_bench", [dict(out, m=None)])
    out, _ = driver_call("blocksparse_bench m=2048 k=4",
                         lambda: blocksparse_bench.main(["2048", "4", "2",
                                                         cuda]))
    quality = [out[k] for k in ("P_dense", "P_block", "R_dense", "R_block")]
    require(out["occupancy"] <= 0.5 and bool(np.isfinite(quality).all()),
            f"blocksparse_bench: {out}")
    rows, _ = driver_call("sdp_bench m=256 B=2",
                          lambda: sdp_bench.main(["--sizes=256", "--batch=2",
                                                  cuda]), ("affinity_build",))
    require([r["solver"] for r in rows] == ["sdp", "pga", "sdp_batched"]
            and all(np.isfinite(r["ms"]) for r in rows),
            f"sdp_bench: rows {rows}")
    check_bench_rows("sdp_bench", [dict(r, m=None) for r in rows])
    # the harness's trials: the dense engine, its build on kernel 6
    rows, _ = driver_call(f"harness.run_grid m={M} rho={RHO} (4 trials)",
                          lambda: harness.run_grid((M,), (RHO,), n_trials=4,
                                                   device=dev),
                          ("affinity_build",))
    check_bench_rows("run_grid", rows, r_bar=DENSE_R)
    trial, _ = driver_call(
        f"harness.run_pointnormal_trial m={PN_M}",
        lambda: harness.run_pointnormal_trial(np.random.default_rng(0),
                                              device=dev),
        ("affinity_build",))
    print(f"point-normal trial: build {trial.t_affinity * 1e3:.3f} ms, solve "
          f"{trial.t_solver * 1e3:.3f} ms, P={trial.p:.4f} R={trial.r:.4f}",
          flush=True)
    check_bench_rows("run_pointnormal_trial", [dict(precision=trial.p,
                                              recall=trial.r, m=None)])


# ---------------------------------------------------------------------------
# the facade's remaining surface: exact DSD, the maximum clique, the
# capacity engine's DSD, the block-sparse path, clique extraction and the
# tri pool's stall_outers
# ---------------------------------------------------------------------------

SURF_CAP_M, SURF_CAP_RHO = 8192, 0.95     # (c) the capacity engine's DSD
MC_M, MC_RHO = 2048, 0.9                  # (b) the bunny's max clique
SCENE_M, SCENE_K, SCENE_RHO = 8192, 8, 0.9  # (d), (e) the multi-object scene
MC_P = 0.995                              # (b)-(e) precision bar
BS_TOL = 1e-4                             # (d) tiles vs dense stacked


def dsd_density(M, mask):
    """w(S') / |S'| of the mask's vertex set over the card's M (f64)."""
    import torch
    idx = torch.nonzero(mask).flatten()
    sub = M.index_select(0, idx).index_select(1, idx).double()
    return float(sub.sum() / 2 / max(1, idx.numel()))


def precision_bar(label, inv, D1, D2, A, gts, mask, dev):
    """Precision against the labeled ground truth (the union of ``gts``, one
    array an object) at the MC_P bar, or, where an exact rounding (the
    maximum clique, DSD) selects associations the labels call outliers,
    each of those consistent with every ground-truth association of the
    object it joined (score > affinityeps and no shared endpoint against
    all of them, on the card): a correct match the synthetic labels miss.
    The bunny problems hold such draws (m=2048, rho=0.9: 9; m=8192,
    rho=0.95: 17), which any exact method must select. Returns (P, R of
    the object won, the count of selected associations outside the
    labels)."""
    import torch
    from clipper_tpu_torch.bench import data
    gts = [g for g in gts if g.size]
    Ain = A[np.asarray(mask)]
    P, _ = data.get_precision_recall(Ain, np.concatenate(gts))
    recalls = [data.get_precision_recall(Ain, g)[1] for g in gts]
    won = gts[int(np.argmax(recalls))]
    labeled = {(int(a), int(b)) for g in gts for a, b in g}
    extra = np.array([a for a in Ain if (int(a[0]), int(a[1])) not in
                      labeled], np.int64).reshape(-1, 2)
    consistent = True
    if len(extra) and P < MC_P:
        X = torch.as_tensor(extra, device=dev)
        G = torch.as_tensor(won, dtype=torch.int64, device=dev)
        T1 = torch.as_tensor(D1, dtype=torch.float32, device=dev)
        T2 = torch.as_tensor(D2, dtype=torch.float32, device=dev)
        score = inv.score_block(T1[X[:, 0]], T1[G[:, 0]], T2[X[:, 1]],
                                T2[G[:, 1]])
        shared = ((X[:, None, 0] == G[None, :, 0])
                  | (X[:, None, 1] == G[None, :, 1]))
        consistent = bool(((score > 1e-4) & ~shared).all())
    print(f"{label}: precision {P * 100:.2f}% against the labels, recall "
          f"{max(recalls) * 100:.2f}% of the object won; {len(extra)} "
          f"selected outside the labels, each consistent with every labeled "
          f"inlier of its object: {consistent}", flush=True)
    require(P >= MC_P or consistent, f"{label}: precision {P:.4f} < {MC_P} "
            "with selected outliers inconsistent with the ground truth")
    return P, max(recalls), len(extra)


def check_clique(label, c, sol, prob, inv, dev):
    """The set is a clique of C (checked on the card), no smaller than the
    heuristic's, and at :func:`precision_bar`; Method.KCORE's set equals
    kcore_prune_mask on the card. Returns the clique's size and the exact
    solve's host ms."""
    import torch
    from clipper_tpu_torch.ops import kcore
    from clipper_tpu_torch.solvers import maxclique
    D1, D2, A, Agt = prob
    C = c._C
    idx = torch.nonzero(sol.mask).flatten()
    sub = C.index_select(0, idx).index_select(1, idx)
    eye = torch.eye(idx.numel(), dtype=torch.bool, device=dev)
    require(bool((sub[~eye] == 1).all()), f"{label}: the maximum clique is "
            "not a clique of C")
    precision_bar(f"{label} maximum clique", inv, D1, D2, A, [Agt],
                  sol.mask.cpu().numpy(), dev)
    heu = c.solve_as_maximum_clique(maxclique.Params(
        method=maxclique.Method.HEU))
    require(int(sol.mask.sum()) >= int(heu.mask.sum()), f"{label}: the "
            "exact clique is smaller than the heuristic's")
    kc = c.solve_as_maximum_clique(maxclique.Params(
        method=maxclique.Method.KCORE))
    mask, maxcore = kcore.kcore_prune_mask(C)
    require(mask.is_cuda and bool((kc.mask == mask).all()), f"{label}: "
            "Method.KCORE's set differs from kcore_prune_mask on the card")
    print(f"{label}: maximum clique |S|={idx.numel()} in {sol.t * 1e3:.2f} "
          f"ms (host, exact B&B; the heuristic's {int(heu.mask.sum())}); "
          f"KCORE set {int(mask.sum())} vertices (max core {int(maxcore)}) "
          "equal to the card's k-core peel", flush=True)
    return idx.numel(), sol.t * 1e3


def surface_dsd_facade(pn_inv, dev):
    """(a) BASELINE.json config 3 with Rounding.DSD; (b) its maximum clique.
    Returns the launches of the counted build and solve, and a summary."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import data, harness
    from clipper_tpu_torch.types import Params, Rounding

    D1, D2, A, Agt = harness.make_pointnormal_problem(
        np.random.default_rng(0), n=PN_N, m=PN_M, rho=PN_RHO)
    D1, D2 = D1.astype(np.float32), D2.astype(np.float32)
    u0 = np.random.default_rng(0).random(PN_M).astype(np.float32)
    c = Clipper(pn_inv, Params(rounding=Rounding.DSD), dtype=torch.float32,
                device=dev)

    def call():
        c.score_pairwise_consistency(D1.T, D2.T, A)
        return c.solve(u0=u0)

    t0 = time.perf_counter()
    sol, launches = counted_call(call)
    total_s = time.perf_counter() - t0
    require(c._M is not None and launches["affinity_build"] == 1,
            f"(a) DSD facade: the dense build kernel once expected, "
            f"launches {launches}")
    mask = sol.mask
    S = sol.u > 0
    require(mask.shape == (PN_M,) and bool(torch.isfinite(sol.u).all()),
            "(a) DSD facade: bad shape or non-finite u")
    require(bool((mask & ~S).sum() == 0), "(a) the DSD mask leaves the "
            "support of u")
    P, R = data.get_precision_recall(c.get_selected_associations(), Agt)
    # the parts apart: the build, the dense solve (DSD_HEU rounding of the
    # same u0) and the host DSD on the gathered block
    build_ms = harness.time_ms(
        lambda: c.score_pairwise_consistency(D1.T, D2.T, A), dev, 3)
    c.params = Params()
    t0 = time.perf_counter()
    heu = c.solve(u0=u0)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    require(bool(torch.equal(heu.u, sol.u)), "(a) the DSD_HEU solve's u "
            "differs from the DSD solve's: the solve is not reproducible")
    t0 = time.perf_counter()
    again = c._dsd_dense(sol.u)
    torch.cuda.synchronize()
    dsd_s = time.perf_counter() - t0
    require(bool(torch.equal(again, mask)), "(a) a rerun of the DSD gives "
            "another set")
    d_dsd, d_heu = dsd_density(c._M, mask), dsd_density(c._M, heu.mask)
    print(f"(a) point-normal facade m={PN_M} rho={PN_RHO} f32 Rounding.DSD: "
          f"precision={P * 100:.2f}% recall={R * 100:.2f}% |DSD set|="
          f"{int(mask.sum())} |S|={int(S.sum())} (|Agt|={len(Agt)}); density "
          f"w(S')/|S'| DSD {d_dsd:.6f} >= DSD_HEU mask's {d_heu:.6f} "
          f"(|mask| {int(heu.mask.sum())}); build {build_ms:.3f} ms (CUDA "
          f"events, mean of 3), solve {solve_ms:.3f} ms, host DSD on the "
          f"gathered M[S, S] {dsd_s:.3f} s (gather, copy, max flow; host "
          f"clock); the first call, build + solve + DSD, {total_s:.3f} s; "
          f"launches {launches}", flush=True)
    require(P >= 0.99, f"(a) DSD facade precision {P:.4f} < 0.99")
    require(R >= 0.85, f"(a) DSD facade recall {R:.4f} < 0.85")
    require(d_dsd >= d_heu - 1e-9 * abs(d_heu), "(a) the DSD set is less "
            "dense than the DSD_HEU mask")
    summary = dict(dsd_s=dsd_s, S=int(S.sum()), dsd_set=int(mask.sum()),
                   build_ms=build_ms, solve_ms=solve_ms, P=P, R=R)

    sol = c.solve_as_maximum_clique()
    require(float(sol.score) == -1.0 and int(sol.ifinal) == 0,
            "(b) the maximum clique's score -1 and ifinal 0 expected")
    summary["pn_clique"], summary["pn_clique_ms"] = check_clique(
        f"(b) point-normal m={PN_M}", c, sol, (D1, D2, A, Agt), pn_inv, dev)
    return launches, summary


def surface_bunny_clique(inv, dev):
    """(b) the maximum clique of the bunny's C at m=2048, rho=0.9 (the
    graph of BENCH.md:226, clique 213: all 205 labeled inliers and 8 of
    the 9 outlier draws consistent with every one of them)."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.types import Params
    pcd0, pcd1, A, Agt, _ = one_problem(MC_M, MC_RHO, seed=0)
    c = Clipper(inv, Params(), dtype=torch.float32, device=dev)
    (sol, launches) = counted_call(lambda: (
        c.score_pairwise_consistency(pcd0.T, pcd1.T, A),
        c.solve_as_maximum_clique())[1])
    require(launches["affinity_build"] == 1, f"(b) bunny: the dense build "
            f"kernel once expected, launches {launches}")
    return check_clique(f"(b) bunny m={MC_M} rho={MC_RHO}", c, sol,
                        (pcd0, pcd1, A, Agt), inv, dev)


def surface_capacity_dsd(inv, dev):
    """(c) the triangle engine (engine="auto") with Rounding.DSD: the
    engine rounds NONZERO, DSD runs on the support block rebuilt from the
    invariant. Returns its launches and |S|."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import data
    from clipper_tpu_torch.types import Params, Rounding
    pcd0, pcd1, A, Agt, u0 = one_problem(SURF_CAP_M, SURF_CAP_RHO, seed=0)
    c = Clipper(inv, Params(rounding=Rounding.DSD), dtype=torch.float32,
                device=dev)
    c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    require(c._cap is not None, "(c) m=8192 did not take the triangle "
            "engine")
    t0 = time.perf_counter()
    sol, launches = counted_call(lambda: c.solve(u0=u0))
    wall = time.perf_counter() - t0
    S = int((sol.u > 0).sum())
    t0 = time.perf_counter()
    again = c._dsd_on_support(sol.u)
    torch.cuda.synchronize()
    dsd_s = time.perf_counter() - t0
    require(bool(torch.equal(again, sol.mask)), "(c) a rerun of the DSD "
            "gives another set")
    require(bool((sol.mask & ~(sol.u > 0)).sum() == 0), "(c) the DSD mask "
            "leaves the support")
    P, R = data.get_precision_recall(c.get_selected_associations(), Agt)
    print(f"(c) capacity engine m={SURF_CAP_M} rho={SURF_CAP_RHO} f32 "
          f"Rounding.DSD: precision={P * 100:.2f}% recall={R * 100:.2f}% "
          f"|S|={S} |DSD set|={int(sol.mask.sum())} (|Agt|={len(Agt)}); "
          f"solve with DSD {wall:.3f} s, the DSD on the rebuilt M[S, S] "
          f"{dsd_s:.3f} s (host clock); launches {launches}", flush=True)
    for name in ("sym_rows_matvec", "sym_rows_reduce"):
        require(launches[name] > 0, f"(c) {name} was never launched")
    precision_bar("(c) capacity DSD", inv, pcd0, pcd1, A, [Agt],
                  sol.mask.cpu().numpy(), dev)
    require(R >= 0.88, f"(c) recall {R:.4f} < 0.88")
    return launches, dict(S=S, dsd_s=dsd_s, P=P, R=R)


def surface_blocksparse(inv, dev):
    """(d) the multi-object scene through set_sparse_matrix_data and the
    occupied-tile solve; (e) extract_cliques on its dense M and C.
    Returns the launches of the dense build and a summary."""
    import scipy.sparse as sp
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import blocksparse_bench, harness
    from clipper_tpu_torch.ops import blocksparse
    from clipper_tpu_torch.solvers import extract_cliques, msrc_flat
    from clipper_tpu_torch.types import Params, Rounding

    pcd0 = harness.load_bunny().astype(np.float32)
    D1, D2, A, gts = blocksparse_bench.build_scene(
        pcd0, SCENE_M, SCENE_K, SCENE_RHO, np.random.default_rng(0))
    m = A.shape[0]
    dense = Clipper(inv, Params(), dtype=torch.float32, engine="dense",
                    device=dev)
    _, launches = counted_call(
        lambda: dense.score_pairwise_consistency(D1.T, D2.T, A))
    require(launches["affinity_build"] == 1, "(d) the scene's dense build "
            f"kernel once expected, launches {launches}")
    M, C = dense._M, dense._C
    # the reference's sparse input: the strict upper triangle as scipy COO,
    # taken from the card without a dense host copy
    iu = torch.nonzero(torch.triu(M, diagonal=1))
    r, cc = iu[:, 0], iu[:, 1]
    vals = M[r, cc].cpu().numpy()
    r, cc = r.cpu().numpy(), cc.cpu().numpy()
    M_sp = sp.coo_matrix((vals, (r, cc)), shape=(m, m)).tocsr()
    C_sp = sp.coo_matrix((np.ones_like(vals), (r, cc)), shape=(m, m)).tocsr()
    c = Clipper(None, Params(rounding=Rounding.DSD), dtype=torch.float32,
                device=dev)
    c.set_sparse_matrix_data(M_sp, C_sp)
    info = c._bs_info
    require(c._bs is not None and c._M is None, "(d) the scene took the "
            f"dense path (occupancy {info and info['occupancy']})")
    _, dinfo = blocksparse.from_scipy(
        (M_sp + M_sp.T).tocsr(), (C_sp + C_sp.T).tocsr(), tile=c._bs.tile,
        storage_dtype=torch.int8, max_occupancy=-1.0, device=dev)
    nt, m_pad = info["nt"], info["m_pad"]
    gen = torch.Generator(device=dev).manual_seed(5)
    U = torch.rand(m_pad, 16, generator=gen, device=dev)
    U = U / torch.linalg.vector_norm(U, dim=0)
    mv = blocksparse.make_matvec(c._bs, nt, torch.float32)
    mvd = msrc_flat.make_stacked_matvec(dinfo["dense"], torch.float32)
    Mu, Cu = mv(U)
    Mu2, Cu2 = mv(U)
    Md, Cd = mvd(U)
    ref = (dinfo["dense"].double() / 127) @ U.to(torch.bfloat16).double()
    err_d = max(float((Mu - Md).abs().max()), float((Cu - Cd).abs().max()))
    err_o = max(float((Mu.double() - ref[:m_pad]).abs().max()),
                float((Cu.double() - ref[m_pad:]).abs().max()))
    rerun = bool(torch.equal(Mu, Mu2) and torch.equal(Cu, Cu2))
    bs_ms = harness.time_ms(lambda: mv(U), dev, 20)
    dense_ms = harness.time_ms(lambda: mvd(U), dev, 20)
    print(f"(d) block-sparse scene m={m} k={SCENE_K} rho={SCENE_RHO}: tile "
          f"{c._bs.tile}, occupancy {info['occupancy'] * 100:.2f}% "
          f"({info['n_tiles']}/{nt * nt} tiles, storage "
          f"{c._bs.tiles.numel() / 1e6:.1f} MB against "
          f"{dinfo['dense'].numel() / 1e6:.1f} MB dense); the tile matvec at "
          f"K=16: max |tiles - dense stacked| {err_d:.3e}, max |tiles - f64 "
          f"oracle| {err_o:.3e}, rerun bit-identical {rerun}; "
          f"{bs_ms:.4f} ms against the dense stacked int8 matvec's "
          f"{dense_ms:.4f} ms (CUDA events, mean of 20)", flush=True)
    require(err_d <= BS_TOL, f"(d) tiles vs dense stacked {err_d:.3e}")
    require(err_o <= ORACLE_TOL, f"(d) tiles vs f64 oracle {err_o:.3e}")
    require(rerun, "(d) a rerun of the tile matvec is not bit-identical")
    t0 = time.perf_counter()
    sol = c.solve(multistart=3)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    mask = sol.mask.cpu().numpy()
    print(f"(d) solve(multistart=3) with Rounding.DSD over the tiles: "
          f"{solve_s:.3f} s (host clock, with the scipy polish and the "
          f"host DSD), |set|={int(mask.sum())}", flush=True)
    P, _, _ = precision_bar("(d) block-sparse DSD", inv, D1, D2, A, gts,
                            mask, dev)

    t0 = time.perf_counter()
    res = extract_cliques(M, C, torch.Generator().manual_seed(0), Params(),
                          max_cliques=SCENE_K, device=dev)
    torch.cuda.synchronize()
    ext_s = time.perf_counter() - t0
    print(f"(e) extract_cliques: {len(res)} cliques for {SCENE_K} objects "
          f"in {ext_s:.3f} s (host clock)", flush=True)
    seen = np.zeros(m, bool)
    for k, cl in enumerate(res):
        require(not (seen & cl.mask).any(), f"(e) clique {k} overlaps an "
                "earlier one")
        seen |= cl.mask
        precision_bar(f"(e) clique {k} (size {int(cl.mask.sum())})", inv,
                      D1, D2, A, gts, cl.mask, dev)
    require(len(res) > 0, "(e) no clique extracted")
    return launches, dict(occupancy=info["occupancy"], bs_ms=bs_ms,
                          dense_ms=dense_ms, solve_s=solve_s, P=P,
                          objects=len(res), extract_s=ext_s)


def phase_surface(inv, pn_inv, check, dev):
    """9: the facade's remaining surface at full width on the card."""
    import torch
    _, _, As, Agts, _ = check
    t0 = time.perf_counter()
    out = {}
    out["a"], summary = surface_dsd_facade(pn_inv, dev)
    surface_bunny_clique(inv, dev)
    out["c"], summary["capacity"] = surface_capacity_dsd(inv, dev)
    out["d"], summary["blocksparse"] = surface_blocksparse(inv, dev)
    # (f) the tri pool at stall_outers=1 on the card and on the CPU
    compare_devices("tri pool stall_outers=1",
                    run_pipeline(inv, check, dev, W_CHECK, stall_outers=1),
                    run_pipeline(inv, check, "cpu", W_CHECK, stall_outers=1),
                    As, Agts, W_CHECK, W_CHECK - 1)
    torch.cuda.synchronize()
    print(f"surface: launches of (a) {out['a']}, (c) {out['c']}, (d) "
          f"{out['d']}; summary {json.dumps(summary)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(out["a"]["affinity_build"] > 0 and out["c"]["sym_rows_matvec"]
            > 0, "surface: kernels 6 and 3 expected on its path")
    return out


# ---------------------------------------------------------------------------
# the SDP relaxation (solvers/sdp.py), the utils, the compat namespace and
# the examples
# ---------------------------------------------------------------------------

SDP_EPS = 1e-4                 # (a) the exact-eigh solve's tolerance
SDP_RANK_M = 4096              # (b) the rank-r route
SDP_B, SDP_B_M = 8, 256        # (c) the batched solve (sdp_bench's default)
SDP_TRACE_TOL = 1e-4           # (a) |tr X - 1|
SDP_LAMBDA_MIN = -1e-5         # (a) lambdas.min()
SDP_DUALITY_REL = 1e-9         # (a) weak duality at the rounded clique


@contextlib.contextmanager
def sdp_solutions():
    """The sdp.Solution of every sdp.solve made inside the block (the
    facade keeps only its mask)."""
    from clipper_tpu_torch.solvers import sdp
    seen, orig = [], sdp.solve

    def spy(*args, **kwargs):
        seen.append(orig(*args, **kwargs))
        return seen[-1]

    sdp.solve = spy
    try:
        yield seen
    finally:
        sdp.solve = orig


def warned(run):
    """(run(), the texts of the warnings it raised)."""
    import warnings
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = run()
    return out, [str(w.message) for w in rec]


def clique_objective(M, nodes):
    """<M, x x^T> in f64 for x the unit indicator of ``nodes``: the
    objective of the rounded set's feasible point of the relaxation."""
    import torch
    idx = torch.as_tensor(nodes, device=M.device)
    sub = M.index_select(0, idx).index_select(1, idx).double()
    return float(sub.sum() / max(1, len(nodes)))


def sdr_quality(label, c, soln, prob, inv, dev, r_bar):
    """The facade's SDR selection: a clique of C (on the card), at
    precision_bar and recall >= r_bar. Returns (P, R)."""
    import torch
    from clipper_tpu_torch.bench import data
    pcd0, pcd1, A, Agt = prob
    C = c.get_constraint_matrix()
    idx = torch.as_tensor(soln.nodes, device=dev)
    sub = C.index_select(0, idx).index_select(1, idx)
    require(len(soln.nodes) > 0 and bool((sub == 1).all()),
            f"{label}: the SDR's nodes are not a clique of C")
    mask = np.zeros(len(A), bool)
    mask[soln.nodes] = True
    P, _, _ = precision_bar(label, inv, pcd0, pcd1, A, [Agt], mask, dev)
    _, R = data.get_precision_recall(A[mask], Agt)
    require(R >= r_bar, f"{label}: recall {R:.4f} < {r_bar}")
    return P, R


def sdp_facade(inv, dev):
    """(a) the facade's exact-eigh SDR at m=1024 and (e) its time limit.
    Returns the launches, the solution and the summary."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.solvers import sdp
    from clipper_tpu_torch.types import Params
    pcd0, pcd1, A, Agt, u0 = one_problem(M, RHO, seed=0)
    c = Clipper(inv, Params(), dtype=torch.float32, device=dev)
    params = sdp.Params(eps_abs=SDP_EPS, eps_rel=SDP_EPS)
    with sdp_solutions() as seen:
        ((_, msgs), launches) = counted_call(lambda: warned(lambda: (
            c.score_pairwise_consistency(pcd0.T, pcd1.T, A),
            c.solve_as_msrc_sdr(params))))
    soln = seen[0]
    require(launches["affinity_build"] == 1, "(a) the dense build kernel "
            f"once expected, launches {launches}")
    require(soln.iters < params.max_iters and not msgs,
            f"(a) iters {soln.iters}, warnings {msgs}")
    Mi = c.get_affinity_matrix()
    tr = float(torch.trace(soln.X))
    lmin = float(soln.lambdas.min())
    pclique = clique_objective(Mi, soln.nodes)
    rel = soln.gap / max(1.0, abs(soln.pobj))
    print(f"(a) facade SDR m={M} rho={RHO} f32, exact eigh, eps {SDP_EPS:g}: "
          f"iters {soln.iters}, {soln.t_solve / soln.iters * 1e3:.3f} ms an "
          f"iteration (host clock over the solve / iters), t_solve "
          f"{soln.t_solve:.3f} s, t_extract {soln.t_extract:.3f} s; pobj "
          f"{soln.pobj:.6f} dobj {soln.dobj:.6f} gap {soln.gap:.3e} ({rel:.3e} "
          f"relative); the rounded clique's objective {pclique:.6f} "
          f"(dobj - it: {soln.dobj - pclique:.3e}); tr X - 1 {tr - 1:.3e}, "
          f"lambda_min {lmin:.3e}, |nodes| {len(soln.nodes)}; launches "
          f"{launches}", flush=True)
    require(abs(tr - 1.0) <= SDP_TRACE_TOL, f"(a) tr X = {tr}")
    require(lmin >= SDP_LAMBDA_MIN, f"(a) lambdas.min() = {lmin}")
    require(soln.dobj >= pclique - SDP_DUALITY_REL * max(1.0, pclique),
            f"(a) dobj {soln.dobj} below the rounded clique's objective "
            f"{pclique}: the dual bound is not a bound")
    P, R = sdr_quality("(a) facade SDR", c, soln, (pcd0, pcd1, A, Agt), inv,
                       dev, DENSE_R)
    summary = dict(m=M, iters=soln.iters, ms_per_iter=soln.t_solve /
                   soln.iters * 1e3, t_solve=soln.t_solve,
                   t_extract=soln.t_extract, gap=soln.gap, pobj=soln.pobj,
                   dobj=soln.dobj, clique_obj=pclique, P=P, R=R)

    # (e) the time limit: one chunk (50 iterations), still feasible
    lim, _ = warned(lambda: sdp.solve(Mi, c.get_constraint_matrix(),
                                      sdp.Params(eps_abs=SDP_EPS,
                                                 eps_rel=SDP_EPS,
                                                 time_limit_secs=1e-9),
                                      device=dev))
    tr = float(torch.trace(lim.X))
    print(f"(e) time_limit_secs=1e-9: stopped at iteration {lim.iters}, tr X "
          f"- 1 {tr - 1:.3e}", flush=True)
    require(lim.iters <= 50 and abs(tr - 1.0) <= 1e-5,
            f"(e) iters {lim.iters}, tr X {tr}")
    summary["time_limit_iters"] = lim.iters
    return launches, c, (pcd0, pcd1, A, Agt, u0), soln, summary


def sdp_rank(inv, dev):
    """(b) the rank-r route at m=4096 with default Params (auto_tune)."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.solvers import sdp
    from clipper_tpu_torch.types import Params
    pcd0, pcd1, A, Agt, _ = one_problem(SDP_RANK_M, RHO, seed=0)
    c = Clipper(inv, Params(), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    with sdp_solutions() as seen:
        ((_, msgs), launches) = counted_call(lambda: warned(lambda: (
            c.score_pairwise_consistency(pcd0.T, pcd1.T, A),
            c.solve_as_msrc_sdr(sdp.Params()))))
    total = time.perf_counter() - t0
    soln = seen[0]
    print(f"(b) rank-r SDR m={SDP_RANK_M} rho={RHO} f32, default Params: "
          f"iters {soln.iters}, {soln.t_solve / soln.iters * 1e3:.3f} ms an "
          f"iteration, t_solve {soln.t_solve:.3f} s, t_extract "
          f"{soln.t_extract:.3f} s, build + solve {total:.3f} s (host clock); "
          f"gap {soln.gap:.3e} (pobj {soln.pobj:.4f}); warnings {msgs}; "
          f"launches {launches}", flush=True)
    for text in ("eps tightened to 0.0001", "z_rank=64",
                 "Anderson acceleration disabled at n=4096 — its difference "
                 "history would hold 2.5 GiB"):
        require(any(text in w for w in msgs), f"(b) auto_tune warning "
                f"{text!r} missing: {msgs}")
    require(launches["affinity_build"] == 1, f"(b) launches {launches}")
    P, R = sdr_quality("(b) rank-r SDR", c, soln, (pcd0, pcd1, A, Agt), inv,
                       dev, BENCH_R)
    return dict(m=SDP_RANK_M, iters=soln.iters, ms_per_iter=soln.t_solve /
                soln.iters * 1e3, t_solve=soln.t_solve, total_s=total,
                gap=soln.gap, P=P, R=R)


def sdp_batched_and_cpu(inv, dev):
    """(c) B=8 problems at m=256 through solve_as_msrc_sdr_batched, each
    against its own single solve on the card; (d) one of them in f64 on
    the card and on the CPU."""
    import torch
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.bench import harness, sdp_bench
    from clipper_tpu_torch.solvers import sdp
    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    D1 = torch.as_tensor(pcd0, device=dev)
    built = []
    for _ in range(SDP_B):
        pcd1, A, _ = harness.make_problem(pcd0, SDP_B_M, RHO, rng)
        built.append(sdp_bench._build(inv, D1, pcd1, A, dev)[2:])
    Ms = torch.stack([b[0] for b in built])
    Cs = torch.stack([b[1] for b in built])
    (solns, launches) = counted_call(
        lambda: Clipper.solve_as_msrc_sdr_batched(Ms, Cs, device=dev))
    t0 = time.perf_counter()
    Clipper.solve_as_msrc_sdr_batched(Ms, Cs, device=dev)
    torch.cuda.synchronize()
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [sdp.solve(Ms[b], Cs[b], device=dev) for b in range(SDP_B)]
    torch.cuda.synchronize()
    ts = time.perf_counter() - t0
    same = [solns[b].nodes == singles[b].nodes for b in range(SDP_B)]
    print(f"(c) batched SDR B={SDP_B} m={SDP_B_M}: {tb / SDP_B * 1e3:.3f} ms "
          f"a problem (host clock over the batch) against {ts / SDP_B * 1e3:.3f}"
          f" ms a single solve; iters batched {[s.iters for s in solns]} "
          f"single {[s.iters for s in singles]}; nodes equal {sum(same)} of "
          f"{SDP_B}", flush=True)
    require(all(same), "(c) a batched solution's nodes differ from its own "
            "single solve's")
    out = dict(ms_per_problem=tb / SDP_B * 1e3,
               single_ms=ts / SDP_B * 1e3)

    M64, C64 = Ms[0].double(), Cs[0].double()
    on_card = sdp.solve(M64, C64, device=dev)
    on_cpu = sdp.solve(M64.cpu(), C64.cpu(), device="cpu")
    dp = abs(on_card.pobj - on_cpu.pobj)
    print(f"(d) f64 m={SDP_B_M} CUDA against CPU: iters {on_card.iters} and "
          f"{on_cpu.iters}, nodes equal {on_card.nodes == on_cpu.nodes}, "
          f"|pobj difference| {dp:.3e} (pobj {on_card.pobj:.12f}), dobj "
          f"{on_card.dobj:.12f} and {on_cpu.dobj:.12f}", flush=True)
    require(on_card.nodes == on_cpu.nodes, "(d) CUDA and CPU nodes differ")
    require(dp <= 1e-8 * max(1.0, abs(on_cpu.pobj)),
            f"(d) pobj {on_card.pobj} against {on_cpu.pobj}")
    out.update(cuda_iters=on_card.iters, cpu_iters=on_cpu.iters, dpobj=dp)
    return out


def utils_compat(inv, c, prob, sdr_nodes, dev):
    """(f) the compat namespace, the profiler and the checkpoint on the
    card."""
    import glob
    import tempfile
    import torch
    import clipper_tpu_torch.compat as clipperpy
    from clipper_tpu_torch import Clipper
    from clipper_tpu_torch.ops.affinity import gather_endpoints
    from clipper_tpu_torch.ops.affinity_pallas import build_affinity_pallas
    from clipper_tpu_torch.solvers import msrc_flat
    from clipper_tpu_torch.types import Params
    from clipper_tpu_torch.utils import checkpoint, profiling
    pcd0, pcd1, A, Agt, u0 = prob

    cp = clipperpy.CLIPPER(inv, clipperpy.Params(), device=dev)
    cp.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    cp.solve(u0)
    ref = Clipper(inv, Params(), dtype=torch.float32, device=dev)
    ref.score_pairwise_consistency(pcd0.T, pcd1.T, A)
    ref.solve(u0=u0)
    same_sel = np.array_equal(cp.get_selected_associations(),
                              ref.get_selected_associations())
    require(same_sel, "(f) compat.CLIPPER's selection differs from the "
            "facade's on the same u0")
    require(isinstance(cp.get_affinity_matrix(), np.ndarray),
            "(f) compat matrices are not host arrays")
    sp = clipperpy.SDPParams()
    sp.eps_abs = sp.eps_rel = SDP_EPS
    cp.solve_as_msrc_sdr(sp)
    compat_nodes = cp.get_solution().nodes
    require(compat_nodes == list(sdr_nodes), "(f) compat.SDPParams' SDR "
            "nodes differ from (a)'s")

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            with profiling.annotate("facade build"):
                ref.score_pairwise_consistency(pcd0.T, pcd1.T, A)
        text = open(glob.glob(f"{tmp}/*.json")[0]).read()
    named = "affinity_build_kernel" in text and "facade build" in text
    require(named, "(f) the device trace does not name kernel 6's kernel")

    # kill-and-resume of an f64 flat solve through the disk, on the card
    D1 = torch.as_tensor(pcd0, dtype=torch.float64, device=dev)
    D2 = torch.as_tensor(pcd1, dtype=torch.float64, device=dev)
    At = torch.as_tensor(A, device=dev)
    P1, P2 = gather_endpoints(D1, D2, At)
    M64, C64 = build_affinity_pallas(inv, P1, P2, At, affinityeps=1e-4)
    mv = msrc_flat.stacked_dual_matvec(M64, C64)
    u = torch.as_tensor(u0, dtype=torch.float64, device=dev)
    u_ref, F_ref, i_ref, ticks_ref, _ = msrc_flat.flat_solve_single(
        mv, u, Params(), return_ticks=True)
    state = msrc_flat.flat_init(mv, u, Params())
    chunks = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/carry.npz"
        while not bool(state.done):
            state = msrc_flat.flat_solve_ticks(mv, state, Params(), ticks=7)
            checkpoint.save_solver_state(path, state)
            state = checkpoint.load_solver_state(path, device=dev)
            chunks += 1
    exact = (state.u.dtype == torch.float64 and state.u.is_cuda
             and torch.equal(state.u, u_ref) and torch.equal(state.F, F_ref)
             and int(state.i) == int(i_ref)
             and int(state.ticks) == int(ticks_ref))
    print(f"(f) compat.CLIPPER selection equal to the facade's: {same_sel}; "
          f"compat.SDPParams SDR nodes equal to (a): "
          f"{compat_nodes == list(sdr_nodes)}; device trace names "
          f"affinity_build_kernel: {named}; f64 flat solve m={M} killed and "
          f"resumed {chunks} times ({int(ticks_ref)} ticks): bit-identical "
          f"{exact}", flush=True)
    require(chunks > 2 and exact, "(f) the resumed f64 solve is not "
            "bit-identical to the straight-through one")


def run_examples(dev):
    """(g) ex1, ex3, ex4 and ex5 in-process at their defaults."""
    from clipper_tpu_torch.examples import (ex1_known_scale_registration,
                                            ex3_plane_cloud, ex4_bunny,
                                            ex5_large_scale)
    arg = [f"--device={dev.type}"]
    out = {}
    for name, mod, need in (
            ("ex1", ex1_known_scale_registration, ("affinity_build",)),
            ("ex3", ex3_plane_cloud, ("affinity_build",)),
            ("ex4", ex4_bunny, ("affinity_build",)),
            ("ex5", ex5_large_scale, ("sym_rows_matvec",))):
        _, out[name] = driver_call(f"example {name}", lambda: mod.main(arg),
                                   need)
    return out


def phase_sdp(inv, dev):
    """10: the SDP relaxation on the card, then the utils, the compat
    namespace and the examples."""
    import torch
    t0 = time.perf_counter()
    launches, c, prob, soln, summary = sdp_facade(inv, dev)
    summary["rank"] = sdp_rank(inv, dev)
    summary["batched"] = sdp_batched_and_cpu(inv, dev)
    utils_compat(inv, c, prob, soln.nodes, dev)
    ex = run_examples(dev)
    torch.cuda.synchronize()
    print(f"sdp: launches of (a) {launches}, examples {ex}; summary "
          f"{json.dumps(summary)}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, c, soln


def main() -> None:
    quick = "--quick" in sys.argv[1:]
    t_start = time.perf_counter()
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
    pn_inv = harness.pointnormal_invariant()
    t0 = time.perf_counter()
    check = make_problems(W_CHECK, seed=1)
    pn_check = make_pn_problems(W_CHECK, seed=1)
    print(f"check data: {W_CHECK} bunny and {W_CHECK} point-normal problems "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    errs = phase_kernels(inv, check, dev)
    for phase in (phase_kernels_pn, phase_kernels_bf16):
        for name, e in phase(inv, pn_inv, check, pn_check, dev).items():
            errs[name] = max(errs.get(name, 0), e)
    if quick:
        print("quick: build and kernel checks passed", flush=True)
        return

    t0 = time.perf_counter()
    main_data = make_problems(W_MAIN, seed=0)
    print(f"pool data: {W_MAIN} problems in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = phase_main(inv, main_data, dev)
    phase_bf16_pool(inv, main_data, dev)
    launches["stored_build"] = phase_stacked(inv, main_data,
                                             dev)["stored_build"]
    phase_multistart(inv, main_data, dev)
    launches["pattern_matvec"] = phase_batched(inv, main_data,
                                               dev)["pattern_matvec"]
    t0 = time.perf_counter()
    pn_main = make_pn_problems(W_MAIN, seed=0)
    print(f"point-normal pool data: {W_MAIN} problems in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches["affinity_build"] = phase_pointnormal(
        pn_inv, pn_main, dev)["facade"]["affinity_build"]
    variant = phase_tri_variants(inv, main_data, dev)
    for name in ("tri_build_fused", "tri_tiles_matvec"):
        launches[name] = variant[name]
    t0 = time.perf_counter()
    cap = one_problem(CAP_M, CAP_RHO, seed=0)
    print(f"capacity data: m={CAP_M} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cap_launches = phase_capacity(inv, cap, dev)
    for name in ("sym_rows_matvec", "sym_tiles_matvec", "sym_rows_reduce",
                 "sym_tiles_reduce"):
        launches[name] = cap_launches[name]
    phase_parity(inv, check, dev)
    phase_parity_pn(inv, pn_inv, check, pn_check, dev)
    phase_facade_parity(inv, dev)
    rows, build_err_main, mv_err_main, tiles_err_main = phase_timing(
        inv, main_data, dev)
    errs["tri_tiles_matvec"] = max(errs["tri_tiles_matvec"], tiles_err_main)
    errs["tri_build"] = max(errs["tri_build"], build_err_main)
    errs["tri_matvec"] = max(errs["tri_matvec"], mv_err_main)
    for name in ("sym_rows_matvec", "sym_tiles_matvec"):
        rows[name], e = time_capacity(name, inv, cap, dev)
        errs[name] = max(errs[name], e)
    rows_sp, errs_sp = time_stacked_and_pattern(inv, main_data, dev)
    rows.update(rows_sp)
    for name, e in errs_sp.items():
        errs[name] = max(errs[name], e)
    rows["affinity_build"], e = time_pn_and_dense(
        inv, pn_inv, check, pn_main, dev, rows)
    errs["affinity_build"] = max(errs["affinity_build"], e)
    (rows["build_probe"], launches["build_probe"],
     errs["build_probe"]) = phase_probe(dev)
    t0 = time.perf_counter()
    phase_drivers(dev)
    print(f"drivers: {time.perf_counter() - t0:.1f} s", flush=True)
    phase_surface(inv, pn_inv, check, dev)
    _, sdr_c, _ = phase_sdp(inv, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(inv, main_data, cap, dev)
        from clipper_tpu_torch.solvers import sdp
        profile_call(f"facade SDR m={M}", lambda: sdr_c.solve_as_msrc_sdr(
            sdp.Params(eps_abs=SDP_EPS, eps_rel=SDP_EPS)))

    src = "clipper_tpu_torch/csrc/"
    replaces = {
        "tri_matvec": "clipper_tpu/ops/flattri.py:152",
        "tri_build": "clipper_tpu/ops/flattri.py:463",
        "sym_rows_matvec": "clipper_tpu/ops/symstore.py:653",
        "stored_build": "clipper_tpu/ops/affinity_pallas.py:107",
        "pattern_matvec": "clipper_tpu/ops/fused_matvec.py:55",
        "sym_tiles_matvec": "clipper_tpu/ops/symstore.py:314",
        "affinity_build": "clipper_tpu/ops/affinity_pallas.py:42",
        "tri_build_fused": "clipper_tpu/ops/flattri.py:567",
        "tri_tiles_matvec": "clipper_tpu/ops/flattri.py:283",
        "build_probe": "clipper_tpu/bench/build_probe.py:135",
    }
    kernels = [dict(name=name, route="cuda", source=f"{src}{name}.cu",
                    replaces=where, launches=launches[name],
                    max_abs_err=errs[name], **rows[name])
               for name, where in replaces.items()]
    # the capacity matvecs' second kernel, the fixed-order reduction
    for k in kernels:
        if k["name"] in _kernels.REDUCTIONS:
            k["reduce_launches"] = launches[_kernels.REDUCTIONS[k["name"]]]
    print("main-path launches: " + ", ".join(
        f"{name} {launches[name]}" for name in (*replaces, *_kernels.
                                                REDUCTIONS.values())),
          flush=True)
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None:
                k[key] = float(k[key])
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
