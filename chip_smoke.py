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
              At every tile the JAX package takes (phase_kernels_tiles),
              each kernel's route (ops/flattri.matvec_route,
              ops/symstore.matvec_route) printed and its time beside its
              bound, plain version and library call: kernels 1 and 9 in
              int8 and bf16 at t = 16, 32, 48, 64, 100, 384, 512 on W=16
              problems of m = t (2048 // t) built by kernel 2 (kernel 1 at
              B=128, K=16 and B=16, K=1; kernel 9 at B=128, bit-equal to
              kernel 1 at K=1), and in f32 and f64 at t = 64, 100, 128,
              256 on W=16 problems of m = t (1024 // t) (kernel 1 at
              B=128, K=16; kernel 9 at B=128, bit-equal to kernel 1 at K=1
              but on its warp-row kernel at t = 128, 256), each <= 1e-4
              from its plain version (f64: 1e-12), <= 1.1e-5 from an f64
              oracle, a rerun bit for bit; kernels 2 and 8, int8 and bf16,
              both invariants,
              at t = 384 and 512 (W=16, m_true < m on four: C exact, 0 M
              codes differing, byte-equal to each other); kernels 3 and 7
              in int8 and bf16 at t = 16, 32, 48, 64, 100, 192, 256, 512
              on one problem of m = t (2048 // t), K=16 and K=1, whole and
              over D=3 slices (rows at G=3), the same bars, and in f32
              and f64 at t=128, K=16, beside torch.matmul over the dense
              [M; C] in their type (TF32 off).
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
              (B=32), gridcell_probe (8 problems at m=2048), mixed_bench
              (8 a size, 1 rep), multistart_bench (W=32, K=4, 1 rep),
              symstore_bench (m=8192, --mv-only), symshard_bench
              (m=8192 on a 1-rank NCCL group), sharded_bench (m=4096 on
              its own 1-rank NCCL group, the bench bars) and
              blocksparse_bench
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
11. mesh    — the multi-rank paths (parallel/sharded.py, the pools'
              mesh=, shard_batch, dryrun.py): (a) the 2D block-sharded
              engine on a 1-rank NCCL group (a 1x1 mesh) at phase 4's
              m=65,536 problem, int8 blocks built 512 rows at a time,
              probes=16, power_steps=4, support=512 (the JAX
              sharded_bench's defaults), the matvec cast 8192 rows at a
              time: one counted call, 2 timed; P >= 0.995, R >= 0.88;
              prints the stage ms, ticks, ifinal, F, the block's GB, the
              peak allocated memory, the polish branch and the IoU with
              phase 4's mask, then the stacked int8 matvec alone at K=16
              and K=1 beside its bound; (b) the 1x1 block at m=8192 (bunny
              seed 2, rho=0.95) byte-equal to kernel 4's storage and to the
              plain stacked build, int8 and bf16; (c) the tri and stacked
              pools (phase 3's and 3b's settings, W=512) on a 1-rank NCCL
              mesh: the Solution of mesh=None bit for bit, their kernels
              launched, the bench bars, problems/s beside mesh=None's in
              turns; (d) gloo ranks sharing the card (NCCL takes one rank a
              card): the 2D engine at (b)'s problem, int8, on 1x1, 1x2, 2x1
              and 2x2 (4 ranks: every rank's u bit-identical, the bench
              bars, IoU >= 0.95 with 1x1), then on 2 ranks the tri pool at
              W=64 (the masks of mesh=None, kernels 1 and 2 launched on each
              rank) and dryrun_multichip(2) (the JAX dry run's m=64,
              tiles of 16; its convergent check in f64 with equal masks).
              Each group of ranks runs under a 300 s timeout; a rank that
              fails fails the phase.
12. tiles   — the paths at tiles the card took only at 128 and 256 before
              (phase_tiles): bench.py's tri pool protocol (W=512) at
              tri_tile 64 and 512 in int8 and 512 in bf16, beside t=256
              in turns (P >= 0.995, R >= 0.88, the build kernel once and
              the matvec by its route launched, no launch under another
              route's key; problems/s and stage ms),
              kernels 1 and 2 timed on that W=512 storage at each tile;
              the m=65,536 capacity problem at tile=256, row-chunked and
              tile list (the P/R bars, IoU >= 0.95 with phase 4's t=128
              mask, kernels 3 and 7 launched; s a solve, stage ms), and
              kernels 3 and 7 at t=256 beside their bound and
              torch.matmul; phase 11 (d)'s dry run at m=64, tiles of 16.
13. user scores — an invariant's own device score inside the build
              kernels (phase_user_score; bench/user_scores.py's
              UserEuclidean and PlanarCauchy): both libraries built (nvcc
              seconds printed; a second lookup runs no nvcc); kernels 2,
              8, 4 in int8 and bf16 at W=512, t = 256, 64 (m=1024) and
              100 (m=1000), m_true < m on every 16th problem, and kernel
              6 in f32 and f64 at m = 1024, 1000, each against its plain
              version with 0 codes differing, timed beside the built-in
              Euclidean's, its bound and its plain version; bench.py's
              tri pool with UserEuclidean and build="auto"
              (tri_build_user once and no other build, masks equal to
              the built-in pool's bit for bit, the bench bars),
              problems/s beside the built-in's in turns and beside
              build="xla"; the tile-major pool, the stacked pool and the
              dense facade with it (kernels 8, 4 and 6 once each). Its
              rows join the kernels' line as *_user.
14. pga     — the dense PGA kernel (csrc/pga_dense.cu, phase_pga_dense)
              on 4 bunny problems at m=2048, rho=0.9, f32 and f64: each
              msrc.find_dense_clique solve against the host loop
              (run_pga over dense_operators) on the same CUDA tensors, at
              tests/test_torch_pga_device.py's tolerances; Clipper.solve
              launches pga_dense once and no other kernel; each solve
              timed beside the host loop and its bound (the trials' Md
              at the L2 read rate measured there, and all at 3.35 TB/s).

The line before the last is a JSON object of the kernels' numbers (rows 3
and 7 also carry reduce_launches, the main path's launches of their
reduction kernel, and tb_per_s, the bytes their design moves a call over
the measured ms; rows 1, 2, 3, 7, 8 and 9 carry "tiles", each new tile's
route, shape, ms and bound from phases 2 and 12; phase 13's four *_user
rows carry the built-in Euclidean kernel's ms as builtin_ms and their
other shapes under "shapes"; phase 14's pga_dense row carries f32's
medians, f64's under "f64" and each problem's numbers); the last line is
{"ok": true, "device": {...}}.

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
F64_FLOPS = 67e12             # f64 products on the tensor cores (DMMA)
F64_SIMT_FLOPS = 34e12        # other f64 work, outside the tensor cores
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
# f32 operations a pair of bench/user_scores.py's PlanarCauchy: two planar
# lengths (2 sub, 2 mul, 2 add, sqrt: 7 each), sub, abs, the gate's
# compare, the tail's mul, div, add and div, the masks' 4 compares: 25;
# 30 with the int8 quantization, as BUILD_OPS_PER_PAIR counts it
CAUCHY_OPS_PER_PAIR = 30


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
    """tri_matvec against the plain version on the same inputs (<= 1e-4;
    f64 storage, summed in f64: <= 1e-12); with oracle, also against an
    f64 oracle on the same content and u (bf16-rounded for int8 / bf16
    storage; <= 1.1e-5, f64: 1e-12) and a rerun bit for bit. Returns the
    max |kernel - plain|."""
    import torch
    from clipper_tpu_torch.ops import flattri
    f64 = tri.dtype == torch.float64
    fdt = torch.float64 if f64 else torch.float32
    MUk, CUk = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, fdt)
    MUp, CUp = flattri.tri_pool_matvec_plain(tri, nt, idx, U, fdt)
    require(bool(torch.isfinite(MUk).all() & torch.isfinite(CUk).all()),
            f"tri_matvec {label}: non-finite output")
    err = max(float((MUk - MUp).abs().max()), float((CUk - CUp).abs().max()))
    msg = f"tri_matvec vs plain ({label}): max|kernel - plain|={err:.3e}"
    if oracle:
        Uo = (U.bfloat16().double() if tri.dtype in (torch.int8,
                                                      torch.bfloat16)
              else U.double())
        MUo, CUo = flattri.tri_pool_matvec_plain(tri.double(), nt, idx, Uo,
                                                 torch.float64)
        s = 1 / 127 if tri.dtype == torch.int8 else 1.0
        e_o = max(float((MUk.double() - MUo * s).abs().max()),
                  float((CUk.double() - CUo * s).abs().max()))
        again = flattri.tri_pool_matvec_cuda(tri, nt, idx, U, fdt)
        same = bool(torch.equal(MUk, again[0]) and torch.equal(CUk,
                                                               again[1]))
        msg += (f", max|kernel - f64 oracle|={e_o:.3e}, rerun "
                f"bit-identical={same}")
        o_tol = F64_MATVEC_TOL if f64 else ORACLE_TOL
        require(e_o <= o_tol, f"tri_matvec {label} exceeds {o_tol} against "
                "the f64 oracle")
        require(same, f"tri_matvec {label}: a rerun is not bit-identical")
    print(msg, flush=True)
    require(err <= (F64_MATVEC_TOL if f64 else MATVEC_TOL),
            f"tri_matvec {label} disagrees with plain")
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


def rows_storage(inv, prob, dev, G, storage=None, tile=ROWS_T):
    """The capacity engine's row-chunked storage of one problem (int8 by
    default, else the raw scores in the float dtype ``storage``)."""
    import torch
    from clipper_tpu_torch.ops import symstore
    P1, P2, At = capacity_endpoints(prob, dev, storage)
    return symstore.build_symchunks(inv, P1, P2, At, len(At), tile=tile,
                                    G=G, storage_dtype=storage or torch.int8)


def tiles_storage(inv, prob, dev, storage=None, tile=ROWS_T):
    """The same problem's tile-list storage (ops/symstore.build_symtiles)."""
    import torch
    from clipper_tpu_torch.ops import symstore
    P1, P2, At = capacity_endpoints(prob, dev, storage)
    return symstore.build_symtiles(inv, P1, P2, At, len(At), tile=tile,
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
                 stall_outers=0, mesh=None, tri_tile=0, build="auto"):
    """bench.py's tri pool (int8 storage unless ``storage`` says; over a
    process group with ``mesh``; at ``tri_tile``, 0: the default 256; the
    build by ``build``)."""
    import torch
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params
    D1, D2s, As, _, u0s = data_
    pipe = pool.make_pool_pipeline(inv, Params(), lanes=128, window=2,
                                   storage_dtype=storage or torch.int8,
                                   power_steps=4, layout="tri",
                                   tri_probes=16, d_scale=0.15,
                                   stall_outers=stall_outers, mesh=mesh,
                                   tri_tile=tri_tile, build=build,
                                   device=dev)
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


def run_stacked(inv, data_, dev, W, timings=None, stats=None, mesh=None):
    import torch
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params
    D1, D2s, As, _, u0s = data_
    pipe = pool.make_pool_pipeline(inv, Params(), storage_dtype=torch.int8,
                                   mesh=mesh, device=dev, **STACKED)
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
        ms = time_ms(lambda: flattri.tri_pool_matvec_cuda(
            tri, nt, idx, U, torch.float32), dev, 50)
        plain = time_ms(lambda: flattri.tri_pool_matvec_plain(
            tri, nt, idx, U, torch.float32), dev, 5)
        r = dict(ms=ms, plain_ms=plain, library_ms=bmm_ms(tri, nt, idx, U,
                                                          dev, 20),
                 **tri_matvec_bound(idx, K, t, nt, tri.element_size()))
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


def report_capacity(label, run, Agt, kernel, route="units"):
    """Shapes, finite values, F <= m, the P/R bars, ``kernel`` launched by
    ``route`` (ops/symstore.matvec_route) with its reduction (on the
    "units" route, its "core" key not at all); prints the quality, stage
    times, ticks, storage and launches."""
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
    for name in (_kernels.route_key(kernel, route),
                 _kernels.REDUCTIONS[kernel]):
        require(launches[name] > 0, f"{label}: {name} was never launched: "
                f"{launches}")
    if route == "units":
        other = _kernels.route_key(kernel, "core")
        require(launches[other] == 0, f"{label}: the units route launched "
                f"{other}: {launches}")
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
    the auto and tile-list runs, and the auto run's mask."""
    m, Agt = len(prob[2]), prob[3]
    run = capacity_solve(inv, prob, dev, "auto", {})
    engine = run[0]._resolve_engine(m)
    require(engine == "triangle" and run[0]._cap is not None,
            f"m={m} resolved to engine {engine!r}, not the triangle engine")
    mask_auto, _ = report_capacity("capacity path (auto)", run, Agt,
                                   "sym_rows_matvec")
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
    return launches, mask_auto


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


def time_capacity(name, inv, prob, dev, t=ROWS_T, storages=None):
    """The rows (name "sym_rows_matvec") or tile-list ("sym_tiles_matvec")
    matvec on the capacity path's m=65,536 storage: held against its plain
    version at K=16 and K=1 (the tile list on its D=3 slices too), then
    timed with its plan built beforehand, beside its bound, its plain
    version, the dense bf16 [M; C] matmul and its two-read design's time;
    then the same over bf16 storage at K=16 (``storages``: int8 and bf16
    by default; t: the storage's tile). Prints the time to make its
    plan (with the layout's plan cache emptied, and from the cache), the
    design's bytes a call against the stored tiles' (and fails past
    DESIGN_RATIO) and the rate it reaches. Returns the K=16 row of the kernels' JSON line and the
    max abs error."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import symstore

    rows_layout = name == "sym_rows_matvec"
    m = len(prob[2])
    G = 32
    storages = storages or (torch.int8, torch.bfloat16)
    nt = m // t
    T = nt * (nt + 1) // 2
    gen = torch.Generator(device=dev).manual_seed(2 if rows_layout else 5)
    Us = {K: unit_rows(gen, 1, K, dev, m)[0] for K in (16, 1)}
    rows = {}
    err = 0.0
    for storage in storages:
        label = str(storage).split(".")[-1]
        if rows_layout:
            store = rows_storage(inv, prob, dev, G=G, storage=storage,
                                 tile=t)
            plan, plan_ms = time_plan(
                lambda: symstore.rows_device_plan(store, nt),
                symstore._rows_plan)
            dense = dense_from_chunks(store, nt)

            def kernel(U):
                return symstore.sym_rows_matvec_cuda(store, nt, U, plan=plan)

            def plain(U):
                return symstore.sym_rows_matvec_plain(store, nt, U)
        else:
            store = tiles_storage(inv, prob, dev, storage, tile=t)
            plan, plan_ms = time_plan(
                lambda: symstore.tiles_device_plan(store, nt),
                symstore._tiles_plan)
            dense = dense_from_tiles(store, nt, torch.bfloat16)

            def kernel(U):
                return symstore.sym_tiles_matvec_cuda(store, nt, U,
                                                      plan=plan)

            def plain(U):
                return symstore.sym_tiles_matvec_plain(store, nt, U)
        print(f"{name} storage m={m}, t={t}: {tuple(store.shape)} {label}, "
              f"{store.numel() * store.element_size() / 1e9:.3f} GB ({T} "
              f"tiles); plan: {len(plan.plan.units)} units, "
              f"{plan.plan.n_slots} partial slots, made in {plan_ms[0]:.1f} "
              f"ms (host plan and copy to the card), {plan_ms[1]:.1f} ms "
              "from the layout's cache", flush=True)
        for K in ((16, 1) if storage == torch.int8 else (16,)):
            U = Us[K]
            label_k = f"{label}, m={m}, K={K}" + (
                "" if t == ROWS_T else f", t={t}")
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
            ref = (f"two-read design {two_read:.4f} ms" if t == ROWS_T
                   else f"route {symstore.matvec_route(t, storage)}")
            print(f"timing {name} {label_k}: kernel {r['ms']:.4f} ms "
                  f"({ref}), bound "
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
    # one kernel over two address maps but where kernel 9's float kinds
    # take their warp-row kernel (t = 128, 256)
    t = tri.shape[1] // 2
    if tri.dtype in (torch.int8, torch.bfloat16) or t not in (128, 256):
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


# ---------------------------------------------------------------------------
# every tile the JAX package takes: the int8 / bf16 matvecs' and builds'
# new tiles (phase 2) and the paths over them (phase 12)
# ---------------------------------------------------------------------------

TILE_M = 2048                  # phase 2's new tiles: m = t (TILE_M // t)
TILE_W = 16                    # ... problems (kernels 1, 2, 8, 9)
PN_TILE_M = 1536               # ... point-normal problems (kernels 2, 8)
TRI_TILES = (16, 32, 48, 64, 100, 384, 512)   # kernels 1 and 9
FLOAT_TILES = (64, 100, 128, 256)     # ... over f32 / f64 storage
CAP_TILES = (16, 32, 48, 64, 100, 192, 256, 512)   # kernels 3 and 7
BUILD_TILES = (384, 512)              # kernels 2 and 8 past 256
TILE_G = 3                     # the rows layout's chunk width there
POOL_TILES = (64, 512)         # phase 12: the tri pool at these tiles
CAP_TILE = 256                 # ... and the capacity engine at this one
CAP_CORE_TILE = 64             # ... and at this one (the unit kernel over
                               # super-tiles of 64-row tiles)
CAP_TILE_IOU = 0.95            # ... its mask against phase 4's (t=128)


def tile_m(t: int) -> int:
    return t * (TILE_M // t)


def tri_matvec_bound(idx, K, t, nt, item, u_item=2, out_item=4,
                     peak=None):
    """bound_of a tri matvec call over lanes idx of storage of ``item``
    bytes an element: each distinct problem's triangle read once, u
    (``u_item`` bytes: bf16) read and the output (``out_item``: f32)
    written once, 2 K flops a stored element, lane and direction (the
    transposed products of the strictly upper tiles), at ``peak`` (the
    bf16 tensor cores' unless given)."""
    B = idx.numel()
    P = int(idx.unique().numel())
    S = t * (nt * (nt + 1) // 2)
    T = nt * (nt + 1) // 2
    m = nt * t
    return bound_of(P * 2 * t * S * item + B * K * m * u_item
                    + B * K * 2 * m * out_item,
                    2 * K * B * (2 * t * S + 2 * t * t * (T - nt)), peak)


def bmm_ms(tri, nt, idx, U, dev, reps=10, dtype=None):
    """torch.bmm over the lanes' dense [M; C] in ``dtype`` (bf16 unless
    given; the library call that computes the tri matvec)."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri
    dtype = dtype or torch.bfloat16
    dense = flattri.dense_stacked(tri[idx.long()], nt).to(dtype)
    Ut = U.to(dtype).transpose(1, 2).contiguous()
    ms = time_ms(lambda: torch.bmm(dense, Ut), dev, reps)
    del dense
    return ms


def rows_oracle(chunks, nt, U):
    """The rows matvec in f64 through the dense [M; C] (exact for int8
    codes and bf16 values)."""
    from clipper_tpu_torch.ops import symstore
    Uc, scale = symstore._operand(chunks.dtype, U)
    return (Uc.double() @ dense_from_chunks(chunks, nt).double().T) * scale


def tile_problems(seed: int, dev):
    """TILE_W bunny problems at m=TILE_M on dev: (P1s, P2s, At)."""
    import torch
    from clipper_tpu_torch.bench import harness
    pcd0 = harness.load_bunny()
    rng = np.random.default_rng(seed)
    probs = [harness.make_problem(pcd0, TILE_M, RHO, rng)
             for _ in range(TILE_W)]
    D2s = np.stack([p[0] for p in probs]).astype(np.float32)
    As = np.stack([p[1] for p in probs]).astype(np.int32)
    P1s, P2s = endpoints(pcd0.astype(np.float32), D2s, As, dev)
    return P1s, P2s, torch.as_tensor(As, device=dev)


def tile_mtrues(W, m, dev):
    """m_true = m but on four problems: m - 1, m - 24, 2m / 3 and 513."""
    import torch
    mts = torch.full((W,), m, dtype=torch.int32, device=dev)
    mts[:4] = torch.tensor([m - 1, m - 24, 2 * m // 3, 513], device=dev)
    return mts


def check_builds_at(inv, P1s, P2s, At, mts, t, storage, label, dev):
    """Kernels 2 and 8 at tile t against the plain build (C exact, no M
    code differing) and byte-equal to each other; returns (kernel 2's
    storage, max |M diff|, kernel 2 ms, kernel 8 ms, bound)."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri
    W, m = At.shape[:2]
    nt = m // t

    def k2():
        return flattri.build_tri_cuda(inv, P1s, P2s, At, mts, t=t,
                                      storage_dtype=storage)

    def k8():
        return flattri.build_tri_fused_cuda(inv, P1s, P2s, At, mts, t=t,
                                            storage_dtype=storage)

    k = k2()
    err = check_build(k, flattri.build_tri_plain(
        inv, P1s, P2s, At, mts, t=t, storage_dtype=storage), t, label)
    same = bool(torch.equal(k8(), k))
    print(f"tri_build_fused vs tri_build ({label}): byte-equal={same}",
          flush=True)
    require(same, f"tri_build_fused ({label}) differs from tri_build")
    S = flattri.tri_ncols(nt, t)
    d = P1s.shape[2]
    item = torch.empty(0, dtype=storage).element_size()
    b_bytes = (W * 2 * t * S * item + 2 * W * m * d * 4 + W * m * 2 * 4
               + W * 4)
    ops = BUILD_OPS_PER_PAIR if d == 3 else PN_OPS_PER_PAIR
    bound_ms, bound_by = build_bound(b_bytes, W, m, ops)
    return (k, err, time_ms(k2, dev, 5), time_ms(k8, dev, 5),
            dict(bound_ms=bound_ms, bound_by=bound_by))


def phase_kernels_tiles(inv, pn_inv, dev):
    """Phase 2 at every tile the JAX package takes (the int8 / bf16
    kernels past t = 128 and 256). Kernels 1 and 9, int8 and bf16,
    at t in TRI_TILES on TILE_W=16 problems of m = t (2048 // t) built by
    kernel 2 (B=128 lanes, K=16 and K=1 for kernel 1; <= 1e-4 from the
    plain version, <= 1.1e-5 from an f64 oracle, a rerun bit for bit;
    kernel 9 bit-equal to kernel 1 at K=1), kernels 1 and 9 in f32 and
    f64 at t in FLOAT_TILES on TILE_W problems of m = t (1024 // t) (the
    same bars, f64 at 1e-12; kernel 9 bit-equal to kernel 1 at K=1 off
    its warp-row tiles 128 and 256); kernels 2 and 8, int8 and bf16, both
    invariants, at t in
    BUILD_TILES with m_true < m on four problems (C exact, 0 M codes
    differing, byte-equal to each other); kernels 3 and 7, int8 and bf16,
    at t in CAP_TILES on one problem of m = t (2048 // t) (rows at G=3),
    K=16 and K=1, whole and over D=3 slices (<= 1e-4 from the plain
    version, <= 1.1e-5 from an f64 oracle, reruns bit for bit). Each
    kernel's route, and its time at these shapes beside its bound, its
    plain version and its library call. Returns (max errors by kernel,
    {kernel: {"t=...": timing row}})."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri, symstore

    t0 = time.perf_counter()
    P1a, P2a, Aa = tile_problems(11, dev)
    pn = make_pn_problems(TILE_W, seed=11, m=PN_TILE_M)
    Q1a, Q2a = endpoints(*pn[:3], dev)
    Qa = torch.as_tensor(pn[2], device=dev)
    print(f"tile data: {TILE_W} bunny problems at m={TILE_M} and "
          f"{TILE_W} point-normal at m={PN_TILE_M} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(15)
    errs = {k: 0.0 for k in ("tri_matvec", "tri_tiles_matvec", "tri_build",
                             "tri_build_fused", "sym_rows_matvec",
                             "sym_tiles_matvec")}
    rows = {k: {} for k in errs}

    # kernels 2 and 8 past t = 256, both invariants and storages
    for t in BUILD_TILES:
        for kind, iv, X1, X2, XA in (("bunny", inv, P1a, P2a, Aa),
                                     ("point-normal", pn_inv, Q1a, Q2a, Qa)):
            m = t * (XA.shape[1] // t)
            mts = tile_mtrues(TILE_W, m, dev)
            for storage in (torch.int8, torch.bfloat16):
                name = str(storage).split(".")[-1]
                label = (f"{name} {kind}, W={TILE_W}, m={m}, t={t}, m_true "
                         "< m on 4")
                _, e, ms2, ms8, bound = check_builds_at(
                    iv, X1[:, :m], X2[:, :m], XA[:, :m], mts, t, storage,
                    label, dev)
                errs["tri_build"] = max(errs["tri_build"], e)
                key = f"t={t}" + ("" if kind == "bunny" else " pn") + (
                    "" if storage == torch.int8 else " bf16")
                shape = f"W={TILE_W}, m={m}"
                rows["tri_build"][key] = dict(ms=ms2, shape=shape, **bound)
                rows["tri_build_fused"][key] = dict(ms=ms8, shape=shape,
                                                    **bound)
                print(f"timing tri_build / tri_build_fused {label}: "
                      f"{ms2:.4f} / {ms8:.4f} ms, bound "
                      f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})",
                      flush=True)

    # kernels 1 and 9 at every new tile
    for t in TRI_TILES:
        m = tile_m(t)
        nt = m // t
        mts = torch.full((TILE_W,), m, dtype=torch.int32, device=dev)
        for storage in (torch.int8, torch.bfloat16):
            name = str(storage).split(".")[-1]
            tri = flattri.build_tri_cuda(inv, P1a[:, :m], P2a[:, :m],
                                         Aa[:, :m], mts, t=t,
                                         storage_dtype=storage)
            route = flattri.matvec_route(t, storage)
            for B, K in ((128, 16), (TILE_W, 1)):
                idx = torch.randint(0, TILE_W, (B,), generator=gen,
                                    device=dev, dtype=torch.int32)
                U = unit_rows(gen, B, K, dev, m)
                errs["tri_matvec"] = max(errs["tri_matvec"], check_matvec(
                    tri, nt, idx, U, f"{name}, route {route}, W={TILE_W}, "
                    f"m={m}, t={t}, B={B}, K={K}", oracle=True))
                if K == 16:
                    r = dict(route=route, shape=f"W={TILE_W}, m={m}, "
                             f"B={B}, K={K}",
                             **tri_matvec_bound(idx, K, t, nt,
                                                tri.element_size()))
                    r["ms"] = time_ms(lambda: flattri.tri_pool_matvec_cuda(
                        tri, nt, idx, U, torch.float32), dev, 20)
                    r["plain_ms"] = time_ms(
                        lambda: flattri.tri_pool_matvec_plain(
                            tri, nt, idx, U, torch.float32), dev, 2)
                    r["library_ms"] = bmm_ms(tri, nt, idx, U, dev)
                    rows["tri_matvec"][f"t={t}" + (
                        "" if storage == torch.int8 else " bf16")] = r
            idx = torch.randint(0, TILE_W, (128,), generator=gen, device=dev,
                                dtype=torch.int32)
            U = unit_rows(gen, 128, 1, dev, m)[:, 0]
            errs["tri_tiles_matvec"] = max(
                errs["tri_tiles_matvec"], check_tiles_matvec(
                    tri, nt, idx, U, f"{name}, route {route}, W={TILE_W}, "
                    f"m={m}, t={t}, B=128"))
            tl = flat_tiles(tri, nt)
            r = dict(route=route, shape=f"W={TILE_W}, m={m}, B=128",
                     **tri_matvec_bound(idx, 1, t, nt, tri.element_size()))
            r["ms"] = time_ms(lambda: flattri.tri_tiles_matvec_cuda(
                tl, nt, idx, U, torch.float32), dev, 20)
            r["plain_ms"] = time_ms(lambda: flattri.tri_tiles_matvec_plain(
                tl, nt, idx, U, torch.float32), dev, 2)
            r["library_ms"] = bmm_ms(tri, nt, idx, U[:, None], dev)
            rows["tri_tiles_matvec"][f"t={t}" + (
                "" if storage == torch.int8 else " bf16")] = r
            del tri, tl
    for name in ("tri_matvec", "tri_tiles_matvec"):
        for key, r in rows[name].items():
            print(f"timing {name} {key} ({r['shape']}, route {r['route']}): "
                  f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, bmm "
                  f"over dense bf16 [M; C] {r['library_ms']:.4f} ms",
                  flush=True)

    # kernels 1 and 9's float kinds at FLOAT_TILES (kernel 1's CUDA-core
    # kernel; kernel 9's too but at t = 128, 256: its warp-row kernel),
    # TILE_W problems of m = t (1024 // t), B=128 lanes: kernel 1 at K=16
    # and kernel 9 at one probe, checked and timed, and kernel 1 at K=1
    # timed beside kernel 9
    for t in FLOAT_TILES:
        m = t * (TILE_M // 2 // t)
        nt = m // t
        mts = torch.full((TILE_W,), m, dtype=torch.int32, device=dev)
        for dtype, kind, peak in ((torch.float32, "f32", F32_FLOPS),
                                  (torch.float64, "f64", F64_FLOPS)):
            tri_f = flattri.build_tri_plain(inv, P1a[:, :m].to(dtype),
                                            P2a[:, :m].to(dtype), Aa[:, :m],
                                            mts, t=t, storage_dtype=None)
            route = flattri.matvec_route(t, dtype)
            item = tri_f.element_size()
            idx = torch.randint(0, TILE_W, (128,), generator=gen,
                                device=dev, dtype=torch.int32)
            U = unit_rows(gen, 128, 16, dev, m).to(dtype)
            shape = f"W={TILE_W}, m={m}, B=128"
            errs["tri_matvec"] = max(errs["tri_matvec"], check_matvec(
                tri_f, nt, idx, U, f"{kind}, route {route}, {shape}, t={t}, "
                "K=16", oracle=True))
            r = dict(route=route, shape=f"{shape}, K=16",
                     **tri_matvec_bound(idx, 16, t, nt, item, item, item,
                                        peak))
            r["ms"] = time_ms(lambda: flattri.tri_pool_matvec_cuda(
                tri_f, nt, idx, U, dtype), dev, 10)
            r["plain_ms"] = time_ms(lambda: flattri.tri_pool_matvec_plain(
                tri_f, nt, idx, U, dtype), dev, 2)
            r["library_ms"] = bmm_ms(tri_f, nt, idx, U, dev, dtype=dtype)
            rows["tri_matvec"][f"t={t} {kind}"] = r
            U1 = U[:, 0].contiguous()
            errs["tri_tiles_matvec"] = max(
                errs["tri_tiles_matvec"], check_tiles_matvec(
                    tri_f, nt, idx, U1, f"{kind}, route {route}, {shape}, "
                    f"t={t}"))
            tl = flat_tiles(tri_f, nt)
            r = dict(route=route, shape=f"{shape}, one probe",
                     **tri_matvec_bound(idx, 1, t, nt, item, item, item,
                                        peak))
            r["ms"] = time_ms(lambda: flattri.tri_tiles_matvec_cuda(
                tl, nt, idx, U1, dtype), dev, 10)
            r["plain_ms"] = time_ms(lambda: flattri.tri_tiles_matvec_plain(
                tl, nt, idx, U1, dtype), dev, 2)
            r["library_ms"] = bmm_ms(tri_f, nt, idx, U1[:, None], dev,
                                     dtype=dtype)
            r["k1_ms"] = time_ms(lambda: flattri.tri_pool_matvec_cuda(
                tri_f, nt, idx, U1[:, None], dtype), dev, 10)
            rows["tri_tiles_matvec"][f"t={t} {kind}"] = r
            for name in ("tri_matvec", "tri_tiles_matvec"):
                q = rows[name][f"t={t} {kind}"]
                print(f"timing {name} t={t} {kind} ({q['shape']}, route "
                      f"{route}): kernel {q['ms']:.4f} ms, bound "
                      f"{q['bound_ms']:.4f} ms ({q['bound_by']}), plain "
                      f"{q['plain_ms']:.4f} ms, torch.bmm over the dense "
                      f"{kind} [M; C] (TF32 off) {q['library_ms']:.4f} ms"
                      + (f", kernel 1 at K=1 {q['k1_ms']:.4f} ms"
                         if "k1_ms" in q else ""), flush=True)
            del tri_f, tl

    # kernels 3 and 7 at every new tile: one problem, m = t (2048 // t)
    for t in CAP_TILES:
        m = tile_m(t)
        nt = m // t
        prob = one_problem(m, RHO, seed=t)
        for storage in (torch.int8, torch.bfloat16):
            name = str(storage).split(".")[-1]
            route = symstore.matvec_route(t, storage)
            chunks = rows_storage(inv, prob, dev, G=TILE_G, storage=storage,
                                  tile=t)
            tl = tiles_storage(inv, prob, dev, storage, tile=t)
            for K in (16, 1):
                U = unit_rows(gen, 1, K, dev, m)[0]
                label = (f"{name}, route {route}, m={m}, t={t}, "
                         f"G={TILE_G}, K={K}")
                errs["sym_rows_matvec"] = max(
                    errs["sym_rows_matvec"],
                    check_rows(chunks, nt, U, label),
                    check_rows_slices(chunks, nt, U, label))
                errs["sym_tiles_matvec"] = max(
                    errs["sym_tiles_matvec"], check_tiles(tl, nt, U, label))
                for kname, y, o in (
                        ("sym_rows_matvec",
                         symstore.sym_rows_matvec_cuda(chunks, nt, U),
                         rows_oracle(chunks, nt, U)),
                        ("sym_tiles_matvec",
                         symstore.sym_tiles_matvec_cuda(tl, nt, U),
                         tiles_oracle(tl, nt, U))):
                    e_o = float((y.double() - o).abs().max())
                    print(f"{kname} {label}: max|kernel - f64 oracle|="
                          f"{e_o:.3e}", flush=True)
                    require(e_o <= ORACLE_TOL, f"{kname} {label} exceeds "
                            f"{ORACLE_TOL} against the f64 oracle")
                if K != 16:
                    continue
                T = nt * (nt + 1) // 2
                item = chunks.element_size()
                bound = bound_of(T * 2 * t * t * item + K * m * 2
                                 + K * 2 * m * 4,
                                 2 * K * 2 * t * t * (2 * T - nt))
                dense = dense_from_tiles(tl, nt, torch.bfloat16)
                Ut = U.to(torch.bfloat16).T.contiguous()
                lib = time_ms(lambda: torch.matmul(dense, Ut), dev, 10)
                del dense
                key = f"t={t}" + ("" if storage == torch.int8 else " bf16")
                rp = symstore.rows_device_plan(chunks, nt)
                tp = symstore.tiles_device_plan(tl, nt)
                for kname, kern, plain in (
                        ("sym_rows_matvec",
                         lambda: symstore.sym_rows_matvec_cuda(
                             chunks, nt, U, plan=rp),
                         lambda: symstore.sym_rows_matvec_plain(chunks, nt,
                                                                U)),
                        ("sym_tiles_matvec",
                         lambda: symstore.sym_tiles_matvec_cuda(
                             tl, nt, U, plan=tp),
                         lambda: symstore.sym_tiles_matvec_plain(tl, nt,
                                                                 U))):
                    r = dict(route=route, shape=f"m={m}, K={K}" + (
                        f", G={TILE_G}" if kname == "sym_rows_matvec"
                        else ""), ms=time_ms(kern, dev, 10),
                             plain_ms=time_ms(plain, dev, 2),
                             library_ms=lib, **bound)
                    rows[kname][key] = r
                    print(f"timing {kname} {key} ({r['shape']}, route "
                          f"{route}, its plan made beforehand): kernel "
                          f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                          f"({r['bound_by']}), plain {r['plain_ms']:.4f} "
                          f"ms, matmul over dense bf16 [M; C] "
                          f"{r['library_ms']:.4f} ms", flush=True)
            del chunks, tl

    # kernels 3 and 7 over f32 and f64 storage at t=128 (the CUDA-core
    # kernel of csrc/sym_core.cuh in f64, their one route)
    t = 128
    m = tile_m(t)
    nt = m // t
    T = nt * (nt + 1) // 2
    prob = one_problem(m, RHO, seed=t)
    for dtype, kind, peak in ((torch.float32, "f32", F32_FLOPS),
                              (torch.float64, "f64", F64_FLOPS)):
        chunks = rows_storage(inv, prob, dev, G=TILE_G, storage=dtype, tile=t)
        tl = tiles_storage(inv, prob, dev, dtype, tile=t)
        U = unit_rows(gen, 1, 16, dev, m)[0].to(dtype)
        label = f"{kind}, route float, m={m}, t={t}, G={TILE_G}, K=16"
        errs["sym_rows_matvec"] = max(errs["sym_rows_matvec"],
                                      check_rows(chunks, nt, U, label))
        errs["sym_tiles_matvec"] = max(errs["sym_tiles_matvec"],
                                       check_tiles(tl, nt, U, label))
        bound = bound_of(T * 2 * t * t * chunks.element_size()
                         + 16 * m * U.element_size() + 16 * 2 * m * 4,
                         2 * 16 * 2 * t * t * (2 * T - nt), peak)
        dense = dense_from_tiles(tl, nt, dtype)
        Ut = U.T.contiguous()
        lib = time_ms(lambda: torch.matmul(dense, Ut), dev, 10)
        del dense
        rp = symstore.rows_device_plan(chunks, nt)
        tp = symstore.tiles_device_plan(tl, nt)
        for kname, kern, plain in (
                ("sym_rows_matvec",
                 lambda: symstore.sym_rows_matvec_cuda(chunks, nt, U,
                                                       plan=rp),
                 lambda: symstore.sym_rows_matvec_plain(chunks, nt, U)),
                ("sym_tiles_matvec",
                 lambda: symstore.sym_tiles_matvec_cuda(tl, nt, U, plan=tp),
                 lambda: symstore.sym_tiles_matvec_plain(tl, nt, U))):
            r = dict(route="float", shape=f"m={m}, K=16" + (
                f", G={TILE_G}" if kname == "sym_rows_matvec" else ""),
                ms=time_ms(kern, dev, 10), plain_ms=time_ms(plain, dev, 2),
                library_ms=lib, **bound)
            rows[kname][f"t={t} {kind}"] = r
            print(f"timing {kname} t={t} {kind} ({r['shape']}, route "
                  f"float): kernel {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f} ms, matmul over dense {kind} "
                  f"[M; C] (TF32 off) {r['library_ms']:.4f} ms", flush=True)
        del chunks, tl
    torch.cuda.empty_cache()
    return errs, rows


def phase_tiles(inv, main, cap, cap_mask, dry, dev):
    """12, "tiles": the paths over tiles the card took only at 128 and 256
    before. (a) bench.py's tri pool protocol (the W=512 problems) at
    tri_tile 64 and 512 in int8 and at 512 in bf16, each beside t=256 in
    turns: one counted call (the warm-up: the build kernel launched once,
    the matvec by its route, ops/flattri.matvec_route), then two rounds of
    one timed call each, in turns; the P/R bars; kernel 1 at B=128, K=16
    and kernel 2 on the same W=512 storage at each tile. (b) The m=65,536
    capacity problem at tile=256 through the facade, row-chunked (auto)
    and tile list: the P/R bars, IoU >= 0.95 with phase 4's t=128 mask,
    kernels 3 and 7 (and their reductions) launched; then kernels 3 and 7
    at t=256 on its storage, K=16 and K=1, against their plain versions,
    timed beside their bound and torch.matmul. (c) Phase 11 (d)'s
    dryrun_multichip(2) ran at the JAX shapes (m=64, tiles of 16). (d)
    The same capacity problem at tile=64, kernels 3 and 7 by the unit
    kernel over super-tiles (:func:`capacity_core_tile`). Returns {kernel:
    {"...": timing row}} for the kernels' line."""
    import torch
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import flattri, symstore

    t_phase = time.perf_counter()
    D1, D2s, As, Agts, u0s = main
    rows = {k: {} for k in ("tri_matvec", "tri_build", "sym_rows_matvec",
                            "sym_tiles_matvec")}
    # (a) the tri pool at each tile, beside t=256 in turns
    cfgs = [(torch.int8, 256), (torch.int8, 64), (torch.int8, 512),
            (torch.bfloat16, 256), (torch.bfloat16, 512)]

    def run(storage, t, timings=None):
        return run_pipeline(inv, main, dev, W_MAIN, timings=timings,
                            storage=storage, tri_tile=t)

    secs = {}
    keys = [_kernels.route_key("tri_matvec", r)
            for r in ("mma", "super", "core")]
    for storage, t in cfgs:
        name = str(storage).split(".")[-1]
        sol, launches = counted_call(lambda: run(storage, t))
        P, R = check_quality(f"tri pool {name} t={t}", As, sol, Agts, W_MAIN)
        route = flattri.matvec_route(t, storage)
        key = _kernels.route_key("tri_matvec", route)
        print(f"tri pool {name} tri_tile={t}: W={W_MAIN} m={M}: precision="
              f"{P * 100:.2f}% recall={R * 100:.2f}%; kernel 1 route "
              f"{route}; launches by route key: " + ", ".join(
                  f"{k} {launches[k]}" for k in keys)
              + f"; tri_build {launches['tri_build']}", flush=True)
        require(launches["tri_build"] == 1 and launches[key] > 0
                and all(launches[k] == 0 for k in keys if k != key),
                f"tri pool {name} t={t}: tri_build once and only {key} "
                f"expected: {launches}")
        secs[(storage, t)] = []
    timings = {}
    for _ in range(2):
        for storage, t in cfgs:
            tm = {}
            _, sec = timed_calls(lambda: run(storage, t, tm), 1)
            secs[(storage, t)].append(sec)
            timings[(storage, t)] = tm
    for storage, t in cfgs:
        name = str(storage).split(".")[-1]
        sec = sum(secs[(storage, t)]) / 2
        base = sum(secs[(storage, 256)]) / 2
        print(f"tri pool {name} t={t}: {W_MAIN / sec:.1f} problems/s "
              f"({sec * 1e3:.1f} ms/batch, mean of 2 in turns) beside t=256 "
              f"{W_MAIN / base:.1f}; stage ms (last call) "
              + ", ".join(f"{k}={v:.3f}" for k, v in
                          timings[(storage, t)].items()), flush=True)

    # kernels 1 and 2 at each pool tile, on the W=512 storage
    P1s, P2s = endpoints(D1, D2s, As, dev)
    At = torch.as_tensor(As, device=dev)
    mts = torch.full((W_MAIN,), M, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    B = min(128, W_MAIN)
    idx = torch.randperm(W_MAIN, generator=gen, device=dev)[:B].to(
        torch.int32)
    U = unit_rows(gen, B, 16, dev)
    for t in (256, *POOL_TILES):
        nt = M // t
        S = flattri.tri_ncols(nt, t)

        def build():
            return flattri.build_tri_cuda(inv, P1s, P2s, At, mts, t=t)

        tri = build()
        b_bytes = (W_MAIN * 2 * t * S + 2 * W_MAIN * M * 3 * 4
                   + W_MAIN * M * 2 * 4 + W_MAIN * 4)
        bound_ms, bound_by = build_bound(b_bytes, W_MAIN, M,
                                         BUILD_OPS_PER_PAIR)
        shape = f"W={W_MAIN}, m={M}"
        rb = dict(ms=time_ms(build, dev, 5), shape=shape, bound_ms=bound_ms,
                  bound_by=bound_by)
        route = flattri.matvec_route(t, torch.int8)
        rm = dict(route=route, shape=f"{shape}, B={B}, K=16",
                  ms=time_ms(lambda: flattri.tri_pool_matvec_cuda(
                      tri, nt, idx, U, torch.float32), dev, 20),
                  plain_ms=time_ms(lambda: flattri.tri_pool_matvec_plain(
                      tri, nt, idx, U, torch.float32), dev, 2),
                  library_ms=bmm_ms(tri, nt, idx, U, dev),
                  **tri_matvec_bound(idx, 16, t, nt, tri.element_size()))
        print(f"timing at tri_tile={t} ({shape}): tri_build {rb['ms']:.4f} "
              f"ms (bound {bound_ms:.4f}, {bound_by}); tri_matvec B={B} "
              f"K=16 route {route} {rm['ms']:.4f} ms (bound "
              f"{rm['bound_ms']:.4f}, {rm['bound_by']}), plain "
              f"{rm['plain_ms']:.4f}, bmm {rm['library_ms']:.4f}",
              flush=True)
        if t != 256:
            rows["tri_build"][f"t={t} {shape}"] = rb
            rows["tri_matvec"][f"t={t} {shape}"] = rm
        del tri
    del P1s, P2s

    # (b) the capacity engine at tile=256
    m, Agt = len(cap[2]), cap[3]
    for engine, opts, kernel in (
            ("auto", {"tile": CAP_TILE}, "sym_rows_matvec"),
            ("triangle", {"tile": CAP_TILE, "matvec": "xla"},
             "sym_tiles_matvec")):
        run_c = capacity_solve(inv, cap, dev, engine, opts)
        label = f"capacity path ({engine}, t={CAP_TILE})"
        mask, _ = report_capacity(label, run_c, Agt, kernel)
        iou = mask_iou(mask, cap_mask)
        print(f"{label}: IoU with phase 4's t={ROWS_T} mask {iou:.4f}",
              flush=True)
        require(iou >= CAP_TILE_IOU, f"{label}: IoU {iou:.4f} with the "
                f"t={ROWS_T} mask < {CAP_TILE_IOU}")
        del run_c
    for name in ("sym_rows_matvec", "sym_tiles_matvec"):
        r, _ = time_capacity(name, inv, cap, dev, t=CAP_TILE,
                             storages=(torch.int8,))
        r = dict(r, route=symstore.matvec_route(CAP_TILE, torch.int8),
                 shape=f"m={m}, K=16" + (", G=32" if name == "sym_rows_matvec"
                                         else ""))
        rows[name][f"t={CAP_TILE} m={m}"] = r
    torch.cuda.empty_cache()
    for name, r in capacity_core_tile(inv, cap, cap_mask, dev, rows).items():
        rows[name].update(r)

    # (c) the dry run at the JAX shapes
    print(f"dryrun_multichip(2) on the card at m={dry['m']}, tile="
          f"{dry['tile']} (phase 11 (d))", flush=True)
    require(dry["m"] == 64 and dry["tile"] == 16, f"the dry run ran at "
            f"m={dry['m']}, tile={dry['tile']}, not the JAX shapes")
    print(f"tiles: {time.perf_counter() - t_phase:.1f} s on {gpu_line()}",
          flush=True)
    return rows


def capacity_core_tile(inv, cap, cap_mask, dev, lib_rows):
    """Phase 12 (d): the m=65,536 capacity problem at tile=CAP_CORE_TILE,
    a multiple of 16 but not of 128, so kernels 3 and 7 run the unit
    kernel over super-tiles of 64-row tiles (ops/symstore.matvec_route
    "units", their "core" keys not launched). Through the facade,
    row-chunked (auto) and tile list: the P/R bars, IoU >= CAP_TILE_IOU
    with phase 4's t=128 mask, the route's key and the reduction launched
    (their launches a solve kept), the warm call's stage ms; then kernels
    3 and 7 at that tile on its int8 storage: K=16 against the plain
    version (the tile list also over D=3 slices), a rerun bit for bit,
    then timed at K=16 and K=1 beside their bound, the plain version and
    the torch.matmul of ``lib_rows``' t=CAP_TILE rows (the same dense
    product, timed in (b)). Returns {kernel: {"t=64 m=65536": timing
    row}}."""
    import torch
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import symstore

    t = CAP_CORE_TILE
    m, Agt = len(cap[2]), cap[3]
    nt = m // t
    T = nt * (nt + 1) // 2
    route = symstore.matvec_route(t, torch.int8)
    solve = {}
    for engine, opts, kernel in (
            ("auto", {"tile": t}, "sym_rows_matvec"),
            ("triangle", {"tile": t, "matvec": "xla"}, "sym_tiles_matvec")):
        t0 = time.perf_counter()
        run_c = capacity_solve(inv, cap, dev, engine, opts)
        label = f"capacity path ({engine}, t={t})"
        mask, _ = report_capacity(label, run_c, Agt, kernel, route=route)
        stats, launches = run_c[2], run_c[3]
        solve[kernel] = dict(
            launches=launches[_kernels.route_key(kernel, route)],
            reduce_launches=launches[_kernels.REDUCTIONS[kernel]],
            warm_s=run_c[4], stage_ms={k: stats[k] for k in (
                "build", "init", "solve", "polish")})
        iou = mask_iou(mask, cap_mask)
        print(f"{label}: IoU with phase 4's t={ROWS_T} mask {iou:.4f}; the "
              f"build and both calls {time.perf_counter() - t0:.1f} s",
              flush=True)
        require(iou >= CAP_TILE_IOU, f"{label}: IoU {iou:.4f} with the "
                f"t={ROWS_T} mask < {CAP_TILE_IOU}")
        del run_c
    gen = torch.Generator(device=dev).manual_seed(t)
    Us = {K: unit_rows(gen, 1, K, dev, m)[0] for K in (16, 1)}
    out = {}
    for name in ("sym_rows_matvec", "sym_tiles_matvec"):
        rows_layout = name == "sym_rows_matvec"
        if rows_layout:
            store = rows_storage(inv, cap, dev, G=32, tile=t)
            plan = symstore.rows_device_plan(store, nt)

            def kern(U):
                return symstore.sym_rows_matvec_cuda(store, nt, U, plan=plan)

            def plain(U):
                return symstore.sym_rows_matvec_plain(store, nt, U)
        else:
            store = tiles_storage(inv, cap, dev, tile=t)
            plan = symstore.tiles_device_plan(store, nt)

            def kern(U):
                return symstore.sym_tiles_matvec_cuda(store, nt, U,
                                                      plan=plan)

            def plain(U):
                return symstore.sym_tiles_matvec_plain(store, nt, U)
        label = f"int8, route {route}, m={m}, t={t}, K=16"
        err = (check_rows(store, nt, Us[16], label) if rows_layout
               else check_tiles(store, nt, Us[16], label))
        by_k = {K: dict(ms=time_ms(lambda: kern(Us[K]), dev, 3),
                        **bound_of(T * 2 * t * t + K * m * 2 + K * 2 * m * 4,
                                   2 * K * 2 * t * t * (2 * T - nt)))
                for K in (16, 1)}
        row = dict(by_k[16], route=route, shape=f"m={m}, K=16" + (
            ", G=32" if rows_layout else ""),
                   plain_ms=time_ms(lambda: plain(Us[16]), dev, 1),
                   library_ms=lib_rows[name][f"t={CAP_TILE} m={m}"][
                       "library_ms"], K1=by_k[1], max_abs_err=err,
                   **solve[name])
        print(f"timing {name} int8 m={m} t={t} (route {route}, its plan made "
              f"beforehand): K=16 {row['ms']:.4f} ms, K=1 "
              f"{by_k[1]['ms']:.4f} ms, bound {row['bound_ms']:.4f} / "
              f"{by_k[1]['bound_ms']:.4f} ms ({row['bound_by']}), plain "
              f"{row['plain_ms']:.4f} ms, matmul over dense bf16 [M; C] "
              f"(t={CAP_TILE}'s) {row['library_ms']:.4f} ms", flush=True)
        out[name] = {f"t={t} m={m}": row}
        del store, plan
        torch.cuda.empty_cache()
    return out


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


def user_invariants(inv):
    """The two sample device scores of bench/user_scores.py beside the
    built-in they stand for (None for PlanarCauchy), their endpoints'
    width and their f32 operations a pair."""
    from clipper_tpu_torch.bench import user_scores
    return {"user_euclidean": (user_scores.UserEuclidean(inv.params), inv,
                               3, BUILD_OPS_PER_PAIR),
            "planar_cauchy": (user_scores.PlanarCauchy(), None, 2,
                              CAUCHY_OPS_PER_PAIR)}


def user_builds_at(uinv, binv, P1s, P2s, At, mts, t, ops, label, dev):
    """Kernels 2, 8 and 4 over a device score at one shape, int8 and bf16:
    kernel 2 against its plain version (C exact, 0 M codes differing),
    kernel 8 byte-equal to kernel 2, kernel 4 against its plain version
    (check_stored), one launch each under its user key; then each timed
    beside the built-in Euclidean kernel on the same inputs (``binv``),
    its bound and its plain version. Returns {kernel: row} (int8; bf16
    under "bf16") and the largest |M| difference."""
    import torch
    from clipper_tpu_torch import _kernels
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import affinity_pallas, flattri
    from clipper_tpu_torch.ops.affinity import stored_from_endpoints

    W, m, d = P1s.shape
    in_bytes = 2 * W * m * d * 4 + W * m * 2 * 4 + W * 4
    rows, err = {}, 0.0
    for storage in (torch.int8, torch.bfloat16):
        sname = "int8" if storage == torch.int8 else "bf16"
        kw = dict(t=t, storage_dtype=storage)
        fns = {"tri_build": lambda i: flattri.build_tri_cuda(
                   i, P1s, P2s, At, mts, **kw),
               "tri_build_fused": lambda i: flattri.build_tri_fused_cuda(
                   i, P1s, P2s, At, mts, **kw),
               "stored_build": lambda i: affinity_pallas.stored_build_cuda(
                   i, P1s, P2s, At, mts, storage_dtype=storage)}
        _kernels.reset_launches()
        tri = fns["tri_build"](uinv)
        plain = lambda: flattri.build_tri_plain(uinv, P1s, P2s, At, mts, **kw)
        err = max(err, check_build(tri, plain(), t, f"user {label} {sname}"))
        same = bool(torch.equal(fns["tri_build_fused"](uinv), tri))
        print(f"tri_build_fused_user vs tri_build_user ({label} {sname}): "
              f"byte-equal={same}", flush=True)
        require(same, f"tri_build_fused_user differs ({label} {sname})")
        del tri
        _, e = check_stored(uinv, P1s, P2s, At, mts, storage,
                            f"user {label} {sname}")
        err = max(err, e)
        launched = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        require(launched == {f"{k}_user": 1 for k in fns},
                f"user {label} {sname}: launches {launched}")
        torch.cuda.empty_cache()
        plains = {"tri_build": plain, "tri_build_fused": plain,
                  "stored_build": lambda: stored_from_endpoints(
                      uinv, P1s, P2s, At, m_true=mts, storage_dtype=storage)}
        S = flattri.tri_ncols(m // t, t)
        for k, fn in fns.items():
            out = (2 * m * m if k == "stored_build" else 2 * t * S)
            bound_ms, bound_by = build_bound(
                W * out * storage.itemsize + in_bytes, W, m, ops)
            r = dict(ms=time_ms(lambda: fn(uinv), dev, 10),
                     builtin_ms=(time_ms(lambda: fn(binv), dev, 10)
                                 if binv is not None else None),
                     plain_ms=time_ms(plains[k], dev, 2), bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None)
            torch.cuda.empty_cache()
            builtin = (f", the built-in Euclidean {r['builtin_ms']:.4f} ms"
                       if binv is not None else "")
            print(f"timing {k}_user {label} {sname}: kernel {r['ms']:.4f} ms"
                  f"{builtin}, bound {bound_ms:.4f} ms ({bound_by}), plain "
                  f"{r['plain_ms']:.4f} ms", flush=True)
            if storage == torch.int8:
                rows[k] = r
            else:
                rows[k]["bf16"] = r
    return rows, err


def user_dense_at(uinv, binv, P1, P2, A, ops, label, dev):
    """Kernel 6 over a device score on one problem, f32 and f64: against
    its plain version (check_dense), timed through its wrapper as the
    facade calls it, beside the built-in Euclidean's, its bound and its
    plain version. Returns the f32 row (f64 under "f64") and the largest
    |M| difference."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.ops import affinity_pallas
    from clipper_tpu_torch.ops.affinity import pairwise_from_endpoints

    m, d = P1.shape
    row, err = None, 0.0
    for dtype, peak in ((torch.float32, F32_FLOPS),
                        (torch.float64, F64_SIMT_FLOPS)):
        name = "f32" if dtype == torch.float32 else "f64"
        p1, p2 = P1.to(dtype), P2.to(dtype)
        err = max(err, check_dense(uinv, p1, p2, A, f"user {label} {name}"))
        item = dtype.itemsize
        r = dict(ms=time_ms(lambda: affinity_pallas.affinity_build_cuda(
                     uinv, p1, p2, A), dev, 10),
                 builtin_ms=(time_ms(lambda: affinity_pallas.
                                     affinity_build_cuda(binv, p1, p2, A),
                                     dev, 10)
                             if binv is not None else None),
                 plain_ms=time_ms(lambda: pairwise_from_endpoints(
                     uinv, p1, p2, A), dev, 2),
                 **bound_of(2 * m * m * item + 2 * m * d * item + m * 2 * 4,
                            m * (m - 1) // 2 * ops, peak),
                 library_ms=None)
        builtin = (f", the built-in Euclidean {r['builtin_ms']:.4f} ms"
                   if binv is not None else "")
        print(f"timing affinity_build_user {label} {name}: kernel "
              f"{r['ms']:.4f} ms{builtin}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms", flush=True)
        if row is None:
            row = r
        else:
            row["f64"] = r
    return row, err


PGA_M, PGA_W = 2048, 4        # the dense PGA kernel: the benchmark's m
PGA_F64_TOL = 1e-10           # f64: u and F (relative) against the host loop
PGA_F32_TOL = 1e-4            # f32: F (relative) against the host loop


def pga_reversed_operators(M, C):
    """dense_operators with each product summed in reverse column order:
    the host loop with its sums in another order."""
    from clipper_tpu_torch.solvers import msrc

    def mv(A):
        return lambda u: (A * u).flip(-1).sum(-1)

    return msrc.PGAOperators(mv_M=mv(M), mv_C=mv(C),
                             make_mv_Md=lambda d: mv(M + d * C))


def pga_traced(fn):
    """fn()'s result and the PGA's published (trials, inner steps, outer
    passes), fn run under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from clipper_tpu_torch.utils import profiling
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    c = profiling.totals()["counters"]
    profiling.reset()
    return out, (c["pga.linesearch_steps"], c["pga.inner_steps"],
                 c["pga.outer_steps"])


def check_pga(M, C, u0, params, kern, host):
    """The kernel's solve against the host loop's on the same tensors, at
    tests/test_torch_pga_device.py's tolerances. f64: the host loop's
    ifinal, mask, inner steps and outer passes, F within PGA_F64_TOL, and
    its trials and u within PGA_F64_TOL, or, where the host loop's own
    run moves when its sums are reversed, no farther from it than twice
    the reversed run. f32: F within PGA_F32_TOL and the host loop's mask,
    or one that differs by no more vertices than the reversal moves the
    host loop's. Returns max |u - u_host|."""
    import torch
    from clipper_tpu_torch.solvers import msrc
    (u, F, i), counts = kern
    (uh, Fh, ih), counts_h = host
    du = float((u - uh).abs().max())
    rel = abs(float(F) - float(Fh)) / abs(float(Fh))
    mask, mask_h = msrc.round_solution(u, F), msrc.round_solution(uh, Fh)
    rev = None
    if M.dtype == torch.float64:
        require(int(i) == int(ih) and counts[1:] == counts_h[1:]
                and torch.equal(mask, mask_h) and rel <= PGA_F64_TOL,
                f"pga_dense f64: ifinal {int(i)} / {int(ih)}, counts "
                f"{counts} / {counts_h}, F {rel:.2e} apart, masks equal "
                f"{torch.equal(mask, mask_h)}")
        if counts[0] != counts_h[0] or du > PGA_F64_TOL:
            (ur, _, _), counts_r = rev = pga_traced(lambda: msrc.run_pga(
                pga_reversed_operators(M, C), u0, params, dtype=M.dtype))
            dr = float((ur - uh).abs().max())
            require(du <= 2 * dr and abs(counts[0] - counts_h[0])
                    <= 2 * abs(counts_r[0] - counts_h[0]),
                    f"pga_dense f64: u {du:.2e} and {counts[0]} trials "
                    f"against the host loop's {counts_h[0]}, which moves "
                    f"{dr:.2e} and to {counts_r[0]} reversed")
    else:
        require(rel <= PGA_F32_TOL, f"pga_dense f32: F {rel:.2e} apart")
        if not torch.equal(mask, mask_h):
            (ur, Fr, _), _ = rev = pga_traced(lambda: msrc.run_pga(
                pga_reversed_operators(M, C), u0, params, dtype=M.dtype))
            moved = int((msrc.round_solution(ur, Fr) ^ mask_h).sum())
            require(int((mask ^ mask_h).sum()) <= moved,
                    f"pga_dense f32: the mask moves "
                    f"{int((mask ^ mask_h).sum())} vertices, the host "
                    f"loop's reversed {moved}")
    return du, rev is not None


def l2_read_rate(n_bytes, dtype, dev, reps=50):
    """Bytes a second of an L2-resident read of n_bytes: the faster of
    torch.mv over, and a sum of, one (m, m) matrix of that size, ``reps``
    calls back to back captured in one CUDA graph, so that the host's
    launches do not pace them (CUDA events over the graph's replays)."""
    import torch
    from clipper_tpu_torch.bench.harness import time_ms
    m = int(round((n_bytes / torch.empty((), dtype=dtype).element_size())
                  ** 0.5))
    A = torch.rand(m, m, dtype=dtype, device=dev)
    x = torch.rand(m, dtype=dtype, device=dev)
    best = float("inf")
    for op in (lambda: torch.mv(A, x), lambda: A.sum()):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                op()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                op()
        best = min(best, time_ms(graph.replay, dev, 5) / reps)
        del graph
    del A
    return n_bytes / (best * 1e-3)


def pga_bound(m, itemsize, trials, outer, l2_rate):
    """(bound_ms, bound_hbm_ms) of one solve: its matrix passes' bytes,
    the rescale's M, M and C for the first d, each outer pass's
    formation of Md (M, C read, Md written) and d terms (M, C) at
    HBM_BYTES_PER_S, and one Md a line-search trial at the faster of
    l2_rate and HBM_BYTES_PER_S (bound_ms) or at HBM_BYTES_PER_S
    (bound_hbm_ms)."""
    pass_bytes = m * m * itemsize
    hbm_s = (3 + 5 * outer) * pass_bytes / HBM_BYTES_PER_S
    trial_bytes = trials * pass_bytes
    trial_rate = max(l2_rate, HBM_BYTES_PER_S)
    return ((hbm_s + trial_bytes / trial_rate) * 1e3,
            (hbm_s + trial_bytes / HBM_BYTES_PER_S) * 1e3)


def phase_pga_dense(inv, dev):
    """14: the dense PGA kernel (csrc/pga_dense.cu) on PGA_W bunny
    problems at m = PGA_M, rho = RHO, in f32 and f64, M and C from the
    facade's build on the card: each msrc.find_dense_clique solve held
    against the host loop (run_pga over dense_operators) on the same CUDA
    tensors (check_pga); the main path's run, Clipper.solve on the first
    f32 problem under the profiler with the launch counts set to 0 just
    before it, launches pga_dense once and no other kernel; each solve
    timed (CUDA events, 20 solves) beside the host loop (2) and its bound
    (pga_bound from its own counts, the trials' Md at the L2 read rate
    measured here, l2_read_rate). Returns (the kernels' row: f32 medians, f64 under
    "f64", each problem under "problems"; launches; max |u - u_host|)."""
    import statistics
    import torch
    from clipper_tpu_torch import Clipper, _kernels
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.solvers import msrc
    from clipper_tpu_torch.types import Params

    params = Params()
    out, err, launches = {}, 0.0, None
    for dtype in (torch.float32, torch.float64):
        kind = str(dtype).split(".")[-1]
        itemsize = torch.empty((), dtype=dtype).element_size()
        l2 = l2_read_rate(PGA_M * PGA_M * itemsize, dtype, dev)
        probs = []
        for seed in range(PGA_W):
            pcd0, pcd1, A, _, u0 = one_problem(PGA_M, RHO, seed)
            c = Clipper(inv, params, dtype=dtype, device=dev)
            c.score_pairwise_consistency(pcd0.T, pcd1.T, A)
            M, C = c._M, c._C
            u0 = torch.as_tensor(u0, dtype=dtype, device=dev)
            if launches is None:
                c.solve(u0)                     # the library and its grid
                torch.cuda.synchronize()
                _kernels.reset_launches()
                soln, _ = pga_traced(lambda: c.solve(u0))
                torch.cuda.synchronize()
                launches = dict(_kernels.LAUNCHES)
                require(launches["pga_dense"] == 1 and not any(
                    n for k, n in launches.items() if k != "pga_dense"),
                    f"Clipper.solve's launches {launches}")
            kern = pga_traced(lambda: msrc.find_dense_clique(M, C, u0,
                                                             params))
            host = pga_traced(lambda: msrc.run_pga(
                msrc.dense_operators(M, C), u0, params, dtype=dtype))
            if dtype == torch.float32 and seed == 0:
                require(torch.equal(soln.mask, msrc.round_solution(
                    *kern[0][:2])), "Clipper.solve's mask is not "
                    "find_dense_clique's")
            du, reversed_ = check_pga(M, C, u0, params, kern, host)
            err = max(err, du)
            trials, inner, outer = kern[1]
            bound_ms, bound_hbm_ms = pga_bound(PGA_M, itemsize, trials,
                                               outer, l2)
            probs.append(dict(
                problem=seed, trials=trials, inner=inner, outer=outer,
                host_trials=host[1][0], ifinal=int(kern[0][2]),
                ms=time_ms(lambda: msrc.find_dense_clique(M, C, u0, params),
                           dev, 20),
                plain_ms=time_ms(lambda: msrc.run_pga(
                    msrc.dense_operators(M, C), u0, params, dtype=dtype),
                    dev, 2),
                bound_ms=bound_ms, bound_hbm_ms=bound_hbm_ms, max_abs_err=du,
                reversed_checked=reversed_))
            del c, M, C
        med = {k: float(statistics.median(p[k] for p in probs))
               for k in ("ms", "plain_ms", "bound_ms", "bound_hbm_ms")}
        out[kind] = dict(med, l2_bytes_per_s=l2, problems=probs)
        print(f"timing pga_dense m={PGA_M} {kind}: kernel {med['ms']:.4f} "
              f"ms, bound {med['bound_ms']:.4f} ms (trials' Md at "
              f"{l2 / 1e12:.2f} TB/s measured; all at 3.35 TB/s "
              f"{med['bound_hbm_ms']:.4f}), plain (the host loop) "
              f"{med['plain_ms']:.4f} ms; trials "
              f"{[p['trials'] for p in probs]}", flush=True)
        torch.cuda.empty_cache()
    row = dict(out["float32"], bound_by="bytes", library_ms=None,
               f64=out["float64"])
    return row, launches["pga_dense"], err


def phase_user_score(inv, main, dev):
    """13: an invariant's own device score inside the build kernels
    (csrc/user_score.cuh; bench/user_scores.py's UserEuclidean, the
    built-in Euclidean's score with operator() alone, and PlanarCauchy,
    d = 2 with a screen, a gate and a tail, on the bunny's x, y). (a)
    Build both libraries (nvcc's seconds printed); a second lookup runs
    no nvcc. (b) Kernels 2, 8, 4 in int8 and bf16 on the 512 main
    problems at t = 256, 64 (m_true < m on every 16th problem) and at
    their first 1000 associations at t = 100 (likewise), and kernel 6 in
    f32 and f64 on the first problem: each against its plain version with
    0 codes differing, timed beside the built-in Euclidean's. (c) The tri
    pool (bench.py's protocol) with UserEuclidean and build="auto":
    tri_build_user launched and no other build, masks equal to the
    built-in pool's bit for bit, the bench bars; problems/s beside the
    built-in's in turns and beside build="xla". (d) The score's other
    paths, each counted: the tile-major pool (kernel 8), the stacked pool
    (kernel 4) and the dense facade (kernel 6). Returns the kernels'
    rows and the launches of the paths."""
    import torch
    from clipper_tpu_torch import Clipper, _kernels
    from clipper_tpu_torch.parallel import pool
    from clipper_tpu_torch.types import Params

    t_phase = time.perf_counter()
    invs = user_invariants(inv)
    scores = [u.cuda_score() for u, _, _, _ in invs.values()]
    secs = _kernels.build_all(scores=scores)
    print(f"user scores: built {len(scores)} device score libraries in "
          f"{secs:.1f} s (nvcc, one a library, in parallel)", flush=True)
    for s in scores:
        for line in _kernels.BUILD_LOG.get(_kernels.user_target(s).stem,
                                           "").splitlines():
            if "spill" in line and " 0 bytes spill" not in line:
                print(f"  ptxas {_kernels.user_target(s).stem}: "
                      f"{line.strip()}", flush=True)
    _kernels._USER_LIBS.clear()
    again = [_kernels.build_user(s) for s in scores]
    t0 = time.perf_counter()
    for s in scores:
        _kernels.user_lib(s)
    runs = sum(a is not None for a in again)
    print(f"user scores: second lookup ran nvcc {runs} times, loaded from "
          f"the cache in {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)
    require(all(a is None for a in again), "a device score library was "
            "built twice")

    D1, D2s, As, Agts, u0s = main
    rows, errs = {}, {}
    for label, (uinv, binv, d, ops) in invs.items():
        for m, t, mt in ((M, 256, M), (M, 64, M - 100),
                         (M_EDGE, 100, M_EDGE - 100)):
            P1s, P2s = endpoints(D1[:, :d], D2s[..., :d], As[:, :m], dev)
            P1s, P2s = P1s.contiguous(), P2s.contiguous()
            At = torch.as_tensor(As[:, :m], device=dev).contiguous()
            mts = torch.full((W_MAIN,), m, dtype=torch.int32, device=dev)
            mts[::16] = mt
            r, e = user_builds_at(uinv, binv, P1s, P2s, At, mts, t, ops,
                                  f"{label} W={W_MAIN} m={m} t={t}", dev)
            for k in r:
                errs[k] = max(errs.get(k, 0.0), e)
                r[k].update(W=W_MAIN, m=m, t=t)
                if label == "user_euclidean" and t == 256:
                    rows[k] = r[k]
                else:
                    rows[k].setdefault("shapes", {})[
                        f"{label} m={m} t={t}"] = r[k]
            del P1s, P2s, At
            torch.cuda.empty_cache()
        for m in (M, M_EDGE):
            P1, P2 = endpoints(D1[:, :d], D2s[0, :, :d], As[0, :m], dev)
            A0 = torch.as_tensor(As[0, :m], device=dev)
            r, e = user_dense_at(uinv, binv, P1, P2, A0, ops,
                                 f"{label} m={m}", dev)
            errs["affinity_build"] = max(errs.get("affinity_build", 0.0), e)
            r["m"] = m
            if label == "user_euclidean" and m == M:
                rows["affinity_build"] = r
            else:
                rows["affinity_build"].setdefault("shapes", {})[
                    f"{label} m={m}"] = r

    # (c) the tri pool over UserEuclidean, the built-in's beside it
    ue = invs["user_euclidean"][0]
    require(pool._resolve_build("auto", torch.int8, ue, dev) == "pallas",
            "build='auto' does not take the kernel for a device score")
    launches = {}
    sol_b = run_pipeline(inv, main, dev, W_MAIN)
    sol_u, got = counted_call(lambda: run_pipeline(ue, main, dev, W_MAIN))
    launches["tri_build"] = got["tri_build_user"]
    builds = {k: v for k, v in got.items() if "build" in k and v}
    print("user score tri pool launches (one call): "
          f"{dict((k, v) for k, v in got.items() if v)}", flush=True)
    require(builds == {"tri_build_user": 1} and got["tri_matvec"] > 0,
            f"user score tri pool: tri_build_user once and no other build "
            f"expected: {builds}")
    same = bool(torch.equal(sol_u.mask, sol_b.mask))
    P, R = check_quality("user score tri pool", As, sol_u, Agts, W_MAIN)
    print(f"user score tri pool: W={W_MAIN} m={M}: precision={P * 100:.2f}%"
          f" recall={R * 100:.2f}%; masks equal to the built-in Euclidean "
          f"pool's bit for bit: {same}", flush=True)
    require(same, "the UserEuclidean pool's masks differ from the built-in "
            "Euclidean pool's")
    walls = {"built-in": [], "user": []}
    stages = {"built-in": {}, "user": {}, "xla": {}}
    for who in ("built-in", "user", "user", "built-in") * 2:
        _, w = timed_calls(lambda: run_pipeline(
            inv if who == "built-in" else ue, main, dev, W_MAIN,
            timings=stages[who]), 1)
        walls[who].append(w)
    sol_x = run_pipeline(ue, main, dev, W_MAIN, build="xla")
    _, wx = timed_calls(lambda: run_pipeline(
        ue, main, dev, W_MAIN, build="xla", timings=stages["xla"]), 2)
    ms = {k: np.mean(v) * 1e3 for k, v in walls.items()}
    print(f"user score tri pool (in turns, 4 calls each): "
          f"{W_MAIN / ms['user'] * 1e3:.1f} problems/s ({ms['user']:.1f} ms "
          f"a call) beside the built-in Euclidean's "
          f"{W_MAIN / ms['built-in'] * 1e3:.1f} ({ms['built-in']:.1f} ms); "
          f"build='xla' with the same invariant {W_MAIN / wx:.1f} "
          f"({wx * 1e3:.1f} ms, masks equal: "
          f"{bool(torch.equal(sol_x.mask, sol_u.mask))})", flush=True)
    print("user score tri pool stage ms (each one's last call, CUDA "
          "events): " + "; ".join(
              f"{who} " + ", ".join(f"{k}={v:.3f}" for k, v in t.items())
              for who, t in stages.items()), flush=True)

    # (d) the score's other paths: kernel 8, 4 and 6 each once a call
    sol, got = counted_call(lambda: run_tri_variant(ue, main, dev, W_MAIN,
                                                    "tiles"))
    launches["tri_build_fused"] = got["tri_build_fused_user"]
    check_quality("user score tile-major pool", As, sol, Agts, W_MAIN)
    sol, got = counted_call(lambda: run_stacked(ue, main, dev, W_MAIN))
    launches["stored_build"] = got["stored_build_user"]
    check_quality("user score stacked pool", As, sol, Agts, W_MAIN)
    c = Clipper(ue, Params(), dtype=torch.float32, device=dev)

    def facade():
        c.score_pairwise_consistency(D1.T, D2s[0].T, As[0])
        return c.solve(u0=u0s[0])

    sol, got = counted_call(facade)
    launches["affinity_build"] = got["affinity_build_user"]
    P, R = precision_recall(As[:1], sol.mask.cpu().numpy()[None], Agts[:1])
    print(f"user score paths: launches tile-major pool "
          f"{launches['tri_build_fused']} (tri_build_fused_user), stacked "
          f"pool {launches['stored_build']} (stored_build_user), dense "
          f"facade {launches['affinity_build']} (affinity_build_user, "
          f"P={P[0] * 100:.2f}% R={R[0] * 100:.2f}%)", flush=True)
    require(P[0] >= 0.995 and R[0] >= 0.85, "user score dense facade: P/R "
            f"{P[0]:.4f} / {R[0]:.4f} under 0.995 / 0.85")
    for k in _kernels.USER_KERNELS:
        require(launches[k] == 1, f"{k}_user launched {launches[k]} times "
                "on its path, not once")
        rows[k].update(launches=launches[k], max_abs_err=errs[k])
    print(f"user scores: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows

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
                F32_FLOPS if dtype == torch.float32 else F64_SIMT_FLOPS)
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
                                         pool_ab, sdp_bench, sharded_bench,
                                         symshard_bench, symstore_bench,
                                         tickstats)
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
    # B=32: cut in depth (B=128 took 31 s of the phase's 80) to hold the
    # script's time as phase 13 joined it
    out, _ = driver_call("tickstats B=32", lambda: tickstats.main(
        ["32", cuda]))
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
    out, _ = driver_call("sharded_bench m=4096 (its own 1-rank NCCL group)",
                         lambda: sharded_bench.main(["4096", "1", cuda]))
    require(out["ranks"] == 1 and [r["mesh"] for r in out["rows"]]
            == [[1, 1]], f"sharded_bench: {out}")
    check_bench_rows("sharded_bench", [dict(r, m=None) for r in out["rows"]])
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


# ---------------------------------------------------------------------------
# the multi-rank paths: the 2D block-sharded engine, the pools over a
# process group, and the dry run
# ---------------------------------------------------------------------------

# the JAX sharded_bench's defaults (clipper_tpu/bench/sharded_bench.py:36-37)
MESH_OPTS = dict(probes=16, power_steps=4, support=512, build_chunk=512)
MESH_MV_CHUNK = 8192   # rows cast to f32 at a time at m=65,536: 2.1 GB
MESH_M = 8192          # the block against kernel 4, and R x C > 1
MESH_SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2))
MESH_IOU = 0.95        # R x C > 1 against 1 x 1 (f32 ulp noise: phase 5)
MESH_W = 64            # the tri pool on 2 gloo ranks
MESH_TIMEOUT = 300.0   # each group of spawned ranks


def mesh_capacity(inv, cap, cap_mask, dev):
    """11 (a): the 2D engine on a 1-rank NCCL group at m=65,536, int8
    storage built a chunk of rows at a time, the stacked matvec
    ``MESH_MV_CHUNK`` rows at a time; the P/R bars; one counted call (the
    warm-up), then 2 timed calls; then the matvec alone at K=16 and K=1
    beside its bound."""
    import torch
    from clipper_tpu_torch.bench import data
    from clipper_tpu_torch.bench.harness import time_ms
    from clipper_tpu_torch.parallel import sharded
    from clipper_tpu_torch.types import Params

    pcd0, pcd1, A, Agt, u0 = cap
    m = len(A)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    with one_rank_group(dev):
        mesh = sharded.make_mesh((1, 1))

        def run():
            return sharded.solve_sharded(
                inv, pcd0, pcd1, A, u0, Params(), mesh,
                storage_dtype=torch.int8, matvec_chunk=MESH_MV_CHUNK,
                device=dev, stats=stats, **MESH_OPTS)

        sol, launches = counted_call(run)
        cold = dict(stats)
        sol, wall = timed_calls(run, 2)
    peak = torch.cuda.max_memory_allocated(dev)
    mask = sol.mask.cpu().numpy()
    F = float(sol.score)
    require(mask.shape == (m,) and bool(torch.isfinite(sol.u).all())
            and np.isfinite(F) and F <= m, "2D engine m=65,536: bad shape, "
            "non-finite u or F, or F > m")
    P, R = data.get_precision_recall(A[mask], Agt)
    block_gb = stats["storage_bytes"] / 1e9
    print(f"2D engine 1x1 (1-rank NCCL group) m={m} rho={CAP_RHO} int8 "
          f"probes=16 power=4 support=512 build_chunk=512 matvec_chunk="
          f"{MESH_MV_CHUNK}: precision={P * 100:.2f}% recall={R * 100:.2f}% "
          f"|mask|={int(mask.sum())}; ifinal={int(sol.ifinal)} F={F:.4f} "
          f"ticks={stats['ticks']} rejected probes={stats['nback']}; polish "
          f"branch {stats['polish_branch']}; block {block_gb:.3f} GB, peak "
          f"allocated {peak / 1e9:.3f} GB; IoU with phase 4's triangle "
          f"engine mask {mask_iou(mask, cap_mask):.4f}", flush=True)
    print(f"2D engine 1x1 m={m} wall: warm call {wall:.4f} s (mean of 2 "
          "after 1 warm-up); stage ms of the last (CUDA events): "
          + ", ".join(f"{k}={stats[k]:.3f}" for k in
                      ("build", "init", "solve", "polish"))
          + "; first call: " + ", ".join(f"{k}={cold[k]:.3f}" for k in
                                         ("build", "init", "solve",
                                          "polish"))
          + f"; kernel launches (one call): "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    require(stats["storage_bytes"] == 2 * m * m, "2D engine: block bytes")
    require(P >= 0.995, f"2D engine m={m}: precision {P:.4f} < 0.995")
    require(R >= 0.88, f"2D engine m={m}: recall {R:.4f} < 0.88")
    del sol

    P1, P2, At = capacity_endpoints(cap, dev)
    store = sharded._affinity_block_stored(inv, P1, P2, At, m, m, m, 1e-4,
                                           torch.int8, 0, 0, 512)
    mv = sharded.sharded_dual_matvec(store, m, m, torch.float32,
                                     sharded.make_mesh(),
                                     matvec_chunk=MESH_MV_CHUNK)
    gen = torch.Generator(device=dev).manual_seed(0)
    for K in (16, 1):
        U = torch.rand(m, K, generator=gen, device=dev)
        ms = time_ms(lambda: mv(U), dev, reps=3)
        bound = bound_of(2 * m * m + m * K * 4 + 2 * m * K * 4,
                         2 * 2 * m * m * K, F32_FLOPS)
        print(f"2D engine stacked int8 matvec m={m} K={K} (stacked_partials "
              f"{MESH_MV_CHUNK} rows at a time, torch.matmul in f32): "
              f"{ms:.4f} ms a call; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), {ms / bound['bound_ms']:.2f}x", flush=True)
    del store, mv
    torch.cuda.empty_cache()


def mesh_block_vs_kernel4(inv, dev):
    """11 (b): the 1x1 stored block at m=8192 byte-equal to kernel 4's
    stacked storage and to the plain stacked build, int8 and bf16.
    Returns the problem."""
    import torch
    from clipper_tpu_torch.ops import affinity_pallas
    from clipper_tpu_torch.ops.affinity import stored_from_endpoints
    from clipper_tpu_torch.parallel import sharded

    prob = one_problem(MESH_M, CAP_RHO, seed=2)
    P1, P2, At = capacity_endpoints(prob, dev)
    m = MESH_M
    mts = torch.full((1,), m, dtype=torch.int32, device=dev)
    for storage in (torch.int8, torch.bfloat16):
        blk = sharded._affinity_block_stored(inv, P1, P2, At, m, m, m, 1e-4,
                                             storage, 0, 0, 512)
        k4 = affinity_pallas.stored_build(inv, P1[None], P2[None], At[None],
                                          mts, storage_dtype=storage)[0]
        plain = stored_from_endpoints(inv, P1, P2, At, storage_dtype=storage)
        d4 = int((blk != k4).sum())
        dp = int((blk != plain).sum())
        print(f"2D engine 1x1 block m={m} {str(storage).split('.')[-1]}: "
              f"{blk.numel()} bytes-or-values; differ from kernel 4 "
              f"(stored_build) {d4}, from the plain stacked build {dp}",
              flush=True)
        require(d4 == 0 and dp == 0, "the 1x1 block differs from kernel 4's "
                "storage or the plain build")
        del blk, k4, plain
    torch.cuda.empty_cache()
    return prob


def mesh_pools(inv, main, dev):
    """11 (c): the tri and stacked pools on a 1-rank NCCL mesh: the
    Solution of mesh=None bit for bit, their kernels launched, the bench
    bars; problems/s of both, timed in turns (none, mesh, mesh, none)."""
    import torch
    import torch.distributed as dist

    D1, D2s, As, Agts, u0s = main
    with one_rank_group(dev):
        group = dist.group.WORLD
        for label, run, need in (("tri", run_pipeline,
                                  ("tri_build", "tri_matvec")),
                                 ("stacked", run_stacked,
                                  ("stored_build",))):
            ref, _ = counted_call(lambda: run(inv, main, dev, W_MAIN))
            sol, launches = counted_call(lambda: run(inv, main, dev, W_MAIN,
                                                     mesh=group))
            missing = [k for k in need if not launches[k]]
            require(not missing, f"{label} pool mesh=group: kernels never "
                    f"launched: {missing}")
            same = all(torch.equal(getattr(sol, f), getattr(ref, f))
                       for f in ("mask", "ifinal", "score", "u"))
            require(same, f"{label} pool on a 1-rank mesh differs from "
                    "mesh=None")
            P, R = check_quality(f"{label} pool mesh=group", As, sol, Agts,
                                 W_MAIN)
            times = {None: [], "mesh": []}
            for which in (None, "mesh", "mesh", None):
                t0 = time.perf_counter()
                run(inv, main, dev, W_MAIN,
                    mesh=group if which else None)
                torch.cuda.synchronize()
                times[which].append(time.perf_counter() - t0)
            rate = {k: W_MAIN / np.mean(v) for k, v in times.items()}
            print(f"{label} pool W={W_MAIN} on a 1-rank NCCL mesh: equal to "
                  f"mesh=None (mask, ifinal, F, u); P={P * 100:.2f}% "
                  f"R={R * 100:.2f}%; {rate['mesh']:.1f} problems/s against "
                  f"{rate[None]:.1f} with mesh=None (turns none, mesh, mesh, "
                  f"none); launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)


def mesh_on_gloo(inv, main, prob, dev):
    """11 (d): R x C > 1 on the one card, gloo ranks all on it (NCCL takes
    one rank a card): the 2D engine at m=8192 int8 on 1x1, 1x2, 2x1 and
    2x2 (4 ranks: every rank's u bit-identical, the bench bars, IoU >=
    MESH_IOU with 1x1); then 2 ranks: the tri pool at W=MESH_W (the masks
    of mesh=None in this process, its kernels launched on each rank) and
    dryrun_multichip(2)."""
    import torch
    from clipper_tpu_torch.bench import cpu_mesh_run, data

    pcd0, pcd1, A, Agt, u0 = prob
    job = dict(kind="sharded", D1=pcd0, D2=pcd1, A=A, u0=u0, invariant=inv,
               device=dev.type, storage_dtype=torch.int8, **MESH_OPTS)
    t0 = time.perf_counter()
    res = cpu_mesh_run.run(4, [dict(job, mesh=s) for s in MESH_SHAPES],
                           timeout=MESH_TIMEOUT)
    print(f"2D engine on 4 gloo ranks on one card: {time.perf_counter() - t0:.1f}"
          " s (spawn and join included)", flush=True)
    base = res[0]["mask"]
    for shape, r in zip(MESH_SHAPES, res):
        P, R = data.get_precision_recall(A[r["mask"]], Agt)
        iou = mask_iou(r["mask"], base)
        print(f"2D engine {shape[0]}x{shape[1]} m={MESH_M} int8 (gloo on the "
              f"card): P={P * 100:.2f}% R={R * 100:.2f}% F={r['score']:.4f} "
              f"ifinal={r['ifinal']} ticks={r['stats']['ticks']} polish "
              f"{r['stats']['polish_branch']}; ranks' u bit-identical "
              f"{r['ranks_agree']}; IoU with 1x1 {iou:.4f}; stage ms "
              + ", ".join(f"{k}={r['stats'][k]:.1f}" for k in
                          ("build", "init", "solve", "polish")), flush=True)
        require(r["ranks_agree"], f"2D engine {shape}: the ranks' u differ")
        require(P >= 0.995 and R >= 0.88, f"2D engine {shape}: P={P:.4f} "
                f"R={R:.4f} below the bars")
        require(iou >= MESH_IOU, f"2D engine {shape}: IoU {iou:.4f} with 1x1")

    D1, D2s, As, _, u0s = main
    W = MESH_W
    pjob = dict(kind="pool", D1=first(D1, W), D2s=D2s[:W], As=As[:W],
                u0s=u0s[:W], invariant=inv, device=dev.type, lanes=128,
                window=2, storage_dtype=torch.int8, power_steps=4,
                layout="tri", tri_probes=16, d_scale=0.15)
    t0 = time.perf_counter()
    got = cpu_mesh_run.run_all(2, [pjob, dict(kind="dryrun",
                                              device=dev.type)],
                               timeout=MESH_TIMEOUT)
    print(f"tri pool and dry run on 2 gloo ranks on one card: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ref = run_pipeline(inv, main, dev, W).mask.cpu().numpy()
    for rank in range(2):
        r = got[rank][0]
        equal = bool((r["mask"] == ref).all())
        print(f"tri pool W={W} on 2 gloo ranks, rank {rank}: masks equal to "
              f"mesh=None {equal}; windows {r['stats']['windows']}; launches "
              f"{r['launches']}", flush=True)
        require(equal, f"tri pool on 2 ranks: rank {rank}'s masks differ "
                "from mesh=None")
        require(r["launches"].get("tri_build") and r["launches"].get(
            "tri_matvec"), f"tri pool rank {rank}: kernels not launched")
    dry = got[0][1]
    print(f"dryrun_multichip(2) on one card: {json.dumps(dry)}", flush=True)
    require(dry["mesh"] == [1, 2] and dry["parity_float64"]["iou"] == 1.0,
            f"dry run: {dry}")
    return dry


def phase_mesh(inv, cap, cap_mask, main, dev):
    """11: the multi-rank paths (see the module docstring). Returns the
    dry run's summary."""
    t0 = time.perf_counter()
    mesh_capacity(inv, cap, cap_mask, dev)
    print(f"mesh (a): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    prob = mesh_block_vs_kernel4(inv, dev)
    mesh_pools(inv, main, dev)
    print(f"mesh (b, c): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dry = mesh_on_gloo(inv, main, prob, dev)
    print(f"mesh (d): {time.perf_counter() - t0:.1f} s", flush=True)
    return dry


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
    t0 = time.perf_counter()
    errs_t, tile_rows = phase_kernels_tiles(inv, pn_inv, dev)
    for name, e in errs_t.items():
        errs[name] = max(errs.get(name, 0), e)
    print(f"kernels at every tile: {time.perf_counter() - t0:.1f} s",
          flush=True)
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
    cap_launches, cap_mask = phase_capacity(inv, cap, dev)
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
    t0 = time.perf_counter()
    dry = phase_mesh(inv, cap, cap_mask, main_data, dev)
    print(f"mesh: {time.perf_counter() - t0:.1f} s on {gpu_line()}",
          flush=True)
    for name, r in phase_tiles(inv, main_data, cap, cap_mask, dry,
                               dev).items():
        tile_rows[name].update(r)
    user_rows = phase_user_score(inv, main_data, dev)
    rows["pga_dense"], launches["pga_dense"], errs["pga_dense"] = \
        phase_pga_dense(inv, dev)
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
        "pga_dense": "clipper_tpu/solvers/msrc.py:236",
    }
    kernels = [dict(name=name, route="cuda", source=f"{src}{name}.cu",
                    replaces=where, launches=launches[name],
                    max_abs_err=errs[name], **rows[name])
               for name, where in replaces.items()]
    # the build kernels over an invariant's own device score (phase 13)
    templates = {"tri_build": "tri_build.cuh",
                 "tri_build_fused": "tri_build_fused.cuh",
                 "stored_build": "stored_pair_build.cuh",
                 "affinity_build": "affinity_build.cuh"}
    for name in _kernels.USER_KERNELS:
        kernels.append(dict(name=f"{name}_user", route="cuda",
                            source=f"{src}{templates[name]}",
                            adaptor=f"{src}user_score.cuh",
                            replaces=replaces[name], **user_rows[name]))
        launches[f"{name}_user"] = user_rows[name]["launches"]
    # the capacity matvecs' second kernel, the fixed-order reduction
    for k in kernels:
        if k["name"] in _kernels.REDUCTIONS:
            k["reduce_launches"] = launches[_kernels.REDUCTIONS[k["name"]]]
    # each new tile's time, bound and route (phases 2 and 12)
    for k in kernels:
        if k["name"] in tile_rows:
            k["tiles"] = tile_rows[k["name"]]
    print("main-path launches: " + ", ".join(
        f"{name} {launches[name]}" for name in (
            *replaces, *_kernels.REDUCTIONS.values(),
            *(f"{k}_user" for k in _kernels.USER_KERNELS))),
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
