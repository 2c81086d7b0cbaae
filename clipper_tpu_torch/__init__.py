"""clipper_tpu_torch — the PyTorch/CUDA port of clipper_tpu.

Robust data association (graph-theoretic inlier selection) on an NVIDIA
Hopper GPU. This package covers these paths end to end:

- the triangle-pool pipeline (many problems): Euclidean or point-normal
  scoring, the flat upper-triangle int8 [M; C] build, the flat MSRC
  solver with the K-wide multiprobe line search (or, over tile-major
  storage, single-probe ticks), lane compaction, the f32 polish and
  DSD_HEU rounding;
- the stacked pool (``layout="stacked"``, any m), its multistart pipeline
  and the bucketed mixed-m pipeline over it, and the lock-step batched
  engine (``make_batched_pipeline``);
- the ``Clipper`` facade (one problem): the dense engine with the nested
  solver or multistart, and from m = 8192 the row-chunked
  symmetric-triangle capacity engine; exact DSD rounding on every engine
  and the maximum clique (host solvers, native/), the sparse input path
  over occupied-tile storage (ops/blocksparse.py), successive clique
  extraction (solvers/extract.py), and the semidefinite relaxation
  (solvers/sdp.py, plain PyTorch as the JAX solver is plain XLA), one
  problem or a batch;
- the clipperpy-style namespace (compat/), Kabsch, checkpoints and
  profiling (utils/), the bench drivers (bench/) and the reference's
  examples (examples/).

The pool's triangle builds and matvecs (flat and tile-major), the stacked
build, the facade's dense build, the batched engine's fused matvec and
the capacity engine's rows and tile-list matvecs are hand-written CUDA
kernels (csrc/); every kernel has a plain PyTorch version that CPU
tensors take.

It imports torch and never jax or clipper_tpu. Entry points run on
``device="cuda"`` unless asked for the CPU, and raise when CUDA is asked
for and missing.
"""

from clipper_tpu_torch.clipper import CLIPPER, Clipper
from clipper_tpu_torch.invariants.base import Invariant, PairwiseInvariant
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.invariants.pointnormal import (
    PointNormalDistance, PointNormalDistanceParams)
from clipper_tpu_torch.ops.affinity import (distinctness_mask,
                                            score_consistency_stored,
                                            score_pairwise_consistency)
from clipper_tpu_torch.ops.affinity_pallas import (
    score_consistency_stored_pallas)
from clipper_tpu_torch.ops.flattri import build_tri, make_tri_pool_matvec
from clipper_tpu_torch.ops.fused_matvec import pattern_dual_matvec
from clipper_tpu_torch.parallel.batched import make_batched_pipeline
from clipper_tpu_torch.parallel.buckets import (BucketedPipeline,
                                                make_bucketed_pipeline)
from clipper_tpu_torch.parallel.pool import (make_pool_multistart_pipeline,
                                             make_pool_pipeline)
from clipper_tpu_torch.types import Params, Rounding, Solution

__all__ = [
    "Clipper", "CLIPPER", "Invariant", "PairwiseInvariant", "EuclideanDistance",
    "EuclideanDistanceParams", "PointNormalDistance",
    "PointNormalDistanceParams", "distinctness_mask",
    "score_consistency_stored", "score_pairwise_consistency",
    "score_consistency_stored_pallas", "build_tri", "make_tri_pool_matvec",
    "pattern_dual_matvec", "make_pool_pipeline",
    "make_pool_multistart_pipeline", "make_batched_pipeline",
    "BucketedPipeline", "make_bucketed_pipeline", "Params", "Rounding",
    "Solution",
]
