"""clipper_tpu_torch — the PyTorch/CUDA port of clipper_tpu.

Robust data association (graph-theoretic inlier selection) on an NVIDIA
Hopper GPU. This package covers two paths end to end:

- the triangle-pool pipeline (many problems): Euclidean scoring, the flat
  upper-triangle int8 [M; C] build, the flat MSRC solver with the K-wide
  multiprobe line search, lane compaction, the f32 polish and DSD_HEU
  rounding;
- the ``Clipper`` facade (one problem): the dense engine with the nested
  solver, and from m = 8192 the row-chunked symmetric-triangle capacity
  engine.

The pool's build and triangle matvec and the capacity engine's rows
matvec are hand-written CUDA kernels (csrc/); every kernel has a plain
PyTorch version that CPU tensors take.

It imports torch and never jax or clipper_tpu. Entry points run on
``device="cuda"`` unless asked for the CPU, and raise when CUDA is asked
for and missing.
"""

from clipper_tpu_torch.clipper import CLIPPER, Clipper
from clipper_tpu_torch.invariants.base import Invariant, PairwiseInvariant
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.ops.affinity import (distinctness_mask,
                                            score_consistency_stored,
                                            score_pairwise_consistency)
from clipper_tpu_torch.ops.flattri import build_tri, make_tri_pool_matvec
from clipper_tpu_torch.parallel.pool import make_pool_pipeline
from clipper_tpu_torch.types import Params, Rounding, Solution

__all__ = [
    "Clipper", "CLIPPER", "Invariant", "PairwiseInvariant", "EuclideanDistance",
    "EuclideanDistanceParams", "distinctness_mask",
    "score_consistency_stored", "score_pairwise_consistency", "build_tri",
    "make_tri_pool_matvec", "make_pool_pipeline", "Params", "Rounding",
    "Solution",
]
