"""Heterogeneous-m workloads: pad-to-bucket batching over the pool engine.

Counterpart of ``clipper_tpu/parallel/buckets.py``. Problems are grouped
into power-of-two size buckets and zero-padded to the bucket size. The
padding is exact: padded rows get no affinity edges and no constraints
(the build's ``m_true`` mask), start at u0 = 0 and never move. Each bucket
is solved by its own cached pool pipeline, so a problem pays for its own
bucket (<= 2x its m), not the workload's largest m: a pool lane reads its
problem's whole stored [M; C] every tick, so padding everything to the
largest m would make the waste quadratic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.parallel import pool
from clipper_tpu_torch.types import Params, Solution, resolve_device


def bucket_size(m: int, min_bucket: int = 128) -> int:
    """Smallest power-of-2 >= m (at least min_bucket)."""
    b = min_bucket
    while b < m:
        b *= 2
    return b


def pad_rows(x: np.ndarray, rows: int, fill=0) -> np.ndarray:
    pad = rows - x.shape[0]
    if pad == 0:
        return np.asarray(x)
    width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), width, constant_values=fill)


class BucketedPipeline:
    """Mixed-m solver: groups (D2, A, u0) problems by size bucket and runs
    one cached pool pipeline per bucket.

    Shares D1 across problems (the common one-map-many-scans shape).
    pool_kwargs go to :func:`pool.make_pool_pipeline`, with the JAX
    package's defaults filled in where not given (``layout="stacked"``,
    ``storage_dtype=torch.bfloat16``; the port's make_pool_pipeline
    defaults to the triangle layout and int8), so a call means the same in
    both packages. Returns per-problem Solutions trimmed to their true m,
    as CPU tensors, in input order. Runs on ``device`` ("cuda" by default;
    raises if missing).
    """

    def __init__(self, invariant: PairwiseInvariant,
                 params: Params = Params(), *,
                 min_bucket: int = 128,
                 pad_batch: bool = True,
                 device="cuda",
                 **pool_kwargs):
        self._invariant = invariant
        self._params = params
        self._min_bucket = min_bucket
        self._pad_batch = pad_batch
        self._device = resolve_device(device)
        self._pool_kwargs = dict(pool_kwargs)
        self._pool_kwargs.setdefault("layout", "stacked")
        self._pool_kwargs.setdefault("storage_dtype", torch.bfloat16)
        self._pipelines: Dict[int, callable] = {}

    def _pipeline_for(self, mb: int):
        if mb not in self._pipelines:
            kw = dict(self._pool_kwargs)
            kw.setdefault("lanes", min(128, max(8, 4096 // max(mb // 256, 1))))
            self._pipelines[mb] = pool.make_pool_pipeline(
                self._invariant, self._params, device=self._device, **kw)
        return self._pipelines[mb]

    def __call__(self, D1, problems: Sequence[Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]]
                 ) -> List[Solution]:
        """problems: sequence of (D2, A, u0) with per-problem shapes
        (n2_i, d), (m_i, 2), (m_i,)."""
        D1 = np.asarray(D1, np.float32)
        groups: Dict[int, List[int]] = {}
        for i, (_, A, _) in enumerate(problems):
            groups.setdefault(bucket_size(A.shape[0], self._min_bucket),
                              []).append(i)

        out: List[Optional[Solution]] = [None] * len(problems)
        for mb, idxs in sorted(groups.items()):
            W = len(idxs)
            Wb = W
            if self._pad_batch:
                # a power-of-2 batch, as the JAX package pads to reuse
                # its compilations across drifting queue lengths
                Wb = 1
                while Wb < W:
                    Wb *= 2
            n2 = max(problems[i][0].shape[0] for i in idxs)
            n2 = -(-n2 // 64) * 64
            d = problems[idxs[0]][0].shape[1]

            D2s = np.zeros((Wb, n2, d), np.float32)
            As = np.zeros((Wb, mb, 2), np.int32)
            u0s = np.zeros((Wb, mb), np.float32)
            m_trues = np.zeros((Wb,), np.int32)
            for k, i in enumerate(idxs):
                D2, A, u0 = problems[i]
                m = A.shape[0]
                D2s[k, : D2.shape[0]] = D2
                As[k, :m] = A
                As[k, m:] = -1          # inert under the m_true mask
                u0s[k, :m] = u0
                m_trues[k] = m
            # batch-padding dummies: a 1-association problem that converges
            # in one tick (u0 must be nonzero for the init normalization)
            for k in range(W, Wb):
                m_trues[k] = 1
                u0s[k, 0] = 1.0
                As[k] = -1
                As[k, 0] = 0

            solns = self._pipeline_for(mb)(D1, D2s, As, u0s,
                                           m_trues=m_trues)
            # one device-to-host copy per field per bucket
            host = {f: getattr(solns, f).cpu()
                    for f in ("ifinal", "mask", "u0", "u", "score")}
            for k, i in enumerate(idxs):
                m = problems[i][1].shape[0]
                out[i] = Solution(ifinal=host["ifinal"][k],
                                  mask=host["mask"][k][:m],
                                  u0=host["u0"][k][:m],
                                  u=host["u"][k][:m],
                                  score=host["score"][k])
        return out


def make_bucketed_pipeline(invariant: PairwiseInvariant,
                           params: Params = Params(),
                           **kwargs) -> BucketedPipeline:
    """See :class:`BucketedPipeline`."""
    return BucketedPipeline(invariant, params, **kwargs)
