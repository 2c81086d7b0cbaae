"""clipperpy.invariants-compatible namespace
(reference: bindings/python/py_clipper.cpp:25-83), over the port's
invariants."""

from __future__ import annotations

import dataclasses

from clipper_tpu_torch.invariants import base as _base
from clipper_tpu_torch.invariants import euclidean as _euclidean
from clipper_tpu_torch.invariants import pointnormal as _pointnormal

Invariant = _base.Invariant
PairwiseInvariant = _base.PairwiseInvariant


class _ParamsHolder:
    """Mutable holder of a frozen params dataclass's fields."""

    _frozen_cls = None

    def __init__(self):
        for f in dataclasses.fields(self._frozen_cls):
            setattr(self, f.name, f.default)

    def _freeze(self):
        return self._frozen_cls(**{f.name: getattr(self, f.name)
                                   for f in dataclasses.fields(
                                       self._frozen_cls)})

    def __repr__(self):
        fields = " ".join(f"{f.name}={getattr(self, f.name)}"
                          for f in dataclasses.fields(self._frozen_cls))
        return f"<{type(self).__name__} : {fields}>"


class EuclideanDistanceParams(_ParamsHolder):
    _frozen_cls = _euclidean.EuclideanDistanceParams


class PointNormalDistanceParams(_ParamsHolder):
    _frozen_cls = _pointnormal.PointNormalDistanceParams


def EuclideanDistance(params=None):
    frozen = params._freeze() if isinstance(params, EuclideanDistanceParams) \
        else (params or _euclidean.EuclideanDistanceParams())
    return _euclidean.EuclideanDistance(frozen)


def PointNormalDistance(params=None):
    frozen = (params._freeze()
              if isinstance(params, PointNormalDistanceParams)
              else params or _pointnormal.PointNormalDistanceParams())
    return _pointnormal.PointNormalDistance(frozen)
