"""clipperpy-compatible namespace.

Counterpart of ``clipper_tpu/compat/__init__.py``: the drop-in surface for
users of the reference Python bindings (reference:
bindings/python/py_clipper.cpp:116-233) over the port's facade:

    import clipper_tpu_torch.compat as clipperpy

    iparams = clipperpy.invariants.EuclideanDistanceParams()
    iparams.sigma = 0.015
    invariant = clipperpy.invariants.EuclideanDistance(iparams)
    params = clipperpy.Params()
    clipper = clipperpy.CLIPPER(invariant, params)
    clipper.score_pairwise_consistency(D1, D2, A)
    clipper.solve()
    Ain = clipper.get_selected_associations()

Parameter objects are plain mutable attribute holders (like the pybind11
ones), snapshotted into frozen dataclasses when the solver runs. A
``solve()`` without ``u0`` draws its init from a clock-seeded generator,
as the reference does (src/utils.cpp:22-29). ``CLIPPER`` runs on
``device="cuda"`` unless asked for the CPU; the matrix accessors return
host numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from clipper_tpu_torch import clipper as _clipper
from clipper_tpu_torch import types as _types
from clipper_tpu_torch.compat import dsd, invariants, utils
from clipper_tpu_torch.solvers import maxclique as _maxclique
from clipper_tpu_torch.solvers import sdp as _sdp
from clipper_tpu_torch.types import Rounding

NONZERO = Rounding.NONZERO
DSD = Rounding.DSD
DSD_HEU = Rounding.DSD_HEU


class _MutableParams:
    """Attribute holder mirroring a frozen dataclass's fields."""

    _frozen_cls = None

    def __init__(self, **kw):
        for f in dataclasses.fields(self._frozen_cls):
            setattr(self, f.name, kw.pop(f.name, f.default))
        if kw:
            raise TypeError(f"unknown params: {sorted(kw)}")

    def freeze(self):
        return self._frozen_cls(**{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self._frozen_cls)})

    def __repr__(self):
        fields = ", ".join(f"{f.name}={getattr(self, f.name)}"
                           for f in dataclasses.fields(self._frozen_cls))
        return f"<{type(self).__name__} : {fields}>"


class Params(_MutableParams):
    _frozen_cls = _types.Params


class MCParams(_MutableParams):
    _frozen_cls = _maxclique.Params


class SDPParams(_MutableParams):
    _frozen_cls = _sdp.Params


def _frozen(params):
    return params.freeze() if isinstance(params, _MutableParams) else params


class Solution:
    """clipperpy-style Solution view: nodes as a list, not a mask."""

    def __init__(self, soln: _types.Solution):
        self._soln = soln

    @property
    def t(self):
        return self._soln.t

    @property
    def ifinal(self):
        return int(self._soln.ifinal)

    @property
    def nodes(self):
        return [int(v) for v in self._soln.nodes]

    @property
    def u0(self):
        return self._soln.u0.cpu().numpy()

    @property
    def u(self):
        return self._soln.u.cpu().numpy()

    @property
    def score(self):
        return float(self._soln.score)

    def __repr__(self):
        return "<CLIPPER Solution>"


class CLIPPER:
    def __init__(self, invariant, params: Params, *, device="cuda"):
        self._impl = _clipper.Clipper(invariant, _frozen(params), seed=None,
                                      device=device)

    def score_pairwise_consistency(self, D1, D2, A=None):
        self._impl.score_pairwise_consistency(D1, D2, A)

    def solve(self, u0=None):
        self._impl.solve(u0=u0 if u0 is not None and np.size(u0) else None)

    def solve_as_maximum_clique(self, params=None):
        self._impl.solve_as_maximum_clique(_frozen(params))

    def solve_as_msrc_sdr(self, params=None):
        self._impl.solve_as_msrc_sdr(_frozen(params))

    def get_initial_associations(self):
        return self._impl.get_initial_associations()

    def get_selected_associations(self):
        return self._impl.get_selected_associations()

    def get_solution(self):
        return Solution(self._impl.get_solution())

    def get_affinity_matrix(self):
        return self._impl.get_affinity_matrix().cpu().numpy()

    def get_constraint_matrix(self):
        return self._impl.get_constraint_matrix().cpu().numpy()

    def set_matrix_data(self, M, C):
        self._impl.set_matrix_data(M, C)

    def set_sparse_matrix_data(self, M, C):
        self._impl.set_sparse_matrix_data(M, C)

    def set_parallelize(self, parallelize):
        self._impl.set_parallelize(parallelize)

    def __repr__(self):
        return "<CLIPPER>"


__version__ = "0.2.4+tpu"
