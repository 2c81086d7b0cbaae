"""Carry state between the JAX package and the port, through numpy.

The JAX package's arrays arrive as numpy arrays (``np.asarray(x)``), its
``_FlatState`` as a dict of arrays (``state._asdict()``), its ``Params`` as
a field dict (``dataclasses.asdict(params)``). These functions turn them
into the port's tensors and back, so both packages can be fed the same
storage and lane states. bfloat16 arrays (ml_dtypes) pass through float32.
An invariant's parameters arrive as ``dataclasses.asdict(inv.params)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from clipper_tpu_torch.invariants import BUILTINS
from clipper_tpu_torch.invariants.base import PairwiseInvariant
from clipper_tpu_torch.solvers import sdp
from clipper_tpu_torch.solvers.msrc_flat import _FlatState
from clipper_tpu_torch.types import Params, Rounding

_INT_FIELDS = ("lsk", "j", "i", "stall", "ticks", "nback")


def to_torch(a, device="cpu") -> torch.Tensor:
    """A numpy (or JAX-as-numpy) array as a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 comes back as float32."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def tri_to_torch(tri, device="cpu") -> torch.Tensor:
    """(W, 2t, S) flat-triangle or (P, T, 2t, t) tile-major storage
    (ops/flattri.py)."""
    shape = np.shape(tri)
    if len(shape) not in (3, 4) or (len(shape) == 4
                                    and shape[2] != 2 * shape[3]):
        raise ValueError(f"triangle storage must be (W, 2t, S) or "
                         f"(P, T, 2t, t); got shape {shape}")
    return to_torch(tri, device).contiguous()


def chunks_to_torch(chunks, device="cpu") -> torch.Tensor:
    """(NC, 2t, G t) row-chunked triangle storage (ops/symstore.py)."""
    if np.ndim(chunks) != 3:
        raise ValueError(f"chunks must be (NC, 2t, G t); got shape "
                         f"{np.shape(chunks)}")
    return to_torch(chunks, device).contiguous()


def tiles_to_torch(tiles, device="cpu") -> torch.Tensor:
    """(T, 2t, t) tile-list triangle storage (ops/symstore.py)."""
    if np.ndim(tiles) != 3 or np.shape(tiles)[1] != 2 * np.shape(tiles)[2]:
        raise ValueError(f"tiles must be (T, 2t, t); got shape "
                         f"{np.shape(tiles)}")
    return to_torch(tiles, device).contiguous()


def invariant_from_params(kind: str, params: Dict) -> PairwiseInvariant:
    """The port's built-in invariant of ``kind`` ("euclidean" or
    "pointnormal", invariants.BUILTINS) from a field dict of its
    parameters, e.g. the JAX invariant's ``dataclasses.asdict(inv.params)``."""
    if kind not in BUILTINS:
        raise ValueError(f"unknown invariant kind {kind!r}; one of "
                         f"{sorted(BUILTINS)}")
    b = BUILTINS[kind]
    return b.cls(b.params_cls(**{k: float(v) for k, v in params.items()}))


def state_to_torch(state: Dict[str, np.ndarray], device="cpu") -> _FlatState:
    """A batched _FlatState given as a dict of (B, ...) arrays."""
    fields = {}
    for name in _FlatState._fields:
        x = to_torch(state[name], device)
        if name in _INT_FIELDS:
            x = x.to(torch.int32)
        elif name == "done":
            x = x.to(torch.bool)
        fields[name] = x
    return _FlatState(**fields)


def state_to_numpy(state: _FlatState) -> Dict[str, np.ndarray]:
    return {name: to_numpy(getattr(state, name))
            for name in _FlatState._fields}


def sdp_state_to_torch(state: Dict[str, np.ndarray],
                       device="cpu") -> sdp._State:
    """The JAX SDP solver's ADMM carry (its ``_State._asdict()``, one
    problem) as the port's :class:`sdp._State` with B = 1: the loop's
    control (it, done, hist) on the host, the rest on ``device``."""
    host = {"it": torch.int32, "done": torch.bool, "hist": torch.int32}
    fields = {}
    for name in sdp._State._fields:
        if name in host:
            fields[name] = to_torch(state[name]).to(host[name]).reshape(1)
        else:
            fields[name] = to_torch(state[name], device)[None]
    return sdp._State(**fields)


def params_from_dict(d: Dict) -> Params:
    d = dict(d)
    d["rounding"] = Rounding(int(d["rounding"]))
    return Params(**d)


def params_to_dict(p: Params) -> Dict:
    d = dataclasses.asdict(p)
    d["rounding"] = int(p.rounding)
    return d
