"""clipperpy.dsd-compatible namespace (reference:
bindings/python/py_clipper.cpp:103-112; the reference's binding registers
the utils module under the dsd name, this is the intended surface)."""

from clipper_tpu_torch.solvers.dsd import solve  # noqa: F401
