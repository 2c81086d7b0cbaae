"""Guards of the port: no JAX inside it, no silent CPU fallback.

clipper_tpu_torch and chip_smoke.py must import neither jax nor anything of
clipper_tpu (only the tests import both), and an entry point that defaults
to the GPU must raise where there is none.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "clipper_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "clipper_tpu"), (path, n)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import clipper_tpu_torch, clipper_tpu_torch.interop\n"
        "import clipper_tpu_torch.bench.harness, clipper_tpu_torch._kernels\n"
        "import clipper_tpu_torch.clipper, clipper_tpu_torch.ops.symstore\n"
        "import clipper_tpu_torch.utils\n"
        "import clipper_tpu_torch.ops.fused_matvec\n"
        "import clipper_tpu_torch.ops.affinity_pallas\n"
        "import clipper_tpu_torch.parallel.batched\n"
        "import clipper_tpu_torch.parallel.buckets\n"
        "import clipper_tpu_torch.bench.cpu_mesh_run\n"
        "import clipper_tpu_torch.bench.build_probe\n"
        "import clipper_tpu_torch.bench.grid_tpu\n"
        "import clipper_tpu_torch.bench.gridcell_probe\n"
        "import clipper_tpu_torch.bench.mixed_bench\n"
        "import clipper_tpu_torch.bench.multistart_bench\n"
        "import clipper_tpu_torch.bench.pool_ab\n"
        "import clipper_tpu_torch.bench.symshard_bench\n"
        "import clipper_tpu_torch.bench.symstore_bench\n"
        "import clipper_tpu_torch.bench.tickstats\n"
        "import clipper_tpu_torch.invariants.pointnormal\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'clipper_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from clipper_tpu_torch import (BucketedPipeline, Clipper,
                                   make_batched_pipeline,
                                   make_pool_multistart_pipeline,
                                   make_pool_pipeline)
    from clipper_tpu_torch.bench.harness import default_invariant
    from clipper_tpu_torch.types import resolve_device
    inv = default_invariant()
    for make in (lambda: make_pool_pipeline(inv, layout="tri"),
                 lambda: make_pool_pipeline(inv, layout="stacked"),
                 lambda: make_pool_multistart_pipeline(inv),
                 lambda: make_batched_pipeline(inv, matvec="fused"),
                 lambda: BucketedPipeline(inv),
                 lambda: Clipper(inv, engine="sharded")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line where
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _kernel_sources():
    return sorted((PORT / "csrc").glob("*.cu*"))


@pytest.mark.parametrize("path", _kernel_sources(),
                         ids=lambda p: p.name)
def test_kernel_source_is_shipped_and_registered(path):
    """Every kernel source and header is in the package data
    (pyproject.toml), every header it includes is a file of csrc/, and a
    .cu file is registered in _kernels.SOURCES with each of its C entry
    points bound in _kernels._SIGNATURES."""
    import fnmatch
    import re
    import tomllib

    from clipper_tpu_torch import _kernels
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["clipper_tpu_torch"]
    rel = str(path.relative_to(PORT))
    assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
    text = path.read_text()
    for inc in re.findall(r'#include "([^"]+)"', text):
        assert (path.parent / inc).is_file(), (path.name, inc)
    if path.suffix == ".cu":
        assert path.stem in _kernels.SOURCES
        c_api = text.split('extern "C"', 1)[1]
        entry = re.findall(r"^int (\w+)\(", c_api, re.M)
        assert entry and all(e in _kernels._SIGNATURES for e in entry), entry
