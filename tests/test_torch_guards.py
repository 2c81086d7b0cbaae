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

import numpy as np
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
        "import clipper_tpu_torch.native.build\n"
        "import clipper_tpu_torch.solvers.dsd\n"
        "import clipper_tpu_torch.solvers.maxclique\n"
        "import clipper_tpu_torch.solvers.extract\n"
        "import clipper_tpu_torch.ops.kcore\n"
        "import clipper_tpu_torch.ops.blocksparse\n"
        "import clipper_tpu_torch.bench.blocksparse_bench\n"
        "import clipper_tpu_torch.solvers.sdp\n"
        "import clipper_tpu_torch.bench.sdp_bench\n"
        "import clipper_tpu_torch.utils.transforms\n"
        "import clipper_tpu_torch.utils.profiling\n"
        "import clipper_tpu_torch.utils.checkpoint\n"
        "import clipper_tpu_torch.compat, clipper_tpu_torch.compat.dsd\n"
        "import clipper_tpu_torch.compat.invariants\n"
        "import clipper_tpu_torch.compat.utils\n"
        "import clipper_tpu_torch.examples.ex1_known_scale_registration\n"
        "import clipper_tpu_torch.examples.ex3_plane_cloud\n"
        "import clipper_tpu_torch.examples.ex4_bunny\n"
        "import clipper_tpu_torch.examples.ex5_large_scale\n"
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
    import clipper_tpu_torch.compat as clipperpy
    from clipper_tpu_torch.bench import blocksparse_bench, sdp_bench
    from clipper_tpu_torch.bench.harness import default_invariant
    from clipper_tpu_torch.examples import (ex1_known_scale_registration,
                                            ex3_plane_cloud, ex4_bunny,
                                            ex5_large_scale)
    from clipper_tpu_torch.solvers import sdp
    from clipper_tpu_torch.utils import checkpoint
    from clipper_tpu_torch.ops import blocksparse, kcore
    from clipper_tpu_torch.solvers import extract_cliques
    from clipper_tpu_torch.types import resolve_device
    import scipy.sparse as sp
    inv = default_invariant()
    M = np.zeros((4, 4))
    for make in (lambda: make_pool_pipeline(inv, layout="tri"),
                 lambda: make_pool_pipeline(inv, layout="stacked"),
                 lambda: make_pool_multistart_pipeline(inv),
                 lambda: make_batched_pipeline(inv, matvec="fused"),
                 lambda: BucketedPipeline(inv),
                 lambda: Clipper(inv, engine="sharded"),
                 lambda: blocksparse.solve_single(M, M, np.ones(4)),
                 lambda: blocksparse.from_dense(M, M),
                 lambda: blocksparse.from_scipy(sp.csr_matrix(M),
                                                sp.csr_matrix(M)),
                 lambda: extract_cliques(M, M, None),
                 lambda: kcore.core_numbers(M),
                 lambda: kcore.kcore_prune_mask(M),
                 lambda: blocksparse_bench.main(["64", "2", "1"]),
                 lambda: sdp.solve(np.eye(4), np.eye(4)),
                 lambda: sdp.solve_batched(np.eye(4)[None], np.eye(4)[None]),
                 lambda: Clipper.solve_as_msrc_sdr_batched(
                     np.eye(4)[None], np.eye(4)[None]),
                 lambda: clipperpy.CLIPPER(inv, clipperpy.Params()),
                 lambda: sdp_bench.main(["--sizes=64"]),
                 lambda: checkpoint.load_solution("unread.npz"),
                 lambda: checkpoint.load_solver_state("unread.npz"),
                 lambda: ex1_known_scale_registration.main([]),
                 lambda: ex3_plane_cloud.main([]),
                 lambda: ex4_bunny.main([]),
                 lambda: ex5_large_scale.main(["64"])):
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


@pytest.mark.parametrize("storage", [torch.int8, torch.bfloat16])
def test_kernel_wrappers_reject_cpu_tensors_and_tiles(storage):
    """Kernels 1, 2, 3, 7, 8 and 9 in int8 and bf16: a wrapper raises on
    CPU tensors (it never gives way to its plain version) and on a tile
    its kernel does not take (1 and 9: t in (128, 256); 3 and 7:
    t = 128)."""
    from clipper_tpu_torch.bench import harness
    from clipper_tpu_torch.ops import flattri, symstore
    idx = torch.zeros(1, dtype=torch.int32)
    f32 = torch.float32
    for t, err, match in ((128, ValueError, "on the card"),
                          (64, NotImplementedError, "t in")):
        with pytest.raises(err, match=match):
            flattri.tri_pool_matvec_cuda(
                torch.zeros(1, 2 * t, t, dtype=storage), 1, idx,
                torch.zeros(1, 1, t), f32)
        with pytest.raises(err, match=match):
            flattri.tri_tiles_matvec_cuda(
                torch.zeros(1, 1, 2 * t, t, dtype=storage), 1, idx,
                torch.zeros(1, t), f32)
    with pytest.raises(ValueError, match="on the card"):
        symstore.sym_rows_matvec_cuda(torch.zeros(1, 256, 128, dtype=storage),
                                      1, torch.zeros(1, 128))
    with pytest.raises(NotImplementedError, match="t = 128"):
        symstore.sym_rows_matvec_cuda(torch.zeros(2, 64, 64, dtype=storage),
                                      2, torch.zeros(1, 64))
    with pytest.raises(ValueError, match="on the card"):
        symstore.sym_tiles_matvec_cuda(
            torch.zeros(1, 256, 128, dtype=storage), 1, torch.zeros(1, 128))
    with pytest.raises(NotImplementedError, match="t = 128"):
        symstore.sym_tiles_matvec_cuda(torch.zeros(3, 64, 32, dtype=storage),
                                       2, torch.zeros(1, 64))
    inv = harness.default_invariant()
    P = torch.zeros(1, 128, 3)
    A = torch.zeros(1, 128, 2, dtype=torch.int32)
    for build in (flattri.build_tri_cuda, flattri.build_tri_fused_cuda):
        with pytest.raises(ValueError, match="on the card"):
            build(inv, P, P, A, torch.tensor([128]), t=128,
                  storage_dtype=storage)
        with pytest.raises(NotImplementedError, match="int8 or bf16"):
            build(inv, P, P, A, torch.tensor([128]), t=128,
                  storage_dtype=torch.float32)


def _native_sources():
    return sorted((PORT / "native").glob("*.cpp"))


@pytest.mark.parametrize("path", _native_sources(), ids=lambda p: p.name)
def test_native_source_is_shipped_and_built(path):
    """Every C++ source of the port's native/ is in the package data and
    in the loader's build list."""
    import fnmatch
    import tomllib

    from clipper_tpu_torch.native import build
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["clipper_tpu_torch"]
    rel = str(path.relative_to(PORT))
    assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
    assert path.name in build.SOURCES


def test_native_loader_writes_only_its_build_dir(tmp_path, monkeypatch):
    """The port's loader builds into build/clipper_tpu_torch/, never under
    clipper_tpu/; a failed build raises (no fallback)."""
    from clipper_tpu_torch.native import build
    assert build.LIB.parent == ROOT / "build" / "clipper_tpu_torch"
    jax_native = ROOT / "clipper_tpu" / "native"
    before = {p: p.stat().st_mtime_ns for p in jax_native.iterdir()}
    lib = build.load()
    assert lib.dsd_solve.restype is not None
    assert build.LIB.is_file() and not build.needs_build()
    out = build.build(tmp_path / "lib.so")
    assert out.is_file() and list(tmp_path.iterdir()) == [out]
    assert {p: p.stat().st_mtime_ns for p in jax_native.iterdir()} == before
    monkeypatch.setattr(build, "_FLAGS", build._FLAGS + ["-Werror=bogus"])
    with pytest.raises(RuntimeError, match="native build failed"):
        build.build(tmp_path / "bad.so")
    assert not (tmp_path / "bad.so").exists()
