"""The port's examples (clipper_tpu_torch/examples/) run end to end on the
CPU with --device=cpu, assert their own results and print their JAX
twins' marker lines (mirrors tests/test_examples.py, slow marks too)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def run_example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m",
                        f"clipper_tpu_torch.examples.{name}", *args,
                        "--device=cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900, env=env)
    assert r.returncode == 0, f"{name} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def test_ex1():
    out = run_example("ex1_known_scale_registration")
    assert "selected 3 associations" in out
    assert "recovered rotation error" in out


def test_ex3():
    out = run_example("ex3_plane_cloud")
    assert "recovered rotation" in out


@pytest.mark.slow
def test_ex4():
    out = run_example("ex4_bunny")
    assert "precision" in out


@pytest.mark.slow
def test_ex5():
    # m=2048 keeps the CPU run short; the example defaults to m=16,384
    out = run_example("ex5_large_scale", "2048")
    assert "facade triangle engine" in out
    assert "sharded facade engine" in out
    assert "precision" in out


def test_examples_raise_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from clipper_tpu_torch.examples import (ex1_known_scale_registration,
                                            ex3_plane_cloud, ex4_bunny,
                                            ex5_large_scale)
    for mod in (ex1_known_scale_registration, ex3_plane_cloud, ex4_bunny,
                ex5_large_scale):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])
