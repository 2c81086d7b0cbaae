"""The benchmark's own tests run on the CPU from the root of a checkout:
``python -m pytest benchmark/tests -q``. They import the benchmark as
the package ``benchmark`` and never import JAX."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
