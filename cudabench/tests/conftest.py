"""CPU tests of the benchmark (``python -m pytest cudabench/tests -q``).
Tests that need a CUDA card carry the ``card`` marker and skip without
one; ``cudabench/README.md`` names the chip command that runs them."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
