"""Test settings of the benchmark's own tests (``python -m pytest benchmarks/tests``).

Tests that need a CUDA card carry the ``card`` marker, decide inside the
test that there is none, and skip; run them on the card with
``python -m pytest benchmarks/tests -m card``.
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
