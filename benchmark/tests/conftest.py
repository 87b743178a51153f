"""The benchmark's own tests: CPU tests at small sizes, and tests marked
`card`, which need a CUDA card and skip without one (python3 -m pytest
benchmark/tests -m card, on the card's machine)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
