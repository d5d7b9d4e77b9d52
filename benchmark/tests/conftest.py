"""The benchmark's tests: CPU tests at tiny widths, and tests marked
``card`` that need a CUDA card (they skip without one, deciding inside
the test)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
