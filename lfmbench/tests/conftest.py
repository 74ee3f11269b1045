"""The benchmark's own tests: ``python -m pytest lfmbench/tests -q`` from the
checkout's root. Tests that need a CUDA device carry the ``cuda`` marker
and skip inside the test when none is visible."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test without one")
