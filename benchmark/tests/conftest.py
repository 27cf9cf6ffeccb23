"""The benchmark's CPU tests: run with `python -m pytest benchmark/tests -q`.

Tests that need an NVIDIA GPU carry the `cuda` marker and skip where there
is none; they decide inside the test, never while a module is imported."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where there is none")
