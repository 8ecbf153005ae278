"""The benchmark's own tests: run with ``python -m pytest portbench/tests``.
Tests marked ``card`` need a CUDA card and skip without one."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
