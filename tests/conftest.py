"""Make ``python -m pytest`` work from the repo root without the
``PYTHONPATH=src`` incantation (which keeps working too — a duplicate
entry is harmless)."""

import os
import sys

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where none is present")
