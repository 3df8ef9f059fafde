"""The benchmark's own tests (not collected by the repository's Tier-1
run, whose testpaths are ``tests/``): ``python -m pytest -q bench/tests``.

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; the decision is
made inside the fixture, never while a module is imported.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.cuda.get_device_name(0)
