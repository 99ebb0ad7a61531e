"""Tests of the benchmark's harness (run them with
`python -m pytest benchmark/tests -q`).  Tests marked `cuda` need the
card and skip without it; the rest run on the CPU at small sizes."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is False")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
