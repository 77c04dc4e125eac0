"""Shared set-up of the benchmark's own tests: the benchmark's folder, the
checkout and this folder on the import path, and the fixture that skips a
test without a card."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent), str(HERE.parents[1])):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
