"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
from the root of the repository. Tests marked ``cuda`` run on a CUDA card
(``-m cuda`` on the chip) and skip elsewhere; whether a card is present is
decided inside the ``cuda_device`` fixture, never at import."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (run on the chip with -m cuda)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)
