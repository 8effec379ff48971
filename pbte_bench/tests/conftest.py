"""The benchmark's CPU tests: the repository root on the path, the
``card`` marker for tests that need the CUDA device (they skip without
one, decided inside the test), and few threads."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)
