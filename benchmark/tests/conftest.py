import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A tiny checkout (benchmark/tests/tiny.py) shared by the tests."""
    from benchmark.tests import tiny

    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def run_tiny(tiny_root):
    """run.run_cell on the tiny checkout, on the CPU."""
    import torch

    from benchmark import run

    torch.set_num_threads(min(4, torch.get_num_threads()))

    def go(cell, seed=20260101, seconds=2.0, trace=False, **kw):
        return run.run_cell(tiny_root, cell, seed, seconds, trace, device="cpu", **kw)
    return go
