"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from
the root of a checkout. They run on the CPU; tests marked `card` run
only where a CUDA card is (they skip here, and run on the card with the
same command)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device name; skips the test where there is no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one thread: the runs' many Python threads each driving
    a multi-threaded CPU op oversubscribe the cores many times over."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
