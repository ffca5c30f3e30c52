"""Shared fixtures of the benchmark's tests.

``card`` marks a test that needs a CUDA card; the ``card`` fixture skips
it on a machine without one (decided when the test runs, never at import).
"""

import pytest
import torch

from benchmark import run as bench_run


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")
    # the tests run side by side in several workers
    torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench():
    return bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
