# NOTE: deliberately NO XLA_FLAGS device-count override here — smoke tests
# and benches must see the single real CPU device. Multi-device tests spawn
# subprocesses with their own env (tests/_subproc.py).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "equivalence: differential DES==vector parity suites "
        "(run standalone via -m equivalence)")
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (CUDA kernels of repro_torch); "
        "skips with a reason where there is none")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
