"""pytest settings of the benchmark's own tests (`bench_port/tests/`,
run as ``python -m pytest bench_port/tests``; tests marked ``chip`` run
only where a CUDA device is present, on the chip:
``python -m pytest bench_port/tests -m chip``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return "cuda"
