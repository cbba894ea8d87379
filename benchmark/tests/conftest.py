"""The benchmark's own tests: on the CPU at tiny sizes.  A case that needs
the card carries the ``cuda`` marker and decides inside its fixture."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this case runs on the card")
    return torch.device("cuda")
