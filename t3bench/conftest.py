"""Settings of the benchmark's own tests (``python -m pytest t3bench``)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where there is none")


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
