"""pytest settings of the benchmark's own tests (no JAX here): the `cuda`
marker of tests that need an NVIDIA GPU."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)          # several test workers share the host
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips itself where "
                   "torch sees none")
