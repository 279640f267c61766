"""Settings for the port's parity tests.

One torch thread per test process: the suite runs under several pytest-xdist
workers, and torch's default of one thread per core would oversubscribe the
machine. This file imports no JAX, so the CUDA tests can run where JAX is
absent (``--confcutdir=tests/torch_port`` keeps ``tests/conftest.py`` out).
"""

import torch

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips itself where there is none"
    )
