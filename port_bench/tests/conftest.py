"""Test settings of the port's benchmark.

The marker ``card`` marks a test that needs a CUDA card; the ``card``
fixture decides at run time whether there is one and skips with a reason
where there is none. Nothing here decides while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this machine has none")
    return torch.device("cuda:0")
