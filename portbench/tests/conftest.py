"""CPU tests of the benchmark (``python3 -m pytest portbench/tests``).

Tests marked ``chip`` need an NVIDIA GPU and skip without one, decided
inside the test.  On the card: ``python3 -m pytest portbench/tests -m
chip``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
