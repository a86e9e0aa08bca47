"""The plain reference agrees with the port's plain path, and the roofline
functions give the bounds the kernel table records."""

import pytest
import torch

from portbench.reference import psk
from portbench.rooflines import b1, b2, bound_s

from .helpers import run_tiny


@pytest.mark.parametrize("workload", ["qpsk1024.ports", "qpsk1024.i16"])
def test_reference_agrees_with_the_plain_path(workload):
    """Each cell run whole at a tiny size on the CPU, where the port's
    kernels run their plain versions: every compared number at or under
    its limit, every block delivered well formed."""
    line, info = run_tiny(workload)
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert info["blocks_compared"] > 0


def test_fit_weights_fit_a_line():
    for n in (1, 2, 5, 50):
        w = psk.fit_weights(n, torch.float64, "cpu")
        y = 3.0 + 0.25 * torch.arange(n, dtype=torch.float64)
        assert abs(float(w @ y) - float(y[-1])) < 1e-12


def test_rooflines_at_the_kernel_table_shapes():
    ops, nbytes = b1.work(1024, 512, 8, 100, 50)
    assert round(nbytes / 1e6, 1) == 45.4
    assert round(bound_s(ops, nbytes) * 1e3, 4) == 0.0136
    ops, nbytes = b2.work(6144, 64)
    assert round(ops / 1e6) == 277
    assert round(bound_s(ops, nbytes) * 1e3, 4) == 0.0041
    # int16 planes, int8 soft: fewer bytes; the debug planes: more.
    assert b1.work(1024, 512, 8, 100, 50, 2, 1)[1] < \
        b1.work(1024, 512, 8, 100, 50)[1] < \
        b1.work(1024, 512, 8, 100, 50, debug_ports=True)[1]
