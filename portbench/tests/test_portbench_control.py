"""The control: the reference put in the program's place in bfloat16 comes
out not correct in every cell (at a tiny size here; ``chip`` at the cell's
own size)."""

import pytest

from portbench.control import control
from portbench.manifest import Manifest

from .helpers import SEED, tiny

CELLS = ["qpsk1024.ports", "qpsk1024.i16"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    out = control(tiny(Manifest().cell(workload)), SEED, 4)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["check"].values())


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_full_size(card, workload):
    out = control(Manifest().cell(workload), SEED, 8, device="cuda")
    assert out["correct"] is False
