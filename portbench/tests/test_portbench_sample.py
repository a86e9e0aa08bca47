"""The check's sample: a uniform draw of the window's deliveries from the
seed, kept in buffers filled during set-up, so the window adds nothing of
the program's to the heap."""

import numpy as np
import pytest

from portbench.paths import Reservoir, engine

from .helpers import SEED, break_path, run_tiny


def _draw(seed, slots, n):
    r = Reservoir(seed, slots)
    held = list(range(slots))
    for i in range(slots, n):
        j = r.slot(i)
        if j is not None:
            held[j] = i
    return held


def test_the_seed_gives_the_sample():
    assert _draw(SEED, 8, 500) == _draw(SEED, 8, 500)
    assert _draw(SEED, 8, 500) != _draw(SEED + 1, 8, 500)
    assert [Reservoir(SEED, 8).slot(i) for i in range(8)] == list(range(8))


@pytest.mark.parametrize("late", [False, True], ids=["early", "late"])
def test_every_delivery_as_likely(late):
    """Over many seeds, the window's first and last deliveries are kept
    about as often as slots / deliveries says."""
    n, slots, seeds = 64, 8, 2000
    i = n - 1 if late else 0
    kept = sum(i in _draw(s, slots, n) for s in range(seeds))
    assert abs(kept / seeds - slots / n) < 0.04


def test_the_window_keeps_no_program_arrays(monkeypatch):
    seen = {}

    def watch(path):
        seen["path"] = path
        seen["buffers"] = [b.ctypes.data for b in path.kept]

    break_path(monkeypatch, watch)
    line, _ = run_tiny("qpsk1024.ports")
    path = seen["path"]
    assert line["correct"]
    assert [b.ctypes.data for b in path.kept] == seen["buffers"]
    assert (path.kept_block >= 0).all()
    assert all(b.base is None for b in path.kept)
    assert isinstance(path, engine.Path)
    assert np.unique(path.kept_block).size == path.kept_block.size
