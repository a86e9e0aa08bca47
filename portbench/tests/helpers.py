"""Tiny sizes at which a whole cell runs on the CPU, with the program's
plain versions of its kernels, and a way to break its timed path."""

import time

from portbench.manifest import Manifest
from portbench.paths import engine
from portbench.run import run_cell

TINY_CONFIG = {"channels": 128, "block_symbols": 256}
TINY_TRAFFIC = {"pool_blocks": 4, "warmup_blocks": 3, "check_blocks": 4,
                "trace_blocks": 3}
SEED = 2 ** 31 + 1234567


def tiny(cell):
    """``cell`` cut to the tiny sizes."""
    cell.config = dict(cell.config, **TINY_CONFIG)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    return cell


def run_tiny(workload, seconds=1.0, trace=False, man=None, seed=SEED):
    cell = tiny((man or Manifest()).cell(workload))
    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())


def break_path(monkeypatch, fault):
    """Every engine path opened from now on has ``fault(path)`` applied
    before its warm-up."""
    real = engine.Path

    class Broken(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            fault(self)

    monkeypatch.setattr(engine, "Path", Broken)
