"""The operations and bytes each kernel's work needs at given shapes, and
the least time the card could take for them (``bound_s``).  They follow
from the work alone: each input byte read once, each output byte written
once, whatever a kernel reads again or stages in between."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def bound_s(ops: float, nbytes: float) -> float:
    """The larger of bytes over HBM bandwidth and operations over the
    float32 rate."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["fp32_ops_per_s"])
