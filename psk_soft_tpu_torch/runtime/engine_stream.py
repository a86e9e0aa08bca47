"""Engine observability shared by the engines (port of the counters in
``psk_soft_tpu/runtime/engine_stream.py:20-43``).  The single-stream
``StreamEngine`` itself is a later ROADMAP step."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EngineMetrics:
    """Observability counters (symbols out, resyncs, ...)."""

    packets_in: int = 0
    samples_in: int = 0
    symbols_out: int = 0
    bits_out: int = 0
    resets: int = 0
    reconfigures: int = 0
    real_mode_drops: int = 0
    eos_seen: int = 0
