"""Kernel B1, the steady-state demodulator of one block: timing over the
window, the decision sample, the M-th power phase, the unwrap, the
phase_avg-point fit, derotation and slicing, for every channel.

Bytes: the block's I/Q planes and the (num_avg - 1) * sps rows of window
before it in, the carry in and out (the phase history, a 9-point trend
history of cos and sin and 8 scalars, in rows of 8), soft I/Q and packed
bits out, and with the debug ports the phase (float32) and the sample
index (one byte).  Operations: per input sample its energy (3); per symbol
the M-th power, three atan2/sincos, the 9-tap trend and the fit (about
2 * phase_avg + 40)."""

from __future__ import annotations

TREND = 9


def carry_rows(phase_avg: int) -> int:
    raw = (phase_avg - 1) + 2 * (TREND - 1) + 8
    return -(-raw // 8) * 8


def work(channels: int, symbols: int, sps: int, num_avg: int,
         phase_avg: int, in_bytes: int = 4, soft_bytes: int = 4,
         debug_ports: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one launch."""
    c, need = channels, symbols * sps
    rows = carry_rows(phase_avg)
    nbytes = (2 * (num_avg - 1) * sps * c + 2 * need * c) * in_bytes \
        + 2 * rows * c * 4 + 2 * symbols * c * soft_bytes + symbols * c
    if debug_ports:
        nbytes += symbols * c * (4 + 1)
    ops = 3 * need * c + symbols * c * (2 * phase_avg + 40)
    return float(ops), float(nbytes)
