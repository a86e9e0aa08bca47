"""Stream metadata and packets: the BulkIO equivalent (host-only copy of
``psk_soft_tpu/runtime/streams.py``).

The reference receives ``dataTransfer`` packets carrying a StreamSRI
(xdelta, mode, streamID), a timestamp, and an EOS flag from its BulkIO input
port (``cpp/psk_soft.cpp:349-363``), and propagates SRI to its output ports
with rate rescaling (``cpp/psk_soft.cpp:392-405``).  Packets are host numpy
arrays.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..config import DemodConfig


@dataclasses.dataclass(frozen=True)
class SRI:
    """Signal-Related Information (BULKIO::StreamSRI equivalent)."""

    stream_id: str
    xdelta: float = 1.0       # seconds between samples
    mode: int = 1             # 1 = complex, 0 = scalar
    xstart: float = 0.0

    @property
    def sample_rate(self) -> float:
        return 1.0 / self.xdelta


@dataclasses.dataclass
class Packet:
    """One data packet (bulkio dataTransfer equivalent).

    data: complex64 samples (or float/int for output ports).
    t: timestamp of the first sample (seconds).
    eos: end-of-stream marker, propagated to consumers.
    sri_changed: whether sri differs from the previous packet's.
    input_queue_flushed: upstream overflow happened before this packet
      (cpp/psk_soft.cpp:353-357 -> full demod state reset).
    """

    data: np.ndarray
    sri: SRI
    t: float = 0.0
    eos: bool = False
    sri_changed: bool = False
    input_queue_flushed: bool = False


# Output port names mirror the SCD port graph (psk_soft.scd.xml:32-73).
PORT_SOFT = "softDecision_dataFloat_out"
PORT_BITS = "bits_dataShort_out"
PORT_PHASE = "phase_dataFloat_out"
PORT_SAMPLE_INDEX = "sampleIndex_dataShort_out"


@dataclasses.dataclass
class PortStats:
    """Per-output-port statistics: the ``ProvidesPortStatisticsProvider``
    analog the reference advertises on every port (psk_soft.scd.xml:86-95;
    bulkio fills rates, queue depths, bytes per port).  One instance per
    port name, updated by the packet layer on every push.
    """

    packets: int = 0          # pushPacket calls ("callsPerSecond" basis)
    items: int = 0            # elements pushed ("elementsPerSecond" basis)
    bytes: int = 0            # payload bytes ("bitsPerSecond" basis)
    eos_count: int = 0
    last_t: float = 0.0       # stream timestamp of the last packet head
    last_wall: float = 0.0    # host wall clock of the last push
    _t0: float = dataclasses.field(default_factory=time.monotonic)

    def update(self, pkt: Packet) -> None:
        self.packets += 1
        self.items += int(pkt.data.size)
        self.bytes += int(pkt.data.nbytes)
        self.eos_count += bool(pkt.eos)
        self.last_t = float(pkt.t)
        self.last_wall = time.monotonic()

    # Rates are lifetime averages over the span since the stats object was
    # created (on the port's first push).  With a single packet that span
    # is ~microseconds and a naive division reads out absurd ~1e12 rates,
    # so all three report 0.0 until a second packet establishes a real
    # span (bulkio's windowed statistics answer the same "no meaningful
    # rate yet" case the same way: zeros).

    def _rate(self, amount: float) -> float:
        if self.packets < 2:
            return 0.0
        return amount / max(self.last_wall - self._t0, 1e-9)

    @property
    def elements_per_second(self) -> float:
        return self._rate(self.items)

    @property
    def calls_per_second(self) -> float:
        return self._rate(self.packets)

    @property
    def bits_per_second(self) -> float:
        return self._rate(8.0 * self.bytes)

    @property
    def time_since_last_call(self) -> float:
        if not self.packets:
            return 0.0
        return max(time.monotonic() - self.last_wall, 0.0)


def record_packets(stats: dict[str, PortStats],
                   pkts: dict[str, Packet] | None):
    """Fold one emitted {port: Packet} dict into a per-port stats map
    (returns ``pkts`` unchanged so emit paths can tail-call it)."""
    if pkts:
        for port, pkt in pkts.items():
            s = stats.get(port)
            if s is None:
                s = stats[port] = PortStats()
            s.update(pkt)
    return pkts


def propagate_sri(cfg: DemodConfig, in_sri: SRI) -> dict[str, SRI]:
    """Output-port SRI with rate rescaling (cpp/psk_soft.cpp:392-405).

    soft:  xdelta *= sps (one value per symbol), complex.
    phase: same rate, real.
    bits:  xdelta *= sps / bits_per_symbol, real.
    sample_index: same rate as soft, real.  (The reference never pushes SRI
    to this port -- a quirk; we emit it, trap (f) beyond SURVEY's list.)
    """
    sym_xdelta = in_sri.xdelta * cfg.sps
    return {
        PORT_SOFT: dataclasses.replace(in_sri, xdelta=sym_xdelta, mode=1),
        PORT_PHASE: dataclasses.replace(in_sri, xdelta=sym_xdelta, mode=0),
        PORT_BITS: dataclasses.replace(
            in_sri, xdelta=sym_xdelta / cfg.bits_per_symbol, mode=0),
        PORT_SAMPLE_INDEX: dataclasses.replace(
            in_sri, xdelta=sym_xdelta, mode=0),
    }
