"""Single-stream engines, the serviceFunction equivalent, and the engine
observability and feed-forward carry resync shared by the bank engines
(port of ``psk_soft_tpu/runtime/engine_stream.py:32-385``).

StreamEngine mirrors the reference's per-packet service loop (C4,
cpp/psk_soft.cpp:346-618): getPacket -> flush/mode/reset checks -> property
snapshot -> SRI propagation -> block step -> four conditional pushPackets.
The stream runs as a one-channel batch on the engine's device ("cuda"
unless the caller asks for the CPU).  StreamRegistry multiplexes streamIDs
to per-stream engines (BulkIO port semantics).  Part of the runtime/engine
facade.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Callable, Optional

import numpy as np
import torch

from .. import state as state_mod
from ..config import DemodConfig
from ..models import blockpsk, psk
from .engine_bank import to_host
from .streams import (SRI, Packet, PortStats, PORT_BITS, PORT_PHASE,
                      PORT_SAMPLE_INDEX, PORT_SOFT, propagate_sri,
                      record_packets)

# Structured logging in place of the reference's log4cxx macros
# (cpp/psk_soft.cpp:33,355,361,639-650).
logger = logging.getLogger("psk_soft_tpu_torch.engine")


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


class _PipelineOps:
    """Pipeline-kind dispatch: exact scan vs feed-forward.  ``init(cfg,
    channels, device)`` is the fresh carry; ``block(cfg, state, x, **kw)``
    the (C, T) block step."""

    def __init__(self, kind: str):
        if kind == "ff":
            self.init = blockpsk.ff_init
            self.block = blockpsk.demod_block_ff
        elif kind == "exact":
            self.init = state_mod.init_state
            self.block = psk.demod_block
        else:
            raise ValueError(f"unknown pipeline {kind!r}")
        self.kind = kind


class StreamEngine:
    """Single-stream streaming demodulator with reference service
    semantics, on ``device``."""

    def __init__(self, cfg: DemodConfig, block_symbols: int = 512,
                 pipeline: str = "ff", *, device="cuda"):
        self.cfg = cfg
        self.block_symbols = int(block_symbols)
        self.device = torch.device(device)
        self._ops = _PipelineOps(pipeline)
        self._state = self._ops.init(cfg, 1, self.device)
        self._staging = np.zeros(0, np.complex64)
        self._sri: Optional[SRI] = None
        self._sri_dirty = True
        # Per-output-port counters (ProvidesPortStatisticsProvider analog,
        # psk_soft.scd.xml:86-95).
        self.port_stats: dict[str, PortStats] = {}
        self._time_origin: Optional[float] = None  # time of stream sample 0
        self._symbols_emitted = 0    # valid outputs so far (for timestamps)
        self._symbols_consumed = 0   # whole symbols fed to the device
        self.metrics = EngineMetrics()

    # ------------------------------------------------------------- config

    def configure(self, new_cfg: DemodConfig) -> None:
        """Live property change: explicit resync (C7 semantics,
        cpp/psk_soft.cpp:365-426,619-651) -- the carry is re-derived, not
        cleared, so tracking survives compatible changes."""
        if new_cfg == self.cfg:
            return
        logger.debug("reconfigure: %s -> %s", self.cfg, new_cfg)
        if self._ops.kind == "exact":
            self._state = state_mod.reconfigure(self.cfg, new_cfg,
                                                self._state)
        else:
            self._state = reconfigure_ff(self.cfg, new_cfg, self._state)
        self.cfg = new_cfg
        self._sri_dirty = True
        # Back to the flexible (warm-up-capable) step: a resync may leave
        # partially filled windows.
        self._symbols_consumed = 0
        # Re-anchor timestamps: the resync changes the symbol period and may
        # suppress emission for a re-warm-up.
        self._symbols_emitted = 0
        self._time_origin = None
        self.metrics.reconfigures += 1

    def reset(self) -> None:
        """Full demod state reset (the resetState property,
        psk_soft.prf.xml:55-60, consumed at cpp/psk_soft.cpp:365-372)."""
        self._state = self._ops.init(self.cfg, 1, self.device)
        self._staging = np.zeros(0, np.complex64)
        self._symbols_emitted = 0
        self._symbols_consumed = 0
        self._time_origin = None  # re-anchor timestamps at the next packet
        self.metrics.resets += 1

    def _reset_phase_only(self) -> None:
        """Clear only the phase-fit history (LinearFit::reset with a new
        sample rate, cpp/psk_soft.cpp:89-102): timing window, warm-up and
        staging survive."""
        fresh = self._ops.init(self.cfg, 1, self.device)
        if self._ops.kind == "ff":
            self._state = self._state._replace(
                phase_hist=fresh.phase_hist, phase_count=fresh.phase_count,
                last_phase=fresh.last_phase)
        else:
            self._state = self._state._replace(
                ring=fresh.ring, ring_pos=fresh.ring_pos,
                ring_fill=fresh.ring_fill, phase_est=fresh.phase_est)

    # ------------------------------------------------------------- data

    def process(self, packet: Packet) -> dict[str, Packet]:
        """Feed one input packet; returns {port_name: Packet} for non-empty
        outputs (like the four conditional pushPackets,
        cpp/psk_soft.cpp:605-615)."""
        self.metrics.packets_in += 1
        if packet.input_queue_flushed:
            # cpp/psk_soft.cpp:353-357: data was dropped upstream; restart
            # tracking rather than demodulate across the gap.
            logger.warning("input queue flushed - data has been thrown on "
                           "the floor; flushing internal buffers (stream %s)",
                           packet.sri.stream_id)
            self.reset()
        if packet.sri.mode != 1:
            # cpp/psk_soft.cpp:359-363: cannot work with real data.
            logger.warning("cannot work with real data (stream %s mode=%d)",
                           packet.sri.stream_id, packet.sri.mode)
            self.metrics.real_mode_drops += 1
            return {}
        if self._sri is None or packet.sri != self._sri or packet.sri_changed:
            if self._sri is not None and packet.sri.xdelta != self._sri.xdelta:
                # A rate change invalidates only the phase-tracker history
                # (cpp/psk_soft.cpp:394-397; the timing deques survive).
                self._reset_phase_only()
                # Re-anchor the timestamp base at this packet's T: staged
                # old-rate samples ahead of it move to the new clock
                # (bounded by one block).
                self._time_origin = packet.t - \
                    packet.sri.xdelta * float(self._staging.size)
                self._symbols_emitted = 0
            self._sri = packet.sri
            self._sri_dirty = True

        data = np.asarray(packet.data, np.complex64).ravel()
        if self._time_origin is None:
            self._time_origin = packet.t
        self.metrics.samples_in += data.size
        self._staging = np.concatenate([self._staging, data])

        outputs = self._drain(final=packet.eos)
        if packet.eos:
            self.metrics.eos_seen += 1
            outputs = self._mark_eos(outputs, packet)
        return record_packets(self.port_stats, outputs)

    # ------------------------------------------------------------- internals

    def _step_fn(self, steady: bool) -> Callable:
        """The block step; steadiness only picks the feed-forward
        pipeline's ``assume_steady`` program."""
        if self._ops.kind == "ff":
            return functools.partial(self._ops.block, self.cfg,
                                     assume_steady=steady)
        return functools.partial(self._ops.block, self.cfg)

    def _is_steady(self) -> bool:
        """Warm-up fully behind us: timing window full and tracker window
        full; the steady program then skips all warm-up machinery."""
        return (self._ops.kind == "ff" and self._symbols_consumed
                >= self.cfg.num_avg + self.cfg.phase_avg)

    def _drain(self, final: bool) -> dict[str, Packet]:
        sps = self.cfg.sps
        block = self.block_symbols * sps
        chunks = []
        while self._staging.size >= block:
            chunks.append(self._run_block(self._staging[:block]))
            self._staging = self._staging[block:]
        if final and self._staging.size >= sps:
            n = (self._staging.size // sps) * sps
            chunks.append(self._run_block(self._staging[:n]))
            self._staging = self._staging[n:]
        if final:
            self._staging = np.zeros(0, np.complex64)
        return self._assemble(chunks)

    def _run_block(self, samples: np.ndarray):
        fn = self._step_fn(self._is_steady())
        x = torch.from_numpy(np.array(samples[None])).to(self.device)
        self._state, out = fn(self._state, x)
        self._symbols_consumed += samples.size // self.cfg.sps
        return out

    def _assemble(self, chunks) -> dict[str, Packet]:
        if not chunks:
            return {}
        # Channel 0 of each (1, S) chunk, on the host.
        chunks = [psk.DemodOutputs(*(to_host(f)[0] for f in c))
                  for c in chunks]
        valid = np.concatenate([c.valid for c in chunks])
        if not valid.any():
            return {}
        soft = np.concatenate([c.soft for c in chunks])[valid]
        bits3 = np.concatenate([c.bits for c in chunks])[valid]
        phase = np.concatenate([c.phase for c in chunks])[valid]
        sidx = np.concatenate([c.sample_index for c in chunks])[valid]
        nb = self.cfg.bits_per_symbol
        bits = bits3[:, :nb].reshape(-1).astype(np.int16)

        sri = self._sri or SRI(stream_id="unknown")
        out_sri = propagate_sri(self.cfg, sri)
        # Timestamp: the first emitted symbol of this batch is stream symbol
        # k0 = symbols_emitted; its first sample's time is origin+k0*sps*xdelta.
        # (Deviation: the reference stamps outputs with the triggering
        # *input* packet's T, cpp/psk_soft.cpp:608-615, which is off by the
        # window latency; this stamps the actual symbol time.)
        k0 = self._symbols_emitted
        t_out = (self._time_origin or 0.0) + sri.xdelta * self.cfg.sps * k0

        self._symbols_emitted += int(valid.sum())
        self.metrics.symbols_out += int(valid.sum())
        self.metrics.bits_out += bits.size

        sri_changed = self._sri_dirty
        self._sri_dirty = False

        def pkt(data, port):
            return Packet(data=data, sri=out_sri[port], t=t_out,
                          sri_changed=sri_changed)

        return {
            PORT_SOFT: pkt(soft, PORT_SOFT),
            PORT_BITS: pkt(bits, PORT_BITS),
            PORT_PHASE: pkt(phase.astype(np.float32), PORT_PHASE),
            PORT_SAMPLE_INDEX: pkt(sidx.astype(np.int16), PORT_SAMPLE_INDEX),
        }

    def _mark_eos(self, outputs, packet) -> dict[str, Packet]:
        # EOS must reach consumers even if no data is emitted.
        if not outputs:
            sri = self._sri or packet.sri
            out_sri = propagate_sri(self.cfg, sri)
            outputs = {p: Packet(data=np.zeros(0, np.float32), sri=s,
                                 t=packet.t)
                       for p, s in out_sri.items()}
        for p in outputs.values():
            p.eos = True
        return outputs


def reconfigure_ff(old_cfg: DemodConfig, new_cfg: DemodConfig,
                   state: blockpsk.FFState) -> blockpsk.FFState:
    """C7 resync of the feed-forward carry (reference
    cpp/psk_soft.cpp:408-426, 619-651), on the carry's device:

    * sps / num_avg change: keep up to the new window's worth of the most
      recent samples, re-binned (:func:`state.resync_window`);
    * constellation change: the phase history is cleared;
    * phase_avg change: the history keeps its newest points.

    Host-side numpy (shapes change), once per property change."""
    dev = state.seen.device
    st = blockpsk.FFState(*(t.cpu().numpy() for t in state))
    channel_shape = np.shape(st.seen)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731,E501
    new = state_mod.resync_carry(old_cfg, new_cfg, st, blockpsk.ff_init(
        new_cfg, channel_shape[0], dev), to)

    if old_cfg.constellation_size != new_cfg.constellation_size:
        return new  # phase history force-cleared (cpp/psk_soft.cpp:416-420)

    n_old, n_new = old_cfg.phase_avg, new_cfg.phase_avg
    hist = st.phase_hist                          # right-aligned (n_old-1,)
    # The history keeps at most n_old-1 live values (the n-th lives only in
    # the fit), so the carried count is capped by what survives.
    count = np.minimum(st.phase_count, max(n_old - 1, 1))
    keep = np.minimum(count, max(n_new - 1, 0))
    m = max(n_new - 1, 0)
    L = max(n_old - 1, 0)
    # Right-align the newest keep values: new[..., s] = hist[..., L-m+s]
    # masked to s >= m-keep.
    if m > 0 and L > 0:
        s = np.arange(m)
        idx = np.broadcast_to(np.clip(L - m + s, 0, L - 1),
                              channel_shape + (m,))
        gathered = np.take_along_axis(hist, idx, axis=-1)
        mask = s >= (m - keep[..., None])
        new_hist = np.where(mask, gathered, 0.0).astype(np.float32)
    else:
        new_hist = np.zeros(channel_shape + (m,), np.float32)
    return new._replace(
        phase_hist=to(new_hist),
        phase_count=to(np.minimum(count, n_new).astype(np.int32)),
        last_phase=to(st.last_phase),
    )


class StreamRegistry:
    """Route interleaved packets of multiple streams to per-stream engines.

    BulkIO ports multiplex streams by streamID with independent SRI/EOS per
    stream; the reference component handles one stream at a time.  Each
    streamID gets its own StreamEngine (created on its first packet with
    the registry's config and device); EOS retires the stream.
    """

    def __init__(self, cfg: DemodConfig, block_symbols: int = 512,
                 pipeline: str = "ff", max_streams: int = 1024, *,
                 device="cuda"):
        self.cfg = cfg
        self.block_symbols = block_symbols
        self.pipeline = pipeline
        self.max_streams = max_streams
        self.device = torch.device(device)
        self.engines: dict[str, StreamEngine] = {}

    def process(self, packet: Packet) -> dict[str, Packet]:
        sid = packet.sri.stream_id
        eng = self.engines.get(sid)
        if eng is None:
            if len(self.engines) >= self.max_streams:
                raise RuntimeError(f"stream limit {self.max_streams} reached")
            eng = StreamEngine(self.cfg, self.block_symbols, self.pipeline,
                               device=self.device)
            self.engines[sid] = eng
        out = eng.process(packet)
        if packet.eos:
            del self.engines[sid]
        return out

    def configure(self, new_cfg: DemodConfig) -> None:
        self.cfg = new_cfg
        for eng in self.engines.values():
            eng.configure(new_cfg)
