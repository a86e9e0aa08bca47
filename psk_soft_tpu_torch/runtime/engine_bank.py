"""Bank packet layer: time-major outputs, SRI/timestamp assembly, and
deferred-assembly pipelining (port of
``psk_soft_tpu/runtime/engine_bank.py:20-338``).

The device->host fetch is ``tensor.cpu().numpy()``.  Pipelining defers it
by ``pipeline_depth`` blocks (the JAX engine's contract); everything runs on
one CUDA stream, so a deferred fetch still queues behind the newer block's
upload and kernel (PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DemodConfig
from ..models.full import QuantSoft, dequantize_soft
from ..utils.profiling import TRACER
from . import native_assemble
from .streams import (SRI, Packet, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX,
                      PORT_SOFT, propagate_sri, record_packets)


def to_host(x):
    """numpy copy of a tensor (None and non-tensors pass through); a
    fetch from a device counts in ``psk.engine.d2h_*``."""
    if not isinstance(x, torch.Tensor):
        return x
    if TRACER.on and x.device.type != "cpu":
        TRACER.count("psk.engine.d2h_bytes", x.numel() * x.element_size())
        TRACER.count("psk.engine.d2h_copies")
    return x.cpu().numpy()


@dataclasses.dataclass
class TMOutputs:
    """Raw kernel block outputs on their way to packet assembly: the
    device-resident time-major planes as the kernel wrote them, plus the
    flush-path row validity mask, the soft_i8 scale and the block's
    ordinal among the engine's steady blocks (its spans' ``block``).  The
    packet fast path (BankAssembler.assemble_tm) fetches these planes and
    builds the channel-major payloads on the host."""

    fo: object                      # models/full.FullOutputs (device)
    valid_rows: object = None       # np bool (S,) or None = all valid
    soft_scale: float | None = None
    block: int | None = None


class BankAssembler:
    """SRI/timestamp packet assembly for a channel bank: one SRI governs
    the aligned bank; packet data carries the leading channel axis.
    Timestamps are symbol k0's first-sample time from the bank's time
    origin."""

    def __init__(self, cfg: DemodConfig, skip_debug: bool = False,
                 skip_data: bool = False):
        self.cfg = cfg
        # skip_debug: phase/sampleIndex ports unconnected (never assembled;
        # the kernel never writes their planes).  skip_data: soft/bits
        # unconnected too -- only the symbol clock advances.
        self.skip_debug = skip_debug
        self.skip_data = skip_data
        native_assemble.load()      # build before the first block
        self.sri: Optional[SRI] = None
        self._dirty = True
        self._t0: Optional[float] = None
        self._k0 = 0

    def set_sri(self, sri: SRI, t: float = 0.0) -> None:
        """Declare the bank's input SRI (call before/whenever it changes)."""
        if self.sri is None or sri != self.sri:
            if self.sri is not None and sri.xdelta != self.sri.xdelta:
                self._t0 = t          # rate change: re-anchor the clock
                self._k0 = 0
            self.sri = sri
            self._dirty = True
        if self._t0 is None:
            self._t0 = t

    def reconfigure(self, cfg: DemodConfig) -> None:
        """New config: the output SRIs change and the clock re-anchors."""
        self.cfg = cfg
        self._dirty = True
        self._k0 = 0
        self._t0 = None

    def reset(self) -> None:
        self._k0 = 0
        self._t0 = None

    def _advance_clock(self, sv: int, eos: bool):
        """The packet bookkeeping both assembly routes share: output SRIs,
        this batch's head timestamp (symbol clock advanced by sv emitted
        symbols), the sriChanged handshake, and the Packet constructor."""
        sri = self.sri or SRI(stream_id="bank")
        out_sri = propagate_sri(self.cfg, sri)
        t_out = (self._t0 or 0.0) + sri.xdelta * self.cfg.sps * self._k0
        self._k0 += sv
        sric = self._dirty
        self._dirty = False

        def pkt(data, port):
            return Packet(data=data, sri=out_sri[port], t=t_out,
                          sri_changed=sric, eos=eos)

        return pkt

    def assemble(self, out, eos: bool = False) -> dict[str, Packet]:
        """Channel-major DemodOutputs -> {port: Packet} with propagated SRI,
        symbol-accurate timestamps, and EOS marking."""
        sri = self.sri or SRI(stream_id="bank")
        out_sri = propagate_sri(self.cfg, sri)
        if out is None:
            if not eos:
                return {}
            return {p: Packet(data=np.zeros(0, np.float32), sri=s,
                              t=(self._t0 or 0.0), eos=True)
                    for p, s in out_sri.items()
                    if not (self.skip_debug
                            and p in (PORT_PHASE, PORT_SAMPLE_INDEX))}
        with TRACER.span("psk.engine.fetch"):
            valid = to_host(out.valid)
        v = valid[0] if valid.ndim > 1 else valid   # lockstep bank
        if self.skip_data:
            self._advance_clock(int(v.sum()), eos)
            return {}
        if not v.any():
            return self.assemble(None, eos=eos)
        soft = out.soft
        debug = not self.skip_debug
        with TRACER.span("psk.engine.fetch"):
            if isinstance(soft, QuantSoft):
                soft = QuantSoft(to_host(soft.re_q), to_host(soft.im_q),
                                 soft.scale)
            soft = to_host(soft)
            bits3 = to_host(out.bits)
            phase = to_host(out.phase) if debug else None
            sidx = to_host(out.sample_index) if debug else None
        soft = dequantize_soft(soft)[:, v]
        nb = self.cfg.bits_per_symbol
        bits = bits3[:, v][:, :, :nb].reshape(bits3.shape[0], -1).astype(
            np.int16)

        pkt = self._advance_clock(int(v.sum()), eos)
        pkts = {PORT_SOFT: pkt(soft, PORT_SOFT),
                PORT_BITS: pkt(bits, PORT_BITS)}
        if phase is not None:
            pkts[PORT_PHASE] = pkt(phase[:, v].astype(np.float32), PORT_PHASE)
        if sidx is not None:
            pkts[PORT_SAMPLE_INDEX] = pkt(sidx[:, v].astype(np.int16),
                                          PORT_SAMPLE_INDEX)
        return pkts

    def assemble_tm(self, tm: TMOutputs, eos: bool = False) -> dict[str, Packet]:
        """Packet assembly straight from the kernel's time-major planes:
        fetch the raw planes, then build the same packet payloads as
        :meth:`assemble` in one native pass a port
        (``runtime/native_assemble``), each into a fresh array."""
        fo = tm.fo
        v = tm.valid_rows
        if self.skip_data:
            sv = fo.soft_re.shape[0] if v is None else int(v.sum())
            self._advance_clock(sv, eos)
            return {}
        with TRACER.span("psk.engine.fetch", tm.block):
            s_re, s_im, phase_p, packed, sidx_p = (
                to_host(a) for a in (fo.soft_re, fo.soft_im, fo.phase,
                                     fo.bits_packed, fo.sample_index))
        if v is not None and not v.any():
            return self.assemble(None, eos=eos)
        if v is not None:
            s_re, s_im, packed = s_re[v], s_im[v], packed[v]
            phase_p = None if phase_p is None else phase_p[v]
            sidx_p = None if sidx_p is None else sidx_p[v]
        pkt = self._advance_clock(s_re.shape[0], eos)

        soft_t = native_assemble.soft(s_re, s_im, tm.soft_scale)  # (Sv, C)
        bits = native_assemble.bits(packed, self.cfg.bits_per_symbol)
        pkts = {PORT_SOFT: pkt(soft_t.T, PORT_SOFT),         # (C, Sv) view
                PORT_BITS: pkt(bits, PORT_BITS)}             # (C, Sv*nb)
        if not self.skip_debug and phase_p is not None:
            pkts[PORT_PHASE] = pkt(native_assemble.phase(phase_p),
                                   PORT_PHASE)
        if not self.skip_debug and sidx_p is not None:
            pkts[PORT_SAMPLE_INDEX] = pkt(
                native_assemble.sample_index(sidx_p), PORT_SAMPLE_INDEX)
        return pkts


class _PipelinedPackets:
    """Deferred-assembly packet pipelining.

    With ``pipeline_depth = d > 0``, ``step_packets`` dispatches block k to
    the device but assembles (device->host fetch) block k-d.  Depth 0 keeps
    the synchronous one-in/one-out contract.  Output packets are identical
    either way, only their emission is delayed by d calls; EOS drains
    everything.
    """

    def _init_pipeline(self, depth: int) -> None:
        if depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        self._pipe_depth = int(depth)
        self._pending: list = []     # device outputs not yet assembled
        self._held: list = []        # assembled packets not yet returned
        self._device_tap_fn = None
        self.port_stats: dict = {}   # per-output-port PortStats

    def set_device_tap(self, fn) -> None:
        """Register an observer called with each raw block output
        (TMOutputs or channel-major DemodOutputs, still on the engine's
        device) right before packet assembly fetches it, so a downstream
        stage (runtime/framesync.FrameSyncer) reads the kernel's planes
        without a plane-sized host transfer.  One slot; None clears it."""
        self._device_tap_fn = fn

    def push_block(self, block) -> None:
        """Channel-major (C, n) complex64 append (NativeChannelBank's
        ``pop_block`` layout, and the front ends' lockstep output): row c
        goes through ``push(c, ...)``, so an engine's ingest rules (no
        mixing with plane staging) hold.  A tensor is read to the host,
        where the per-channel staging lives."""
        block = np.asarray(to_host(block), np.complex64)
        if block.ndim != 2 or block.shape[0] != self.channels:
            raise ValueError(f"expected ({self.channels}, n) block")
        for c in range(self.channels):
            self.push(c, block[c])

    def _emit(self, out, eos: bool = False) -> dict[str, Packet]:
        tm = isinstance(out, TMOutputs)
        with TRACER.span("psk.engine.emit", out.block if tm else None):
            if out is not None and self._device_tap_fn is not None:
                self._device_tap_fn(out)
            if tm:
                pkts = self.assembler.assemble_tm(out, eos=eos)
            else:
                pkts = self.assembler.assemble(out, eos=eos)
            if self._pipe_depth:
                # Depth 0 counts eagerly in step()/flush(); pipelined blocks
                # are only fetched (and hence countable) here.
                soft = pkts.get(PORT_SOFT)
                if soft is not None:
                    self.metrics.symbols_out += int(soft.data.size)
                bitsp = pkts.get(PORT_BITS)
                if bitsp is not None:
                    self.metrics.bits_out += int(bitsp.data.size)
            return record_packets(self.port_stats, pkts)

    def _drain_pending(self) -> None:
        """Assemble every in-flight block now; the packets are held and
        returned first by the next step_packets calls.  configure() calls
        this so blocks computed under the old config never get the new
        config's SRI and timestamps."""
        for out in self._pending:
            pkts = self._emit(out)
            if pkts:
                self._held.append(pkts)
        self._pending.clear()

    def step_packets(self) -> Optional[dict[str, Packet]]:
        """step() + packet assembly: {port: Packet} with SRI/timestamps.
        Returns None when nothing is ready to emit (distinct from {} = a
        block ran but emitted nothing).  Packets held back by a
        reconfigure come out first, one per call."""
        if self._held:
            return self._held.pop(0)
        out = self._step_core()
        if self._pipe_depth == 0:
            return None if out is None else self._emit(out)
        if out is not None:
            self._pending.append(out)
        if len(self._pending) > self._pipe_depth:
            return self._emit(self._pending.pop(0))
        return None

    def flush_packets(self) -> dict[str, Packet]:
        """flush() + assembly, EOS-marked on every port.  Held packets and
        pipelined blocks still in flight are assembled first and merged
        along the symbol axis, so the merged packet's head timestamp stays
        symbol-accurate."""
        dicts = list(self._held)
        self._held = []
        dicts += [p for p in (self._emit(o) for o in self._pending) if p]
        self._pending = []
        dicts.append(self._emit(self._flush_core(), eos=True))
        return _merge_packet_dicts(dicts)


def _merge_packet_dicts(dicts: list[dict[str, Packet]]) -> dict[str, Packet]:
    """Concatenate per-port packets from consecutive blocks of one bank."""
    dicts = [d for d in dicts if d]
    if not dicts:
        return {}
    if len(dicts) == 1:
        return dicts[0]
    merged = {}
    for port in dicts[0]:
        ps = [d[port] for d in dicts if port in d]
        datas = [p.data for p in ps if p.data.size]
        data = (np.concatenate(datas, axis=-1) if datas else ps[0].data)
        merged[port] = Packet(
            data=data, sri=ps[-1].sri, t=ps[0].t,
            sri_changed=any(p.sri_changed for p in ps),
            eos=ps[-1].eos)
    return merged
