"""FEC-decoding stages of the receive chain (port of
``psk_soft_tpu/runtime/fec.py``).

:class:`FecFrameDecoder` decodes the convolutional code on every
synchronized frame payload behind the frame synchronizer, keeping its
``pop_frames`` surface: each drain's payloads go to the device once, and
LLRs, deinterleaving, the decode (kernel B2 on the card), re-encoding and
the corrected-error count all run there; only the information bits and
the counts are fetched.  B2 takes any number of rows, so the JAX stage's
power-of-two batch padding has no counterpart.

:class:`StreamFecDecoder` runs the streaming Viterbi decoder over a
continuous (unframed) soft stream, one device step per chunk (kernels B3
and B4 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fec import (CODE_K7, ConvCode, conv_encode, info_bits_for,
                       make_stream_soft_fn, psk_llrs, viterbi_decode,
                       viterbi_stream_flush, viterbi_stream_init)
from ..ops.interleave import _perm, deinterleave
from .streams import PORT_SOFT


class FecFrameDecoder:
    """Viterbi-decode synchronized frame payloads.

    Args:
      syncer: a runtime.framesync.FrameSyncer (or compatible wrapper)
        whose frames carry derotated soft payloads.
      code: the convolutional code (default K=7 (171,133) rate 1/2).
      terminate: payloads end with K-1 zero flush bits (frame mode).
      suspect_fraction: flag a frame ``suspect`` when the re-encoded
        disagreement fraction exceeds this.
      interleave_rows: block deinterleaver rows, if the TX interleaves.
      labeling: payload bit labeling, "scd" or "gray".
      device: where the payloads decode.

    Payload contract: ``fmt.payload * log2(M)`` code bits must form a
    whole number of trellis steps (after depuncturing) with room for the
    flush bits, validated at construction.
    """

    def __init__(self, syncer, code: ConvCode = CODE_K7,
                 terminate: bool = True, suspect_fraction: float = 0.08,
                 interleave_rows: int | None = None,
                 labeling: str = "scd", *, device="cuda"):
        self.syncer = syncer
        self.code = code
        self.terminate = terminate
        self.suspect_fraction = float(suspect_fraction)
        self.interleave_rows = interleave_rows
        self.labeling = labeling
        self.device = torch.device(device)
        fmt = syncer.fmt
        self._m = fmt.m
        self._nb = int(np.log2(fmt.m))
        self._code_bits = fmt.payload * self._nb
        self.info_bits = info_bits_for(code, self._code_bits, terminate)
        if interleave_rows is not None:
            _perm(self._code_bits, int(interleave_rows))   # validates
        self.frames_decoded = 0
        self.errors_corrected = 0
        self.suspect_frames = 0

    # -- decode --------------------------------------------------------------

    def decode_payloads(self, payloads):
        """(N, payload) complex soft payloads -> (info, corrected) as
        numpy: (N, info_bits) int8 and (N,) int32 re-encode disagreement
        counts."""
        if not isinstance(payloads, torch.Tensor):
            payloads = torch.from_numpy(
                np.ascontiguousarray(payloads, np.complex64))
        pay = payloads.to(self.device)
        n = pay.shape[0]
        if n == 0:
            return (np.zeros((0, self.info_bits), np.int8),
                    np.zeros(0, np.int32))
        llr = psk_llrs(self._m, pay, labeling=self.labeling)
        llr = llr.reshape(n, self._code_bits)
        if self.interleave_rows is not None:
            llr = deinterleave(llr, self.interleave_rows)
        info = viterbi_decode(self.code, llr, terminate=self.terminate)
        # Corrected-error observability: re-encode and compare against the
        # received hard decisions.
        reenc = conv_encode(self.code, info, terminate=self.terminate)
        corrected = (reenc.to(torch.bool) ^ (llr < 0)).sum(dim=-1)
        return (info.to(torch.int8).cpu().numpy(),
                corrected.to(torch.int32).cpu().numpy())

    def _decode_frames(self, frames: list) -> list:
        if not frames:
            return frames
        info, corrected = self.decode_payloads(
            np.stack([f.soft for f in frames]))
        limit = self.suspect_fraction * self._code_bits
        for f, i, c in zip(frames, info, corrected):
            f.info_bits = i
            f.corrected = int(c)
            f.suspect = bool(c > limit)
            self.suspect_frames += f.suspect
        self.frames_decoded += len(frames)
        self.errors_corrected += int(corrected.sum())
        return frames

    # -- syncer surface ----------------------------------------------------

    def pop_frames(self) -> list:
        """Drain the syncer's frames, decoded in one batch."""
        return self._decode_frames(self.syncer.pop_frames())

    def reset(self) -> None:
        """Queue-flush semantics: stream state resets downstream; the
        cumulative counters survive (use :meth:`reset_fec` to zero
        them)."""
        self.syncer.reset()

    def reset_fec(self) -> None:
        self.frames_decoded = 0
        self.errors_corrected = 0
        self.suspect_frames = 0

    def __getattr__(self, name):
        return getattr(self.syncer, name)


class StreamFecDecoder:
    """Streaming Viterbi over a continuous (unframed) soft stream.

    Taps ``step_packets``/``flush_packets`` soft payloads, or standalone
    ``observe(soft)``.  Soft symbols buffer on the host; each drained
    chunk goes to the device once and runs constellation LLRs ->
    depuncture -> ACS -> windowed traceback there
    (ops/fec.make_stream_soft_fn); only the decoded bits come back.  Bits
    emerge ``depth`` trellis steps behind the input (default 10
    constraint lengths, at which the output matches full-stream Viterbi);
    the first ``depth`` emitted steps are pre-stream garbage and dropped.

    The decoder assumes the encoder started at the stream head
    (``known_start``); punctured codes are depunctured per period-aligned
    chunk.  ``pop_bits()`` drains the decoded (C, N) bit stream.
    """

    def __init__(self, engine, code: ConvCode = CODE_K7, m=None,
                 depth: int | None = None, block_steps: int = 512,
                 known_start: bool = True, labeling: str = "scd", *,
                 device="cuda"):
        self.labeling = labeling
        if isinstance(engine, int):
            self.engine = None
            self._channels = engine
        else:
            self.engine = engine
            self._channels = engine.channels
        self.code = code
        self.device = torch.device(device)
        if m is None and self.engine is not None:
            m = int(self.engine.cfg.constellation_size)
        if m is None:
            raise ValueError("pass m for standalone use")
        self._m = int(m)
        self._nb = int(np.log2(self._m))
        self.depth = int(depth) if depth is not None else 10 * code.k
        if block_steps < 1:
            raise ValueError("block_steps must be >= 1")
        # Chunk grain: a whole number of trellis steps that is also a
        # whole number of symbols (puncture-period and log2(M) aligned).
        if code.puncture is not None:
            p = np.asarray(code.puncture)
            kept, period = int(p.sum()), p.shape[0]
        else:
            kept, period = code.n, 1
        g_wire = np.lcm(kept, self._nb)
        self._grain_syms = int(g_wire // self._nb)
        self._grain_steps = int(g_wire // kept * period)
        g = self._grain_steps
        self.block_steps = ((int(block_steps) + g - 1) // g) * g
        self._syms_per_block = self.block_steps // g * self._grain_syms
        self._known_start = bool(known_start)
        self._fn = make_stream_soft_fn(code, self._m, labeling)
        self.steps_decoded = 0
        self._clear()

    # -- core ------------------------------------------------------------

    def observe(self, soft) -> None:
        """Fold one (C, S) block of soft decisions into the decoder."""
        soft = np.asarray(soft)
        if soft.ndim != 2 or soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) soft block; "
                             f"got {soft.shape}")
        if soft.shape[1] == 0:
            return
        self._buf = np.concatenate(
            [self._buf, soft.astype(np.complex64)], axis=1)
        while self._buf.shape[1] >= self._syms_per_block:
            self._emit_chunk(self._syms_per_block)

    def _emit_chunk(self, syms: int) -> None:
        chunk, self._buf = self._buf[:, :syms], self._buf[:, syms:]
        self._state, bits = self._fn(
            self._state,
            torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device))
        self._append(bits.cpu().numpy())

    def _append(self, bits: np.ndarray) -> None:
        """Drop the pre-stream garbage (the first ``depth`` emitted
        steps)."""
        t = bits.shape[1]
        skip = max(0, self.depth - self._steps_emitted)
        self._steps_emitted += t
        if skip < t:
            self._out.append(np.ascontiguousarray(bits[:, skip:], np.int8))
            self.steps_decoded += t - skip

    def finalize(self) -> None:
        """End of stream: decode everything still buffered and in the
        window.  A sub-grain tail (fewer symbols than one aligned trellis
        step) cannot form a step and is dropped."""
        left = (self._buf.shape[1] // self._grain_syms) * self._grain_syms
        if left:
            self._emit_chunk(left)
        self._append(viterbi_stream_flush(self.code,
                                          self._state).cpu().numpy())

    def pop_bits(self) -> np.ndarray:
        """Drain the decoded (C, N) info-bit stream emitted so far."""
        if not self._out:
            return np.zeros((self._channels, 0), np.int8)
        out = np.concatenate(self._out, axis=1)
        self._out = []
        return out

    # -- engine surface ----------------------------------------------------

    def _tap(self, pkts):
        if pkts:
            soft = pkts.get(PORT_SOFT)
            if soft is not None and soft.data.size:
                self.observe(soft.data)
        return pkts

    def step_packets(self):
        return self._tap(self.engine.step_packets())

    def flush_packets(self):
        pkts = self._tap(self.engine.flush_packets())
        self.finalize()
        return pkts

    def reset(self) -> None:
        """Queue-flush semantics: drop buffered soft data and the decoder
        window (the stream is discontinuous); the cumulative
        ``steps_decoded`` counter survives."""
        self._clear()
        if self.engine is not None:
            self.engine.reset()

    def _clear(self) -> None:
        self._buf = np.zeros((self._channels, 0), np.complex64)
        self._state = viterbi_stream_init(self.code, self._channels,
                                          self.depth,
                                          known_start=self._known_start,
                                          device=self.device)
        self._steps_emitted = 0          # incl. the first `depth` garbage
        self._out = []                   # (C, T) decoded chunks

    def reset_fec(self) -> None:
        self._clear()
        self.steps_decoded = 0

    @property
    def channels(self) -> int:
        return self._channels

    def __getattr__(self, name):
        if self.engine is None:
            raise AttributeError(name)
        return getattr(self.engine, name)
