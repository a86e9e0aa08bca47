"""Streaming frame synchronizer wrapped around the bank engines (port of
``psk_soft_tpu/runtime/framesync.py``).

Detects unique-word frame starts in the demodulated soft stream, resolves
the M-fold carrier ambiguity per frame and emits aligned, derotated,
re-sliced payloads.  Taps ``step_packets``/``flush_packets``; everything
else delegates to the wrapped engine.

Streaming is exactly one-shot detection: the local-max criterion
(ops/framesync.detect_peaks) depends only on a bounded neighbourhood, so
the syncer holds back ``sep - 1`` correlation lags plus the payload span
before committing a frame start, and carries a bounded (C, ~frame+sep)
soft tail across blocks: identical frames for any block split.

The tail lives on the syncer's device; one detection runs per scan
(ops/framesync.detect_uw_sparse) and the host fetches only the sparse
candidates and the committed frames' payload rows (ops/framesync.
extract_heads).  When the wrapped engine offers ``set_device_tap`` (the
bank engines), the syncer reads the kernel's block outputs on the device;
otherwise it taps the host packet stream and uploads each block once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.full import QuantSoft
from ..ops.framesync import (Frame, FrameFormat, detect_uw_sparse,
                             extract_heads, resolve_rotation_angle)
from .engine_bank import TMOutputs
from .streams import PORT_SOFT


def _valid_span(v):
    """(lo, hi) of a 1-D host validity mask's True run, or the index array
    when it is not contiguous; None when nothing is valid."""
    idx = np.flatnonzero(np.asarray(v))
    if idx.size == 0:
        return None
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    return (lo, hi) if hi - lo == idx.size else idx


def _take(x: torch.Tensor, span, dim: int) -> torch.Tensor:
    if isinstance(span, tuple):
        return x.narrow(dim, span[0], span[1] - span[0])
    return x.index_select(dim, torch.as_tensor(span, device=x.device))


def engine_out_soft(out):
    """A bank engine's raw block output -> (C, S) complex64 soft block on
    its device, or None when the block emitted nothing.  TMOutputs
    (time-major kernel planes, int8 with ``soft_scale``) are trimmed to
    ``valid_rows`` (flush blocks); channel-major DemodOutputs (warm-up
    blocks, lockstep bank) to row 0 of their valid plane."""
    if out is None:
        return None
    if isinstance(out, TMOutputs):
        re, im = out.fo.soft_re, out.fo.soft_im
        if out.valid_rows is not None:
            span = _valid_span(out.valid_rows)
            if span is None:
                return None
            re, im = _take(re, span, 0), _take(im, span, 0)
        re, im = re.to(torch.float32), im.to(torch.float32)
        if out.soft_scale:
            inv = 1.0 / out.soft_scale
            re, im = re * inv, im * inv
        return torch.complex(re, im).T
    soft = out.soft
    if isinstance(soft, QuantSoft):
        inv = 1.0 / soft.scale
        soft = torch.complex(torch.as_tensor(soft.re_q).to(torch.float32)
                             * inv,
                             torch.as_tensor(soft.im_q).to(torch.float32)
                             * inv)
    valid = out.valid[0] if out.valid.ndim > 1 else out.valid
    span = _valid_span(torch.as_tensor(valid).cpu().numpy())
    if span is None:
        return None
    return _take(soft, span, 1)


class FrameSyncer:
    """UW frame sync on a bank's soft-decision stream.

    Args:
      engine: wrapped bank engine (or wrapper stack), or an int channel
        count for standalone use via :meth:`observe`.
      fmt: frame format (UW indices, payload length, M, threshold).
      max_frames: ring limit on buffered frames (oldest dropped, counted
        in ``dropped_frames``).
      device_tap: read the engine's device-resident block outputs when it
        offers ``set_device_tap``.
      device: where the tail lives and detection runs.
    """

    def __init__(self, engine, fmt: FrameFormat, max_frames: int = 4096,
                 device_tap: bool = True, *, device="cuda"):
        if isinstance(engine, int):
            self.engine = None
            self._channels = engine
        else:
            self.engine = engine
            self._channels = engine.channels
        self.fmt = fmt
        self.device = torch.device(device)
        self.max_frames = int(max_frames)
        # Emit peak t only once norm[t .. t+sep-1] is final and the payload
        # is present: lookahead = max(frame span, detection window span).
        self._need_after = max(fmt.frame_len,
                               fmt.separation + fmt.uw_len - 1)
        # Left context so future peaks' look-back windows stay intact.
        self._keep_back = fmt.separation - 1
        self._buf = None        # (C, L) complex64 on the device; None = empty
        self._buf_len = 0
        self._base = 0          # absolute symbol index of buf[:, 0]
        self._next_scan = 0     # first absolute start not yet committed
        self.frames: list[Frame] = []
        self.dropped_frames = 0
        self.frames_synced = 0
        self._tap_device = False
        if self.engine is not None and device_tap:
            hook = getattr(self.engine, "set_device_tap", None)
            if callable(hook):
                hook(self._observe_engine_out)
                self._tap_device = True

    # -- core ----------------------------------------------------------------

    def observe(self, soft) -> list[Frame]:
        """Fold one (C, S) host soft block; returns frames committed by
        it."""
        soft = np.asarray(soft, np.complex64)
        if soft.ndim != 2 or soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) soft block; "
                             f"got {soft.shape}")
        if soft.shape[1] == 0:
            return []
        return self.observe_device(
            torch.from_numpy(np.ascontiguousarray(soft)))

    def observe_device(self, soft: torch.Tensor) -> list[Frame]:
        """:meth:`observe` for a (C, S) complex tensor (the engine tap's
        block, already on the syncer's device; another is moved there):
        appends to the tail, scans, fetches only the sparse candidates and
        the committed payloads."""
        if soft.ndim != 2 or soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) device block")
        soft = soft.to(self.device)
        if soft.shape[1]:
            self._buf = (soft if self._buf is None
                         else torch.cat([self._buf, soft], dim=1))
            self._buf_len = int(self._buf.shape[1])
        new = self._scan()
        self._trim()
        return self._commit(new)

    def _observe_engine_out(self, out) -> None:
        """Device tap (the engine's ``set_device_tap`` hook)."""
        soft = engine_out_soft(out)
        if soft is not None and soft.shape[1]:
            self.observe_device(soft)

    def _commit(self, new: list[Frame]) -> list[Frame]:
        if new:
            self.frames_synced += len(new)
            self.frames.extend(new)
            excess = len(self.frames) - self.max_frames
            if excess > 0:
                del self.frames[:excess]
                self.dropped_frames += excess
        return new

    def _scan(self, hi: int | None = None) -> list[Frame]:
        length = self._buf_len
        if hi is None:
            hi = length - self._need_after    # inclusive last committable t
        lo = self._next_scan - self._base
        if hi < lo or length < self.fmt.uw_len:
            return []
        fmt = self.fmt
        cand = detect_uw_sparse(self._buf, fmt)
        self._next_scan = self._base + hi + 1
        ts = cand.idx[:, 1].astype(np.int64)
        keep = (ts >= lo) & (ts <= hi)
        idx, vals = cand.idx[keep], cand.vals[keep]
        if idx.shape[0] == 0:
            return []
        cs = idx[:, 0].astype(np.int64)
        ts = idx[:, 1].astype(np.int64)
        ks, ress = resolve_rotation_angle(vals[:, 1].astype(np.float64),
                                          fmt.m)
        pm, bits = extract_heads(self._buf, fmt, cs, ts, ks)
        return [Frame(channel=int(cs[i]), start=self._base + int(ts[i]),
                      rotation=int(ks[i]), corr=float(vals[i, 0]),
                      residual_phase=float(ress[i]),
                      soft=pm[i], bits=bits[i])
                for i in range(idx.shape[0])]

    def _trim(self) -> None:
        keep_from = self._next_scan - self._base - self._keep_back
        if keep_from > 0 and self._buf is not None:
            self._buf = (self._buf[:, keep_from:]
                         if keep_from < self._buf_len else None)
            self._buf_len = max(self._buf_len - keep_from, 0)
            self._base += keep_from

    # -- engine surface ----------------------------------------------------

    def _tap(self, pkts):
        # With the device tap registered, blocks were observed at emit
        # time; the packet stream passes through untouched.
        if pkts and not self._tap_device:
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

    def finalize(self) -> list[Frame]:
        """End of stream: commit frames in the held-back tail whose payload
        is fully present (matching one-shot extraction on the whole
        stream)."""
        new = self._scan(hi=self._buf_len - self.fmt.frame_len)
        self._trim()
        return self._commit(new)

    def pop_frames(self) -> list[Frame]:
        """Drain and return all buffered frames."""
        out, self.frames = self.frames, []
        return out

    def reset(self) -> None:
        self.reset_sync()
        if self.engine is not None:
            self.engine.reset()

    def reset_sync(self) -> None:
        self._buf = None
        self._buf_len = 0
        self._base = 0
        self._next_scan = 0
        self.frames = []

    @property
    def channels(self) -> int:
        return self._channels

    def __getattr__(self, name):
        if self.engine is None:
            raise AttributeError(name)
        return getattr(self.engine, name)


class GroupFrameSyncer:
    """Per-channel frame formats over one bank (mixed-format banks): one
    :class:`FrameSyncer` per group of channels sharing a format, over the
    channel-row slices of the tapped soft block; frames come back with
    bank-level channel indices.

    Args:
      engine: wrapped bank engine (or an int channel count for standalone
        ``observe``).
      fmts: per-channel formats, length = channels (channels sharing a
        format form one group).
      device: where each group's syncer runs.
    """

    def __init__(self, engine, fmts, max_frames: int = 4096, *,
                 device="cuda"):
        if isinstance(engine, int):
            self.engine = None
            self._channels = engine
        else:
            self.engine = engine
            self._channels = engine.channels
        fmts = list(fmts)
        if len(fmts) != self._channels:
            raise ValueError(f"need one format per channel "
                             f"({self._channels}); got {len(fmts)}")
        groups: dict[int, list[int]] = {}
        uniq: list = []
        for c, fmt in enumerate(fmts):
            for gi, g_fmt in enumerate(uniq):
                if g_fmt is fmt or g_fmt == fmt:
                    groups[gi].append(c)
                    break
            else:
                uniq.append(fmt)
                groups[len(uniq) - 1] = [c]
        self.fmts = fmts
        self._rows = [np.asarray(groups[gi], np.int64)
                      for gi in range(len(uniq))]
        self._syncers = [FrameSyncer(len(rows), uniq[gi],
                                     max_frames=max_frames, device=device)
                         for gi, rows in enumerate(self._rows)]

    # -- core ----------------------------------------------------------------

    def _remap(self, per_group) -> list[Frame]:
        out = []
        for rows, frames in zip(self._rows, per_group):
            for f in frames:
                f.channel = int(rows[f.channel])
                out.append(f)
        return out

    def observe(self, soft) -> list[Frame]:
        soft = np.asarray(soft, np.complex64)
        if soft.ndim != 2 or soft.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, S) soft block; "
                             f"got {soft.shape}")
        return self._remap(sync.observe(soft[rows])
                           for rows, sync in zip(self._rows, self._syncers))

    def finalize(self) -> list[Frame]:
        return self._remap(sync.finalize() for sync in self._syncers)

    def pop_frames(self) -> list[Frame]:
        # observe/finalize remapped the committed frames already.
        out = [f for sync in self._syncers for f in sync.pop_frames()]
        out.sort(key=lambda f: (f.start, f.channel))
        return out

    @property
    def frames_synced(self) -> int:
        return sum(s.frames_synced for s in self._syncers)

    @property
    def dropped_frames(self) -> int:
        return sum(s.dropped_frames for s in self._syncers)

    def reset_sync(self) -> None:
        for s in self._syncers:
            s.reset_sync()

    def reset(self) -> None:
        self.reset_sync()
        if self.engine is not None:
            self.engine.reset()

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

    @property
    def channels(self) -> int:
        return self._channels

    def __getattr__(self, name):
        if self.engine is None:
            raise AttributeError(name)
        return getattr(self.engine, name)
