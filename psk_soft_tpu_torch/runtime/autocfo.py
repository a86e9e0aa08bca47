"""Automatic carrier acquisition in front of a bank engine (port of
``psk_soft_tpu/runtime/autocfo.py:45-308``).

The M-th-power tracker locks only while the per-symbol phase step
``M * 2pi * f * sps`` stays well under pi, so a carrier offset beyond
``1 / (2*M*sps)`` cycles/sample makes it slip cycles.  This wrapper

  1. stages input until ``acq_samples`` per channel have arrived,
  2. acquires each channel's CFO from the M-th-power spectrum
     (eval/cfo.acquire_cfo, numpy, on a host copy of those samples only),
  3. derotates everything (the staged samples too: acquisition loses no
     sample) with a phase-continuous NCO and feeds the wrapped engine,
  4. with ``track=True`` reads the residual off the phase port every block
     and folds it back into the NCO phase-continuously (a slope change,
     never a phase jump) when it nears the edge of the lock range.

The NCO's phase is a float64 host clock (wrapped ``(f*n) mod 1``), exact
over unbounded streams.  Per-channel ``push`` and numpy blocks and planes
are derotated on the host in float64; a tensor block, and tensor planes
staged before acquisition, in float64 on their device by the same formula;
tensor planes after acquisition on their device by ops/mixer.derotate (a
float32 angle from the host's wrapped start phase), as the JAX package
derotates device arrays.  int16 wire planes are
refused: mixing before dequantization would change the wire contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ..eval.cfo import acquire_cfo, cfo_from_phase
from ..ops.mixer import derotate
from .streams import PORT_PHASE

TWO_PI = 2.0 * np.pi


class AutoCfoEngine:
    """Acquisition + NCO derotation wrapped around a bank engine.

    Args:
      engine: the wrapped bank engine (its ``cfg``/``channels`` drive the
        defaults; every other attribute passes through).
      acq_samples: per-channel samples staged before acquisition (the
        staged data is replayed through the NCO, nothing is dropped).
      m: constellation size override for acquisition (scalar or (C,));
        default the engine's per-channel modes (mixed banks) or
        ``cfg.constellation_size``.
      nfft: acquisition FFT size (default: next power of 2 >= acq_samples).
      track: fold the fine residual (phase-port slope) back into the NCO
        whenever it exceeds ``track_guard`` of the lock range.
      track_guard: fraction of the ``1/(2*M*sps)`` lock range that triggers
        a fold.
    """

    def __init__(self, engine, *, acq_samples: int = 4096, m=None,
                 nfft: int | None = None, track: bool = False,
                 track_guard: float = 0.25):
        self.engine = engine
        self.acq_samples = int(acq_samples)
        self.nfft = nfft
        self.track = bool(track)
        self.track_guard = float(track_guard)
        self._user_m = m
        c = engine.channels
        self._m = self._derive_m()
        self.freq = None                     # (C,) cycles/sample, float64
        self._phi = np.zeros(c, np.float64)  # NCO phase offset (fold carry)
        self._n = np.zeros(c, np.int64)      # per-channel sample position
        self._pre = [np.zeros(0, np.complex64) for _ in range(c)]
        self._pre_planes: list = []          # (re, im) staged plane chunks
        self._pre_rows = 0
        self.folds = np.zeros(c, np.int64)   # track-mode refolds per channel
        self.acquisitions = 0

    # ---- plumbing ---------------------------------------------------------
    def _derive_m(self) -> np.ndarray:
        if self._user_m is not None:
            m = np.asarray(self._user_m, np.float64)
        elif hasattr(self.engine, "params"):   # mixed bank: per-channel M
            m = torch.as_tensor(self.engine.params.m).cpu().numpy().astype(
                np.float64)
        else:
            m = np.asarray(float(self.engine.cfg.constellation_size))
        return np.broadcast_to(m, (self.engine.channels,)).copy()

    def _lock_range(self) -> np.ndarray:
        return 1.0 / (2.0 * self._m * self.engine.cfg.sps)

    def __getattr__(self, name):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    @property
    def cfo(self) -> np.ndarray | None:
        """Current per-channel NCO frequency (cycles/input sample)."""
        return None if self.freq is None else self.freq.copy()

    # ---- NCO --------------------------------------------------------------
    def _angle(self, c: int, count: int) -> np.ndarray:
        """Wrapped NCO phase (radians) of the next ``count`` samples of
        channel ``c`` (float64, the linear term taken mod 1)."""
        n = self._n[c] + np.arange(count, dtype=np.float64)
        return TWO_PI * np.mod(self.freq[c] * n, 1.0) + self._phi[c]

    def _derotate_host(self, c: int, x: np.ndarray) -> np.ndarray:
        y = x * np.exp(-1j * self._angle(c, x.size))
        self._n[c] += x.size
        return y.astype(np.complex64)

    def _derotate_block(self, block):
        """(C, n) block through the float64 NCO: numpy on the host, a
        tensor on its device."""
        n_s = block.shape[1]
        if isinstance(block, torch.Tensor):
            dev = block.device
            n = (torch.from_numpy(self._n).to(dev, torch.float64)[:, None]
                 + torch.arange(n_s, dtype=torch.float64, device=dev))
            f = torch.from_numpy(self.freq).to(dev)[:, None]
            ang = (TWO_PI * torch.remainder(f * n, 1.0)
                   + torch.from_numpy(self._phi).to(dev)[:, None])
            y = (block.to(torch.complex128)
                 * torch.polar(torch.ones_like(ang), -ang)).to(
                     torch.complex64)
        else:
            n = (self._n[:, None]
                 + np.arange(n_s, dtype=np.float64)[None, :])
            ang = (TWO_PI * np.mod(self.freq[:, None] * n, 1.0)
                   + self._phi[:, None])
            y = (block * np.exp(-1j * ang)).astype(np.complex64)
        self._n += n_s
        return y

    def _derotate_planes(self, re, im, replay: bool = False):
        """Derotate a (rows, C) plane pair: tensors on their device
        (ops/mixer.derotate; in float64 there when ``replay``, as the JAX
        package replays staged planes through its host form), numpy on the
        host in float64."""
        rows = re.shape[0]
        n0 = self._n[0]
        if not np.all(self._n == n0):
            raise ValueError("plane mode keeps the channels in lockstep")
        phase0 = TWO_PI * np.mod(self.freq * n0, 1.0) + self._phi
        phase0 = np.mod(phase0 + np.pi, TWO_PI) - np.pi
        if isinstance(re, torch.Tensor) and replay:
            dev = re.device
            t = torch.arange(rows, dtype=torch.float64, device=dev)[:, None]
            f = torch.from_numpy(self.freq).to(dev)
            ang = (TWO_PI * torch.remainder(f * t, 1.0)
                   + torch.from_numpy(phase0).to(dev))
            c, s = torch.cos(ang), torch.sin(ang)
            re, im = re.double(), im.double()
            y_re = (re * c + im * s).float()
            y_im = (im * c - re * s).float()
        elif isinstance(re, torch.Tensor):
            fp = torch.from_numpy(np.stack([self.freq, phase0]).astype(
                np.float32)).to(re.device)
            y_re, y_im, _ = derotate(re, im, fp[0], fp[1])
        else:
            t = np.arange(rows, dtype=np.float64)[:, None]
            ang = (TWO_PI * np.mod(self.freq[None, :] * t, 1.0)
                   + phase0[None, :])
            c, s = np.cos(ang), np.sin(ang)
            y_re = (re * c + im * s).astype(np.float32)
            y_im = (im * c - re * s).astype(np.float32)
        self._n += rows
        return y_re, y_im

    def _fold(self, residual: np.ndarray, mask: np.ndarray) -> None:
        """Phase-continuous slope change: phi moves so the NCO phase at the
        current position is the same under the new frequency."""
        self._phi[mask] += TWO_PI * np.mod(
            -residual[mask] * self._n[mask], 1.0)
        self._phi[mask] = np.mod(self._phi[mask] + np.pi, TWO_PI) - np.pi
        self.freq[mask] += residual[mask]
        self.folds[mask] += 1

    # ---- acquisition ------------------------------------------------------
    def _acquire_from(self, x: np.ndarray) -> None:
        """Coarse acquisition from a (C, T) host block."""
        self.freq = np.asarray(
            acquire_cfo(x, self._m, nfft=self.nfft), np.float64).reshape(-1)
        self.acquisitions += 1

    def _maybe_acquire(self) -> None:
        if self.freq is not None:
            return
        a = self.acq_samples
        if self._pre_rows:                          # plane staging
            if self._pre_rows < a:
                return
            re = [r for r, _ in self._pre_planes]
            im = [i for _, i in self._pre_planes]
            if isinstance(re[0], torch.Tensor):
                x = torch.complex(torch.cat(re)[:a].T,
                                  torch.cat(im)[:a].T).cpu().numpy()
            else:
                x = (np.concatenate(re)[:a].T
                     + 1j * np.concatenate(im)[:a].T).astype(np.complex64)
            self._acquire_from(x)
        else:                                       # per-channel staging
            if not all(s.size >= a for s in self._pre):
                return
            self._acquire_from(np.stack([s[:a] for s in self._pre]))
        self._replay()

    def _replay(self) -> None:
        """Feed everything staged before acquisition through the NCO."""
        for r, i in self._pre_planes:
            self.engine.push_planes(*self._derotate_planes(r, i, True))
        self._pre_planes, self._pre_rows = [], 0
        for c, s in enumerate(self._pre):
            if s.size:
                self.engine.push(c, self._derotate_host(c, s))
        self._pre = [np.zeros(0, np.complex64)
                     for _ in range(self.engine.channels)]

    def reacquire(self, reset_engine: bool = True) -> None:
        """Drop carrier lock and re-acquire on the next ``acq_samples``
        (retune semantics); the wrapped engine resets by default, since
        the old phase history belongs to the old carrier."""
        self.freq = None
        self._phi[:] = 0.0
        self._n[:] = 0
        if reset_engine:
            self.engine.reset()

    # ---- ingest -----------------------------------------------------------
    def push(self, channel: int, data) -> None:
        d = np.asarray(data, np.complex64).ravel()
        if self.freq is None:
            self._pre[channel] = np.concatenate([self._pre[channel], d])
            self._maybe_acquire()
        else:
            self.engine.push(channel, self._derotate_host(channel, d))

    def push_block(self, block) -> None:
        """Channel-major (C, n) complex block, numpy or a tensor."""
        if self.freq is None:
            if isinstance(block, torch.Tensor):
                block = block.cpu().numpy()
            block = np.asarray(block, np.complex64)
            for c in range(block.shape[0]):
                self._pre[c] = np.concatenate([self._pre[c], block[c]])
            self._maybe_acquire()
        else:
            if not isinstance(block, torch.Tensor):
                block = np.asarray(block, np.complex64)
            self.engine.push_block(self._derotate_block(block))

    def push_planes(self, re, im) -> None:
        """Time-major (rows, C) float32 planes, numpy or tensors."""
        if torch.as_tensor(re).dtype == torch.int16:
            raise ValueError(
                "AutoCfoEngine mixes before the engine, so int16 wire "
                "planes must be dequantized first: feed float32 planes and "
                "build the inner engine without ingest_scale")
        if self.freq is None:
            self._pre_planes.append((re, im))
            self._pre_rows += re.shape[0]
            self._maybe_acquire()
        else:
            self.engine.push_planes(*self._derotate_planes(re, im))

    # ---- engine surface ---------------------------------------------------
    def _track_packets(self, pkts):
        if not (self.track and isinstance(pkts, dict)
                and PORT_PHASE in pkts):
            return pkts
        ph = np.asarray(pkts[PORT_PHASE].data, np.float64)
        if ph.ndim != 2 or ph.shape[1] < 8:
            return pkts
        residual = cfo_from_phase(ph, self._m, self.engine.cfg.sps)
        mask = np.abs(residual) > self.track_guard * self._lock_range()
        if mask.any():
            self._fold(residual, mask)
        return pkts

    def step_packets(self):
        return self._track_packets(self.engine.step_packets())

    def step(self):
        return self.engine.step()

    def _flush_pending(self) -> None:
        """Short stream: if EOS comes before ``acq_samples``, acquire from
        whatever is staged (coarser, but the tracker pulls in the rest);
        zero CFO only when there is nothing to measure."""
        if self.freq is not None:
            return
        have = (self._pre_rows if self._pre_rows
                else min((s.size for s in self._pre), default=0))
        if have >= 64:
            saved, self.acq_samples = self.acq_samples, int(have)
            try:
                self._maybe_acquire()
            finally:
                self.acq_samples = saved
        else:
            self.freq = np.zeros(self.engine.channels, np.float64)
            self._replay()

    def flush_packets(self):
        self._flush_pending()
        return self.engine.flush_packets()

    def flush(self):
        self._flush_pending()
        return self.engine.flush()

    def configure(self, new_cfg) -> None:
        self.engine.configure(new_cfg)
        self._m = self._derive_m()

    def set_params(self, params) -> None:            # mixed banks
        self.engine.set_params(params)
        self._m = self._derive_m()

    def reset(self) -> None:
        """Queue-flush semantics: demod state resets, the carrier estimate
        survives (the RF chain did not change because packets were lost);
        :meth:`reacquire` drops it."""
        self.engine.reset()
        self._pre = [np.zeros(0, np.complex64)
                     for _ in range(self.engine.channels)]
        self._pre_planes, self._pre_rows = [], 0
