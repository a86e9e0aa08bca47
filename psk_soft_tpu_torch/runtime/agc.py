"""AGC/squelch front end wrapped around a bank engine (port of
``psk_soft_tpu/runtime/agc.py:31-189``).

Normalises each channel's level before demodulation and mutes dead
channels.  Per-channel complex ``push`` and time-major ``push_planes`` pass
through gained; everything else delegates to the wrapped engine.

Two data paths, which interleave freely (each re-seeds from the other's
carry):

- **device** (``push_block`` on (C, T) blocks, ``push_planes`` on (T, C)
  planes through ops/agc.agc_block_tm, no transpose): runs on the engine's
  device and hands the wrapped stage tensors on that device, so planes
  pushed as CUDA tensors stay on the card.  The carry stays there too
  until the host path or an observer (``gains_db``) needs it.
- **host ragged** (``push``): per-channel pushes of any length run the same
  chunk EMA in float64 numpy through the segment closed form (one (K, K)
  matrix product per 512-chunk segment).

Samples that do not fill a chunk are staged per channel, so any push
granularity gives the gains of one-shot processing.  int16 wire planes and
an inner engine with ``ingest_scale`` are refused: a gain before
dequantization would change the wire contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.agc import AgcConfig, AgcState, agc_block, agc_block_tm

_SEG = 512  # chunks per host-side closed-form segment


class AgcFrontEnd:
    """AGC + squelch in front of a bank engine.

    Args:
      engine: wrapped bank engine or front end (its ``device``,
        ``channels`` and ``cfg`` are used).
      agc_cfg: AGC configuration; ``chunk`` defaults to the engine's sps so
        the gain is constant within each symbol.
    """

    def __init__(self, engine, agc_cfg: AgcConfig | None = None):
        self.engine = engine
        if agc_cfg is None:
            agc_cfg = AgcConfig(chunk=engine.cfg.sps)
        self.agc_cfg = agc_cfg
        c = engine.channels
        self._power = np.ones(c, np.float64)
        self._primed = np.zeros(c, bool)
        self._dev_state = None     # AgcState on the device, when newer
        self._tail = [np.zeros(0, np.complex64) for _ in range(c)]
        self._mats: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # -- carry -------------------------------------------------------------

    def _host_carry(self) -> None:
        """Bring the device carry (if newer) back to the float64 host
        copy."""
        if self._dev_state is not None:
            self._power = self._dev_state.power.cpu().numpy().astype(
                np.float64)
            self._primed = self._dev_state.primed.cpu().numpy().copy()
            self._dev_state = None

    def _device_carry(self) -> AgcState:
        if self._dev_state is None:
            dev = self.engine.device
            self._dev_state = AgcState(
                power=torch.from_numpy(self._power.astype(np.float32)).to(
                    dev),
                primed=torch.from_numpy(self._primed.copy()).to(dev))
        return self._dev_state

    # -- host ragged path --------------------------------------------------

    def _host_mats(self, k: int):
        if k not in self._mats:
            a = self.agc_cfg.alpha
            j = np.arange(k)
            expo = j[:, None] - j[None, :]
            lower = a * (1.0 - a) ** np.maximum(expo, 0) * (expo >= 0)
            self._mats[k] = (lower, (1.0 - a) ** (j + 1))
        return self._mats[k]

    def _host_gain(self, c: int, x: np.ndarray) -> np.ndarray:
        """Chunk EMA + gain for one channel (float64, segment products)."""
        cfg = self.agc_cfg
        k = x.size // cfg.chunk
        q = np.mean(np.abs(x.reshape(k, cfg.chunk)) ** 2, axis=-1
                    ).astype(np.float64)
        p = np.empty(k, np.float64)
        pos = 0
        while pos < k:
            seg = min(_SEG, k - pos)
            lower, d = self._host_mats(seg)
            p0 = self._power[c] if self._primed[c] else q[0]
            ps = lower @ q[pos:pos + seg] + d * p0
            if not self._primed[c] and pos == 0:
                ps[0] = q[0]
            p[pos:pos + seg] = ps
            self._power[c] = ps[-1]
            self._primed[c] = True
            pos += seg
        gain = cfg.target_rms / np.sqrt(np.maximum(p, cfg.eps))
        if cfg.squelch_power > 0.0:
            gain = np.where(p >= cfg.squelch_power, gain, 0.0)
        return gain

    def push(self, c: int, x) -> None:
        """Per-channel ragged push; sub-chunk remainders are staged."""
        cfg = self.agc_cfg
        self._host_carry()
        x = np.concatenate([self._tail[c], np.asarray(x, np.complex64)])
        n = (x.size // cfg.chunk) * cfg.chunk
        self._tail[c] = x[n:]
        if not n:
            return
        head = x[:n]
        gain = self._host_gain(c, head)
        y = (head.reshape(-1, cfg.chunk)
             * gain[:, None]).reshape(-1).astype(np.complex64)
        self.engine.push(c, y)

    # -- device paths ------------------------------------------------------

    def _check_lockstep(self, what: str) -> None:
        if any(t.size for t in self._tail):
            raise ValueError(f"staged sub-chunk tails pending; {what} "
                             f"cannot interleave with ragged remainders")

    def push_block(self, x) -> None:
        """Lockstep (C, T) complex block (numpy or a tensor), gained on the
        engine's device and handed on as a tensor there."""
        self._check_lockstep("push_block")
        x = torch.as_tensor(x).to(self.engine.device, torch.complex64)
        self._dev_state, y, _ = agc_block(self.agc_cfg, self._device_carry(),
                                          x)
        self.engine.push_block(y)

    def push_planes(self, re, im) -> None:
        """Time-major (T, C) float32 planes (numpy or tensors), gained on
        the engine's device in that layout and handed on as tensors
        there."""
        if getattr(self.engine, "_ingest_scale", None) is not None \
                or torch.as_tensor(re).dtype == torch.int16:
            raise ValueError("AGC before int16 dequantization would change "
                             "the wire contract; feed float32 planes and "
                             "build the inner engine without ingest_scale")
        self._check_lockstep("push_planes")
        dev = self.engine.device
        re = torch.as_tensor(re).to(dev, torch.float32)
        im = torch.as_tensor(im).to(dev, torch.float32)
        self._dev_state, y_re, y_im, _ = agc_block_tm(
            self.agc_cfg, self._device_carry(), re, im)
        self.engine.push_planes(y_re, y_im)

    # -- observability -------------------------------------------------------

    @property
    def gains_db(self) -> np.ndarray:
        """Current per-channel gain in dB."""
        self._host_carry()
        g = self.agc_cfg.target_rms / np.sqrt(
            np.maximum(self._power, self.agc_cfg.eps))
        return (20.0 * np.log10(np.maximum(g, 1e-30))).astype(np.float32)

    @property
    def squelched(self) -> np.ndarray:
        """Per-channel squelch state (True = muted)."""
        self._host_carry()
        if self.agc_cfg.squelch_power <= 0.0:
            return np.zeros_like(self._primed)
        return self._primed & (self._power < self.agc_cfg.squelch_power)

    def reset_agc(self) -> None:
        self._power[:] = 1.0
        self._primed[:] = False
        self._dev_state = None
        self._tail = [np.zeros(0, np.complex64)
                      for _ in range(self.engine.channels)]

    def __getattr__(self, name):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)
