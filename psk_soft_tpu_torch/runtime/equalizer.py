"""Adaptive-equalizer front end wrapped around a bank engine (port of
``psk_soft_tpu/runtime/equalizer.py:31-207``).

Per-channel blind CMA equalization in front of demodulation.  The lockstep
paths (``push_block``, ``push_planes``) run on the engine's device and hand
the wrapped stage tensors there, so planes pushed as CUDA tensors stay on
the card; everything else delegates to the wrapped engine.

One block update per lockstep step, so the front end is deterministic for
a given push sequence; with ``freeze`` the weights hold and the data path
is a per-channel FIR.  Per-channel ragged ``push`` is staged on the host
to the lockstep grid (block CMA shares one update schedule across the
bank), so a per-channel upstream (the AGC's host path) composes unchanged.
int16 wire planes and an inner engine with ``ingest_scale`` are refused.
The CMA cost stays on the device unless it is read (``cm_err``) or the
CMA -> DD handover needs it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.equalizer import EqConfig, eq_init, make_eq_fn


class EqFrontEnd:
    """Blind CMA equalizer in front of a bank engine.

    Args:
      engine: wrapped bank engine or front end (its ``device`` and
        ``channels`` are used).
      eq_cfg: equalizer configuration; ``stride`` defaults to 1
        (rectangular pulses; sps for band-limited ones).
      dd_switch: CMA -> DD-LMS handover once the worst channel's CMA cost
        stays below this for ``dd_hold`` consecutive updates (the bank
        maximum, so no unconverged channel starts DD cold); None keeps
        pure CMA.  Ignored when eq_cfg starts in "dd" mode.
      dd_hold: consecutive below-threshold updates required to switch.
    """

    def __init__(self, engine, eq_cfg: EqConfig | None = None, *,
                 dd_switch: float | None = None, dd_hold: int = 3):
        self.engine = engine
        self.eq_cfg = eq_cfg if eq_cfg is not None else EqConfig()
        self._state = eq_init(self.eq_cfg, (engine.channels,), engine.device)
        self._fn = make_eq_fn(self.eq_cfg)
        self._last_cm_err = torch.zeros(engine.channels)
        self._staged = [np.zeros(0, np.complex64)
                        for _ in range(engine.channels)]
        self.updates = 0
        self.dd_switch = dd_switch
        self.dd_hold = int(dd_hold)
        self._lock_streak = 0

    def _set_cfg(self, **changes) -> None:
        self.eq_cfg = dataclasses.replace(self.eq_cfg, **changes)
        self._fn = make_eq_fn(self.eq_cfg)

    def _run(self, x) -> torch.Tensor:
        """One lockstep step on the engine's device; returns y there."""
        self._state, y, info = self._fn(self._state, x)
        self._last_cm_err = info["cm_err"]
        if not self.eq_cfg.freeze:
            self.updates += 1
            if (self.dd_switch is not None and self.eq_cfg.mode == "cma"
                    and self._dd_gate_metric() < self.dd_switch):
                self._lock_streak += 1
                if self._lock_streak >= self.dd_hold:
                    self._set_cfg(mode="dd")
            elif self.eq_cfg.mode == "cma":
                self._lock_streak = 0
        return y

    def _dd_gate_metric(self) -> float:
        """The worst channel's CMA cost (a bank mean could hand an
        unconverged minority to DD cold)."""
        return float(self._last_cm_err.max())

    @property
    def mode(self) -> str:
        """Current adaptation mode: "cma" or "dd"."""
        return self.eq_cfg.mode

    # -- data paths ----------------------------------------------------------

    def push(self, channel: int, data) -> None:
        """Per-channel push, staged on the host to the lockstep grid: the
        common prefix (stride-aligned, >= taps samples) runs as one
        lockstep step."""
        self._staged[channel] = np.concatenate(
            [self._staged[channel], np.asarray(data, np.complex64).ravel()])
        cfg = self.eq_cfg
        m = min(s.size for s in self._staged)
        m -= m % cfg.stride
        if m < max(cfg.taps, cfg.stride):
            return
        x = np.stack([s[:m] for s in self._staged])
        self._staged = [s[m:] for s in self._staged]
        self.engine.push_block(self._run(x))

    def _check_lockstep(self) -> None:
        if any(s.size for s in self._staged):
            # Ragged remainders would reorder against the lockstep block.
            raise ValueError("staged ragged pushes pending; keep one push "
                             "style per stream")

    def push_block(self, x) -> None:
        """Lockstep (C, T) complex block (numpy or a tensor), equalized on
        the engine's device and handed on as a tensor there."""
        self._check_lockstep()
        self.engine.push_block(self._run(x))

    def push_planes(self, re, im) -> None:
        """Time-major (T, C) float32 planes (numpy or tensors), equalized
        on the engine's device and handed on as tensors there."""
        if getattr(self.engine, "_ingest_scale", None) is not None \
                or torch.as_tensor(re).dtype == torch.int16:
            raise ValueError("equalizing before int16 dequantization would "
                             "change the wire contract; feed float32 planes "
                             "and build the inner engine without "
                             "ingest_scale")
        self._check_lockstep()
        dev = self.engine.device
        x = torch.complex(torch.as_tensor(re).to(dev, torch.float32).T,
                          torch.as_tensor(im).to(dev, torch.float32).T)
        y = self._run(x)
        if hasattr(self.engine, "push_planes"):
            self.engine.push_planes(y.real.T.contiguous(),
                                    y.imag.T.contiguous())
        else:                       # plane-less engines take the block
            self.engine.push_block(y)

    # -- control / observability ---------------------------------------------

    def freeze(self) -> None:
        """Hold the current weights."""
        if not self.eq_cfg.freeze:
            self._set_cfg(freeze=True)

    def adapt(self) -> None:
        """Resume weight adaptation."""
        if self.eq_cfg.freeze:
            self._set_cfg(freeze=False)

    @property
    def weights(self) -> np.ndarray:
        """(C, L) current per-channel equalizer taps."""
        return self._state.w.cpu().numpy()

    @property
    def cm_err(self) -> np.ndarray:
        """(C,) CMA cost E[(|y|^2 - R2)^2] of the last block (~0 once the
        channel is inverted)."""
        return self._last_cm_err.cpu().numpy().astype(np.float32)

    def reset(self) -> None:
        """Queue-flush semantics: drop staged data and the FIR history (the
        stream is discontinuous) but keep the weights, a property of the
        channel (:meth:`reset_eq` forgets them too)."""
        self._staged = [np.zeros(0, np.complex64)
                        for _ in range(self.engine.channels)]
        self._state = self._state._replace(
            hist=torch.zeros_like(self._state.hist))
        self.engine.reset()

    def reset_eq(self) -> None:
        if self.dd_switch is not None and self.eq_cfg.mode == "dd":
            # Fresh identity weights need re-acquisition: DD decisions on
            # an unequalized channel are unreliable, so back to CMA.
            self._set_cfg(mode="cma")
        self._lock_streak = 0
        self._state = eq_init(self.eq_cfg, (self.engine.channels,),
                              self.engine.device)
        self._last_cm_err = torch.zeros(self.engine.channels)
        self._staged = [np.zeros(0, np.complex64)
                        for _ in range(self.engine.channels)]
        self.updates = 0

    def __getattr__(self, name):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)
