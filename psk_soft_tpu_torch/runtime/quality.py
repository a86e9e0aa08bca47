"""Per-channel link-quality monitor wrapped around a bank engine (port of
``psk_soft_tpu/runtime/quality.py:28-137``).

EVM / M2M4-SNR / carrier-lock tracking for every channel, from the soft
packets the engine already emits: the wrapper taps ``step_packets`` and
``flush_packets``, so it composes with any engine surface (Batch,
FullKernel, Mixed, front-end stacks) without touching the data path.
Every other attribute delegates to the wrapped engine.

Per block the (C, S) soft payload goes to the engine's device for one
moment reduction (ops/quality.block_quality) and the per-channel results
come back in one fetch; the monitor folds them into per-channel EMAs on the
host (alpha per *symbol*, folded once a block, so block sizes converge
alike).  A mixed bank's per-channel M comes from ``engine.params.m``.
With the soft port unconnected (``data_ports=False``) there is no soft
packet and the monitor sees nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quality import evm_pct, make_quality_fn, snr_db
from .streams import PORT_SOFT


class QualityMonitor:
    """EVM / SNR / lock tracking in front of a bank engine's packet API.

    Args:
      engine: wrapped bank engine (or wrapper stack) exposing
        ``step_packets``/``flush_packets``, ``channels`` and ``device``.
      alpha: EMA weight per symbol (window ``1/alpha`` symbols); 1.0 =
        latest block only.
      m: constellation size override, int or (C,); default the engine's
        per-channel modes (mixed banks) or ``cfg.constellation_size``.
    """

    def __init__(self, engine, alpha: float = 0.01, m=None):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1]; got {alpha}")
        self.engine = engine
        self.alpha = float(alpha)
        if m is None:
            params = getattr(engine, "params", None)
            m = (params.m if params is not None
                 else engine.cfg.constellation_size)
        if not isinstance(m, int):
            m = torch.as_tensor(m).to(engine.device, torch.int32)
        self._m = m
        self._fn = make_quality_fn(m)
        c = engine.channels
        self._sym = np.zeros(c, np.int64)       # total symbols measured
        self._amp = np.zeros(c, np.float64)
        self._power = np.zeros(c, np.float64)
        self._snr = np.zeros(c, np.float64)
        self._lock = np.zeros(c, np.float64)
        self._evm2 = np.zeros(c, np.float64)    # EMA of EVM^2 (power-like)

    # -- update --------------------------------------------------------------

    def observe(self, soft) -> None:
        """Fold one (C, S) block of soft decisions (numpy or a tensor)
        into the EMAs."""
        soft = torch.as_tensor(soft)
        if soft.ndim != 2 or soft.shape[0] != self.engine.channels:
            raise ValueError(f"expected ({self.engine.channels}, S) soft "
                             f"block; got {tuple(soft.shape)}")
        if soft.shape[1] == 0:
            return
        q = self._fn(soft.to(self.engine.device))
        n, amp, power, snr, lock, evm = torch.stack(
            [q.count.double(), q.amp.double(), q.power.double(),
             q.snr.double(), q.lock.double(), q.evm.double()]).cpu().numpy()
        n = n.astype(np.int64)
        # Per-symbol EMA folded once per block: weight 1-(1-a)^n, exact for
        # a constant within the block, so block size never biases the
        # time constant.
        w = 1.0 - (1.0 - self.alpha) ** n
        w = np.where(self._sym == 0, 1.0, w)
        w = np.where(n > 0, w, 0.0)

        def fold(acc, val):
            return (1.0 - w) * acc + w * val

        self._amp = fold(self._amp, amp)
        self._power = fold(self._power, power)
        self._snr = fold(self._snr, snr)
        self._lock = fold(self._lock, lock)
        self._evm2 = fold(self._evm2, evm ** 2)
        self._sym += n

    def _tap(self, pkts):
        if pkts:
            soft = pkts.get(PORT_SOFT)
            if soft is not None and soft.data.size:
                self.observe(soft.data)
        return pkts

    # -- engine surface ------------------------------------------------------

    def step_packets(self):
        return self._tap(self.engine.step_packets())

    def flush_packets(self):
        return self._tap(self.engine.flush_packets())

    def reset(self) -> None:
        self.reset_quality()
        self.engine.reset()

    def reset_quality(self) -> None:
        for a in (self._amp, self._power, self._snr, self._lock, self._evm2):
            a[:] = 0.0
        self._sym[:] = 0

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> dict[str, np.ndarray]:
        """Current per-channel quality in engineering units."""
        return {
            "symbols": self._sym.copy(),
            "amp": self._amp.astype(np.float32),
            "power": self._power.astype(np.float32),
            "snr_db": snr_db(self._snr),
            "evm_pct": evm_pct(np.sqrt(self._evm2)),
            "lock": self._lock.astype(np.float32),
        }

    def alarms(self, min_lock: float = 0.5,
               min_snr_db: float = 3.0) -> np.ndarray:
        """(C,) bool: channels measured but below lock/SNR thresholds."""
        measured = self._sym > 0
        bad = (self._lock < min_lock) | (snr_db(self._snr) < min_snr_db)
        return measured & bad

    def __getattr__(self, name):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)
