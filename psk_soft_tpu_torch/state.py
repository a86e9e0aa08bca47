"""Demodulator carry-state helpers (port of
``psk_soft_tpu/state.py:74-100``).

Only the host-side timing-window resync is here so far; the exact-scan
``DemodState`` with ``init_state`` and ``reconfigure`` waits for ROADMAP
A.5.  Alignment convention: the timing window carry holds the most recent
``num_avg - 1`` whole symbols (rows of sps samples), right-aligned against
the next block.
"""

from __future__ import annotations

import numpy as np

from .config import DemodConfig


def resync_window(old_cfg: DemodConfig, new_cfg: DemodConfig,
                  win_samples: np.ndarray, seen: np.ndarray):
    """resyncEnergy semantics (reference cpp/psk_soft.cpp:619-636): keep
    the most recent whole new-sps symbols that fit the new window, re-bin
    energies, restart the warm-up count from what was kept.

    Returns (win_samples', win_energy', seen') as numpy arrays shaped for
    ``new_cfg`` (right-aligned rows), or None when the window is unchanged.
    """
    if (old_cfg.sps, old_cfg.num_avg) == (new_cfg.sps, new_cfg.num_avg):
        return None
    channel_shape = np.shape(seen)
    old_rows = min(int(np.min(seen)) if np.size(seen) else 0,
                   old_cfg.num_avg - 1)
    flat = np.asarray(win_samples).reshape(channel_shape + (-1,))
    flat = flat[..., (old_cfg.num_avg - 1 - old_rows) * old_cfg.sps:]
    keep_syms = min(flat.shape[-1] // new_cfg.sps, new_cfg.num_avg - 1)
    a1 = max(new_cfg.num_avg - 1, 0)
    ws = np.zeros(channel_shape + (a1, new_cfg.sps), np.complex64)
    we = np.zeros(channel_shape + (a1, new_cfg.sps), np.float32)
    if keep_syms > 0:
        tail = flat[..., flat.shape[-1] - keep_syms * new_cfg.sps:]
        rows = tail.reshape(channel_shape + (keep_syms, new_cfg.sps))
        ws[..., a1 - keep_syms:, :] = rows
        we[..., a1 - keep_syms:, :] = (rows.real ** 2
                                       + rows.imag ** 2).astype(np.float32)
    return ws, we, np.full(channel_shape, keep_syms, np.int32)
