"""Demodulator carry state of the exact-scan pipeline (port of
``psk_soft_tpu/state.py:34-188``).

The reference keeps its cross-packet state in mutable deques and counters
(``cpp/psk_soft.h:66-86``).  Here it is one NamedTuple of tensors, channels
leading when batched, so a block step is ``step(state, block) -> (state,
outputs)`` and a checkpoint is the tuple's leaves.  :func:`reconfigure`
(property-change semantics, C7) is an explicit old-state -> new-state
function, in host numpy like the JAX package's, so its output is bit-equal.

Alignment convention: the timing window carry holds the most recent
``num_avg - 1`` whole symbols (rows of sps samples), right-aligned against
the next block, so block row o is both "the window starting at output
symbol o" and "the symbol emitted for window o".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import DemodConfig


class DemodState(NamedTuple):
    """Carry of the exact scan; shapes below for one chain, with a leading
    channel axis (C, ...) when batched."""

    # Timing window: previous num_avg-1 symbol rows (samples + energies).
    win_samples: torch.Tensor   # (num_avg-1, sps) complex64
    win_energy: torch.Tensor    # (num_avg-1, sps) float32
    # Symbols absorbed so far, saturating at num_avg (the warm-up gate,
    # cpp/psk_soft.cpp:457).
    seen: torch.Tensor          # () int32
    # Phase tracker (LinearFit equivalent): ring of unwrapped phases.
    ring: torch.Tensor          # (phase_avg,) float32
    ring_pos: torch.Tensor      # () int32, next write slot
    ring_fill: torch.Tensor     # () int32, saturating at phase_avg
    phase_est: torch.Tensor     # () float32, last fit output
    # Previous selected (pre-correction) symbol sample for differential
    # decoding; 1+0j at start (the reference's 0 makes its first
    # differential output NaN).
    last_any: torch.Tensor      # () complex64
    # Matched-filter input tail (ntaps-1 samples; empty when disabled).
    mf_tail: torch.Tensor       # (mf_ntaps-1 or 0,) complex64


def init_state(cfg: DemodConfig, channels: int | None = None,
               device="cuda") -> DemodState:
    """Fresh carry on ``device``: one chain, or ``channels`` chains along
    a leading axis."""
    lead = () if channels is None else (int(channels),)
    a1 = max(cfg.num_avg - 1, 0)
    c64 = dict(dtype=torch.complex64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return DemodState(
        win_samples=torch.zeros(lead + (a1, cfg.sps), **c64),
        win_energy=torch.zeros(lead + (a1, cfg.sps), **f32),
        seen=torch.zeros(lead, **i32),
        ring=torch.zeros(lead + (cfg.phase_avg,), **f32),
        ring_pos=torch.zeros(lead, **i32),
        ring_fill=torch.zeros(lead, **i32),
        phase_est=torch.zeros(lead, **f32),
        last_any=torch.ones(lead, **c64),
        mf_tail=torch.zeros(lead + (max(cfg.mf_ntaps - 1, 0),), **c64),
    )


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


def resync_carry(old_cfg: DemodConfig, new_cfg: DemodConfig, st, new, to):
    """The part of a C7 resync both carries share (this module's
    DemodState and models/blockpsk's FFState): ``new`` (a fresh carry for
    ``new_cfg``) takes ``st``'s (numpy) last symbol, its matched-filter
    tail while the filter is unchanged, and its timing window, re-binned by
    :func:`resync_window` when sps or num_avg changed.  ``to`` moves a numpy
    array to the carry's device."""
    new = new._replace(last_any=to(st.last_any))
    mf_keys = ("matched_filter", "sps", "rrc_beta", "rrc_span")
    if all(getattr(old_cfg, k) == getattr(new_cfg, k) for k in mf_keys):
        new = new._replace(mf_tail=to(st.mf_tail))
    resync = resync_window(old_cfg, new_cfg, st.win_samples, st.seen)
    if resync is None:
        return new._replace(win_samples=to(st.win_samples),
                            win_energy=to(st.win_energy), seen=to(st.seen))
    ws, we, seen = resync
    return new._replace(win_samples=to(ws), win_energy=to(we), seen=to(seen))


def reconfigure(old_cfg: DemodConfig, new_cfg: DemodConfig,
                state: DemodState) -> DemodState:
    """Re-derive the carry after a property change (C7; the reference's
    dirty-flag consumers, cpp/psk_soft.cpp:408-426, 619-651), on the
    carry's device:

    * sps / num_avg change: :func:`resync_window` (the reference re-bins
      only on an sps change and can stall when numAvg shrinks; this
      resyncs on any change);
    * constellation change: phase history cleared, estimate back to 0
      (``phaseEstimator.reset(NULL,NULL,true)``);
    * phase_avg change: the fit window keeps its newest points and the
      fit is recomputed (``LinearFit::reset``, cpp/psk_soft.cpp:104-122).

    Host-side numpy (shapes change), once per property change.
    """
    dev = state.seen.device
    st = DemodState(*(t.cpu().numpy() for t in state))
    channel_shape = np.shape(st.seen)
    # np.array copies to a C-contiguous array and keeps 0-d shapes.
    to = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    new = resync_carry(old_cfg, new_cfg, st, init_state(
        new_cfg, channel_shape[0] if channel_shape else None, dev), to)

    # --- phase tracker ---
    if old_cfg.constellation_size != new_cfg.constellation_size:
        return new  # history force-cleared; phase_est back to 0
    ring, pos, fill = st.ring, st.ring_pos, st.ring_fill
    n_old, n_new = old_cfg.phase_avg, new_cfg.phase_avg
    # Each channel's ring in chronological order; keep the newest
    # min(fill, n_new), written from slot 0 with one vectorized gather.
    idx = (np.arange(n_old) + np.where(fill == n_old, pos, 0)[..., None]) \
        % n_old
    chrono = np.take_along_axis(ring, idx, axis=-1)  # oldest..newest
    keep = np.minimum(fill, n_new)
    j = np.arange(n_new)
    src_idx = np.clip(np.asarray(fill)[..., None]
                      - np.asarray(keep)[..., None] + j, 0, n_old - 1)
    gathered = np.take_along_axis(chrono, src_idx, axis=-1)
    new_ring = np.where(j < np.asarray(keep)[..., None], gathered,
                        0.0).astype(np.float32)
    new_fill = keep.astype(np.int32)
    new_pos = (new_fill % n_new).astype(np.int32)
    phase_est = np.asarray(st.phase_est, np.float32)
    if n_old != n_new:
        # LinearFit::reset ends in calculateFit() (cpp/psk_soft.cpp:122).
        i = np.arange(n_new, dtype=np.float64)
        p = new_fill.astype(np.float64)
        ysum = np.sum(new_ring, axis=-1)
        xysum = np.sum(i * new_ring, axis=-1)
        d = p * (p * p - 1.0) / 12.0
        m = np.where(d != 0, (xysum - (p - 1) / 2 * ysum)
                     / np.where(d == 0, 1, d), 0.0)
        fit = np.where(p > 1,
                       ysum / np.where(p == 0, 1, p) + m * (p - 1) / 2,
                       np.where(p == 1, new_ring[..., 0], 0.0))
        phase_est = fit.astype(np.float32)
    return new._replace(ring=to(new_ring), ring_pos=to(new_pos),
                        ring_fill=to(new_fill), phase_est=to(phase_est))
