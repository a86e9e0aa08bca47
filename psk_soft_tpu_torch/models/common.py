"""Shared pipeline stages (port of ``psk_soft_tpu/models/common.py:13-89``).

The JAX functions handle one chain and are vmapped over channels; these
take any leading (channel) axes and work on the trailing ones.
"""

from __future__ import annotations

import math

import torch

from ..config import DemodConfig
from ..ops import matched_filter, slicers, timing


def maybe_matched_filter(cfg: DemodConfig, state, x: torch.Tensor):
    """Apply the configured matched filter (streaming overlap-save).

    Returns (filtered_x, new_mf_tail); identity when disabled.
    """
    if cfg.matched_filter == "none":
        return x, state.mf_tail
    taps = torch.as_tensor(matched_filter.filter_taps(cfg), device=x.device)
    return matched_filter.streaming_filter(x, state.mf_tail, taps)


def timing_frontend(cfg: DemodConfig, win_samples, win_energy, seen, xs):
    """C2 timing recovery over one block of symbol rows.

    Args:
      win_samples/win_energy: (..., num_avg-1, sps) carry rows.
      seen: (...,) int32 saturating symbol count.
      xs: (..., S, sps) block rows.

    Returns a dict with sel (..., S), sample_index (..., S) int32, valid and
    prev_exists (..., S) bool, new_win_samples/new_win_energy, seen2.
    """
    S = xs.shape[-2]
    num_avg = cfg.num_avg
    ar = torch.arange(S, dtype=torch.int32, device=xs.device)
    seen_c = seen.unsqueeze(-1)
    if cfg.sps > 1:
        e = timing.symbol_energy_rows(xs)
        e_cat = torch.cat([win_energy, e], dim=-2)
        s_cat = torch.cat([win_samples, xs], dim=-2)
        w = timing.windowed_bin_sums(e_cat, num_avg)
        if cfg.timing_interp:
            sample_index, sel = timing.select_decision_samples_interp(
                s_cat.reshape(*s_cat.shape[:-2], -1), w, cfg.sps)
        else:
            sample_index, sel = timing.select_decision_samples(
                s_cat[..., :S, :], w)
        valid = (seen_c + 1 + ar) >= num_avg
        prev_exists = (seen_c + ar) >= num_avg
        new_win_s, new_win_e = s_cat[..., S:, :], e_cat[..., S:, :]
    else:
        # sps == 1: every sample is a symbol.
        sel = xs[..., 0]
        sample_index = torch.zeros(sel.shape, dtype=torch.int32,
                                   device=xs.device)
        valid = torch.ones(sel.shape, dtype=torch.bool, device=xs.device)
        prev_exists = (seen_c + ar) >= 1
        new_win_s, new_win_e = win_samples, win_energy
    seen2 = torch.clamp(seen + S, max=num_avg).to(torch.int32)
    return dict(sel=sel, sample_index=sample_index, valid=valid,
                prev_exists=prev_exists, new_win_samples=new_win_s,
                new_win_energy=new_win_e, seen2=seen2)


def correct_and_slice(cfg: DemodConfig, sel, prev_exists, last_any,
                      phase_seq):
    """C5/C6: differential decode or derotation, then bit slicing.

    sel/prev_exists/phase_seq: (..., S); last_any: (...,).
    Returns (soft, bits, new_last_any).
    """
    m = cfg.constellation_size
    shifted = torch.cat([last_any.unsqueeze(-1), sel[..., :-1]], dim=-1)
    one = torch.ones((), dtype=sel.dtype, device=sel.device)
    prev = torch.where(prev_exists, shifted, one)
    if cfg.differential:
        base = sel / prev
        correction = torch.zeros_like(phase_seq)
    else:
        base = sel
        correction = -phase_seq / m
    if m == 4:
        # +pi/4 so decisions sit at (+-1 +- j)/sqrt(2).
        correction = correction + math.pi / 4
    phasor = torch.complex(torch.cos(correction), torch.sin(correction))
    soft = (base * phasor).to(torch.complex64)
    bits = slicers.slice_bits(m, soft)
    return soft, bits, sel[..., -1]
