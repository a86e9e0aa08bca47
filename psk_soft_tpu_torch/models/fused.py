"""Fused pipeline: kernel B5 timing frontend + the feed-forward symbol
backend (port of ``psk_soft_tpu/models/fused.py:28-134``).

Input stays time-major (T, C), so the sample-rate work (energy, windowed
bins, argmax, decision gather) is one kernel B5 launch that reads the
planes once, and only symbol-rate data (1/sps of it) flows through the
plain-torch backend (``models/blockpsk.symbol_backend``) afterwards.

Semantically the same as models/blockpsk (gated by the tests); restricted
to sps > 1, matched_filter "none" and channel counts that are multiples of
128 (the JAX package's contract, kept as the engine keeps it).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import DemodConfig
from ..ops.cuda.frontend_kernel import timing_frontend_tm
from .blockpsk import SymbolBackendState, symbol_backend
from .psk import DemodOutputs


class FusedState(NamedTuple):
    """Carry for the fused time-major pipeline (C channels in lockstep)."""

    win_re: torch.Tensor       # ((num_avg-1)*sps, C) float32
    win_im: torch.Tensor       # ((num_avg-1)*sps, C) float32
    seen: torch.Tensor         # () int32 -- all channels share the cadence
    phase_hist: torch.Tensor   # (C, phase_avg-1) float32
    phase_count: torch.Tensor  # (C,) int32
    last_phase: torch.Tensor   # (C,) float32
    last_any: torch.Tensor     # (C,) complex64


def fused_init(cfg: DemodConfig, channels: int, device) -> FusedState:
    """Fresh carry for ``channels`` chains on ``device``."""
    a1 = max(cfg.num_avg - 1, 0)
    f32 = dict(dtype=torch.float32, device=device)
    return FusedState(
        win_re=torch.zeros((a1 * cfg.sps, channels), **f32),
        win_im=torch.zeros((a1 * cfg.sps, channels), **f32),
        seen=torch.zeros((), dtype=torch.int32, device=device),
        phase_hist=torch.zeros((channels, max(cfg.phase_avg - 1, 0)), **f32),
        phase_count=torch.zeros((channels,), dtype=torch.int32,
                                device=device),
        last_phase=torch.zeros((channels,), **f32),
        last_any=torch.ones((channels,), dtype=torch.complex64,
                            device=device),
    )


def demod_block_fused(cfg: DemodConfig, state: FusedState,
                      x_re: torch.Tensor, x_im: torch.Tensor, *,
                      assume_steady: bool = False):
    """Demodulate one time-major block.

    Args:
      x_re/x_im: (T, C) float32 planes, T = S * sps.
      assume_steady: the converged fast path (every output valid, the
        tracker window full); identical outputs on a converged carry.
    Returns (new_state, DemodOutputs) with (C, S)-shaped outputs.  The new
    window carry is a view of the block's last (num_avg-1)*sps rows when
    the block is at least that long.
    """
    if cfg.sps <= 1:
        raise ValueError("fused pipeline requires sps > 1")
    if cfg.matched_filter != "none":
        raise ValueError("fused pipeline does not fold the matched filter; "
                         "use models.blockpsk")
    sps, num_avg = cfg.sps, cfg.num_avg
    T, C = x_re.shape
    if T % sps:
        raise ValueError(f"block length {T} not a multiple of sps={sps}")
    if C % 128:
        raise ValueError(f"channels ({C}) must be a multiple of 128")
    S = T // sps
    dev = x_re.device

    sel_re, sel_im, idx = timing_frontend_tm(
        state.win_re, state.win_im, x_re, x_im, sps=sps, num_avg=num_avg)

    # Symbol rate from here on (1/sps of the data): channel-major.
    sel = torch.complex(sel_re.T, sel_im.T)                  # (C, S)
    sample_index = idx.T
    if assume_steady:
        valid = torch.ones((C, S), dtype=torch.bool, device=dev)
        prev_exists = valid
    else:
        ar = torch.arange(S, dtype=torch.int32, device=dev)
        valid = ((state.seen + 1 + ar) >= num_avg).expand(C, S)
        prev_exists = ((state.seen + ar) >= num_avg).expand(C, S)

    bst = SymbolBackendState(state.phase_hist, state.phase_count,
                             state.last_phase, state.last_any)
    bst2, (soft, bits, phase_seq) = symbol_backend(
        cfg, bst, sel, valid, prev_exists, assume_steady=assume_steady)

    keep = (num_avg - 1) * sps
    if keep == 0:
        win_re, win_im = state.win_re, state.win_im
    elif T >= keep:
        win_re, win_im = x_re[T - keep:], x_im[T - keep:]
    else:
        win_re = torch.cat([state.win_re, x_re])[T:]
        win_im = torch.cat([state.win_im, x_im])[T:]
    new_state = FusedState(
        win_re=win_re, win_im=win_im,
        seen=torch.clamp(state.seen + S, max=num_avg).to(torch.int32),
        phase_hist=bst2.phase_hist,
        phase_count=bst2.phase_count,
        last_phase=bst2.last_phase,
        last_any=bst2.last_any,
    )
    if assume_steady:
        outputs = DemodOutputs(soft=soft, bits=bits.to(torch.int8),
                               phase=phase_seq, sample_index=sample_index,
                               valid=valid)
    else:
        zero = torch.zeros((), dtype=soft.dtype, device=dev)
        outputs = DemodOutputs(
            soft=torch.where(valid, soft, zero),
            bits=torch.where(valid.unsqueeze(-1), bits,
                             torch.zeros_like(bits)).to(torch.int8),
            phase=torch.where(valid, phase_seq, torch.zeros_like(phase_seq)),
            sample_index=torch.where(valid, sample_index,
                                     torch.zeros_like(sample_index)),
            valid=valid,
        )
    return new_state, outputs


def make_fused_demod_fn(cfg: DemodConfig, *, assume_steady: bool = False):
    """``fn(state, x_re, x_im) -> (state', DemodOutputs)`` for ``cfg``."""
    return functools.partial(demod_block_fused, cfg,
                             assume_steady=assume_steady)
