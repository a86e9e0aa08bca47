"""Block-parallel feed-forward PSK demodulator: the warm-up pipeline
(port of ``psk_soft_tpu/models/blockpsk.py:43-268``).

No scan at all: timing is windowed energy sums + argmax, the M-th-power
phases are unwrapped with a prefix sum against a decimated trend, and the
sliding linear fit is an FIR over the unwrapped phases, with a right-aligned
weight fix-up for the growing window of a fresh stream.

Every function is batched over a leading channel axis: states hold (C, ...)
tensors and blocks are (C, T) complex64.  ``_fir_phase_track`` evaluates
the FIR with ``unfold`` and a float32 matmul (no TF32 on any device).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import DemodConfig
from ..ops import linear_fit, phase as phase_ops
from .common import correct_and_slice, maybe_matched_filter, timing_frontend
from .psk import DemodOutputs, bank, one_chain


class FFState(NamedTuple):
    """Carry for the feed-forward pipeline, channels leading."""

    win_samples: torch.Tensor   # (C, num_avg-1, sps) complex64
    win_energy: torch.Tensor    # (C, num_avg-1, sps) float32
    seen: torch.Tensor          # (C,) int32, saturating at num_avg
    # Right-aligned history of the last (phase_avg-1) unwrapped phases;
    # only the rightmost min(phase_count, phase_avg-1) entries are live.
    phase_hist: torch.Tensor    # (C, phase_avg-1) float32
    phase_count: torch.Tensor   # (C,) int32, saturating at phase_avg
    last_phase: torch.Tensor    # (C,) float32, last unwrapped phase
    last_any: torch.Tensor      # (C,) complex64
    mf_tail: torch.Tensor       # (C, mf_ntaps-1 or 0) complex64


def ff_init(cfg: DemodConfig, channels: int | None = None,
            device="cuda") -> FFState:
    """Fresh carry for ``channels`` chains on ``device``; ``channels=None``
    is one chain without the channel axis (the JAX ``ff_init(cfg)``), the
    carry of :func:`make_ff_demod_fn`'s single-chain step."""
    a1 = max(cfg.num_avg - 1, 0)
    n1 = max(cfg.phase_avg - 1, 0)
    lead = () if channels is None else (channels,)
    c64 = dict(dtype=torch.complex64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return FFState(
        win_samples=torch.zeros(lead + (a1, cfg.sps), **c64),
        win_energy=torch.zeros(lead + (a1, cfg.sps), **f32),
        seen=torch.zeros(lead, **i32),
        phase_hist=torch.zeros(lead + (n1,), **f32),
        phase_count=torch.zeros(lead, **i32),
        last_phase=torch.zeros(lead, **f32),
        last_any=torch.ones(lead, **c64),
        mf_tail=torch.zeros(lead + (max(cfg.mf_ntaps - 1, 0),), **c64),
    )


def _fir_phase_track(cfg: DemodConfig, hist, phase_count, unwrapped, valid,
                     assume_steady: bool = False):
    """Sliding linear-fit estimates for one block, as FIR + warm-up fix.

    Args:
      hist: (C, n-1) right-aligned unwrapped-phase history.
      phase_count: (C,) int32 valid phases before this block (saturated).
      unwrapped: (C, S) block unwrapped phases (garbage where ~valid).
      valid: (C, S) bool; invalid entries form a prefix.

    Returns (est (C, S), new_hist (C, n-1), new_phase_count (C,)).
    """
    n = cfg.phase_avg
    S = unwrapped.shape[-1]
    dev = unwrapped.device
    cat = torch.cat([hist, unwrapped], dim=-1)            # (C, n-1+S)

    # Steady-state FIR: est[o] = w . cat[o:o+n]  (fit at newest point).
    if n == 1:
        est = unwrapped
    else:
        w = torch.as_tensor(linear_fit.endpoint_fir_weights(n), device=dev)
        est = cat.unfold(-1, n, 1) @ w                    # (C, S)

    if assume_steady:
        new_hist = cat[:, S:] if n > 1 else hist
        return est, new_hist, phase_count

    # Warm-up: outputs whose effective window p < n get the right-aligned
    # p-point weights (the growing window of a fresh stream).  The fix-up
    # window starts at each channel's first valid row.
    rank = torch.cumsum(valid.to(torch.int32), dim=-1)   # 1-based among valid
    p = torch.clamp(phase_count.unsqueeze(-1) + rank, max=n)
    if n > 1:
        k = min(n, S)
        fv = torch.argmax(valid.to(torch.int32), dim=-1)  # first valid
        start = torch.clamp(fv, max=S - k)                # (C,)
        rows = start.unsqueeze(-1) + torch.arange(k, device=dev)  # (C, k)
        wm = torch.as_tensor(linear_fit.warmup_fir_weight_matrix(n),
                             device=dev)
        idx = rows.unsqueeze(-1) + torch.arange(n, device=dev)   # (C, k, n)
        windows = torch.gather(cat, 1, idx.reshape(idx.shape[0], -1))
        windows = windows.reshape(idx.shape)
        p_warm = torch.gather(p, 1, rows)
        w_sel = wm[torch.clamp(p_warm, 1, n).long() - 1]         # (C, k, n)
        est_warm = torch.sum(windows * w_sel, dim=-1)
        est_slice = torch.gather(est, 1, rows)
        fixed = torch.where(p_warm < n, est_warm, est_slice)
        est = est.scatter(1, rows, fixed)

    new_count = torch.clamp(
        phase_count + valid.to(torch.int32).sum(-1), max=n).to(torch.int32)
    new_hist = cat[:, S:] if n > 1 else hist
    return est, new_hist, new_count


class SymbolBackendState(NamedTuple):
    """Symbol-rate carry: everything downstream of timing recovery."""

    phase_hist: torch.Tensor    # (C, phase_avg-1) float32
    phase_count: torch.Tensor   # (C,) int32
    last_phase: torch.Tensor    # (C,) float32
    last_any: torch.Tensor      # (C,) complex64


def symbol_backend(cfg: DemodConfig, st: SymbolBackendState,
                   sel: torch.Tensor, valid: torch.Tensor,
                   prev_exists: torch.Tensor, assume_steady: bool = False):
    """Phase recovery + correction + slicing over one block's (C, S)
    decision samples.  ``assume_steady=True`` is the converged fast path:
    every output valid and the tracker window full.

    Returns (new SymbolBackendState, (soft, bits, phase_seq)).
    """
    m = cfg.constellation_size
    S = sel.shape[-1]
    n1 = cfg.phase_avg - 1
    two_pi = phase_ops.TWO_PI

    raw = phase_ops.mth_power_phase(sel, m)                 # (C, S)
    if assume_steady:
        raw_eff = raw
    else:
        fv = torch.argmax(valid.to(torch.int32), dim=-1).clamp(0, S - 1)
        first_raw = torch.gather(raw, 1, fv.unsqueeze(-1)).squeeze(-1)
        prev_eff = torch.where(st.phase_count > 0, st.last_phase, first_raw)
        raw_eff = torch.where(valid, raw, prev_eff.unsqueeze(-1))
    # Unwrap over [history, block] in one locally-consistent chain, then
    # snap the absolute origin back onto the carry with whole turns.
    head = st.phase_hist if n1 > 0 else st.last_phase.unsqueeze(-1)
    h = head.shape[-1]
    ext = torch.cat([head, raw_eff], dim=-1)
    u_ext = phase_ops.robust_block_unwrap(ext)
    cont_shift = two_pi * torch.round(
        (st.last_phase - u_ext[:, h - 1]) / two_pi)
    if assume_steady:
        shift = cont_shift
    else:
        u_first = torch.gather(u_ext, 1, (h + fv).unsqueeze(-1)).squeeze(-1)
        start_shift = two_pi * torch.round((first_raw - u_first) / two_pi)
        shift = torch.where(st.phase_count > 0, cont_shift, start_shift)
    unwrapped = u_ext[:, h:] + shift.unsqueeze(-1)
    est, new_hist, new_count = _fir_phase_track(
        cfg, st.phase_hist, st.phase_count, unwrapped, valid,
        assume_steady=assume_steady)
    if assume_steady:
        phase_seq = est
        new_last_phase = unwrapped[:, S - 1]
        last_est = est[:, S - 1]
    else:
        phase_seq = torch.where(valid, est, torch.zeros_like(est))
        any_valid = valid.any(-1)
        last_rev = torch.argmax(valid.flip(-1).to(torch.int32), dim=-1)
        last_idx = torch.where(any_valid, S - 1 - last_rev,
                               torch.zeros_like(last_rev)).unsqueeze(-1)
        new_last_phase = torch.where(
            any_valid, torch.gather(unwrapped, 1, last_idx).squeeze(-1),
            st.last_phase)
        last_est = torch.where(any_valid,
                               torch.gather(est, 1, last_idx).squeeze(-1),
                               torch.zeros_like(st.last_phase))

    # End-of-block re-wrap about M*2pi: keep the carried history bounded;
    # estimates already emitted are unaffected.
    off = phase_ops.rewrap_offset(last_est, m)
    new_hist = new_hist - off.unsqueeze(-1)
    new_last_phase = new_last_phase - off

    soft, bits, last_any = correct_and_slice(cfg, sel, prev_exists,
                                             st.last_any, phase_seq)
    new_st = SymbolBackendState(phase_hist=new_hist, phase_count=new_count,
                                last_phase=new_last_phase, last_any=last_any)
    return new_st, (soft, bits, phase_seq)


def demod_block_ff(cfg: DemodConfig, state: FFState, x: torch.Tensor,
                   assume_steady: bool = False):
    """Feed-forward demod of one symbol-aligned (C, T) complex64 block.

    Returns (new FFState, DemodOutputs with (C, S) planes).
    """
    sps = cfg.sps
    T = x.shape[-1]
    if T % sps != 0:
        raise ValueError(f"block length {T} not a multiple of sps={sps}")
    S = T // sps
    x, mf_tail = maybe_matched_filter(cfg, state, x)
    xs = x.reshape(x.shape[0], S, sps)

    fe = timing_frontend(cfg, state.win_samples, state.win_energy,
                         state.seen, xs)
    sel = fe["sel"]
    if assume_steady:
        valid = torch.ones(sel.shape, dtype=torch.bool, device=sel.device)
        prev_exists = valid
    else:
        valid, prev_exists = fe["valid"], fe["prev_exists"]

    bst = SymbolBackendState(state.phase_hist, state.phase_count,
                             state.last_phase, state.last_any)
    bst2, (soft, bits, phase_seq) = symbol_backend(
        cfg, bst, sel, valid, prev_exists, assume_steady=assume_steady)

    new_state = FFState(
        win_samples=fe["new_win_samples"],
        win_energy=fe["new_win_energy"],
        seen=fe["seen2"],
        phase_hist=bst2.phase_hist,
        phase_count=bst2.phase_count,
        last_phase=bst2.last_phase,
        last_any=bst2.last_any,
        mf_tail=mf_tail,
    )
    if assume_steady:
        outputs = DemodOutputs(soft=soft, bits=bits.to(torch.int8),
                               phase=phase_seq,
                               sample_index=fe["sample_index"], valid=valid)
    else:
        outputs = DemodOutputs(
            soft=torch.where(valid, soft, torch.zeros_like(soft)),
            bits=torch.where(valid.unsqueeze(-1), bits,
                             torch.zeros_like(bits)).to(torch.int8),
            phase=phase_seq,
            sample_index=torch.where(valid, fe["sample_index"],
                                     torch.zeros_like(fe["sample_index"])),
            valid=valid,
        )
    return new_state, outputs


def make_ff_demod_fn(cfg: DemodConfig, channels: int | None = None, *,
                     assume_steady: bool = False):
    """The feed-forward block step ``fn(state, x) -> (state,
    DemodOutputs)``: one chain ((T,) in with an :func:`ff_init` ``(cfg)``
    carry, (S,) out) or, with ``channels`` set, a bank with a leading
    channel axis.  ``x`` may be numpy (copied to the state's device) or a
    tensor on the state's device.  The JAX ``jit`` argument has no
    counterpart."""
    step = functools.partial(demod_block_ff, cfg,
                             assume_steady=assume_steady)
    if channels is None:
        return functools.partial(one_chain, step)
    return functools.partial(bank, step, int(channels))


def make_scanned_ff_demod_fn(cfg: DemodConfig, channels: int | None = None,
                             *, assume_steady: bool = False):
    """Many block steps in one call: ``fn(state, xs)`` with ``xs`` shaped
    (K, T) (or (K, C, T) with ``channels``) runs the carried step over the
    leading axis, a loop where JAX scans, and returns (state, DemodOutputs
    stacked field by field on a leading K axis)."""
    step = make_ff_demod_fn(cfg, channels, assume_steady=assume_steady)

    def run(state: FFState, xs):
        outs = []
        for k in range(len(xs)):
            state, out = step(state, xs[k])
            outs.append(out)
        return state, DemodOutputs(*(torch.stack(f) for f in zip(*outs)))

    return run
