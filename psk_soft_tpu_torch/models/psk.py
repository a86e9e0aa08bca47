"""Exact-semantics PSK demodulator, the golden-parity pipeline (port of
``psk_soft_tpu/models/psk.py:61-176``).

Reproduces the reference hot loop (C2/C3/C4/C5/C6, ``cpp/psk_soft.cpp:
442-603``) as a block step ``demod_block(cfg, state, x) -> (state',
DemodOutputs)``.  Everything parallel in the reference's per-sample loop is
computed for the whole block at once (energy binning, windowed argmax,
decision samples, M-th-power phase, rotation, slicing); only the true
recursion -- unwrap against the estimate feeding the sliding linear fit
(cpp/psk_soft.cpp:477-481) -- is a Python loop over the block's symbols,
each step vectorised over channels, with no host sync inside it.  The
feed-forward recast (``models/blockpsk``) and the kernels are tested
against this module.

Alignment (see state.py): output o of a block is stream symbol
``seen_before + o - (num_avg - 1)``, emitted from the forward window of
symbols [o, o + num_avg - 1] like the reference emits the oldest symbol of
its just-completed window; the first ``num_avg - 1`` window positions of a
fresh stream are invalid (warm-up, cpp/psk_soft.cpp:457).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import DemodConfig
from ..ops import linear_fit, phase as phase_ops
from ..state import DemodState, init_state
from .common import correct_and_slice, maybe_matched_filter, timing_frontend


class DemodOutputs(NamedTuple):
    """Per-block outputs; the four reference output ports plus validity.
    Leading axes are channels (C, S, ...).

    soft:         (C, S) complex64  -- softDecision_dataFloat_out (or a
                                       models/full.QuantSoft)
    bits:         (C, S, 3) int8    -- bits_dataShort_out, LSB-first, only
                                       the first cfg.bits_per_symbol columns
                                       valid
    phase:        (C, S) float32    -- phase_dataFloat_out (or None)
    sample_index: (C, S) int        -- sampleIndex_dataShort_out (or None)
    valid:        (C, S) bool       -- warm-up gate; invalid rows are padding
    """

    soft: torch.Tensor
    bits: torch.Tensor
    phase: torch.Tensor | None
    sample_index: torch.Tensor | None
    valid: torch.Tensor


def _ring_set(ring: torch.Tensor, onehot: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """ring[..., pos] = val, with the slot given as a one-hot mask."""
    return torch.where(onehot, val.unsqueeze(-1), ring)


def _phase_scan(cfg: DemodConfig, state: DemodState, raw: torch.Tensor,
                valid: torch.Tensor):
    """Sequential unwrap + sliding linear fit over a block's symbols.

    raw/valid: (C, S).  Returns ((ring, pos, fill, est), phase_seq (C, S)).

    An invalid (warm-up) symbol leaves the tracker untouched: the reference
    runs phase recovery only when a symbol is emitted (cpp/psk_soft.cpp:
    457-481).  So the write slot and the fill count of every step follow
    from the count of valid symbols before it, and everything that depends
    on them alone -- the one-hot slots, the rank masks of ring_fit's
    windowed sums, and fit_at_newest's terms in the fill p -- is computed
    for the whole block before the loop.  The loop carries the ring and
    the estimate; each step is ops/linear_fit.fit_at_newest's arithmetic
    in its order (p >= 1 after a write, so its p == 0 branch never
    applies), with no host sync.
    """
    n = cfg.phase_avg
    S = raw.shape[-1]
    dev = raw.device
    pos0, fill0 = state.ring_pos, state.ring_fill
    # Valid symbols among steps 0..o-1 (before step o) and 0..o (after).
    after = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    before = after - valid.to(torch.int32)
    pos_cur = torch.remainder(pos0.unsqueeze(-1) + before, n)       # (C, S)
    fill_cur = torch.clamp(fill0.unsqueeze(-1) + before, max=n)
    pos2 = torch.remainder(pos_cur + 1, n)
    fill2 = torch.clamp(fill_cur + 1, max=n).to(torch.int32)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    onehot = slots == pos_cur.unsqueeze(-1)                          # (C, S, n)
    rank = linear_fit.ring_rank(n, pos2.unsqueeze(-1), fill2.unsqueeze(-1))
    maskv = (rank < fill2.unsqueeze(-1)).to(torch.float32)
    # ysum and xysum weights; rank*mask*y == (rank*y)*mask exactly.
    weights = torch.stack([maskv, rank.to(torch.float32) * maskv], dim=-2)
    p = fill2.to(torch.float32)
    d = linear_fit.denominator(fill2)
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    half_pm1 = (p - 1.0) / 2.0
    pm1 = p - 1.0
    more = fill2 > 1
    zero = torch.zeros((), dtype=raw.dtype, device=dev)

    ring, est = state.ring, state.phase_est
    phase_seq = []
    for o in range(S):
        y = phase_ops.unwrap_step(est, raw[:, o])
        ring2 = _ring_set(ring, onehot[:, o], y)
        sums = torch.sum(ring2.unsqueeze(-2) * weights[:, o], dim=-1)
        ysum, xysum = sums[:, 0], sums[:, 1]
        m = (xysum - half_pm1[:, o] * ysum) / safe_d[:, o]
        est2 = ysum / p[:, o] + m * pm1[:, o] / 2.0
        est2 = torch.where(more[:, o], est2, y)
        k = valid[:, o]
        ring = torch.where(k.unsqueeze(-1), ring2, ring)
        est = torch.where(k, est2, est)
        phase_seq.append(torch.where(k, est2, zero))
    phase_seq = torch.stack(phase_seq, dim=-1)
    count = valid.to(torch.int32).sum(-1)
    pos = torch.remainder(pos0 + count, n).to(torch.int32)
    fill = torch.clamp(fill0 + count, max=n).to(torch.int32)

    # End-of-block re-wrap about M*2pi (cpp/psk_soft.cpp:592-603) keeps the
    # estimate bounded over long streams without changing soft symbols.
    off = phase_ops.rewrap_offset(est, cfg.constellation_size)
    ring = ring - off.unsqueeze(-1)
    est = est - off
    return (ring, pos, fill, est), phase_seq


def demod_block(cfg: DemodConfig, state: DemodState, x: torch.Tensor):
    """Demodulate one symbol-aligned block of C channels.

    state: a channel-batched DemodState (C leading); x: (C, T) complex64
    with T = S * cfg.sps, S >= 1.  Returns (new_state, DemodOutputs) with
    (C, S) planes.
    """
    sps, m = cfg.sps, cfg.constellation_size
    T = x.shape[-1]
    if T % sps != 0:
        raise ValueError(f"block length {T} not a multiple of sps={sps}")
    S = T // sps
    x, mf_tail = maybe_matched_filter(cfg, state, x)
    xs = x.reshape(x.shape[0], S, sps)

    # --- C2: windowed max-energy timing recovery, fully parallel ---
    fe = timing_frontend(cfg, state.win_samples, state.win_energy,
                         state.seen, xs)
    sel, sample_index, valid = fe["sel"], fe["sample_index"], fe["valid"]

    # --- C3: M-th-power phase + unwrap + linear-fit tracking ---
    raw = phase_ops.mth_power_phase(sel, m)
    (ring, pos, fill, est), phase_seq = _phase_scan(cfg, state, raw, valid)

    # --- C5/C6: differential decode or derotation, then slicing ---
    soft, bits, last_any = correct_and_slice(cfg, sel, fe["prev_exists"],
                                             state.last_any, phase_seq)

    new_state = DemodState(
        win_samples=fe["new_win_samples"],
        win_energy=fe["new_win_energy"],
        seen=fe["seen2"],
        ring=ring,
        ring_pos=pos,
        ring_fill=fill,
        phase_est=est,
        last_any=last_any,
        mf_tail=mf_tail,
    )
    outputs = DemodOutputs(
        soft=torch.where(valid, soft, torch.zeros_like(soft)),
        bits=torch.where(valid.unsqueeze(-1), bits,
                         torch.zeros_like(bits)).to(torch.int8),
        phase=torch.where(valid, phase_seq, torch.zeros_like(phase_seq)),
        sample_index=torch.where(valid, sample_index,
                                 torch.zeros_like(sample_index)),
        valid=valid,
    )
    return new_state, outputs


def _block_input(x, device) -> torch.Tensor:
    """A block as complex64 on the state's device: numpy input is copied
    there; a tensor must already be there."""
    if isinstance(x, torch.Tensor):
        if x.device != torch.device(device):
            raise ValueError(f"block is on {x.device}, the state on "
                             f"{device}")
        return x.to(torch.complex64)
    return torch.from_numpy(np.asarray(x, np.complex64)).to(device)


def one_chain(step, state, x):
    """A channel-batched block step ``step(state, x)`` run on one chain:
    (T,) in, (S,) out, through a C = 1 batch."""
    x = _block_input(x, state.seen.device)
    if x.ndim != 1:
        raise ValueError(f"expected a (T,) block, got {tuple(x.shape)}")
    new, out = step(type(state)(*(t.unsqueeze(0) for t in state)),
                    x.unsqueeze(0))
    return (type(new)(*(t.squeeze(0) for t in new)),
            type(out)(*(t.squeeze(0) for t in out)))


def bank(step, channels: int, state, x):
    """A channel-batched block step on a (channels, T) block."""
    x = _block_input(x, state.seen.device)
    if x.ndim != 2 or x.shape[0] != channels:
        raise ValueError(f"expected a ({channels}, T) block, got "
                         f"{tuple(x.shape)}")
    return step(state, x)


def make_demod_fn(cfg: DemodConfig, channels: int | None = None):
    """The block step ``fn(state, x) -> (state, DemodOutputs)``: one chain
    ((T,) in, (S,) out) or, with ``channels`` set, a bank with a leading
    channel axis.  ``x`` may be numpy (copied to the state's device) or a
    tensor on the state's device."""
    step = functools.partial(demod_block, cfg)
    if channels is None:
        return functools.partial(one_chain, step)
    return functools.partial(bank, step, int(channels))


def demod_init(cfg: DemodConfig, channels: int | None = None,
               device="cuda") -> DemodState:
    """Fresh carry on ``device`` (see state.init_state)."""
    return init_state(cfg, channels, device)
