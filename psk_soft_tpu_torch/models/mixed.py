"""Mixed-mode multi-channel demod: per-channel constellation and
differential flag (port of ``psk_soft_tpu/models/mixed.py:32-143``).

BASELINE config 4: a BPSK/QPSK/8-PSK bank.  The constellation size and
the differential flag are per-channel tensors, so one call serves a
heterogeneous bank (channels still share sps, num_avg and phase_avg).
Every mode-dependent stage is an elementwise select over the variants
(ops/phase.mth_power_phase_dynamic, ops/slicers.slice_bits_dynamic).  This
is the warm-up of ``runtime/engine_mixed.MixedKernelBatchEngine``; kernel
B1's ``mixed`` mode is its steady state.

The JAX chain handles one channel and is vmapped; here every function is
batched over the leading channel axis, as in models/blockpsk.  Like the JAX
chain it applies no matched filter.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import DemodConfig
from ..ops import phase as phase_ops, slicers
from .blockpsk import FFState, _fir_phase_track, ff_init
from .common import timing_frontend
from .psk import DemodOutputs


class MixedParams(NamedTuple):
    """Per-channel demod mode."""

    m: torch.Tensor     # (C,) int32 in {2, 4, 8, 16, 32}
    diff: torch.Tensor  # (C,) bool

    @classmethod
    def make(cls, m, diff, device):
        """From any array-likes (numpy, lists, tensors) of C modes, on
        ``device``."""
        return cls(torch.as_tensor(np.array(m), dtype=torch.int32,
                                   device=device),
                   torch.as_tensor(np.array(diff), dtype=torch.bool,
                                   device=device))

    def to(self, device) -> "MixedParams":
        return MixedParams(self.m.to(device), self.diff.to(device))

    @property
    def bits_per_symbol(self) -> torch.Tensor:
        """log2(M) per channel: 2->1, 4->2, 8->3, 16->4, 32->5."""
        b = torch.zeros_like(self.m)
        for k in (2, 4, 8, 16):
            b = b + (self.m > k).to(b.dtype)
        return b + 1

    @property
    def max_bits(self) -> int:
        """Bit-plane width of this bank: at least 3, log2 of its largest M."""
        return max(3, int(self.m.max()).bit_length() - 1)


def demod_block_mixed(cfg: DemodConfig, params: MixedParams, st: FFState,
                      x: torch.Tensor, max_bits: int = 3):
    """Feed-forward demod of one (C, T) complex64 block with per-channel
    (M, differential); cfg's constellation_size and differential are
    ignored.  Returns (new FFState, DemodOutputs with (C, S) planes and
    ``max_bits`` bit planes)."""
    sps = cfg.sps
    C, T = x.shape
    if T % sps:
        raise ValueError(f"block length {T} not a multiple of sps={sps}")
    S = T // sps
    m = params.m.to(x.device)
    diff = params.diff.to(x.device)
    mc, dc = m.unsqueeze(-1), diff.unsqueeze(-1)
    fe = timing_frontend(cfg, st.win_samples, st.win_energy, st.seen,
                         x.reshape(C, S, sps))
    sel, valid = fe["sel"], fe["valid"]

    # Phase chain with the channel's M.
    raw = phase_ops.mth_power_phase_dynamic(sel, mc)
    fv = torch.argmax(valid.to(torch.int32), dim=-1).clamp(0, S - 1)
    first_raw = torch.gather(raw, 1, fv.unsqueeze(-1)).squeeze(-1)
    prev_eff = torch.where(st.phase_count > 0, st.last_phase, first_raw)
    raw_eff = torch.where(valid, raw, prev_eff.unsqueeze(-1))
    n1 = cfg.phase_avg - 1
    head = st.phase_hist if n1 > 0 else st.last_phase.unsqueeze(-1)
    h = head.shape[-1]
    u_ext = phase_ops.robust_block_unwrap(torch.cat([head, raw_eff], dim=-1))
    two_pi = phase_ops.TWO_PI
    cont_shift = two_pi * torch.round(
        (st.last_phase - u_ext[:, h - 1]) / two_pi)
    u_first = torch.gather(u_ext, 1, (h + fv).unsqueeze(-1)).squeeze(-1)
    start_shift = two_pi * torch.round((first_raw - u_first) / two_pi)
    shift = torch.where(st.phase_count > 0, cont_shift, start_shift)
    unwrapped = u_ext[:, h:] + shift.unsqueeze(-1)
    est, new_hist, new_count = _fir_phase_track(
        cfg, st.phase_hist, st.phase_count, unwrapped, valid)
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
    # Re-wrap about the channel's own M*2pi.
    off = phase_ops.rewrap_offset(last_est, m.to(torch.float32))
    new_hist = new_hist - off.unsqueeze(-1)
    new_last_phase = new_last_phase - off

    # Correction: differential, or derotation by -est/M (+pi/4 for QPSK).
    shifted = torch.cat([st.last_any.unsqueeze(-1), sel[:, :-1]], dim=-1)
    one = torch.ones((), dtype=sel.dtype, device=sel.device)
    prev = torch.where(fe["prev_exists"], shifted, one)
    mf = mc.to(torch.float32)
    correction = torch.where(dc, torch.zeros_like(phase_seq),
                             -phase_seq / mf)
    correction = correction + torch.where(
        mc == 4, torch.full((), math.pi / 4, dtype=torch.float32,
                            device=x.device),
        torch.zeros((), dtype=torch.float32, device=x.device))
    phasor = torch.complex(torch.cos(correction), torch.sin(correction))
    base = torch.where(dc, sel / prev, sel)
    soft = (base * phasor).to(torch.complex64)
    bits = slicers.slice_bits_dynamic(mc, soft, max_bits=max_bits)

    new_state = FFState(
        win_samples=fe["new_win_samples"], win_energy=fe["new_win_energy"],
        seen=fe["seen2"], phase_hist=new_hist, phase_count=new_count,
        last_phase=new_last_phase, last_any=sel[:, -1], mf_tail=st.mf_tail)
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


def make_mixed_demod_fn(cfg: DemodConfig, max_bits: int = 3):
    """fn(params, state, x (C, T)) -> (state, DemodOutputs (C, S)), the
    JAX package's signature.  ``max_bits``: 3 covers {2, 4, 8} banks; pass
    ``params.max_bits`` for banks with 16- or 32-PSK channels."""
    def run(params: MixedParams, state: FFState, x: torch.Tensor):
        return demod_block_mixed(cfg, params, state, x, max_bits)

    return run


def mixed_init(cfg: DemodConfig, channels: int, device) -> FFState:
    return ff_init(cfg, channels, device)
