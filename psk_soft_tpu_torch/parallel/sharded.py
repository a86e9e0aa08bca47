"""Mesh-sharded batch demodulation: channels x time-blocks with seam
exchange (port of ``psk_soft_tpu/parallel/sharded.py:1-230``).

The demod of a (C, T) batch is sharded over a (chan, time) :class:`Mesh`.
The channel axis is communication-free.  Splitting one stream's *time*
axis turns the reference's sequential carries into three tiny seam
structures:

* **Timing halo** (overlap-save): output symbol k needs the energy window
  of symbols [k, k + numAvg - 1] (cpp/psk_soft.cpp:457-465 emits the
  oldest symbol of the just-full window), so each shard pulls the first
  ``numAvg - 1`` symbol rows of its right neighbor via ``ppermute``.
* **Phase-unwrap prefix**: local unwraps differ from the global unwrap by
  a per-shard constant delta_t that accumulates seam corrections
  c_t = 2pi*round((u_{t-1}[last] - raw_t[0]) / 2pi); an ``all_gather`` of
  three scalars per (shard, channel) and a K-length cumsum recovers every
  delta -- the associative-scan recast of the reference's recursion
  (cpp/psk_soft.cpp:477-478).
* **Fit/differential halo**: the FIR phase tracker needs the previous
  ``phaseAvg - 1`` unwrapped phases, and differential decoding the
  previous decision sample -- one left ``ppermute`` each.

Batch semantics match streaming the same array through the carried
pipeline: outputs are emitted for stream symbols [0, N - numAvg + 1) and
the tail is masked invalid.  Shard-size constraints (asserted): symbols
per time shard >= numAvg - 1 and >= phaseAvg - 1, so every halo comes from
the immediate neighbor.

Plain PyTorch, no kernel: the JAX body is plain XLA too.  The FIR tracker's
'valid' correlation (``_conv_valid``, XLA's convolution there) is an
unfold and a float32 product here, as in models/blockpsk.
"""

from __future__ import annotations

import functools
import math

import torch

from ..config import DemodConfig
from ..models.psk import DemodOutputs
from ..ops import linear_fit, phase as phase_ops, slicers, timing
from .mesh import (P, Mesh, all_gather, axis_index, axis_size, ppermute,
                   shard_map)

TWO_PI = phase_ops.TWO_PI


def _right_halo(rows: torch.Tensor, k: int, axis_name: str) -> torch.Tensor:
    """Receive the first rows (axis 1) of the right neighbor; the last
    shard gets zeros (its tail windows are invalid anyway)."""
    n_sh = axis_size(axis_name)
    perm = [(i, i - 1) for i in range(1, n_sh)]
    return ppermute(rows[:, :k].contiguous(), axis_name, perm)


def _left_shift(vals: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Receive values from the left neighbor; the first shard gets
    zeros."""
    n_sh = axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n_sh - 1)]
    return ppermute(vals.contiguous(), axis_name, perm)


def _sharded_body(cfg: DemodConfig, total_symbols: int, x: torch.Tensor):
    """Per-shard body.  x: (C_loc, S_loc * sps) complex64."""
    sps, num_avg, m, n = (cfg.sps, cfg.num_avg, cfg.constellation_size,
                          cfg.phase_avg)
    dev = x.device
    c_loc = x.shape[0]
    s_loc = x.shape[1] // sps

    # ---- optional matched filter (left sample halo = overlap-save) ----
    if cfg.matched_filter != "none":
        from ..ops import matched_filter as mf
        taps = torch.as_tensor(mf.filter_taps(cfg), device=dev)
        ntaps = cfg.mf_ntaps
        halo = _left_shift(x[:, x.shape[1] - (ntaps - 1):], "time")
        x = mf.apply_fir(torch.cat([halo, x], dim=1), taps)

    xs = x.reshape(c_loc, s_loc, sps)
    t_idx = axis_index("time")
    gsym = t_idx * s_loc + torch.arange(s_loc, dtype=torch.int32,
                                        device=dev)
    # Valid outputs: the reference emits symbol k only once symbol
    # k+numAvg-1 exists (cpp/psk_soft.cpp:457).
    valid = gsym < (total_symbols - num_avg + 1)

    # ---- timing: overlap-save right halo + windowed argmax ----
    if sps > 1:
        if s_loc >= num_avg - 1:
            halo = _right_halo(xs, num_avg - 1, "time")
        else:  # only legal single-shard (asserted in make_sharded_demod)
            halo = torch.zeros((c_loc, num_avg - 1, sps), dtype=xs.dtype,
                               device=dev)
        e_local = timing.symbol_energy_rows(xs)
        e_halo = timing.symbol_energy_rows(halo)
        rows = torch.cat([xs, halo], dim=1)              # (C, S+A-1, sps)
        e = torch.cat([e_local, e_halo], dim=1)
        w = timing.windowed_bin_sums(e, num_avg)         # (C, S, sps)
        if cfg.timing_interp:
            sample_index, sel = timing.select_decision_samples_interp(
                rows.reshape(c_loc, -1), w, sps)
        else:
            sample_index, sel = timing.select_decision_samples(xs, w)
    else:
        sel = xs[..., 0]
        sample_index = torch.zeros((c_loc, s_loc), dtype=torch.int32,
                                   device=dev)

    # ---- phase: trend-robust local unwrap over a raw halo + seam combine
    raw = phase_ops.mth_power_phase(sel, m)              # (C, S)
    halo_len = max(n - 1, phase_ops.UNWRAP_TREND_LEN - 1, 1)
    if s_loc >= halo_len:
        halo_raw = _left_shift(raw[:, -halo_len:], "time")  # 0 on shard 0
    else:  # only legal single-shard (asserted in make_sharded_demod)
        halo_raw = torch.zeros((c_loc, halo_len), dtype=raw.dtype,
                               device=dev)
    ext = torch.cat([halo_raw, raw], dim=1)              # (C, H+S)
    u_ext = phase_ops.robust_block_unwrap(ext)
    # Seam combine: each shard publishes its last owned unwrapped value,
    # that symbol as its right neighbor computes it inside the halo, and
    # its local origin correction; deltas are a prefix sum over the seam
    # corrections (cpp/psk_soft.cpp:477-478 as an associative scan).
    own_last = u_ext[:, -1]
    halo_last = u_ext[:, halo_len - 1]
    origin_fix = TWO_PI * torch.round((raw[:, 0] - u_ext[:, halo_len])
                                      / TWO_PI)
    seam = torch.stack([own_last, halo_last, origin_fix], dim=0)  # (3, C)
    gathered = all_gather(seam, "time")                  # (K, 3, C)
    c_seam = TWO_PI * torch.round(
        (gathered[:-1, 0, :] - gathered[1:, 1, :]) / TWO_PI)     # (K-1, C)
    delta_all = torch.cat(
        [torch.zeros((1, c_loc), dtype=torch.float32, device=dev),
         torch.cumsum(c_seam, dim=0)], dim=0) + gathered[0, 2, :][None]
    delta = delta_all[t_idx]                             # (C,)

    # ---- FIR tracker (the unwrapped halo doubles as the fit lead-in) ----
    if n > 1:
        cat = u_ext[:, halo_len - (n - 1):] + delta[:, None]  # (C, n-1+S)
        wfir = torch.as_tensor(linear_fit.endpoint_fir_weights(n),
                               device=dev)
        est = _conv_valid(cat, wfir)                     # (C, S)
        # Warm-up (growing window) affects global output indices < n, i.e.
        # the first rows of the first shard(s).
        k = min(n, s_loc)
        p = torch.clamp(gsym[:k] + 1, max=n)
        wm = torch.as_tensor(linear_fit.warmup_fir_weight_matrix(n),
                             device=dev)
        idx = (torch.arange(k, device=dev)[:, None]
               + torch.arange(n, device=dev)[None, :])
        windows = cat[:, idx]                            # (C, k, n)
        w_sel = wm[torch.clamp(p, 1, n).long() - 1]      # (k, n)
        est_warm = torch.sum(windows * w_sel[None], dim=-1)
        est = torch.cat([torch.where((p < n)[None, :], est_warm, est[:, :k]),
                         est[:, k:]], dim=1)
    else:
        est = u_ext[:, halo_len:] + delta[:, None]
    phase_seq = torch.where(valid[None, :], est, torch.zeros((), device=dev))

    # ---- correction / differential / slicing ----
    prev_last = _left_shift(sel[:, -1], "time")          # (C,)
    shifted = torch.cat([prev_last[:, None], sel[:, :-1]], dim=1)
    one = torch.ones((), dtype=sel.dtype, device=dev)
    prev = torch.where(gsym[None, :] >= 1, shifted, one)
    if cfg.differential:
        base = sel / prev
        correction = torch.zeros_like(phase_seq)
    else:
        base = sel
        correction = -phase_seq / m
    if m == 4:
        correction = correction + math.pi / 4
    phasor = torch.complex(torch.cos(correction), torch.sin(correction))
    soft = (base * phasor).to(torch.complex64)
    bits = slicers.slice_bits(m, soft)

    vmask = valid[None, :]
    zero = torch.zeros((), dtype=soft.dtype, device=dev)
    return (
        torch.where(vmask, soft, zero),
        torch.where(vmask[..., None], bits, torch.zeros_like(bits)),
        phase_seq,
        torch.where(vmask, sample_index, torch.zeros_like(sample_index)),
        vmask.expand(soft.shape),
    )


def _conv_valid(cat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched 'valid' correlation: out[c, o] = sum_i cat[c, o+i] * w[i]
    (no kernel flip; float32 on every device)."""
    return cat.unfold(-1, w.shape[0], 1) @ w


def make_sharded_demod(cfg: DemodConfig, mesh: Mesh, total_symbols: int):
    """Build the sharded batch demod: (C, T) complex64 -> DemodOutputs.

    T = total_symbols * cfg.sps; C divisible by the 'chan' axis and
    total_symbols by the 'time' axis.  The input may be a whole tensor or
    a :class:`~psk_soft_tpu_torch.parallel.mesh.Sharded` one; outputs
    follow it (see ``shard_map``).
    """
    n_time = mesh.shape["time"]
    if total_symbols % n_time:
        raise ValueError(f"{total_symbols} symbols not divisible by "
                         f"time={n_time}")
    s_loc = total_symbols // n_time
    min_syms = max(cfg.num_avg - 1, cfg.phase_avg - 1,
                   phase_ops.UNWRAP_TREND_LEN - 1,
                   -(-max(cfg.mf_ntaps - 1, 0) // cfg.sps))
    if n_time > 1 and s_loc < min_syms:
        raise ValueError(
            f"symbols per time shard ({s_loc}) must be >= {min_syms} "
            f"(max of num_avg-1, phase_avg-1, mf halo)")

    spec = P("chan", "time")
    inner = shard_map(functools.partial(_sharded_body, cfg, total_symbols),
                      mesh, in_specs=spec, out_specs=(spec,) * 5)

    def run(x):
        soft, bits, phase, sample_index, valid = inner(x)
        return DemodOutputs(soft=soft, bits=bits, phase=phase,
                            sample_index=sample_index, valid=valid)

    return run
