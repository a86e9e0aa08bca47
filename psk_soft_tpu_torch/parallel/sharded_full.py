"""Multi-shard flagship: kernel B1 sharded over the mesh (port of
``psk_soft_tpu/parallel/sharded_full.py:1-239``).

Two compositions of models/full.py's single-kernel pipeline:

* **Channel sharding** (:func:`make_sharded_full_demod`):
  communication-free -- each shard runs B1 on its channel slice with its
  own carry planes.
* **Time + channel sharding** (:func:`make_time_sharded_full_demod`): one
  stream's time axis is split across shards too (BASELINE.json config 5).
  Each shard runs B1 *statelessly* over [left warm-up halo | own | right
  lookahead halo] sample planes (two ``ppermute`` exchanges), discards the
  halo outputs, and the only cross-shard sequential quantity -- the
  absolute phase origin, a per-(shard, channel) multiple of 2pi -- is
  recovered afterwards from overlap outputs by an ``all_gather`` + prefix
  sum, then applied as a constellation-preserving derotation.  The
  stream's very first warm-up region (first shard's discard margin) is
  masked invalid: this path is the steady-streaming configuration; use
  parallel/sharded.py for exact head-of-stream warm-up semantics.

The Pallas tiling of the JAX factories (``s_tile``, the pad rows to a tile
multiple, ``s_tile >= A-1``) and ``interpret`` have no counterpart: the
port's B1 runs any block length, one launch a shard a call.  B1 takes any
channel count, so a shard holds any number of channels (JAX's "a multiple
of 128 per device" is Pallas's lane width).
"""

from __future__ import annotations

import functools

import torch

from ..config import DemodConfig
from ..models.full import FullOutputs, FullState, _static_taps, \
    demod_block_full
from ..ops import slicers
from ..ops.cuda import demod_kernel
from ..ops.phase import TWO_PI, UNWRAP_TREND_LEN
from .mesh import (P, Mesh, NamedSharding, all_gather, axis_index,
                   axis_size, ppermute, shard, shard_map)


def channel_sharding_tm(mesh: Mesh) -> NamedSharding:
    """Time-major planes (T, C): channels on the last axis, sharded."""
    return NamedSharding(mesh, P(None, "chan"))


def shard_full_state(state: FullState, mesh: Mesh) -> FullState:
    """The carry's planes split over the mesh's 'chan' axis."""
    sh = channel_sharding_tm(mesh)
    return FullState(win_re=shard(state.win_re, sh),
                     win_im=shard(state.win_im, sh),
                     planes=shard(state.planes, sh))


def make_sharded_full_demod(cfg: DemodConfig, mesh: Mesh, *,
                            in_scale: float = 1.0,
                            soft_i8_scale: float | None = None,
                            debug_ports: bool = True,
                            pack_out: bool | None = None):
    """Returns fn(state, x_re, x_im) -> (state, FullOutputs), with every
    (.., C) plane split over the mesh's 'chan' axis: one B1 launch a shard
    a call.  The chan axis is communication-free, so every kernel output
    profile (int8 soft, packed bits, debug planes off) shards through
    unchanged.  A state from :func:`shard_full_state` keeps the outputs
    sharded; whole tensors in give whole tensors out."""
    body = functools.partial(demod_block_full, cfg, in_scale=in_scale,
                             pack_out=pack_out, soft_i8_scale=soft_i8_scale,
                             debug_ports=debug_ports)
    spec = P(None, "chan")
    state_specs = FullState(win_re=spec, win_im=spec, planes=spec)
    dbg = spec if debug_ports else None   # None passes the None plane
    return shard_map(body, mesh, in_specs=(state_specs, spec, spec),
                     out_specs=(state_specs,
                                FullOutputs(spec, spec, dbg, spec, dbg)),
                     collectives=False)


def _shift_rows(v: torch.Tensor, from_left: bool) -> torch.Tensor:
    """ppermute along 'time': receive rows from the left (or right)
    neighbor; edge shards receive zeros."""
    n_sh = axis_size("time")
    if from_left:
        perm = [(i, i + 1) for i in range(n_sh - 1)]
    else:
        perm = [(i, i - 1) for i in range(1, n_sh)]
    return ppermute(v.contiguous(), "time", perm)


def _rows(v: torch.Tensor, count: int, last: bool) -> torch.Tensor:
    """The first (or last) ``count`` rows of v, zero-padded on the far
    side when v holds fewer (a lone time shard's halo is all zeros)."""
    if v.shape[0] >= count:
        return v[v.shape[0] - count:] if last else v[:count]
    pad = torch.zeros((count - v.shape[0],) + tuple(v.shape[1:]),
                      dtype=v.dtype, device=v.device)
    return torch.cat([pad, v] if last else [v, pad])


def make_time_sharded_full_demod(cfg: DemodConfig, mesh: Mesh,
                                 total_symbols: int, *, mixed_params=None,
                                 in_scale: float = 1.0,
                                 soft_i8_scale: float | None = None):
    """Time+channel-sharded single-kernel demod (see module docstring).

    Returns fn(x_re, x_im) -> (soft_re, soft_im, phase, bits, idx, valid)
    with (T, C) inputs split P('time', 'chan') and (S, C) outputs likewise;
    bits are packed int32 codes.  The first ``discard`` symbols of the
    stream and the final numAvg-1 are masked invalid.  With
    ``soft_i8_scale`` the soft planes come back int8, quantized after the
    seam correction.  int16 planes run B1's int16 ingest (``in_scale``).

    Every kernel profile runs: matched filter (the streaming FIR's filtered
    timeline lags raw by ``ntaps-1`` samples, so the extra rows extend the
    *left* halo and the FF symbol grid is preserved), fractional
    circular-centroid timing, and per-channel mixed mode.  For mixed mode
    pass ``mixed_params`` (models/mixed.MixedParams with (C,) arrays); the
    static cfg constellation/differential are then ignored, as in
    models/full.make_mixed_full_demod_fn.
    """
    sps, num_avg, m, n = (cfg.sps, cfg.num_avg, cfg.constellation_size,
                          cfg.phase_avg)
    if sps <= 1:
        raise ValueError("time-sharded full kernel supports sps > 1 only")
    taps = _static_taps(cfg)
    extra = (len(taps) - 1) if taps else 0
    mixed = mixed_params is not None
    n_time = mesh.shape["time"]
    s_loc = total_symbols // n_time
    if total_symbols % n_time:
        raise ValueError(f"{total_symbols} symbols not divisible by "
                         f"time={n_time}")
    a1 = num_avg - 1
    discard = n + UNWRAP_TREND_LEN + 8        # phase warm-up margin
    rh = a1 * sps                             # window lookahead halo
    # Left halo = warm-up margin + window + the FIR's (ntaps-1) raw tail; a
    # single ppermute only reaches the immediate neighbour, so each shard
    # must own at least the halo it sends.
    lh = (a1 + discard) * sps + extra
    if n_time > 1 and s_loc * sps < max(lh, rh):
        raise ValueError(f"samples per time shard ({s_loc * sps}) must be "
                         f">= {max(lh, rh)}")
    rs = demod_kernel.state_rows(n)
    wsplit = a1 * sps + extra                 # kernel window-carry rows
    if mixed:
        misc = (n - 1) + 2 * (UNWRAP_TREND_LEN - 1)
        m_arr = torch.as_tensor(mixed_params.m).to("cpu", torch.float32)
        d_arr = torch.as_tensor(mixed_params.diff).to("cpu", torch.float32)

    def body(x_re, x_im, *mode_planes):       # (T_loc, C_loc) each
        c_loc = x_re.shape[1]
        dev = x_re.device

        def assemble(v):
            left = _shift_rows(_rows(v, lh, last=True), from_left=True)
            right = _shift_rows(_rows(v, rh, last=False), from_left=False)
            return torch.cat([left, v, right])

        ext_re = assemble(x_re)
        ext_im = assemble(x_im)
        planes0 = torch.zeros((rs, c_loc), dtype=torch.float32, device=dev)
        if mixed:
            planes0[misc + 6] = mode_planes[0]
            planes0[misc + 7] = mode_planes[1]
        # pack_out=False: the seam correction below re-slices bits, so keep
        # one int32 contract across the differential/mixed/plain branches.
        soft_re, soft_im, phase, bits, idx, _ = demod_kernel.demod_full_tm(
            ext_re[:wsplit], ext_im[:wsplit], ext_re[wsplit:],
            ext_im[wsplit:], planes0, sps=sps, num_avg=num_avg, phase_avg=n,
            m=m, diff=cfg.differential, mf_taps=taps,
            timing_interp=cfg.timing_interp, mixed=mixed, in_scale=in_scale,
            pack_out=False)

        # --- recover the absolute phase origin per shard (multiple of
        # 2pi, relative to shard 0) from overlap outputs ---
        # Kernel output row o corresponds to ext symbol o (the window's
        # OLDEST symbol), so own outputs occupy rows [a1+discard,
        # a1+discard+s_loc).
        own0 = a1 + discard
        t_idx = axis_index("time")
        seam = torch.stack([phase[own0 + s_loc - 1],     # own last
                            phase[own0 - 1]])            # left's last
        gathered = all_gather(seam, "time")              # (K, 2, C_loc)
        c_seam = TWO_PI * torch.round(
            (gathered[:-1, 0] - gathered[1:, 1]) / TWO_PI)   # (K-1, C)
        delta_all = torch.cat(
            [torch.zeros((1, c_loc), dtype=torch.float32, device=dev),
             torch.cumsum(c_seam, dim=0)])
        delta = delta_all[t_idx]                         # (C_loc,)

        # own region, origin-corrected
        sl = slice(own0, own0 + s_loc)
        soft = torch.complex(soft_re[sl], soft_im[sl])
        phase_own = phase[sl] + delta[None, :]
        if mixed:
            # Per channel: rotate + re-slice non-differential lanes, keep
            # the kernel's packed bits on differential lanes.
            rot = -delta / mode_planes[0]
            rot_soft = soft * torch.complex(torch.cos(rot),
                                            torch.sin(rot))[None, :]
            is_diff = mode_planes[1] > 0.5
            soft = torch.where(is_diff[None, :], soft, rot_soft)
            m_int = mode_planes[0].to(torch.int32)
            resliced = slicers.slice_code_dynamic(m_int[:, None], soft.T).T
            packed = torch.where(is_diff[None, :], bits[sl],
                                 resliced.to(torch.int32))
        elif not cfg.differential:
            rot = -delta / float(m)
            soft = soft * torch.complex(torch.cos(rot),
                                        torch.sin(rot))[None, :]
            # bits follow the corrected constellation
            packed = slicers.slice_code(m, soft.T).T.to(torch.int32)
        else:
            packed = bits[sl]
        gsym = t_idx * s_loc + torch.arange(s_loc, dtype=torch.int32,
                                            device=dev)
        valid = (gsym >= discard) & (gsym < total_symbols - a1)
        s_re, s_im = soft.real, soft.imag
        if soft_i8_scale is not None:
            # Quantized after the seam correction: the phase-origin
            # recovery needs the full-precision phase plane and a float
            # soft rotation, so int8 cannot ride B1's own epilogue here.
            s = float(soft_i8_scale)
            s_re = torch.clamp(torch.round(s_re * s), -127, 127).to(
                torch.int8)
            s_im = torch.clamp(torch.round(s_im * s), -127, 127).to(
                torch.int8)
        return (s_re.contiguous(), s_im.contiguous(), phase_own,
                packed.contiguous(), idx[sl],
                valid[:, None].expand(s_loc, c_loc))

    spec = P("time", "chan")
    mode_spec = (P("chan"), P("chan")) if mixed else ()
    inner = shard_map(body, mesh, in_specs=(spec, spec) + mode_spec,
                      out_specs=(spec,) * 6)
    if mixed:
        return lambda x_re, x_im: inner(x_re, x_im, m_arr, d_arr)
    return inner
