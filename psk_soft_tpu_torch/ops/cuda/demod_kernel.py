"""Kernel B1: the fused steady-state demod, hand-written CUDA for Hopper
(port of ``psk_soft_tpu/ops/pallas/demod_kernel.py:41-835``).

Three pieces, as for every kernel of the port:

* ``csrc/demod_full.cu``: the CUDA C++ kernels (its header note says
  what bounds them on an H100), built with nvcc for sm_90a into
  ``build/psk_soft_tpu_torch/`` at first use and loaded with ctypes.  One
  wrapper call launches two kernels: stage A (timing and the raw phase,
  one block per group of channels, kernel B5's block loop) and
  stage B (trend, unwrap scan, FIR, derotation, slicing, carry; one block
  per group of channels walking the block in chunks of symbols); with a
  matched filter a third, stage 0, filters the raw rows into scratch
  first.  :func:`launch_plan` sizes them in Python (stage 0 by
  :func:`fir_plan`); :func:`matched_filter_tm` launches stage 0 alone.
* :func:`demod_full_tm_ref`: the same function in plain PyTorch, on any
  device.  It follows the kernel's stages (9-tap trend on every symbol,
  prefix unwrap, endpoint FIR), not blockpsk's strided unwrap.
* :func:`demod_full_tm`: the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernels, and a failed build, load or
  launch raises.  ``demod_full_tm.launches`` counts wrapper calls that
  launched them, ``demod_full_tm.mode_launches`` those of each mode.

Every static mode of the Pallas kernel is served: int16 ingest
(``in_scale``), ``timing_interp``, an in-kernel matched filter
(``mf_taps``) and ``mixed`` per-channel modes, alone or together.  The
TPU-only knobs (``s_tile``, ``double_buffer``, ``win_offset``,
``interpret``) have no counterpart.

The carry plane keeps the Pallas layout (:func:`state_rows`), so
``models/full.full_from_ff`` and the tests compare planes directly.  One
named divergence from the Pallas kernel: the M*2pi re-wrap of the phase
history happens once per block (the Pallas kernel does it at the end of
every TPU time tile), from the last unwrapped phase.  Soft decisions and
bits are unchanged by it; the phase port and the carry's phase rows can
differ by whole multiples of M*2pi where the Pallas kernel re-wrapped
mid-block.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from ...ops.linear_fit import endpoint_fir_weights
from ...ops.phase import TWO_PI, UNWRAP_TREND_LEN
from ...utils.build import REPO_ROOT, build_shared, count_launch, load_once

CSRC = REPO_ROOT / "psk_soft_tpu_torch" / "csrc"
SOURCE = CSRC / "demod_full.cu"
TIMING_HEADER = CSRC / "timing.cuh"     # shared with kernel B5
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Constants of csrc/timing.cuh and csrc/demod_full.cu that the launch plans
# need (chip_smoke.py holds the plans' shared memory against the libraries'
# own counts).
TIMING_THREADS = 512           # timing loops (B1 stage A, B5): threads
TIMING_MAX_GROUP = 8           # ... channels a block (a 32-byte sector)
TIMING_MAX_CHUNK = 64          # ... symbols a staged chunk, at most
TIMING_STAGE_BYTES = 80 * 1024  # ... bytes a staged chunk, at most
TIMING_MAX_SMEM = 232448       # ... shared memory a block (an H100's)
TRACK_GROUP = 8                # stage B: channels per block
TRACK_MAX_CHUNK = 64           # stage B: symbols per chunk
FIR_CHANNELS = 32              # stage 0 (matched filter): channels a block
FIR_ROWS_PER_THREAD = 16       # ... outputs a thread (R)
FIR_TAP_GROUP = 8              # ... taps a group (G)
FIR_ROW_THREADS = (8, 4, 2, 1)  # ... threads a channel, in preference
FIR_MAX_SMEM = TIMING_MAX_SMEM  # ... shared memory a block
FIR_SM_SMEM = 233472           # ... shared memory an SM (an H100's)
FIR_SMS = 132                  # ... SMs (an H100's)
FIR_BLOCKS_PER_SM = 2          # ... blocks an SM holds (launch bounds)
TREND_HIST = UNWRAP_TREND_LEN - 1


def state_rows(phase_avg: int, k: int = UNWRAP_TREND_LEN) -> int:
    """Rows of the carry plane: u_hist | c_re hist | c_im hist | misc(8),
    padded up to a multiple of 8 (the Pallas layout, kept for parity).
    misc = [ang_prev, unwrap_acc, last_any_re, last_any_im, interp_re,
    interp_im, mixed_m, mixed_diff]: rows 4-5 take the block's last sample
    under timing_interp (within a call only, as in the Pallas kernel),
    rows 6-7 hold a mixed bank's per-channel M and differential flag
    (written by models/full.full_from_ff, carried through)."""
    raw = (phase_avg - 1) + 2 * (k - 1) + 8
    return -(-raw // 8) * 8


class TimingPlan(NamedTuple):
    """How the timing loops of csrc/timing.cuh (kernel B5, and B1's stage
    A) are launched: one block per group of channels over the whole block
    of symbols.  The kernels check it (``timing_plan_error``)."""
    group: int                  # channels a block
    chunk: int                  # symbols a staged chunk (double-buffered)
    vec: int                    # bytes a staging copy moves: 16, 8, 4, 2
    smem: int                   # dynamic shared memory a block, bytes
    grid: int                   # blocks
    threads: int                # threads a block


@functools.lru_cache(maxsize=256)
def timing_plan(channels: int, sps: int, align: int = 16, esize: int = 4,
                interp: bool = False) -> TimingPlan:
    """Plan of the timing loops for ``channels`` channels at ``sps``, the
    planes' addresses multiples of ``align`` bytes, ``esize``-byte samples
    (4: float32, 2: int16), one more staged leaving symbol with ``interp``.
    The group is 8 channels (one 32-byte sector of each float32 row)
    unless one staged symbol would not fit TIMING_STAGE_BYTES, then 4, 2,
    1; the chunk as many symbols (up to TIMING_MAX_CHUNK; fewer chunks mean
    fewer barriers) as fit, and the block within TIMING_MAX_SMEM where it
    can be; copies of 16 bytes where the group, the row stride and the
    addresses allow it, else 8, else 4, else (int16) 2."""
    extra = int(bool(interp))

    def stage(group, chunk):     # re and im, chunk + (chunk + 1 + extra)
        return 2 * esize * sps * group * (2 * chunk + 1 + extra)

    group = next((g for g in (8, 4, 2) if stage(g, 1) <= TIMING_STAGE_BYTES),
                 1)
    chunk = max(1, min(TIMING_MAX_CHUNK,
                       (TIMING_STAGE_BYTES // (2 * esize * sps * group)
                        - 1 - extra) // 2))
    vec = next(v for v in (16, 8, 4, 2)
               if (esize * group) % v == 0 and (esize * channels) % v == 0
               and align % v == 0 and (v >= 4 or esize == 2))
    pairs = sps * group

    def smem(chunk):                  # csrc/timing.cuh, timing_smem_bytes
        parts = max(1, min(chunk, TIMING_THREADS // pairs))
        staged = -(-2 * stage(group, chunk) // 16) * 16
        return staged + 4 * (chunk * (pairs + group) + chunk * pairs
                             + 2 * parts * pairs + 4 * pairs)

    while chunk > 1 and smem(chunk) > TIMING_MAX_SMEM:
        chunk -= 1
    return TimingPlan(group, chunk, vec, smem(chunk), -(-channels // group),
                      TIMING_THREADS)


def plane_align(*planes) -> int:
    """The largest power of two (at most 16) dividing the byte addresses of
    the non-empty ``planes``: what the timing loops' copies may assume."""
    align = 16
    for t in planes:
        if t.numel():
            ptr = t.data_ptr()
            align = min(align, ptr & -ptr)
    return align


class FirPlan(NamedTuple):
    """How stage 0 (the matched filter, csrc/demod_full.cu
    ``demod_fir_kernel``) is launched: blocks of 32 channels x a run of
    rows, walked in tiles of ``rows_per_thread * row_threads`` rows, two
    staging buffers when a run holds more than one tile.  The kernel checks
    it (``fir_plan_error``)."""
    rows_per_thread: int        # outputs a thread (R)
    tap_group: int              # taps unrolled together (G)
    row_threads: int            # threads a channel
    tile: int                   # filtered rows a tile
    run_rows: int               # filtered rows a block walks
    runs: int                   # runs a strip of 32 channels (grid x)
    strips: int                 # strips (grid y)
    stages: int                 # staging buffers (1: one tile a run)
    vec: int                    # bytes a staging copy moves: 16, 8, 4, 2
    smem: int                   # dynamic shared memory a block, bytes
    threads: int                # threads a block


def _fir_smem(ntaps: int, tile: int, stages: int, esize: int) -> int:
    """csrc/demod_full.cu, fir_smem_bytes: the taps (whole float4s), then
    ``stages`` buffers of tile + ntaps - 1 raw rows of 32 channels, re and
    im."""
    return (4 * (-(-ntaps // 4) * 4)
            + stages * 2 * (tile + ntaps - 1) * FIR_CHANNELS * esize)


@functools.lru_cache(maxsize=256)
def fir_plan(channels: int, rows_f: int, ntaps: int, esize: int = 4,
             align: int = 16) -> FirPlan:
    """Plan of stage 0 for ``rows_f`` filtered rows of ``channels``
    channels (``rows_f + ntaps - 1`` raw rows of ``esize``-byte samples,
    4 float32 or 2 int16, at addresses that are multiples of ``align``
    bytes).  The widest tile (8 threads a channel, 128 rows) whose two
    staging buffers fit FIR_MAX_SMEM, else the narrowest that does; runs
    of whole tiles, as many a strip as fill the SMs once (FIR_SMS x the
    blocks an SM holds); one tile a run, and one buffer, where two do not
    fit at any width.  Copies of 16 bytes where the row stride and the
    addresses allow it, else 8, else 4, else (int16) 2.  Raises ValueError
    where one buffer of the narrowest tile does not fit."""
    if channels < 1 or rows_f < 1 or ntaps < 1 or esize not in (2, 4):
        raise ValueError(f"stage 0 needs channels, rows and taps >= 1 and "
                         f"2- or 4-byte samples, got {channels}, {rows_f}, "
                         f"{ntaps}, {esize}")
    vec = next(v for v in (16, 8, 4, 2)
               if (esize * channels) % v == 0 and align % v == 0
               and v >= esize)
    two = [rt for rt in FIR_ROW_THREADS
           if _fir_smem(ntaps, FIR_ROWS_PER_THREAD * rt, 2, esize)
           <= FIR_MAX_SMEM]
    one = [rt for rt in FIR_ROW_THREADS
           if _fir_smem(ntaps, FIR_ROWS_PER_THREAD * rt, 1, esize)
           <= FIR_MAX_SMEM]
    if not one:
        raise ValueError(
            f"a matched filter of {ntaps} taps needs "
            f"{_fir_smem(ntaps, FIR_ROWS_PER_THREAD, 1, esize)} bytes of "
            f"shared memory per block, more than {FIR_MAX_SMEM}")
    rt = (two or one)[0]
    tile = FIR_ROWS_PER_THREAD * rt
    strips = -(-channels // FIR_CHANNELS)
    tiles = -(-rows_f // tile)
    per_run = 1
    if two:
        held = min(FIR_BLOCKS_PER_SM,
                   FIR_SM_SMEM // (_fir_smem(ntaps, tile, 2, esize) + 1024))
        runs = max(1, min(tiles, FIR_SMS * held // strips))
        per_run = -(-tiles // runs)
    stages = 2 if per_run > 1 else 1
    run_rows = per_run * tile
    return FirPlan(FIR_ROWS_PER_THREAD, FIR_TAP_GROUP, rt, tile, run_rows,
                   -(-rows_f // run_rows), strips, stages, vec,
                   _fir_smem(ntaps, tile, stages, esize), FIR_CHANNELS * rt)


class LaunchPlan(NamedTuple):
    """How one wrapper call launches B1's stages (csrc/demod_full.cu).
    Grids and blocks are CUDA x sizes; shared memory is bytes per block;
    scratch maps each buffer the wrapper allocates to its shape."""
    timing: TimingPlan          # stage A
    chunk: int                  # stage B: symbols per chunk
    group: int                  # stage B: channels per block
    track_grid: int
    track_block: int
    track_smem: int
    scratch: dict
    fir: FirPlan | None = None  # stage 0 (matched filter only)


@functools.lru_cache(maxsize=256)
def launch_plan(C: int, S: int, sps: int, phase_avg: int,
                align: int = 16, esize: int = 4, interp: bool = False,
                ntaps: int = 0, mf_rows: int = 0,
                raw_align: int = 16) -> LaunchPlan:
    """Pure-Python launch plan of :func:`demod_full_tm` for C channels,
    S symbols, the planes stage A reads at addresses that are multiples of
    ``align`` bytes, of ``esize``-byte samples, ``interp`` for
    timing_interp; with a matched filter of ``ntaps`` taps, stage 0
    (:func:`fir_plan` over the raw planes, at addresses that are multiples
    of ``raw_align``) and its (2, mf_rows, C) float32 scratch of filtered
    rows (stage A then reads float32).  The same sizes as the kernels' own
    (``psk_demod_full_smem`` in csrc/demod_full.cu)."""
    per_warp = 32 // TRACK_GROUP
    chunk = min(TRACK_MAX_CHUNK, -(-S // per_warp) * per_warp)
    n1 = phase_avg - 1
    buffer = ((n1 + chunk) + 2 * (TREND_HIST + chunk)
              + 3 * (1 + chunk)) * TRACK_GROUP
    track_smem = 4 * (2 * buffer + n1 + 1 + chunk // per_warp * TRACK_GROUP
                      + 3 * TRACK_GROUP)
    scratch = {"sel_re": (S, C), "sel_im": (S, C), "raw": (S, C),
               "first_bad": (2, sps, C)}
    fir = None
    if ntaps:
        scratch["filt"] = (2, mf_rows, C)
        fir = fir_plan(C, mf_rows, ntaps, esize, raw_align)
    return LaunchPlan(
        timing=timing_plan(C, sps, align, 4 if ntaps else esize, interp),
        chunk=chunk, group=TRACK_GROUP,
        track_grid=-(-C // TRACK_GROUP), track_block=chunk * TRACK_GROUP,
        track_smem=track_smem, scratch=scratch, fir=fir)


def _check_args(win_re, win_im, x_re, x_im, state_planes, *, sps, num_avg,
                phase_avg, m, pack_out, mf_taps, timing_interp, mixed,
                in_scale):
    """Validate everything both versions take; raise on anything else.
    Returns (pack_out, int16 planes, taps as a float tuple or None)."""
    k = UNWRAP_TREND_LEN
    if phase_avg < k + 1:
        raise ValueError(f"full kernel requires phase_avg >= {k + 1}")
    if num_avg < 2:
        raise ValueError("full kernel requires num_avg >= 2")
    if sps < 2:
        raise ValueError("full kernel supports sps > 1")
    if m not in (2, 4, 8, 16, 32):
        raise ValueError(f"unsupported constellation size {m}")
    planes = (win_re, win_im, x_re, x_im)
    i16 = x_re.dtype == torch.int16
    if i16 and win_re.dtype != torch.int16:
        raise ValueError("int16 ingest needs int16 window carry planes "
                         "(quantize with models.full.quantize_full_state)")
    pdt = torch.int16 if i16 else torch.float32
    if any(t.dtype != pdt for t in planes) \
            or state_planes.dtype != torch.float32:
        raise ValueError("planes must be all float32 or all int16 (int16 "
                         "ingest), and state float32")
    if i16 and not np.isfinite(in_scale):
        raise ValueError(f"in_scale must be finite, got {in_scale}")
    planes += (state_planes,)
    if any(t.ndim != 2 for t in planes):
        raise ValueError("planes and state must be 2-D (rows, C)")
    if any(t.device != x_re.device for t in planes):
        raise ValueError("planes and state must be on one device")
    taps = None
    if mf_taps is not None:
        taps = tuple(float(t) for t in mf_taps)
        if not taps:
            raise ValueError("mf_taps must hold at least one tap")
    T, C = x_re.shape
    if x_im.shape != (T, C) or T == 0 or T % sps:
        raise ValueError(f"x planes must be (S*sps, C) with S >= 1, got "
                         f"{tuple(x_re.shape)} / {tuple(x_im.shape)}")
    wrows = (num_avg - 1) * sps + (len(taps) - 1 if taps else 0)
    if win_re.shape != (wrows, C) or win_im.shape != (wrows, C):
        raise ValueError(f"win planes must be {(wrows, C)}")
    rs = state_rows(phase_avg)
    if state_planes.shape != (rs, C):
        raise ValueError(f"state_planes must be {(rs, C)}, got "
                         f"{tuple(state_planes.shape)}")
    if pack_out is None:
        pack_out = sps <= 128
    elif pack_out and sps > 128:
        raise ValueError(f"pack_out requires sps <= 128 (int8 index range),"
                         f" got sps={sps}")
    return pack_out, i16, taps


def _alloc_outputs(S, C, device, pack_out, soft_i8_scale, debug_ports):
    sdt = torch.float32 if soft_i8_scale is None else torch.int8
    odt = torch.int8 if pack_out else torch.int32
    soft_re = torch.empty((S, C), dtype=sdt, device=device)
    soft_im = torch.empty((S, C), dtype=sdt, device=device)
    bits = torch.empty((S, C), dtype=odt, device=device)
    phase = idx = None
    if debug_ports:
        phase = torch.empty((S, C), dtype=torch.float32, device=device)
        idx = torch.empty((S, C), dtype=odt, device=device)
    return soft_re, soft_im, phase, bits, idx


def demod_full_tm_ref(win_re, win_im, x_re, x_im, state_planes, *, sps: int,
                      num_avg: int, phase_avg: int, m: int, diff: bool,
                      pack_out: bool | None = None,
                      soft_i8_scale: float | None = None,
                      debug_ports: bool = True, mf_taps=None,
                      timing_interp: bool = False, mixed: bool = False,
                      in_scale: float = 1.0):
    """Plain-PyTorch version of :func:`demod_full_tm` (same arguments and
    outputs), whole-block tensor ops on any device."""
    pack_out, i16, taps = _check_args(
        win_re, win_im, x_re, x_im, state_planes, sps=sps, num_avg=num_avg,
        phase_avg=phase_avg, m=m, pack_out=pack_out, mf_taps=mf_taps,
        timing_interp=timing_interp, mixed=mixed, in_scale=in_scale)
    dev = x_re.device
    T, C = x_re.shape
    S = T // sps
    k = UNWRAP_TREND_LEN
    k1 = k - 1
    n1 = phase_avg - 1
    misc = n1 + 2 * k1
    st = state_planes

    # int16 ingest: dequantize with one float32 multiply per sample.
    deq = ((lambda t: t.to(torch.float32) * in_scale) if i16  # noqa: E731
           else (lambda t: t))
    re = torch.cat([deq(win_re), deq(x_re)])
    im = torch.cat([deq(win_im), deq(x_im)])
    if taps is not None:
        # Matched filter on the raw [window | block] rows, the
        # ops/matched_filter.apply_fir convention f[r] = sum_j taps[j] *
        # raw[r + j]; the rest runs on the (A-1)*sps + T filtered rows.
        re, im = _fir(re, taps), _fir(im, taps)

    # C2 timing: windowed bin energies (cumsum-diff).
    e = (re * re + im * im).reshape(S + num_avg - 1, sps, C)
    cs = torch.cumsum(e, dim=0)
    lower = torch.cat([torch.zeros_like(cs[:1]), cs[:S - 1]])
    w = cs[num_avg - 1:] - lower                              # (S, sps, C)
    if timing_interp:
        b, sel_re, sel_im = _interp_pick(re, im, w, sps)
    else:
        b = torch.argmax(w, dim=1)                            # first max
        gather = lambda v: torch.gather(                      # noqa: E731
            v[:S * sps].reshape(S, sps, C), 1, b.unsqueeze(1)).squeeze(1)
        sel_re, sel_im = gather(re), gather(im)

    # C3: M-th power phase (per channel when mixed: rows misc+6, misc+7).
    if mixed:
        mvec, dvec = st[misc + 6], st[misc + 7]
        zr, zi = sel_re, sel_im
        pick_r = pick_i = None
        for pw in (2, 4, 8, 16, 32):
            zr, zi = zr * zr - zi * zi, 2.0 * zr * zi
            if pick_r is None:
                pick_r, pick_i = zr, zi
            else:
                here = mvec == pw
                pick_r = torch.where(here, zr, pick_r)
                pick_i = torch.where(here, zi, pick_i)
        # Anything but 2, 4, 8 and 16 takes the 32nd power, as in Pallas.
        other = (mvec != 2) & (mvec != 4) & (mvec != 8) & (mvec != 16)
        zr = torch.where(other, zr, pick_r)
        zi = torch.where(other, zi, pick_i)
    else:
        zr, zi = sel_re, sel_im
        for _ in range(m.bit_length() - 1):
            zr, zi = zr * zr - zi * zi, 2.0 * zr * zi
    raw = torch.atan2(zi, zr)

    # Trend MA over the last k raw phases, prefix unwrap, residual.
    ext_cre = torch.cat([st[n1:n1 + k1], torch.cos(raw)])
    ext_cim = torch.cat([st[n1 + k1:n1 + 2 * k1], torch.sin(raw)])
    t_re = ext_cre.unfold(0, k, 1).sum(-1)
    t_im = ext_cim.unfold(0, k, 1).sum(-1)
    ang_t = torch.atan2(t_im, t_re)
    ang_shift = torch.cat([st[misc:misc + 1], ang_t[:-1]])
    cum = torch.cumsum(torch.round((ang_t - ang_shift) / TWO_PI), dim=0)
    acc = st[misc + 1]
    t_unw = ang_t + acc - TWO_PI * cum
    resid = raw - ang_t
    u = t_unw + (resid - TWO_PI * torch.round(resid / TWO_PI))

    # C1: endpoint-fit FIR over [u history | u].
    ext_u = torch.cat([st[:n1], u])
    est = ext_u.unfold(0, phase_avg, 1) @ _fir_weights(phase_avg, dev)

    # C5: derotation or differential decode (per channel when mixed).
    pr = torch.cat([st[misc + 2:misc + 3], sel_re[:-1]])
    pi_ = torch.cat([st[misc + 3:misc + 4], sel_im[:-1]])
    pp = pr * pr + pi_ * pi_
    inv = 1.0 / torch.where(pp == 0, torch.ones_like(pp), pp)
    dif_r = (sel_re * pr + sel_im * pi_) * inv
    dif_i = (sel_im * pr - sel_re * pi_) * inv
    if mixed:
        dsel = dvec > 0.5
        base_r = torch.where(dsel, dif_r, sel_re)
        base_i = torch.where(dsel, dif_i, sel_im)
        corr = torch.where(dsel, torch.zeros_like(est), -est / mvec)
        corr = torch.where(mvec == 4, corr + 0.7853981633974483, corr)
    elif diff:
        base_r, base_i = dif_r, dif_i
        corr = torch.zeros_like(est)
    else:
        base_r, base_i = sel_re, sel_im
        corr = -est / float(m)
    if not mixed and m == 4:
        corr = corr + 0.7853981633974483
    cph_r, cph_i = torch.cos(corr), torch.sin(corr)
    s_r = base_r * cph_r - base_i * cph_i
    s_i = base_r * cph_i + base_i * cph_r

    # C6: slicing, packed LSB-first.
    sgn_r = (s_r < 0).to(torch.int32)
    sgn_i = (s_i < 0).to(torch.int32)
    code4 = (sgn_r ^ sgn_i) + 2 * sgn_i
    if mixed:
        ss = torch.atan2(s_i, s_r) * (mvec * (0.5 / math.pi))
        ss = torch.where(ss < -0.5, ss + mvec, ss)
        # A NaN soft value slices to 0, as the kernel and XLA convert it.
        codem = torch.floor(torch.nan_to_num(ss + 0.5, nan=0.0)).to(
            torch.int32)
        mi = mvec.to(torch.int32)
        codem = torch.where(codem >= mi, codem - mi, codem)
        code = torch.where(mvec == 2, sgn_r,
                           torch.where(mvec == 4, code4, codem))
    elif m == 2:
        code = sgn_r
    elif m == 4:
        code = code4
    else:
        ss = torch.atan2(s_i, s_r) * (m / TWO_PI)
        ss = torch.where(ss < -0.5, ss + float(m), ss)
        code = torch.floor(ss + 0.5).to(torch.int32) & (m - 1)

    o_sre, o_sim, o_phase, o_bits, o_idx = _alloc_outputs(
        S, C, dev, pack_out, soft_i8_scale, debug_ports)
    if soft_i8_scale is None:
        o_sre.copy_(s_r)
        o_sim.copy_(s_i)
    else:
        o_sre.copy_(torch.clamp(torch.round(s_r * soft_i8_scale), -127, 127))
        o_sim.copy_(torch.clamp(torch.round(s_i * soft_i8_scale), -127, 127))
    o_bits.copy_(code)
    if debug_ports:
        o_phase.copy_(est)
        o_idx.copy_(b)

    # Carry update with the end-of-block M*2pi re-wrap (from u_last).
    wrapv = TWO_PI * mvec if mixed else TWO_PI * m
    u_last = u[S - 1]
    off = torch.where(u_last.abs() > wrapv,
                      torch.round(u_last / wrapv) * wrapv,
                      torch.zeros_like(u_last))
    new = st.clone()
    new[:n1] = ext_u[S:] - off
    new[n1:n1 + k1] = ext_cre[S:]
    new[n1 + k1:n1 + 2 * k1] = ext_cim[S:]
    new[misc] = ang_t[S - 1]
    new[misc + 1] = acc - TWO_PI * cum[S - 1] - off
    new[misc + 2] = sel_re[S - 1]
    new[misc + 3] = sel_im[S - 1]
    if timing_interp:                 # row S-1's last sample
        new[misc + 4] = re[S * sps - 1]
        new[misc + 5] = im[S * sps - 1]
    return o_sre, o_sim, o_phase, o_bits, o_idx, new


def _interp_pick(re, im, w, sps: int):
    """timing_interp's pick over the (S, sps, C) window sums ``w`` of the
    [window | block] stream ``re``/``im`` (the Pallas ``_frontend_interp``
    on the whole block): the circular centroid p of the bin energies in
    [-0.5, sps - 0.5), bin round(p) % sps, the sample interpolated between
    stream samples o*sps + floor(p) and the next (row o-1's last, row o+1's
    first at the edges) with frac = p - floor(p).  Output 0 of the call has
    no sample before it: floor(p) < 0 there takes frac 0 and its own first
    sample.  A NaN p (a poisoned window) takes bin 0 and sample 0 with frac
    NaN.  Returns (bin, sel_re, sel_im)."""
    S, _, C = w.shape
    cos_t, sin_t = _interp_table(sps, w.device)[:, :, None]
    zr = (w * cos_t).sum(1)
    zi = (w * sin_t).sum(1)
    p = torch.atan2(zi, zr) * (sps / TWO_PI)
    p = torch.where(p < -0.5, p + sps, p)
    p = torch.where(p > sps - 0.5, p - sps, p)
    nan = torch.isnan(p)
    zero = torch.zeros_like(p)
    b = torch.where(nan, zero, torch.round(p)).to(torch.int64) % sps
    i0f = torch.floor(p)
    frac = p - i0f
    head = i0f[0] < 0
    i0f[0] = torch.where(head, zero[0], i0f[0])
    frac[0] = torch.where(head, zero[0], frac[0])
    i0 = torch.where(nan, zero, i0f).to(torch.int64)
    at = torch.arange(S, device=w.device).unsqueeze(1) * sps + i0
    w1 = 1.0 - frac

    def lerp(v):
        return (torch.gather(v, 0, at) * w1
                + torch.gather(v, 0, at + 1) * frac)

    return b, lerp(re), lerp(im)


@functools.lru_cache(maxsize=None)
def _interp_table(sps: int, device: torch.device) -> torch.Tensor:
    """(2, sps) float32 cos and sin of bin j's angle j * (2pi/sps) (the
    angle rounded to float32 as the Pallas kernel forms it), on
    ``device``."""
    ang = np.arange(sps, dtype=np.float32) * np.float32(TWO_PI / sps)
    tab = np.stack([np.cos(ang.astype(np.float64)),
                    np.sin(ang.astype(np.float64))]).astype(np.float32)
    return torch.as_tensor(tab, device=device)


def _fir(v: torch.Tensor, taps: tuple) -> torch.Tensor:
    """'valid' FIR down the rows of (R + L - 1, C) ``v``: f[r] = sum_j
    taps[j] * v[r + j], summed in tap order (the kernel's order)."""
    w_t = _taps_on(taps, v.device)
    rows = v.shape[0] - len(taps) + 1
    out = w_t[0] * v[:rows]
    for j in range(1, len(taps)):
        out = out + w_t[j] * v[j:j + rows]
    return out


def _check_fir_args(raw_re, raw_im, taps, in_scale):
    """Validate what both versions of the matched filter take; raise on
    anything else.  Returns (taps as a float tuple, int16 planes)."""
    taps = tuple(float(t) for t in taps)
    if not taps:
        raise ValueError("taps must hold at least one tap")
    i16 = raw_re.dtype == torch.int16
    if raw_re.dtype not in (torch.float32, torch.int16) \
            or raw_im.dtype != raw_re.dtype:
        raise ValueError("raw planes must be both float32 or both int16")
    if i16 and not np.isfinite(in_scale):
        raise ValueError(f"in_scale must be finite, got {in_scale}")
    if raw_re.ndim != 2 or raw_im.shape != raw_re.shape \
            or raw_re.shape[0] < len(taps) or raw_re.shape[1] < 1:
        raise ValueError(f"raw planes must be (rows, C) alike with rows >= "
                         f"{len(taps)} (the taps) and C >= 1, got "
                         f"{tuple(raw_re.shape)} / {tuple(raw_im.shape)}")
    if raw_im.device != raw_re.device:
        raise ValueError("raw planes must be on one device")
    return taps, i16


def matched_filter_tm_ref(raw_re, raw_im, taps, *, in_scale: float = 1.0):
    """Plain-PyTorch version of :func:`matched_filter_tm` (same arguments
    and outputs) on any device: int16 dequantized with one float32
    multiply a sample, then :func:`_fir` on each plane."""
    taps, i16 = _check_fir_args(raw_re, raw_im, taps, in_scale)
    if i16:
        raw_re = raw_re.to(torch.float32) * in_scale
        raw_im = raw_im.to(torch.float32) * in_scale
    return _fir(raw_re, taps), _fir(raw_im, taps)


def matched_filter_tm(raw_re, raw_im, taps, *, in_scale: float = 1.0):
    """B1's stage 0 alone: the 'valid' FIR f[r] = sum_j taps[j] * raw[r +
    j] down the rows of time-major planes.

    Args:
      raw_re/raw_im: (rows_raw, C) float32 planes, or int16 ones
        dequantized as ``i16 * in_scale``; rows_raw >= len(taps).
      taps: the filter's taps, a sequence of floats.
      in_scale: dequantization step of int16 planes (ignored for float32).
    Returns:
      (filt_re, filt_im), (rows_raw - len(taps) + 1, C) float32.

    CPU tensors take :func:`matched_filter_tm_ref`; CUDA tensors launch
    ``demod_fir_kernel`` on the current stream (:func:`fir_plan`), whose
    sums are one fused multiply-add a tap in tap order.
    """
    if raw_re.device.type == "cpu":
        return matched_filter_tm_ref(raw_re, raw_im, taps, in_scale=in_scale)
    if raw_re.device.type != "cuda":
        raise ValueError(f"unsupported device {raw_re.device}")
    taps, i16 = _check_fir_args(raw_re, raw_im, taps, in_scale)
    if not (raw_re.is_contiguous() and raw_im.is_contiguous()):
        raise ValueError("raw planes must be contiguous")
    dev = raw_re.device
    rows_raw, C = raw_re.shape
    rows_f = rows_raw - len(taps) + 1
    plan = fir_plan(C, rows_f, len(taps), 2 if i16 else 4,
                    plane_align(raw_re, raw_im))
    lib, _ = load_library()
    with torch.cuda.device(dev):
        limit = lib.psk_demod_full_max_smem()
        if plan.smem > limit:
            raise ValueError(f"a matched filter of {len(taps)} taps needs "
                             f"{plan.smem} bytes of shared memory per block, "
                             f"more than this device's limit of {limit}")
        out = torch.empty((2, rows_f, C), dtype=torch.float32, device=dev)
        rc = lib.psk_matched_filter_tm(
            _ptr(raw_re), _ptr(raw_im), rows_raw, C, int(i16),
            float(in_scale), _ptr(_taps_on(taps, dev)), len(taps),
            _ptr(out[0]), _ptr(out[1]), *_fir_args(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"matched_filter_tm launch failed: CUDA error "
                           f"{rc}")
    count_launch(matched_filter_tm)
    return out[0], out[1]


matched_filter_tm.launches = 0


@functools.lru_cache(maxsize=None)
def _taps_on(taps: tuple, device: torch.device) -> torch.Tensor:
    """Matched-filter taps as a float32 tensor on ``device``, cached per
    (taps, device)."""
    return torch.tensor(taps, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _fir_weights(phase_avg: int, device: torch.device) -> torch.Tensor:
    """Endpoint-fit FIR weights (float32, oldest first) on ``device``."""
    w = endpoint_fir_weights(phase_avg, dtype=np.float64).astype(np.float32)
    return torch.as_tensor(w, device=device)


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


@load_once
def load_library():
    """Build (at first use) and load the kernel library.  Returns
    (ctypes library, compiler output of this build or "")."""
    path, log = build_shared(SOURCE, "demod_full", [nvcc_path()], NVCC_FLAGS,
                             headers=(TIMING_HEADER,))
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.psk_demod_full_tm.restype = i32
    f32 = ctypes.c_float
    lib.psk_demod_full_tm.argtypes = (
        [vp, vp, i64] + [vp] * 14 + [i32] * 9 + [f32] + [i32] * 5
        + [i32, f32, i32, vp, i32, vp, i32, vp, vp] + [i32] * 6 + [vp])
    lib.psk_matched_filter_tm.restype = i32
    lib.psk_matched_filter_tm.argtypes = (
        [vp, vp, i64, i32, i32, f32, vp, i32, vp, vp] + [i32] * 6 + [vp])
    lib.psk_demod_full_max_smem.restype = i32
    lib.psk_demod_full_max_smem.argtypes = []
    lib.psk_demod_full_smem.restype = i64
    lib.psk_demod_full_smem.argtypes = [i32] * 8
    return lib, log


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _fir_args(plan: FirPlan) -> tuple:
    """The plan fields stage 0's launch takes (``fir_plan_error``)."""
    return (plan.rows_per_thread, plan.tap_group, plan.row_threads,
            plan.run_rows, plan.stages, plan.vec)


def demod_full_tm(win_re, win_im, x_re, x_im, state_planes, *, sps: int,
                  num_avg: int, phase_avg: int, m: int, diff: bool,
                  pack_out: bool | None = None,
                  soft_i8_scale: float | None = None,
                  debug_ports: bool = True, mf_taps=None,
                  timing_interp: bool = False, mixed: bool = False,
                  in_scale: float = 1.0):
    """Run the fused steady-state demod over time-major planes.

    Args:
      win_re/win_im: ((num_avg-1)*sps + len(mf_taps)-1, C) timing-window
        planes (the previous block's last rows; a view of them is fine):
        raw samples under a matched filter.
      x_re/x_im: (S*sps, C) block planes, float32, or int16 with int16
        window planes (the wire format, dequantized as ``i16 * in_scale``).
      state_planes: (state_rows(phase_avg), C) float32 carry.
      m, diff: constellation size and differential decoding (ignored when
        ``mixed``: rows misc+6 and misc+7 of the carry hold them per channel).
      pack_out: int8 bits/sampleIndex planes (None: when sps <= 128).
      soft_i8_scale: emit soft planes as int8 ``clip(round(s*scale),
        -127, 127)``; bits and phase use the unquantized values.
      debug_ports: False skips the phase and sampleIndex planes (None).
      mf_taps: matched-filter taps (a sequence of floats) run on the raw
        [window | block] rows before timing; None for no filter.
      timing_interp: circular-centroid timing with the decision sample
        interpolated between its two nearest samples.
      mixed: per-channel (M, differential) from the carry's mode rows.
      in_scale: dequantization step of int16 planes (ignored for float32).
    Returns:
      (soft_re, soft_im, phase, bits_packed, sample_index, new_state)
      with (S, C) symbol-rate planes.

    CPU tensors take :func:`demod_full_tm_ref`; CUDA tensors launch the
    stages of kernel B1 on the current stream (:func:`launch_plan`).
    """
    kwargs = dict(sps=sps, num_avg=num_avg, phase_avg=phase_avg, m=m,
                  pack_out=pack_out, mf_taps=mf_taps,
                  timing_interp=timing_interp, mixed=mixed,
                  in_scale=in_scale)
    planes = (win_re, win_im, x_re, x_im, state_planes)
    if x_re.device.type == "cpu":
        return demod_full_tm_ref(*planes, diff=diff,
                                 soft_i8_scale=soft_i8_scale,
                                 debug_ports=debug_ports, **kwargs)
    if x_re.device.type != "cuda":
        raise ValueError(f"unsupported device {x_re.device}")
    pack_out, i16, taps = _check_args(*planes, **kwargs)
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("planes and state must be contiguous")
    dev = x_re.device
    T, C = x_re.shape
    S = T // sps
    wrows = (num_avg - 1) * sps
    filt = None
    if taps is not None:
        filt = torch.empty((2, wrows + T, C), dtype=torch.float32,
                           device=dev)
        stage_a_in = (filt[0, :wrows], filt[1, :wrows], filt[0, wrows:],
                      filt[1, wrows:])
    else:
        stage_a_in = planes[:4]
    plan = launch_plan(C, S, sps, phase_avg, plane_align(*stage_a_in),
                       2 if i16 else 4, bool(timing_interp),
                       len(taps) if taps else 0, wrows + T if taps else 0,
                       plane_align(*planes[:4]))
    lib, _ = load_library()
    with torch.cuda.device(dev):
        limit = lib.psk_demod_full_max_smem()
        for stage, smem in (("stage A (timing)", plan.timing.smem),
                            ("stage B (tracking)", plan.track_smem),
                            ("stage 0 (matched filter)",
                             plan.fir.smem if plan.fir else 0)):
            if smem > limit:
                raise ValueError(
                    f"sps {sps}, phase_avg {phase_avg}: {stage} needs {smem}"
                    f" bytes of shared memory per block, more than this "
                    f"device's limit of {limit}")
        outs = _alloc_outputs(S, C, dev, pack_out, soft_i8_scale,
                              debug_ports)
        o_sre, o_sim, o_phase, o_bits, o_idx = outs
        new_state = torch.empty_like(state_planes)
        sel_re, sel_im, raw = torch.empty(
            (3,) + plan.scratch["raw"], dtype=torch.float32, device=dev)
        first_bad = torch.empty(plan.scratch["first_bad"], dtype=torch.int32,
                                device=dev)
        itab = _interp_table(sps, dev) if timing_interp else None
        taps_t = _taps_on(taps, dev) if taps else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.psk_demod_full_tm(
            _ptr(win_re), _ptr(win_im), win_re.shape[0], _ptr(x_re),
            _ptr(x_im), _ptr(state_planes), _ptr(new_state),
            _ptr(_fir_weights(phase_avg, dev)), _ptr(o_sre), _ptr(o_sim),
            _ptr(o_phase), _ptr(o_bits), _ptr(o_idx), _ptr(sel_re),
            _ptr(sel_im), _ptr(raw), _ptr(first_bad), C, S, sps, num_avg,
            phase_avg, m, int(bool(diff)), int(pack_out),
            int(soft_i8_scale is not None),
            float(soft_i8_scale or 0.0), state_planes.shape[0],
            *plan.timing[:3], plan.chunk, int(i16), float(in_scale),
            int(bool(timing_interp)), _ptr(itab), int(bool(mixed)),
            _ptr(taps_t), len(taps) if taps else 0,
            _ptr(None if filt is None else filt[0]),
            _ptr(None if filt is None else filt[1]),
            *(_fir_args(plan.fir) if plan.fir else (0,) * 6),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"demod_full_tm launch failed: CUDA error {rc}")
    count_launch(demod_full_tm, [
        mode for mode, on in (("int16", i16), ("timing_interp", timing_interp),
                              ("matched_filter", taps is not None),
                              ("mixed", mixed)) if on])
    return o_sre, o_sim, o_phase, o_bits, o_idx, new_state


demod_full_tm.launches = 0
# Of those launches, the ones in each mode (a launch can be in several).
demod_full_tm.mode_launches = dict.fromkeys(
    ("int16", "timing_interp", "matched_filter", "mixed"), 0)
