"""Kernel B1's stage 0 (the matched filter, ``demod_fir_kernel``) on the
CPU: its launch plan (``demod_kernel.fir_plan``) against the shared-memory
limit for every tap count a config can give, a numpy emulation of the
kernel's tiling (row runs, tiles, halos kept across tiles, tap groups on a
register ring and the remainder taps) that must reproduce the plain FIR
exactly, and the plain version (``matched_filter_tm_ref``) against the
JAX package's ``ops/matched_filter.apply_fir``."""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu.ops.matched_filter import apply_fir as jax_apply_fir
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk
from psk_soft_tpu_torch.ops.matched_filter import rrc_taps

torch.set_num_threads(1)
jax.config.update("jax_platforms", "cpu")

LISTED_NTAPS = (1, 2, 8, 9, 65, 129, 257)
CHANNELS = (1, 31, 32, 1000, 1024)
ROWS_F = (50 - 1 + 512) * 8          # config 3's filtered rows a block


def _old_smem(ntaps: int) -> int:
    """Shared memory of the stage-0 kernel this plan replaced: 64 rows x
    32 channels a block, both planes staged as float32, and the taps."""
    return 4 * (2 * (64 + ntaps - 1) * 32 + ntaps)


def _check_plan(plan, C: int, rows_f: int, ntaps: int, esize: int) -> None:
    assert plan.rows_per_thread == dk.FIR_ROWS_PER_THREAD
    assert plan.tap_group == dk.FIR_TAP_GROUP
    assert plan.row_threads in dk.FIR_ROW_THREADS
    assert plan.tile == plan.rows_per_thread * plan.row_threads
    assert plan.threads == 32 * plan.row_threads
    assert plan.run_rows % plan.tile == 0
    assert plan.runs == -(-rows_f // plan.run_rows)
    assert plan.strips == -(-C // 32)
    assert plan.stages == (2 if plan.run_rows > plan.tile else 1)
    assert (esize * C) % plan.vec == 0 and plan.vec >= esize
    assert plan.smem == (4 * (-(-ntaps // 4) * 4) + plan.stages * 2
                         * (plan.tile + ntaps - 1) * 32 * esize)
    assert plan.smem <= dk.FIR_MAX_SMEM


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("ntaps", LISTED_NTAPS)
def test_plan_takes_every_listed_ntaps(ntaps, esize):
    """Boxcar and RRC lengths (1, 2, 8, 9, 65, 129, 257 taps) at C 1, 31,
    32, 1000, 1024 and config 3's rows, and at a short block: a plan the
    kernel takes, within the shared-memory limit."""
    for C in CHANNELS:
        for rows_f in (ROWS_F, 5):
            _check_plan(dk.fir_plan(C, rows_f, ntaps, esize), C, rows_f,
                        ntaps, esize)


def test_plan_refuses_nothing_the_old_kernel_took():
    """Every tap count whose old 64-row block fitted the limit has a plan,
    float32 and int16; every DemodConfig.mf_ntaps up to sps 64 and RRC
    span 16 that the old kernel took too; past the new limit, ValueError."""
    took = [n for n in range(1, 2000) if _old_smem(n) <= dk.FIR_MAX_SMEM]
    assert took[-1] > 800
    for ntaps in took:
        for esize in (4, 2):
            _check_plan(dk.fir_plan(1000, ROWS_F, ntaps, esize), 1000,
                        ROWS_F, ntaps, esize)
    for sps in range(2, 65):
        for cfg in [DemodConfig(sps=sps, matched_filter="boxcar")] + [
                DemodConfig(sps=sps, matched_filter="rrc", rrc_span=span)
                for span in range(1, 17)]:
            if _old_smem(cfg.mf_ntaps) <= dk.FIR_MAX_SMEM:
                dk.fir_plan(1024, ROWS_F, cfg.mf_ntaps)
    big = next(n for n in range(took[-1], 4000)
               if 4 * n + 256 * (16 + n - 1) > dk.FIR_MAX_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        dk.fir_plan(1024, ROWS_F, big)
    for bad in ((0, ROWS_F, 65), (1024, 0, 65), (1024, ROWS_F, 0)):
        with pytest.raises(ValueError):
            dk.fir_plan(*bad)


def test_plan_shapes_at_config3():
    """Config 3's widths: the widest tile (8 threads a channel, 128 rows),
    two buffers, runs of whole tiles that fill the SMs once (32 strips x 8
    runs = 256 blocks, two an SM); 16-byte copies at C 1000 and 1024,
    narrower ones where the row stride or the address allows no more."""
    plan = dk.fir_plan(1024, ROWS_F, 65)
    assert (plan.row_threads, plan.tile, plan.stages) == (8, 128, 2)
    assert plan.runs * plan.strips <= dk.FIR_SMS * dk.FIR_BLOCKS_PER_SM
    assert plan.runs * plan.strips > dk.FIR_SMS
    assert dk.fir_plan(1000, ROWS_F, 65).vec == 16
    assert dk.fir_plan(1000, ROWS_F, 65, 2).vec == 16
    assert dk.fir_plan(1000, ROWS_F, 65, 4, 8).vec == 8
    assert dk.fir_plan(31, ROWS_F, 65).vec == 4
    assert dk.fir_plan(31, ROWS_F, 65, 2).vec == 2
    assert dk.fir_plan(1002, ROWS_F, 65, 2).vec == 4
    # One strip: a run per tile fills more SMs than long runs, one buffer.
    one = dk.fir_plan(32, ROWS_F, 65)
    assert one.stages == 1 and one.run_rows == one.tile
    # Long filters fall back to narrower tiles, then to one buffer.
    assert dk.fir_plan(1024, ROWS_F, 350)[2::5] == (4, 2)
    assert dk.fir_plan(1024, ROWS_F, 600)[2::5] == (8, 1)
    assert dk.fir_plan(1024, ROWS_F, 832)[2::5] == (4, 1)


def test_kernel_constants_match_the_plan():
    """The plan's constants are the kernel's own (csrc/demod_full.cu)."""
    src = dk.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kFirChannels") == dk.FIR_CHANNELS
    assert const("kFirRowsPer") == dk.FIR_ROWS_PER_THREAD
    assert const("kFirGroup") == dk.FIR_TAP_GROUP
    assert const("kFirMaxRowThreads") == max(dk.FIR_ROW_THREADS)
    assert const("kFirMinBlocks") == dk.FIR_BLOCKS_PER_SM


def _emulate(raw: np.ndarray, taps: np.ndarray, plan, scale=None):
    """numpy emulation of demod_fir_kernel's data movement under ``plan``:
    per strip of 32 channels and run of rows, tile 0 staged whole, later
    tiles staged as their new rows with the ntaps - 1 shared rows copied
    from the tile before; per thread of a row group its 16 outputs from a
    ring of window slots (sample s in slot s % slots) filled a tap group at
    a time, then the remainder taps read from the staged rows.  Products
    and sums are rounded apart in tap order (the plain version's
    arithmetic), so it must equal it exactly."""
    R, G = plan.rows_per_thread, plan.tap_group
    phases = -(-(R + G - 1) // G)
    slots = phases * G
    ntaps = len(taps)
    rows_raw, C = raw.shape
    rows_f = rows_raw - ntaps + 1
    tile, span = plan.tile, plan.tile + ntaps - 1
    t32 = taps.astype(np.float32)
    out = np.full((rows_f, C), np.float32(7.5))     # unwritten marker

    def sample(v):
        if scale is None:
            return v
        return v.astype(np.float32) * np.float32(scale)

    for y in range(plan.strips):
        lanes = np.zeros((rows_raw, 32), raw.dtype)
        width = min(32, C - 32 * y)
        lanes[:, :width] = raw[:, 32 * y:32 * y + width]
        for x in range(plan.runs):
            run0 = x * plan.run_rows
            run_end = min(run0 + plan.run_rows, rows_f)
            ntiles = -(-(run_end - run0) // tile)
            assert ntiles == 1 or plan.stages == 2
            bufs = [np.zeros((span, 32), raw.dtype)
                    for _ in range(plan.stages)]

            def stage(buf, r0, first, n):
                for ri in range(first, first + n):
                    r = r0 + ri
                    buf[ri] = lanes[r] if r < rows_raw else 0

            stage(bufs[0], run0, 0, span)
            for t in range(ntiles):
                cur = bufs[t & 1]
                r0 = run0 + t * tile
                if t + 1 < ntiles:
                    nxt = bufs[(t + 1) & 1]
                    stage(nxt, r0 + tile, ntaps - 1, tile)
                    nxt[:ntaps - 1] = cur[tile:span]
                for rg in range(plan.row_threads):
                    row0 = r0 + rg * R
                    if row0 >= run_end:
                        continue
                    base = rg * R
                    acc = np.zeros((R, 32), np.float32)
                    win = np.zeros((slots, 32), np.float32)
                    win[:R - 1] = sample(cur[base:base + R - 1])
                    for g in range(ntaps // G):
                        ph = (g % phases) * G
                        for k in range(G):
                            win[(ph + R - 1 + k) % slots] = sample(
                                cur[base + g * G + R - 1 + k])
                        for k in range(G):
                            idx = (ph + np.arange(R) + k) % slots
                            acc = acc + t32[g * G + k] * win[idx]
                    for j in range(ntaps // G * G, ntaps):
                        acc = acc + t32[j] * sample(cur[base + j:base + j + R])
                    n = min(R, run_end - row0)
                    out[row0:row0 + n, 32 * y:32 * y + width] = \
                        acc[:n, :width]
    return out


@pytest.mark.parametrize("ntaps, rows_f, C, row_threads, tiles_per_run", [
    (1, 37, 5, 1, 2),          # every tap a remainder tap
    (7, 50, 33, 1, 2),         # fewer taps than a group; two strips
    (9, 101, 40, 1, 4),        # one group + one remainder tap
    (21, 70, 32, 1, 3),        # two groups + 5, a partial turn of the ring
    (24, 129, 64, 4, 2),       # a whole turn (3 groups), no remainder
    (65, 300, 31, 2, 4),       # config 3's length, ragged rows and strip
    (65, 300, 31, 8, 1),       # ... one tile a run, one buffer
])
def test_emulated_tiling_reproduces_the_plain_fir(ntaps, rows_f, C,
                                                  row_threads,
                                                  tiles_per_run):
    """Row runs of several tiles (halos kept across tiles), tap groups
    with their remainder, rows_f not a multiple of the tile, C not a
    multiple of the strip, a NaN raw sample: the emulated kernel equals
    the plain FIR exactly, NaN included."""
    rng = np.random.default_rng(ntaps * 1000 + rows_f)
    taps = rng.standard_normal(ntaps).astype(np.float32)
    raw = rng.standard_normal((rows_f + ntaps - 1, C)).astype(np.float32)
    raw[rows_f // 2, C // 2] = np.nan
    tile = dk.FIR_ROWS_PER_THREAD * row_threads
    run_rows = tile * tiles_per_run
    plan = dk.FirPlan(dk.FIR_ROWS_PER_THREAD, dk.FIR_TAP_GROUP, row_threads,
                      tile, run_rows, -(-rows_f // run_rows), -(-C // 32),
                      2 if tiles_per_run > 1 else 1, 4, 0, 32 * row_threads)
    assert plan.runs > 1 or tiles_per_run == 1
    want = dk._fir(torch.from_numpy(raw), tuple(float(t) for t in taps))
    np.testing.assert_array_equal(_emulate(raw, taps, plan), want.numpy())


@pytest.mark.parametrize("ntaps", [9, 65])
def test_emulated_tiling_under_the_plan_int16(ntaps):
    """int16 planes dequantized where a sample enters the window, under
    fir_plan's own plan at a short block: equal to the plain version on the
    dequantized planes."""
    rng = np.random.default_rng(ntaps)
    taps = rrc_taps(8) if ntaps == 65 else rng.standard_normal(
        ntaps).astype(np.float32)
    rows_f, C, scale = 200, 40, 1.0 / 8000
    raw = rng.integers(-30000, 30000, (rows_f + ntaps - 1, C)).astype(
        np.int16)
    plan = dk.fir_plan(C, rows_f, ntaps, 2)
    got_re, _ = dk.matched_filter_tm_ref(torch.from_numpy(raw),
                                         torch.from_numpy(raw), taps,
                                         in_scale=scale)
    np.testing.assert_array_equal(_emulate(raw, taps, plan, scale),
                                  got_re.numpy())


@pytest.mark.parametrize("i16", [False, True])
@pytest.mark.parametrize("ntaps", [1, 9, 65])
def test_plain_version_matches_jax_apply_fir(ntaps, i16):
    """matched_filter_tm_ref against the JAX package's apply_fir on the
    same seeded planes (int16 dequantized as i16 * in_scale first), within
    1e-5 * sum|taps| * max|raw|: XLA's convolution sums in another order
    than the plain version's tap-order sum."""
    rng = np.random.default_rng(100 + ntaps)
    taps = rrc_taps(8) if ntaps == 65 else rng.standard_normal(
        ntaps).astype(np.float32)
    rows_raw, C = 300 + ntaps - 1, 48
    if i16:
        scale = 1.0 / 8000
        re = rng.integers(-30000, 30000, (rows_raw, C)).astype(np.int16)
        im = rng.integers(-30000, 30000, (rows_raw, C)).astype(np.int16)
        re_f = re.astype(np.float32) * np.float32(scale)
        im_f = im.astype(np.float32) * np.float32(scale)
    else:
        scale = 1.0
        re = rng.standard_normal((rows_raw, C)).astype(np.float32)
        im = rng.standard_normal((rows_raw, C)).astype(np.float32)
        re_f, im_f = re, im
    got = dk.matched_filter_tm_ref(torch.from_numpy(re), torch.from_numpy(im),
                                   taps, in_scale=scale)
    x = jnp.asarray((re_f + 1j * im_f).T.astype(np.complex64))
    y = np.asarray(jax_apply_fir(x, jnp.asarray(taps))).T
    tol = 1e-5 * float(np.abs(taps).sum()) * float(
        max(np.abs(re_f).max(), np.abs(im_f).max()))
    assert got[0].shape == (rows_raw - ntaps + 1, C)
    assert np.abs(got[0].numpy() - y.real).max() <= tol
    assert np.abs(got[1].numpy() - y.imag).max() <= tol


def test_matched_filter_tm_on_cpu_and_its_checks():
    """CPU tensors take the plain version (and count no launch); what
    neither version takes raises ValueError."""
    rng = np.random.default_rng(3)
    re = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    taps = [0.5, -0.25, 1.0]
    before = dk.matched_filter_tm.launches
    got = dk.matched_filter_tm(re, im, taps)
    want = dk.matched_filter_tm_ref(re, im, taps)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dk.matched_filter_tm.launches == before
    np.testing.assert_allclose(
        got[0][3].numpy(), 0.5 * re[3] + -0.25 * re[4] + re[5], rtol=1e-6)
    bad = [((re, im, []), "at least one tap"),
           ((re, im.double(), taps), "float32"),
           ((re[:2], im[:2], taps), "rows >= 3"),
           ((re[:, 0], im[:, 0], taps), "rows, C"),
           ((re.to(torch.int16), im.to(torch.int16), taps), "in_scale")]
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            kw = {"in_scale": float("nan")} if what == "in_scale" else {}
            dk.matched_filter_tm(*args, **kw)
