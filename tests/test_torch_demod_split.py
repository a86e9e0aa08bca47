"""Kernel B1's two-stage design (csrc/demod_full.cu), on the CPU.

The kernels run only on the card (chip_smoke.py phase 3 holds them against
the plain version).  Here: (1) the wrapper's pure-Python launch plan at the
edge shapes, and that it refuses no shape the one-thread-per-channel
kernel took; (2) the carry contract the tracking stage's chunks rely on:
a block split in two plain-version calls, the carry planes and the last
(num_avg-1)*sps rows handed over, equals one call; (3) the plain version's
rule for non-finite samples, which stage B reproduces from the first NaN
and +inf symbol of each (bin, channel).
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import blockpsk, full
from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

torch.set_num_threads(1)

PHASE_TOL = 2e-3                # tests/test_full_kernel.py's phase bound
SPLIT_SOFT_TOL = 1e-4           # a split chain against one block
H100_SMEM = 232448              # opt-in shared memory a block, H100
OLD_THREADS = 32                # the earlier kernel: one warp a block


def _old_kernel_took(sps, phase_avg):
    """The earlier kernel's check: (sps + phase_avg - 1) floats per thread
    of shared memory, one 32-thread block, within the device's limit."""
    return (sps + phase_avg - 1) * OLD_THREADS * 4 <= H100_SMEM


@pytest.mark.parametrize("C,S,sps,phase_avg", [
    (1024, 512, 8, 50),          # the flagship shape
    (1000, 512, 8, 50),          # C not a multiple of a channel group
    (1024, 1, 8, 50), (1024, 5, 8, 50), (1024, 37, 8, 50),
    (1024, 129, 8, 50),          # S < 8, S < n1, S not a chunk multiple
    (256, 512, 40, 50),          # sps > 32: a shorter staged chunk
    (128, 512, 32, 50), (128, 512, 33, 50),
    (7, 3, 2, 10),               # a few channels, the smallest phase_avg
    (1, 100_000_000, 2, 10),     # one channel, a very long block
    (8192, 512, 8, 50),          # 1024 stage-A blocks
])
def test_launch_plan_edges(C, S, sps, phase_avg):
    plan = dk.launch_plan(C, S, sps, phase_avg)
    # Stage A: one block per group of channels over all of S; groups cover
    # C, the staged chunks fit, copies fit the rows.
    tp = plan.timing
    assert tp.group in (1, 2, 4, 8) and tp.grid == -(-C // tp.group)
    assert 1 <= tp.chunk <= dk.TIMING_MAX_CHUNK
    assert 8 * sps * tp.group * (2 * tp.chunk + 1) <= dk.TIMING_STAGE_BYTES \
        or (tp.group, tp.chunk) == (1, 1)
    assert (4 * tp.group) % tp.vec == 0 and (4 * C) % tp.vec == 0
    pairs = sps * tp.group
    parts = max(1, min(tp.chunk, dk.TIMING_THREADS // pairs))
    assert tp.smem == 4 * (2 * 2 * (2 * tp.chunk + 1) * pairs
                           + tp.chunk * (2 * pairs + tp.group)
                           + 2 * parts * pairs + 4 * pairs)
    assert tp.smem <= dk.TIMING_MAX_SMEM or tp.chunk == 1
    assert tp.threads == dk.TIMING_THREADS <= 1024
    # Stage B: whole warps of (symbol, channel), one chunk when S is small.
    assert plan.chunk % (32 // plan.group) == 0
    assert plan.chunk == min(dk.TRACK_MAX_CHUNK, -(-S // 4) * 4)
    assert plan.track_block == plan.chunk * plan.group
    assert plan.track_block % 32 == 0 and plan.track_block <= 1024
    assert plan.track_grid * plan.group >= C > (plan.track_grid - 1
                                                ) * plan.group
    n1 = phase_avg - 1
    hist = (n1 + plan.chunk) + 2 * (8 + plan.chunk) + 3 * (1 + plan.chunk)
    assert plan.track_smem == 4 * (2 * hist * plan.group + n1 + 1
                                   + plan.chunk // 4 * plan.group
                                   + 3 * plan.group)
    assert plan.scratch == {"sel_re": (S, C), "sel_im": (S, C),
                            "raw": (S, C), "first_bad": (2, sps, C)}


def test_launch_plan_flagship_numbers():
    plan = dk.launch_plan(1024, 512, 8, 50)
    assert tuple(plan.timing) == (8, 64, 16, 172032, 128, 512)
    assert (plan.chunk, plan.track_grid, plan.track_block) == (64, 128, 512)
    assert plan.track_smem == 29736
    assert dk.launch_plan(1000, 512, 8, 50, align=8).timing.vec == 8
    assert dk.launch_plan(7, 3, 2, 10).timing.vec == 4
    assert dk.launch_plan(256, 512, 40, 50).timing[:3] == (8, 15, 16)


@pytest.mark.parametrize("sps,phase_avg", [
    (2, 10), (8, 50), (32, 1785), (2, 1815), (40, 1777), (100, 1000),
    (900, 917), (1806, 11),
])
def test_launch_plan_takes_every_shape_the_old_kernel_took(sps, phase_avg):
    assert _old_kernel_took(sps, phase_avg)
    for S in (1, 37, 512):
        plan = dk.launch_plan(1024, S, sps, phase_avg)
        assert max(plan.timing.smem, plan.track_smem) <= H100_SMEM


def test_launch_plan_refuses_nothing_the_old_kernel_took():
    """Over a grid of sps and phase_avg: wherever the old check passed,
    both stages fit the same device."""
    for sps in (2, 3, 8, 31, 32, 33, 64, 128, 255, 512, 1024, 1800):
        for phase_avg in (10, 11, 50, 100, 500, 1000, 1500, 1815):
            if not _old_kernel_took(sps, phase_avg):
                continue
            plan = dk.launch_plan(512, 300, sps, phase_avg)
            assert max(plan.timing.smem, plan.track_smem) <= H100_SMEM, (
                sps, phase_avg)


# --- the carry contract ---

C, SPS, NUM_AVG, PHASE_AVG = 32, 8, 50, 20
WARM, NS = 256, 256


def _bank(m, diff, n_sym, seed0=0):
    """(C, n_sym*SPS) complex64: a unit PSK impulse at sample 2 of every
    symbol, a small frequency offset, real noise of std 0.01; channel i
    draws from seed seed0 + i."""
    out = np.empty((C, n_sym * SPS), np.complex64)
    rot = np.exp(2j * np.pi * 2e-4 * SPS * np.arange(n_sym))
    for i in range(C):
        rng = np.random.default_rng(seed0 + i)
        pts = np.exp(2j * np.pi * rng.integers(0, m, n_sym) / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(n_sym * SPS, np.complex64)
        x[2::SPS] = pts * rot
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out[i] = x
    return out


def _warm(m, diff, n_sym):
    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=m,
                      phase_avg=PHASE_AVG, differential=diff)
    xs = torch.from_numpy(_bank(m, diff, WARM + n_sym))
    st, _ = blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, C, "cpu"),
                                    xs[:, :WARM * SPS])
    run = xs[:, WARM * SPS:]
    return (full.full_from_ff(cfg, st), run.real.T.contiguous(),
            run.imag.T.contiguous())


def _wrapped(a, b, period):
    d = (a - b).double()
    return float((d - period * (d / period).round()).abs().max())


@pytest.mark.parametrize("m,diff", [(4, False), (4, True)])
@pytest.mark.parametrize("a", [1, 7, 48, 200])
def test_split_block_equals_one_call(a, m, diff):
    st, x_re, x_im = _warm(m, diff, NS)
    kw = dict(sps=SPS, num_avg=NUM_AVG, phase_avg=PHASE_AVG, m=m, diff=diff)
    one = dk.demod_full_tm_ref(st.win_re, st.win_im, x_re, x_im, st.planes,
                               **kw)
    cut = a * SPS
    first = dk.demod_full_tm_ref(st.win_re, st.win_im, x_re[:cut],
                                 x_im[:cut], st.planes, **kw)
    keep = (NUM_AVG - 1) * SPS
    win_re = torch.cat([st.win_re, x_re[:cut]])[-keep:]
    win_im = torch.cat([st.win_im, x_im[:cut]])[-keep:]
    second = dk.demod_full_tm_ref(win_re, win_im, x_re[cut:], x_im[cut:],
                                  first[5], **kw)
    soft_re, soft_im, phase, bits, idx = (
        torch.cat([p, q]) for p, q in zip(first[:5], second[:5]))
    assert torch.equal(bits, one[3])
    assert torch.equal(idx, one[4])
    assert float((soft_re - one[0]).abs().max()) < SPLIT_SOFT_TOL
    assert float((soft_im - one[1]).abs().max()) < SPLIT_SOFT_TOL
    period = 2 * np.pi * m
    assert _wrapped(phase, one[2], period) < PHASE_TOL
    assert _wrapped(second[5], one[5], period) < PHASE_TOL


# --- the plain version's non-finite rule ---

def _rule_indices(energy, clean_idx, S, num_avg):
    """The first-NaN / first-inf rule from the first non-finite symbol of
    each bin.  energy: (S + num_avg - 1, sps) of one channel, counted over
    [window | block]; clean_idx: the indices where no bin is non-finite."""
    n_rows, sps = energy.shape
    none = n_rows + num_avg
    tn = [next((t for t in range(n_rows) if np.isnan(energy[t, j])), none)
          for j in range(sps)]
    ti = [next((t for t in range(n_rows) if np.isposinf(energy[t, j])), none)
          for j in range(sps)]
    out = clean_idx.copy()
    for o in range(S):
        hi = o + num_avg - 1
        nan = [j for j in range(sps) if hi >= tn[j] or o > ti[j]]
        inf = [j for j in range(sps) if hi >= ti[j]]
        if nan:
            out[o] = nan[0]
        elif inf:
            out[o] = inf[0]
    return out


def test_plain_version_keeps_the_nonfinite_rule():
    """NaN at channel 3's block symbol 300 (bin 5), +inf at channel 9's
    symbol 100 (bin 3), and on channel 17 +inf at symbol 150 (bin 6) then
    NaN at symbol 180 (bin 1): the plain version's sample index follows
    the rule for every output symbol the poison reaches, and equals the
    clean run everywhere else."""
    S = 512
    st, x_re, x_im = _warm(4, False, S)
    kw = dict(sps=SPS, num_avg=NUM_AVG, phase_avg=PHASE_AVG, m=4,
              diff=False)
    clean = dk.demod_full_tm_ref(st.win_re, st.win_im, x_re, x_im,
                                 st.planes, **kw)[4]
    x_re, x_im = x_re.clone(), x_im.clone()
    x_re[300 * SPS + 5, 3] = float("nan")
    x_im[100 * SPS + 3, 9] = float("inf")
    x_re[150 * SPS + 6, 17] = float("inf")
    x_im[180 * SPS + 1, 17] = float("nan")
    got = dk.demod_full_tm_ref(st.win_re, st.win_im, x_re, x_im, st.planes,
                               **kw)[4]
    re = torch.cat([st.win_re, x_re]).numpy()
    im = torch.cat([st.win_im, x_im]).numpy()
    energy = (re * re + im * im).reshape(S + NUM_AVG - 1, SPS, C)
    poisoned = {3: 300, 9: 100, 17: 150}
    for c in range(C):
        expect = clean[:, c].numpy()
        if c in poisoned:
            expect = _rule_indices(energy[:, :, c], expect, S, NUM_AVG)
            # The rule reaches back num_avg - 1 symbols from the sample's
            # place in [window | block], i.e. to its block symbol.
            first = poisoned[c]
            assert not np.array_equal(expect[first:],
                                      clean[first:, c].numpy())
            np.testing.assert_array_equal(expect[:first],
                                          clean[:first, c].numpy())
        np.testing.assert_array_equal(got[:, c].numpy(), expect,
                                      err_msg=f"channel {c}")
    assert (got[300:, 3] == 5).all() and (got[100:, 9] == 3).all()
    # An inf bin wins until a NaN appears; the first NaN bin beats it.
    assert (got[150:180, 17] == 6).all() and (got[180:, 17] == 1).all()
