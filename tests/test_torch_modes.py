"""Port parity, kernel B1's other modes: int16 ingest, timing_interp, the
in-kernel matched filter and mixed per-channel modes of
psk_soft_tpu_torch/ops/cuda/demod_kernel (its plain version on the CPU)
and models/full, against the JAX Pallas kernel run with interpret=True on
the same numpy inputs and the same carry; then FullKernelBatchEngine at
BASELINE config 3 (8-PSK, RRC, timing_interp) on int16 wire planes against
the JAX engine.

Bounds, from the JAX package's own tests: bits and sample_index equal,
soft 3e-3, phase 2e-3 modulo M*2pi (tests/test_full_kernel.py); mixed
phase 1e-3 (tests/test_full_kernel_mf.py:153-196); the config-3 engine
within 5e-3 (test_full_kernel_mf.py:96-117).  int16 against float32 on the
dequantized values: equal (one float32 multiply dequantizes in both).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models import full as jfull
from psk_soft_tpu.models.blockpsk import ff_init as jax_ff_init
from psk_soft_tpu.models.blockpsk import make_ff_demod_fn
from psk_soft_tpu.ops import phase as jphase, slicers as jslicers
from psk_soft_tpu.ops import timing as jtiming
from psk_soft_tpu.runtime.engine import \
    FullKernelBatchEngine as JaxFullKernelBatchEngine
from psk_soft_tpu.testing.signals import gen_psk_channel
from psk_soft_tpu.utils import checkpoint as jckpt
from psk_soft_tpu.utils.transfer import to_host
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import full
from psk_soft_tpu_torch.ops import phase, slicers, timing
from psk_soft_tpu_torch.ops.cuda import demod_kernel
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
from psk_soft_tpu_torch.utils import checkpoint, interop

torch.set_num_threads(1)

C, SPS = 128, 8
SOFT_TOL, PHASE_TOL = 3e-3, 2e-3
CFG3 = dict(sps=8, num_avg=50, constellation_size=8, phase_avg=40,
            matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
            timing_interp=True)                       # BASELINE config 3


def _shaped(cfg, num_symbols, seed0=0, pulse="rrc"):
    """tests/test_full_kernel_mf.py's bank: gen_psk_channel at 25 dB."""
    return np.stack([
        gen_psk_channel(num_symbols, sps=cfg.sps, m=cfg.constellation_size,
                        seed=seed0 + i, snr_db=25, freq_offset=1e-4,
                        pulse=pulse, rrc_beta=cfg.rrc_beta,
                        rrc_span=cfg.rrc_span)[0] for i in range(C)])


def _impulses(num_symbols, seed0=0, m=4, taps=((3, 1.0),)):
    """Timing-decisive bank: the symbol on intra-symbol samples ``taps``
    (index, gain), a small frequency offset, noise 0.01."""
    xs = []
    for i in range(C):
        rng = np.random.default_rng(seed0 + i)
        pts = np.exp(2j * np.pi * rng.integers(0, m, num_symbols) / m)
        x = np.zeros(num_symbols * SPS, np.complex64)
        for pos, g in taps:
            x[pos::SPS] = g * pts * np.exp(2j * np.pi * 1e-4 * SPS
                                           * np.arange(num_symbols))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return np.stack(xs)


def _wire(xs):
    """int16 wire planes (T, C) of a bank, their scale, and the bank
    dequantized."""
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    re = np.round(np.ascontiguousarray(xs.real.T) / scale).astype(np.int16)
    im = np.round(np.ascontiguousarray(xs.imag.T) / scale).astype(np.int16)
    xq = ((re.astype(np.float32) * scale).T
          + 1j * (im.astype(np.float32) * scale).T).astype(np.complex64)
    return re, im, scale, xq


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _jax_carry(kw, xs, warm=256):
    """The JAX feed-forward warm-up over ``warm`` symbols and its hand-off
    (raw window under a matched filter); returns (JAX FullState, the same
    as port tensors, the rest of ``xs``)."""
    jcfg = JaxDemodConfig(**kw)
    w = warm * jcfg.sps
    jff, _ = make_ff_demod_fn(jcfg, channels=C)(jax_ff_init(jcfg, (C,)),
                                                jnp.asarray(xs[:, :w]))
    raw = None
    if jcfg.matched_filter != "none":
        raw = xs[:, w - (jcfg.num_avg - 1) * jcfg.sps - jcfg.mf_ntaps + 1:w]
    jst = jfull.full_from_ff(jcfg, jff, raw_win=raw)
    return jst, interop.full_state_from_numpy(_np(jst), "cpu"), xs[:, w:]


def _planes(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real.T)),
            torch.from_numpy(np.ascontiguousarray(x.imag.T)))


def _wrapped(a, b, period):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d - period * np.round(d / period)).max()


def _assert_out(out, jout, period, phase_tol=PHASE_TOL):
    jout = to_host(jout)
    np.testing.assert_array_equal(out.bits_packed.numpy(),
                                  np.asarray(jout.bits_packed))
    np.testing.assert_array_equal(out.sample_index.numpy(),
                                  np.asarray(jout.sample_index))
    for a, b in ((out.soft_re, jout.soft_re), (out.soft_im, jout.soft_im)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SOFT_TOL)
    assert _wrapped(out.phase.numpy(), jout.phase, period) < phase_tol


def _both(kw, jst, st, run, mixed=False, i16=None):
    """One block through the Pallas kernel and the port from one carry;
    ``i16`` = (re, im, scale) wire planes of ``run``."""
    jcfg, cfg = JaxDemodConfig(**kw), DemodConfig(**kw)
    if i16 is None:
        jx = (jnp.asarray(np.ascontiguousarray(run.real.T)),
              jnp.asarray(np.ascontiguousarray(run.imag.T)))
        x, scale = _planes(run), 1.0
    else:
        re, im, scale = i16
        jst = jfull.quantize_full_state(jst, scale)
        st = full.quantize_full_state(st, scale)
        jx = (jnp.asarray(re), jnp.asarray(im))
        x = (torch.from_numpy(re), torch.from_numpy(im))
    jnew, jout = jfull.demod_block_full(jcfg, jst, *jx, s_tile=128,
                                        mixed=mixed, in_scale=scale,
                                        interpret=True)
    new, out = full.demod_block_full(cfg, st, *x, mixed=mixed,
                                     in_scale=scale)
    return jnew, jout, new, out


@pytest.mark.parametrize("case", ["rrc", "interp", "config3", "boxcar_sps10",
                                  "config3_int16"])
def test_mode_matches_pallas(case):
    """Each mode against the Pallas kernel from one JAX carry: the matched
    filter alone (RRC, argmax timing), timing_interp alone on impulses,
    config 3 (RRC + timing_interp), a boxcar at sps 10 (odd look-back),
    and config 3 on int16 wire planes."""
    kw = {"rrc": dict(CFG3, constellation_size=4, timing_interp=False),
          "interp": dict(sps=8, num_avg=50, constellation_size=4,
                         phase_avg=20, timing_interp=True),
          "config3": CFG3,
          "boxcar_sps10": dict(sps=10, num_avg=50, constellation_size=4,
                               phase_avg=20, matched_filter="boxcar"),
          "config3_int16": CFG3}[case]
    jcfg = JaxDemodConfig(**kw)
    if case == "interp":
        xs = _impulses(384, seed0=200, taps=((3, 1.0), (4, 0.5)))
    else:
        xs = _shaped(jcfg, 384, seed0=50,
                     pulse="rect" if case.startswith("boxcar") else "rrc")
    i16 = None
    if case.endswith("int16"):
        re, im, scale, xs = _wire(xs)
        i16 = (re[256 * SPS:], im[256 * SPS:], scale)
    jst, st, run = _jax_carry(kw, xs)
    jnew, jout, new, out = _both(kw, jst, st, run, i16=i16)
    m = kw["constellation_size"]
    _assert_out(out, jout, 2 * np.pi * m)
    assert _wrapped(new.planes.numpy(), np.asarray(jnew.planes),
                    2 * np.pi * m) < PHASE_TOL
    rows = full.window_rows(DemodConfig(**kw))
    assert new.win_re.shape == (rows, C)
    np.testing.assert_array_equal(new.win_re.numpy(), np.asarray(jnew.win_re))
    assert new.win_re.dtype == (torch.int16 if i16 else torch.float32)


def test_int16_equals_float32_on_dequantized_planes():
    """The int16 wire planes through the plain version equal the float32
    planes of their dequantized values: window, block and carry."""
    kw = dict(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    re, im, scale, xq = _wire(_impulses(384, seed0=7))
    _, st, run = _jax_carry(kw, xq)
    st16 = full.quantize_full_state(st, scale)
    w = 256 * SPS
    cfg = DemodConfig(**kw)
    n16, o16 = full.demod_block_full(
        cfg, st16, torch.from_numpy(re[w:]), torch.from_numpy(im[w:]),
        in_scale=scale)
    n32, o32 = full.demod_block_full(cfg, full.dequantize_full_state(
        st16, scale), *_planes(run))
    for a, b in zip(o16, o32):
        assert torch.equal(a, b)
    assert torch.equal(n16.planes, n32.planes)
    assert torch.equal(full.dequantize_full_state(n16, scale).win_re,
                       n32.win_re)


def test_interp_row0_negative_offset_matches_pallas():
    """The energy peak between bins 7 and 0 of the previous symbol period:
    the centroid is negative, so the decision interpolates into the row
    before it -- and at output 0 of the call, which has no row before,
    the Pallas kernel's fall-back (frac 0, the row's own first sample)."""
    kw = dict(sps=8, num_avg=50, constellation_size=4, phase_avg=20,
              timing_interp=True)
    xs = _impulses(384, seed0=300, taps=((0, 1.0), (7, 0.9)))
    jst, st, run = _jax_carry(kw, xs)
    # Output 0's centroid, from the Pallas kernel's own window sums.
    w = np.asarray(st.win_re.numpy()) ** 2 + st.win_im.numpy() ** 2
    e = np.concatenate([w, run.real.T[:8] ** 2 + run.imag.T[:8] ** 2])
    bins = e[:8 * 50].reshape(50, 8, C).sum(0)
    ang = 2 * np.pi * np.arange(8) / 8
    p = np.arctan2((bins * np.sin(ang)[:, None]).sum(0),
                   (bins * np.cos(ang)[:, None]).sum(0)) * 8 / (2 * np.pi)
    assert (p < 0).mean() > 0.9                  # the case under test
    _, jout, _, out = _both(kw, jst, st, run)
    _assert_out(out, jout, 2 * np.pi * 4)
    # Output 0 takes its own row's first sample.
    neg = p < 0
    np.testing.assert_allclose((out.soft_re.numpy()[0] ** 2
                                + out.soft_im.numpy()[0] ** 2)[neg],
                               (st.win_re.numpy()[0] ** 2
                                + st.win_im.numpy()[0] ** 2)[neg],
                               rtol=1e-4)


def test_mixed_mode_matches_pallas():
    """Per-channel (M, differential) from the carry's mode rows against
    the Pallas kernel's mixed mode (index and bits equal, soft 3e-3,
    phase 1e-3)."""
    from psk_soft_tpu.models.mixed import MixedParams as JaxMixedParams

    kw = dict(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    rng = np.random.default_rng(0)
    ms, diffs = rng.choice([2, 4, 8], C), rng.random(C) < 0.5
    xs = np.zeros((C, 384 * SPS), np.complex64)
    for i in range(C):
        r = np.random.default_rng(700 + i)
        pts = np.exp(2j * np.pi * r.integers(0, ms[i], 384) / ms[i])
        if diffs[i]:
            pts = np.cumprod(pts)
        xs[i, 3::SPS] = pts * np.exp(2j * np.pi * 1e-4 * SPS
                                     * np.arange(384))
        xs[i] += (0.01 * r.standard_normal(xs.shape[1])).astype(np.complex64)
    jcfg = JaxDemodConfig(**kw)
    jp = JaxMixedParams.make(ms, diffs)
    from psk_soft_tpu.models.mixed import make_mixed_demod_fn, mixed_init
    jff, _ = make_mixed_demod_fn(jcfg)(jp, mixed_init(jcfg, C),
                                       jnp.asarray(xs[:, :256 * SPS]))
    jst = jfull.full_from_ff(jcfg, jff, mixed_params=jp)
    ff = interop.ff_state_from_numpy(_np(to_host(jff)), "cpu")
    st = full.full_from_ff(DemodConfig(**kw), ff,
                           mixed_params=interop.mixed_params_from_numpy(
                               ms, diffs, "cpu"))
    for f in st._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), atol=1e-6)
    _, jout, new, out = _both(kw, jst, st, xs[:, 256 * SPS:], mixed=True)
    _assert_out(out, jout, 2 * np.pi * 2, phase_tol=1e-3)
    misc = 19 + 16
    assert torch.equal(new.planes[misc + 6:misc + 8], st.planes[misc + 6:
                                                                misc + 8])


def test_matched_filter_poison_is_filtered_first():
    """A NaN and an +inf raw sample under the matched filter: the plain
    version equals the unfiltered pipeline on the filtered stream (the
    ops/matched_filter.apply_fir convention), so the first-NaN / first-inf
    rule holds on filtered samples; only the poisoned channels go
    non-finite.  (The Pallas kernel filters with banded matmuls, where a
    NaN reaches a whole 128-row chunk: ROADMAP C names that divergence.)"""
    kw = dict(CFG3, timing_interp=False)
    cfg = DemodConfig(**kw)
    _, st, run = _jax_carry(kw, _shaped(JaxDemodConfig(**kw), 384, seed0=9))
    x_re, x_im = _planes(run)
    x_re[40 * SPS + 5, 5] = float("nan")
    x_im[30 * SPS + 3, 9] = float("inf")
    k = dict(sps=8, num_avg=50, phase_avg=40, m=8, diff=False)
    taps = full._static_taps(cfg)
    got = demod_kernel.demod_full_tm(st.win_re, st.win_im, x_re, x_im,
                                     st.planes, mf_taps=taps, **k)
    re = demod_kernel._fir(torch.cat([st.win_re, x_re]), taps)
    im = demod_kernel._fir(torch.cat([st.win_im, x_im]), taps)
    w = 49 * SPS
    want = demod_kernel.demod_full_tm(re[:w], im[:w], re[w:], im[w:],
                                      st.planes, **k)
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.isnan(), b.isnan())
    bad = torch.nonzero(~got[0].isfinite().all(dim=0)).flatten().tolist()
    assert bad == [5, 9]


def test_launch_plan_takes_the_modes():
    """int16 planes stage 2-byte rows (a group of 8 channels is one
    16-byte copy; 2-byte copies at an odd channel count); timing_interp
    stages one more leaving symbol; a matched filter adds stage 0 and its
    float32 scratch, and stage A then reads float32."""
    f32 = demod_kernel.timing_plan(1000, 8)
    i16 = demod_kernel.timing_plan(1000, 8, esize=2)
    assert (f32.vec, i16.vec) == (16, 16) and i16.smem < f32.smem
    assert demod_kernel.timing_plan(1001, 8, esize=2).vec == 2
    assert demod_kernel.timing_plan(1002, 8, esize=2).vec == 4
    assert demod_kernel.timing_plan(1000, 8, 8, esize=2).vec == 8
    itp = demod_kernel.timing_plan(1024, 8, interp=True)
    assert itp.smem == f32.smem + 2 * 2 * 4 * 8 * 8
    plan = demod_kernel.launch_plan(1024, 512, 8, 40, 16, 2, True, 65,
                                    49 * 8 + 512 * 8)
    assert plan.scratch["filt"] == (2, 49 * 8 + 512 * 8, 1024)
    assert plan.fir == demod_kernel.fir_plan(1024, 49 * 8 + 512 * 8, 65, 2)
    assert plan.fir.smem == 4 * 68 + 2 * 2 * (128 + 64) * 32 * 2
    assert plan.timing == demod_kernel.timing_plan(1024, 8, 16, 4, True)
    assert demod_kernel.launch_plan(1024, 512, 8, 40).fir is None


def test_ops_match_jax():
    """The dynamic-M phase and slicers and the interpolating pick."""
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((64, 40)) + 1j * rng.standard_normal((64, 40))
         ).astype(np.complex64)
    m = rng.choice([2, 4, 8, 16, 32], (64, 1)).astype(np.int32)
    np.testing.assert_allclose(
        phase.mth_power_phase_dynamic(torch.from_numpy(z),
                                      torch.from_numpy(m)).numpy(),
        np.asarray(jphase.mth_power_phase_dynamic(jnp.asarray(z),
                                                  jnp.asarray(m))),
        atol=2e-5)
    np.testing.assert_array_equal(
        slicers.slice_bits_dynamic(torch.from_numpy(m), torch.from_numpy(z),
                                   max_bits=5).numpy(),
        np.asarray(jslicers.slice_bits_dynamic(jnp.asarray(m),
                                               jnp.asarray(z), max_bits=5)))
    s_flat = (rng.standard_normal((3, 40 * 8)) + 1j
              * rng.standard_normal((3, 40 * 8))).astype(np.complex64)
    w = rng.random((3, 30, 8)).astype(np.float32)
    w[:, :, 0] += 2.0                            # centroids near bin 0
    idx, sel = timing.select_decision_samples_interp(
        torch.from_numpy(s_flat), torch.from_numpy(w), 8)
    jidx, jsel = jtiming.select_decision_samples_interp(
        jnp.asarray(s_flat), jnp.asarray(w), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(sel.numpy(), np.asarray(jsel), atol=1e-5)


def test_carry_converters_match_jax():
    """full_from_ff with the raw window, ff_from_full filtering it back
    (with the raw filter tail), and the int16 window converters."""
    kw = CFG3
    jcfg, cfg = JaxDemodConfig(**kw), DemodConfig(**kw)
    jst, st, _ = _jax_carry(kw, _shaped(jcfg, 300, seed0=3))
    got = interop.ff_state_to_numpy(full.ff_from_full(cfg, st))
    want = _np(to_host(jfull.ff_from_full(jcfg, jst)))
    for f in want:
        np.testing.assert_allclose(got[f], want[f], atol=1e-6, err_msg=f)
    assert got["mf_tail"].shape == (C, 64)
    q = full.quantize_full_state(st, 1e-4)
    jq = jfull.quantize_full_state(jst, 1e-4)
    np.testing.assert_array_equal(q.win_re.numpy(), np.asarray(jq.win_re))
    np.testing.assert_array_equal(
        full.dequantize_full_state(q, 1e-4).win_im.numpy(),
        np.asarray(jfull.dequantize_full_state(jq, 1e-4).win_im))
    with pytest.raises(ValueError, match="raw_win"):
        full.full_from_ff(cfg, full.ff_from_full(cfg, st))
    with pytest.raises(ValueError, match="dequantize"):
        full.ff_from_full(cfg, q)


def _run_config3(eng, re, im, block, n_blocks):
    out = []
    for b in range(n_blocks):
        eng.push_planes(re[b * block:(b + 1) * block],
                        im[b * block:(b + 1) * block])
        out.append(eng.step())
    eng.push_planes(re[n_blocks * block:], im[n_blocks * block:])
    out.append(eng.flush())
    return out


def test_config3_engine_int16_matches_jax(tmp_path):
    """BASELINE config 3 through FullKernelBatchEngine on int16 wire planes
    from NativePlaneBank("i16"), against the JAX engine (interpret=True)
    fed the same planes: valid symbols within 5e-3, bits and sample index
    equal; the window carry stays int16; the flush masks the last
    ceil(64/8) symbols; then an int16 checkpoint saved mid-stream restores
    into a fresh engine that continues bit-equal."""
    block = 128
    xs = _shaped(JaxDemodConfig(**CFG3), 4 * block + 40, seed0=400)
    re, im, scale, _ = _wire(xs)
    bank = NativePlaneBank(C, capacity_samples=re.shape[0] + 8, dtype="i16")
    pairs = np.stack([re, im], -1)               # (T, C, 2) interleaved
    assert not bank.push_interleaved(pairs)
    p_re, p_im, flushed = bank.pop_planes(re.shape[0], timeout=0)
    bank.close()
    assert not flushed and p_re.dtype == np.int16
    np.testing.assert_array_equal(p_re, re)
    np.testing.assert_array_equal(p_im, im)
    eng = FullKernelBatchEngine(DemodConfig(**CFG3), C, block_symbols=block,
                                ingest_scale=scale, device="cpu")
    jeng = JaxFullKernelBatchEngine(JaxDemodConfig(**CFG3), C,
                                    block_symbols=block, s_tile=128,
                                    interpret=True, ingest_scale=scale)
    n = block * SPS
    got = _run_config3(eng, p_re, p_im, n, 4)
    want = _run_config3(jeng, re, im, n, 4)
    assert eng.steady and eng.full_state.win_re.dtype == torch.int16
    assert eng.full_state.win_re.shape == (49 * 8 + 64, C)
    for g, w in zip(got, want):
        v = np.asarray(w.valid)
        np.testing.assert_array_equal(g.valid.numpy(), v)
        np.testing.assert_allclose(g.soft.numpy()[v], np.asarray(w.soft)[v],
                                   atol=5e-3)
        np.testing.assert_array_equal(g.bits.numpy()[v],
                                      np.asarray(w.bits)[v])
        np.testing.assert_array_equal(g.sample_index.numpy()[v],
                                      np.asarray(w.sample_index)[v])
    assert int(got[-1].valid[0].sum()) == 40 - 8

    # Checkpoint mid-stream (int16 window), restore, continue: equal.
    a = FullKernelBatchEngine(DemodConfig(**CFG3), C, block_symbols=block,
                              ingest_scale=scale, device="cpu")
    for b in range(2):
        a.push_planes(re[b * n:(b + 1) * n], im[b * n:(b + 1) * n])
        a.step()
    path = os.path.join(tmp_path, "i16.npz")
    checkpoint.save_state(path, a.full_state, DemodConfig(**CFG3))
    state, cfg_l, _ = checkpoint.load_state(path, "cpu")
    jstate, _, _ = jckpt.load_state(path)          # the JAX side reads it
    assert state.win_re.dtype == torch.int16
    assert np.asarray(jstate.win_re).dtype == np.int16
    b_eng = FullKernelBatchEngine(cfg_l, C, block_symbols=block,
                                  ingest_scale=scale, device="cpu")
    b_eng.restore_full_state(state)
    a.push_planes(re[2 * n:3 * n], im[2 * n:3 * n])
    b_eng.push_planes(re[2 * n:3 * n], im[2 * n:3 * n])
    oa, ob = a.step(), b_eng.step()
    assert torch.equal(oa.soft, ob.soft) and torch.equal(oa.bits, ob.bits)


def test_config3_engine_configure_mid_stream_matches_jax():
    """configure on a matched-filter engine mid-stream: the raw window
    seeds the raw tail, the engine re-warms and hands back to the kernel
    without a gap, as the JAX engine does (5e-3)."""
    kw = dict(CFG3, num_avg=20, phase_avg=12, rrc_span=4)
    jcfg = JaxDemodConfig(**kw)
    xs = _shaped(jcfg, 6 * 128, seed0=500)
    eng = FullKernelBatchEngine(DemodConfig(**kw), C, block_symbols=128,
                                device="cpu")
    jeng = JaxFullKernelBatchEngine(jcfg, C, block_symbols=128, s_tile=128,
                                    interpret=True)
    for b, blk in enumerate(np.split(xs, 6, axis=1)):
        if b == 3:
            assert eng.steady and jeng.steady
            eng.configure(DemodConfig(**dict(kw, phase_avg=16)))
            jeng.configure(dataclasses.replace(jcfg, phase_avg=16))
            assert not eng.steady
            assert eng._raw_tail.shape == (C, 19 * 8 + 32)
        eng.push_planes(*_planes(blk))
        jeng.push_planes(np.ascontiguousarray(blk.real.T),
                         np.ascontiguousarray(blk.imag.T))
        o, jo = eng.step(), jeng.step()
        v = np.asarray(jo.valid)
        np.testing.assert_array_equal(o.valid.numpy(), v)
        np.testing.assert_allclose(o.soft.numpy()[v], np.asarray(jo.soft)[v],
                                   atol=5e-3)
    assert eng.steady and jeng.steady and bool(o.valid.all())


def test_int16_engine_contract():
    """An int16-ingest engine takes int16 planes only, an engine without
    ingest_scale no int16 planes, and an int16 window only restores into
    an int16-ingest engine."""
    cfg = DemodConfig(**CFG3)
    eng = FullKernelBatchEngine(cfg, C, ingest_scale=1e-4, device="cpu")
    z32 = np.zeros((64, C), np.float32)
    with pytest.raises(ValueError, match="int16"):
        eng.push_planes(z32, z32)
    with pytest.raises(ValueError, match="push_planes"):
        eng.push(0, np.zeros(8, np.complex64))
    plain = FullKernelBatchEngine(cfg, C, device="cpu")
    z16 = np.zeros((64, C), np.int16)
    with pytest.raises(ValueError, match="ingest_scale"):
        plain.push_planes(z16, z16)
    st = full.FullState(torch.zeros((49 * 8 + 64, C), dtype=torch.int16),
                        torch.zeros((49 * 8 + 64, C), dtype=torch.int16),
                        torch.zeros((demod_kernel.state_rows(40), C)))
    with pytest.raises(ValueError, match="ingest_scale"):
        plain.restore_full_state(st)
    eng.restore_full_state(st._replace(win_re=st.win_re.float(),
                                       win_im=st.win_im.float()))
    assert eng.full_state.win_re.dtype == torch.int16
    with pytest.raises(ValueError, match="finite"):
        FullKernelBatchEngine(cfg, C, ingest_scale=float("nan"),
                              device="cpu")
