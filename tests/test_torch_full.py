"""Port parity, steady kernel: psk_soft_tpu_torch/models/full and kernel
B1's plain version (ops/cuda/demod_kernel.demod_full_tm_ref) against the
JAX Pallas kernel run with interpret=True.

The JAX feed-forward warm-up converges; its carry crosses over through
utils/interop, and both steady paths run from the same carry.  Bounds are
tests/test_full_kernel.py's: bits and sample_index exact, phase 2e-3, soft
3e-3.  The Pallas kernel re-wraps the phase history about M*2pi at the end
of every TPU time tile, the port once per block, so phase and the carry's
phase rows are compared modulo M*2pi.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models import full as jax_full
from psk_soft_tpu.models.blockpsk import ff_init as jax_ff_init
from psk_soft_tpu.models.blockpsk import make_ff_demod_fn
from psk_soft_tpu.utils.transfer import to_host
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import blockpsk, full
from psk_soft_tpu_torch.ops.cuda import demod_kernel
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

PHASE_TOL, SOFT_TOL = 2e-3, 3e-3
C, NS = 128, 768


def _channels(m=4, diff=False, sps=8):
    """tests/test_full_kernel.py's fixture: a PSK impulse at sample 2 of
    every symbol, a small frequency offset, real noise; seed = channel."""
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, m, NS)
        pts = np.exp(2j * np.pi * j / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(NS * sps, np.complex64)
        x[2::sps] = pts * np.exp(2j * np.pi * 2e-4 * sps * np.arange(NS))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _setup(m=4, diff=False, sps=8):
    """Converged JAX warm-up; returns (cfg, jcfg, jax FFState, JAX
    FullState, the same carry as port tensors, run block (C, T))."""
    kw = dict(sps=sps, num_avg=50, constellation_size=m, phase_avg=20,
              differential=diff)
    cfg, jcfg = DemodConfig(**kw), JaxDemodConfig(**kw)
    xs = _channels(m, diff, sps)
    warm, run = np.split(xs, [256 * sps], axis=1)
    jff, _ = make_ff_demod_fn(jcfg, channels=C)(jax_ff_init(jcfg, (C,)),
                                                jnp.asarray(warm))
    jst = jax_full.full_from_ff(jcfg, jff)
    st = interop.full_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    return cfg, jcfg, jff, jst, st, run


def _planes(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real.T)),
            torch.from_numpy(np.ascontiguousarray(x.imag.T)))


def _wrapped(a, b, period):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d - period * np.round(d / period)).max()


def _assert_block(out, jout, m, soft_i8=False):
    jout = to_host(jout)
    np.testing.assert_array_equal(out.bits_packed.numpy(),
                                  np.asarray(jout.bits_packed))
    assert out.bits_packed.dtype == torch.int8          # pack_out default
    if soft_i8:
        assert out.soft_re.dtype == torch.int8
        for a, b in ((out.soft_re, jout.soft_re),
                     (out.soft_im, jout.soft_im)):
            assert np.abs(a.numpy().astype(int)
                          - np.asarray(b).astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(out.soft_re.numpy(),
                                   np.asarray(jout.soft_re), atol=SOFT_TOL)
        np.testing.assert_allclose(out.soft_im.numpy(),
                                   np.asarray(jout.soft_im), atol=SOFT_TOL)
    if jout.phase is None:
        assert out.phase is None and out.sample_index is None
    else:
        np.testing.assert_array_equal(out.sample_index.numpy(),
                                      np.asarray(jout.sample_index))
        assert _wrapped(out.phase.numpy(), jout.phase,
                        2 * np.pi * m) < PHASE_TOL


def _assert_planes(planes, jplanes, m):
    assert _wrapped(planes.numpy(), np.asarray(jplanes),
                    2 * np.pi * m) < PHASE_TOL


@pytest.mark.parametrize("m,diff,sps", [
    (4, False, 8), (2, False, 8), (8, False, 8), (4, True, 8),
    (16, False, 8),      # the generic M >= 8 slicer
    (4, False, 10),      # window (num_avg-1)*sps = 490 rows, not 8-aligned
])
def test_steady_kernel_matches_pallas(m, diff, sps):
    cfg, jcfg, _, jst, st, run = _setup(m, diff, sps)
    jnew, jout = jax_full.demod_block_full(
        jcfg, jst, jnp.asarray(run.real.T), jnp.asarray(run.imag.T),
        s_tile=128, interpret=True)
    new, out = full.demod_block_full(cfg, st, *_planes(run))
    _assert_block(out, jout, m)
    _assert_planes(new.planes, jnew.planes, m)
    np.testing.assert_array_equal(new.win_re.numpy(), np.asarray(jnew.win_re))


def test_full_from_ff_matches_jax():
    cfg, jcfg, jff, jst, _, _ = _setup()
    ff = interop.ff_state_from_numpy(
        {k: np.asarray(v) for k, v in to_host(jff)._asdict().items()}, "cpu")
    st = full.full_from_ff(cfg, ff)
    for f in st._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("mode", ["debug_off", "soft_i8"])
def test_steady_kernel_modes_match_pallas(mode):
    cfg, jcfg, _, jst, st, run = _setup()
    kw = (dict(debug_ports=False) if mode == "debug_off"
          else dict(soft_i8_scale=100.0))
    jnew, jout = jax_full.demod_block_full(
        jcfg, jst, jnp.asarray(run.real.T), jnp.asarray(run.imag.T),
        s_tile=128, interpret=True, **kw)
    new, out = full.demod_block_full(cfg, st, *_planes(run), **kw)
    _assert_block(out, jout, 4, soft_i8=mode == "soft_i8")
    _assert_planes(new.planes, jnew.planes, 4)
    do = full.to_demod_outputs(cfg, out, soft_i8_scale=kw.get(
        "soft_i8_scale"))
    jdo = to_host(jax_full.to_demod_outputs(jcfg, jout, soft_i8_scale=kw.get(
        "soft_i8_scale")))
    np.testing.assert_array_equal(do.bits.numpy(), np.asarray(jdo.bits))
    assert do.valid.all()
    if mode == "soft_i8":
        assert isinstance(do.soft, full.QuantSoft)
        host = full.QuantSoft(do.soft.re_q.numpy(), do.soft.im_q.numpy(),
                              do.soft.scale)
        np.testing.assert_allclose(full.dequantize_soft(host),
                                   jax_full.dequantize_soft(jdo.soft),
                                   atol=0.0101)
    else:
        assert do.phase is None and do.sample_index is None


def test_two_block_carry_matches_pallas():
    """Two consecutive blocks from one carry (tests/test_full_kernel.py:
    71-91): the port chain against the Pallas chain, and the port's split
    chain against its own single block."""
    cfg, jcfg, _, jst, st, run = _setup()
    halves = np.split(run, 2, axis=1)
    one_state, one = full.demod_block_full(cfg, st, *_planes(run))
    parts = []
    for half in halves:
        jst, jout = jax_full.demod_block_full(
            jcfg, jst, jnp.asarray(half.real.T), jnp.asarray(half.imag.T),
            s_tile=128, interpret=True)
        st, out = full.demod_block_full(cfg, st, *_planes(half))
        _assert_block(out, jout, 4)
        parts.append(out)
    _assert_planes(st.planes, jst.planes, 4)
    np.testing.assert_allclose(
        torch.cat([p.soft_re for p in parts]).numpy(), one.soft_re.numpy(),
        atol=1e-4)
    _assert_planes(st.planes, one_state.planes.numpy(), 4)


def test_rolling_is_the_same_launch():
    cfg, _, _, _, st, run = _setup()
    blocks = [_planes(b) for b in np.split(run, 4, axis=1)]
    legacy, rolling = [], []
    s = st
    for b in blocks:
        s, o = full.demod_block_full(cfg, s, *b)
        legacy.append(o)
    s2, o0 = full.demod_block_full(cfg, st, *blocks[0])
    rolling.append(o0)
    planes = s2.planes
    for i in range(1, 4):
        planes, o = full.demod_block_full_rolling(cfg, planes,
                                                  *blocks[i - 1], *blocks[i])
        rolling.append(o)
    for a, b in zip(legacy, rolling):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(s.planes, planes)


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes through the plain version; no kernel launch."""
    cfg, _, _, _, st, run = _setup()
    demod_kernel.demod_full_tm.launches = 0
    x_re, x_im = _planes(run)
    kw = dict(sps=8, num_avg=50, phase_avg=20, m=4, diff=False)
    got = demod_kernel.demod_full_tm(st.win_re, st.win_im, x_re, x_im,
                                     st.planes, **kw)
    ref = demod_kernel.demod_full_tm_ref(st.win_re, st.win_im, x_re, x_im,
                                         st.planes, **kw)
    assert demod_kernel.demod_full_tm.launches == 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[3].dtype == torch.int8 and got[4].dtype == torch.int8
    got32 = demod_kernel.demod_full_tm(st.win_re, st.win_im, x_re, x_im,
                                       st.planes, pack_out=False, **kw)
    assert got32[3].dtype == torch.int32
    assert torch.equal(got32[3].to(torch.int8), got[3])


@pytest.mark.parametrize("bad,match", [
    (dict(mf_taps=(1.0, 1.0)), None),
    (dict(timing_interp=True), None),
    (dict(mixed=True), None),
    (dict(in_scale=0.5), None),
    (dict(phase_avg=9), "phase_avg"),
    (dict(num_avg=1), "num_avg"),
    (dict(sps=1), "sps"),
    (dict(m=3), "constellation"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    """The wrapper refuses what the kernel does not take; every mode of
    the Pallas kernel (match None) it takes: a matched filter (its window
    then carries len(taps)-1 more raw rows), timing_interp, mixed modes
    (from the carry's mode rows) and int16 planes, each run here equal to
    the plain version."""
    kw = dict(sps=8, num_avg=50, phase_avg=20, m=4, diff=False)
    kw.update(bad)
    rows = demod_kernel.state_rows(max(kw["phase_avg"], 1))
    z = torch.zeros((64, 128))
    extra = len(kw.get("mf_taps") or (1,)) - 1
    win = torch.zeros(((kw["num_avg"] - 1) * kw["sps"] + extra, 128))
    st = torch.zeros((rows, 128))
    if match is not None:
        with pytest.raises(ValueError, match=match):
            demod_kernel.demod_full_tm(win, win, z, z, st, **kw)
        return
    gen = torch.Generator().manual_seed(5)
    win, z = torch.randn(win.shape, generator=gen), torch.randn(
        z.shape, generator=gen)
    if "in_scale" in kw:
        win, z = (win * 1000).to(torch.int16), (z * 1000).to(torch.int16)
    if kw.get("mixed"):
        misc = kw["phase_avg"] - 1 + 16
        st[misc + 6] = 8.0                      # M per channel
        st[misc + 7, ::2] = 1.0                 # differential
    got = demod_kernel.demod_full_tm(win, win, z, z, st, **kw)
    ref = demod_kernel.demod_full_tm_ref(win, win, z, z, st, **kw)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert got[5].shape == (rows, 128) and bool(got[0].isfinite().all())


def test_wrapper_rejects_bad_shapes():
    kw = dict(sps=8, num_avg=50, phase_avg=20, m=4, diff=False)
    rows = demod_kernel.state_rows(20)
    win = torch.zeros((49 * 8, 128))
    z = torch.zeros((64, 128))
    st = torch.zeros((rows, 128))
    with pytest.raises(ValueError, match="x planes"):
        demod_kernel.demod_full_tm(win, win, z[:60], z[:60], st, **kw)
    with pytest.raises(ValueError, match="win planes"):
        demod_kernel.demod_full_tm(win[:8], win[:8], z, z, st, **kw)
    with pytest.raises(ValueError, match="state_planes"):
        demod_kernel.demod_full_tm(win, win, z, z, st[:8], **kw)
    with pytest.raises(ValueError, match="float32"):
        demod_kernel.demod_full_tm(win, win, z.double(), z.double(), st,
                                   **kw)
    with pytest.raises(ValueError, match="int16"):
        demod_kernel.demod_full_tm(win, win, z.to(torch.int16),
                                   z.to(torch.int16), st, **kw)
    assert demod_kernel.state_rows(20) == 48


def test_full_from_ff_guards():
    cfg = DemodConfig(sps=8, num_avg=50, phase_avg=5)
    with pytest.raises(ValueError, match="phase_avg"):
        full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, "cpu"))
    # A matched filter needs the raw window (the FF carry holds filtered
    # samples): full_from_ff takes it, with mf_ntaps-1 more rows.
    cfg = DemodConfig(sps=8, num_avg=50, phase_avg=20, matched_filter="rrc")
    with pytest.raises(ValueError, match="raw_win"):
        full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, "cpu"))
    raw = torch.ones((C, full.window_rows(cfg)), dtype=torch.complex64)
    st = full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, "cpu"), raw_win=raw)
    assert st.win_re.shape == (49 * 8 + 64, C) and bool(st.win_re.eq(1).all())
    cfg = DemodConfig(sps=8, num_avg=50, phase_avg=20)
    st = full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, "cpu"))
    z = torch.zeros((8 * 8, C))
    with pytest.raises(ValueError, match="block must be"):
        full.demod_block_full(cfg, st, z, z)
