"""Port parity, exact-scan path: psk_soft_tpu_torch's ops/linear_fit ring
fit, ops/phase.unwrap_step, state.reconfigure, models/psk (the exact scan,
batched and one chain) and the numpy testing modules (signals, oracle)
against the JAX package on the same numpy inputs; then the six golden
scenarios and the oracle parity through the port alone.

Tolerances: bits, sample index, valid and the integer carry fields equal;
soft and phase within 2e-3, the JAX package's own tolerance for the exact
scan against the oracle (tests/test_oracle_parity.py:45-47); reconfigure
and the testing modules bit-equal (both are the same numpy code).  The
parity signals have a decisive timing peak (all energy on one sample of
each symbol): on the golden vectors' rectangular pulses every sample of a
symbol ties up to 1e-4 noise, and the two packages' windowed sums may
break such a tie differently (tests/test_golden.py:107-116), so the golden
scenarios are held against the transmitted symbols instead.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psk_soft_tpu as jpst
from psk_soft_tpu import state as jstate
from psk_soft_tpu.ops import linear_fit as jlinear_fit
from psk_soft_tpu.ops import phase as jphase
from psk_soft_tpu.testing import oracle as joracle
from psk_soft_tpu.testing import signals as jsignals
from psk_soft_tpu.utils.transfer import to_host
import psk_soft_tpu_torch as pst
from psk_soft_tpu_torch.ops import linear_fit, phase
from psk_soft_tpu_torch.testing import oracle, signals
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

TOL = 2e-3          # soft and phase (tests/test_oracle_parity.py:45-47)
INT_FIELDS = ("seen", "ring_pos", "ring_fill")


def decisive(nsym, sps, m, seed, diff=False, foff=0.0, peak=5, n_ch=1,
             pulse="impulse"):
    """(n_ch, nsym*sps) complex64: PSK symbols with all energy on sample
    ``peak`` of each symbol (or RRC-shaped), a frequency offset of
    ``foff`` cycles/sample and real noise of std 0.02; channel i draws
    from seed + i (tests/test_oracle_parity.py's fixture)."""
    out = np.empty((n_ch, nsym * sps), np.complex64)
    for i in range(n_ch):
        rng = np.random.default_rng(seed + i)
        pts = np.exp(2j * np.pi * rng.integers(0, m, nsym) / m)
        if diff:
            pts = np.cumprod(pts)
        if pulse == "rrc":
            x, _ = signals.gen_psk_channel(nsym, sps, m, seed=seed + i,
                                           pulse="rrc", freq_offset=foff)
        else:
            x = np.zeros(nsym * sps, np.complex128)
            x[peak::sps] = pts * np.exp(2j * np.pi * foff * sps
                                        * np.arange(nsym))
        out[i] = x + 0.02 * rng.standard_normal(x.size)
    return out


def assert_outputs(got, ref, nb):
    """Port DemodOutputs against JAX ones of the same shape."""
    ref = to_host(ref)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.sample_index.numpy(),
                                  np.asarray(ref.sample_index))
    np.testing.assert_array_equal(got.bits.numpy()[..., :nb],
                                  np.asarray(ref.bits)[..., :nb])
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(ref.phase),
                               atol=TOL)
    np.testing.assert_allclose(got.soft.numpy(), np.asarray(ref.soft),
                               atol=TOL)


def assert_states(got, ref):
    ref = to_host(ref)
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=TOL, err_msg=f)


def to_port_state(jst):
    return interop.demod_state_from_numpy(
        {k: np.asarray(v) for k, v in to_host(jst)._asdict().items()}, "cpu")


# ------------------------------------------------------------ primitives


@pytest.mark.parametrize("n", [1, 2, 7, 50])
def test_ring_fit_matches_jax(n):
    """Random rings at every pos/fill: ring_rank and denominator equal,
    the fit within 1e-5 relative (float32 sums in another order)."""
    rng = np.random.default_rng(n)
    C = 64
    ring = (rng.standard_normal((C, n)) * 20).astype(np.float32)
    pos = rng.integers(0, n, C).astype(np.int32)
    fill = rng.integers(0, n + 1, C).astype(np.int32)
    fill[:2] = (0, n)
    newest = rng.standard_normal(C).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        linear_fit.ring_rank(n, t(pos)[:, None], t(fill)[:, None]).numpy(),
        np.asarray(jlinear_fit.ring_rank(n, jnp.asarray(pos)[:, None],
                                         jnp.asarray(fill)[:, None])))
    np.testing.assert_array_equal(
        linear_fit.denominator(t(fill)).numpy(),
        np.asarray(jlinear_fit.denominator(jnp.asarray(fill))))
    got = linear_fit.ring_fit(t(ring), t(pos), t(fill), t(newest)).numpy()
    ref = np.asarray(jlinear_fit.ring_fit(*map(jnp.asarray,
                                               (ring, pos, fill, newest))))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_unwrap_step_matches_jax():
    """Bit-equal, half-turn ties included (both round half to even)."""
    rng = np.random.default_rng(3)
    est = (rng.standard_normal(4096) * 60).astype(np.float32)
    raw = rng.uniform(-np.pi, np.pi, 4096).astype(np.float32)
    pi = np.float32(np.pi)
    est[:2] = (pi, -pi)            # (est - raw) / 2pi = +-1/2 exactly
    raw[:2] = 0.0
    got = phase.unwrap_step(torch.from_numpy(est),
                            torch.from_numpy(raw)).numpy()
    ref = np.asarray(jphase.unwrap_step(jnp.asarray(est), jnp.asarray(raw)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:2], [0.0, 0.0])   # ties to even


# ------------------------------------------------------------ exact scan

CASES = [
    # (m, differential, foff, matched filter, blocks)
    (2, False, 0.0, "none", 1),
    (4, False, 1e-4, "none", 1),
    (8, False, 0.0, "none", 1),
    (2, True, 0.0, "none", 1),
    (4, True, 0.0, "none", 1),
    (8, True, 0.0, "none", 1),
    (4, False, 1e-4, "none", 2),
    (4, False, 1e-4, "none", 5),
    (8, True, 2e-4, "none", 10),
    (4, False, 0.0, "rrc", 1),
    (4, False, 5e-5, "rrc", 5),
]


@pytest.mark.parametrize("m,diff,foff,mf,blocks", CASES,
                         ids=[f"M{c[0]}{'d' if c[1] else ''}-f{c[2]}-{c[3]}"
                              f"-x{c[4]}" for c in CASES])
def test_demod_block_matches_jax(m, diff, foff, mf, blocks):
    """Batched (C = 4) and one chain, block by block: outputs and the
    carry after every block."""
    kw = dict(sps=8, num_avg=30, constellation_size=m, phase_avg=15,
              differential=diff, matched_filter=mf)
    cfg, jcfg = pst.DemodConfig(**kw), jpst.DemodConfig(**kw)
    nsym, C = 400, 4
    x = decisive(nsym, 8, m, seed=10 * m + blocks, diff=diff, foff=foff,
                 n_ch=C, pulse="rrc" if mf == "rrc" else "impulse")
    nb = cfg.bits_per_symbol
    fn, jfn = pst.make_demod_fn(cfg, C), jpst.make_demod_fn(jcfg, C)
    st, jst = pst.demod_init(cfg, C, "cpu"), jpst.demod_init(jcfg, C)
    one, jone = pst.make_demod_fn(cfg), jpst.make_demod_fn(jcfg)
    st1, jst1 = pst.demod_init(cfg, device="cpu"), jpst.demod_init(jcfg)
    for blk in np.split(x, blocks, axis=1):
        st, out = fn(st, blk)
        jst, jout = jfn(jst, jnp.asarray(blk))
        assert_outputs(out, jout, nb)
        assert_states(st, jst)
        st1, out1 = one(st1, blk[0])
        jst1, jout1 = jone(jst1, jnp.asarray(blk[0]))
        assert out1.soft.shape == (blk.shape[1] // 8,)
        assert_outputs(out1, jout1, nb)
        assert_states(st1, jst1)
    assert int(out.valid.sum()) > 0


def test_demod_fn_input_rules():
    """numpy blocks are copied to the state's device; a tensor elsewhere,
    a block of the wrong shape or length raises."""
    cfg = pst.DemodConfig(sps=4, num_avg=5, constellation_size=2,
                          phase_avg=4)
    st = pst.demod_init(cfg, device="cpu")
    assert st.seen.shape == () and st.ring.shape == (4,)
    fn = pst.make_demod_fn(cfg)
    st2, out = fn(st, np.ones(40, np.complex128))
    assert out.soft.dtype == torch.complex64 and out.soft.shape == (10,)
    with pytest.raises(ValueError, match="multiple of sps"):
        fn(st, np.ones(41, np.complex64))
    with pytest.raises(ValueError, match=r"\(T,\) block"):
        fn(st, np.ones((2, 40), np.complex64))
    with pytest.raises(ValueError, match=r"\(3, T\) block"):
        pst.make_demod_fn(cfg, 3)(pst.demod_init(cfg, 3, "cpu"),
                                  np.ones((2, 40), np.complex64))
    meta = torch.ones(40, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="is on meta"):
        fn(st, meta)


# ------------------------------------------------------------ reconfigure

RECONF = {
    "sps": dict(sps=4),
    "num_avg_shrink": dict(num_avg=18),
    "num_avg_grow": dict(num_avg=45),
    "phase_avg_shrink": dict(phase_avg=9),
    "phase_avg_grow": dict(phase_avg=24),
    "m": dict(constellation_size=8),
    "rrc_on": dict(matched_filter="rrc"),
}


@pytest.mark.parametrize("change", sorted(RECONF))
@pytest.mark.parametrize("batched", [False, True])
def test_reconfigure_matches_jax(change, batched):
    """The same carry (the JAX one after 70 symbols, mid ring wrap)
    through both reconfigure functions: numpy outputs bit-equal."""
    kw = dict(sps=8, num_avg=30, constellation_size=4, phase_avg=15)
    old_j = jpst.DemodConfig(**kw)
    new_kw = dict(kw, **RECONF[change])
    C = 3 if batched else None
    x = decisive(70, 8, 4, seed=5, n_ch=3, foff=1e-4)
    jst = jpst.demod_init(old_j, C)
    jst, _ = jpst.make_demod_fn(old_j, C)(jst, jnp.asarray(
        x if batched else x[0]))
    got = pst.reconfigure(pst.DemodConfig(**kw), pst.DemodConfig(**new_kw),
                          to_port_state(jst))
    ref = to_host(jstate.reconfigure(old_j, jpst.DemodConfig(**new_kw), jst))
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ------------------------------------------------------------ testing/

@pytest.mark.parametrize("m,diff,n", [(2, False, 300), (4, False, 1000),
                                      (8, True, 257), (4, True, 64)])
def test_gen_psk_is_the_jax_one(m, diff, n):
    for seed in (100, 7):
        a = signals.gen_psk(n, 8, m, differential=diff, seed=seed)
        b = jsignals.gen_psk(n, 8, m, differential=diff, seed=seed)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("kw", [
    dict(m=4), dict(m=8, differential=True, snr_db=12.0),
    dict(m=2, freq_offset=1e-3, phase_offset=0.3, timing_offset=3),
    dict(m=4, pulse="rrc", rrc_beta=0.25, rrc_span=6, snr_db=20.0)])
def test_gen_psk_channel_is_the_jax_one(kw):
    a = signals.gen_psk_channel(200, sps=8, seed=9, **kw)
    b = jsignals.gen_psk_channel(200, sps=8, seed=9, **kw)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    t = np.linspace(60.0, 1400.0, 23)
    np.testing.assert_array_equal(signals.sinc_interp(a[0], t),
                                  jsignals.sinc_interp(b[0], t))


@pytest.mark.parametrize("m,diff", [(2, False), (4, True), (8, False)])
def test_oracle_is_the_jax_one(m, diff):
    x = decisive(150, 6, m, seed=m, diff=diff, peak=2)[0]
    a = oracle.demod_reference(x, 6, 20, m, 12, differential=diff,
                               sample_rate=3.0)
    b = joracle.demod_reference(x, 6, 20, m, 12, differential=diff,
                                sample_rate=3.0)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    f, g = oracle.LinearFitRef(7, 2.0), joracle.LinearFitRef(7, 2.0)
    ys = np.random.default_rng(1).standard_normal(30)
    assert [f.next(y) for y in ys] == [g.next(y) for y in ys]
    assert f.reset(num_pts=4) == g.reset(num_pts=4)
    assert f.subtract_const(1.5) == g.subtract_const(1.5)


# ------------------------------------------------------------ golden / oracle

def run_golden(m, differential, num_blocks=1):
    cfg = pst.DemodConfig(sps=8, num_avg=100, constellation_size=m,
                          phase_avg=50, differential=differential)
    x, syms = signals.gen_psk(1000, 8, m, differential=differential)
    fn = pst.make_demod_fn(cfg)
    st = pst.demod_init(cfg, device="cpu")
    outs = []
    for blk in np.split(x, num_blocks):
        st, out = fn(st, blk)
        outs.append(out)
    valid = torch.cat([o.valid for o in outs]).numpy()
    soft = torch.cat([o.soft for o in outs]).numpy()[valid]
    bits = torch.cat([o.bits for o in outs]).numpy()[valid]
    return cfg, soft, bits, syms


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("differential", [False, True])
def test_golden_scenarios(m, differential):
    """tests/test_golden.py through the port: 901 outputs, max soft error
    under 1e-3 (modulo the M rotations when not differential; symbol 0
    excluded), bits exact where the rotation is known (differential)."""
    cfg, soft, bits, syms = run_golden(m, differential,
                                       num_blocks=5 if m == 4 else 1)
    assert soft.shape[0] == 1000 - 99
    expected = syms[:soft.shape[0]]
    if differential:
        rot = np.exp(1j * np.pi / 4) if m == 4 else 1.0
        assert np.abs(soft[1:] - expected[1:] * rot).max() < 1e-3
        # Transmitted symbol exp(2pi*i*j/m): recover j, map per the SCD.
        j = np.round(np.angle(expected) / (2 * np.pi / m)).astype(int) % m
        if m == 2:
            exp_bits = j[:, None]
        elif m == 4:
            ang = 2 * np.pi * j / 4 + np.pi / 4
            sr = (np.cos(ang) < 0).astype(int)
            si = (np.sin(ang) < 0).astype(int)
            exp_bits = np.stack([sr ^ si, si], axis=1)
        else:
            exp_bits = np.stack([(j >> k) & 1 for k in range(3)], axis=1)
        nb = cfg.bits_per_symbol
        np.testing.assert_array_equal(bits[1:, :nb], exp_bits[1:, :nb])
    else:
        thetas = [k * 2 * np.pi / m + (np.pi / 4 if m == 4 else 0)
                  for k in range(m)]
        err = min(np.abs(soft[1:] * np.exp(1j * t) - expected[1:]).max()
                  for t in thetas)
        assert err < 1e-3


@pytest.mark.parametrize("m,diff,foff", [(2, False, 0.0), (4, False, 1e-4),
                                         (8, False, 0.0), (4, True, 0.0)])
def test_exact_scan_matches_port_oracle(m, diff, foff):
    """tests/test_oracle_parity.py:27-47 with the port's oracle: sample
    index equal, soft and phase within 2e-3."""
    sps, num_avg, phase_avg, nsym = 8, 30, 15, 300
    x = decisive(nsym, sps, m, seed=m, diff=diff, foff=foff)[0]
    ref = oracle.demod_reference(x, sps, num_avg, m, phase_avg,
                                 differential=diff)
    cfg = pst.DemodConfig(sps=sps, num_avg=num_avg, constellation_size=m,
                          phase_avg=phase_avg, differential=diff)
    _, out = pst.make_demod_fn(cfg)(pst.demod_init(cfg, device="cpu"), x)
    v = out.valid.numpy()
    assert v.sum() == ref["soft"].size == nsym - (num_avg - 1)
    np.testing.assert_array_equal(out.sample_index.numpy()[v],
                                  ref["sample_index"])
    np.testing.assert_allclose(out.phase.numpy()[v], ref["phase"], atol=TOL)
    np.testing.assert_allclose(out.soft.numpy()[v], ref["soft"], atol=TOL)


def test_config_fields_cross():
    """The port's DemodConfig takes the JAX one's fields unchanged."""
    jcfg = jpst.DemodConfig(sps=10, num_avg=40, constellation_size=8,
                            phase_avg=20, matched_filter="rrc",
                            timing_interp=True)
    assert interop.config_from_jax_dict(dataclasses.asdict(jcfg)) == \
        pst.DemodConfig(**dataclasses.asdict(jcfg))
