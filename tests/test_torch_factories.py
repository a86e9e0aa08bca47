"""Port parity, step factories and transfer helpers: the port's
models/blockpsk.make_ff_demod_fn / make_scanned_ff_demod_fn against the JAX
ones (bits, validity and sample index equal, soft and phase within 1e-4,
tests/test_torch_blockpsk.py's bounds), models/full.make_full_demod_fn,
make_mixed_full_demod_fn and make_scanned_full_demod_fn against the JAX
ones with the Pallas kernel in interpret mode (bits and sample index
exact, soft 3e-3, phase 2e-3 modulo M*2pi, tests/test_full_kernel.py:60-68),
the scanned full step equal to its per-block calls, and utils/transfer's
round trips."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models import blockpsk as jax_blockpsk
from psk_soft_tpu.models import full as jax_full
from psk_soft_tpu.models import mixed as jax_mixed
from psk_soft_tpu.utils.transfer import to_host as jax_to_host
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import blockpsk, full, mixed
from psk_soft_tpu_torch.utils import interop, transfer

torch.set_num_threads(1)

FF_TOL = 1e-4
PHASE_TOL, SOFT_TOL = 2e-3, 3e-3
C, NS, SPS = 128, 512, 8


def _channels(n_ch, m=4, ns=NS, sps=SPS, seed=0):
    """A PSK impulse at sample 2 of every symbol, a small frequency offset,
    real noise; seed = seed + channel."""
    out = []
    for i in range(n_ch):
        rng = np.random.default_rng(seed + i)
        pts = np.exp(2j * np.pi * rng.integers(0, m, ns) / m)
        x = np.zeros(ns * sps, np.complex64)
        x[2::sps] = pts * np.exp(2j * np.pi * 2e-4 * sps * np.arange(ns))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _configs(**kw):
    return DemodConfig(**kw), JaxDemodConfig(**kw)


def _assert_ff(out, jout, nb):
    jout = jax_to_host(jout)
    np.testing.assert_array_equal(out.valid.numpy(), jout.valid)
    np.testing.assert_array_equal(out.sample_index.numpy(),
                                  jout.sample_index)
    np.testing.assert_array_equal(out.bits.numpy()[..., :nb],
                                  jout.bits[..., :nb])
    np.testing.assert_allclose(out.phase.numpy(), jout.phase, atol=FF_TOL)
    np.testing.assert_allclose(out.soft.numpy(), jout.soft, atol=FF_TOL)


def _assert_ff_state(st, jst):
    for f in st._fields:
        a, b = getattr(st, f).numpy(), np.asarray(getattr(jst, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=FF_TOL, err_msg=f)


@pytest.mark.parametrize("channels", [None, 4])
def test_ff_factory_matches_jax(channels):
    cfg, jcfg = _configs(sps=SPS, num_avg=50, constellation_size=4,
                         phase_avg=20)
    xs = _channels(channels or 1)
    if channels is None:
        xs = xs[0]
    fn = blockpsk.make_ff_demod_fn(cfg, channels)
    jfn = jax_blockpsk.make_ff_demod_fn(jcfg, channels)
    st = blockpsk.ff_init(cfg, channels, "cpu")
    jst = jax_blockpsk.ff_init(jcfg, () if channels is None else (channels,))
    assert st.seen.shape == jst.seen.shape
    for blk in np.split(xs, [100 * SPS, 300 * SPS], axis=-1):
        st, out = fn(st, blk)                     # numpy in, as JAX takes
        jst, jout = jfn(jst, jnp.asarray(blk))
        _assert_ff(out, jout, 2)
    _assert_ff_state(st, jst)
    steady = blockpsk.make_ff_demod_fn(cfg, channels, assume_steady=True)
    jsteady = jax_blockpsk.make_ff_demod_fn(jcfg, channels,
                                            assume_steady=True)
    blk = xs[..., :128 * SPS]
    st, out = steady(st, torch.from_numpy(blk))
    jst, jout = jsteady(jst, jnp.asarray(blk))
    _assert_ff(out, jout, 2)
    with pytest.raises(ValueError):
        fn(st, xs[None] if channels is None else xs[:2])


@pytest.mark.parametrize("channels", [None, 4])
def test_scanned_ff_factory_matches_jax(channels):
    cfg, jcfg = _configs(sps=SPS, num_avg=50, constellation_size=8,
                         phase_avg=20)
    xs = _channels(channels or 1, m=8, ns=4 * 64)
    xs = np.stack(np.split(xs if channels else xs[0], 4, axis=-1))
    st, out = blockpsk.make_scanned_ff_demod_fn(cfg, channels)(
        blockpsk.ff_init(cfg, channels, "cpu"), xs)
    jst, jout = jax_blockpsk.make_scanned_ff_demod_fn(jcfg, channels)(
        jax_blockpsk.ff_init(jcfg, () if channels is None else (channels,)),
        jnp.asarray(xs))
    assert out.soft.shape == jout.soft.shape
    _assert_ff(out, jout, 3)
    _assert_ff_state(st, jst)


def _full_setup(m=4, ns=NS):
    """Converged JAX warm-up, handed over to both packages' full carry."""
    cfg, jcfg = _configs(sps=SPS, num_avg=50, constellation_size=m,
                         phase_avg=20)
    xs = _channels(C, m, ns)
    warm, run = np.split(xs, [256 * SPS], axis=1)
    jff, _ = jax_blockpsk.make_ff_demod_fn(jcfg, channels=C)(
        jax_blockpsk.ff_init(jcfg, (C,)), jnp.asarray(warm))
    jst = jax_full.full_from_ff(jcfg, jff)
    st = interop.full_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    return cfg, jcfg, jst, st, run


def _tm(x):
    return np.ascontiguousarray(x.real.T), np.ascontiguousarray(x.imag.T)


def _wrapped(a, b, period):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d - period * np.round(d / period)).max()


def _assert_full(out, jout, m):
    jout = jax_to_host(jout)
    np.testing.assert_array_equal(out.bits_packed.numpy(), jout.bits_packed)
    np.testing.assert_array_equal(out.sample_index.numpy(),
                                  jout.sample_index)
    np.testing.assert_allclose(out.soft_re.numpy(), jout.soft_re,
                               atol=SOFT_TOL)
    np.testing.assert_allclose(out.soft_im.numpy(), jout.soft_im,
                               atol=SOFT_TOL)
    assert _wrapped(out.phase.numpy(), jout.phase, 2 * np.pi * m) < PHASE_TOL


def test_full_factory_matches_jax():
    cfg, jcfg, jst, st, run = _full_setup()
    re, im = _tm(run)
    new, out = full.make_full_demod_fn(cfg)(st, torch.from_numpy(re),
                                            torch.from_numpy(im))
    jnew, jout = jax_full.make_full_demod_fn(jcfg, s_tile=128,
                                             interpret=True)(
        jst, jnp.asarray(re), jnp.asarray(im))
    _assert_full(out, jout, 4)
    assert _wrapped(new.planes.numpy(), jnew.planes, 8 * np.pi) < PHASE_TOL
    # int8 soft planes and int16 bits: the options reach the kernel.
    _, q = full.make_full_demod_fn(cfg, soft_i8_scale=100.0, pack_out=False)(
        st, torch.from_numpy(re), torch.from_numpy(im))
    assert q.soft_re.dtype == torch.int8 and q.bits_packed.dtype != torch.int8
    np.testing.assert_array_equal(q.bits_packed.numpy(),
                                  out.bits_packed.numpy())


def test_scanned_full_factory_matches_jax_and_per_block_calls():
    cfg, jcfg, jst, st, run = _full_setup(m=8, ns=256 + 3 * 128)
    blocks = [_tm(b) for b in np.split(run, 3, axis=1)]
    xs_re = np.stack([b[0] for b in blocks])
    xs_im = np.stack([b[1] for b in blocks])
    new, out = full.make_scanned_full_demod_fn(cfg)(
        st, torch.from_numpy(xs_re), torch.from_numpy(xs_im))
    jnew, jout = jax_full.make_scanned_full_demod_fn(jcfg, s_tile=128,
                                                     interpret=True)(
        jst, jnp.asarray(xs_re), jnp.asarray(xs_im))
    assert out.soft_re.shape == (3, 128, C)
    _assert_full(out, jout, 8)
    one = st
    for k, (re, im) in enumerate(blocks):
        one, o = full.demod_block_full(cfg, one, torch.from_numpy(re),
                                       torch.from_numpy(im))
        for a, b in zip(o, out):
            assert torch.equal(a, b[k])
    for a, b in zip(one, new):
        assert torch.equal(a, b)


def test_mixed_full_factory_matches_jax():
    cfg, jcfg = _configs(sps=SPS, num_avg=50, constellation_size=4,
                         phase_avg=20)
    rng = np.random.default_rng(4)
    ms = rng.choice([2, 4, 8], C)
    diffs = rng.random(C) < 0.5
    xs = np.stack([_channels(1, int(ms[c]), seed=c)[0] for c in range(C)])
    warm, run = np.split(xs, [256 * SPS], axis=1)
    jp = jax_mixed.MixedParams.make(ms, diffs)
    jff, _ = jax_mixed.make_mixed_demod_fn(jcfg)(
        jp, jax_mixed.mixed_init(jcfg, C), jnp.asarray(warm))
    jst = jax_full.full_from_ff(jcfg, jff, mixed_params=jp)
    st = interop.full_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    re, im = _tm(run)
    _, out = full.make_mixed_full_demod_fn(cfg)(st, torch.from_numpy(re),
                                                torch.from_numpy(im))
    _, jout = jax_full.make_mixed_full_demod_fn(jcfg, s_tile=128,
                                                interpret=True)(
        jst, jnp.asarray(re), jnp.asarray(im))
    _assert_full(out, jout, 8)
    assert mixed.MixedParams.make(ms, diffs, "cpu").max_bits == 3


@pytest.mark.parametrize("factory", ["make_full_demod_fn",
                                     "make_mixed_full_demod_fn",
                                     "make_scanned_full_demod_fn"])
@pytest.mark.parametrize("tpu_arg", ["s_tile", "interpret", "jit"])
def test_full_factories_take_no_tpu_arguments(factory, tpu_arg):
    """A named divergence (ROADMAP C): the Pallas tiling, interpret mode
    and jit have no counterpart; passing one is a TypeError."""
    cfg = DemodConfig(sps=SPS, num_avg=50, constellation_size=4,
                      phase_avg=20)
    with pytest.raises(TypeError):
        getattr(full, factory)(cfg, **{tpu_arg: 256 if tpu_arg == "s_tile"
                                       else True})


@dataclasses.dataclass(frozen=True)
class _Box:
    a: object
    b: object = None


def test_transfer_round_trips():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5)) + 1j * rng.standard_normal((3, 5))
         ).astype(np.complex64)
    t = transfer.to_device(x, "cpu")
    assert t.dtype == torch.complex64 and t.device.type == "cpu"
    np.testing.assert_array_equal(transfer.to_host(t), x)
    z0 = transfer.to_device(np.complex64(1 + 2j), "cpu")
    assert z0.shape == () and complex(z0) == 1 + 2j
    assert transfer.to_device(t, "cpu") is t
    q = full.QuantSoft(torch.ones(2, 3, dtype=torch.int8),
                       -torch.ones(2, 3, dtype=torch.int8), 100.0)
    tree = {"soft": q, "list": [t, None, 3],
            "box": _Box(torch.arange(4), (t.real, 2.5))}
    host = transfer.to_host(tree)
    assert isinstance(host["soft"], full.QuantSoft)
    assert host["soft"].scale == 100.0
    assert host["soft"].re_q.dtype == np.int8
    np.testing.assert_array_equal(full.dequantize_soft(host["soft"]),
                                  np.full((2, 3), 0.01 - 0.01j, np.complex64))
    assert isinstance(host["list"], list) and host["list"][1:] == [None, 3]
    np.testing.assert_array_equal(host["list"][0], x)
    assert isinstance(host["box"], _Box)
    np.testing.assert_array_equal(host["box"].a, np.arange(4))
    np.testing.assert_array_equal(host["box"].b[0], x.real)
    for fn, val in ((transfer.complex_zeros, 0), (transfer.complex_ones, 1)):
        z = fn((2, 3), "cpu")
        assert z.dtype == torch.complex64 and bool((z == val).all())
    demod = DemodConfig(sps=4, num_avg=10, constellation_size=4,
                        phase_avg=12)
    st = transfer.to_host(blockpsk.ff_init(demod, 2, "cpu"))
    assert isinstance(st, blockpsk.FFState)
    assert st.win_samples.dtype == np.complex64
