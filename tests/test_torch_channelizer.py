"""Port parity, the channelizer: psk_soft_tpu_torch's ops/channelizer
(prototype_taps, channelize_block, channelize_block_os2,
channel_frequencies) and runtime/channelizer.ChannelizerFrontEnd against
the JAX package on the CPU, fed the same numpy samples.

Tolerances: the taps and the channel frequencies bit-equal; the bank's
output within 2e-5 of JAX's and of the direct-DDC oracle (the JAX oracle
tests' bound, tests/test_channelizer.py:42-43 and :276-277: the FFTs sum
in another order); within the port, streaming equals one-shot to 1e-6
(tests/test_channelizer.py:95-96) and the carry is bit-equal.  The
wideband capture -> ChannelizerFrontEnd -> FullKernelBatchEngine stack
agrees with JAX's (FullKernelBatchEngine with interpret=True) at the
engine's bounds: bits and sample index equal on the occupied channels,
soft 3e-3, phase 2e-3 (tests/test_torch_engine_full.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import channelizer as jch
from psk_soft_tpu.runtime.channelizer import \
    ChannelizerFrontEnd as JaxChannelizerFrontEnd
from psk_soft_tpu.runtime.engine import \
    FullKernelBatchEngine as JaxFullKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI as JaxSRI
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import channelizer as tch
from psk_soft_tpu_torch.runtime.channelizer import ChannelizerFrontEnd
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.streams import (PORT_BITS, PORT_PHASE,
                                                PORT_SAMPLE_INDEX, PORT_SOFT,
                                                SRI)
from psk_soft_tpu_torch.testing.wideband import rc_psk, synthesize
from psk_soft_tpu_torch.utils.interop import (channelizer_carry_from_numpy,
                                              channelizer_carry_to_numpy)

torch.set_num_threads(1)

ORACLE_TOL = 2e-5
STREAM_TOL = 1e-6
PHASE_TOL, SOFT_TOL = 2e-3, 3e-3


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _oracle(taps, xx, C, hop):
    """Direct DDC: y[t, m] = sum_l h[l] xx[t*hop + l] e^{-2j pi m (t*hop +
    l)/C} (hop C: the critical bank, whose twiddle is 1; hop C/2: the
    2x-oversampled bank)."""
    L = taps.size
    B = (xx.size - (L - hop)) // hop
    l = np.arange(L)
    y = np.empty((B, C), np.complex128)
    for m in range(C):
        w = taps * np.exp(-2j * np.pi * m * l / C)
        for t in range(B):
            y[t, m] = np.dot(w, xx[t * hop: t * hop + L]) \
                * np.exp(-2j * np.pi * m * t * hop / C)
    return y


@pytest.mark.parametrize("C,K,beta,cut", [(8, 6, 9.0, 1.0), (16, 8, 9.0, 1.0),
                                          (128, 8, 7.0, 0.8),
                                          (32, 4, 9.0, 2.0)])
def test_taps_and_frequencies_bit_equal(C, K, beta, cut):
    np.testing.assert_array_equal(
        tch.prototype_taps(C, K, beta=beta, cutoff_scale=cut),
        jch.prototype_taps(C, K, beta=beta, cutoff_scale=cut))
    np.testing.assert_array_equal(tch.channel_frequencies(C, 1e-6),
                                  jch.channel_frequencies(C, 1e-6))


def test_validation_matches_jax():
    for args in [(1, 8), (8, 1), (8, 8, 9.0, 0.0), (8, 8, 9.0, 2.5)]:
        with pytest.raises(ValueError):
            jch.prototype_taps(*args)
        with pytest.raises(ValueError):
            tch.prototype_taps(*args)
    taps = _t(tch.prototype_taps(8, 4))
    with pytest.raises(ValueError):
        tch.channelize_block(taps, tch.channelizer_init(8, 4, "cpu"),
                             torch.zeros(12, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tch.channelize_block_os2(taps, tch.channelizer_os2_init(8, 4, "cpu"),
                                 torch.zeros(12, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tch.channelizer_os2_init(7, 4, "cpu")
    with pytest.raises(ValueError):
        ChannelizerFrontEnd(8, oversample=3, device="cpu")
    fe = ChannelizerFrontEnd(8, oversample=2, device="cpu")
    fe.push(np.zeros(64, np.complex64))
    with pytest.raises(ValueError):
        fe.step_planes(3)


@pytest.mark.parametrize("os2", [False, True])
@pytest.mark.parametrize("C,K,B", [(8, 6, 40), (16, 8, 24)])
def test_block_matches_jax_and_oracle(os2, C, K, B):
    """One block from a zero carry: within 2e-5 of JAX and of the direct
    DDC; the carry holds the last branch rows, bit-equal to JAX's."""
    taps = tch.prototype_taps(C, K)
    x = _noise(B * C, seed=C + K)
    if os2:
        t_carry, ty = tch.channelize_block_os2(
            _t(taps), tch.channelizer_os2_init(C, K, "cpu"), _t(x))
        j_carry, jy = jch.channelize_block_os2(
            jnp.asarray(taps), jch.channelizer_os2_init(C, K),
            jnp.asarray(x))
        pad, hop = (2 * K - 1) * (C // 2), C // 2
    else:
        t_carry, ty = tch.channelize_block(
            _t(taps), tch.channelizer_init(C, K, "cpu"), _t(x))
        j_carry, jy = jch.channelize_block(
            jnp.asarray(taps), jch.channelizer_init(C, K), jnp.asarray(x))
        pad, hop = (K - 1) * C, C
    assert ty.dtype == torch.complex64 and t_carry.dtype == torch.complex64
    assert tuple(ty.shape) == np.asarray(jy).shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ORACLE_TOL,
                               rtol=0)
    xx = np.concatenate([np.zeros(pad, np.complex64), x])
    np.testing.assert_allclose(ty.numpy(), _oracle(taps, xx, C, hop),
                               atol=ORACLE_TOL, rtol=0)
    np.testing.assert_array_equal(t_carry.numpy(), np.asarray(j_carry))
    np.testing.assert_array_equal(t_carry.numpy().ravel(), x[-pad:])


@pytest.mark.parametrize("m", [0, 1, 5, 12, 15])
def test_tone_routes_to_its_bin(m):
    """A tone at channel m's center comes out of bin m at amplitude ~1 and
    is rejected elsewhere (tests/test_channelizer.py:47-61), as JAX's."""
    C, K, B = 16, 8, 64
    taps = tch.prototype_taps(C, K)
    x = np.exp(2j * np.pi * m * np.arange(B * C) / C).astype(np.complex64)
    _, y = tch.channelize_block(_t(taps), tch.channelizer_init(C, K, "cpu"),
                                _t(x))
    _, jy = jch.channelize_block(jnp.asarray(taps), jch.channelizer_init(C, K),
                                 jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ORACLE_TOL,
                               rtol=0)
    y = y.numpy()[K:]
    assert np.abs(np.abs(y[:, m]) - 1.0).max() < 1e-3
    assert np.delete(np.abs(y), m, axis=1).max() < 1e-3


@pytest.mark.parametrize("os2", [False, True])
def test_streaming_equals_oneshot(os2):
    C, K = 8, 6
    taps = _t(tch.prototype_taps(C, K))
    x = _noise(200 * C, seed=1)
    step = tch.channelize_block_os2 if os2 else tch.channelize_block
    init = tch.channelizer_os2_init if os2 else tch.channelizer_init
    c_ref, ref = step(taps, init(C, K, "cpu"), _t(x))
    carry, parts, i = init(C, K, "cpu"), [], 0
    for nrows in (1, 7, 64, 3, 125):            # 200 rows of C samples
        carry, y = step(taps, carry, _t(x[i: i + nrows * C]))
        parts.append(y.numpy())
        i += nrows * C
    np.testing.assert_allclose(np.concatenate(parts), ref.numpy(),
                               atol=STREAM_TOL, rtol=0)
    np.testing.assert_array_equal(carry.numpy(), c_ref.numpy())


def test_os2_odd_rows_are_the_critical_bank():
    """Decimating the 2x bank by 2 (odd rows, (-1)^m folded out) gives the
    critical bank's rows (tests/test_channelizer.py:337-350)."""
    C, K = 8, 8
    taps = _t(tch.prototype_taps(C, K))
    x = _t(_noise(100 * C, seed=6))
    _, y2 = tch.channelize_block_os2(taps, tch.channelizer_os2_init(
        C, K, "cpu"), x)
    _, y1 = tch.channelize_block(taps, tch.channelizer_init(C, K, "cpu"), x)
    alt = np.where(np.arange(C) % 2 == 1, -1.0, 1.0).astype(np.float32)
    np.testing.assert_allclose(y2.numpy()[1::2] * alt, y1.numpy(),
                               atol=STREAM_TOL, rtol=0)


def test_jax_carry_continues_in_the_port():
    """A stream the JAX bank started (critical and 2x) continues in the
    port from JAX's carry, through utils/interop, and equals JAX's
    uninterrupted run."""
    C, K = 16, 6
    taps = tch.prototype_taps(C, K)
    x = _noise(90 * C, seed=8)
    cut = 37 * C
    for os2 in (False, True):
        jstep = jch.channelize_block_os2 if os2 else jch.channelize_block
        jinit = jch.channelizer_os2_init if os2 else jch.channelizer_init
        tstep = tch.channelize_block_os2 if os2 else tch.channelize_block
        _, jall = jstep(jnp.asarray(taps), jinit(C, K), jnp.asarray(x))
        jc, _ = jstep(jnp.asarray(taps), jinit(C, K), jnp.asarray(x[:cut]))
        carry = channelizer_carry_from_numpy(np.asarray(jc), "cpu")
        carry, y = tstep(_t(taps), carry, _t(x[cut:]))
        n = np.asarray(jall).shape[0] - y.shape[0]
        np.testing.assert_allclose(y.numpy(), np.asarray(jall)[n:],
                                   atol=ORACLE_TOL, rtol=0)
        jc2, _ = jstep(jnp.asarray(taps), jinit(C, K), jnp.asarray(x))
        np.testing.assert_array_equal(channelizer_carry_to_numpy(carry),
                                      np.asarray(jc2))
    with pytest.raises(ValueError):
        channelizer_carry_from_numpy(np.zeros(5, np.complex64), "cpu")


@pytest.mark.parametrize("oversample", [1, 2])
def test_frontend_planes_block_drain_reset(oversample):
    """step_planes gives contiguous float32 (rows, C) planes equal to
    step_block's (C, rows) samples and to JAX's front end; available_rows,
    drain and reset as in tests/test_channelizer.py:129-154."""
    C, K = 8, 6
    x = _noise(100 * C, seed=5)
    fe_p = ChannelizerFrontEnd(C, taps_per_branch=K, oversample=oversample,
                               device="cpu")
    fe_b = ChannelizerFrontEnd(C, taps_per_branch=K, oversample=oversample,
                               device="cpu")
    jfe = JaxChannelizerFrontEnd(C, taps_per_branch=K, oversample=oversample)
    for fe in (fe_p, fe_b, jfe):
        assert fe.available_rows() == 0
        fe.push(x[:333])
        fe.push(x[333:])
    rows = 64 * oversample
    re, im = fe_p.step_planes(rows)
    for p in (re, im):
        assert p.dtype == torch.float32 and p.is_contiguous()
        assert tuple(p.shape) == (rows, C) and p.device.type == "cpu"
    blk = fe_b.step_block(rows)
    assert blk.dtype == np.complex64 and blk.flags.c_contiguous
    np.testing.assert_array_equal(re.numpy().T + 1j * im.numpy().T, blk)
    np.testing.assert_allclose(blk, jfe.step_block(rows), atol=ORACLE_TOL,
                               rtol=0)
    left = 36 * oversample
    assert fe_p.available_rows() == fe_b.available_rows() == left
    assert fe_b.step_block(left + 1) is None and fe_p.step_planes(
        left + 1) is None
    tail = fe_b.drain(planes=False)
    assert tail.shape == (C, left)
    np.testing.assert_allclose(tail, jfe.drain(planes=False),
                               atol=ORACLE_TOL, rtol=0)
    assert fe_b.drain(planes=False) is None
    dre, dim = fe_p.drain()
    np.testing.assert_array_equal(dre.numpy().T + 1j * dim.numpy().T, tail)
    fe_b.reset()
    fe_b.push(x)
    np.testing.assert_array_equal(fe_b.step_block(rows), blk)
    np.testing.assert_array_equal(fe_b.frequencies(1e-6),
                                  jfe.frequencies(1e-6))


def test_synthesis_bank_round_trip():
    """testing/wideband.synthesize is the analysis bank's inverse: a
    raised-cosine channel comes back K-1 rows later within 3e-4, and the
    synthesis streams block-split invariantly."""
    C, K = 16, 8
    taps = tch.prototype_taps(C, K)
    x, _ = rc_psk(np.full(C, 8.0), 800, 4, np.random.default_rng(0))
    wide, _ = synthesize(x.T, taps)
    _, y = tch.channelize_block(_t(taps), tch.channelizer_init(C, K, "cpu"),
                                _t(wide))
    np.testing.assert_allclose(y.numpy()[K - 1 + 50:700], x.T[50:700 - K + 1],
                               atol=3e-4, rtol=0)
    w1, carry = synthesize(x.T[:300], taps)
    w2, _ = synthesize(x.T[300:], taps, carry)
    np.testing.assert_allclose(np.concatenate([w1, w2]), wide, atol=1e-6,
                               rtol=0)


def _capture(C, K, rows, noise_ch, seed):
    """Raised-cosine QPSK (sps 8) on every channel but ``noise_ch``, which
    carry noise only, at 30 dB; summed by the synthesis bank."""
    rng = np.random.default_rng(seed)
    x, _ = rc_psk(np.full(C, 8.0), rows, 4, rng)
    x[list(noise_ch)] = 0
    x += (0.03 / np.sqrt(2) * (rng.standard_normal(x.shape)
                               + 1j * rng.standard_normal(x.shape)))
    wide, _ = synthesize(x.T, tch.prototype_taps(C, K))
    return wide


def _softs(pkts):
    return np.concatenate([p[PORT_SOFT].data for p in pkts
                           if p and p[PORT_SOFT].data.size], axis=1)


def test_frontend_feeds_full_kernel_engine_like_jax():
    """The production wideband path on both packages: a 128-channel
    capture -> ChannelizerFrontEnd -> FullKernelBatchEngine (the port's
    plain B1 on the CPU; JAX's interpret-mode Pallas kernel), one
    64-symbol block at a time, then a flush.  Packets agree at the
    engine's bounds on the occupied channels, and every occupied band
    locks (99th-percentile QPSK angle error < 0.1,
    tests/test_channelizer.py:223-226)."""
    C, K, sps, S, B = 128, 8, 8, 200, 64
    noise = (5, 77)
    kw = dict(sps=sps, num_avg=50, constellation_size=4, phase_avg=20)
    wide = _capture(C, K, S * sps, noise, seed=9)
    fe = ChannelizerFrontEnd(C, taps_per_branch=K, device="cpu")
    jfe = JaxChannelizerFrontEnd(C, taps_per_branch=K)
    eng = FullKernelBatchEngine(DemodConfig(**kw), C, block_symbols=B,
                                device="cpu")
    jeng = JaxFullKernelBatchEngine(JaxDemodConfig(**kw), C, block_symbols=B,
                                    s_tile=B, interpret=True)
    eng.set_input_sri(SRI("wb", xdelta=1.0))
    jeng.set_input_sri(JaxSRI("wb", xdelta=1.0))
    got, ref = [], []
    for i in range(0, wide.size, 50000):       # ragged wideband arrivals
        for f, e, out in ((fe, eng, got), (jfe, jeng, ref)):
            f.push(wide[i:i + 50000])
            while True:
                r = f.step_planes(B * sps)
                if r is None:
                    break
                e.push_planes(*r)
                out.append(e.step_packets())
    got.append(eng.flush_packets())
    ref.append(jeng.flush_packets())
    assert len(got) == len(ref) == S // B + 1
    sig = np.ones(C, bool)
    sig[list(noise)] = False
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for port in a:
            pa, pb = a[port], b[port]
            assert (pa.t, pa.eos) == (pb.t, pb.eos)
            assert pa.data.shape == pb.data.shape
            da, db = pa.data, pb.data
            if da.ndim == 2:
                da, db = da[sig], db[sig]
            if port in (PORT_BITS, PORT_SAMPLE_INDEX):
                np.testing.assert_array_equal(da, db, err_msg=port)
            else:
                tol = PHASE_TOL if port == PORT_PHASE else SOFT_TOL
                np.testing.assert_allclose(da, db, atol=tol, rtol=0,
                                           err_msg=port)
    soft = _softs(got)
    assert soft.shape[0] == C and soft.shape[1] >= 100
    ang = np.angle(soft[sig, 5:] * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    err = np.minimum(ang, np.pi / 2 - ang)
    assert np.percentile(err, 99) < 0.1


def test_frontend_os2_feeds_full_kernel_engine():
    """The 2x bank in front of the engine: the capture's channels at sps 8
    come out at sps 16 (tests/test_channelizer.py:317-381), and the planes
    go straight into FullKernelBatchEngine, where every occupied band
    locks (the angle bounds of that test)."""
    C, K, sps, S, B = 128, 8, 8, 320, 64
    noise = (5, 77)
    wide = _capture(C, K, S * sps, noise, seed=4)
    fe = ChannelizerFrontEnd(C, taps_per_branch=K, oversample=2,
                             device="cpu")
    fe.push(wide)
    assert fe.available_rows() == 2 * S * sps
    cfg = DemodConfig(sps=2 * sps, num_avg=50, constellation_size=4,
                      phase_avg=20)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=B, device="cpu")
    eng.set_input_sri(SRI("os2", xdelta=1.0))
    pkts = []
    while True:
        r = fe.step_planes(B * 2 * sps)
        if r is None:
            break
        eng.push_planes(*r)
        pkts.append(eng.step_packets())
    assert len(pkts) == S // B
    sig = np.ones(C, bool)
    sig[list(noise)] = False
    soft = _softs(pkts)[sig]
    assert soft.shape[1] >= 200
    ang = np.angle(soft[:, 5:] * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    err = np.minimum(ang, np.pi / 2 - ang)
    assert np.percentile(err, 99) < 0.2
    assert np.percentile(err, 50) < 0.06
