"""Port parity, the front-end receiver: psk_soft_tpu_torch's
runtime/native_bank.NativeChannelBank, the engines' push_block and
build_receiver(agc, equalize, acquire_cfo, quality) with the frame side,
against the JAX package on the CPU, fed the same numpy inputs.

Tolerances: bank blocks equal (the same C++ ring); push_block equal to
per-channel pushes; the stack's frame lists, bits, info bits, CRC flags
and rotations equal to JAX's, soft payloads and correlations within B1's
3e-3 (tests/test_full_kernel.py:60-68), CFOs equal, AGC gains within
4.4e-4 dB (rtol 1e-4 on the power, tests/test_agc.py), equalizer weights
within 1e-5 (tests/test_equalizer.py), quality EMAs within rtol 1e-3,
alarms equal.  With engine="full" the port's planes stay tensors and its
NCO is ops/mixer.derotate, where JAX's AGC hands numpy to the host NCO
(ROADMAP C): the tolerances above still hold.
"""

import threading

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import crc as jcrc
from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.ops import scramble as jsc
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.equalizer import EqConfig as JaxEqConfig
from psk_soft_tpu.ops.equalizer import multipath
from psk_soft_tpu.ops.framesync import FrameFormat as JaxFrameFormat
from psk_soft_tpu.runtime.engine import BatchEngine as JaxBatchEngine
from psk_soft_tpu.runtime.engine import FullKernelBatchEngine as JaxFull
from psk_soft_tpu.runtime.native_bank import NativeChannelBank as JaxBank
from psk_soft_tpu.runtime.receiver import build_receiver as jax_build
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import crc, fec, scramble
from psk_soft_tpu_torch.ops.equalizer import EqConfig
from psk_soft_tpu_torch.runtime.engine_batch import BatchEngine
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.native_bank import NativeChannelBank
from psk_soft_tpu_torch.runtime.receiver import build_receiver

torch.set_num_threads(1)

TOL = 3e-3


def _frames(n, c, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, c)) + 1j * rng.standard_normal((n, c)))
    return z.astype(np.complex64)


def test_native_channel_bank_matches_jax():
    """The same pushes into the JAX bank and the port's (one C++ source,
    built by each package): the same blocks, flush flags, depths, stats,
    timeouts and refusals; wraparound and overflow included."""
    c, cap = 3, 256
    jb, tb = JaxBank(c, capacity_samples=cap), NativeChannelBank(
        c, capacity_samples=cap)
    stream = _frames(cap * 4, c, seed=2)
    pos = 0
    for push, popn in ((96, 80), (96, 80), (300, 50), (10, 64)):
        chunk = stream[pos:pos + push]
        pos += push
        assert tb.push_interleaved(chunk) == jb.push_interleaved(chunk)
        assert tb.depth() == jb.depth()
        while jb.depth() >= popn:
            (a, fa), (b, fb) = tb.pop_block(popn), jb.pop_block(popn)
            assert a.dtype == np.complex64 and a.shape == (c, popn)
            np.testing.assert_array_equal(a, b)
            assert fa == fb
    assert tb.stats() == type(tb.stats())(*jb.stats().__dict__.values())
    assert tb.stats().flushes == 1
    assert tb.pop_block(10_000, timeout=0.01) is None
    with pytest.raises(ValueError, match="whole frames"):
        tb.push_interleaved(np.zeros(4, np.complex64))
    raw = _frames(5, c, seed=3)
    tb.push_interleaved(raw.view(np.float32).ravel())   # raw float32 pairs
    got = tb.pop_block(tb.depth())[0]
    np.testing.assert_array_equal(got[:, -5:], raw.T)
    tb.close()
    jb.close()


def test_native_channel_bank_threaded_into_push_block():
    """A producer thread pushes 37 frames at a time and closes; the
    consumer pops (C, 200) blocks into an engine's push_block, which equals
    per-channel pushes of the same stream."""
    c, n_blocks, blk = 4, 12, 200
    stream = _frames(n_blocks * blk, c, seed=7)
    bank = NativeChannelBank(c, capacity_samples=blk * n_blocks + 1)

    def produce():
        for i in range(0, stream.shape[0], 37):
            bank.push_interleaved(stream[i:i + 37])
        bank.close()

    t = threading.Thread(target=produce)
    t.start()
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    e_blk = BatchEngine(cfg, c, block_symbols=100, device="cpu")
    got = 0
    while got < n_blocks:
        r = bank.pop_block(blk, timeout=5.0)
        if r is None:
            break
        e_blk.push_block(r[0])
        got += 1
    t.join()
    assert got == n_blocks
    e_ref = BatchEngine(cfg, c, block_symbols=100, device="cpu")
    for ch in range(c):
        e_ref.push(ch, stream[:, ch])
    assert e_blk.metrics.samples_in == e_ref.metrics.samples_in
    while (a := e_ref.step()) is not None:
        b = e_blk.step()
        assert torch.equal(a.soft, b.soft) and torch.equal(a.bits, b.bits)
    assert e_blk.step() is None


def test_push_block_matches_jax_and_keeps_the_mixing_rule():
    """push_block on the port's bank engines equals the JAX engines' (the
    JAX test's 3-channel bank, three blocks; soft within 3e-3), a tensor
    block equals a numpy one, and FullKernelBatchEngine keeps its rule:
    channel-major pushes (push_block too) and plane pushes do not mix, and
    an int16-ingest engine takes only planes."""
    c, s = 3, 64
    rng = np.random.default_rng(11)
    x = np.stack([np.repeat(np.exp(2j * np.pi * rng.integers(0, 4, 3 * s)
                                   / 4), 8) for _ in range(c)]
                 ).astype(np.complex64)
    kw = dict(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    j = JaxBatchEngine(JaxDemodConfig(**kw), c, block_symbols=s)
    j.push_block(x)
    outs = []
    for block in (x, torch.from_numpy(x)):
        e = BatchEngine(DemodConfig(**kw), c, block_symbols=s, device="cpu")
        e.push_block(block)
        outs.append([e.step() for _ in range(3)])
        assert e.step() is None
    for a, b in zip(*outs):
        assert torch.equal(a.soft, b.soft)
    for a in outs[0]:
        b = j.step()
        np.testing.assert_array_equal(a.bits.numpy(), np.asarray(b.bits))
        np.testing.assert_allclose(a.soft.numpy(), np.asarray(b.soft),
                                   atol=TOL)
    cfg = DemodConfig(**kw)
    full = FullKernelBatchEngine(cfg, 128, block_symbols=s, device="cpu")
    with pytest.raises(ValueError, match=r"\(128, n\)"):
        full.push_block(x)
    full.push_block(np.zeros((128, 8), np.complex64))
    with pytest.raises(ValueError, match="cannot mix"):
        full.push_planes(np.zeros((8, 128), np.float32),
                         np.zeros((8, 128), np.float32))
    full = FullKernelBatchEngine(cfg, 128, block_symbols=s, device="cpu")
    full.push_planes(np.zeros((8, 128), np.float32),
                     np.zeros((8, 128), np.float32))
    with pytest.raises(ValueError, match="plane-ingest"):
        full.push_block(np.zeros((128, 8), np.complex64))
    wire = FullKernelBatchEngine(cfg, 128, block_symbols=s,
                                 ingest_scale=1e-3, device="cpu")
    with pytest.raises(ValueError, match="int16"):
        wire.push_block(np.zeros((128, 8), np.complex64))


SPS = 8
BLOCK = 256
N_BLOCKS = 16
STARTS = (2600, 3000, 3400, 3800)


def _link(c, rng, noise_ch):
    """tests/test_receiver.py's link (K7 + CRC-16 + PRBS15 frames, Gray,
    from the JAX transmitter) made harder: the one-symbol echo of
    tests/test_equalizer.py:156, a carrier beyond the tracker's lock range
    (0.018 + 0.006 c/C cycles/sample), a level per channel in -20..+10 dB,
    and ``noise_ch`` carrying noise only.  Frames start after the
    equalizer has converged."""
    fmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4)
    n_msg = jfec.info_bits_for(jfec.CODE_K7, 128) - jcrc.CRC16_CCITT.degree
    total = N_BLOCKS * BLOCK
    truth, rows = {}, []
    t = np.arange(total * SPS)
    for ch in range(c):
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in STARTS]
        for s0, i in zip(STARTS, infos):
            truth[(ch, s0)] = i
        idx = tx.frame_stream(fmt, infos, list(STARTS), total,
                              code=jfec.CODE_K7, lfsr=jsc.prbs15(),
                              crc=jcrc.CRC16_CCITT, labeling="gray",
                              seed=50 + ch)
        x = multipath(tx.shape(4, idx, SPS).astype(np.complex64),
                      [1.0] + [0.0] * 7 + [0.5j])
        if ch in noise_ch:
            x = (rng.standard_normal(x.size)
                 + 1j * rng.standard_normal(x.size)) / np.sqrt(2)
        x = x * np.exp(2j * np.pi * (0.018 + 0.006 * ch / c) * t)
        x = x + 0.01 * (rng.standard_normal(x.size)
                        + 1j * rng.standard_normal(x.size))
        rows.append((x * 10 ** (rng.uniform(-20, 10) / 20)
                     ).astype(np.complex64))
    return fmt, np.stack(rows), truth


def _stages(rx):
    q = rx.quality
    return dict(quality=q, agc=q.engine, eq=q.engine.engine,
                cfo=q.engine.engine.engine)


@pytest.mark.parametrize("engine", ["batch", "full"])
def test_front_end_receiver_matches_jax(engine):
    """build_receiver(agc, equalize=EqConfig(taps=33, mu=5e-5),
    acquire_cfo, quality, frame side) on the hard link: "batch" over 4
    channels by per-channel pushes (the host ragged paths), "full" over
    128 by time-major planes (tensors in the port, numpy in JAX; JAX's
    kernel in interpret mode).  Every frame green with exact info bits,
    and everything equal to the JAX stack within the stated tolerances."""
    c = 4 if engine == "batch" else 128
    noise_ch = (2,) if engine == "batch" else (5, 77)
    rng = np.random.default_rng(111)
    fmt, wire, truth = _link(c, rng, noise_ch)
    kw = dict(sps=SPS, num_avg=30, constellation_size=4, phase_avg=40)
    common = dict(engine=engine, block_symbols=BLOCK, agc=True,
                  acquire_cfo=True, quality=True, uw=fmt.uw,
                  frame_payload=64, fec_labeling="gray")
    jrx = jax_build(JaxDemodConfig(**kw), c,
                    equalize=JaxEqConfig(taps=33, mu=5e-5),
                    fec=jfec.CODE_K7, descramble=jsc.prbs15(),
                    crc=jcrc.CRC16_CCITT,
                    engine_kwargs=(dict(s_tile=64, interpret=True)
                                   if engine == "full" else None), **common)
    rx = build_receiver(DemodConfig(**kw), c,
                        equalize=EqConfig(taps=33, mu=5e-5),
                        fec=fec.CODE_K7, descramble=scramble.prbs15(),
                        crc=crc.CRC16_CCITT, device="cpu", **common)
    if engine == "full":
        assert isinstance(_stages(jrx)["cfo"].engine, JaxFull)
    got, want = [], []
    n = BLOCK * SPS
    for pos in range(0, wire.shape[1], n):
        blk = wire[:, pos:pos + n]
        if engine == "batch":
            for ch in range(c):
                jrx.engine.push(ch, blk[ch])
                rx.engine.push(ch, blk[ch])
        else:
            re = np.ascontiguousarray(blk.real.T)
            im = np.ascontiguousarray(blk.imag.T)
            jrx.engine.push_planes(re, im)
            rx.engine.push_planes(torch.from_numpy(re), torch.from_numpy(im))
        for r in (jrx, rx):
            while r.engine.ready():
                r.engine.step_packets()
        want += jrx.pop_frames()
        got += rx.pop_frames()
    jrx.engine.flush_packets()
    rx.engine.flush_packets()
    want += jrx.pop_frames()
    got += rx.pop_frames()

    key = lambda f: (f.channel, f.start)  # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [key(f) for f in got] == [key(f) for f in want]
    for a, b in zip(got, want):
        assert (a.rotation, a.crc_ok, a.corrected) == (b.rotation, b.crc_ok,
                                                       b.corrected)
        np.testing.assert_array_equal(a.bits, b.bits)
        np.testing.assert_array_equal(a.info_bits, b.info_bits)
        np.testing.assert_allclose(a.soft, b.soft, atol=TOL, rtol=0)
        assert abs(a.corr - b.corr) <= TOL
    delay = _stages(rx)["eq"].eq_cfg.center_tap // SPS
    late = {(f.channel, f.start - delay): f for f in got if f.crc_ok}
    for (ch, s0), info in truth.items():
        if ch not in noise_ch:
            np.testing.assert_array_equal(late[(ch, s0)].info_bits, info)

    st, jst = _stages(rx), _stages(jrx)
    np.testing.assert_array_equal(st["cfo"].cfo, jst["cfo"].cfo)
    sig = [ch for ch in range(c) if ch not in noise_ch]
    np.testing.assert_allclose(st["cfo"].cfo[sig], 0.018 + 0.006
                               * np.asarray(sig) / c, atol=2e-4)
    np.testing.assert_allclose(st["agc"].gains_db, jst["agc"].gains_db,
                               atol=4.4e-4)
    np.testing.assert_allclose(st["eq"].weights, jst["eq"].weights,
                               atol=1e-5)
    snap, jsnap = st["quality"].snapshot(), jst["quality"].snapshot()
    np.testing.assert_array_equal(snap["symbols"], jsnap["symbols"])
    for name in ("amp", "power", "lock"):
        np.testing.assert_allclose(snap[name], jsnap[name], rtol=1e-3,
                                   err_msg=name)
    np.testing.assert_array_equal(st["quality"].alarms(),
                                  jst["quality"].alarms())
    assert np.nonzero(st["quality"].alarms())[0].tolist() == list(noise_ch)
    assert (snap["lock"][sig] > 0.5).all()      # tests/test_receiver.py
