"""Port parity, the per-stage receive chain: psk_soft_tpu_torch's
ops/interleave, ops/scramble, runtime/fec (FecFrameDecoder,
StreamFecDecoder), runtime/scramble, runtime/crc and
runtime/receiver.build_receiver against the JAX package on the CPU, fed the
same numpy inputs (transmit streams from the JAX package's ops/tx).

Tolerances: bits, info bits, corrected counts, CRC flags and frame lists
equal; soft payloads and correlation values within 1e-5.
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import crc as jcrc
from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.ops import interleave as jil
from psk_soft_tpu.ops import scramble as jsc
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.framesync import FrameFormat as JaxFrameFormat
from psk_soft_tpu.runtime import crc as jrcrc
from psk_soft_tpu.runtime import fec as jrfec
from psk_soft_tpu.runtime import scramble as jrsc
from psk_soft_tpu.runtime.receiver import build_receiver as jax_build
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import crc, fec, interleave, scramble
from psk_soft_tpu_torch.ops.framesync import Frame, FrameFormat
from psk_soft_tpu_torch.runtime import crc as rcrc
from psk_soft_tpu_torch.runtime import fec as rfec
from psk_soft_tpu_torch.runtime import scramble as rsc
from psk_soft_tpu_torch.runtime.receiver import build_receiver

torch.set_num_threads(1)

TOL = 1e-5
K7P23 = (jfec.ConvCode(7, (0o171, 0o133), jfec.PUNCTURE_2_3),
         fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_2_3))


@pytest.mark.parametrize("rows", [1, 4, 16])
def test_interleave_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    got = interleave.interleave(torch.from_numpy(x), rows)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jil.interleave(x, rows)))
    back = interleave.deinterleave(got, rows)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jil.deinterleave(np.asarray(got), rows)))
    with pytest.raises(ValueError, match="multiple"):
        interleave.interleave(torch.from_numpy(x), 5)


@pytest.mark.parametrize("preset", ["prbs7", "prbs15", "prbs23"])
def test_scramble_matches_jax(preset):
    """Presets, keystream, additive scrambling with the default and with
    per-row seeds (self-inverse), the self-synchronizing pair."""
    rng = np.random.default_rng(len(preset))
    jl, tl = jsc.lfsr_preset(preset, 77), scramble.lfsr_preset(preset, 77)
    assert (tl.degree, tl.taps, tl.seed) == (jl.degree, jl.taps, jl.seed)
    np.testing.assert_array_equal(scramble.keystream(tl, 300),
                                  jsc.keystream(jl, 300))
    bits = rng.integers(0, 2, (5, 200)).astype(np.int8)
    seeds = rng.integers(0, 2, (5, tl.degree)).astype(np.int8)
    for sd in (None, seeds):
        got = scramble.additive_scramble(tl, torch.from_numpy(bits), sd)
        want = jsc.additive_scramble(jl, bits, sd)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            scramble.additive_scramble(tl, got, sd).numpy(), bits)
    taps = (18, 23) if preset != "prbs7" else (3, 5)
    y = scramble.selfsync_scramble(torch.from_numpy(bits), taps)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jsc.selfsync_scramble(bits, taps)))
    d = scramble.selfsync_descramble(y, taps)
    np.testing.assert_array_equal(d.numpy(), bits)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jsc.selfsync_descramble(np.asarray(y), taps)))
    with pytest.raises(ValueError, match="unknown LFSR"):
        scramble.lfsr_preset("prbs9")
    with pytest.raises(ValueError, match="seeds shape"):
        scramble.additive_scramble(tl, torch.from_numpy(bits), seeds[:2])


def test_stream_descrambler_matches_jax_over_splits():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (3, 400)).astype(np.int8)
    ours, ref = rsc.StreamDescrambler(3), jrsc.StreamDescrambler(3)
    out, want = [], []
    for lo, hi in ((0, 7), (7, 30), (30, 31), (31, 400)):
        out.append(ours.observe(bits[:, lo:hi]))
        want.append(ref.observe(bits[:, lo:hi]))
    np.testing.assert_array_equal(np.concatenate(out, 1),
                                  np.concatenate(want, 1))
    with pytest.raises(ValueError, match="bit block"):
        ours.observe(bits[:2])


class _Source:
    """A frame source standing in for the syncer: hands out prepared
    frames once."""

    def __init__(self, fmt, frames):
        self.fmt = fmt
        self._frames = frames

    def pop_frames(self):
        out, self._frames = self._frames, []
        return out


def _frames(payloads, bits=None, frame_cls=Frame):
    return [frame_cls(channel=i, start=10 * i, rotation=0, corr=1.0,
                      residual_phase=0.0, soft=p,
                      bits=None if bits is None else bits[i])
            for i, p in enumerate(payloads)]


@pytest.mark.parametrize("labeling,rows", [("scd", None), ("gray", 8)])
def test_fec_frame_decoder_matches_jax(labeling, rows):
    """Noisy payloads, some past the code's correction span: info bits,
    corrected counts, suspect flags and the stage counters equal."""
    from psk_soft_tpu.ops.framesync import Frame as JaxFrame

    rng = np.random.default_rng(7)
    n, payload = 9, 64
    kw = dict(uw=(0, 1, 2, 3) * 4, payload=payload, m=4)
    info = rng.integers(0, 2, (n, payload - 6)).astype(np.int8)
    coded = fec.conv_encode(fec.CODE_K7, info).numpy()
    if rows is not None:
        coded = interleave.interleave(torch.from_numpy(coded), rows).numpy()
    sym = tx.symbols_to_iq(4, tx.bits_to_symbols(
        4, coded.reshape(-1), labeling=labeling)).reshape(n, payload)
    noise = np.linspace(0.05, 0.9, n)[:, None]
    pay = (sym + noise * (rng.standard_normal(sym.shape)
                          + 1j * rng.standard_normal(sym.shape))
           ).astype(np.complex64)
    ours = rfec.FecFrameDecoder(_Source(FrameFormat(**kw), _frames(pay)),
                                fec.CODE_K7, interleave_rows=rows,
                                labeling=labeling, device="cpu")
    ref = jrfec.FecFrameDecoder(
        _Source(JaxFrameFormat(**kw), _frames(pay, frame_cls=JaxFrame)),
        jfec.CODE_K7, interleave_rows=rows, labeling=labeling,
        backend="xla")
    got, want = ours.pop_frames(), ref.pop_frames()
    assert len(got) == n
    for a, b in zip(got, want):
        assert a.info_bits.dtype == np.int8
        np.testing.assert_array_equal(a.info_bits, b.info_bits)
        assert (a.corrected, a.suspect) == (b.corrected, b.suspect)
    assert any(f.suspect for f in got) and not got[0].suspect
    np.testing.assert_array_equal(got[0].info_bits, info[0])
    assert ((ours.frames_decoded, ours.errors_corrected, ours.suspect_frames)
            == (ref.frames_decoded, ref.errors_corrected, ref.suspect_frames))
    info, corrected = ours.decode_payloads(np.zeros((0, payload),
                                                    np.complex64))
    assert info.shape == (0, ours.info_bits) and corrected.shape == (0,)
    with pytest.raises(ValueError, match="multiple"):
        rfec.FecFrameDecoder(_Source(FrameFormat(**kw), []), fec.CODE_K7,
                             interleave_rows=7, device="cpu")


@pytest.mark.parametrize("punctured", [False, True])
def test_stream_fec_decoder_matches_jax(punctured):
    """Standalone StreamFecDecoder over QPSK soft symbols in ragged
    chunks: the decoded stream equals the JAX decoder's and the sent
    bits; the pre-stream discard and finalize as there."""
    jcode, code = K7P23 if punctured else (jfec.CODE_K7, fec.CODE_K7)
    rng = np.random.default_rng(93)
    bits = rng.integers(0, 2, (2, 600), np.int8)
    coded = fec.conv_encode(code, bits, terminate=False).numpy()
    syms = np.stack([tx.symbols_to_iq(4, tx.bits_to_symbols(4, row))
                     for row in coded])
    noisy = (syms + 0.15 * (rng.standard_normal(syms.shape)
                            + 1j * rng.standard_normal(syms.shape))
             ).astype(np.complex64)
    ours = rfec.StreamFecDecoder(2, code, m=4, depth=70, block_steps=128,
                                 device="cpu")
    ref = jrfec.StreamFecDecoder(2, jcode, m=4, depth=70, block_steps=128,
                                 backend="xla")
    assert ours.block_steps == ref.block_steps
    for lo in range(0, noisy.shape[1], 177):
        ours.observe(noisy[:, lo:lo + 177])
        ref.observe(noisy[:, lo:lo + 177])
        np.testing.assert_array_equal(ours.pop_bits(), ref.pop_bits())
    ours.finalize()
    ref.finalize()
    got = ours.pop_bits()
    np.testing.assert_array_equal(got, ref.pop_bits())
    assert ours.steps_decoded == ref.steps_decoded == bits.shape[1]
    ours.reset_fec()
    assert ours.pop_bits().shape == (2, 0) and ours.steps_decoded == 0
    with pytest.raises(ValueError, match="pass m"):
        rfec.StreamFecDecoder(2, code, device="cpu")


def test_frame_crc_checker_matches_jax(monkeypatch):
    """CRC flags and stripped messages equal the JAX stage's, on info bits
    and on raw bits; the stage computes on its own device (a "cuda" stage
    hands that device to ops/crc.check_crc), and check_crc computes on a
    tensor's device and equals the JAX package's."""
    from psk_soft_tpu.ops.framesync import Frame as JaxFrame

    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 2, (6, 40)).astype(np.int8)
    framed = crc.append_crc(crc.CRC16_CCITT, msgs)
    framed[[1, 4], 5] ^= 1                             # two corrupted
    got_m, got_ok = crc.check_crc(crc.CRC16_CCITT, torch.from_numpy(framed))
    want_m, want_ok = jcrc.check_crc(jcrc.CRC16_CCITT, framed)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_ok, want_ok)
    assert list(got_ok) == [True, False, True, True, False, True]
    pay = np.zeros((6, 8), np.complex64)
    for use_info in (True, False):
        ours_f = _frames(pay, None if use_info else framed)
        ref_f = _frames(pay, None if use_info else framed,
                        frame_cls=JaxFrame)
        if use_info:
            for a, b, row in zip(ours_f, ref_f, framed):
                a.info_bits, b.info_bits = row.copy(), row.copy()
        ours = rcrc.FrameCrcChecker(_Source(None, ours_f), crc.CRC16_CCITT,
                                    device="cpu")
        ref = jrcrc.FrameCrcChecker(_Source(None, ref_f), jcrc.CRC16_CCITT)
        for a, b in zip(ours.pop_frames(), ref.pop_frames()):
            assert a.crc_ok == b.crc_ok
            np.testing.assert_array_equal(
                a.info_bits if use_info else a.bits,
                b.info_bits if use_info else b.bits)
        assert (ours.frames_checked, ours.crc_failures) == (6, 2)
    seen = []

    def spy(spec, bits, device=None):
        seen.append(torch.device(device))
        return crc.check_crc(spec, bits)               # computed here

    monkeypatch.setattr(rcrc, "check_crc", spy)
    stage = rcrc.FrameCrcChecker(_Source(None, _frames(pay, framed)),
                                 crc.CRC16_CCITT, device="cuda")
    assert [f.crc_ok for f in stage.pop_frames()] == list(want_ok)
    assert seen == [torch.device("cuda")]


def _tx_wire(c, sps, n_msg, fmt, lfsr, code, spec, rng):
    """The link of tests/test_receiver.py: K7 + CRC-16 + PRBS15 frames on a
    rotated, noisy QPSK wire from the JAX transmitter."""
    starts = [300, 700, 1100]
    truth, rows = {}, []
    for ch in range(c):
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
        for s0, i in zip(starts, infos):
            truth[(ch, s0)] = i
        idx = tx.frame_stream(fmt, infos, starts, 1600, code=code,
                              lfsr=lfsr, crc=spec, labeling="gray",
                              seed=50 + ch)
        x = tx.shape(4, idx, sps) * np.exp(1j * 0.9)
        x = x + 0.04 * (rng.standard_normal(x.size)
                        + 1j * rng.standard_normal(x.size))
        rows.append(x.astype(np.complex64))
    return np.stack(rows), truth


def _drive(rx, wire, c, sps):
    block = 256 * sps
    for pos in range(0, wire.shape[1], block):
        for ch in range(c):
            rx.engine.push(ch, wire[ch, pos:pos + block])
        rx.engine.step_packets()
    rx.engine.flush_packets()
    return rx.pop_frames()


def test_build_receiver_matches_jax():
    """The stack of tests/test_receiver.py without the quality tap (A.8):
    batch engine -> FrameSyncer -> FecFrameDecoder -> FrameDescrambler ->
    FrameCrcChecker.  Every frame decodes with the CRC green and exact info
    bits, and the frame list equals the JAX receiver's."""
    c, sps = 2, 8
    kw = dict(sps=sps, num_avg=30, constellation_size=4, phase_avg=40)
    rng = np.random.default_rng(111)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4)
    n_msg = jfec.info_bits_for(jfec.CODE_K7, 128) - jcrc.CRC16_CCITT.degree
    wire, truth = _tx_wire(c, sps, n_msg, jfmt, jsc.prbs15(), jfec.CODE_K7,
                           jcrc.CRC16_CCITT, rng)
    stack = dict(block_symbols=256, uw=jfmt.uw, frame_payload=64,
                 fec_labeling="gray")
    want = _drive(jax_build(JaxDemodConfig(**kw), c, fec=jfec.CODE_K7,
                            descramble=jsc.prbs15(), crc=jcrc.CRC16_CCITT,
                            **stack), wire, c, sps)
    rx = build_receiver(DemodConfig(**kw), c, fec=fec.CODE_K7,
                        descramble=scramble.prbs15(), crc=crc.CRC16_CCITT,
                        device="cpu", **stack)
    assert rx.fec is not None and rx.syncer is not None
    assert rx.quality is None and rx.channels == c
    got = _drive(rx, wire, c, sps)
    assert len(got) == len(want) == c * 3
    for a, b in zip(got, want):
        assert ((a.channel, a.start, a.rotation, a.crc_ok, a.corrected,
                 a.suspect) == (b.channel, b.start, b.rotation, b.crc_ok,
                                b.corrected, b.suspect))
        np.testing.assert_array_equal(a.bits, b.bits)
        np.testing.assert_array_equal(a.info_bits, b.info_bits)
        np.testing.assert_allclose(a.soft, b.soft, atol=TOL, rtol=0)
        assert abs(a.corr - b.corr) <= TOL
        assert a.crc_ok
        np.testing.assert_array_equal(a.info_bits,
                                      truth[(a.channel, a.start)])


@pytest.mark.parametrize("case", ["frame_stage_without_uw", "unknown_engine",
                                  "fec_and_stream_fec", "bare",
                                  "stream_fec", "chain_needs_fec",
                                  "chain_per_stage", "chain_labeling",
                                  "chain"])
def test_build_receiver_validation(case):
    """The JAX receiver's validation cases, and the bare, stream-FEC and
    chain stacks."""
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=20)
    uw = dict(uw=(0, 1, 2, 3) * 4, frame_payload=64)
    kw = dict(device="cpu")
    if case == "frame_stage_without_uw":
        with pytest.raises(ValueError, match="require uw"):
            build_receiver(cfg, 2, fec=fec.CODE_K7, **kw)
    elif case == "unknown_engine":
        with pytest.raises(ValueError, match="unknown engine"):
            build_receiver(cfg, 2, engine="mosaic", **kw)
    elif case == "fec_and_stream_fec":
        with pytest.raises(ValueError, match="pick one"):
            build_receiver(cfg, 2, fec=fec.CODE_K7, stream_fec=fec.CODE_K7,
                           **uw, **kw)
    elif case == "bare":
        rx = build_receiver(cfg, 2, **kw)
        assert rx.frames is None and rx.quality is None
        with pytest.raises(ValueError, match="without frame sync"):
            rx.pop_frames()
    elif case == "stream_fec":
        rx = build_receiver(cfg, 2, stream_fec=fec.CODE_K7, **kw)
        assert rx.stream_fec is not None and rx.engine is rx.stream_fec
        assert rx.stream_fec.device == torch.device("cpu")
    elif case == "chain_needs_fec":
        with pytest.raises(ValueError, match="requires uw"):
            build_receiver(cfg, 128, engine="chain", **uw, **kw)
    elif case == "chain_per_stage":
        with pytest.raises(ValueError, match="per-stage"):
            build_receiver(cfg, 128, engine="chain", fec=fec.CODE_K7,
                           fec_labeling="gray",
                           descramble=scramble.prbs15(), **uw, **kw)
    elif case == "chain_labeling":
        with pytest.raises(ValueError, match="gray"):
            build_receiver(cfg, 128, engine="chain", fec=fec.CODE_K7, **uw,
                           **kw)
    else:
        rx = build_receiver(cfg, 128, engine="chain", fec=fec.CODE_K7,
                            crc=crc.CRC16_CCITT, fec_labeling="gray",
                            block_symbols=256, **uw, **kw)
        assert rx.engine is rx.frames and rx.engine.device.type == "cpu"
        assert rx.pop_frames() == []


@pytest.mark.parametrize("option", ["agc", "equalize", "acquire_cfo",
                                    "quality"])
def test_build_receiver_a8_options_raise(option):
    """The sample-side front ends and the quality tap (ROADMAP A.8): each
    raises under engine="chain", as the JAX receiver's do, and under
    "batch" and "full" builds its stage between the engine and the frame
    syncer, on the receiver's device."""
    from psk_soft_tpu_torch.runtime import agc, autocfo, equalizer, quality

    cls = {"agc": agc.AgcFrontEnd, "equalize": equalizer.EqFrontEnd,
           "acquire_cfo": autocfo.AutoCfoEngine,
           "quality": quality.QualityMonitor}[option]
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=20)
    kw = dict(uw=(0, 1, 2, 3) * 4, frame_payload=64, fec=fec.CODE_K7,
              fec_labeling="gray", device="cpu", **{option: True})
    with pytest.raises(ValueError, match="per-stage"):
        build_receiver(cfg, 128, engine="chain", **kw)
    for engine in ("batch", "full"):
        rx = build_receiver(cfg, 128, engine=engine, **kw)
        stage = rx.syncer.engine
        assert type(stage) is cls and stage.engine.device.type == "cpu"
        assert (rx.quality is stage) == (option == "quality")
        if option == "equalize":
            assert stage.eq_cfg.dd_m == 4
        assert rx.syncer._tap_device and rx.channels == 128
