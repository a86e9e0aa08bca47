"""Port parity, transmit chain: psk_soft_tpu_torch/ops/tx against the JAX
ops/tx on the same arguments (outputs byte-equal: dtype, shape and every
byte), and tests/test_tx.py's four checks run on the port's receive stack
(FrameSyncer, FecFrameDecoder, FrameDescrambler on the CPU; the RRC demod
through the port's feed-forward factory)."""

import numpy as np
import pytest
import torch

from psk_soft_tpu.ops import crc as jcrc
from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.ops import scramble as jscramble
from psk_soft_tpu.ops import tx as jtx
from psk_soft_tpu.ops.framesync import FrameFormat as JaxFrameFormat
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import crc, fec, scramble, slicers, tx
from psk_soft_tpu_torch.ops.framesync import FrameFormat

torch.set_num_threads(1)

MS = [2, 4, 8, 16, 32]


def _same_bytes(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("labeling", ["scd", "gray"])
@pytest.mark.parametrize("m", MS)
def test_bits_to_symbols_matches_jax(m, labeling):
    rng = np.random.default_rng(60 + m)
    nb = int(np.log2(m))
    bits = rng.integers(0, 2, (3, 40 * nb), np.int8)
    idx = tx.bits_to_symbols(m, bits, labeling)
    _same_bytes(idx, jtx.bits_to_symbols(m, bits, labeling))
    _same_bytes(tx.symbols_to_iq(m, idx), jtx.symbols_to_iq(m, idx))


@pytest.mark.parametrize("m", MS)
def test_bits_to_symbols_inverts_slicers(m):
    rng = np.random.default_rng(61)
    nb = int(np.log2(m))
    bits = rng.integers(0, 2, (3, 20 * nb), np.int8)
    idx = tx.bits_to_symbols(m, bits)
    pts = torch.from_numpy(tx.symbols_to_iq(m, idx))
    sliced = slicers.slice_bits(m, pts).numpy()[..., :nb]
    assert np.array_equal(sliced.reshape(3, -1), bits)


def _stacks(m):
    """(port, JAX) keyword pairs: no coding; CRC-16 + PRBS15 + K7 +
    interleave; CRC-32 + punctured K7 2/3."""
    yield {}, {}
    yield (dict(crc=crc.CRC16_CCITT, lfsr=scramble.prbs15(), code=fec.CODE_K7,
                interleave_rows=4),
           dict(crc=jcrc.CRC16_CCITT, lfsr=jscramble.prbs15(),
                code=jfec.CODE_K7, interleave_rows=4))
    yield (dict(crc=crc.CRC32_MPEG2,
                code=fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_2_3)),
           dict(crc=jcrc.CRC32_MPEG2,
                code=jfec.ConvCode(7, (0o171, 0o133), jfec.PUNCTURE_2_3)))


@pytest.mark.parametrize("labeling", ["scd", "gray"])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_build_frame_and_stream_match_jax(m, labeling):
    rng = np.random.default_rng(64)
    uw = tuple(int(v) for v in rng.integers(0, m, 16))
    nb = int(np.log2(m))
    fmt = FrameFormat(uw=uw, payload=96, m=m)
    jfmt = JaxFrameFormat(uw=uw, payload=96, m=m)
    for kw, jkw in _stacks(m):
        n = fmt.payload * nb
        if "code" in kw:
            n = fec.info_bits_for(kw["code"], n)
        if "crc" in kw:
            n -= kw["crc"].degree
        infos = [rng.integers(0, 2, n, np.int8) for _ in range(3)]
        _same_bytes(tx.build_frame(fmt, infos[0], labeling=labeling, **kw),
                    jtx.build_frame(jfmt, infos[0], labeling=labeling,
                                    **jkw))
        starts = [5, 300, 600]
        for fill in (None, 1):
            _same_bytes(
                tx.frame_stream(fmt, infos, starts, 900, labeling=labeling,
                                fill=fill, seed=7, **kw),
                jtx.frame_stream(jfmt, infos, starts, 900, labeling=labeling,
                                 fill=fill, seed=7, **jkw))


@pytest.mark.parametrize("pulse", ["rect", "rrc"])
def test_shape_matches_jax(pulse):
    rng = np.random.default_rng(65)
    idx = rng.integers(0, 8, (3, 200))
    for sps, beta, span in ((8, 0.35, 8), (5, 0.25, 6)):
        _same_bytes(tx.shape(8, idx, sps, pulse, beta, span),
                    jtx.shape(8, idx, sps, pulse, beta, span))
    _same_bytes(tx.shape(4, idx[0] % 4, 4, pulse),
                jtx.shape(4, idx[0] % 4, 4, pulse))


def test_build_frame_roundtrip_fec_scramble():
    from psk_soft_tpu_torch.runtime.fec import FecFrameDecoder
    from psk_soft_tpu_torch.runtime.framesync import FrameSyncer
    from psk_soft_tpu_torch.runtime.scramble import FrameDescrambler

    rng = np.random.default_rng(62)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    lf = scramble.prbs15()
    n_info = fec.info_bits_for(fec.CODE_K7, fmt.payload * 2)
    infos = [rng.integers(0, 2, n_info, np.int8) for _ in range(2)]
    idx = tx.frame_stream(fmt, infos, [50, 400], 700, code=fec.CODE_K7,
                          lfsr=lf, seed=7)
    soft = tx.symbols_to_iq(4, idx)[None]
    sync = FrameSyncer(1, fmt, device="cpu")
    top = FrameDescrambler(FecFrameDecoder(sync, fec.CODE_K7, device="cpu"),
                           lf, device="cpu")
    sync.observe(soft.astype(np.complex64))
    sync.finalize()
    frames = top.pop_frames()
    assert [f.start for f in frames] == [50, 400]
    for f, info in zip(frames, infos):
        assert f.corrected == 0 and not f.suspect
        assert np.array_equal(f.info_bits, info)


def test_frame_stream_validation():
    fmt = FrameFormat(uw=(0, 1, 2, 3), payload=4, m=4)
    bits = np.zeros(8, np.int8)
    with pytest.raises(ValueError):
        tx.frame_stream(fmt, [bits, bits], [10, 12], 100)   # overlap
    with pytest.raises(ValueError):
        tx.frame_stream(fmt, [bits], [95], 100)             # doesn't fit
    with pytest.raises(ValueError):
        tx.build_frame(fmt, np.zeros(7, np.int8))           # wrong count
    with pytest.raises(ValueError):
        tx.shape(4, np.zeros(4, np.int64), 8, pulse="sinc")
    fill = tx.frame_stream(fmt, [bits], [4], 40, fill=2)
    assert (fill[:4] == 2).all() and (fill[12:] == 2).all()


def test_rrc_shaping_demodulates():
    """TX RRC + RX RRC matched filter composes to a clean demod."""
    from psk_soft_tpu_torch.models.blockpsk import ff_init, make_ff_demod_fn
    from psk_soft_tpu_torch.utils.transfer import to_device, to_host

    rng = np.random.default_rng(63)
    n_sym, sps = 600, 8
    idx = rng.integers(0, 4, n_sym)
    x = tx.shape(4, idx, sps, pulse="rrc")
    assert x.shape == (n_sym * sps,)
    cfg = DemodConfig(sps=sps, num_avg=50, constellation_size=4,
                      phase_avg=50, matched_filter="rrc")
    st, out = make_ff_demod_fn(cfg, channels=1)(ff_init(cfg, 1, "cpu"),
                                                to_device(x[None], "cpu"))
    out = to_host(out)
    v = out.valid[0]
    soft = out.soft[0][v][20:]      # skip the tracker-settle symbols
    assert soft.size > 480
    d = np.angle(soft * np.exp(-1j * np.pi / 4))
    frac = np.mod(d, np.pi / 2)
    dist = np.minimum(frac, np.pi / 2 - frac)
    assert dist.max() < 0.2, dist.max()
    assert np.median(dist) < 0.03
