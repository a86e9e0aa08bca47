"""The bank engine's host packet assembly (runtime/native_assemble over
csrc/assemble.cpp) against the numpy expressions it replaced in
BankAssembler.assemble_tm, kept here as the reference: every payload equal
element for element, with the same dtype and shape, at tile edges (S of 1,
7, 63, 64, 65, 512) over 128 and 1024 channels; and assemble_tm's packets
against the numpy assembly under valid_rows masks, int8 soft and debug
ports off, each block's packets in arrays of their own."""

import zlib

import numpy as np
import pytest
import torch

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models.full import (FullOutputs, QuantSoft,
                                            dequantize_soft)
from psk_soft_tpu_torch.runtime import native_assemble
from psk_soft_tpu_torch.runtime.engine_bank import BankAssembler, TMOutputs
from psk_soft_tpu_torch.runtime.streams import (PORT_BITS, PORT_PHASE,
                                                PORT_SAMPLE_INDEX, PORT_SOFT,
                                                SRI)

torch.set_num_threads(1)

CHANNELS = (128, 1024)
SYMBOLS = (1, 7, 63, 64, 65, 512)
SHAPES = [(s, c) for c in CHANNELS for s in SYMBOLS]
IDS = [f"S{s}-C{c}" for s, c in SHAPES]


# ---- the numpy assembly the native pass replaced --------------------------

def ref_soft(s_re, s_im, scale):
    if scale:
        return dequantize_soft(QuantSoft(s_re, s_im, scale))
    soft_t = np.empty(s_re.shape, np.complex64)
    soft_t.real = s_re
    soft_t.imag = s_im
    return soft_t


def ref_bits(packed, nb):
    return ((packed.T[:, :, None] >> np.arange(nb)) & 1).astype(
        np.int16).reshape(packed.shape[1], -1)


def ref_phase(phase_p):
    return phase_p.T.astype(np.float32)


def ref_sample_index(sidx_p):
    return sidx_p.T.astype(np.int16)


def ref_assemble_tm(asm, tm, eos=False):
    """BankAssembler.assemble_tm as it was before the native pass."""
    fo, v = tm.fo, tm.valid_rows
    s_re, s_im, phase_p, packed, sidx_p = (
        None if a is None else np.asarray(a)
        for a in (fo.soft_re, fo.soft_im, fo.phase, fo.bits_packed,
                  fo.sample_index))
    if v is not None and not v.any():
        return asm.assemble(None, eos=eos)
    if v is not None:
        s_re, s_im, packed = s_re[v], s_im[v], packed[v]
        phase_p = None if phase_p is None else phase_p[v]
        sidx_p = None if sidx_p is None else sidx_p[v]
    pkt = asm._advance_clock(s_re.shape[0], eos)
    soft_t = ref_soft(s_re, s_im, tm.soft_scale)
    pkts = {PORT_SOFT: pkt(soft_t.T, PORT_SOFT),
            PORT_BITS: pkt(ref_bits(packed, asm.cfg.bits_per_symbol),
                           PORT_BITS)}
    if not asm.skip_debug and phase_p is not None:
        pkts[PORT_PHASE] = pkt(ref_phase(phase_p), PORT_PHASE)
    if not asm.skip_debug and sidx_p is not None:
        pkts[PORT_SAMPLE_INDEX] = pkt(ref_sample_index(sidx_p),
                                      PORT_SAMPLE_INDEX)
    return pkts


# ---- planes ---------------------------------------------------------------

def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _soft_planes(rng, shape, i8):
    if i8:
        return tuple(rng.integers(-128, 128, shape, dtype=np.int8)
                     for _ in range(2))
    re, im = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    special = np.float32([np.inf, -0.0, np.nan, 1e-45, -3e38])
    k = min(re.size, special.size)
    re.reshape(-1)[:k] = special[:k]
    return re, im


def _int_plane(rng, shape, dtype, lo=None, hi=None):
    info = np.iinfo(dtype)
    lo = info.min if lo is None else lo
    hi = info.max + 1 if hi is None else hi
    return rng.integers(lo, hi, shape, dtype=dtype)


def _assert_same(got, want):
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- each payload -------------------------------------------------------

@pytest.mark.parametrize("scale", [None, 100.0, 37.5],
                         ids=["f32", "i8-100", "i8-37.5"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_soft_matches_numpy(shape, scale):
    s_re, s_im = _soft_planes(_rng("soft", shape, scale), shape, bool(scale))
    got = native_assemble.soft(s_re, s_im, scale)
    want = ref_soft(s_re, s_im, scale)
    _assert_same(got, want)
    # bit for bit, NaN payloads and signed zeros included
    _assert_same(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("nb", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["i8", "i32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bits_match_numpy(shape, dtype, nb):
    packed = _int_plane(_rng("bits", shape, dtype, nb), shape, dtype)
    _assert_same(native_assemble.bits(packed, nb), ref_bits(packed, nb))


@pytest.mark.parametrize("shape", [(512, 128), (65, 1024)],
                         ids=["S512-C128", "S65-C1024"])
def test_bits_of_a_mixed_bank_match_numpy(shape):
    """A mixed bank's ports are as wide as its largest M (32: 5 bits);
    channels of smaller M leave their high bits 0."""
    rng = _rng("mixed", shape)
    m_bits = rng.choice([1, 2, 3, 4, 5], shape[1])
    packed = (rng.integers(0, 32, shape) % (1 << m_bits)).astype(np.int8)
    _assert_same(native_assemble.bits(packed, 5), ref_bits(packed, 5))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_phase_matches_numpy(shape):
    plane = _rng("phase", shape).standard_normal(shape).astype(np.float32)
    got = native_assemble.phase(plane)
    _assert_same(got, ref_phase(plane))
    assert got.flags.c_contiguous


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["i8", "i32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sample_index_matches_numpy(shape, dtype):
    # int32 planes reach past int16, where both wrap to 16 bits
    plane = _int_plane(_rng("sidx", shape, dtype), shape, dtype)
    got = native_assemble.sample_index(plane)
    _assert_same(got, ref_sample_index(plane))
    assert got.flags.c_contiguous


def test_payloads_read_strided_planes():
    """Non-contiguous planes are read as their values, not their memory."""
    rng = _rng("strided")
    wide = rng.standard_normal((64, 256)).astype(np.float32)
    plane = wide[:, ::2]
    _assert_same(native_assemble.phase(plane), ref_phase(plane))
    packed = _int_plane(rng, (128, 64), np.int32)[::2]
    _assert_same(native_assemble.bits(packed, 3), ref_bits(packed, 3))


def test_bad_planes_are_refused():
    f32 = np.zeros((4, 128), np.float32)
    with pytest.raises(ValueError, match="plane"):
        native_assemble.bits(f32, 2)
    with pytest.raises(ValueError, match="plane"):
        native_assemble.sample_index(np.zeros((4, 128), np.int16))
    with pytest.raises(ValueError, match="plane"):
        native_assemble.soft(f32, f32, 100.0)       # int8 planes expected
    with pytest.raises(ValueError, match="plane"):
        native_assemble.phase(np.zeros(128, np.float32))
    with pytest.raises(ValueError, match="differ"):
        native_assemble.soft(f32, f32[:3])
    with pytest.raises(ValueError, match="nb"):
        native_assemble.bits(np.zeros((4, 128), np.int8), 0)


# ---- BankAssembler.assemble_tm ------------------------------------------

def _fo(rng, s, c, *, i8=False, wide=False, debug=True, nb=2):
    """Time-major kernel planes as the kernel's plain version returns them:
    CPU tensors (int32 bit and index planes when sps > 128)."""
    idt = np.int32 if wide else np.int8
    s_re, s_im = _soft_planes(rng, (s, c), i8)
    t = torch.from_numpy
    return FullOutputs(
        soft_re=t(s_re), soft_im=t(s_im),
        phase=(t(rng.standard_normal((s, c)).astype(np.float32))
               if debug else None),
        bits_packed=t(_int_plane(rng, (s, c), idt, 0, 1 << nb)),
        sample_index=(t(_int_plane(rng, (s, c), idt, 0, 300 if wide
                                   else 128)) if debug else None))


def _assembler(debug=True, m=4):
    asm = BankAssembler(DemodConfig(sps=8, num_avg=20, constellation_size=m,
                                    phase_avg=10), skip_debug=not debug)
    asm.set_sri(SRI(stream_id="tm", xdelta=2e-6), t=1.5)
    return asm


def _assert_packets(got, want):
    assert set(got) == set(want)
    for port in want:
        g, w = got[port], want[port]
        _assert_same(np.asarray(g.data), np.asarray(w.data))
        assert (g.t, g.sri, g.eos, g.sri_changed) == \
            (w.t, w.sri, w.eos, w.sri_changed), port


def _masks(s):
    rng = _rng("mask", s)
    return {"all": None, "prefix": np.arange(s) < s - 5,
            "scattered": rng.random(s) < 0.5, "empty": np.zeros(s, bool)}


@pytest.mark.parametrize("eos", [False, True], ids=["block", "eos"])
@pytest.mark.parametrize("mask", ["all", "prefix", "scattered", "empty"])
@pytest.mark.parametrize("mode", ["f32", "i8", "i32-planes", "no-debug",
                                  "8psk"])
def test_assemble_tm_matches_numpy(mode, mask, eos):
    s, c = 64, 128
    nb = 3 if mode == "8psk" else 2
    debug = mode != "no-debug"
    scale = 37.5 if mode == "i8" else None
    rng = _rng("tm", mode, mask, eos)
    blocks = [_fo(rng, s, c, i8=scale is not None,
                  wide=mode == "i32-planes", debug=debug, nb=nb)
              for _ in range(2)]
    got_asm, want_asm = (_assembler(debug, 1 << nb) for _ in range(2))
    v = _masks(s)[mask]
    for fo in blocks:             # two blocks: the symbol clock advances
        tm = TMOutputs(fo=fo, valid_rows=v, soft_scale=scale)
        got = got_asm.assemble_tm(tm, eos=eos)
        _assert_packets(got, ref_assemble_tm(want_asm, tm, eos=eos))
        if mask == "empty":
            assert bool(got) == eos
        else:
            assert (PORT_PHASE in got) == debug
            assert got[PORT_SOFT].data.shape == (c, int(
                s if v is None else v.sum()))


def test_consecutive_blocks_share_no_memory():
    asm = _assembler()
    rng = _rng("fresh")
    fos = [_fo(rng, 64, 128) for _ in range(2)]
    first, second = (asm.assemble_tm(TMOutputs(fo=fo)) for fo in fos)
    planes = [np.asarray(a) for fo in fos for a in fo]
    for port in first:
        a = first[port].data
        for b in [second[p].data for p in second] + planes:
            assert not np.shares_memory(a, b), port


def test_assembler_builds_the_library_when_made(monkeypatch):
    """The library is loaded as the assembler is made, before any block."""
    calls = []
    monkeypatch.setattr(native_assemble, "load",
                        lambda: calls.append(1))
    _assembler()
    assert calls == [1]
