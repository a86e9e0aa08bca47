"""Port parity, FEC and CRC: psk_soft_tpu_torch's ops/fec, ops/crc and the
plain versions of kernels B2, B3 and B4 (ops/cuda/viterbi_kernel) against
the JAX package on the CPU, fed the same numpy inputs.

Tolerances: code bits, decisions and decoded bits equal; LLRs and path
metrics within 1e-5 (float32 arithmetic in another order).  The JAX
decoders run as the JAX package's own tests run them: the XLA scan
(``viterbi_decode(backend="xla")``, held equal to the Pallas decoder by
tests/test_viterbi_kernel.py) and the Pallas kernels with interpret=True.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu.ops import crc as jcrc
from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.ops import slicers as jslicers
from psk_soft_tpu.ops.pallas import viterbi_kernel as jvk
from psk_soft_tpu_torch.ops import crc, fec, slicers
from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

torch.set_num_threads(1)

LLR_TOL = 1e-5

CODES = {
    "k3": (jfec.CODE_K3, fec.CODE_K3),
    "k7": (jfec.CODE_K7, fec.CODE_K7),
    "k9": (jfec.CODE_K9, fec.CODE_K9),
    "k7p23": (jfec.ConvCode(7, (0o171, 0o133), jfec.PUNCTURE_2_3),
              fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_2_3)),
    "k7p34": (jfec.ConvCode(7, (0o171, 0o133), jfec.PUNCTURE_3_4),
              fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_3_4)),
}


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_dataclass_fields_and_presets_match_jax():
    assert _fields(fec.ConvCode) == _fields(jfec.ConvCode)
    assert _fields(crc.CrcSpec) == _fields(jcrc.CrcSpec)
    for name in ("CODE_K7", "CODE_K9", "CODE_K3"):
        assert (dataclasses.asdict(getattr(fec, name))
                == dataclasses.asdict(getattr(jfec, name)))
    assert fec.PUNCTURE_2_3 == jfec.PUNCTURE_2_3
    assert fec.PUNCTURE_3_4 == jfec.PUNCTURE_3_4
    for name in ("CRC16_CCITT", "CRC32_MPEG2"):
        assert (dataclasses.asdict(getattr(crc, name))
                == dataclasses.asdict(getattr(jcrc, name)))
    assert crc.crc_preset("crc16") == crc.CRC16_CCITT
    with pytest.raises(ValueError, match="unknown CRC preset"):
        crc.crc_preset("crc8")
    for bad in (dict(k=1), dict(polys=(0o171,)), dict(polys=(0o400, 1)),
                dict(puncture=((0, 1), (1, 1)))):
        with pytest.raises(ValueError):
            fec.ConvCode(**bad)
    assert fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_3_4).rate == 0.75


@pytest.mark.parametrize("name", sorted(CODES))
def test_trellis_taps_and_butterfly_signs_match_jax(name):
    jcode, code = CODES[name]
    np.testing.assert_array_equal(fec._tap_planes(code),
                                  jfec._tap_planes(jcode))
    for a, b in zip(fec._trellis(code), jfec._trellis(jcode)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(vk.butterfly_signs(code),
                                  jvk.butterfly_signs(jcode))


@pytest.mark.parametrize("terminate", [True, False])
@pytest.mark.parametrize("name", sorted(CODES))
def test_conv_encode_depuncture_info_bits_match_jax(name, terminate):
    jcode, code = CODES[name]
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, (5, 66)).astype(np.int8)
    want = np.asarray(jfec.conv_encode(jcode, info, terminate=terminate))
    got = fec.conv_encode(code, info, terminate=terminate)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fec.hard_llrs(got).numpy(),
                                  np.asarray(jfec.hard_llrs(want)))
    soft = rng.standard_normal(want.shape).astype(np.float32)
    np.testing.assert_array_equal(fec.depuncture(code, soft).numpy(),
                                  np.asarray(jfec.depuncture(jcode, soft)))
    n_code = want.shape[-1]
    assert (fec.info_bits_for(code, n_code, terminate)
            == jfec.info_bits_for(jcode, n_code, terminate) == 66)
    with pytest.raises(ValueError):
        fec.info_bits_for(code, n_code + 1)


@pytest.mark.parametrize("scale", [None, 2.5])
@pytest.mark.parametrize("labeling", ["scd", "gray"])
@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_psk_llrs_and_bit_labels_match_jax(m, labeling, scale):
    np.testing.assert_array_equal(slicers.bit_labels(m, labeling),
                                  jslicers.bit_labels(m, labeling))
    rng = np.random.default_rng(m)
    soft = (rng.standard_normal((3, 40))
            + 1j * rng.standard_normal((3, 40))).astype(np.complex64)
    want = np.asarray(jfec.psk_llrs(m, soft, scale=scale, labeling=labeling))
    got = fec.psk_llrs(m, torch.from_numpy(soft), scale=scale,
                       labeling=labeling)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LLR_TOL, rtol=0)


def test_psk_llrs_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="constellation"):
        fec.psk_llrs(3, torch.zeros(4, dtype=torch.complex64))
    with pytest.raises(ValueError, match="labeling"):
        slicers.bit_labels(4, "natural")


@pytest.mark.parametrize("spec", ["crc16", "crc32"])
def test_crc_matches_jax(spec):
    jspec, tspec = jcrc.crc_preset(spec), crc.crc_preset(spec)
    assert crc.crc_serial(tspec, np.unpackbits(
        np.frombuffer(b"123456789", np.uint8))) == (
            0x29B1 if spec == "crc16" else 0x0376E6E7)
    rng = np.random.default_rng(11)
    msg = rng.integers(0, 2, (4, 7, 77)).astype(np.int8)
    np.testing.assert_array_equal(crc.crc_bits(tspec, msg).numpy(),
                                  np.asarray(jcrc.crc_bits(jspec, msg)))
    framed = crc.append_crc(tspec, msg)
    np.testing.assert_array_equal(framed, jcrc.append_crc(jspec, msg))
    framed[1, 2, 5] ^= 1
    got_m, got_ok = crc.check_crc(tspec, framed)
    want_m, want_ok = jcrc.check_crc(jspec, framed)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_ok, want_ok)
    assert not got_ok[1, 2] and got_ok.sum() == 27
    with pytest.raises(ValueError):
        crc.check_crc(tspec, framed[..., :tspec.degree])


def _code_llrs(jcode, rows, n_info, hard, seed):
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (rows, n_info)).astype(np.int8)
    bits = np.asarray(jfec.conv_encode(jcode, info))
    if hard:                                   # +/-1 LLRs: full of ties
        flip = rng.random(bits.shape) < 0.05
        return np.array(jfec.hard_llrs(bits ^ flip))
    return ((1.0 - 2.0 * bits)
            + 0.8 * rng.standard_normal(bits.shape)).astype(np.float32)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("terminate", [True, False])
@pytest.mark.parametrize("name", sorted(CODES))
def test_plain_viterbi_decoders_match_jax(name, terminate, hard):
    """ops/fec.viterbi_decode (plain scan), and viterbi_decode_kernel along
    the fused (B2) and two-phase (B3 + B4, t_tile given) dispatch, all
    equal to the JAX decoder bit for bit."""
    jcode, code = CODES[name]
    llr = _code_llrs(jcode, 24, 66, hard, seed=len(name))
    want = np.asarray(jfec.viterbi_decode(jcode, llr, terminate=terminate,
                                          backend="xla"))
    t = torch.from_numpy(llr)
    got = [fec.viterbi_decode(code, t, terminate=terminate),
           fec.make_viterbi_fn(code, terminate)(llr),
           vk.viterbi_decode_kernel(code, t, terminate=terminate),
           vk.viterbi_decode_kernel(code, t, terminate=terminate,
                                    t_tile=16)]
    for g in got:
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), want)


def test_long_trellis_takes_the_two_phase_path():
    """Past the fused kernel's shared-memory budget the dispatch runs
    B3 + B4 (here their plain versions), still equal to JAX."""
    jcode, code = CODES["k9"]
    t = 1500
    assert not vk.fused_fits(code.states, t) and vk.fused_fits(64, 64)
    llr = _code_llrs(jcode, 3, t - (code.k - 1), False, seed=5)
    want = np.asarray(jfec.viterbi_decode(jcode, llr, backend="xla"))
    got = vk.viterbi_decode_kernel(code, torch.from_numpy(llr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_plain_versions_match_pallas_kernels():
    """viterbi_acs_ref / viterbi_traceback_ref / viterbi_fused_ref against
    the Pallas kernels (interpret mode) on the same planes: decisions and
    bits equal, final metrics within 1e-5, padding rows zero."""
    rng = np.random.default_rng(21)
    b, t, t_pad, s = 128, 20, 32, 64
    llr = rng.standard_normal((2, t_pad, b)).astype(np.float32)
    pm0 = np.full((s, b), -1e9, np.float32)
    pm0[0] = 0.0
    pm0[:, 7] = rng.standard_normal(s)          # an arbitrary start row
    exp = jvk.butterfly_signs(jfec.CODE_K7)
    kw = dict(k=7, s_count=s, n=2, t_actual=t)
    jdec, jpm = jvk.viterbi_acs(jnp.asarray(llr), jnp.asarray(pm0),
                                jnp.asarray(exp), t_tile=t_pad,
                                interpret=True, **kw)
    tl, tp, te = map(torch.from_numpy, (llr, pm0, exp))
    dec, pm = vk.viterbi_acs(tl, tp, te, **kw)
    np.testing.assert_array_equal(dec.numpy()[:t], np.asarray(jdec)[:t])
    assert not dec[t:].any()
    np.testing.assert_allclose(pm.numpy(), np.asarray(jpm), atol=LLR_TOL,
                               rtol=0)
    start = rng.integers(0, s, (1, b)).astype(np.int32)
    jbits = jvk.viterbi_traceback(jdec, jnp.asarray(start), k=7, s_count=s,
                                  t_actual=t, t_tile=t_pad, interpret=True)
    bits = vk.viterbi_traceback(dec, torch.from_numpy(start), k=7,
                                s_count=s, t_actual=t)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    for terminate in (True, False):
        jf = jvk.viterbi_fused(jnp.asarray(llr), jnp.asarray(pm0),
                               jnp.asarray(exp), t_pad=t_pad,
                               terminate=terminate, interpret=True, **kw)
        f = vk.viterbi_fused(tl, tp, te, terminate=terminate, **kw)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert (vk.viterbi_fused.launches, vk.viterbi_acs.launches,
            vk.viterbi_traceback.launches) == (0, 0, 0)   # CPU: plain


def test_kernel_wrappers_validate():
    z = torch.zeros
    kw = dict(k=7, s_count=64, n=2, t_actual=4)
    with pytest.raises(ValueError, match="s_count"):
        vk.viterbi_acs(z(2, 4, 8), z(32, 8), z(64, 2), **{**kw,
                                                           "s_count": 32})
    with pytest.raises(ValueError, match="pm0"):
        vk.viterbi_fused(z(2, 4, 8), z(64, 9), z(128, 2), terminate=True,
                         **kw)
    with pytest.raises(ValueError, match="t_actual"):
        vk.viterbi_acs(z(2, 4, 8), z(64, 8), z(128, 2), **{**kw,
                                                            "t_actual": 5})
    with pytest.raises(ValueError, match="int8"):
        vk.viterbi_traceback(z(4, 64, 8), z(1, 8, dtype=torch.int32), k=7,
                             s_count=64, t_actual=4)
    with pytest.raises(ValueError, match="device"):
        vk.viterbi_acs(z(2, 4, 8, device="meta"), z(64, 8, device="meta"),
                       z(128, 2, device="meta"), **kw)
    with pytest.raises(ValueError, match="flush"):
        fec.viterbi_decode(fec.CODE_K7, z(2, 12))


@pytest.mark.parametrize("fn", ["viterbi_stream_init", "viterbi_stream_step",
                                "viterbi_stream_flush",
                                "viterbi_decode_parallel",
                                "make_stream_soft_fn"])
def test_streaming_decoders_wait_for_their_step(fn):
    """Each streaming / time-parallel entry point runs on a CPU tensor and
    equals the JAX package's (XLA backend) on the same inputs: bits and
    decision windows equal, metrics within 1e-4."""
    rng = np.random.default_rng(31)
    jcode, code = CODES["k7"]
    bits = rng.integers(0, 2, (2, 200)).astype(np.int8)
    coded = fec.conv_encode(code, bits, terminate=False).numpy()
    llr = ((1.0 - 2.0 * coded)
           + 0.6 * rng.standard_normal(coded.shape)).astype(np.float32)
    steps = llr.reshape(2, -1, 2)
    jst = jfec.viterbi_stream_init(jcode, 2, 40, known_start=False)
    st = fec.viterbi_stream_init(code, 2, 40, known_start=False,
                                 device="cpu")

    def same_state(st, jst):
        np.testing.assert_array_equal(st.dec.numpy(), np.asarray(jst.dec))
        np.testing.assert_allclose(st.pm.numpy(), np.asarray(jst.pm),
                                   atol=1e-4, rtol=0)

    if fn == "viterbi_stream_init":
        assert st.pm.dtype == torch.float32 and st.dec.dtype == torch.bool
        same_state(st, jst)
    elif fn in ("viterbi_stream_step", "viterbi_stream_flush"):
        for lo in (0, 60):
            jst, jb = jfec.viterbi_stream_step(jcode, jst, steps[:, lo:lo + 60],
                                               backend="xla")
            st, b = fec.viterbi_stream_step(code, st, torch.from_numpy(
                steps[:, lo:lo + 60]))
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
            same_state(st, jst)
        if fn == "viterbi_stream_flush":
            np.testing.assert_array_equal(
                fec.viterbi_stream_flush(code, st).numpy(),
                np.asarray(jfec.viterbi_stream_flush(jcode, jst)))
    elif fn == "viterbi_decode_parallel":
        got = fec.viterbi_decode_parallel(code, torch.from_numpy(llr),
                                          chunk=48, margin=35)
        want = jfec.viterbi_decode_parallel(jcode, llr, chunk=48, margin=35,
                                            backend="xla")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        soft = (rng.standard_normal((2, 32))
                + 1j * rng.standard_normal((2, 32))).astype(np.complex64)
        st, b = fec.make_stream_soft_fn(code, 4)(st, torch.from_numpy(soft))
        jst, jb = jfec.make_stream_soft_fn(jcode, 4, backend="xla")(
            jst, jnp.asarray(soft))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        same_state(st, jst)
