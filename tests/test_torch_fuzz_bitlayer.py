"""Port parity, the JAX package's randomized bit-layer suites: the loopback
cases of tests/test_fuzz_bitlayer.py and the soaks of
tests/test_soak_receiver.py, drawn from the port's copies of their
generators (psk_soft_tpu_torch/testing/conformance), through the port's
stages on the CPU and the JAX stages.

* The case list equals the JAX module's ``CASES`` (codes, scramblers and
  CRCs field by field).
* Loopback: tx.frame_stream -> FrameSyncer -> FecFrameDecoder ->
  FrameDescrambler -> FrameCrcChecker returns every frame's info bits
  exactly with the CRC green, and the frames equal the JAX stack's on the
  same soft stream (channel, start, rotation, bits, info bits, CRC and
  corrections equal; corr within 1e-5, tests/test_torch_sync_stack.py's
  bound).
* Frame-stack soak: ragged observes, drains, finalizes and resets through
  a 16-frame ring, held to the JAX test's invariants (as the JAX suite
  holds its own stack).  The JAX stack compiles anew for every buffer
  length it meets, ~30 s a seed, so its run is not repeated here; the
  loopback cases hold the same stages' frames equal to JAX's.
* Stream-FEC soak: ragged observes, pops, resets and finalizes through
  StreamFecDecoder at K7 (the JAX test's code) and K3: the port's decoder,
  fed the JAX LLRs, keeps the JAX test's invariants and equals the JAX
  decoder bit for bit and step for step, and its own LLRs lie within 1e-6
  of JAX's on every block it decodes.  (On the port's own
  LLRs a K3 decode can differ from JAX's at an ACS decision within float32
  rounding of a tie: the soak's symbols are random, not a codeword, and
  the two packages' LLRs differ by up to 4.8e-7; ROADMAP, "Known gaps".)
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu.ops import fec as jfec
from psk_soft_tpu.ops.fec import CODE_K3 as JCODE_K3
from psk_soft_tpu.ops.fec import CODE_K7 as JCODE_K7
from psk_soft_tpu.ops.framesync import FrameFormat as JFrameFormat
from psk_soft_tpu.runtime.crc import FrameCrcChecker as JFrameCrcChecker
from psk_soft_tpu.runtime.fec import FecFrameDecoder as JFecFrameDecoder
from psk_soft_tpu.runtime.fec import StreamFecDecoder as JStreamFecDecoder
from psk_soft_tpu.runtime.framesync import FrameSyncer as JFrameSyncer
from psk_soft_tpu.runtime.scramble import FrameDescrambler as JDescrambler
from psk_soft_tpu_torch.ops import fec as pfec
from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
from psk_soft_tpu_torch.ops.fec import CODE_K3, CODE_K7
from psk_soft_tpu_torch.ops.framesync import FrameFormat
from psk_soft_tpu_torch.ops.scramble import prbs15
from psk_soft_tpu_torch.runtime.crc import FrameCrcChecker
from psk_soft_tpu_torch.runtime.fec import FecFrameDecoder, StreamFecDecoder
from psk_soft_tpu_torch.runtime.framesync import FrameSyncer
from psk_soft_tpu_torch.runtime.scramble import FrameDescrambler
from psk_soft_tpu_torch.testing import conformance as cf
from psk_soft_tpu_torch.tools.gates import check_fec_soak, check_loopback

torch.set_num_threads(1)

TOL = 1e-5
PORT = (FrameSyncer, FecFrameDecoder, FrameDescrambler, FrameCrcChecker)
JAX = (JFrameSyncer, JFecFrameDecoder, JDescrambler, JFrameCrcChecker)


def _jax_cases():
    path = Path(__file__).resolve().parent / "test_fuzz_bitlayer.py"
    spec = importlib.util.spec_from_file_location("_jax_fuzz_bitlayer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


def _fields(obj):
    return None if obj is None else (type(obj).__name__,
                                     dataclasses.astuple(obj))


def test_bitlayer_case_list_equals_jax():
    ours = [(m, p, _fields(code), il, lab, _fields(lf), _fields(crc))
            for (m, p, _, il, lab, _, _), (code, lf, crc) in zip(
                cf.BITLAYER_CASES, map(cf.bitlayer_parts, cf.BITLAYER_CASES))]
    theirs = [(m, p, _fields(code), il, lab, _fields(lf), _fields(crc))
              for m, p, code, il, lab, lf, crc in _jax_cases()]
    assert ours == theirs


def _same_frames(got, want):
    key = [(f.channel, f.start, f.rotation, f.bits.tobytes(),
            None if f.info_bits is None else f.info_bits.tobytes(),
            f.crc_ok, f.corrected, f.suspect) for f in (got, want)]
    assert key[0] == key[1]
    assert abs(got.corr - want.corr) <= TOL


@pytest.mark.parametrize("index", range(len(cf.BITLAYER_CASES)),
                         ids=[cf.bitlayer_id(c) for c in cf.BITLAYER_CASES])
def test_bitlayer_loopback(index):
    case = cf.BITLAYER_CASES[index]
    m, payload, _, il_rows, labeling, _, _ = case
    code, lfsr, crc = cf.bitlayer_parts(case)
    uw, starts, infos, soft = cf.bitlayer_stream(case)
    sync, top = cf.frame_stack(PORT, 1, FrameFormat(uw=uw, payload=payload,
                                                    m=m, threshold=0.6),
                               code, lfsr, crc, il_rows, labeling,
                               device="cpu")
    frames = sorted(cf.run_loopback(sync, top, soft), key=lambda f: f.start)
    assert len(frames) == len(starts)
    for f, info in zip(frames, infos[0]):
        assert f.start in starts
        got = f.info_bits if code is not None else f.bits
        if crc is not None:
            assert f.crc_ok is True
        np.testing.assert_array_equal(got, info)

    _, _, jcode, _, _, jlf, jcrc = _jax_cases()[index]
    jsync, jtop = cf.frame_stack(JAX, 1, JFrameFormat(uw=uw, payload=payload,
                                                      m=m, threshold=0.6),
                                 jcode, jlf, jcrc, il_rows, labeling)
    want = sorted(cf.run_loopback(jsync, jtop, soft), key=lambda f: f.start)
    assert len(want) == len(frames)
    for a, b in zip(frames, want):
        _same_frames(a, b)


@pytest.mark.parametrize("seed", cf.FRAME_SOAK_SEEDS)
def test_frame_stack_soak(seed):
    uw, n_msg, script = cf.frame_soak_script(seed)
    fmt = FrameFormat(uw=uw, payload=64, m=4, threshold=0.7)
    sync, top = cf.frame_stack(PORT, 2, fmt, CODE_K7, prbs15(), CRC16_CCITT,
                               max_frames=cf.FRAME_SOAK_MAX_FRAMES,
                               device="cpu")
    got = cf.run_frame_soak(sync, top, script)

    # tests/test_soak_receiver.py:31-84's invariants on the port's stack.
    drained, last_synced = 0, 0
    for ev, frames, synced, _, decoded, descrambled, checked in got:
        drained += len(frames)
        for f in frames:
            assert f.channel in (0, 1) and f.start >= 0
            assert f.info_bits.shape == (n_msg,)
            assert f.corrected >= 0 and isinstance(f.crc_ok, bool)
        assert synced >= last_synced
        last_synced = synced
        assert checked == decoded == descrambled
    assert drained + len(sync.frames) <= sync.frames_synced \
        - sync.dropped_frames + cf.FRAME_SOAK_MAX_FRAMES


_PORT_LLRS = pfec.psk_llrs
_JAX_LLRS = jax.jit(jfec.psk_llrs, static_argnums=(0,),
                    static_argnames=("labeling",))


def _jax_llrs(m, soft, scale=None, labeling="scd"):
    """The JAX package's psk_llrs on a port tensor (what the JAX stream
    decoder computes inside its step), after holding the port's own LLRs
    of the same block within 1e-6 of them."""
    assert scale is None
    want = np.array(_JAX_LLRS(m, jnp.asarray(soft.numpy()),
                              labeling=labeling))
    np.testing.assert_allclose(_PORT_LLRS(m, soft, labeling=labeling)
                               .numpy(), want, rtol=0, atol=1e-6)
    return torch.from_numpy(want)


@pytest.mark.parametrize("seed", cf.FEC_SOAK_SEEDS)
@pytest.mark.parametrize("k", [7, 3])
def test_stream_fec_soak(seed, k, monkeypatch):
    script = cf.fec_soak_script(seed)
    code, jcode = {7: (CODE_K7, JCODE_K7), 3: (CODE_K3, JCODE_K3)}[k]
    # The port's decoder on the JAX LLRs, its own held to them block by
    # block.
    monkeypatch.setattr(pfec, "psk_llrs", _jax_llrs)
    dec = StreamFecDecoder(2, code, m=4, depth=cf.FEC_SOAK_DEPTH,
                           block_steps=cf.FEC_SOAK_BLOCK, device="cpu")
    got = cf.run_fec_soak(dec, script)
    # tests/test_soak_receiver.py:87-115's invariants on the port's run.
    popped = 0
    for ev, bits, steps in got:
        if ev == "pop":
            assert bits.shape[0] == 2 and ((bits == 0) | (bits == 1)).all()
            popped += bits.shape[1]
        elif ev == "reset":
            popped = steps
    assert popped <= dec.steps_decoded

    jdec = JStreamFecDecoder(2, jcode, m=4, depth=cf.FEC_SOAK_DEPTH,
                             block_steps=cf.FEC_SOAK_BLOCK)
    want = cf.run_fec_soak(jdec, script)
    for (ev, a, sa), (_, b, sb) in zip(got, want):
        assert sa == sb, ev
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_bitlayer_gates_refuse_wrong_results():
    """check_loopback and check_fec_soak (chip_smoke.py phase 29's gates)
    pass the port's own runs and refuse a flipped bit, a lost frame and a
    skewed step count."""
    case = cf.BITLAYER_CASES[1]
    m, payload, _, il_rows, labeling, _, _ = case
    code, lfsr, crc = cf.bitlayer_parts(case)
    uw, starts, infos, soft = cf.bitlayer_stream(case, 2)
    sync, top = cf.frame_stack(PORT, 2, FrameFormat(uw=uw, payload=payload,
                                                    m=m, threshold=0.6),
                               code, lfsr, crc, il_rows, labeling,
                               device="cpu")
    frames = cf.run_loopback(sync, top, soft)
    assert check_loopback("t", frames, starts, infos, True, True) == 6
    bad = infos.copy()
    bad[1, 2, 0] ^= 1
    with pytest.raises(AssertionError, match="bits or CRC"):
        check_loopback("t", frames, starts, bad, True, True)
    with pytest.raises(AssertionError, match="5 frames of 6"):
        check_loopback("t", frames[1:], starts, infos, True, True)

    script = cf.fec_soak_script(400)[:12]
    dec = StreamFecDecoder(2, CODE_K3, m=4, depth=cf.FEC_SOAK_DEPTH,
                           block_steps=cf.FEC_SOAK_BLOCK, device="cpu")
    run = cf.run_fec_soak(dec, script)
    assert check_fec_soak("t", run, run) > 0
    flipped = [(ev, None if b is None else b ^ (i == 3), s)
               for i, (ev, b, s) in enumerate(run)]
    with pytest.raises(AssertionError, match="popped bits differ"):
        check_fec_soak("t", flipped, run)
    skewed = run[:-1] + [run[-1][:2] + (run[-1][2] + 1,)]
    with pytest.raises(AssertionError, match="steps"):
        check_fec_soak("t", skewed, run)
