"""Port parity, the AGC front end: psk_soft_tpu_torch's
runtime/agc.AgcFrontEnd against the JAX package's on the CPU, fed the same
numpy blocks, planes and ragged pushes.

Tolerances (tests/test_agc.py's): gained samples within 1e-4 between the
host ragged and the device paths and 1e-5 between the block and plane
paths and against JAX on the same path; tracked powers within rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops.agc import AgcConfig as JaxAgcConfig
from psk_soft_tpu.runtime.agc import AgcFrontEnd as JaxAgc
from psk_soft_tpu.runtime.engine import BatchEngine as JaxBatchEngine
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops.agc import AgcConfig
from psk_soft_tpu_torch.runtime.agc import AgcFrontEnd
from psk_soft_tpu_torch.runtime.engine_batch import BatchEngine
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine

torch.set_num_threads(1)


def _sig(c, t, seed=0, amp=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((c, t)) + 1j * rng.standard_normal((c, t))
         ).astype(np.complex64)
    return (amp * x / np.sqrt(2.0)).astype(np.complex64)


class _Sink:
    """Capture-only stand-in with the bank-engine ingest surface (numpy
    and tensors alike are kept as numpy, channel-major)."""

    def __init__(self, channels, sps=8):
        self.cfg = DemodConfig(sps=sps, num_avg=20, phase_avg=10)
        self.channels = channels
        self.device = torch.device("cpu")
        self.got = [[] for _ in range(channels)]
        self.kinds = []

    def push(self, c, x):
        self.got[c].append(np.asarray(x))
        self.kinds.append("push")

    def push_block(self, x):
        self.kinds.append(type(x).__name__)
        for c in range(self.channels):
            self.push(c, np.asarray(x[c]))

    def push_planes(self, re, im):
        self.kinds.append(type(re).__name__)
        y = np.asarray(re).T + 1j * np.asarray(im).T
        for c in range(self.channels):
            self.push(c, y[c].astype(np.complex64))

    def chan(self, c):
        return (np.concatenate(self.got[c]) if self.got[c]
                else np.zeros(0, np.complex64))

    def all(self):
        return np.stack([self.chan(c) for c in range(self.channels)])


def _pair(cfg_kw, c):
    jsink, tsink = _Sink(c), _Sink(c)
    return (JaxAgc(jsink, JaxAgcConfig(**cfg_kw)), jsink,
            AgcFrontEnd(tsink, AgcConfig(**cfg_kw)), tsink)


@pytest.mark.parametrize("path", ["block", "planes", "ragged"])
def test_agc_front_end_matches_jax(path):
    """Each path of the port against the same path of JAX: gained
    samples, gains_db and squelch state (squelch on, a quiet channel)."""
    cfg_kw = dict(alpha=0.03, chunk=8, squelch_power=1e-3)
    x = _sig(3, 2048, seed=11, amp=5.0)
    x[2] *= 1e-3                                  # below the squelch
    jagc, jsink, agc, sink = _pair(cfg_kw, 3)
    for half in np.split(x, [1024], axis=1):
        if path == "block":
            jagc.push_block(half)
            agc.push_block(half)
        elif path == "planes":
            re = np.ascontiguousarray(half.real.T)
            im = np.ascontiguousarray(half.imag.T)
            jagc.push_planes(re, im)
            agc.push_planes(torch.from_numpy(re), torch.from_numpy(im))
        else:
            rng = np.random.default_rng(half.shape[1])
            for c in range(3):
                pos = 0
                while pos < half.shape[1]:
                    n = min(int(rng.integers(1, 300)), half.shape[1] - pos)
                    jagc.push(c, half[c, pos:pos + n])
                    agc.push(c, half[c, pos:pos + n])
                    pos += n
    tol = 1e-5 if path != "ragged" else 1e-6
    np.testing.assert_allclose(sink.all(), jsink.all(), atol=tol, rtol=0)
    np.testing.assert_allclose(agc.gains_db, jagc.gains_db, atol=1e-4)
    np.testing.assert_array_equal(agc.squelched, jagc.squelched)
    assert list(agc.squelched) == [False, False, True]
    if path != "ragged":
        # The device paths hand tensors on.
        assert set(sink.kinds) == {"Tensor", "push"}


def test_host_ragged_equals_device_block():
    """tests/test_agc.py's gate on the port alone: ragged per-channel
    pushes (sub-chunk remainders staged) equal one device block within
    1e-4, powers within rtol 1e-4; then the paths interleave (block,
    ragged, planes), each re-seeding from the other's carry, as in JAX."""
    cfg = AgcConfig(alpha=0.03, chunk=8, squelch_power=1e-4)
    x = _sig(3, 2048, seed=11, amp=5.0)
    dev_sink, host_sink = _Sink(3), _Sink(3)
    dev, host = AgcFrontEnd(dev_sink, cfg), AgcFrontEnd(host_sink, cfg)
    dev.push_block(torch.from_numpy(x))
    for c in range(3):
        pos = 0
        rng = np.random.default_rng(c)
        while pos < x.shape[1]:
            n = min(int(rng.integers(1, 300)), x.shape[1] - pos)
            host.push(c, x[c, pos:pos + n])
            pos += n
    for c in range(3):
        a, b = dev_sink.chan(c), host_sink.chan(c)
        n = min(a.size, b.size)
        assert n >= x.shape[1] - cfg.chunk
        np.testing.assert_allclose(a[:n], b[:n], atol=1e-4)
    np.testing.assert_allclose(dev.gains_db, host.gains_db, atol=1e-3)

    cfg_kw = dict(alpha=0.05, chunk=8)
    jagc, jsink, agc, sink = _pair(cfg_kw, 2)
    y = _sig(2, 3 * 512, seed=3, amp=0.3)
    a, b, d = np.split(y, [512, 1024], axis=1)
    for fe in (jagc, agc):
        fe.push_block(a)
        for c in range(2):
            fe.push(c, b[c])
        fe.push_planes(np.ascontiguousarray(d.real.T),
                       np.ascontiguousarray(d.imag.T))
    np.testing.assert_allclose(sink.all(), jsink.all(), atol=1e-5)
    np.testing.assert_allclose(agc.gains_db, jagc.gains_db, atol=1e-4)
    agc.reset_agc()
    assert (agc.gains_db == 0).all() and not agc._primed.any()


def test_agc_front_end_refuses_and_delegates():
    """int16 planes and an inner int16-ingest engine are refused; lockstep
    paths refuse pending ragged tails; attributes delegate."""
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    agc = AgcFrontEnd(FullKernelBatchEngine(cfg, 128, block_symbols=64,
                                            ingest_scale=1e-3, device="cpu"))
    with pytest.raises(ValueError, match="int16"):
        agc.push_planes(np.zeros((64, 128), np.int16),
                        np.zeros((64, 128), np.int16))
    agc = AgcFrontEnd(_Sink(2))
    with pytest.raises(ValueError, match="int16"):
        agc.push_planes(torch.zeros((64, 2), dtype=torch.int16),
                        torch.zeros((64, 2), dtype=torch.int16))
    agc.push(0, np.ones(5, np.complex64))             # a 5-sample tail
    with pytest.raises(ValueError, match="tails"):
        agc.push_block(np.ones((2, 8), np.complex64))
    with pytest.raises(ValueError, match="tails"):
        agc.push_planes(np.ones((8, 2), np.float32),
                        np.ones((8, 2), np.float32))
    assert agc.channels == 2 and agc.agc_cfg.chunk == 8


def test_agc_demod_integration_matches_jax():
    """tests/test_agc.py's integration: a 40x bank behind the AGC
    demodulates to unit-amplitude soft symbols equal to the unscaled
    bank's within 0.05, and the port's soft equals JAX's within 3e-3."""
    c, s, sps = 4, 800, 8
    rng = np.random.default_rng(17)
    xs = []
    for _ in range(c):
        j = rng.integers(0, 4, s)
        x = np.repeat(np.exp(2j * np.pi * j / 4), sps)
        x += (1e-3 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x.astype(np.complex64))
    xs = np.stack(xs)
    kw = dict(sps=sps, num_avg=50, phase_avg=20)
    ref_eng = BatchEngine(DemodConfig(**kw), c, device="cpu")
    ref_eng.push_block(xs)
    ref_out = ref_eng.step()
    agc = AgcFrontEnd(BatchEngine(DemodConfig(**kw), c, device="cpu"),
                      AgcConfig(target_rms=1.0, alpha=0.3, chunk=sps))
    agc.push_block(40.0 * xs)
    out = agc.engine.step()
    jagc = JaxAgc(JaxBatchEngine(JaxDemodConfig(**kw), c),
                  JaxAgcConfig(target_rms=1.0, alpha=0.3, chunk=sps))
    jagc.push_block(40.0 * xs)
    jout = jagc.engine.step()
    v = ref_out.valid.numpy() & out.valid.numpy()
    assert v.sum() > c * 400
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    soft = out.soft.numpy()
    np.testing.assert_allclose(np.abs(soft[v]), 1.0, atol=0.05)
    np.testing.assert_allclose(soft[v], ref_out.soft.numpy()[v], atol=0.05)
    np.testing.assert_allclose(soft[v], np.asarray(jout.soft)[v], atol=3e-3)
