"""Port parity, carrier acquisition: psk_soft_tpu_torch's
runtime/autocfo.AutoCfoEngine against the JAX package's on the CPU, fed
the same numpy banks (per-channel pushes, channel-major blocks, numpy
planes; tensor planes against JAX device arrays).

Tolerances: acquired and tracked CFOs equal to JAX's (the same numpy
acquisition on the same samples) and within 2e-4 of the truth
(tests/test_autocfo.py); samples from the float64 NCO within 1e-6 of
JAX's; tensor planes through ops/mixer.derotate within 1e-6 of JAX's
device form; the replay within 2e-5 of a one-shot derotated stream
(tests/test_autocfo.py); soft decisions within 3e-3 of JAX's engine.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.runtime.autocfo import AutoCfoEngine as JaxAutoCfo
from psk_soft_tpu.runtime.engine import BatchEngine as JaxBatchEngine
from psk_soft_tpu.runtime.streams import PORT_PHASE as JAX_PORT_PHASE
from psk_soft_tpu.runtime.streams import SRI as JaxSRI
from psk_soft_tpu.runtime.streams import Packet as JaxPacket
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime.autocfo import AutoCfoEngine
from psk_soft_tpu_torch.runtime.engine_batch import BatchEngine
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.streams import PORT_PHASE, PORT_SOFT, SRI

torch.set_num_threads(1)

C, SPS, M = 4, 8, 4
KW = dict(sps=SPS, num_avg=50, constellation_size=M, phase_avg=20)


def _bank(ns, cfos, seed=0, c=C, noise=0.002):
    """(c, T) bank, one carrier per channel (cycles/sample)."""
    xs, syms = [], []
    for i, f in enumerate(np.broadcast_to(cfos, (c,))):
        rng = np.random.default_rng(seed + i)
        j = rng.integers(0, M, ns)
        x = np.repeat(np.exp(2j * np.pi * j / M), SPS)
        x = x * np.exp(2j * np.pi * f * np.arange(x.size))
        x = x + noise * (rng.standard_normal(x.size)
                         + 1j * rng.standard_normal(x.size))
        xs.append(x.astype(np.complex64))
        syms.append(np.exp(2j * np.pi * j / M))
    return np.stack(xs), np.stack(syms)


def _ser_mod_rotation(soft, expect, max_delay=60):
    best = 1.0
    for d in range(max_delay):
        e = expect[d:d + soft.size]
        s = soft[:e.size]
        for k in range(M):
            rot = np.exp(2j * np.pi * k / M) * np.exp(1j * np.pi / 4)
            best = min(best, float(np.mean(np.abs(s - e * rot) > 0.5)))
    return best


class _Sink:
    """Ingest-only engine: records what reaches it, channel-major numpy
    (and whether planes came as tensors)."""

    def __init__(self, c=C, m=None):
        self.cfg = DemodConfig(**KW)
        self.channels = c
        self.device = torch.device("cpu")
        self.got = [[] for _ in range(c)]
        self.kinds = set()
        self.resets = 0
        self.phase = []
        if m is not None:
            self.params = type("P", (), {"m": m})()

    def push(self, c, x):
        self.got[c].append(np.asarray(x))

    def push_block(self, x):
        self.kinds.add(type(x).__name__)
        for c in range(self.channels):
            self.push(c, np.asarray(x[c]))

    def push_planes(self, re, im):
        self.kinds.add(type(re).__name__)
        y = np.asarray(re).T + 1j * np.asarray(im).T
        for c in range(self.channels):
            self.push(c, y[c])

    def step_packets(self):
        if not self.phase:
            return None
        return {PORT_PHASE: self.phase.pop(0)}

    def reset(self):
        self.resets += 1

    def all(self):
        return np.stack([np.concatenate(g) for g in self.got])


def _run(eng, xs, block_samps=None, push_block=False):
    outs = []
    step = block_samps or xs.shape[1]
    for i in range(0, xs.shape[1], step):
        if push_block:
            eng.push_block(xs[:, i:i + step])
        else:
            for c in range(xs.shape[0]):
                eng.push(c, xs[c, i:i + step])
        while (o := eng.step()) is not None:
            outs.append(o)
    return outs


@pytest.mark.parametrize("push_block", [False, True])
def test_beyond_lock_range_matches_jax(push_block):
    """3x the lock range: both wrappers acquire the same CFOs (within 2e-4
    of the truth) and demodulate the settled region; the port's soft equals
    JAX's within 3e-3."""
    f = 3.0 / (2 * M * SPS)
    truth = [f, -f, 2 * f, 0.5 * f]
    xs, syms = _bank(1500, truth)
    jeng = JaxAutoCfo(JaxBatchEngine(JaxDemodConfig(**KW), C,
                                     block_symbols=256), acq_samples=4096)
    eng = AutoCfoEngine(BatchEngine(DemodConfig(**KW), C, block_symbols=256,
                                    device="cpu"), acq_samples=4096)
    jouts = _run(jeng, xs, 2048, push_block)
    outs = _run(eng, xs, 2048, push_block)
    assert eng.acquisitions == jeng.acquisitions == 1
    np.testing.assert_array_equal(eng.cfo, jeng.cfo)
    np.testing.assert_allclose(eng.cfo, truth, atol=2e-4)
    soft = np.concatenate([o.soft.numpy() for o in outs], axis=1)
    valid = np.concatenate([o.valid.numpy() for o in outs], axis=1)
    jsoft = np.concatenate([np.asarray(o.soft) for o in jouts], axis=1)
    np.testing.assert_array_equal(valid, np.concatenate(
        [np.asarray(o.valid) for o in jouts], axis=1))
    np.testing.assert_allclose(soft[valid], jsoft[valid], atol=3e-3)
    for c in range(C):
        v = soft[c, valid[c]][200:]
        assert _ser_mod_rotation(v, syms[c, 200:]) < 0.01


@pytest.mark.parametrize("kind", ["push", "block", "block_tensor",
                                  "planes", "planes_tensor"])
def test_nco_paths_match_jax(kind):
    """Every ingest path through a sink, 512-sample pushes, acquisition
    after 2048: the samples reaching the engine equal JAX's on the same
    kind of input (a tensor block against a numpy block: the same float64
    NCO; tensor planes against JAX device arrays: ops/mixer.derotate), and
    tensors stay tensors."""
    xs, _ = _bank(1024, [0.03, -0.02, 0.011, 0.0], seed=5)
    jsink, sink = _Sink(), _Sink()
    jeng = JaxAutoCfo(jsink, acq_samples=2048)
    eng = AutoCfoEngine(sink, acq_samples=2048)
    for i in range(0, xs.shape[1], 512):
        blk = xs[:, i:i + 512]
        re = np.ascontiguousarray(blk.real.T)
        im = np.ascontiguousarray(blk.imag.T)
        if kind == "push":
            for c in range(C):
                jeng.push(c, blk[c])
                eng.push(c, blk[c])
        elif kind.startswith("block"):
            jeng.push_block(blk)
            eng.push_block(torch.from_numpy(blk) if kind == "block_tensor"
                           else blk)
        elif kind == "planes":
            jeng.push_planes(re, im)
            eng.push_planes(re, im)
        else:
            jeng.push_planes(jnp.asarray(re), jnp.asarray(im))
            eng.push_planes(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_array_equal(eng.cfo, jeng.cfo)
    np.testing.assert_array_equal(eng._n, jeng._n)
    np.testing.assert_allclose(sink.all(), jsink.all(), atol=1e-6, rtol=0)
    if kind.endswith("tensor"):
        assert sink.kinds == {"Tensor"}
    elif kind in ("block", "planes"):
        assert sink.kinds == {"ndarray"}


def test_acquisition_replays_staged_data_exactly():
    """Acquisition drops nothing: the wrapper's output equals the same
    engine on a one-shot pre-derotated stream (phase-continuous NCO over
    the replay/live seam), and the CFOs equal JAX's."""
    xs, _ = _bank(1200, 0.03, seed=5)
    eng = AutoCfoEngine(BatchEngine(DemodConfig(**KW), C, block_symbols=128,
                                    device="cpu"), acq_samples=2048)
    outs = _run(eng, xs, block_samps=512)
    got = np.concatenate([o.soft.numpy() for o in outs], axis=1)
    jeng = JaxAutoCfo(_Sink(), acq_samples=2048)
    for c in range(C):
        jeng.push(c, xs[c, :2048])
    np.testing.assert_array_equal(eng.cfo, jeng.cfo)
    t = np.arange(xs.shape[1])
    pre = xs * np.exp(-2j * np.pi * eng.cfo[:, None] * t[None, :])
    ref_eng = BatchEngine(DemodConfig(**KW), C, block_symbols=128,
                          device="cpu")
    ref = np.concatenate([o.soft.numpy() for o in _run(
        ref_eng, pre.astype(np.complex64))], axis=1)
    np.testing.assert_allclose(got, ref[:, :got.shape[1]], atol=2e-5)


@pytest.mark.parametrize("tensors", [False, True])
def test_plane_mode_full_kernel(tensors):
    """FullKernelBatchEngine behind the wrapper on (T, C) planes, numpy
    (float64 host NCO) and tensors (ops/mixer.derotate): the CFO within
    2e-4 and the settled symbols right."""
    f = 0.025
    xs, syms = _bank(1024, f, seed=9)
    xs = np.tile(xs, (32, 1))                 # the engine wants C % 128 == 0
    inner = FullKernelBatchEngine(DemodConfig(**KW), 128, block_symbols=128,
                                  device="cpu")
    eng = AutoCfoEngine(inner, acq_samples=2048)
    re = np.ascontiguousarray(xs.real.T)
    im = np.ascontiguousarray(xs.imag.T)
    outs = []
    for i in range(0, re.shape[0], 1024):
        r, m = re[i:i + 1024], im[i:i + 1024]
        if tensors:
            r, m = torch.from_numpy(r), torch.from_numpy(m)
        eng.push_planes(r, m)
        while (o := eng.step()) is not None:
            outs.append(o)
    np.testing.assert_allclose(eng.cfo, f, atol=2e-4)
    assert isinstance(inner._plane_re[0], torch.Tensor) if \
        inner._plane_re else True
    soft = np.concatenate([o.soft.numpy() for o in outs], axis=1)
    valid = np.concatenate([o.valid.numpy() for o in outs], axis=1)
    v = soft[0, valid[0]][200:]
    assert _ser_mod_rotation(v, syms[0, 200:]) < 0.01


def test_int16_planes_rejected():
    eng = AutoCfoEngine(FullKernelBatchEngine(DemodConfig(**KW), 128,
                                              block_symbols=128,
                                              ingest_scale=1e-3,
                                              device="cpu"))
    for z in (np.zeros((64, 128), np.int16),
              torch.zeros((64, 128), dtype=torch.int16)):
        with pytest.raises(ValueError, match="int16"):
            eng.push_planes(z, z)


def test_track_folds_match_jax():
    """track=True on the same phase-port packets (a stub engine): both
    wrappers fold the same channels at the same blocks, phase-continuously,
    to the same NCO (frequency and phase offset)."""
    rng = np.random.default_rng(4)
    xs, _ = _bank(400, 0.02, seed=1)
    jsink, sink = _Sink(), _Sink()
    jeng = JaxAutoCfo(jsink, acq_samples=2048, track=True, track_guard=0.05)
    eng = AutoCfoEngine(sink, acq_samples=2048, track=True, track_guard=0.05)
    for fe in (jeng, eng):
        fe.push_block(xs)
    for b in range(6):
        slope = M * 2 * np.pi * SPS * rng.uniform(-4e-3, 4e-3, (C, 1))
        ph = (slope * np.arange(64) + rng.uniform(-1, 1, (C, 1))
              ).astype(np.float32)
        ph[:, 40:] -= 2 * np.pi * M                    # a block re-wrap
        jsink.phase.append(JaxPacket(data=ph, sri=JaxSRI("t")))
        sink.phase.append(type("P", (), {"data": ph})())
        assert set(jeng.step_packets()) == {JAX_PORT_PHASE}
        assert set(eng.step_packets()) == {PORT_PHASE}
        np.testing.assert_array_equal(eng.folds, jeng.folds)
        np.testing.assert_array_equal(eng.cfo, jeng.cfo)
        np.testing.assert_array_equal(eng._phi, jeng._phi)
    assert eng.folds.sum() > 0


def test_track_folds_drift_back_into_nco():
    """tests/test_autocfo.py's drift on the port's BatchEngine: a slow
    quadratic drift is folded back (folds counted), the final NCO near
    the end frequency (3e-3), the constellation tight at the end."""
    ns = 4000
    rng = np.random.default_rng(3)
    t = np.arange(ns * SPS)
    f0, slew = 0.02, 1e-7
    xs = []
    for _ in range(C):
        j = rng.integers(0, M, ns)
        x = np.repeat(np.exp(2j * np.pi * j / M), SPS)
        x = x * np.exp(1j * 2 * np.pi * (f0 * t + 0.5 * slew * t * t))
        xs.append((x + 0.002 * (rng.standard_normal(x.size) + 1j
                                * rng.standard_normal(x.size))
                   ).astype(np.complex64))
    xs = np.stack(xs)
    eng = AutoCfoEngine(BatchEngine(DemodConfig(**KW), C, block_symbols=256,
                                    device="cpu"),
                        acq_samples=2048, track=True, track_guard=0.05)
    eng.set_input_sri(SRI(xdelta=1.0, mode=1, stream_id="trk"), 0.0)
    pkts = []
    for i in range(0, xs.shape[1], 2048):
        eng.push_block(xs[:, i:i + 2048])
        while (p := eng.step_packets()) is not None:
            pkts.append(p)
    assert int(eng.folds.sum()) > 0
    np.testing.assert_allclose(eng.cfo, f0 + slew * t[-1], atol=3e-3)
    np.testing.assert_allclose(np.abs(pkts[-1][PORT_SOFT].data), 1.0,
                               atol=0.15)


def test_flush_short_stream_matches_jax():
    """EOS before acq_samples: both acquire from what arrived (the same
    CFO, within 1e-3 of the truth); with under 64 samples, zero CFO."""
    xs, _ = _bank(120, 0.02, seed=2)
    jeng = JaxAutoCfo(JaxBatchEngine(JaxDemodConfig(**KW), C,
                                     block_symbols=64), acq_samples=65536)
    eng = AutoCfoEngine(BatchEngine(DemodConfig(**KW), C, block_symbols=64,
                                    device="cpu"), acq_samples=65536)
    jeng.set_input_sri(JaxSRI(xdelta=1.0, mode=1, stream_id="s"), 0.0)
    eng.set_input_sri(SRI(xdelta=1.0, mode=1, stream_id="s"), 0.0)
    for c in range(C):
        jeng.push(c, xs[c])
        eng.push(c, xs[c])
    jpkts, pkts = jeng.flush_packets(), eng.flush_packets()
    np.testing.assert_array_equal(eng.cfo, jeng.cfo)
    np.testing.assert_allclose(eng.cfo, 0.02, atol=1e-3)
    assert PORT_PHASE in pkts and set(pkts) == set(jpkts)
    assert eng.acq_samples == 65536
    tiny = AutoCfoEngine(_Sink(), acq_samples=4096)
    tiny.push_planes(np.ones((32, C), np.float32),
                     np.zeros((32, C), np.float32))
    tiny._flush_pending()
    assert (tiny.cfo == 0).all() and tiny.engine.all().shape == (C, 32)


def test_reset_keeps_carrier_reacquire_drops_it():
    """reset keeps the carrier (the engine resets), reacquire drops it and
    the next data re-acquires; configure and set_params re-derive M (a
    mixed bank's comes from params.m)."""
    xs, _ = _bank(600, 0.02)
    eng = AutoCfoEngine(BatchEngine(DemodConfig(**KW), C, block_symbols=64,
                                    device="cpu"), acq_samples=1024)
    _run(eng, xs)
    lock = eng.cfo
    eng.reset()
    np.testing.assert_array_equal(eng.cfo, lock)
    eng.reacquire()
    assert eng.cfo is None and (eng._n == 0).all()
    _run(eng, xs)
    np.testing.assert_allclose(eng.cfo, 0.02, atol=2e-4)
    eng.configure(DemodConfig(**dict(KW, constellation_size=2)))
    assert (eng._m == 2).all()
    sink = _Sink(m=torch.tensor([2, 4, 8, 4], dtype=torch.int32))
    sink.set_params = lambda p: setattr(sink, "params", p)
    mixed = AutoCfoEngine(sink)
    assert list(mixed._m) == [2, 4, 8, 4]
    mixed.set_params(type("P", (), {"m": np.array([8, 8, 2, 2])})())
    assert list(mixed._m) == [8, 8, 2, 2] and mixed.channels == C
    mixed.reacquire(reset_engine=True)
    assert sink.resets == 1
