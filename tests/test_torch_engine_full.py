"""Port parity, engine: psk_soft_tpu_torch's FullKernelBatchEngine on the
CPU (the kernel's plain version) against the JAX FullKernelBatchEngine
(Pallas kernel with interpret=True), fed the same time-major planes over
the warm-up, the hand-off, steady blocks and one flush.

Packets agree: SRI, timestamps, EOS and shapes equal; bits and sampleIndex
equal; soft 3e-3 and phase 2e-3 (the kernel bounds of
tests/test_full_kernel.py).  With 256-symbol blocks the Pallas kernel runs
one time tile per block, so both re-wrap the phase at the same place.
"""

import inspect

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.runtime.engine import \
    FullKernelBatchEngine as JaxFullKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI as JaxSRI
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import blockpsk, full
from psk_soft_tpu_torch.ops.cuda import demod_kernel
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
from psk_soft_tpu_torch.runtime.streams import (PORT_BITS, PORT_PHASE,
                                                PORT_SAMPLE_INDEX, PORT_SOFT,
                                                SRI)

torch.set_num_threads(1)

PHASE_TOL, SOFT_TOL = 2e-3, 3e-3
C, SPS, BLOCK = 128, 8, 256
NS = 4 * BLOCK + 100                    # 4 blocks + a flushed remainder
KW = dict(sps=SPS, num_avg=50, constellation_size=4, phase_avg=20)


def _planes():
    """(T, C) re/im planes of tests/test_full_kernel.py's fixture."""
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        pts = np.exp(2j * np.pi * rng.integers(0, 4, NS) / 4)
        x = np.zeros(NS * SPS, np.complex64)
        x[2::SPS] = pts * np.exp(2j * np.pi * 2e-4 * SPS * np.arange(NS))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    xs = np.stack(out)
    return (np.ascontiguousarray(xs.real.T), np.ascontiguousarray(xs.imag.T))


def _drive(eng, re, im, chunk=1000):
    eng.set_input_sri(SRI("s", xdelta=1e-6) if isinstance(
        eng, FullKernelBatchEngine) else JaxSRI("s", xdelta=1e-6), 5.0)
    pkts = []
    for k in range(0, re.shape[0], chunk):
        eng.push_planes(re[k:k + chunk], im[k:k + chunk])
        while eng.ready():
            p = eng.step_packets()
            if p is not None:
                pkts.append(p)
    pkts.append(eng.flush_packets())
    return pkts


def _assert_packets(got, ref, soft_tol=SOFT_TOL):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for port in a:
            pa, pb = a[port], b[port]
            assert (pa.t, pa.eos, pa.sri_changed) == (pb.t, pb.eos,
                                                      pb.sri_changed), port
            assert (pa.sri.stream_id, pa.sri.xdelta, pa.sri.mode) == (
                pb.sri.stream_id, pb.sri.xdelta, pb.sri.mode), port
            assert pa.data.shape == pb.data.shape, port
            assert pa.data.dtype == pb.data.dtype, port
            if port in (PORT_BITS, PORT_SAMPLE_INDEX):
                np.testing.assert_array_equal(pa.data, pb.data)
            else:
                tol = PHASE_TOL if port == PORT_PHASE else soft_tol
                np.testing.assert_allclose(pa.data, pb.data, atol=tol)


@pytest.mark.parametrize("depth,extra", [
    (0, {}), (1, {}), (0, dict(debug_ports=False, soft_i8=True))])
def test_engine_packets_match_jax(depth, extra):
    re, im = _planes()
    demod_kernel.demod_full_tm.launches = 0
    eng = FullKernelBatchEngine(DemodConfig(**KW), C, block_symbols=BLOCK,
                                pipeline_depth=depth, device="cpu", **extra)
    jeng = JaxFullKernelBatchEngine(JaxDemodConfig(**KW), C,
                                    block_symbols=BLOCK, interpret=True,
                                    pipeline_depth=depth, **extra)
    got = _drive(eng, re, im)
    ref = _drive(jeng, re, im)
    # int8 soft planes: one quantization step (1/100) where the float
    # values straddle a rounding boundary.
    _assert_packets(got, ref, 0.0101 if extra.get("soft_i8") else SOFT_TOL)
    assert demod_kernel.demod_full_tm.launches == 0       # CPU: plain path
    assert eng.steady
    # Flush: 100 real symbols of a zero-padded block (after the pending
    # steady block at depth 1); the masked rows are dropped exactly as the
    # JAX engine drops them.
    assert got[-1][PORT_SOFT].data.shape[1] == 100 + (BLOCK if depth else 0)
    assert got[-1][PORT_SOFT].eos
    assert (PORT_PHASE in got[0]) == extra.get("debug_ports", True)
    total = sum(p[PORT_SOFT].data.shape[1] for p in got)
    assert total == NS - (KW["num_avg"] - 1)
    assert eng.metrics.symbols_out == jeng.metrics.symbols_out == total * C
    assert eng.metrics.samples_in == re.size


def test_engine_data_ports_off_and_port_stats_match_jax():
    """data_ports=False assembles nothing but keeps the symbol clock; port
    statistics count the same packets as the JAX engine's."""
    re, im = _planes()
    outs = []
    for data_ports in (False, True):
        eng = FullKernelBatchEngine(DemodConfig(**KW), C, block_symbols=BLOCK,
                                    data_ports=data_ports, device="cpu")
        jeng = JaxFullKernelBatchEngine(JaxDemodConfig(**KW), C,
                                        block_symbols=BLOCK, interpret=True,
                                        data_ports=data_ports)
        got, ref = _drive(eng, re, im), _drive(jeng, re, im)
        if not data_ports:
            assert all(p == {} for p in got) and all(p == {} for p in ref)
        assert eng.assembler._k0 == jeng.assembler._k0 == NS - 49
        assert set(eng.port_stats) == set(jeng.port_stats)
        for port, st in eng.port_stats.items():
            js = jeng.port_stats[port]
            assert (st.packets, st.items, st.bytes, st.eos_count) == (
                js.packets, js.items, js.bytes, js.eos_count), port
        outs.append(len(eng.port_stats))
    assert outs == [0, 4]


def test_engine_step_arrays_match_jax():
    """The channel-major step()/flush() surface, warm-up and steady."""
    re, im = _planes()
    eng = FullKernelBatchEngine(DemodConfig(**KW), C, block_symbols=BLOCK,
                                device="cpu")
    jeng = JaxFullKernelBatchEngine(JaxDemodConfig(**KW), C,
                                    block_symbols=BLOCK, interpret=True)
    rows = 2 * BLOCK * SPS
    eng.push_planes(re[:rows], im[:rows])
    jeng.push_planes(re[:rows], im[:rows])
    for _ in range(2):
        out, jout = eng.step(), jeng.step()
        np.testing.assert_array_equal(out.valid.numpy(),
                                      np.asarray(jout.valid))
        np.testing.assert_array_equal(out.bits.numpy(),
                                      np.asarray(jout.bits))
        np.testing.assert_array_equal(out.sample_index.numpy(),
                                      np.asarray(jout.sample_index))
        np.testing.assert_allclose(out.soft.numpy(), np.asarray(jout.soft),
                                   atol=SOFT_TOL)
    assert eng.step() is None and jeng.step() is None
    eng.push_planes(re[rows:rows + 40 * SPS], im[rows:rows + 40 * SPS])
    jeng.push_planes(re[rows:rows + 40 * SPS], im[rows:rows + 40 * SPS])
    out, jout = eng.flush(), jeng.flush()
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    assert int(out.valid[0].sum()) == 40


def test_engine_native_bank_and_channel_push():
    """NativePlaneBank ingest and per-channel push give the same packets
    as direct plane pushes."""
    re, im = _planes()
    cfg = DemodConfig(**KW)
    need = BLOCK * SPS
    ref = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK, device="cpu")
    via_bank = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK,
                                     device="cpu")
    per_chan = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK,
                                     device="cpu")
    bank = NativePlaneBank(C, capacity_samples=4 * need)
    frames = (re + 1j * im).astype(np.complex64)          # (T, C)
    for b in range(3):
        rows = slice(b * need, (b + 1) * need)
        ref.push_planes(re[rows], im[rows])
        bank.push_interleaved(frames[rows])
        pre, pim, flushed = bank.pop_planes(need, timeout=0)
        assert not flushed
        via_bank.push_planes(pre, pim)
        for c in range(C):
            per_chan.push(c, frames[rows, c])
        a, b2, c2 = (ref.step_packets(), via_bank.step_packets(),
                     per_chan.step_packets())
        for port in a:
            np.testing.assert_array_equal(a[port].data, b2[port].data)
            np.testing.assert_array_equal(a[port].data, c2[port].data)
    assert bank.stats().frames_in == 3 * need
    bank.close()


def test_engine_reset_restarts_the_stream():
    re, im = _planes()
    eng = FullKernelBatchEngine(DemodConfig(**KW), C, block_symbols=BLOCK,
                                device="cpu")
    need = BLOCK * SPS
    eng.push_planes(re[:2 * need], im[:2 * need])
    first = [eng.step_packets(), eng.step_packets()]
    assert eng.steady
    eng.reset()
    assert not eng.steady and eng.metrics.resets == 1
    eng.push_planes(re[:2 * need], im[:2 * need])
    again = [eng.step_packets(), eng.step_packets()]
    for a, b in zip(first, again):
        for port in a:
            np.testing.assert_array_equal(a[port].data, b[port].data)
            assert a[port].t == b[port].t


@pytest.mark.parametrize("kw,cfg_kw,match", [
    (dict(ingest_scale=0.5), {}, None),
    (dict(guard_nonfinite=True, soft_i8=True), {}, "mutually exclusive"),
    ({}, dict(matched_filter="rrc"), None),
    ({}, dict(timing_interp=True), None),
    ({}, dict(phase_avg=5), "phase_avg"),
])
def test_engine_rejects_later_options(kw, cfg_kw, match):
    """Options the engine refuses raise; int16 ingest, a matched filter
    and timing_interp (match None) run, two blocks (warm-up, hand-off,
    one steady block) with packets equal to the JAX engine's: int16 wire
    planes as the JAX engine takes them, the others as floats."""
    cfg = DemodConfig(**{**KW, **cfg_kw})
    if match is not None:
        with pytest.raises(ValueError, match=match):
            FullKernelBatchEngine(cfg, C, device="cpu", **kw)
        return
    re, im = _planes()
    rows = 2 * BLOCK * SPS
    re, im = re[:rows], im[:rows]
    if "ingest_scale" in kw:
        kw = dict(ingest_scale=float(np.abs(re).max()) / 30000.0)
        re = np.round(re / kw["ingest_scale"]).astype(np.int16)
        im = np.round(im / kw["ingest_scale"]).astype(np.int16)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK, device="cpu",
                                **kw)
    jeng = JaxFullKernelBatchEngine(JaxDemodConfig(**{**KW, **cfg_kw}), C,
                                    block_symbols=BLOCK, interpret=True,
                                    **kw)
    _assert_packets(_drive(eng, re, im), _drive(jeng, re, im))
    assert eng.steady


def test_engine_rejects_later_methods_and_bad_input():
    eng = FullKernelBatchEngine(DemodConfig(**KW), C, block_symbols=BLOCK,
                                device="cpu")
    eng.configure(DemodConfig(**{**KW, "num_avg": 40}))     # before data
    assert eng.metrics.reconfigures == 1 and eng.cfg.num_avg == 40
    with pytest.raises(ValueError, match="config/channel mismatch"):
        eng.restore_full_state(full.full_from_ff(
            DemodConfig(**KW), blockpsk.ff_init(DemodConfig(**KW), C, "cpu")))
    z16 = np.zeros((64, C), np.int16)
    with pytest.raises(ValueError, match="int16 planes need ingest_scale"):
        eng.push_planes(z16, z16)
    with pytest.raises(ValueError, match="rows"):
        eng.push_planes(np.zeros((64, 3), np.float32),
                        np.zeros((64, 3), np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        FullKernelBatchEngine(DemodConfig(**KW), 100, device="cpu")
    # The entry point runs on the card unless the caller asks for the CPU.
    params = inspect.signature(FullKernelBatchEngine).parameters
    assert params["device"].default == "cuda"
