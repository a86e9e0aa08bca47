"""Port parity, engine lifecycle: psk_soft_tpu_torch's ff_from_full,
reconfigure_ff and FullKernelBatchEngine's configure, restore_full_state
and guard_nonfinite on the CPU (kernel B1's plain version) against the JAX
package (Pallas kernel with interpret=True), fed the same numpy inputs.

Bounds: the carry converters and the resync are host numpy on both sides
and are held equal (float32 to 1e-6 where the JAX package computes on the
device); engine packets with the kernel bounds of tests/test_full_kernel.py
(bits and sampleIndex equal, soft 3e-3, phase 2e-3) plus the lock checks
of tests/test_engine_lifecycle.py:69-99; the guard's channel_resyncs equal
to the JAX engine's and the healthy channels bit-equal to an unpoisoned
port run (tests/test_engine_planes.py:188-246).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models import full as jfull
from psk_soft_tpu.models.blockpsk import ff_init as jax_ff_init
from psk_soft_tpu.models.blockpsk import make_ff_demod_fn
from psk_soft_tpu.runtime.engine import \
    FullKernelBatchEngine as JaxFullKernelBatchEngine
from psk_soft_tpu.runtime.engine_stream import \
    reconfigure_ff as jax_reconfigure_ff
from psk_soft_tpu.runtime.streams import SRI as JaxSRI
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import blockpsk, full
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.engine_stream import reconfigure_ff
from psk_soft_tpu_torch.runtime.streams import (PORT_BITS, PORT_PHASE,
                                                PORT_SAMPLE_INDEX, PORT_SOFT,
                                                SRI)
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

C, SPS, BLOCK = 128, 8, 128
KW = dict(sps=SPS, num_avg=50, constellation_size=4, phase_avg=20)
SOFT_TOL, PHASE_TOL = 3e-3, 2e-3


def _bank(num_symbols, seed0=0, m=4, pos=2):
    """Timing-decisive bank (energy on intra-symbol index ``pos``), a small
    frequency offset, noise 0.01: (C, T) complex64."""
    xs = []
    for i in range(C):
        rng = np.random.default_rng(seed0 + i)
        x = np.zeros(num_symbols * SPS, np.complex64)
        x[pos::SPS] = np.exp(2j * np.pi * rng.integers(0, m, num_symbols)
                             / m) * np.exp(2j * np.pi * 1e-4 * SPS
                                           * np.arange(num_symbols))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return np.stack(xs)


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _converged_jax_ff(jcfg, xs):
    st, _ = make_ff_demod_fn(jcfg, channels=C)(jax_ff_init(jcfg, (C,)),
                                               jnp.asarray(xs))
    return st


def test_ff_from_full_matches_jax_and_round_trips():
    jcfg, cfg = JaxDemodConfig(**KW), DemodConfig(**KW)
    xs = _bank(512)
    jst = _converged_jax_ff(jcfg, xs[:, :256 * SPS])
    jfs = jfull.full_from_ff(jcfg, jst)
    fs = interop.full_state_from_numpy(_np(jfs), "cpu")
    got = interop.ff_state_to_numpy(full.ff_from_full(cfg, fs))
    want = _np(jfull.ff_from_full(jcfg, jfs))
    assert set(got) == set(want)
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # full_from_ff -> ff_from_full continues like the original carry.
    st = interop.ff_state_from_numpy(_np(jst), "cpu")
    st_rt = full.ff_from_full(cfg, full.full_from_ff(cfg, st))
    x2 = torch.from_numpy(xs[:, 256 * SPS:])
    _, a = blockpsk.demod_block_ff(cfg, st, x2)
    _, b = blockpsk.demod_block_ff(cfg, st_rt, x2)
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    np.testing.assert_array_equal(a.sample_index.numpy(),
                                  b.sample_index.numpy())
    np.testing.assert_allclose(a.soft.numpy(), b.soft.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.phase.numpy(), b.phase.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="matched filter"):
        full.ff_from_full(dataclasses.replace(cfg, matched_filter="rrc"), fs)


@pytest.mark.parametrize("change", [
    dict(num_avg=60), dict(num_avg=40), dict(sps=4), dict(phase_avg=30),
    dict(phase_avg=12), dict(constellation_size=8)])
def test_reconfigure_ff_matches_jax(change):
    """The resync of a warm-up carry and of a kernel carry brought back
    with ff_from_full, for every kind of property change."""
    jcfg, cfg = JaxDemodConfig(**KW), DemodConfig(**KW)
    new_j = dataclasses.replace(jcfg, **change)
    new_p = dataclasses.replace(cfg, **change)
    xs = _bank(300, seed0=5)
    jwarm = _converged_jax_ff(jcfg, xs[:, :60 * SPS])   # partial history
    jsteady = jfull.ff_from_full(jcfg, jfull.full_from_ff(
        jcfg, _converged_jax_ff(jcfg, xs)))
    for jst in (jwarm, jsteady):
        want = _np(jax_reconfigure_ff(jcfg, new_j, jst))
        got = interop.ff_state_to_numpy(reconfigure_ff(
            cfg, new_p, interop.ff_state_from_numpy(_np(jst), "cpu")))
        for f in want:
            assert got[f].shape == want[f].shape, f
            np.testing.assert_allclose(got[f], want[f], atol=1e-6,
                                       err_msg=f)


def _drive(eng, re, im, blocks, configure_at=None, new_cfg=None):
    jax_eng = not isinstance(eng, FullKernelBatchEngine)
    eng.set_input_sri((JaxSRI if jax_eng else SRI)("s", xdelta=1e-6), 2.0)
    need = BLOCK * SPS
    pkts = []
    for b in range(blocks):
        if b == configure_at:
            eng.configure(new_cfg)
        eng.push_planes(re[b * need:(b + 1) * need],
                        im[b * need:(b + 1) * need])
        p = eng.step_packets()
        if p is not None:
            pkts.append(p)
    pkts.append(eng.flush_packets())
    return pkts


def _assert_packets(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for port in a:
            pa, pb = a[port], b[port]
            assert (pa.t, pa.eos, pa.sri_changed, pa.sri.xdelta) == (
                pb.t, pb.eos, pb.sri_changed, pb.sri.xdelta), port
            assert pa.data.shape == pb.data.shape, port
            if port in (PORT_BITS, PORT_SAMPLE_INDEX):
                np.testing.assert_array_equal(pa.data, pb.data)
            else:
                tol = PHASE_TOL if port == PORT_PHASE else SOFT_TOL
                np.testing.assert_allclose(pa.data, pb.data, atol=tol)


def _lock_quality(soft):
    """99th-percentile angular distance to the nearest QPSK point."""
    ang = np.angle(soft * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    return np.percentile(np.minimum(ang, np.pi / 2 - ang), 99)


@pytest.mark.parametrize("depth,change", [
    (0, dict(phase_avg=30)), (1, dict(num_avg=40, phase_avg=30))])
def test_configure_mid_stream_matches_jax(depth, change):
    """configure() on the steady engine: in-flight blocks are assembled
    under the old config, the carry survives, the engine re-warms and hands
    back to the kernel; packets equal the JAX engine's."""
    xs = _bank(8 * BLOCK, seed0=10)
    re, im = (np.ascontiguousarray(xs.real.T),
              np.ascontiguousarray(xs.imag.T))
    eng = FullKernelBatchEngine(DemodConfig(**KW), C, block_symbols=BLOCK,
                                pipeline_depth=depth, device="cpu")
    jeng = JaxFullKernelBatchEngine(JaxDemodConfig(**KW), C,
                                    block_symbols=BLOCK, s_tile=BLOCK,
                                    pipeline_depth=depth, interpret=True)
    got = _drive(eng, re, im, 8, 4,
                 dataclasses.replace(DemodConfig(**KW), **change))
    ref = _drive(jeng, re, im, 8, 4,
                 dataclasses.replace(JaxDemodConfig(**KW), **change))
    _assert_packets(got, ref)
    assert eng.steady and eng.metrics.reconfigures == 1
    assert eng.cfg.phase_avg == 30
    after = np.concatenate([p[PORT_SOFT].data for p in got[-5:]
                            if PORT_SOFT in p and p[PORT_SOFT].data.size],
                           axis=1)
    # Timing and phase carried across: every post-change symbol emitted
    # and on the constellation (a cleared carry would re-warm).
    assert after.shape[1] >= 4 * BLOCK - (1 if depth else 0) * BLOCK
    assert _lock_quality(after) < 0.1


def test_restore_full_state_from_port_and_jax():
    """A fresh engine restored from a running engine's full_state continues
    bit-exactly; restored from the JAX engine's carry it continues like the
    JAX engine."""
    cfg, jcfg = DemodConfig(**KW), JaxDemodConfig(**KW)
    xs = _bank(10 * BLOCK, seed0=30, pos=5)
    need = BLOCK * SPS
    eng = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK, device="cpu")
    jeng = JaxFullKernelBatchEngine(jcfg, C, block_symbols=BLOCK,
                                    s_tile=BLOCK, interpret=True)
    blocks = [xs[:, i:i + need] for i in range(0, xs.shape[1], need)]
    for blk in blocks[:6]:
        _step_all((eng, jeng), blk)
    again = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK, device="cpu")
    again.restore_full_state(eng.full_state)
    from_jax = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK,
                                     device="cpu")
    from_jax.restore_full_state(interop.full_state_from_numpy(
        _np(jeng.full_state), "cpu"))
    assert again.steady and from_jax.steady
    for blk in blocks[6:]:
        planes = (np.ascontiguousarray(blk.real.T),
                  np.ascontiguousarray(blk.imag.T))
        outs = []
        for e in (eng, again, from_jax, jeng):
            e.push_planes(*planes)
            outs.append(e.step())
        a, b, c, j = outs
        np.testing.assert_array_equal(a.soft.numpy(), b.soft.numpy())
        np.testing.assert_array_equal(a.bits.numpy(), b.bits.numpy())
        np.testing.assert_array_equal(c.bits.numpy(), np.asarray(j.bits))
        np.testing.assert_array_equal(c.sample_index.numpy(),
                                      np.asarray(j.sample_index))
        np.testing.assert_allclose(c.soft.numpy(), np.asarray(j.soft),
                                   atol=SOFT_TOL)
    bad = eng.full_state._replace(win_re=eng.full_state.win_re[:-8])
    with pytest.raises(ValueError, match="config/channel mismatch"):
        again.restore_full_state(bad)
    # An int16 window restores into an int16-ingest engine (and only
    # there): quantized, the carry continues like the float32 one on the
    # dequantized planes.
    scale = 1e-4
    i16 = full.quantize_full_state(eng.full_state, scale)
    with pytest.raises(ValueError, match="ingest_scale"):
        again.restore_full_state(i16)
    wire = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK,
                                 ingest_scale=scale, device="cpu")
    wire.restore_full_state(i16)
    again.restore_full_state(full.dequantize_full_state(i16, scale))
    q = np.round(np.ascontiguousarray(blocks[-1].real.T) / scale)
    qi = np.round(np.ascontiguousarray(blocks[-1].imag.T) / scale)
    wire.push_planes(q.astype(np.int16), qi.astype(np.int16))
    again.push_planes((q * np.float32(scale)).astype(np.float32),
                      (qi * np.float32(scale)).astype(np.float32))
    w, a = wire.step(), again.step()
    assert wire.full_state.win_re.dtype == torch.int16
    assert torch.equal(w.bits, a.bits)
    np.testing.assert_allclose(w.soft.numpy(), a.soft.numpy(), atol=1e-5)


def _step_all(engines, blk):
    re = np.ascontiguousarray(blk.real.T)
    im = np.ascontiguousarray(blk.imag.T)
    outs = []
    for e in engines:
        e.push_planes(re, im)
        outs.append(e.step())
    return outs


def test_guard_nonfinite_steady_matches_jax():
    """A NaN run in one channel on the steady path: the JAX and the port
    engine flag the same channel; the port's healthy channels stay equal
    to an unpoisoned port run, the poisoned one re-converges."""
    cfg, jcfg = DemodConfig(**KW), JaxDemodConfig(**KW)
    xs = _bank(12 * BLOCK, seed0=300, pos=3)
    need = BLOCK * SPS
    blocks = [xs[:, i:i + need] for i in range(0, xs.shape[1], need)]
    eng = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK,
                                guard_nonfinite=True, device="cpu")
    ref = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK, device="cpu")
    jeng = JaxFullKernelBatchEngine(jcfg, C, block_symbols=BLOCK,
                                    s_tile=BLOCK, interpret=True,
                                    guard_nonfinite=True)
    for blk in blocks[:5]:
        _step_all((eng, ref, jeng), blk)
    bad_blk = blocks[5].copy()
    bad_blk[7, 100:120] = np.nan
    bad_blk[90, 400] = np.inf
    window_before = eng.full_state.win_re
    _step_all((eng, jeng), bad_blk)
    _step_all((ref,), blocks[5])
    np.testing.assert_array_equal(eng.channel_resyncs, jeng.channel_resyncs)
    assert eng.channel_resyncs[[7, 90]].tolist() == [1, 1]
    assert eng.channel_resyncs.sum() == 2 == eng.metrics.resets
    # The poisoned window was rebuilt, never zeroed inside the caller's
    # previous block.
    assert eng.full_state.win_re.data_ptr() != window_before.data_ptr()
    assert not eng.full_state.win_re[:, 7].any()
    for blk in blocks[6:]:
        o, o_ref, jo = _step_all((eng, ref, jeng), blk)
    s, s_ref = o.soft.numpy(), o_ref.soft.numpy()
    healthy = np.ones(C, bool)
    healthy[[7, 90]] = False
    np.testing.assert_array_equal(s[healthy], s_ref[healthy])
    np.testing.assert_allclose(s, np.asarray(jo.soft), atol=SOFT_TOL)
    assert np.isfinite(s).all()
    assert abs(np.abs(s[7, -64:]).mean() - 1.0) < 0.2
    np.testing.assert_array_equal(eng.channel_resyncs, jeng.channel_resyncs)


def test_guard_nonfinite_warmup_matches_jax():
    cfg, jcfg = DemodConfig(**KW), JaxDemodConfig(**KW)
    xs = _bank(2 * BLOCK, seed0=400)
    blk = xs[:, :BLOCK * SPS].copy()
    blk[3, :16] = np.inf
    eng = FullKernelBatchEngine(cfg, C, block_symbols=BLOCK,
                                guard_nonfinite=True, device="cpu")
    jeng = JaxFullKernelBatchEngine(jcfg, C, block_symbols=BLOCK,
                                    s_tile=BLOCK, interpret=True,
                                    guard_nonfinite=True)
    _step_all((eng, jeng), blk)
    assert eng.channel_resyncs[3] == 1 and eng.channel_resyncs.sum() == 1
    np.testing.assert_array_equal(eng.channel_resyncs, jeng.channel_resyncs)
    # The block also completes the warm-up: channel 3 hands a fresh (zero)
    # carry to the kernel, the others their converged one, as in JAX.
    st, jst = eng.full_state, jeng.full_state
    assert not st.win_re[:, 3].any() and not st.planes[:cfg.phase_avg - 1,
                                                       3].any()
    np.testing.assert_array_equal(st.win_re.numpy(), np.asarray(jst.win_re))
    np.testing.assert_allclose(st.planes.numpy(), np.asarray(jst.planes),
                               atol=PHASE_TOL)


@pytest.mark.parametrize("kw", [dict(pipeline_depth=1),
                                dict(soft_i8=True)])
def test_guard_excludes_depth_and_soft_i8_as_in_jax(kw):
    for make in (lambda: FullKernelBatchEngine(
            DemodConfig(**KW), C, guard_nonfinite=True, device="cpu", **kw),
                 lambda: JaxFullKernelBatchEngine(
            JaxDemodConfig(**KW), C, guard_nonfinite=True, interpret=True,
            **kw)):
        with pytest.raises(ValueError, match="mutually exclusive"):
            make()


def test_configure_rejects_unported_configs_without_touching_state():
    """A config the kernel does not take raises before anything changes;
    a matched filter and timing_interp are taken now (the engine then
    carries the filter's raw look-back); an unchanged config is a no-op."""
    eng = FullKernelBatchEngine(DemodConfig(**KW), C, block_symbols=BLOCK,
                                device="cpu")
    before = eng.cfg
    with pytest.raises(ValueError, match="phase_avg"):
        eng.configure(dataclasses.replace(before, phase_avg=5))
    assert eng.cfg == before and eng.metrics.reconfigures == 0
    eng.configure(before)                      # unchanged: a no-op
    assert eng.metrics.reconfigures == 0
    for n, change in enumerate((dict(matched_filter="rrc"),
                                dict(timing_interp=True)), 1):
        eng.configure(dataclasses.replace(eng.cfg, **change))
        assert eng.metrics.reconfigures == n
    assert eng.cfg.matched_filter == "rrc" and eng.cfg.timing_interp
    assert eng._raw_keep == full.window_rows(eng.cfg) == 49 * 8 + 64
