"""Port parity, the streaming frame-sync path: psk_soft_tpu_torch's
ops/framesync host path (correlate_uw, detect_peaks, detect_uw_sparse,
extract_heads, extract_frames) and runtime/framesync (FrameSyncer with the
engine device tap, GroupFrameSyncer) against the JAX package on the CPU,
fed the same numpy inputs.

Tolerances: peak indices, rotations, bits and frame lists equal;
correlation, norms and soft payloads within 1e-5; angles within 1e-4
modulo 2pi (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu.ops import framesync as jfs
from psk_soft_tpu.ops import tx
from psk_soft_tpu.runtime import framesync as jrfs
from psk_soft_tpu.utils.transfer import to_host
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import framesync as fs
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.runtime.framesync import (FrameSyncer,
                                                  GroupFrameSyncer)
from psk_soft_tpu_torch.runtime.streams import SRI

torch.set_num_threads(1)

TOL = 1e-5


def _fmts(m: int, uw: int, payload: int, seed: int, threshold=0.7):
    rng = np.random.default_rng(seed)
    kw = dict(uw=tuple(int(v) for v in rng.integers(0, m, uw)),
              payload=payload, m=m, threshold=threshold)
    return jfs.FrameFormat(**kw), fs.FrameFormat(**kw)


def _soft_bank(c, s, fmt, seed=5, starts=None):
    """Random M-PSK soft plane with UW-led frames planted per channel,
    rotated by a per-channel multiple of 2pi/M."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, fmt.m, (c, s))
    if starts is None:
        starts = range(7, s - fmt.frame_len, 3 * fmt.frame_len // 2)
    for ch in range(c):
        for s0 in starts:
            idx[ch, s0:s0 + fmt.uw_len] = fmt.uw
    soft = fs.psk_points(idx.reshape(-1), fmt.m).reshape(c, s)
    soft = soft * np.exp(2j * np.pi * (np.arange(c) % fmt.m) / fmt.m)[:, None]
    soft = soft + 0.03 * (rng.standard_normal((c, s))
                          + 1j * rng.standard_normal((c, s)))
    return soft.astype(np.complex64)


def _frame_key(f):
    return (f.channel, f.start, f.rotation, f.bits.tobytes())


def _same_frames(got, want):
    assert [_frame_key(f) for f in got] == [_frame_key(f) for f in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.soft, b.soft, atol=TOL, rtol=0)
        assert abs(a.corr - b.corr) <= TOL
        assert abs(a.residual_phase - b.residual_phase) <= 1e-4


@pytest.mark.parametrize("m", [2, 4, 8])
def test_sync_functions_match_jax(m):
    """correlate_uw (corr and norm), detect_peaks on the same norm,
    detect_uw_sparse (indices equal, norm and angle close) and
    resolve_rotation_angle against the JAX package's."""
    jfmt, fmt = _fmts(m, 24, 40, seed=m)
    soft = _soft_bank(6, 600, fmt, seed=m)
    jcorr, jnorm = to_host(jfs.correlate_uw(soft, jfmt.points))
    corr, norm = fs.correlate_uw(torch.from_numpy(soft), fmt.points)
    assert corr.dtype == torch.complex64 and norm.shape == jnorm.shape
    np.testing.assert_allclose(corr.numpy(), jcorr, atol=TOL, rtol=0)
    np.testing.assert_allclose(norm.numpy(), jnorm, atol=TOL, rtol=0)
    for got, want in zip(fs.detect_peaks(jnorm, fmt.threshold,
                                         fmt.separation),
                         jfs.detect_peaks(jnorm, jfmt.threshold,
                                          jfmt.separation)):
        np.testing.assert_array_equal(got, want)
    jc = jfs.detect_uw_sparse(soft, jfmt)
    c = fs.detect_uw_sparse(torch.from_numpy(soft), fmt)
    assert c.idx.dtype == np.int32 and c.vals.dtype == np.float32
    assert c.idx.shape[0] > 6
    np.testing.assert_array_equal(c.idx, jc.idx)
    np.testing.assert_allclose(c.vals[:, 0], jc.vals[:, 0], atol=TOL, rtol=0)
    d = np.angle(np.exp(1j * (c.vals[:, 1].astype(np.float64)
                              - jc.vals[:, 1])))
    assert np.abs(d).max() < 1e-4
    for got, want in zip(fs.resolve_rotation_angle(jc.vals[:, 1], m),
                         jfs.resolve_rotation_angle(jc.vals[:, 1], m)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="capacity"):
        fs.detect_uw_sparse(torch.from_numpy(soft), fmt, kmax=2)
    empty = fs.detect_uw_sparse(torch.from_numpy(soft[:, :10]), fmt)
    assert empty.idx.shape == (0, 2)


def test_extract_heads_and_frames_match_jax():
    """extract_heads (one gather, derotation, slicing) and the one-shot
    extract_frames against the JAX package's."""
    jfmt, fmt = _fmts(4, 16, 24, seed=9)
    soft = _soft_bank(4, 400, fmt)
    jframes = jfs.extract_frames(jfmt, soft, base=100)
    frames = fs.extract_frames(fmt, soft, base=100)
    assert len(frames) >= 5
    _same_frames(frames, jframes)
    heads_c = [f.channel for f in jframes]
    heads_t = [f.start - 100 for f in jframes]
    ks = [f.rotation for f in jframes]
    jpm, jbits = jfs.extract_heads(soft, jfmt, heads_c, heads_t, ks)
    pm, bits = fs.extract_heads(torch.from_numpy(soft), fmt, heads_c,
                                heads_t, ks)
    assert pm.shape == jpm.shape and bits.dtype == np.int8
    np.testing.assert_allclose(pm, jpm, atol=TOL, rtol=0)
    np.testing.assert_array_equal(bits, jbits)
    pm0, bits0 = fs.extract_heads(torch.from_numpy(soft), fmt, [], [], [])
    assert pm0.shape == (0, 24) and bits0.shape == (0, 48)


@pytest.mark.parametrize("splits", [(), (300,), (1, 2, 150, 151, 700),
                                    (97, 194, 291, 388, 485, 582)])
def test_frame_syncer_matches_jax(splits):
    """The streaming syncer over a block split equals the JAX syncer over
    the same split and the port's one-shot extraction of the whole
    stream: no frame lost or doubled at a seam."""
    jfmt, fmt = _fmts(4, 24, 40, seed=3)
    soft = _soft_bank(5, 800, fmt, seed=11,
                      starts=range(13, 800 - 64, 97))
    edges = [0, *splits, soft.shape[1]]
    ours = FrameSyncer(5, fmt, device="cpu")
    ref = jrfs.FrameSyncer(5, jfmt)
    for lo, hi in zip(edges[:-1], edges[1:]):
        ours.observe(soft[:, lo:hi])
        ref.observe(soft[:, lo:hi])
    ours.finalize()
    ref.finalize()
    got, want = ours.pop_frames(), ref.pop_frames()
    assert len(got) >= 30 and ours.frames_synced == len(got)
    _same_frames(got, want)
    one_shot = sorted(fs.extract_frames(fmt, soft),
                      key=lambda f: (f.start, f.channel))
    assert sorted(map(_frame_key, got)) == sorted(map(_frame_key, one_shot))


def _run_engine_sync(device_tap: bool, soft_i8: bool = False,
                     data_ports: bool = True, depth: int = 0):
    """The port's FullKernelBatchEngine (128 channels, CPU) under a
    FrameSyncer, through warm-up, steady blocks and a flush block."""
    c, sps = 128, 4
    cfg = DemodConfig(sps=sps, num_avg=20, constellation_size=4,
                      phase_avg=24)
    rng = np.random.default_rng(21)
    fmt = fs.FrameFormat(uw=tuple(int(v) for v in rng.integers(0, 4, 24)),
                         payload=24, m=4, threshold=0.7)
    s_total = 700
    idx = rng.integers(0, 4, (c, s_total))
    for s0 in range(150, s_total - fmt.frame_len - 40, 90):
        idx[:, s0:s0 + fmt.uw_len] = fmt.uw
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    eng = FullKernelBatchEngine(cfg, c, block_symbols=128, soft_i8=soft_i8,
                                data_ports=data_ports, pipeline_depth=depth,
                                device="cpu")
    eng.set_input_sri(SRI(stream_id="dev-tap"))
    sync = FrameSyncer(eng, fmt, device_tap=device_tap, device="cpu")
    assert sync._tap_device is device_tap
    re = np.ascontiguousarray(x.real.T, np.float32)      # (T, C) planes
    im = np.ascontiguousarray(x.imag.T, np.float32)
    need = 128 * sps
    for pos in range(0, x.shape[1] - need + 1, need):
        eng.push_planes(re[pos:pos + need], im[pos:pos + need])
        pkts = sync.step_packets()
        if not data_ports:
            assert not pkts        # no plane fetch, no packets
    tail = x.shape[1] // need * need
    eng.push_planes(re[tail:], im[tail:])
    sync.flush_packets()
    return sync.pop_frames()


@pytest.mark.parametrize("soft_i8", [False, True])
def test_device_tap_matches_packet_tap(soft_i8):
    """The syncer reading the engine's raw block outputs (TMOutputs, int8
    planes with soft_i8, channel-major warm-up blocks, the trimmed flush
    block) finds the frames the packet tap finds."""
    a = _run_engine_sync(device_tap=True, soft_i8=soft_i8)
    b = _run_engine_sync(device_tap=False, soft_i8=soft_i8)
    assert len(a) == len(b) > 100
    for fa, fb in zip(a, b):
        assert _frame_key(fa) == _frame_key(fb)
        np.testing.assert_allclose(fa.soft, fb.soft, atol=1e-6, rtol=0)
        assert abs(fa.corr - fb.corr) <= TOL


@pytest.mark.parametrize("depth", [0, 1])
def test_frames_only_engine_same_frames(depth):
    """data_ports=False (no packet assembly at all) gives the same frame
    stream through the device tap, also with pipelined assembly."""
    a = _run_engine_sync(device_tap=True, data_ports=False, depth=depth)
    b = _run_engine_sync(device_tap=True, data_ports=True)
    assert [_frame_key(f) for f in a] == [_frame_key(f) for f in b]


def test_group_frame_syncer_matches_jax():
    """A bank mixing QPSK and 8-PSK formats over uneven splits: frames
    with bank channel indices, equal to the JAX GroupFrameSyncer's."""
    rng = np.random.default_rng(131)
    jq, fq = _fmts(4, 32, 40, seed=1)
    j8, f8 = _fmts(8, 32, 30, seed=2, threshold=0.6)
    jfmts, fmts = [jq, j8, jq, j8], [fq, f8, fq, f8]
    total = 900
    starts = {0: [50, 400], 1: [80, 500], 2: [120, 620], 3: [60, 300]}
    rows = []
    for c, fmt in enumerate(jfmts):
        nb = int(np.log2(fmt.m))
        infos = [rng.integers(0, 2, fmt.payload * nb, np.int8)
                 for _ in starts[c]]
        idx = tx.frame_stream(fmt, infos, starts[c], total, seed=7)
        soft = tx.symbols_to_iq(fmt.m, idx) * np.exp(2j * np.pi * c / fmt.m)
        rows.append((soft + 0.02 * (rng.standard_normal(total)
                                    + 1j * rng.standard_normal(total))
                     ).astype(np.complex64))
    bank = np.stack(rows)
    ours = GroupFrameSyncer(4, fmts, device="cpu")
    ref = jrfs.GroupFrameSyncer(4, jfmts)
    assert len(ours._syncers) == 2
    for lo, hi in ((0, 300), (300, 301), (301, 900)):
        ours.observe(bank[:, lo:hi])
        ref.observe(bank[:, lo:hi])
    ours.finalize()
    ref.finalize()
    got, want = ours.pop_frames(), ref.pop_frames()
    assert len(got) == 8 and ours.frames_synced == 8
    _same_frames(got, want)
    with pytest.raises(ValueError, match="one format per channel"):
        GroupFrameSyncer(3, fmts, device="cpu")
