"""Port parity, the resampler: psk_soft_tpu_torch's ops/resample
(kaiser_sinc_table, uniform_poly_matrix, resample_block,
resample_block_uniform, resample_positions_valid) and runtime/resampler
(ResamplerBank on its gather, uniform and grouped paths, and
ResampledBankEngine) against the JAX package on the CPU, fed the same
numpy samples.

Tolerances: the table and S bit-equal; the device steps within 1e-5 of
JAX's (the float32 positions may round differently where one side
contracts a multiply-add, and the lerp table includes row P, so a flipped
floor moves an output only by rounding); the banks within 1e-5 of JAX's
banks fed the same ragged pushes (both rebase positions in float64 on the
host).  Where the port is held to its own one-shot call or to the other
path, JAX's own bounds: 5e-4 streamed against one-shot
(tests/test_resample.py:147, :371), 3e-4 banded against gather
(:451, :495).  ResampledBankEngine's packets: bits and sample index equal,
soft 3e-3 and phase 2e-3 (tests/test_torch_engine_full.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import resample as jrs
from psk_soft_tpu.runtime import resampler as jrb
from psk_soft_tpu.runtime.streams import SRI as JaxSRI
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import resample as trs
from psk_soft_tpu_torch.runtime import resampler as trb
from psk_soft_tpu_torch.runtime.streams import (PORT_BITS, PORT_PHASE,
                                                PORT_SAMPLE_INDEX, SRI)
from psk_soft_tpu_torch.testing.wideband import rc_psk

torch.set_num_threads(1)

K, P = 8, 128
OP_TOL = 1e-5
STREAM_TOL = 5e-4         # tests/test_resample.py:147, :371
PATH_TOL = 3e-4           # tests/test_resample.py:451, :495
PHASE_TOL, SOFT_TOL = 2e-3, 3e-3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("p,k,cut,beta", [(128, 8, 1.0, 8.0),
                                          (64, 12, 0.8, 6.0),
                                          (32, 4, 0.5, 8.0)])
def test_table_bit_equal(p, k, cut, beta):
    np.testing.assert_array_equal(
        trs.kaiser_sinc_table(p, k, cutoff=cut, beta=beta),
        jrs.kaiser_sinc_table(p, k, cutoff=cut, beta=beta))


@pytest.mark.parametrize("num,den,k,cut", [(73, 80, 8, 1.0), (5, 4, 8, 0.8),
                                           (1, 4, 8, 1.0), (4, 1, 64, 0.25),
                                           (37, 32, 8, 32 / 37)])
def test_uniform_matrix_bit_equal(num, den, k, cut):
    np.testing.assert_array_equal(
        trs.uniform_poly_matrix(num, den, k, cutoff=cut),
        jrs.uniform_poly_matrix(num, den, k, cutoff=cut))


def test_validation_matches_jax():
    for mod in (trs, jrs):
        with pytest.raises(ValueError):
            mod.kaiser_sinc_table(cutoff=0.0)
        with pytest.raises(ValueError):
            mod.uniform_poly_matrix(0, 4)
    x = torch.zeros((10, 2))
    with pytest.raises(ValueError):
        trs.resample_block_uniform(x, x, _t(trs.uniform_poly_matrix(5, 4)),
                                   5, 4)
    for args in [([1.0, -0.5], 32, {}), ([1.0], 32, dict(taps_per_phase=7)),
                 ([10.0], 32, dict(taps_per_phase=8)),
                 ([0.9, 1.1], 32, dict(uniform=True))]:
        with pytest.raises(ValueError):
            jrb.ResamplerBank(args[0], args[1], **args[2])
        with pytest.raises(ValueError):
            trb.ResamplerBank(args[0], args[1], device="cpu", **args[2])
    trb.ResamplerBank([4.0], 32, taps_per_phase=8, device="cpu")
    trb.ResamplerBank([10.0], 32, taps_per_phase=24, device="cpu")
    bank = trb.ResamplerBank([1.0], 32, device="cpu")
    with pytest.raises(ValueError):
        bank.push(0, np.zeros((2, 2), np.complex64))


@pytest.mark.parametrize("ratios,n_out,t_in", [
    ([0.8, 1.0, 1.25, 7.3 / 8], 256, 400),
    ([1.0, 1.0], 32, 64),
    ([0.6, 2.5, 3.9, 1.7, 0.97], 120, 512),
])
def test_resample_block_matches_jax(ratios, n_out, t_in):
    C = len(ratios)
    x = _noise((t_in, C), seed=len(ratios))
    r = np.asarray(ratios, np.float32)
    tab = trs.kaiser_sinc_table(P, K, cutoff=min(1.0, 1.0 / max(ratios)))
    pos0 = (K // 2 - 1 + np.random.default_rng(1).uniform(0, 1, C)).astype(
        np.float32)
    assert trs.resample_positions_valid(pos0, r, n_out, t_in, K) == \
        jrs.resample_positions_valid(pos0, r, n_out, t_in, K)
    yr, yi, pe = trs.resample_block(_t(x.real), _t(x.imag), _t(pos0), _t(r),
                                    _t(tab), n_out)
    jr, ji, jpe = jrs.resample_block(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()),
        jnp.asarray(pos0), jnp.asarray(r), jnp.asarray(tab), n_out)
    assert yr.dtype == torch.float32 and tuple(yr.shape) == (n_out, C)
    np.testing.assert_allclose(yr.numpy(), np.asarray(jr), atol=OP_TOL,
                               rtol=0)
    np.testing.assert_allclose(yi.numpy(), np.asarray(ji), atol=OP_TOL,
                               rtol=0)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-7)


def test_resample_block_ratio_one_is_passthrough():
    x = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    yr, _, pe = trs.resample_block(
        _t(x), _t(x), torch.full((3,), float(K // 2 - 1)), torch.ones(3),
        _t(trs.kaiser_sinc_table(P, K)), 32)
    np.testing.assert_allclose(yr.numpy(), x[K // 2 - 1: K // 2 - 1 + 32],
                               atol=1e-6)
    np.testing.assert_allclose(pe.numpy(), K // 2 - 1 + 32)


@pytest.mark.parametrize("num,den,kt,q", [(73, 80, 8, 6), (5, 4, 8, 9),
                                          (1, 4, 8, 64), (4, 1, 64, 60)])
def test_resample_block_uniform_matches_jax(num, den, kt, q):
    """The shifted-reshape windows (two shifts when num >= K, more when
    upsampling strongly) and the banded product, against JAX's einsum."""
    C = 3
    t_in = q * num + kt
    x = _noise((t_in, C), seed=num + den)
    S = trs.uniform_poly_matrix(num, den, kt, cutoff=min(1.0, den / num))
    yr, yi = trs.resample_block_uniform(_t(x.real), _t(x.imag), _t(S), num,
                                        den)
    jr, ji = jrs.resample_block_uniform(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()),
        jnp.asarray(S), num, den)
    assert tuple(yr.shape) == (q * den, C) and yr.is_contiguous()
    np.testing.assert_allclose(yr.numpy(), np.asarray(jr), atol=OP_TOL,
                               rtol=0)
    np.testing.assert_allclose(yi.numpy(), np.asarray(ji), atol=OP_TOL,
                               rtol=0)


def test_uniform_runs_without_tf32(monkeypatch):
    """The banded product runs at matmul precision "highest" (no TF32)
    whatever the caller set, and the caller's setting comes back, also
    when the product raises."""
    seen = []
    einsum = torch.einsum

    def recording(*a):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return einsum(*a)

    monkeypatch.setattr(torch, "einsum", recording)
    S = _t(trs.uniform_poly_matrix(5, 4))
    x = torch.randn(5 * 4 + K, 2)
    old = torch.get_float32_matmul_precision()
    try:
        for caller in ("high", "medium", "highest"):
            torch.set_float32_matmul_precision(caller)
            trs.resample_block_uniform(x, x, S, 5, 4)
            assert torch.get_float32_matmul_precision() == caller
        assert seen == [("highest", False)] * 6

        def failing(*a):
            raise RuntimeError("product failed")

        monkeypatch.setattr(torch, "einsum", failing)
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="product failed"):
            trs.resample_block_uniform(x, x, S, 5, 4)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)


def _stream(bank, xs, n_blocks, rng):
    """Step ``bank`` n_blocks times, pushing ragged chunks (sizes drawn
    from ``rng``) whenever it is not ready; returns the (C, B) blocks."""
    outs, fed = [], [0] * len(xs)
    while len(outs) < n_blocks:
        got = bank.step()
        if got is not None:
            outs.append(got)
            continue
        for c, x in enumerate(xs):
            n = int(rng.integers(1, 64))
            bank.push(c, x[fed[c]:fed[c] + n])
            fed[c] += n
    return outs


def _both(ratios, B, n_blocks, seed, **kw):
    """The port's and JAX's banks fed the same ragged pushes; returns
    (port blocks, JAX blocks, port bank, JAX bank)."""
    need = int(np.ceil(B * n_blocks * max(ratios))) + 8 * K
    xs = [_noise(need, seed + c) for c in range(len(ratios))]
    tb = trb.ResamplerBank(ratios, block_out=B, device="cpu", **kw)
    jb = jrb.ResamplerBank(ratios, block_out=B, **kw)
    got = _stream(tb, xs, n_blocks, np.random.default_rng(seed))
    ref = _stream(jb, xs, n_blocks, np.random.default_rng(seed))
    return got, ref, tb, jb


@pytest.mark.parametrize("ratios,kw,path", [
    ([0.9, 1.0, 1.2], dict(uniform=False), "gather"),
    (list(np.random.default_rng(104).uniform(0.6, 2.5, 4)), {}, "gather"),
    ([7.3 / 8] * 3, {}, "uniform"),
    ([1.25] * 2, {}, "uniform"),
    ([73 / 80, 1.0, 73 / 80, 37 / 32], {}, "grouped"),
    ([73 / 80, 1.0, 89 / 80, 37 / 32] * 2, dict(cutoff=32 / 37), "grouped"),
])
def test_bank_matches_jax(ratios, kw, path):
    """Each device path against JAX's bank on the same ragged pushes;
    the path picked and the bookkeeping (pending, the EOS drain) equal."""
    B = 48
    got, ref, tb, jb = _both(ratios, B, 4, seed=7, **kw)
    assert (tb._uniform, tb._groups is None) == (jb._uniform,
                                                 jb._groups is None)
    assert path == ("grouped" if tb._groups is not None else
                    "uniform" if tb._uniform else "gather")
    if tb._groups is not None:
        assert [idx.tolist() for idx, _, _ in tb._groups] == \
            [idx.tolist() for idx, _ in jb._groups]
    for a, b in zip(got, ref):
        assert a.dtype == np.complex64 and a.shape == (len(ratios), B)
        np.testing.assert_allclose(a, b, atol=OP_TOL, rtol=0)
    np.testing.assert_array_equal(tb.pending(), jb.pending())
    assert tb.ready() == jb.ready()
    t_tail, j_tail = tb.drain(planes=False), jb.drain(planes=False)
    assert len(t_tail) == len(j_tail)
    for a, b in zip(t_tail, j_tail):
        np.testing.assert_allclose(a, b, atol=OP_TOL, rtol=0)
    assert tb.drain(planes=False) == []


def test_planes_match_host_blocks():
    """step_planes gives (B, C) float32 planes on the bank's device, the
    same samples as step's (C, B) host blocks, on every path."""
    for ratios in ([0.9, 1.1], [1.25, 1.25], [1.25, 1.0, 1.25]):
        xs = [_noise(600, c) for c in range(len(ratios))]
        banks = [trb.ResamplerBank(ratios, 64, device="cpu")
                 for _ in range(2)]
        for b in banks:
            for c, x in enumerate(xs):
                b.push(c, x)
        re, im = banks[0].step_planes()
        assert re.dtype == torch.float32 and tuple(re.shape) == (64,
                                                                 len(ratios))
        np.testing.assert_array_equal(re.numpy().T + 1j * im.numpy().T,
                                      banks[1].step())


def test_gather_bank_streaming_matches_oneshot():
    """The ragged stream equals one one-shot device call over the whole
    input (tests/test_resample.py:103-147, JAX's bound)."""
    ratios = [0.9, 1.0, 1.2]
    B, n_blocks = 64, 5
    need = int(np.ceil(B * n_blocks * max(ratios))) + 4 * K
    xs = [_noise(need, 20 + c) for c in range(3)]
    bank = trb.ResamplerBank(ratios, block_out=B, uniform=False,
                             device="cpu")
    stream = np.concatenate(_stream(bank, xs, n_blocks,
                                    np.random.default_rng(0)), axis=1)
    x = np.stack(xs, axis=1)
    yr, yi, _ = trs.resample_block(
        _t(x.real), _t(x.imag), torch.full((3,), float(K // 2 - 1)),
        _t(np.asarray(ratios, np.float32)),
        _t(trs.kaiser_sinc_table(P, K, cutoff=1.0 / max(ratios))),
        B * n_blocks)
    np.testing.assert_allclose(stream, yr.numpy().T + 1j * yi.numpy().T,
                               atol=STREAM_TOL)


@pytest.mark.parametrize("ratios", [[7.3 / 8] * 2,
                                    [73 / 80, 1.0, 73 / 80, 37 / 32]])
def test_banded_paths_match_gather(ratios):
    """The uniform and grouped banks equal the gather bank with the same
    filter within the gather table's lerp error
    (tests/test_resample.py:454-495)."""
    B = 96
    co = min(1.0, 1.0 / max(ratios))
    fast = trb.ResamplerBank(ratios, B, cutoff=co, device="cpu")
    slow = trb.ResamplerBank(ratios, B, cutoff=co, uniform=False,
                             device="cpu")
    assert slow._uniform is None and slow._groups is None
    assert fast._uniform is not None or fast._groups is not None
    n = int(4 * B * max(ratios)) + 8 * K
    for c in range(len(ratios)):
        x = _noise(n, 30 + c)
        fast.push(c, x)
        slow.push(c, x)
    outs_f, outs_s = [], []
    while fast.ready():
        outs_f.append(fast.step())
    while slow.ready():
        outs_s.append(slow.step())
    assert len(outs_f) == len(outs_s) > 1
    np.testing.assert_allclose(np.concatenate(outs_f, axis=1),
                               np.concatenate(outs_s, axis=1), atol=PATH_TOL)


def test_pending_ready_drain():
    """tests/test_resample.py:150-159 and :237-268, against JAX's bank."""
    bank = trb.ResamplerBank([1.0, 1.5], block_out=32, device="cpu")
    jbank = jrb.ResamplerBank([1.0, 1.5], block_out=32)
    assert not bank.ready() and bank.step() is None
    p = bank.pending()
    np.testing.assert_array_equal(p, jbank.pending())
    assert p.shape == (2,) and (p > 0).all() and p[1] > p[0]
    for c in (0, 1):
        bank.push(c, np.zeros(int(p[c]), np.complex64))
    assert bank.ready() and bank.step() is not None

    ratios, B = [0.85, 1.3], 48
    bank = trb.ResamplerBank(ratios, block_out=B, device="cpu")
    jbank = jrb.ResamplerBank(ratios, block_out=B)
    n0, n1 = int(2.4 * B * ratios[0]), int(1.2 * B * ratios[1])
    for b in (bank, jbank):
        b.push(0, _noise(n0, 1))
        b.push(1, _noise(n1, 2))
    live = 0
    while bank.ready():
        np.testing.assert_allclose(bank.step(), jbank.step(), atol=OP_TOL)
        live += 1
    tail, jtail = bank.drain(planes=False), jbank.drain(planes=False)
    assert len(tail) == len(jtail) >= 1
    np.testing.assert_array_equal(bank._real, jbank._real)
    assert (bank._real <= bank.K).all()
    assert bank.drain(planes=False) == []
    total = (live + len(tail)) * B
    for n, r in zip((n0, n1), ratios):
        assert total >= (n - bank.K) / r


def test_set_ratio_tracks_tone_like_jax():
    """set_ratio mid-stream on the gather path: positions stay continuous
    and a resampled tone stays within 4e-3 of its continuous form
    (tests/test_resample.py:282-321); outputs equal JAX's bank."""
    f, B, r1, r2 = 0.07, 64, 1.0, 1.05
    bank = trb.ResamplerBank([r2], block_out=B, uniform=False, device="cpu")
    jbank = jrb.ResamplerBank([r2], block_out=B, uniform=False)
    for b in (bank, jbank):
        with pytest.raises(ValueError):
            b.set_ratio(0, 1.2)
        with pytest.raises(ValueError):
            b.set_ratio(0, 0.0)
        b.set_ratio(0, r1)
        b.push(0, np.exp(2j * np.pi * f * np.arange(800)).astype(
            np.complex64))
    abs_pos = float(bank._pos[0])
    outs, times = [], []
    for i in range(6):
        if i == 3:
            bank.set_ratio(0, r2)
            jbank.set_ratio(0, r2)
        r = r1 if i < 3 else r2
        got = bank.step()
        np.testing.assert_allclose(got, jbank.step(), atol=OP_TOL)
        outs.append(got[0])
        times.append(abs_pos + np.arange(B) * r)
        abs_pos += B * r
    want = np.exp(2j * np.pi * f * np.concatenate(times))
    assert np.abs(np.concatenate(outs) - want).max() < 4e-3
    for ratios in ([1.25, 1.25], [1.25, 1.0]):
        with pytest.raises(ValueError, match="uniform=False"):
            trb.ResamplerBank(ratios, 32, device="cpu").set_ratio(0, 1.0)


def _run_engine(eng, xs, sri, chunk):
    """Native-rate pushes in chunks, step_packets after each, then the
    flush; returns the non-empty packet dicts."""
    eng.set_input_sri(sri, 0.0)
    out = []
    for i in range(0, max(len(x) for x in xs), chunk):
        for c, x in enumerate(xs):
            eng.push(c, x[i:i + chunk])
        while True:
            pkts = eng.step_packets()
            if pkts is None:
                break
            out.append(pkts)
    out.extend(eng.flush_packets())
    return [p for p in out if p]


def _assert_packets(got, ref, live):
    """Packets agree; in the drained tail, past ``live[c]`` symbols of
    channel c, the timing windows hold only the EOS zero padding, whose
    energies tie exactly, so there the values are not compared."""
    assert len(got) == len(ref) > 0
    done = 0
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        width = a[PORT_PHASE].data.shape[-1]
        keep = (done + np.arange(width))[None, :] < live[:, None]
        done += width
        for port in a:
            pa, pb = a[port], b[port]
            assert (pa.t, pa.eos) == (pb.t, pb.eos)
            assert pa.sri.xdelta == pb.sri.xdelta
            assert pa.data.shape == pb.data.shape
            if not width:
                continue
            k = np.repeat(keep, pa.data.shape[-1] // width, axis=1)
            da, db = pa.data[k], pb.data[k]
            if port in (PORT_BITS, PORT_SAMPLE_INDEX):
                np.testing.assert_array_equal(da, db, err_msg=port)
            else:
                tol = PHASE_TOL if port == PORT_PHASE else SOFT_TOL
                np.testing.assert_allclose(da, db, atol=tol, rtol=0,
                                           err_msg=port)


@pytest.mark.parametrize("pipeline,C,native,extra", [
    ("ff", 2, 7.3, {}),
    ("ff", 4, [7.3, 8.0, 8.9, 9.25], {}),
    ("full", 128, [7.3, 8.0, 8.9, 9.25] * 32, {}),
    ("full", 128, list(7.3 + 1.95 * np.arange(128) / 127),
     dict(resampler_kwargs=dict(uniform=False))),
])
def test_resampled_bank_engine_matches_jax(pipeline, C, native, extra):
    """ResampledBankEngine over the BatchEngine ("ff") and the full engine
    (the port's plain B1; JAX's interpret-mode kernel), raised-cosine QPSK
    at each channel's native sps with its symbol centres on the common
    grid: packets as JAX's, the packet clock rescaled alike."""
    kw = dict(sps=8, num_avg=20, constellation_size=4, phase_avg=12)
    B = 64
    sps = np.broadcast_to(np.asarray(native, np.float64), (C,))
    n = int(4.5 * B * 8 * sps.max() / 8)
    xs, _ = rc_psk(sps, n, 4, np.random.default_rng(17), offset=K // 2 - 1)
    eng = trb.ResampledBankEngine(DemodConfig(**kw), C, native,
                                  block_symbols=B, pipeline=pipeline,
                                  device="cpu", **extra)
    jkw = dict(extra, s_tile=B, interpret=True) if pipeline == "full" \
        else extra
    jeng = jrb.ResampledBankEngine(JaxDemodConfig(**kw), C, native,
                                   block_symbols=B, pipeline=pipeline, **jkw)
    got = _run_engine(eng, xs, SRI("t", xdelta=1.0), 1000)
    ref = _run_engine(jeng, xs, JaxSRI("t", xdelta=1.0), 1000)
    assert eng.metrics.symbols_out > 0
    assert dataclasses.asdict(eng.metrics) == dataclasses.asdict(
        jeng.metrics)
    r = eng.resampler.ratios
    # emitted symbols whose timing window still reads pushed samples
    live = ((n - 2 * K) / r / 8).astype(np.int64) - 2
    _assert_packets(got, ref, live)
    scale = r[0] if np.allclose(r, r[0]) else np.median(r)
    assert eng.engine.assembler.sri.xdelta == pytest.approx(scale)


def test_resampled_bank_engine_configure_guard():
    cfg = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
    eng = trb.ResampledBankEngine(cfg, 1, 7.3, block_symbols=32,
                                  pipeline="ff", device="cpu")
    with pytest.raises(ValueError):
        eng.configure(dataclasses.replace(cfg, sps=10))
    eng.configure(dataclasses.replace(cfg, constellation_size=8))
    assert eng.engine.cfg.constellation_size == 8
    eng.reset()
    assert eng.metrics.resets == 1
    np.testing.assert_array_equal(eng.pending(), eng.resampler.pending())
