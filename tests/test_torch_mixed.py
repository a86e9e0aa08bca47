"""Port parity, mixed-mode banks (BASELINE config 4): models/mixed and
runtime/engine_mixed.MixedKernelBatchEngine of psk_soft_tpu_torch on the
CPU (kernel B1's plain version in its mixed mode) against the JAX package
(the XLA mixed pipeline, and MixedKernelBatchEngine with the Pallas kernel
in interpret mode) on the same numpy inputs.

Bounds: the feed-forward mixed pipeline to 1e-4 with bits and sample index
equal (tests/test_torch_blockpsk.py's bound for the same arithmetic); the
engines as tests/test_mixed_engine.py holds the JAX engine against the XLA
pipeline (soft 5e-3, bits and sample index equal), on float32 and on int16
wire planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models.mixed import MixedParams as JaxMixedParams
from psk_soft_tpu.models.mixed import make_mixed_demod_fn as jax_mixed_fn
from psk_soft_tpu.models.mixed import mixed_init as jax_mixed_init
from psk_soft_tpu.runtime.engine import \
    MixedKernelBatchEngine as JaxMixedKernelBatchEngine
from psk_soft_tpu.runtime.streams import SRI as JaxSRI
from psk_soft_tpu.utils.transfer import to_host
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import mixed
from psk_soft_tpu_torch.ops.phase import UNWRAP_TREND_LEN
from psk_soft_tpu_torch.runtime.engine_mixed import MixedKernelBatchEngine
from psk_soft_tpu_torch.runtime.streams import PORT_BITS, PORT_SOFT, SRI
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

C, SPS, BLOCK = 128, 8, 128
KW = dict(sps=SPS, num_avg=50, constellation_size=4, phase_avg=20)
TOL = 1e-4


def _mixed_bank(num_symbols, seed=0):
    """tests/test_mixed_engine.py's bank: M in {2, 4, 8} and the
    differential flag drawn per channel, the symbol on sample 3."""
    rng = np.random.default_rng(seed)
    ms = rng.choice([2, 4, 8], C)
    diffs = rng.random(C) < 0.5
    xs = []
    for i in range(C):
        r = np.random.default_rng(seed + 1 + i)
        m = int(ms[i])
        pts = np.exp(2j * np.pi * r.integers(0, m, num_symbols) / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.zeros(num_symbols * SPS, np.complex64)
        x[3::SPS] = pts * np.exp(2j * np.pi * 1e-4 * SPS
                                 * np.arange(num_symbols))
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return ms, diffs, np.stack(xs)


def _np(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def test_mixed_params_match_jax():
    ms = np.array([2, 4, 8, 16, 32, 4])
    p = mixed.MixedParams.make(ms, np.zeros(6, bool), "cpu")
    jp = JaxMixedParams.make(ms, np.zeros(6, bool))
    np.testing.assert_array_equal(p.bits_per_symbol.numpy(),
                                  np.asarray(jp.bits_per_symbol))
    assert p.max_bits == jp.max_bits == 5
    assert mixed.MixedParams.make([2, 4], [0, 1], "cpu").max_bits == 3
    q = interop.mixed_params_from_numpy(np.asarray(jp.m), np.asarray(jp.diff),
                                        "cpu")
    assert q.m.dtype == torch.int32 and q.diff.dtype == torch.bool
    np.testing.assert_array_equal(q.m.numpy(), ms)


@pytest.mark.parametrize("max_bits", [3, 5])
def test_mixed_pipeline_matches_jax(max_bits):
    """models/mixed over two consecutive blocks from a fresh carry (the
    warm-up's valid prefix and the growing phase window included); with
    max_bits 5 a 32-PSK and a 16-PSK channel join the bank."""
    cfg, jcfg = DemodConfig(**KW), JaxDemodConfig(**KW)
    ms, diffs, xs = _mixed_bank(320, seed=11)
    if max_bits == 5:
        ms = ms.copy()
        ms[:2] = (32, 16)
    p = mixed.MixedParams.make(ms, diffs, "cpu")
    jp = JaxMixedParams.make(ms, diffs)
    fn = mixed.make_mixed_demod_fn(cfg, max_bits=max_bits)
    jfn = jax_mixed_fn(jcfg, max_bits=max_bits)
    st, jst = mixed.mixed_init(cfg, C, "cpu"), jax_mixed_init(jcfg, C)
    for blk in np.split(xs, 2, axis=1):
        st, out = fn(p, st, torch.from_numpy(blk))
        jst, jout = jfn(jp, jst, jnp.asarray(blk))
        jout = to_host(jout)
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
        np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
        np.testing.assert_array_equal(out.sample_index.numpy(),
                                      np.asarray(jout.sample_index))
        np.testing.assert_allclose(out.soft.numpy(), np.asarray(jout.soft),
                                   atol=TOL)
        np.testing.assert_allclose(out.phase.numpy(), np.asarray(jout.phase),
                                   atol=TOL)
    got = interop.ff_state_to_numpy(st)
    for f, v in _np(to_host(jst)).items():
        np.testing.assert_allclose(got[f], v, atol=TOL, err_msg=f)


def _engines(seed, n_blocks, **kw):
    ms, diffs, xs = _mixed_bank(n_blocks * BLOCK, seed=seed)
    eng = MixedKernelBatchEngine(mixed.MixedParams.make(ms, diffs, "cpu"),
                                 DemodConfig(**KW), C, block_symbols=BLOCK,
                                 device="cpu", **kw)
    jeng = JaxMixedKernelBatchEngine(JaxMixedParams.make(ms, diffs),
                                     JaxDemodConfig(**KW), C,
                                     block_symbols=BLOCK, s_tile=128,
                                     interpret=True, **kw)
    return ms, diffs, xs, eng, jeng


def _assert_step(o, jo, soft_tol=5e-3):
    v = np.asarray(jo.valid)
    np.testing.assert_array_equal(o.valid.numpy(), v)
    np.testing.assert_allclose(o.soft.numpy()[v], np.asarray(jo.soft)[v],
                               atol=soft_tol)
    np.testing.assert_array_equal(o.bits.numpy()[v], np.asarray(jo.bits)[v])
    np.testing.assert_array_equal(o.sample_index.numpy()[v],
                                  np.asarray(jo.sample_index)[v])


def test_mixed_engine_packets_match_jax():
    """Warm-up on models/mixed, hand-off with the mode rows, kernel B1's
    mixed mode in the steady state, and packets in the uniform 3-bit port
    layout, against the JAX engine; then the EOS drain."""
    ms, diffs, xs, eng, jeng = _engines(40, 4)
    eng.set_input_sri(SRI(stream_id="mixed", xdelta=1e-6))
    jeng.set_input_sri(JaxSRI(stream_id="mixed", xdelta=1e-6))
    blocks = np.split(xs, 4, axis=1)
    for blk in blocks[:3]:
        for c in range(C):
            eng.push(c, blk[c])
            jeng.push(c, blk[c])
        p, jp = eng.step_packets(), jeng.step_packets()
        assert set(p) == set(jp)
        np.testing.assert_array_equal(p[PORT_BITS].data, jp[PORT_BITS].data)
        np.testing.assert_allclose(p[PORT_SOFT].data, jp[PORT_SOFT].data,
                                   atol=5e-3)
        assert p[PORT_SOFT].t == jp[PORT_SOFT].t
    assert eng.steady and jeng.steady
    misc = KW["phase_avg"] - 1 + 2 * (UNWRAP_TREND_LEN - 1)
    np.testing.assert_array_equal(eng.full_state.planes[misc + 6].numpy(), ms)
    np.testing.assert_array_equal(eng.full_state.planes[misc + 7].numpy(),
                                  diffs)
    sv = p[PORT_SOFT].data.shape[1]
    assert p[PORT_BITS].data.shape == (C, sv * 3)
    assert np.isclose(p[PORT_BITS].sri.xdelta * 3, 1e-6 * KW["sps"])
    tail = blocks[3][:, :40 * SPS]
    for c in range(C):
        eng.push(c, tail[c])
        jeng.push(c, tail[c])
    f, jf = eng.flush_packets(), jeng.flush_packets()
    np.testing.assert_array_equal(f[PORT_BITS].data, jf[PORT_BITS].data)
    assert f[PORT_SOFT].eos and f[PORT_SOFT].data.shape == (C, 40)


def test_mixed_engine_set_params_matches_jax():
    """set_params mid-stream: channels whose M changed restart their phase
    tracking, the others carry it; both engines re-warm and hand back to
    the kernel, block for block equal."""
    ms, diffs, xs, eng, jeng = _engines(80, 6)
    blocks = np.split(xs, 6, axis=1)
    new_m = ms.copy()
    new_m[:8] = np.where(new_m[:8] == 8, 4, 8)
    new_d = diffs.copy()
    new_d[:8] = False
    for b, blk in enumerate(blocks):
        if b == 3:
            eng.set_params(mixed.MixedParams.make(new_m, new_d, "cpu"))
            jeng.set_params(JaxMixedParams.make(new_m, new_d))
            assert not eng.steady
            pc = eng._warm_state.phase_count.numpy()
            assert (pc[:8] == 0).all() and (pc[8:] > 0).all()
            np.testing.assert_array_equal(
                pc, np.asarray(jeng._warm_state.phase_count))
        eng.push_planes(np.ascontiguousarray(blk.real.T),
                        np.ascontiguousarray(blk.imag.T))
        jeng.push_planes(np.ascontiguousarray(blk.real.T),
                         np.ascontiguousarray(blk.imag.T))
        _assert_step(eng.step(), jeng.step())
    assert eng.steady and jeng.steady
    assert eng.metrics.reconfigures == 1


def test_mixed_engine_int16_planes_match_jax():
    """Mixed modes on int16 wire planes against the JAX engine on the same
    planes; the window carry int16, the mode rows float32."""
    ms, diffs, xs, _, _ = _engines(120, 3)
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    re = np.round(np.ascontiguousarray(xs.real.T) / scale).astype(np.int16)
    im = np.round(np.ascontiguousarray(xs.imag.T) / scale).astype(np.int16)
    _, _, _, eng, jeng = _engines(120, 3, ingest_scale=scale)
    n = BLOCK * SPS
    for b in range(3):
        eng.push_planes(re[b * n:(b + 1) * n], im[b * n:(b + 1) * n])
        jeng.push_planes(re[b * n:(b + 1) * n], im[b * n:(b + 1) * n])
        _assert_step(eng.step(), jeng.step(), soft_tol=5e-3)
    assert eng.steady and eng.full_state.win_re.dtype == torch.int16
    assert eng.full_state.planes.dtype == torch.float32


def test_mixed_engine_guard_keeps_modes_and_debug_ports_off():
    """A poisoned channel restarts with zero tracking but keeps its mode
    rows (its M and differential flag); with debug ports off the port set
    stays {soft, bits} through warm-up, steady state and the drain."""
    ms, diffs, xs = _mixed_bank(4 * BLOCK, seed=9)
    eng = MixedKernelBatchEngine(mixed.MixedParams.make(ms, diffs, "cpu"),
                                 DemodConfig(**KW), C, block_symbols=BLOCK,
                                 guard_nonfinite=True, device="cpu")
    blocks = [b.copy() for b in np.split(xs, 4, axis=1)]
    blocks[2][5, 100:120] = np.nan
    for blk in blocks[:3]:
        eng.push_planes(np.ascontiguousarray(blk.real.T),
                        np.ascontiguousarray(blk.imag.T))
        eng.step()
    assert eng.channel_resyncs[5] == 1 and eng.channel_resyncs.sum() == 1
    misc = KW["phase_avg"] - 1 + 2 * (UNWRAP_TREND_LEN - 1)
    planes = eng.full_state.planes
    assert not planes[:misc + 6, 5].any()
    assert planes[misc + 6, 5] == ms[5] and planes[misc + 7, 5] == diffs[5]

    quiet = MixedKernelBatchEngine(mixed.MixedParams.make(ms, diffs, "cpu"),
                                   DemodConfig(**KW), C, block_symbols=BLOCK,
                                   debug_ports=False, device="cpu")
    seen = set()
    for blk in np.split(xs, 4, axis=1)[:3]:
        for c in range(C):
            quiet.push(c, blk[c])
        seen |= set(quiet.step_packets() or {})
    assert quiet.steady
    for c in range(C):
        quiet.push(c, xs[c, :10 * SPS])
    seen |= set(quiet.flush_packets())
    assert seen == {PORT_SOFT, PORT_BITS}


def test_mixed_engine_rejects_bad_params():
    with pytest.raises(ValueError, match="channel modes"):
        MixedKernelBatchEngine(mixed.MixedParams.make([2, 4], [0, 0], "cpu"),
                               DemodConfig(**KW), C, device="cpu")
    with pytest.raises(ValueError, match="M must be"):
        MixedKernelBatchEngine(mixed.MixedParams.make(np.full(C, 3),
                                                      np.zeros(C), "cpu"),
                               DemodConfig(**KW), C, device="cpu")
    import inspect
    params = inspect.signature(MixedKernelBatchEngine).parameters
    assert params["device"].default == "cuda"
