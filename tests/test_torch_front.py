"""Port parity, front chain: psk_soft_tpu_torch's ops/mixer, ops/agc,
eval/cfo, models/chain's front chain and ChainEngine(acquire_cfo=True) on
the CPU against the JAX package (Pallas kernels with interpret=True), fed
the same numpy inputs.

Bounds: derotate within 1e-6 of JAX on one block (both round the float32
NCO angle once; cos/sin accurate), its carried phase within 1e-4 rad (the
two packages round the ~500-rad end phase differently); AGC gains and powers within 1e-5
relative, samples within 1e-5 (tests/test_chain_front.py:35-62, and the
float64 oracle to 1e-5 / 1e-4 as tests/test_agc.py:25-35); the host CFO
estimates equal.  Chains are held at frame level: found, pos, count, ok and
message bits equal, correlation angles within 1e-4; ChainEngine's Frame
lists and cfo_estimates equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.eval import cfo as jcfo
from psk_soft_tpu.models import chain as jchain
from psk_soft_tpu.models.blockpsk import demod_block_ff as jax_demod_block_ff
from psk_soft_tpu.models.blockpsk import ff_init as jax_ff_init
from psk_soft_tpu.models.full import full_from_ff as jax_full_from_ff
from psk_soft_tpu.ops import agc as jagc
from psk_soft_tpu.ops import mixer as jmixer
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.crc import CRC16_CCITT as JAX_CRC16
from psk_soft_tpu.ops.fec import CODE_K7 as JAX_K7
from psk_soft_tpu.ops.framesync import FrameFormat as JaxFrameFormat
from psk_soft_tpu.runtime.chain_engine import ChainEngine as JaxChainEngine
from psk_soft_tpu.runtime.streams import SRI as JaxSRI
from psk_soft_tpu.runtime.streams import Packet as JaxPacket
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.eval import cfo
from psk_soft_tpu_torch.models import chain
from psk_soft_tpu_torch.ops import agc, mixer
from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
from psk_soft_tpu_torch.ops.cuda import demod_kernel, viterbi_kernel
from psk_soft_tpu_torch.ops.fec import CODE_K7
from psk_soft_tpu_torch.runtime.chain_engine import ChainEngine
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

ANG_TOL = 1e-4
C = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_derotate_matches_jax():
    rng = np.random.default_rng(0)
    T = 4096
    re = rng.standard_normal((T, C)).astype(np.float32)
    im = rng.standard_normal((T, C)).astype(np.float32)
    freq = (0.018 + 0.006 * np.arange(C) / C).astype(np.float32)
    ph0 = rng.uniform(-3, 3, C).astype(np.float32)
    want = jmixer.derotate(jnp.asarray(re), jnp.asarray(im),
                           jnp.asarray(freq), jnp.asarray(ph0))
    got = mixer.derotate(_t(re), _t(im), _t(freq), _t(ph0))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    d = got[2].numpy() - np.asarray(want[2])
    assert np.abs(d - 2 * np.pi * np.round(d / (2 * np.pi))).max() < 1e-4
    assert got[2].dtype == torch.float32
    # The carried phase continues the stream: two half blocks == one block.
    y1 = mixer.derotate(_t(re[:T // 2]), _t(im[:T // 2]), _t(freq), _t(ph0))
    y2 = mixer.derotate(_t(re[T // 2:]), _t(im[T // 2:]), _t(freq), y1[2])
    np.testing.assert_allclose(torch.cat([y1[0], y2[0]]).numpy(),
                               got[0].numpy(), atol=2e-3)
    x = (re + 1j * im).T.astype(np.complex64)
    np.testing.assert_array_equal(mixer.derotate_host(x, freq, ph0),
                                  jmixer.derotate_host(x, freq, ph0))
    np.testing.assert_array_equal(mixer.derotate_host(x[0], 0.01),
                                  jmixer.derotate_host(x[0], 0.01))


@pytest.mark.parametrize("squelch", [0.0, 2e-2])
def test_agc_matches_jax_and_oracle(squelch):
    kw = dict(alpha=0.07, chunk=8, squelch_power=squelch)
    jcfg, cfg = jagc.AgcConfig(**kw), agc.AgcConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 512)) + 1j * rng.standard_normal((5, 512))
         ).astype(np.complex64)
    x *= np.geomspace(0.01, 30.0, 5)[:, None].astype(np.float32)
    x[0, 256:] *= 1e-3                       # a channel that falls silent
    jst1, jy, jinfo = jagc.agc_block(jcfg, jagc.agc_init(jcfg, (5,)), x)
    st1, y, info = agc.agc_block(cfg, agc.agc_init(cfg, (5,), "cpu"), _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    for k in ("gain", "power"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(jinfo[k]),
                                   rtol=1e-5)
    np.testing.assert_array_equal(info["active"].numpy(),
                                  np.asarray(jinfo["active"]))
    assert bool(info["active"].all()) == (squelch == 0.0)
    np.testing.assert_allclose(st1.power.numpy(), np.asarray(jst1.power),
                               rtol=1e-5)
    for c in range(5):
        y_ref, g_ref, p_ref = agc.agc_reference(cfg, x[c])
        np.testing.assert_allclose(info["power"][c].numpy(), p_ref,
                                   rtol=1e-5)
        np.testing.assert_allclose(y[c].numpy(), y_ref, atol=1e-4)
        np.testing.assert_array_equal(
            y_ref, jagc.agc_reference(jcfg, x[c])[0])
    # Time-major planes, streamed in two halves.
    re, im = _t(x.real.T), _t(x.imag.T)
    st = agc.agc_init(cfg, 5, "cpu")
    st, r1, i1, _ = agc.agc_block_tm(cfg, st, re[:256], im[:256])
    st, r2, i2, info2 = agc.agc_block_tm(cfg, st, re[256:], im[256:])
    jst = jagc.agc_init(jcfg, (5,))
    jst, jr1, _, _ = jagc.agc_block_tm(jcfg, jst, jnp.asarray(re[:256]),
                                       jnp.asarray(im[:256]))
    jst, jr2, ji2, jinfo2 = jagc.agc_block_tm(jcfg, jst,
                                              jnp.asarray(re[256:]),
                                              jnp.asarray(im[256:]))
    np.testing.assert_allclose(torch.cat([r1, r2]).numpy(), y.real.numpy().T,
                               atol=1e-5)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), atol=1e-5)
    np.testing.assert_allclose(i2.numpy(), np.asarray(ji2), atol=1e-5)
    np.testing.assert_allclose(info2["gain"].numpy(),
                               np.asarray(jinfo2["gain"]), rtol=1e-5)
    np.testing.assert_allclose(st.power.numpy(), np.asarray(jst.power),
                               rtol=1e-5)
    with pytest.raises(ValueError):
        agc.AgcConfig(alpha=0.0)
    with pytest.raises(ValueError, match="multiple of chunk"):
        agc.agc_block(cfg, agc.agc_init(cfg, (), "cpu"),
                      torch.zeros(12, dtype=torch.complex64))


def test_cfo_estimators_match_jax():
    rng = np.random.default_rng(7)
    n = 3000
    freqs = np.array([0.011, -0.02, 0.03, 0.0004])
    m = np.array([4, 4, 2, 8])
    sym = np.exp(2j * np.pi * rng.integers(0, 8, (4, n)) / m[:, None])
    x = (sym * np.exp(2j * np.pi * freqs[:, None] * np.arange(n))
         ).astype(np.complex64)
    got = cfo.acquire_cfo(x, m)
    np.testing.assert_array_equal(got, jcfo.acquire_cfo(x, m))
    np.testing.assert_allclose(got, freqs, atol=1e-4)
    assert cfo.acquire_cfo(x[0], 4) == jcfo.acquire_cfo(x[0], 4)
    phase = np.cumsum(rng.normal(0.02, 1e-3, (3, 200)), axis=1)
    phase[:, 120:] -= 4 * 2 * np.pi                      # an M*2pi re-wrap
    np.testing.assert_array_equal(cfo.cfo_from_phase(phase, 4, 8),
                                  jcfo.cfo_from_phase(phase, 4, 8))
    np.testing.assert_array_equal(
        cfo.cfo_from_phase(phase.T, np.array([4, 4, 8]), 8, symbol_axis=0),
        jcfo.cfo_from_phase(phase.T, np.array([4, 4, 8]), 8, symbol_axis=0))
    kw = dict(sps=8, num_avg=40, constellation_size=4, phase_avg=30)
    pkt = JaxPacket(data=phase, sri=JaxSRI("s", xdelta=8e-6), t=0.0)
    np.testing.assert_array_equal(
        cfo.cfo_from_packet(pkt, DemodConfig(**kw)),
        jcfo.cfo_from_packet(pkt, JaxDemodConfig(**kw)))
    with pytest.raises(ValueError, match="2 symbols"):
        cfo.cfo_from_phase(phase[:, :1], 4, 8)


# --- the front chain ---------------------------------------------------------

def _front_setup():
    """tests/test_chain_front.py's setup: offsets beyond the tracker's
    pull-in and a 400x amplitude spread."""
    sps, S = 8, 512
    kw = dict(sps=sps, num_avg=40, constellation_size=4, phase_avg=30)
    rng = np.random.default_rng(41)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                          threshold=0.7)
    n_msg = jchain.chain_msg_bits(jfmt, JAX_K7, JAX_CRC16)
    rows = [70, 290]
    starts = [r - (kw["num_avg"] - 1) for r in rows]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in rows]
    idx_row = tx.frame_stream(jfmt, infos, starts, S, code=JAX_K7,
                              crc=JAX_CRC16, labeling="gray", seed=42)
    clean = np.repeat(np.exp(1j * (2 * np.pi * np.tile(idx_row, (C, 1)) / 4
                                   + 0.3)), sps, axis=1)
    freqs = (0.02 + 0.005 * np.arange(C) / C).astype(np.float32)
    gains = np.geomspace(0.05, 20.0, C)[:, None]
    t = np.arange(clean.shape[1])
    x = (clean * gains * np.exp(2j * np.pi * freqs[:, None] * t[None])
         ).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return kw, jfmt, rows, infos, x, freqs


def test_front_chain_matches_jax_beyond_pullin():
    """NCO + AGC ahead of B1: two blocks through the port's front chain
    equal the JAX front chain's and decode every frame exactly, where the
    plain chain on the same capture fails."""
    kw, jfmt, rows, infos, x, freqs = _front_setup()
    jcfg, cfg = JaxDemodConfig(**kw), DemodConfig(**kw)
    fmt = interop.frame_format_from_jax_dict(dataclasses.asdict(jfmt))
    jagc_cfg = jagc.AgcConfig(alpha=0.1, chunk=8, target_rms=1.0)
    agc_cfg = interop.agc_config_from_jax_dict(dataclasses.asdict(jagc_cfg))
    y = jmixer.derotate_host(x, freqs)
    _, y_agc, _ = jagc.agc_block(jagc_cfg, jagc.agc_init(jagc_cfg, (C,)), y)
    st_ff, _ = jax.jit(jax.vmap(functools.partial(jax_demod_block_ff, jcfg)))(
        jax_ff_init(jcfg, (C,)), jnp.asarray(np.asarray(y_agc)))
    jdemod = jax_full_from_ff(jcfg, st_ff)
    demod_np = {f: np.asarray(getattr(jdemod, f)) for f in jdemod._fields}
    re, im = np.ascontiguousarray(x.real.T), np.ascontiguousarray(x.imag.T)

    jfront = jax.jit(jchain.make_front_chain_fn(
        jcfg, jfmt, JAX_K7, len(rows), crc=JAX_CRC16, agc_cfg=jagc_cfg,
        interpret=True))
    jst = jchain.front_chain_init(jfmt, C, jdemod, agc_cfg=jagc_cfg,
                                  freq=freqs)
    front = chain.make_front_chain_fn(cfg, fmt, CODE_K7, len(rows),
                                      crc=CRC16_CCITT, agc_cfg=agc_cfg)
    st = chain.front_chain_init(fmt, C, interop.full_state_from_numpy(
        demod_np, "cpu"), agc_cfg=agc_cfg, freq=freqs)
    assert isinstance(st.front.agc, agc.AgcState)
    for _ in range(2):
        jst, jout = jfront(jst, jnp.asarray(re), jnp.asarray(im))
        st, out = front(st, _t(re), _t(im))
        found = out.found.numpy()
        np.testing.assert_array_equal(found, np.asarray(jout.found))
        np.testing.assert_array_equal(out.pos.numpy(), np.asarray(jout.pos))
        np.testing.assert_array_equal(out.count.numpy(),
                                      np.asarray(jout.count))
        np.testing.assert_array_equal(out.msg.numpy()[found],
                                      np.asarray(jout.msg)[found])
        np.testing.assert_array_equal(out.ok.numpy(), np.asarray(jout.ok))
        np.testing.assert_allclose(out.ang.numpy()[found],
                                   np.asarray(jout.ang)[found], atol=ANG_TOL)
    assert found.all() and out.ok.all()
    np.testing.assert_array_equal(out.pos.numpy(), np.tile(rows, (C, 1)))
    np.testing.assert_array_equal(out.msg.numpy(),
                                  np.tile(np.stack(infos), (C, 1, 1)))
    np.testing.assert_allclose(st.front.agc.power.numpy(),
                               np.asarray(jst.front.agc.power), rtol=1e-5)
    rt = interop.front_chain_state_to_numpy(st)          # with an AGC
    back = interop.front_chain_state_from_numpy(rt["front"], rt["demod"],
                                                rt["tail"], "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tuple(back)),
                    jax.tree_util.tree_leaves(tuple(st))):
        assert torch.equal(a, b)
    # The plain chain on the raw capture: the offset defeats the tracker.
    plain = chain.make_chain_fn(cfg, fmt, CODE_K7, len(rows),
                                crc=CRC16_CCITT)
    _, out_p = plain(chain.chain_init(fmt, C, interop.full_state_from_numpy(
        demod_np, "cpu")), _t(re), _t(im))
    assert not (out_p.found & out_p.ok).all()


# --- ChainEngine(acquire_cfo=True) --------------------------------------------

S = 256
KW = dict(sps=8, num_avg=40, constellation_size=4, phase_avg=30)
N_BLOCKS = 6
SNAP_AT, SET_CFO_AT = 3, 4      # carry snapshot / set_cfo before block i


def _acq_stream():
    """tests/test_chain_engine.py:291-330's stream: K7 + CRC-16 frames at
    irregular starts from symbol 140, offsets 0.018 + 0.006*c/C."""
    rng = np.random.default_rng(95)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                          threshold=0.7)
    n_msg = jchain.chain_msg_bits(jfmt, JAX_K7, JAX_CRC16)
    total = N_BLOCKS * S
    starts, p = [], 140
    while p + jfmt.frame_len <= total - jfmt.separation:
        starts.append(p)
        p += jfmt.separation + int(rng.integers(5, 60))
    truth, rows = {}, []
    for c in range(C):
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
        truth.update({(c, s0): i for s0, i in zip(starts, infos)})
        idx = tx.frame_stream(jfmt, infos, starts, total, code=JAX_K7,
                              crc=JAX_CRC16, labeling="gray", seed=96 + c)
        rows.append(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)))
    x = np.repeat(np.stack(rows), 8, axis=1).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    freqs = (0.018 + 0.006 * np.arange(C) / C).astype(np.float32)
    t = np.arange(x.shape[1])
    x = (x * np.exp(2j * np.pi * freqs[:, None] * t[None])
         ).astype(np.complex64)
    return jfmt, x, truth, freqs


def _key(frames):
    return [(f.channel, f.start, f.crc_ok, tuple(f.info_bits.tolist()))
            for f in frames]


def _run(eng, x, lo=0, snap=None):
    """Blocks lo.. through ``eng``; set_cfo before SET_CFO_AT; returns the
    per-step frame lists (flush last) and the carry taken before SNAP_AT."""
    steps = []
    for b in range(lo, N_BLOCKS):
        if b == SNAP_AT and snap is not None:
            snap.append((eng.chain_state, eng._base, eng._blocks))
        if b == SET_CFO_AT:
            eng.set_cfo(eng.cfo_estimates + np.float32(2e-6))
        eng.push_block(x[:, b * S * 8:(b + 1) * S * 8])
        steps.append(_key(eng.step()))
    steps.append(_key(eng.flush()))
    return steps


@pytest.fixture(scope="module")
def acq_run():
    jfmt, x, truth, freqs = _acq_stream()
    eng = JaxChainEngine(JaxDemodConfig(**KW), C, jfmt, JAX_K7, JAX_CRC16,
                         block_symbols=S, acquire_cfo=True, interpret=True)
    snap = []
    steps = _run(eng, x, snap=snap)
    return dict(jfmt=jfmt, x=x, truth=truth, freqs=freqs, steps=steps,
                snap=snap[0], est=np.asarray(eng.cfo_estimates),
                counters=(eng.frames_synced, eng.crc_failures))


def _port_engine(jfmt, **kw):
    fmt = interop.frame_format_from_jax_dict(dataclasses.asdict(jfmt))
    return ChainEngine(DemodConfig(**KW), C, fmt, CODE_K7, CRC16_CCITT,
                       block_symbols=S, device="cpu", **kw)


def test_chain_engine_acquire_cfo_matches_jax(acq_run):
    """Frame for frame equal to the JAX engine (set_cfo mid-stream
    included); every frame after the warm-up decoded with exact bits and
    the estimates within 1e-4 of the truth, where the plain engine decodes
    fewer than half."""
    demod_kernel.demod_full_tm.launches = 0
    viterbi_kernel.viterbi_fused.launches = 0
    eng = _port_engine(acq_run["jfmt"], acquire_cfo=True)
    steps = _run(eng, acq_run["x"])
    assert steps == acq_run["steps"]
    np.testing.assert_array_equal(eng.cfo_estimates, acq_run["est"])
    assert (eng.frames_synced, eng.crc_failures) == acq_run["counters"]
    assert demod_kernel.demod_full_tm.launches == 0      # CPU: plain
    assert viterbi_kernel.viterbi_fused.launches == 0
    got = {(c, s0): bits for step in steps for c, s0, ok, bits in step
           if ok}
    truth = acq_run["truth"]
    post_warm = [k for k in truth if k[1] >= S]
    for key in post_warm:
        assert key in got, f"missed {key}"
        np.testing.assert_array_equal(got[key], truth[key])
    np.testing.assert_allclose(eng.cfo_estimates - 2e-6, acq_run["freqs"],
                               atol=1e-4)
    plain = _port_engine(acq_run["jfmt"])
    for b in range(N_BLOCKS):
        plain.push_block(acq_run["x"][:, b * S * 8:(b + 1) * S * 8])
        plain.step()
    plain.flush()
    assert len([f for f in plain.pop_frames() if f.crc_ok]) \
        < len(post_warm) // 2


def test_chain_engine_resumes_from_jax_front_carry(acq_run):
    """The JAX engine's FrontChainState, through utils/interop, resumes
    the port's acquiring engine exactly."""
    jst, base, blocks = acq_run["snap"]
    fr = jst.front
    state = interop.front_chain_state_from_numpy(
        {"freq": np.asarray(fr.freq), "phase": np.asarray(fr.phase),
         "agc": None},
        {f: np.asarray(getattr(jst.demod, f)) for f in jst.demod._fields},
        {f: np.asarray(getattr(jst.tail, f)) for f in jst.tail._fields},
        "cpu")
    rt = interop.front_chain_state_to_numpy(state)       # no AGC
    assert rt["front"]["agc"] is None
    np.testing.assert_array_equal(rt["tail"]["tail_re"],
                                  np.asarray(jst.tail.tail_re))
    eng = _port_engine(acq_run["jfmt"], acquire_cfo=True)
    with pytest.raises(ValueError, match="not warmed up"):
        eng.set_cfo(0.02)
    eng.restore_chain_state(state, base_symbols=base, blocks_done=blocks)
    assert _run(eng, acq_run["x"], lo=SNAP_AT) \
        == acq_run["steps"][SNAP_AT:]
    plain = _port_engine(acq_run["jfmt"])
    with pytest.raises(ValueError, match="acquire_cfo"):
        plain.restore_chain_state(state)
    with pytest.raises(ValueError, match="acquire_cfo"):
        plain.set_cfo(0.0)
    assert plain.cfo_estimates is None
    with pytest.raises(ValueError, match="ChainState"):
        eng.restore_chain_state(chain.ChainState(state.demod, state.tail))
