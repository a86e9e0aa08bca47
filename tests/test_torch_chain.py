"""Port parity, receive chain: psk_soft_tpu_torch's models/chain and
runtime/chain_engine on the CPU (every kernel's plain version) against the
JAX package (Pallas kernels with interpret=True), fed the same numpy
streams.

Held equal: found, pos, count, ok and the decoded message bits of found
rows; Frame lists (channel, start, info_bits, crc_ok) and the engine's
counters.  Held within 1e-5: the raw correlation angles of found rows.
Rows where ``found`` is False are garbage by the fixed-capacity contract
and are not compared.  Also the seam law on the port alone: every start
offset decodes exactly once, and the result does not depend on how the
stream is cut into blocks (as in tests/test_chain_seam.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models import chain as jchain
from psk_soft_tpu.models.blockpsk import demod_block_ff as jax_demod_block_ff
from psk_soft_tpu.models.blockpsk import ff_init as jax_ff_init
from psk_soft_tpu.models.full import full_from_ff as jax_full_from_ff
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.crc import CRC16_CCITT as JAX_CRC16
from psk_soft_tpu.ops.fec import CODE_K7 as JAX_K7
from psk_soft_tpu.ops.framesync import FrameFormat as JaxFrameFormat
from psk_soft_tpu.ops.framesync import psk_points
from psk_soft_tpu.runtime.chain_engine import ChainEngine as JaxChainEngine
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import chain
from psk_soft_tpu_torch.models.blockpsk import ff_init
from psk_soft_tpu_torch.models.full import full_from_ff
from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
from psk_soft_tpu_torch.ops.cuda import demod_kernel, viterbi_kernel
from psk_soft_tpu_torch.ops.fec import CODE_K7, info_bits_for
from psk_soft_tpu_torch.ops.framesync import FrameFormat
from psk_soft_tpu_torch.runtime.chain_engine import ChainEngine
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

ANG_TOL = 1e-5
C, S, SPS = 128, 256, 8
KW = dict(sps=SPS, num_avg=40, constellation_size=4, phase_avg=30)


def _port_fmt(jfmt):
    return interop.frame_format_from_jax_dict(dataclasses.asdict(jfmt))


def _soft_stream(jfmt, infos, starts, length, channels, seed, noise=0.02,
                 crc=None):
    """(C, length) soft stream with K7-coded frames at ``starts``."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(channels):
        idx = tx.frame_stream(jfmt, infos, starts, length, code=JAX_K7,
                              crc=crc, labeling="gray", seed=seed + 101 * c)
        rows.append(psk_points(idx, jfmt.m))
    soft = np.stack(rows)
    soft += noise * (rng.standard_normal(soft.shape)
                     + 1j * rng.standard_normal(soft.shape))
    return soft.astype(np.complex64)


def _port_seam_blocks(fmt, k, soft, s_block, crc=None):
    """The port's seam tail over ``soft`` cut into s_block-row blocks:
    list of ChainOutputs, one per block."""
    c, total = soft.shape
    step = chain.make_seam_tail_fn(fmt, CODE_K7, k, crc=crc)
    tail = chain.seam_tail_init(fmt, c, "cpu")
    re = torch.from_numpy(np.ascontiguousarray(soft.real.T))
    im = torch.from_numpy(np.ascontiguousarray(soft.imag.T))
    outs = []
    for b in range(total // s_block):
        rows = slice(b * s_block, (b + 1) * s_block)
        tail, out = step(tail, re[rows], im[rows])
        outs.append(out)
    return outs


def _commits(outs, s_block):
    """{channel: [(absolute start, msg bits)]} from per-block outputs."""
    got = {}
    for b, out in enumerate(outs):
        for c, j in zip(*np.nonzero(out.found.numpy())):
            got.setdefault(int(c), []).append(
                (b * s_block + int(out.pos[c, j]), out.msg[c, j].numpy()))
    return got


def _assert_outputs_equal(got, want):
    """Port ChainOutputs against JAX ChainOutputs (numpy fields)."""
    found = got.found.numpy()
    np.testing.assert_array_equal(found, np.asarray(want.found))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.msg.numpy()[found],
                                  np.asarray(want.msg)[found])
    np.testing.assert_array_equal(got.ok.numpy()[found],
                                  np.asarray(want.ok)[found])
    np.testing.assert_allclose(got.ang.numpy()[found],
                               np.asarray(want.ang)[found], atol=ANG_TOL,
                               rtol=0)


def test_seam_geometry_matches_jax():
    rng = np.random.default_rng(0)
    for sep in (None, 20, 200):
        jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 24)), payload=40,
                              m=4, min_sep=sep)
        fmt = _port_fmt(jfmt)
        assert chain._need_after(fmt) == jchain._need_after(jfmt)
        assert chain.seam_lead(fmt) == jchain.seam_lead(jfmt)
        for s_block in (48, 512):
            assert (chain.commit_bounds(fmt, s_block)
                    == jchain.commit_bounds(jfmt, s_block))
        assert (chain.chain_msg_bits(fmt, CODE_K7, CRC16_CCITT)
                == jchain.chain_msg_bits(jfmt, JAX_K7, JAX_CRC16))
    assert chain.ChainOutputs._fields == jchain.ChainOutputs._fields
    assert chain.SeamTailState._fields == jchain.SeamTailState._fields
    assert chain.ChainState._fields == jchain.ChainState._fields


def test_every_offset_decoded_exactly_once():
    """One frame at every start offset mod the block length (spacing S+1),
    each decoded exactly once at its exact position with exact bits."""
    rng = np.random.default_rng(1)
    s_block = 48
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=16, m=4,
                          threshold=0.8)
    n_msg = info_bits_for(CODE_K7, jfmt.payload * 2)
    starts = [j * (s_block + 1) for j in range(s_block)]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    total = ((starts[-1] + jfmt.frame_len) // s_block + 2) * s_block
    soft = _soft_stream(jfmt, infos, starts, total, channels=3, seed=2)
    got = _commits(_port_seam_blocks(_port_fmt(jfmt), 3, soft, s_block),
                   s_block)
    for c in range(3):
        assert [p for p, _ in got[c]] == starts, f"channel {c}"
        for (_, msg), want in zip(got[c], infos):
            np.testing.assert_array_equal(msg, want)


def test_seam_tail_matches_jax_and_is_split_invariant():
    """The same stream cut into 48- and 96-row blocks commits the same
    (position, bits) set; block by block the 48-row run equals the JAX
    seam tail (with a CRC)."""
    rng = np.random.default_rng(3)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=32,
                          m=4, threshold=0.8)
    fmt = _port_fmt(jfmt)
    n_msg = info_bits_for(CODE_K7, jfmt.payload * 2) - 16
    starts = [11, 90, 141, 200, 333, 420]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    soft = _soft_stream(jfmt, infos, starts, 576, channels=2, seed=4,
                        crc=JAX_CRC16)
    outs_a = _port_seam_blocks(fmt, 3, soft, 48, crc=CRC16_CCITT)
    outs_b = _port_seam_blocks(fmt, 5, soft, 96, crc=CRC16_CCITT)
    got_a, got_b = _commits(outs_a, 48), _commits(outs_b, 96)
    for c in range(2):
        assert ([p for p, _ in got_a[c]] == [p for p, _ in got_b[c]]
                == starts)
        for (_, ma), (_, mb), want in zip(got_a[c], got_b[c], infos):
            np.testing.assert_array_equal(ma, want)
            np.testing.assert_array_equal(mb, want)
    assert all(bool(o.ok[o.found].all()) for o in outs_a)

    jstep = jchain.make_seam_tail_fn(jfmt, JAX_K7, 3, crc=JAX_CRC16,
                                     interpret=True)
    re = np.ascontiguousarray(soft.real.T).reshape(12, 48, 2)
    im = np.ascontiguousarray(soft.imag.T).reshape(12, 48, 2)
    _, jouts = jax.jit(lambda t, r, i: jax.lax.scan(
        lambda tt, xs: jstep(tt, xs[0], xs[1]), t, (r, i)))(
            jchain.seam_tail_init(jfmt, 2), jnp.asarray(re), jnp.asarray(im))
    for b, out in enumerate(outs_a):
        _assert_outputs_equal(out, jax.tree_util.tree_map(
            lambda a, b=b: np.asarray(a)[b], jouts))


def test_overflow_count_observable():
    """k+1 frames inside one block's commit window: count reports k+1 and
    the earliest k decode."""
    rng = np.random.default_rng(5)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 16)), payload=16, m=4,
                          threshold=0.8)
    fmt = _port_fmt(jfmt)
    n_msg = info_bits_for(CODE_K7, jfmt.payload * 2)
    s_block, k = 192, 3
    lo, hi = chain.commit_bounds(fmt, s_block)
    w0 = s_block + lo - chain.seam_lead(fmt)
    starts = [w0 + 10 + j * fmt.separation for j in range(k + 1)]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    soft = _soft_stream(jfmt, infos, starts, 3 * s_block, channels=2, seed=6)
    outs = _port_seam_blocks(fmt, k, soft, s_block)
    assert (outs[1].count == k + 1).all() and outs[1].found.all()
    assert not outs[0].count.any() and not outs[2].count.any()
    got = _commits(outs, s_block)
    for c in range(2):
        assert [p for p, _ in got[c]] == starts[:k]


def _chain_input(seed):
    """Converged JAX carry and a 3-block coded stream with frames that
    straddle the input-block seams."""
    rng = np.random.default_rng(seed)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48,
                          m=4, threshold=0.7)
    n_msg = jchain.chain_msg_bits(jfmt, JAX_K7, JAX_CRC16)
    starts = [100, 230, 500]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    idx = tx.frame_stream(jfmt, infos, starts, 3 * S, code=JAX_K7,
                          crc=JAX_CRC16, labeling="gray", seed=seed + 1)
    x = np.repeat(np.exp(1j * (2 * np.pi * np.tile(idx, (C, 1)) / 4 + 0.4)),
                  SPS, axis=1).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    warm_idx = tx.frame_stream(jfmt, [], [], S, seed=seed + 2)
    warm = np.repeat(np.exp(1j * (2 * np.pi * np.tile(warm_idx, (C, 1)) / 4
                                  + 0.4)), SPS, axis=1).astype(np.complex64)
    cfg = JaxDemodConfig(**KW)
    st_ff, _ = jax.jit(jax.vmap(functools.partial(jax_demod_block_ff, cfg)))(
        jax_ff_init(cfg, (C,)), jnp.asarray(warm))
    return jfmt, x, jax_full_from_ff(cfg, st_ff)


@pytest.mark.parametrize("seam", [True, False])
def test_make_chain_fn_matches_jax_from_one_carry(seam):
    """The port's make_chain_fn (B1 and B2 plain versions) and the JAX one
    run block by block from the same converged carry, passed across
    through utils/interop."""
    jfmt, x, jfull = _chain_input(seed=7)
    fmt = _port_fmt(jfmt)
    crc = interop.crc_spec_from_jax_dict(dataclasses.asdict(JAX_CRC16))
    code = interop.conv_code_from_jax_dict(dataclasses.asdict(JAX_K7))
    demod_np = {f: np.asarray(getattr(jfull, f)) for f in jfull._fields}
    k = 2
    jstep = jax.jit(jchain.make_chain_fn(JaxDemodConfig(**KW), jfmt, JAX_K7,
                                         k, crc=JAX_CRC16, interpret=True,
                                         seam=seam))
    step = chain.make_chain_fn(DemodConfig(**KW), fmt, code, k, crc=crc,
                               seam=seam)
    if seam:
        jstate = jchain.chain_init(jfmt, C, jfull)
        tail_np = {f: np.asarray(getattr(jstate.tail, f))
                   for f in jstate.tail._fields}
        state = interop.chain_state_from_numpy(demod_np, tail_np, "cpu")
    else:
        jstate = jfull
        state = interop.full_state_from_numpy(demod_np, "cpu")
    decoded = 0
    for b in range(3 if seam else 2):
        blk = x[:, b * S * SPS:(b + 1) * S * SPS]
        re, im = (np.ascontiguousarray(blk.real.T),
                  np.ascontiguousarray(blk.imag.T))
        jstate, jout = jstep(jstate, jnp.asarray(re), jnp.asarray(im))
        state, out = step(state, torch.from_numpy(re), torch.from_numpy(im))
        _assert_outputs_equal(out, jout)
        decoded += int(out.found.sum())
        assert bool(out.ok[out.found].all())
    # seam: all three frames on every channel; one-shot: only the frames
    # wholly inside a block's demod output.
    assert decoded == (3 * C if seam else 2 * C)


# --- ChainEngine -------------------------------------------------------------

STARTS = [20] + list(range(140, 1300, 105)) + [1395, 1560]
TOTAL = 6 * S + S // 2       # 6 whole blocks and half a block


def _engine_stream():
    rng = np.random.default_rng(52)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48,
                          m=4, threshold=0.7)
    n_msg = jchain.chain_msg_bits(jfmt, JAX_K7, JAX_CRC16)
    truth, rows = {}, []
    for c in range(C):
        infos = [rng.integers(0, 2, n_msg, np.int8) for _ in STARTS]
        truth.update({(c, s0): i for s0, i in zip(STARTS, infos)})
        idx = tx.frame_stream(jfmt, infos, STARTS, TOTAL, code=JAX_K7,
                              crc=JAX_CRC16, labeling="gray", seed=c)
        rows.append(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)))
    x = np.repeat(np.stack(rows), SPS, axis=1).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return jfmt, x, truth


def _key(frames):
    return [(f.channel, f.start, f.crc_ok, tuple(f.info_bits.tolist()))
            for f in frames]


def _counters(eng):
    return (eng.frames_synced, eng.crc_failures, eng.overflow_peaks,
            eng.warmup_symbols)


def _blocks(x):
    blk = S * SPS
    return [x[:, p:p + blk] for p in range(0, x.shape[1], blk)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX ChainEngine over the stream, push_block, depth 0; the carry
    is snapshotted after the warm block and two chain blocks."""
    jfmt, x, truth = _engine_stream()
    eng = JaxChainEngine(JaxDemodConfig(**KW), C, jfmt, JAX_K7, JAX_CRC16,
                         block_symbols=S, interpret=True)
    per_step, snap = [], None
    for i, blk in enumerate(_blocks(x)):
        if i == 3:
            st = eng.chain_state
            snap = ({f: np.asarray(getattr(st.demod, f))
                     for f in st.demod._fields},
                    {f: np.asarray(getattr(st.tail, f))
                     for f in st.tail._fields}, eng._base, eng._blocks)
        eng.push_block(blk)
        per_step.append(eng.step())
    flushed = eng.flush()
    return dict(jfmt=jfmt, x=x, truth=truth, per_step=per_step,
                flushed=flushed, frames=eng.pop_frames(),
                counters=_counters(eng), snap=snap)


def _port_engine(jfmt, **kw):
    return ChainEngine(DemodConfig(**KW), C, _port_fmt(jfmt), CODE_K7,
                       CRC16_CCITT, block_symbols=S, device="cpu", **kw)


def test_chain_engine_matches_jax(jax_run):
    """Same stream, same Frame list and counters.  The frame wholly inside
    the warm-up block (start 20) is lost, as is the one in the trailing
    half block that flush() drops; the rest decode with exact bits."""
    demod_kernel.demod_full_tm.launches = 0
    viterbi_kernel.viterbi_fused.launches = 0
    eng = _port_engine(jax_run["jfmt"])
    for i, blk in enumerate(_blocks(jax_run["x"])):
        eng.push_block(blk)
        got = eng.step()
        want = jax_run["per_step"][i]
        assert (got is None) == (want is None)
        if got is not None:
            assert _key(got) == _key(want), f"step {i}"
    flushed = eng.flush()
    assert _key(flushed) == _key(jax_run["flushed"])
    frames = eng.pop_frames()
    assert _key(frames) == _key(jax_run["frames"])
    assert _counters(eng) == jax_run["counters"]
    assert demod_kernel.demod_full_tm.launches == 0     # CPU: plain
    assert viterbi_kernel.viterbi_fused.launches == 0

    truth = jax_run["truth"]
    decoded = {(f.channel, f.start) for f in frames}
    expect = {k for k in truth if k[1] not in (20, 1560)}
    assert decoded == expect
    assert {f.start for f in flushed} == {1395}       # the tail's frame
    for f in frames:
        assert f.crc_ok
        np.testing.assert_array_equal(f.info_bits, truth[(f.channel,
                                                          f.start)])
    assert eng.warmup_symbols == S and eng.overflow_peaks == 0
    assert eng.flush() == []                          # idempotent
    with pytest.raises(ValueError, match="finalized"):
        eng.push_block(jax_run["x"][:, :S * SPS])


def test_chain_engine_restored_from_jax_carry(jax_run):
    """The JAX engine's carry after three blocks, through utils/interop,
    resumes the port's engine exactly: same frames as the JAX engine
    from there on."""
    demod_np, tail_np, base, blocks = jax_run["snap"]
    eng = _port_engine(jax_run["jfmt"])
    eng.restore_chain_state(
        interop.chain_state_from_numpy(demod_np, tail_np, "cpu"),
        base_symbols=base, blocks_done=blocks)
    got = []
    for blk in _blocks(jax_run["x"])[3:]:
        eng.push_block(blk)
        got += eng.step() or []
    got += eng.flush()
    want = [f for step in jax_run["per_step"][3:] for f in (step or [])]
    assert _key(got) == _key(want + jax_run["flushed"])
    with pytest.raises(ValueError, match="tail"):
        eng.restore_chain_state(chain.ChainState(
            None, chain.seam_tail_init(eng.fmt, 64, "cpu")))


def test_chain_engine_depth_planes_and_ragged_pushes(jax_run):
    """pipeline_depth=1 with push_planes, and ragged per-channel pushes,
    commit the same frames as depth 0 with whole-block pushes."""
    x = jax_run["x"]
    want = sorted(_key(jax_run["frames"]))
    deep = _port_engine(jax_run["jfmt"], pipeline_depth=1)
    returned = []
    for blk in _blocks(x):
        deep.push_planes(np.ascontiguousarray(blk.real.T),
                         np.ascontiguousarray(blk.imag.T))
        returned.append(deep.step())
    assert returned[:2] == [[], []]         # warm block, then one in flight
    deep.flush()
    assert sorted(_key(deep.pop_frames())) == want

    ragged = _port_engine(jax_run["jfmt"])
    rng = np.random.default_rng(9)
    posn = np.zeros(C, np.int64)
    while (posn < x.shape[1]).any():
        for c in range(C):
            n = int(rng.integers(500, 4000))
            ragged.push(c, x[c, posn[c]:posn[c] + n])
            posn[c] = min(posn[c] + n, x.shape[1])
        while ragged.step() is not None:
            pass
    ragged.flush()
    assert sorted(_key(ragged.pop_frames())) == want


def test_push_to_channel_minus_one_matches_jax(jax_run):
    """push(-1, ...) aliases the last channel's staging in both packages
    (runtime/chain_engine.py's push in each): the stream's first three
    blocks pushed channel by channel, the last channel as -1, give the same
    frames in both, and the same as pushing it as channel C - 1."""
    blocks = _blocks(jax_run["x"])[:3]

    def drive(eng, last):
        frames = []
        for blk in blocks:
            for c in range(C - 1):
                eng.push(c, blk[c])
            eng.push(last, blk[C - 1])
            frames += eng.step() or []
        return frames + eng.flush()

    jeng = JaxChainEngine(JaxDemodConfig(**KW), C, jax_run["jfmt"], JAX_K7,
                          JAX_CRC16, block_symbols=S, interpret=True)
    want = _key(drive(jeng, -1))
    got = _key(drive(_port_engine(jax_run["jfmt"]), -1))
    assert got == want
    assert any(f[0] == C - 1 for f in got)
    assert got == _key(drive(_port_engine(jax_run["jfmt"]), C - 1))


def test_chain_engine_validation_and_later_steps():
    cfg = DemodConfig(**KW)
    fmt = FrameFormat(uw=(0, 1, 2, 3) * 4, payload=16, m=4)
    with pytest.raises(ValueError, match="constellation_size"):
        ChainEngine(cfg, C, FrameFormat(uw=(0, 1), payload=8, m=8),
                    CODE_K7, device="cpu")
    with pytest.raises(ValueError, match="matched_filter"):
        ChainEngine(DemodConfig(**KW, matched_filter="rrc"), C, fmt,
                    CODE_K7, device="cpu")
    with pytest.raises(ValueError, match="sync window"):
        ChainEngine(cfg, C, fmt, CODE_K7, block_symbols=30, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        ChainEngine(cfg, C, fmt, CODE_K7, pipeline_depth=2, device="cpu")
    acq = ChainEngine(cfg, C, fmt, CODE_K7, acquire_cfo=True, device="cpu")
    assert acq.acquire_cfo and acq.cfo_estimates is None     # not warm yet
    eng = ChainEngine(cfg, C, fmt, CODE_K7, block_symbols=128, device="cpu")
    assert eng.k == 128 // fmt.separation + 1
    assert eng.device == torch.device("cpu")
    assert ChainEngine(cfg, C, fmt, CODE_K7).device.type == "cuda"
    with pytest.raises(ValueError, match="acquire_cfo"):
        eng.set_cfo(0.0)
    assert eng.cfo_estimates is None
    with pytest.raises(ValueError, match="dequantized"):
        eng.push_planes(np.zeros((8, C), np.int16),
                        np.zeros((8, C), np.int16))
    with pytest.raises(ValueError, match="rows"):
        eng.push_planes(np.zeros((8, 3), np.float32),
                        np.zeros((8, 3), np.float32))
    assert eng.step() is None                       # not enough data
    eng.push(0, np.zeros(100, np.complex64))
    with pytest.raises(ValueError, match="cannot mix"):
        eng.push_planes(np.zeros((8, C), np.float32),
                        np.zeros((8, C), np.float32))
    eng.reset()
    eng.push_block(np.zeros((C, 128 * SPS), np.complex64))
    assert eng.step() == [] and eng.chain_state is not None
    eng.reset()
    assert eng.chain_state is None and not eng.frames
    # The front chain: same carry layout as JAX, runs a silent block.
    assert chain.FrontState._fields == jchain.FrontState._fields
    assert chain.FrontChainState._fields == jchain.FrontChainState._fields
    demod = full_from_ff(cfg, ff_init(cfg, C, "cpu"))
    st = chain.front_chain_init(fmt, C, demod, freq=np.full(C, 0.01))
    assert st.front.agc is None and st.front.freq.dtype == torch.float32
    z = torch.zeros((128 * SPS, C))
    st, out = chain.make_front_chain_fn(cfg, fmt, CODE_K7, 2)(st, z, z)
    assert not out.found.any() and isinstance(st, chain.FrontChainState)
