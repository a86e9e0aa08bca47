"""Port parity, checkpoint files: psk_soft_tpu_torch/utils/checkpoint reads
and writes the JAX package's .npz format, so a checkpoint written by either
package loads in the other (ROADMAP A.10).

Held equal: every leaf after JAX save -> port load and port save -> JAX
load (dtypes kept: complex split and rejoined, int32, bool, int16), the
config and ``extra``; a port continuation from a JAX checkpoint against
the JAX continuation at frame level (found, pos, msg, ok equal), and for
the exact scan's DemodState (bits and sample index equal, soft and phase
within 2e-3); the engine's save -> load -> restore_full_state continuation
bit-equal.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu import demod_init as jax_demod_init
from psk_soft_tpu import make_demod_fn as jax_make_demod_fn
from psk_soft_tpu.models import chain as jchain
from psk_soft_tpu.models.blockpsk import demod_block_ff as jax_demod_block_ff
from psk_soft_tpu.models.blockpsk import ff_init as jax_ff_init
from psk_soft_tpu.models.full import full_from_ff as jax_full_from_ff
from psk_soft_tpu.models.full import quantize_full_state
from psk_soft_tpu.models.fused import fused_init as jax_fused_init
from psk_soft_tpu.models.fused import make_fused_demod_fn as jax_fused_fn
from psk_soft_tpu.ops import tx
from psk_soft_tpu.ops.agc import AgcConfig as JaxAgcConfig
from psk_soft_tpu.ops.crc import CRC16_CCITT as JAX_CRC16
from psk_soft_tpu.ops.fec import CODE_K7 as JAX_K7
from psk_soft_tpu.ops.framesync import FrameFormat as JaxFrameFormat
from psk_soft_tpu.utils import checkpoint as jckpt
from psk_soft_tpu_torch import make_demod_fn
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import chain
from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
from psk_soft_tpu_torch.ops.fec import CODE_K7
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.utils import checkpoint, interop

torch.set_num_threads(1)

C, SPS, S = 128, 8, 256
KW = dict(sps=SPS, num_avg=40, constellation_size=4, phase_avg=30)


def _leaves(state):
    """(dotted name, numpy leaf or None) pairs of a nested state."""
    out = []
    for name, leaf in zip(type(state)._fields, state):
        if leaf is None:
            out.append((name, None))
        elif hasattr(type(leaf), "_fields"):
            out += [(f"{name}.{k}", v) for k, v in _leaves(leaf)]
        else:
            out.append((name, leaf.cpu().numpy()
                        if isinstance(leaf, torch.Tensor)
                        else np.asarray(leaf)))
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert type(a).__name__ == type(b).__name__
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_full():
    """A converged JAX FullState (warm-up through blockpsk)."""
    jcfg = JaxDemodConfig(**KW)
    rng = np.random.default_rng(15)
    x = np.exp(2j * np.pi * rng.integers(0, 4, (C, 160)) / 4)
    x = np.repeat(x, SPS, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    st_ff, _ = jax.jit(jax.vmap(functools.partial(jax_demod_block_ff, jcfg)))(
        jax_ff_init(jcfg, (C,)), jnp.asarray(x))
    return jax_full_from_ff(jcfg, st_ff), x


def _jax_state(kind):
    jcfg = JaxDemodConfig(**KW)
    full, x = _jax_full()
    fmt = JaxFrameFormat(uw=(0, 1, 2, 3) * 4, payload=16, m=4)
    freqs = np.linspace(1e-3, 2e-2, C).astype(np.float32)
    if kind == "full":
        return full
    if kind.startswith("demod"):
        bank = kind == "demod_bank"
        st, _ = jax_make_demod_fn(jcfg, C if bank else None)(
            jax_demod_init(jcfg, C if bank else None),
            jnp.asarray(x if bank else x[0]))
        return st
    if kind == "chain":
        return jchain.chain_init(fmt, C, full)
    if kind == "fused":
        st, _ = jax_fused_fn(jcfg, s_tile=160, interpret=True)(
            jax_fused_init(jcfg, C), jnp.asarray(x.real.T),
            jnp.asarray(x.imag.T))
        return st
    agc_cfg = JaxAgcConfig(alpha=0.1, chunk=8) if kind == "front_agc" \
        else None
    return jchain.front_chain_init(fmt, C, full, agc_cfg=agc_cfg, freq=freqs)


@pytest.mark.parametrize("kind", ["full", "chain", "fused", "front",
                                  "front_agc", "demod", "demod_bank"])
def test_checkpoints_cross_between_packages(kind, tmp_path):
    jst = _jax_state(kind)
    jcfg = JaxDemodConfig(**KW)
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save_state(path, jst, jcfg, extra={"blocks_done": 3})
    st, cfg, extra = checkpoint.load_state(path, "cpu")
    assert cfg == DemodConfig(**KW) and extra == {"blocks_done": 3}
    _assert_same(st, jst)
    if kind.startswith("front"):
        assert (st.front.agc is None) == (kind == "front")
    back = os.path.join(tmp_path, "port.npz")
    checkpoint.save_state(back, st, cfg, extra={"stream": "s0"})
    jst2, jcfg2, jextra = jckpt.load_state(back)
    assert jcfg2 == jcfg and jextra == {"stream": "s0"}
    _assert_same(st, jst2)
    st2, _, _ = checkpoint.load_state(back, "cpu")
    _assert_same(st, st2)


def test_port_continues_a_jax_chain_checkpoint(tmp_path):
    """A JAX seam-chain carry saved after one block resumes the port's
    chain: the frame straddling the cut decodes as in the JAX
    continuation."""
    jcfg, cfg = JaxDemodConfig(**KW), DemodConfig(**KW)
    rng = np.random.default_rng(13)
    jfmt = JaxFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=48, m=4,
                          threshold=0.7)
    fmt = interop.frame_format_from_jax_dict(dataclasses.asdict(jfmt))
    n_msg = jchain.chain_msg_bits(jfmt, JAX_K7, JAX_CRC16)
    starts = [100, 230]
    infos = [rng.integers(0, 2, n_msg, np.int8) for _ in starts]
    idx_row = tx.frame_stream(jfmt, infos, starts, 3 * S, code=JAX_K7,
                              crc=JAX_CRC16, labeling="gray", seed=14)
    x = np.repeat(np.exp(1j * (2 * np.pi * np.tile(idx_row, (C, 1)) / 4
                               + 0.4)), SPS, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    st_ff, _ = jax.jit(jax.vmap(functools.partial(jax_demod_block_ff, jcfg)))(
        jax_ff_init(jcfg, (C,)), jnp.asarray(x[:, :S * SPS]))
    jstep = jax.jit(jchain.make_chain_fn(jcfg, jfmt, JAX_K7, 2,
                                         crc=JAX_CRC16, interpret=True))
    step = chain.make_chain_fn(cfg, fmt, CODE_K7, 2, crc=CRC16_CCITT)

    def planes(b):
        blk = x[:, b * S * SPS:(b + 1) * S * SPS]
        return np.ascontiguousarray(blk.real.T), np.ascontiguousarray(
            blk.imag.T)

    jst, _ = jstep(jchain.chain_init(jfmt, C, jax_full_from_ff(jcfg, st_ff)),
                   *map(jnp.asarray, planes(0)))
    path = os.path.join(tmp_path, "chain.npz")
    jckpt.save_state(path, jst, jcfg, extra={"blocks_done": 1})
    st, _, extra = checkpoint.load_state(path, "cpu")
    assert isinstance(st, chain.ChainState) and extra["blocks_done"] == 1
    n_found = 0
    for b in (1, 2):
        re, im = planes(b)
        jst, jout = jstep(jst, jnp.asarray(re), jnp.asarray(im))
        st, out = step(st, torch.from_numpy(re), torch.from_numpy(im))
        found = out.found.numpy()
        np.testing.assert_array_equal(found, np.asarray(jout.found))
        np.testing.assert_array_equal(out.pos.numpy(), np.asarray(jout.pos))
        np.testing.assert_array_equal(out.msg.numpy()[found],
                                      np.asarray(jout.msg)[found])
        np.testing.assert_array_equal(out.ok.numpy()[found],
                                      np.asarray(jout.ok)[found])
        n_found += int(found.sum())
    assert n_found >= C        # the frame across the cut decoded on resume


def test_port_continues_a_jax_demod_state(tmp_path):
    """The exact scan's carry after 160 symbols, saved by the JAX package,
    resumes the port's scan as the JAX scan goes on (and a port-saved
    carry loads back in JAX)."""
    jcfg, cfg = JaxDemodConfig(**KW), DemodConfig(**KW)
    jst = _jax_state("demod_bank")
    path = os.path.join(tmp_path, "demod.npz")
    jckpt.save_state(path, jst, jcfg, extra={"symbols": 160})
    st, cfg_l, extra = checkpoint.load_state(path, "cpu")
    assert cfg_l == cfg and extra == {"symbols": 160}
    rng = np.random.default_rng(21)
    x = np.exp(2j * np.pi * (rng.integers(0, 4, (C, 64)) / 4 + 0.01))
    x = np.repeat(x, SPS, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    x[:, 2::SPS] *= 2                       # a decisive timing peak
    jst2, jout = jax_make_demod_fn(jcfg, C)(jst, jnp.asarray(x))
    st2, out = make_demod_fn(cfg, C)(st, x)
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    np.testing.assert_array_equal(out.sample_index.numpy(),
                                  np.asarray(jout.sample_index))
    np.testing.assert_allclose(out.soft.numpy(), np.asarray(jout.soft),
                               atol=2e-3)
    np.testing.assert_allclose(out.phase.numpy(), np.asarray(jout.phase),
                               atol=2e-3)
    back = os.path.join(tmp_path, "port.npz")
    checkpoint.save_state(back, st2, cfg)
    jst3, _, _ = jckpt.load_state(back)
    _assert_same(st2, jst3)
    np.testing.assert_array_equal(np.asarray(jst3.ring_fill),
                                  np.asarray(jst2.ring_fill))


def test_engine_save_load_restore_is_exact(tmp_path):
    """full_state -> save_state -> load_state -> restore_full_state in a
    fresh engine: the continuation is bit-equal."""
    cfg = DemodConfig(**KW)
    rng = np.random.default_rng(5)
    x = np.exp(2j * np.pi * rng.integers(0, 4, (C, 6 * 128)) / 4)
    x = np.repeat(x, SPS, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    need = 128 * SPS
    blocks = [(np.ascontiguousarray(x[:, i:i + need].real.T),
               np.ascontiguousarray(x[:, i:i + need].imag.T))
              for i in range(0, x.shape[1], need)]
    eng = FullKernelBatchEngine(cfg, C, block_symbols=128, device="cpu")
    for blk in blocks[:3]:
        eng.push_planes(*blk)
        eng.step()
    path = os.path.join(tmp_path, "eng.npz")
    checkpoint.save_state(path, eng.full_state, cfg)
    st, cfg2, _ = checkpoint.load_state(path, "cpu")
    eng2 = FullKernelBatchEngine(cfg2, C, block_symbols=128, device="cpu")
    eng2.restore_full_state(st)
    for blk in blocks[3:]:
        eng.push_planes(*blk)
        eng2.push_planes(*blk)
        a, b = eng.step(), eng2.step()
        np.testing.assert_array_equal(a.soft.numpy(), b.soft.numpy())
        np.testing.assert_array_equal(a.bits.numpy(), b.bits.numpy())


def test_pre_r5_flat_format_loads(tmp_path):
    """The flat format (``fields`` / ``complex_fields`` in the header)."""
    jst = jax_ff_init(JaxDemodConfig(**KW), (C,))
    arrays, cplx = {}, []
    for name, leaf in zip(jst._fields, jst):
        leaf = np.asarray(leaf)
        if np.iscomplexobj(leaf):
            arrays[f"{name}__re"] = leaf.real.astype(np.float32)
            arrays[f"{name}__im"] = (leaf.imag + 0.5).astype(np.float32)
            cplx.append(name)
        else:
            arrays[name] = leaf
    header = {"state_class": "FFState", "fields": list(jst._fields),
              "complex_fields": cplx, "config": dataclasses.asdict(
                  JaxDemodConfig(**KW)), "extra": {"old": True}}
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         np.uint8)
    path = os.path.join(tmp_path, "flat.npz")
    np.savez(path, **arrays)
    st, cfg, extra = checkpoint.load_state(path, "cpu")
    jst2, _, _ = jckpt.load_state(path)
    _assert_same(st, jst2)
    assert st.last_any.dtype == torch.complex64
    assert float(st.last_any[0].imag) == 0.5 and extra == {"old": True}


def test_unported_classes_raise(tmp_path):
    """The classes a port step added later cross both ways: a JAX EqState
    (complex leaves as __re/__im) loads with its leaves, dtypes and layout
    kept, a port EqState saved mid-adaptation loads in JAX, and
    utils/interop carries it without a file; a JAX ViterbiStreamState loads
    with its leaves, dtypes and layout kept; a JAX int16-window FullState
    loads as int16 and restores into an int16-ingest engine, whose carry
    then equals the JAX one (an engine without ingest_scale refuses it).
    An unknown class still raises."""
    from psk_soft_tpu.ops.equalizer import EqConfig, eq_block, eq_init
    from psk_soft_tpu.ops.fec import viterbi_stream_init
    from psk_soft_tpu_torch.ops import equalizer as teq

    jcfg = JaxDemodConfig(**KW)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 64)) + 1j * rng.standard_normal((2, 64))
         ).astype(np.complex64)
    jst, _, _ = eq_block(EqConfig(taps=5), eq_init(EqConfig(taps=5), (2,)),
                         x)
    path = os.path.join(tmp_path, "EqState.npz")
    jckpt.save_state(path, jst, jcfg, extra={"updates": 1})
    st, cfg, extra = checkpoint.load_state(path, "cpu")
    assert isinstance(st, teq.EqState) and st.w.dtype == torch.complex64
    assert cfg == DemodConfig(**KW) and extra == {"updates": 1}
    _assert_same(st, jst)
    tst, _, _ = teq.eq_block(teq.EqConfig(taps=5), st, torch.from_numpy(x))
    path = os.path.join(tmp_path, "EqState_port.npz")
    checkpoint.save_state(path, tst, DemodConfig(**KW))
    jback, _, _ = jckpt.load_state(path)
    _assert_same(tst, jback)
    arrays = interop.eq_state_to_numpy(tst)
    assert set(arrays) == {"w", "hist"}
    _assert_same(interop.eq_state_from_numpy(arrays, "cpu"), jback)
    np.savez(os.path.join(tmp_path, "unknown.npz"), __header__=np.frombuffer(
        json.dumps({"state_class": "NoSuchState", "fields": [],
                    "complex_fields": [], "config": dataclasses.asdict(
                        jcfg), "extra": {}}).encode(), np.uint8))
    with pytest.raises(ValueError, match="unknown state class"):
        checkpoint.load_state(os.path.join(tmp_path, "unknown.npz"), "cpu")
    jvs = viterbi_stream_init(JAX_K7, 2, 40, known_start=False)
    path = os.path.join(tmp_path, "ViterbiStreamState.npz")
    jckpt.save_state(path, jvs, jcfg)
    vs, _, _ = checkpoint.load_state(path, "cpu")
    assert type(vs).__name__ == "ViterbiStreamState"
    assert vs.pm.dtype == torch.float32 and vs.dec.dtype == torch.bool
    _assert_same(vs, jvs)
    full, _ = _jax_full()
    path = os.path.join(tmp_path, "i16.npz")
    jq = quantize_full_state(full, 1e-4)
    jckpt.save_state(path, jq, jcfg)
    st, cfg, _ = checkpoint.load_state(path, "cpu")
    assert st.win_re.dtype == torch.int16
    eng = FullKernelBatchEngine(cfg, C, device="cpu")
    with pytest.raises(ValueError, match="ingest_scale"):
        eng.restore_full_state(st)
    wire = FullKernelBatchEngine(cfg, C, ingest_scale=1e-4, device="cpu")
    wire.restore_full_state(st)
    assert wire.steady
    for f in st._fields:
        np.testing.assert_array_equal(getattr(wire.full_state, f).numpy(),
                                      np.asarray(getattr(jq, f)))
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"                       # an .npz archive
