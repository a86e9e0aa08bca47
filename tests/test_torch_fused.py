"""Port parity, fused pipeline: psk_soft_tpu_torch's kernel B5 plain version
and models/fused on the CPU against the JAX package (the Pallas timing
frontend with interpret=True, the fused pipeline and the feed-forward
blockpsk pipeline), fed the same numpy inputs.

Bounds: the frontend's sample index equal and its decision samples within
1e-5 (tests/test_fused.py:33-52); the fused outputs against blockpsk with
that file's bounds: validity, bits and sample index equal, soft within
2e-4, phase within 1e-3 (tests/test_fused.py:55-75).  Against the JAX fused
pipeline the same stage order runs on both sides, so the same bounds hold.
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
from psk_soft_tpu.models.fused import fused_init as jax_fused_init
from psk_soft_tpu.models.fused import make_fused_demod_fn as jax_fused_fn
from psk_soft_tpu.ops.pallas.frontend import \
    timing_frontend_tm as jax_frontend
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import full
from psk_soft_tpu_torch.models.fused import (FusedState, fused_init,
                                             make_fused_demod_fn)
from psk_soft_tpu_torch.ops.cuda import frontend_kernel
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

C, NS = 128, 512
SOFT_TOL, PHASE_TOL = 2e-4, 1e-3


def _channels(cfg, m=4, diff=False):
    """tests/test_fused.py's fixture: (C, T) complex64."""
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, m, NS)
        pts = np.exp(2j * np.pi * j / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(NS * cfg.sps, np.complex64)
        x[2::cfg.sps] = pts * np.exp(2j * np.pi * 1e-4 * cfg.sps
                                     * np.arange(NS))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _planes(xs):
    """Time-major float32 planes of a (C, T) complex block, as tensors."""
    return (torch.from_numpy(np.ascontiguousarray(xs.real.T)),
            torch.from_numpy(np.ascontiguousarray(xs.imag.T)))


def _cfgs(**kw):
    return JaxDemodConfig(**kw), DemodConfig(**kw)


def test_frontend_plain_matches_pallas():
    sps, num_avg, s = 8, 20, 256
    rng = np.random.default_rng(0)
    cat = (rng.standard_normal(((s + num_avg - 1) * sps, C))
           + 1j * rng.standard_normal(((s + num_avg - 1) * sps, C))
           ).astype(np.complex64)
    j_re, j_im, j_idx = jax_frontend(
        jnp.asarray(cat.real), jnp.asarray(cat.imag), sps=sps,
        num_avg=num_avg, s_tile=64, interpret=True)
    w = (num_avg - 1) * sps
    re = torch.from_numpy(np.ascontiguousarray(cat.real))
    im = torch.from_numpy(np.ascontiguousarray(cat.imag))
    frontend_kernel.timing_frontend_tm.launches = 0
    sel_re, sel_im, idx = frontend_kernel.timing_frontend_tm(
        re[:w], im[:w], re[w:], im[w:], sps=sps, num_avg=num_avg)
    assert frontend_kernel.timing_frontend_tm.launches == 0   # CPU: plain
    assert idx.dtype == torch.int32 and sel_re.shape == (s, C)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(sel_re.numpy(), np.asarray(j_re), atol=1e-5)
    np.testing.assert_allclose(sel_im.numpy(), np.asarray(j_im), atol=1e-5)


def test_frontend_plain_matches_pallas_on_poisoned_channels():
    """A NaN at channel 11's block symbol 100 and +inf at channel 23's
    symbol 40 (chip_smoke.py phase 3's poison case, scaled to 256
    symbols): the plain version picks as the Pallas kernel does over the
    whole block (s_tile = S), where each window sum is a cumsum difference
    from the start of [window | block] -- sample index equal, decision
    samples equal where finite and non-finite where the kernel's are.  With
    s_tile 64 the Pallas kernel restarts its cumsum at each tile and picks
    otherwise on those two channels (ROADMAP C)."""
    sps, num_avg, s = 8, 20, 256
    w = (num_avg - 1) * sps
    rng = np.random.default_rng(4)
    cat = np.zeros(((s + num_avg - 1) * sps, C), np.complex64)
    cat[2::sps] = np.exp(2j * np.pi * rng.integers(0, 4, cat[2::sps].shape)
                         / 4)
    cat += (0.01 * rng.standard_normal(cat.shape)).astype(np.complex64)
    cat.real[w + 100 * sps + 5, 11] = np.nan
    cat.imag[w + 40 * sps + 3, 23] = np.inf
    re = torch.from_numpy(np.ascontiguousarray(cat.real))
    im = torch.from_numpy(np.ascontiguousarray(cat.imag))
    sel_re, sel_im, idx = frontend_kernel.timing_frontend_tm(
        re[:w], im[:w], re[w:], im[w:], sps=sps, num_avg=num_avg)
    j_re, j_im, j_idx = (np.asarray(a) for a in jax_frontend(
        jnp.asarray(cat.real), jnp.asarray(cat.imag), sps=sps,
        num_avg=num_avg, s_tile=s, interpret=True))
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_equal(sel_re.numpy(), j_re)   # NaN where NaN
    np.testing.assert_array_equal(sel_im.numpy(), j_im)
    bad = np.flatnonzero(~np.isfinite(sel_re.numpy() + sel_im.numpy())
                         .all(axis=0))
    assert bad.tolist() == [11, 23]
    # From the first output whose window reaches the sample (its block
    # symbol: the window is num_avg - 1 symbols ahead), on to the end of
    # the block, the poisoned bin is the pick (first NaN; inf, then NaN).
    assert (idx[100:, 11] == 5).all() and (idx[:100, 11] == 2).all()
    assert (idx[40:, 23] == 3).all()
    t_idx = np.asarray(jax_frontend(jnp.asarray(cat.real),
                                    jnp.asarray(cat.imag), sps=sps,
                                    num_avg=num_avg, s_tile=64,
                                    interpret=True)[2])
    differ = np.flatnonzero((t_idx != j_idx).any(axis=0))
    assert differ.tolist() == [11, 23]


def test_frontend_args_and_empty_window():
    """num_avg 1 (an empty window) and the argument checks."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((64, C)).astype(np.float32))
    empty = torch.zeros((0, C))
    sel_re, _, idx = frontend_kernel.timing_frontend_tm(
        empty, empty, x, x.flip(0), sps=8, num_avg=1)
    e = (x * x + x.flip(0) ** 2).reshape(8, 8, C)
    np.testing.assert_array_equal(idx.numpy(), e.argmax(1).numpy())
    with pytest.raises(ValueError, match="win planes"):
        frontend_kernel.timing_frontend_tm(empty, empty, x, x, sps=8,
                                           num_avg=3)
    with pytest.raises(ValueError, match="S\\*sps"):
        frontend_kernel.timing_frontend_tm(empty, empty, x[:60], x[:60],
                                           sps=8, num_avg=1)
    assert tuple(frontend_kernel.timing_plan(1024, 8)) == (
        8, 64, 16, 172032, 128, 512)
    assert tuple(frontend_kernel.timing_plan(128, 8))[:3] == (8, 64, 16)
    assert frontend_kernel.timing_plan(1, 2000)[:3] == (1, 1, 4)  # wide sps


@pytest.mark.parametrize("m,diff", [(4, False), (2, False), (8, False),
                                    (4, True)])
def test_fused_matches_jax_fused_and_blockpsk(m, diff):
    jcfg, cfg = _cfgs(sps=8, num_avg=50, constellation_size=m, phase_avg=20,
                      differential=diff)
    xs = _channels(cfg, m=m, diff=diff)
    _, out_ff = make_ff_demod_fn(jcfg, channels=C)(jax_ff_init(jcfg, (C,)),
                                                   jnp.asarray(xs))
    _, out_ju = jax_fused_fn(jcfg, s_tile=128, interpret=True)(
        jax_fused_init(jcfg, C), jnp.asarray(xs.real.T),
        jnp.asarray(xs.imag.T))
    st, out = make_fused_demod_fn(cfg)(fused_init(cfg, C, "cpu"),
                                       *_planes(xs))
    v = out.valid.numpy()
    for ref in (out_ff, out_ju):
        rv = np.asarray(ref.valid)
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(out.sample_index.numpy()[v],
                                      np.asarray(ref.sample_index)[rv])
        np.testing.assert_array_equal(out.bits.numpy()[v],
                                      np.asarray(ref.bits)[rv])
        np.testing.assert_allclose(out.soft.numpy()[v],
                                   np.asarray(ref.soft)[rv], atol=SOFT_TOL)
        np.testing.assert_allclose(out.phase.numpy()[v],
                                   np.asarray(ref.phase)[rv], atol=PHASE_TOL)
    assert int(st.seen) == cfg.num_avg
    assert not out.soft.numpy()[~v].any()           # masked warm-up rows


def test_fused_multiblock_carry_and_jax_state():
    """Two blocks equal one shot; the carry after each block equals the
    JAX fused pipeline's, and the window carry is a view of the block."""
    jcfg, cfg = _cfgs(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels(cfg)
    fn = make_fused_demod_fn(cfg)
    jfn = jax_fused_fn(jcfg, s_tile=128, interpret=True)
    st, jst = fused_init(cfg, C, "cpu"), jax_fused_init(jcfg, C)
    parts = []
    for blk in np.split(xs, 2, axis=1):
        re, im = _planes(blk)
        st, out = fn(st, re, im)
        jst, _ = jfn(jst, jnp.asarray(blk.real.T), jnp.asarray(blk.imag.T))
        assert st.win_re.data_ptr() == re[re.shape[0] - st.win_re.shape[0]:]\
            .data_ptr()
        parts.append(out)
        for f in FusedState._fields:
            np.testing.assert_allclose(
                getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                atol=1e-4, err_msg=f)
    soft = np.concatenate([o.soft.numpy()[o.valid.numpy()].reshape(C, -1)
                           for o in parts], axis=1)
    _, one = fn(fused_init(cfg, C, "cpu"), *_planes(xs))
    soft1 = one.soft.numpy()[one.valid.numpy()].reshape(C, -1)
    np.testing.assert_allclose(soft, soft1, atol=SOFT_TOL)


def test_fused_steady_matches_flex_and_hands_off_to_b1():
    """assume_steady gives the flexible path's outputs on a converged
    carry; the carry hands off to kernel B1 (full_from_ff of a FusedState)
    exactly as the JAX package hands it off."""
    jcfg, cfg = _cfgs(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _channels(cfg)
    a, b = np.split(xs, 2, axis=1)
    fn = make_fused_demod_fn(cfg)
    steady = make_fused_demod_fn(cfg, assume_steady=True)
    st, _ = fn(fused_init(cfg, C, "cpu"), *_planes(a))
    st1, o1 = fn(st, *_planes(b))
    st2, o2 = steady(st, *_planes(b))
    assert o1.valid.all()
    np.testing.assert_allclose(o2.soft.numpy(), o1.soft.numpy(), atol=1e-6)
    np.testing.assert_array_equal(o2.bits.numpy(), o1.bits.numpy())
    np.testing.assert_allclose(o2.phase.numpy(), o1.phase.numpy(),
                               atol=1e-5)
    for x1, x2 in zip(st1, st2):
        np.testing.assert_allclose(torch.real(x1).numpy(),
                                   torch.real(x2).numpy(), atol=1e-5)
    jfs = jfull.full_from_ff(jcfg,
                             _jax_fused(interop.fused_state_to_numpy(st)))
    fs = full.full_from_ff(cfg, st)
    for f in full.FullState._fields:
        np.testing.assert_allclose(getattr(fs, f).numpy(),
                                   np.asarray(getattr(jfs, f)), atol=1e-6,
                                   err_msg=f)


def _jax_fused(arrays):
    from psk_soft_tpu.models.fused import FusedState as JaxFusedState

    return JaxFusedState(**{f: jnp.asarray(arrays[f])
                            for f in JaxFusedState._fields})


def test_fused_guards():
    cfg = DemodConfig(sps=1, num_avg=10, constellation_size=4, phase_avg=5)
    z = torch.zeros((64, C))
    with pytest.raises(ValueError, match="sps > 1"):
        make_fused_demod_fn(cfg)(fused_init(cfg, C, "cpu"), z, z)
    cfg2 = dataclasses.replace(cfg, sps=8, matched_filter="boxcar")
    with pytest.raises(ValueError, match="matched filter"):
        make_fused_demod_fn(cfg2)(fused_init(cfg2, C, "cpu"), z[:80],
                                  z[:80])
    cfg3 = dataclasses.replace(cfg, sps=8)
    with pytest.raises(ValueError, match="multiple of sps"):
        make_fused_demod_fn(cfg3)(fused_init(cfg3, C, "cpu"), z[:60], z[:60])
    z100 = torch.zeros((64, 100))
    with pytest.raises(ValueError, match="multiple of 128"):
        make_fused_demod_fn(cfg3)(fused_init(cfg3, 100, "cpu"), z100, z100)
