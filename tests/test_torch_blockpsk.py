"""Port parity, feed-forward pipeline: psk_soft_tpu_torch/models/blockpsk
(and models/common) against the JAX blockpsk, vmapped over channels, on the
same numpy inputs; plus the six golden scenarios through the port alone.

Bits, validity and sample indices must be equal; soft and phase agree
within 1e-4 (float32, another summation order; phases reach a few tens of
radians).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models.blockpsk import ff_init as jax_ff_init
from psk_soft_tpu.models.blockpsk import make_ff_demod_fn
from psk_soft_tpu.testing.signals import gen_psk
from psk_soft_tpu.utils.transfer import to_host
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models import blockpsk
from psk_soft_tpu_torch.utils import interop

torch.set_num_threads(1)

TOL = 1e-4
C, NS = 128, 768


def _channels(m=4, diff=False, sps=8):
    """tests/test_full_kernel.py's fixture: a PSK impulse at sample 2 of
    every symbol, a small frequency offset, real noise; seed = channel."""
    out = []
    for i in range(C):
        rng = np.random.default_rng(i)
        j = rng.integers(0, m, NS)
        pts = np.exp(2j * np.pi * j / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(NS * sps, np.complex64)
        x[2::sps] = pts * np.exp(2j * np.pi * 2e-4 * sps * np.arange(NS))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _configs(**kw):
    return DemodConfig(**kw), JaxDemodConfig(**kw)


def _assert_outputs(got, ref, nb):
    ref = to_host(ref)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.sample_index.numpy(),
                                  np.asarray(ref.sample_index))
    np.testing.assert_array_equal(got.bits.numpy()[..., :nb],
                                  np.asarray(ref.bits)[..., :nb])
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(ref.phase),
                               atol=TOL)
    np.testing.assert_allclose(got.soft.numpy(), np.asarray(ref.soft),
                               atol=TOL)


def _assert_states(got, ref):
    ref = interop.ff_state_from_numpy(
        {k: np.asarray(v) for k, v in to_host(ref)._asdict().items()}, "cpu")
    for f in got._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, err_msg=f)


def test_ff_init_matches_jax():
    cfg, jcfg = _configs(sps=8, num_avg=50, phase_avg=20,
                         matched_filter="rrc")
    _assert_states(blockpsk.ff_init(cfg, 4, "cpu"), jax_ff_init(jcfg, (4,)))


@pytest.mark.parametrize("m,diff", [(4, False), (2, False), (8, False),
                                    (4, True)])
def test_ff_blocks_match_jax(m, diff):
    """Warm-up (valid prefix, growing fit window) through steady state,
    block by block, carries compared at the end."""
    cfg, jcfg = _configs(sps=8, num_avg=50, constellation_size=m,
                         phase_avg=20, differential=diff)
    xs = _channels(m, diff)
    fn = make_ff_demod_fn(jcfg, channels=C)
    jst = jax_ff_init(jcfg, (C,))
    st = blockpsk.ff_init(cfg, C, "cpu")
    for blk in np.split(xs, [32 * 8, 64 * 8, 256 * 8], axis=1):
        jst, jout = fn(jst, jnp.asarray(blk))
        st, out = blockpsk.demod_block_ff(cfg, st, torch.from_numpy(blk))
        _assert_outputs(out, jout, cfg.bits_per_symbol)
    _assert_states(st, jst)


def test_ff_assume_steady_matches_jax():
    cfg, jcfg = _configs(sps=8, num_avg=50, constellation_size=4,
                         phase_avg=20)
    xs = _channels()
    warm, run = np.split(xs, [256 * 8], axis=1)
    jst, _ = make_ff_demod_fn(jcfg, channels=C)(jax_ff_init(jcfg, (C,)),
                                                jnp.asarray(warm))
    st = interop.ff_state_from_numpy(
        {k: np.asarray(v) for k, v in to_host(jst)._asdict().items()}, "cpu")
    jst2, jout = make_ff_demod_fn(jcfg, channels=C, assume_steady=True)(
        jst, jnp.asarray(run))
    st2, out = blockpsk.demod_block_ff(cfg, st, torch.from_numpy(run),
                                       assume_steady=True)
    _assert_outputs(out, jout, cfg.bits_per_symbol)
    _assert_states(st2, jst2)


def test_ff_matched_filter_matches_jax():
    cfg, jcfg = _configs(sps=8, num_avg=20, constellation_size=4,
                         phase_avg=20, matched_filter="rrc", rrc_span=4)
    xs = _channels()[:16]
    fn = make_ff_demod_fn(jcfg, channels=16)
    jst = jax_ff_init(jcfg, (16,))
    st = blockpsk.ff_init(cfg, 16, "cpu")
    for blk in np.split(xs, 2, axis=1):
        jst, jout = fn(jst, jnp.asarray(blk))
        st, out = blockpsk.demod_block_ff(cfg, st, torch.from_numpy(blk))
        _assert_outputs(out, jout, cfg.bits_per_symbol)
    _assert_states(st, jst)


def test_ff_sps1_passthrough_matches_jax():
    cfg, jcfg = _configs(sps=1, num_avg=10, constellation_size=4,
                         phase_avg=20)
    x, _ = gen_psk(300, 1, 4)
    jst, jout = make_ff_demod_fn(jcfg)(jax_ff_init(jcfg), jnp.asarray(x))
    st, out = blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, 1, "cpu"),
                                      torch.from_numpy(x[None]))
    jout = to_host(jout)
    np.testing.assert_array_equal(out.bits.numpy()[0], np.asarray(jout.bits))
    np.testing.assert_allclose(out.soft.numpy()[0], np.asarray(jout.soft),
                               atol=TOL)


def test_ff_rejects_ragged_block():
    cfg = DemodConfig(sps=8)
    with pytest.raises(ValueError, match="multiple of sps"):
        blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, 1, "cpu"),
                                torch.zeros((1, 12), dtype=torch.complex64))


def _golden(m, differential):
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=m, phase_avg=50,
                      differential=differential)
    x, syms = gen_psk(1000, 8, m, differential=differential)
    _, out = blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, 1, "cpu"),
                                     torch.from_numpy(x[None]))
    valid = out.valid.numpy()[0]
    return out.soft.numpy()[0][valid], syms


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("differential", [False, True])
def test_golden_scenarios(m, differential):
    """tests/test_golden.py's six reference scenarios, through the port:
    901 outputs, soft within 1e-3 of the transmitted points (modulo the M
    legal rotations when not differential; first symbol excluded)."""
    soft, syms = _golden(m, differential)
    assert soft.shape[0] == 1000 - 99
    expected = syms[:soft.shape[0]].astype(np.complex64)
    if differential:
        if m == 4:
            expected = expected * np.exp(1j * np.pi / 4).astype(np.complex64)
        err = np.abs(soft[1:] - expected[1:]).max()
    else:
        thetas = {2: [0, np.pi],
                  4: [np.pi / 4 + k * np.pi / 2 for k in range(4)],
                  8: [k * np.pi / 4 for k in range(8)]}[m]
        err = min(np.abs(soft[1:] * np.exp(1j * th) - expected[1:]).max()
                  for th in thetas)
    assert err < 1e-3, err


def test_interop_round_trip():
    cfg = DemodConfig(sps=8, num_avg=20, phase_avg=20)
    st = blockpsk.ff_init(cfg, 3, "cpu")
    back = interop.ff_state_from_numpy(interop.ff_state_to_numpy(st), "cpu")
    for f in st._fields:
        assert torch.equal(getattr(st, f), getattr(back, f))
    assert interop.config_from_jax_dict(
        dataclasses.asdict(JaxDemodConfig(sps=4))) == DemodConfig(sps=4)
    with pytest.raises(ValueError, match="missing"):
        interop.ff_state_from_numpy({"seen": np.zeros(3)}, "cpu")
