"""Port parity, the sharded flagship: psk_soft_tpu_torch/parallel/
sharded_full (kernel B1 per shard; its plain version on CPU shards)
against the JAX package on the same numpy samples, JAX's B1 in interpret
mode on its 8 virtual CPU devices (tests/test_sharded_full.py and
tests/test_time_sharded_full.py's cases).

Tolerances:
- channel-sharded: equal to the port's single-device steady state as
  tests/test_sharded_full.py holds JAX's (soft within 1e-5, bits and
  sample index equal; int8 soft within half a step); from JAX's warm-up
  carry, against JAX's sharded function at B1's port bounds
  (tests/test_torch_full.py: bits and sample index equal, soft 3e-3,
  phase 2e-3).  Any channel count a
  shard runs (B1 has no lane width; JAX's Pallas kernel wants 128).
- time-sharded: against JAX's single-device feed-forward (or mixed)
  reference as tests/test_time_sharded_full.py does: valid masks equal,
  sample index equal on valid, soft after removing the best M-fold
  rotation within 5e-3 (the port's B1 re-wraps the phase once a block, the
  Pallas kernel once a tile, so phase origins differ by turns of M*2pi),
  bits that re-derive from the soft values; against JAX's own
  time-sharded function on the (2, 4) QPSK and the mixed case the same
  way.  int16 planes equal the float32 run on the dequantized samples
  (soft within 1e-5), int8 soft within half a step of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.models import blockpsk as jblockpsk, full as jfull
from psk_soft_tpu.models.mixed import MixedParams as JaxMixedParams
from psk_soft_tpu.models.mixed import make_mixed_demod_fn as jax_mixed_fn
from psk_soft_tpu.models.mixed import mixed_init as jax_mixed_init
from psk_soft_tpu.parallel import sharded_full as jsf
from psk_soft_tpu.parallel.mesh import make_mesh as jax_make_mesh
from psk_soft_tpu.testing.signals import gen_psk_channel
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.models.blockpsk import ff_init, make_ff_demod_fn
from psk_soft_tpu_torch.models.full import (FullState, full_from_ff,
                                           make_full_demod_fn)
from psk_soft_tpu_torch.models.mixed import MixedParams
from psk_soft_tpu_torch.ops import slicers
from psk_soft_tpu_torch.parallel.mesh import Sharded, make_mesh, unshard
from psk_soft_tpu_torch.parallel.sharded_full import (
    make_sharded_full_demod, make_time_sharded_full_demod, shard_full_state)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
SOFT_TOL, PHASE_TOL = 3e-3, 2e-3      # B1's port bounds
ROT_TOL = 5e-3                        # tests/test_time_sharded_full.py


def _jcfg(cfg):
    return JaxDemodConfig(**cfg.__dict__)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- channel-sharded ---------------------------------------------------------

def _bank(c, ns=512, seed0=0):
    return np.stack([gen_psk_channel(ns, sps=8, m=4, seed=seed0 + i,
                                     snr_db=25, freq_offset=1e-4)[0]
                     for i in range(c)])


def _decisive(c, ns, m=4, diff=False):
    """tests/test_time_sharded_full.py's timing-decisive channels: energy
    on intra-symbol index 3, a frequency offset, noise."""
    out = []
    for i in range(c):
        rng = np.random.default_rng(i)
        pts = np.exp(2j * np.pi * rng.integers(0, m, ns) / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(ns * 8, np.complex64)
        x[3::8] = pts * np.exp(2j * np.pi * 1e-4 * 8 * np.arange(ns))
        x += (0.01 * rng.standard_normal(x.size)).astype(np.complex64)
        out.append(x)
    return np.stack(out)


def _steady(cfg, xs):
    """Port warm-up over the first 256 symbols: (FullState, run planes)."""
    warm, run = np.split(xs, [256 * 8], axis=1)
    c = xs.shape[0]
    st_ff, _ = make_ff_demod_fn(cfg, channels=c)(ff_init(cfg, c, "cpu"),
                                                 _t(warm))
    return full_from_ff(cfg, st_ff), _t(run.real.T), _t(run.imag.T)


def test_sharded_full_matches_single_device_and_jax():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _bank(256)
    st, x_re, x_im = _steady(cfg, xs)
    _, out1 = make_full_demod_fn(cfg)(st, x_re, x_im)
    mesh = make_mesh(chan=2, time=1, devices=CPU8)
    st2, out2 = make_sharded_full_demod(cfg, mesh)(
        shard_full_state(st, mesh), x_re, x_im)
    assert isinstance(out2.soft_re, Sharded)
    got = {k: unshard(v) for k, v in out2._asdict().items()}
    np.testing.assert_allclose(got["soft_re"], out1.soft_re, atol=1e-5)
    np.testing.assert_array_equal(got["bits_packed"], out1.bits_packed)
    np.testing.assert_array_equal(got["sample_index"], out1.sample_index)
    assert torch.equal(unshard(st2.planes), make_full_demod_fn(cfg)(
        st, x_re, x_im)[0].planes)

    # JAX's channel-sharded function and the port's from JAX's warm-up
    # carry (the Pallas layout, shared), on timing-decisive pulses (the
    # rectangular ones above tie, and the two packages break ties apart).
    jcfg = _jcfg(cfg)
    warm, run = np.split(_decisive(256, 512), [256 * 8], axis=1)
    x_re, x_im = _t(run.real.T), _t(run.imag.T)
    jst_ff, _ = jblockpsk.make_ff_demod_fn(jcfg, channels=256)(
        jblockpsk.ff_init(jcfg, (256,)), jnp.asarray(warm))
    jst = jfull.full_from_ff(jcfg, jst_ff)
    jmesh = jax_make_mesh(chan=2, time=1)
    sh = jsf.channel_sharding_tm(jmesh)
    _, ref = jsf.make_sharded_full_demod(jcfg, jmesh, s_tile=128,
                                         interpret=True)(
        jsf.shard_full_state(jst, jmesh),
        jax.device_put(jnp.asarray(np.ascontiguousarray(run.real.T)), sh),
        jax.device_put(jnp.asarray(np.ascontiguousarray(run.imag.T)), sh))
    _, out3 = make_sharded_full_demod(cfg, mesh)(
        FullState(*(_t(np.array(v)) for v in jst)), x_re, x_im)
    np.testing.assert_array_equal(out3.bits_packed,
                                  np.asarray(ref.bits_packed))
    np.testing.assert_array_equal(out3.sample_index,
                                  np.asarray(ref.sample_index))
    np.testing.assert_allclose(out3.soft_re, np.asarray(ref.soft_re),
                               atol=SOFT_TOL)
    np.testing.assert_allclose(out3.phase, np.asarray(ref.phase),
                               atol=PHASE_TOL)


def test_sharded_full_output_profiles():
    """int8 soft / debug ports off / packed outputs shard over the chan
    axis unchanged (the axis is communication-free)."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    st, x_re, x_im = _steady(cfg, _bank(256))
    _, out1 = make_full_demod_fn(cfg)(st, x_re, x_im)
    mesh = make_mesh(chan=2, time=1, devices=CPU8)
    _, out2 = make_sharded_full_demod(cfg, mesh, soft_i8_scale=100.0,
                                      debug_ports=False)(st, x_re, x_im)
    assert out2.phase is None and out2.sample_index is None
    assert out2.soft_re.dtype == torch.int8
    assert torch.equal(out2.bits_packed, out1.bits_packed)
    d = (out2.soft_re.float() / 100.0 - out1.soft_re).abs()
    assert float(d.max()) <= 0.5 / 100.0 + 1e-6


def test_sharded_full_takes_any_channel_count():
    """The port's channel contract: a shard holds any number of channels
    (here 3 shards of 40), each equal to the single-device run."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    st, x_re, x_im = _steady(cfg, _bank(120, seed0=40))
    _, out1 = make_full_demod_fn(cfg)(st, x_re, x_im)
    _, out2 = make_sharded_full_demod(
        cfg, make_mesh(chan=3, time=1, devices=CPU8))(st, x_re, x_im)
    assert torch.equal(out2.bits_packed, out1.bits_packed)
    assert torch.equal(out2.sample_index, out1.sample_index)
    assert float((out2.soft_re - out1.soft_re).abs().max()) < 1e-5


# --- time-sharded ------------------------------------------------------------

C, NS = 256, 2048


def _signals(m=4, diff=False):
    return _decisive(C, NS, m, diff)


def _run_port(cfg, xs, meshdims, ns, **kw):
    chan, time = meshdims
    run = make_time_sharded_full_demod(
        cfg, make_mesh(chan=chan, time=time, devices=CPU8), ns, **kw)
    outs = run(_t(xs.real.T), _t(xs.imag.T))
    return [o.numpy() for o in outs]


def _run_jax(cfg, xs, meshdims, ns, mixed_params=None):
    chan, time = meshdims
    mesh = jax_make_mesh(chan=chan, time=time)
    run = jsf.make_time_sharded_full_demod(_jcfg(cfg), mesh, ns, s_tile=128,
                                           mixed_params=mixed_params,
                                           interpret=True)
    sh = NamedSharding(mesh, JP("time", "chan"))
    outs = run(jax.device_put(jnp.asarray(np.ascontiguousarray(xs.real.T)),
                              sh),
               jax.device_put(jnp.asarray(np.ascontiguousarray(xs.imag.T)),
                              sh))
    return [np.asarray(o) for o in outs]


def _ff_reference(cfg, xs, ns, c):
    """JAX's single-device feed-forward over the whole stream, re-indexed so
    column s is stream symbol s (ff output o is stream symbol o-(numAvg-1))."""
    jcfg = _jcfg(cfg)
    _, out = jblockpsk.make_ff_demod_fn(jcfg, channels=c)(
        jblockpsk.ff_init(jcfg, (c,)), jnp.asarray(xs))
    a1 = cfg.num_avg - 1
    soft = np.zeros((c, ns), np.complex64)
    idx = np.zeros((c, ns), np.float32)
    soft[:, : ns - a1] = np.asarray(out.soft)[:, a1:]
    idx[:, : ns - a1] = np.asarray(out.sample_index)[:, a1:]
    return soft, idx


def _check_rotated(outs, soft_ref, idx_ref, m, valid_ref=None,
                   idx_atol=0.0):
    """tests/test_time_sharded_full.py:80-99: sample index on valid, soft
    after the best M-fold rotation, bits re-derived from soft."""
    soft_re, soft_im, _, packed, idx, valid = outs
    soft = (soft_re + 1j * soft_im).T
    valid = valid.T
    assert valid.any() and (~valid).any()
    if valid_ref is not None:
        np.testing.assert_array_equal(valid, valid_ref)
    np.testing.assert_allclose(idx.T[valid], idx_ref[valid], atol=idx_atol)
    errs = [np.abs(soft[valid] * np.exp(2j * np.pi * r / m)
                   - soft_ref[valid]).max() for r in range(m)]
    assert min(errs) < ROT_TOL, min(errs)
    re_sliced = slicers.slice_bits(m, torch.from_numpy(soft[valid])).numpy()
    vals = re_sliced[:, 0] + 2 * re_sliced[:, 1] + 4 * re_sliced[:, 2]
    np.testing.assert_array_equal(packed.T[valid], vals)


@pytest.mark.parametrize("m,diff,meshdims", [(4, False, (2, 4)),
                                             (4, False, (1, 8)),
                                             (8, False, (2, 2)),
                                             (4, True, (2, 4))])
def test_time_sharded_full_matches_ff(m, diff, meshdims):
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=m, phase_avg=20,
                      differential=diff)
    xs = _signals(m=m, diff=diff)
    outs = _run_port(cfg, xs, meshdims, NS)
    soft_ff, idx_ff = _ff_reference(cfg, xs, NS, C)
    _check_rotated(outs, soft_ff, idx_ff, m)
    if (m, diff, meshdims) == (4, False, (2, 4)):
        ref = _run_jax(cfg, xs, meshdims, NS)
        _check_rotated(outs, (ref[0] + 1j * ref[1]).T, ref[4].T, m,
                       valid_ref=ref[5].T)


def test_time_sharded_mf_interp_matches_ff():
    """BASELINE config-3 profile (8-PSK + RRC + fractional timing): the
    FIR's (ntaps-1)-sample filtered-timeline lag rides the left halo."""
    ns, c = 1024, 256
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=8, phase_avg=20,
                      matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
                      timing_interp=True)
    xs = np.stack([
        gen_psk_channel(ns, sps=8, m=8, seed=900 + i, snr_db=25,
                        freq_offset=1e-4, pulse="rrc")[0] for i in range(c)])
    outs = _run_port(cfg, xs, (2, 2), ns)
    soft_ff, idx_ff = _ff_reference(cfg, xs, ns, c)
    _check_rotated(outs, soft_ff, idx_ff, 8, idx_atol=1e-3)


def test_time_sharded_boxcar_matches_ff():
    """Boxcar matched filter (odd ntaps-1 halo extension) on sps=10."""
    ns, c = 768, 256
    cfg = DemodConfig(sps=10, num_avg=30, constellation_size=4, phase_avg=16,
                      matched_filter="boxcar")
    xs = np.stack([
        gen_psk_channel(ns, sps=10, m=4, seed=1200 + i, snr_db=25,
                        freq_offset=1e-4, pulse="rect")[0] for i in range(c)])
    outs = _run_port(cfg, xs, (2, 3), ns)
    soft_ff, idx_ff = _ff_reference(cfg, xs, ns, c)
    _check_rotated(outs, soft_ff, idx_ff, 4)


def test_time_sharded_mixed_matches_jax():
    """Per-channel (M, differential) bank time-sharded (config 4 on the
    multi-shard flagship path) vs JAX's XLA mixed pipeline (shard 0 shares
    its phase origin and later shards are rewound to it, so the soft
    values compare directly) and vs JAX's own time-sharded function."""
    ns, c = 1024, 256
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    rng = np.random.default_rng(7)
    ms = rng.choice([2, 4, 8], c)
    diffs = rng.random(c) < 0.5
    xs = []
    for i in range(c):
        r = np.random.default_rng(1500 + i)
        m = int(ms[i])
        pts = np.exp(2j * np.pi * r.integers(0, m, ns) / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.zeros(ns * 8, np.complex64)
        x[3::8] = pts * np.exp(2j * np.pi * 1e-4 * 8 * np.arange(ns))
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    xs = np.stack(xs)
    outs = _run_port(cfg, xs, (2, 2), ns,
                     mixed_params=MixedParams.make(ms, diffs, "cpu"))
    soft_sh = (outs[0] + 1j * outs[1]).T
    valid = outs[5].T

    jparams = JaxMixedParams.make(ms, diffs)
    _, out = jax_mixed_fn(_jcfg(cfg))(jparams, jax_mixed_init(_jcfg(cfg), c),
                                      jnp.asarray(xs))
    a1 = cfg.num_avg - 1
    soft_ref = np.zeros((c, ns), np.complex64)
    soft_ref[:, : ns - a1] = np.asarray(out.soft)[:, a1:]
    bits_ref = np.zeros((c, ns, 3), np.int32)
    bits_ref[:, : ns - a1] = np.asarray(out.bits)[:, a1:]
    idx_ref = np.zeros((c, ns), np.int32)
    idx_ref[:, : ns - a1] = np.asarray(out.sample_index)[:, a1:]
    np.testing.assert_array_equal(outs[4].T[valid], idx_ref[valid])
    assert np.abs(soft_sh[valid] - soft_ref[valid]).max() < ROT_TOL
    packed_ref = bits_ref[..., 0] + 2 * bits_ref[..., 1] + 4 * bits_ref[..., 2]
    np.testing.assert_array_equal(outs[3].T[valid], packed_ref[valid])

    ref = _run_jax(cfg, xs, (2, 2), ns, mixed_params=jparams)
    np.testing.assert_array_equal(outs[5], ref[5])
    np.testing.assert_array_equal(outs[4][outs[5]], ref[4][ref[5]])
    np.testing.assert_array_equal(outs[3][outs[5]], ref[3][ref[5]])
    d = np.abs((outs[0] + 1j * outs[1]) - (ref[0] + 1j * ref[1]))[outs[5]]
    assert d.max() < ROT_TOL, d.max()


def test_time_sharded_i16_matches_f32():
    """int16 wire planes through the time-sharded path: the halos carry
    2-byte planes and each shard's B1 runs its int16 ingest; outputs equal
    the float32 run on the dequantized signal."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _signals()
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    re_w = np.round(np.ascontiguousarray(xs.real.T) / scale).astype(np.int16)
    im_w = np.round(np.ascontiguousarray(xs.imag.T) / scale).astype(np.int16)
    mesh = make_mesh(chan=2, time=4, devices=CPU8)
    o16 = make_time_sharded_full_demod(cfg, mesh, NS, in_scale=scale)(
        _t(re_w), _t(im_w))
    o32 = make_time_sharded_full_demod(cfg, mesh, NS)(
        _t(re_w.astype(np.float32) * scale), _t(im_w.astype(np.float32)
                                               * scale))
    valid = o16[5]
    assert torch.equal(valid, o32[5])
    assert torch.equal(o16[4][valid], o32[4][valid])
    assert torch.equal(o16[3][valid], o32[3][valid])
    d = (torch.complex(o16[0], o16[1]) - torch.complex(o32[0], o32[1])).abs()
    assert float(d[valid].max()) < 1e-5


def test_time_sharded_soft_i8_quantizes_after_seam_correction():
    """soft_i8_scale on the time-sharded path: int8 planes within 0.5/scale
    of the float32 run; bits and valid identical to it."""
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    xs = _signals()
    mesh = make_mesh(chan=2, time=4, devices=CPU8)
    xr, xi = _t(xs.real.T), _t(xs.imag.T)
    o32 = make_time_sharded_full_demod(cfg, mesh, NS)(xr, xi)
    o8 = make_time_sharded_full_demod(cfg, mesh, NS,
                                      soft_i8_scale=100.0)(xr, xi)
    valid = o8[5]
    assert torch.equal(valid, o32[5]) and torch.equal(o8[3], o32[3])
    assert o8[0].dtype == torch.int8
    for q, f in ((o8[0], o32[0]), (o8[1], o32[1])):
        d = (q.float() / 100.0 - f.clamp(-1.27, 1.27)).abs()[valid]
        assert float(d.max()) <= 0.5 / 100.0 + 1e-6, float(d.max())


def test_time_sharded_guards():
    cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
    mesh = make_mesh(chan=1, time=8, devices=CPU8)
    with pytest.raises(ValueError, match="samples per time shard"):
        make_time_sharded_full_demod(cfg, mesh, 512)
    with pytest.raises(ValueError, match="not divisible"):
        make_time_sharded_full_demod(cfg, mesh, 2044)
    with pytest.raises(ValueError, match="sps > 1"):
        make_time_sharded_full_demod(DemodConfig(sps=1, num_avg=50,
                                                 constellation_size=4,
                                                 phase_avg=20), mesh, 2048)
