"""Port parity, ops level: psk_soft_tpu_torch/config.py and ops/ against the
JAX package on the same numpy inputs (float32 both sides).

Tolerance 1e-4 absolute: float32 values of at most a few tens, summed in
another order (jnp.convolve / lax.conv vs unfold + sum).  Integer outputs
(argmax indices, bit codes) must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import linear_fit as j_linear_fit
from psk_soft_tpu.ops import matched_filter as j_mf
from psk_soft_tpu.ops import phase as j_phase
from psk_soft_tpu.ops import slicers as j_slicers
from psk_soft_tpu.ops import timing as j_timing
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import (linear_fit, matched_filter, phase,
                                    slicers, timing)

torch.set_num_threads(1)

TOL = 1e-4


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _wrapped(a, b, period=2 * np.pi):
    """Largest |a - b| modulo ``period`` (atan2 outputs may sit on either
    side of the +-pi cut after a last-bit difference)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d - period * np.round(d / period)).max()


def test_config_fields_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(DemodConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxDemodConfig)]
    assert ours == ref
    for kw in (dict(), dict(sps=8, constellation_size=8, phase_avg=20),
               dict(matched_filter="rrc", rrc_span=4),
               dict(matched_filter="boxcar", sps=4)):
        a, b = DemodConfig(**kw), JaxDemodConfig(**kw)
        assert (a.bits_per_symbol, a.window_samples, a.mf_ntaps) == (
            b.bits_per_symbol, b.window_samples, b.mf_ntaps)
        assert a.to_json() == b.to_json()
        assert DemodConfig.from_json(b.to_json()) == a


@pytest.mark.parametrize("kw", [dict(constellation_size=3), dict(sps=0),
                                dict(num_avg=0), dict(phase_avg=0),
                                dict(matched_filter="gauss")])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxDemodConfig(**kw)
    with pytest.raises(ValueError):
        DemodConfig(**kw)


@pytest.mark.parametrize("n", [1, 2, 20, 50])
def test_linear_fit_tables_equal(n):
    np.testing.assert_array_equal(linear_fit.endpoint_fir_weights(n),
                                  j_linear_fit.endpoint_fir_weights(n))
    np.testing.assert_array_equal(linear_fit.warmup_fir_weight_matrix(n),
                                  j_linear_fit.warmup_fir_weight_matrix(n))


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_mth_power_phase(m):
    # Near-unit magnitudes, like decision samples: |x|**32 stays normal.
    rng = np.random.default_rng(m)
    x = (rng.uniform(0.8, 1.2, (8, 256))
         * np.exp(1j * rng.uniform(-np.pi, np.pi, (8, 256)))
         ).astype(np.complex64)
    got = phase.mth_power_phase(torch.from_numpy(x), m).numpy()
    ref = np.asarray(j_phase.mth_power_phase(jnp.asarray(x), m))
    assert got.dtype == np.float32
    assert _wrapped(got, ref) < TOL


@pytest.mark.parametrize("k,stride", [(9, 1), (9, 4), (5, 2)])
def test_causal_complex_ma(k, stride):
    rng = np.random.default_rng(k + stride)
    p = rng.uniform(-np.pi, np.pi, (6, 128)).astype(np.float32)
    got = phase.causal_complex_ma(torch.from_numpy(p), k, stride).numpy()
    ref = np.asarray(j_phase.causal_complex_ma(jnp.asarray(p), k, stride))
    assert got.shape == ref.shape
    assert _wrapped(got, ref) < TOL


@pytest.mark.parametrize("t", [64, 97])
def test_unwraps(t):
    rng = np.random.default_rng(t)
    walk = np.cumsum(rng.normal(0.3, 0.5, (5, t)), -1).astype(np.float32)
    raw = np.angle(np.exp(1j * walk)).astype(np.float32)
    prev = raw[:, 0].copy()
    np.testing.assert_allclose(
        phase.block_unwrap(torch.from_numpy(raw), torch.from_numpy(prev)),
        j_phase.block_unwrap(jnp.asarray(raw), jnp.asarray(prev)), atol=TOL)
    np.testing.assert_allclose(
        phase.robust_block_unwrap(torch.from_numpy(raw)),
        j_phase.robust_block_unwrap(jnp.asarray(raw)), atol=TOL)
    np.testing.assert_allclose(phase.wrap_to_pi(torch.from_numpy(walk)),
                               j_phase.wrap_to_pi(jnp.asarray(walk)),
                               atol=TOL)
    assert phase.UNWRAP_TREND_LEN == j_phase.UNWRAP_TREND_LEN
    assert phase.UNWRAP_TREND_STRIDE == j_phase.UNWRAP_TREND_STRIDE


@pytest.mark.parametrize("m", [2, 4, 8])
def test_rewrap_offset(m):
    est = np.linspace(-80, 80, 321).astype(np.float32)
    np.testing.assert_array_equal(
        phase.rewrap_offset(torch.from_numpy(est), m).numpy(),
        np.asarray(j_phase.rewrap_offset(jnp.asarray(est), m)))


@pytest.mark.parametrize("num_avg", [1, 7, 50])
def test_timing(num_avg):
    rng = np.random.default_rng(num_avg)
    s, sps = 64, 8
    rows = _cplx(rng, (4, s + num_avg - 1, sps))
    e = timing.symbol_energy_rows(torch.from_numpy(rows))
    e_ref = np.asarray(j_timing.symbol_energy_rows(jnp.asarray(rows)))
    np.testing.assert_allclose(e.numpy(), e_ref, atol=TOL)
    w = timing.windowed_bin_sums(e, num_avg)
    w_ref = np.array(j_timing.windowed_bin_sums(jnp.asarray(e_ref),
                                                num_avg))
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=1e-5, atol=TOL)
    idx, sel = timing.select_decision_samples(
        torch.from_numpy(rows[:, :s].copy()), torch.from_numpy(w_ref))
    idx_ref, sel_ref = j_timing.select_decision_samples(
        jnp.asarray(rows[:, :s]), jnp.asarray(w_ref))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_ref))


@pytest.mark.parametrize("num_avg", [1, 7, 50])
def test_windowed_bin_sums_direct(num_avg):
    """The direct windowed sum against JAX's reduce_window and against the
    cumsum-diff path on the same energies."""
    rng = np.random.default_rng(100 + num_avg)
    e = np.abs(_cplx(rng, (4, 64 + num_avg - 1, 8))) ** 2
    w = timing.windowed_bin_sums_direct(torch.from_numpy(e), num_avg)
    w_ref = np.asarray(j_timing.windowed_bin_sums_direct(jnp.asarray(e),
                                                         num_avg))
    assert w.shape == w_ref.shape == (4, 64, 8)
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=1e-5, atol=TOL)
    np.testing.assert_allclose(
        w.numpy(), timing.windowed_bin_sums(torch.from_numpy(e),
                                            num_avg).numpy(),
        rtol=1e-5, atol=TOL)


def test_argmax_keeps_first_maximum():
    """Exact ties pick bin 0, like std::max_element (tests/test_tiebreak)."""
    w = torch.ones((3, 10, 8))
    w[1, :, 5] = 2.0
    w[1, :, 6] = 2.0
    rows = torch.zeros((3, 10, 8), dtype=torch.complex64)
    idx, _ = timing.select_decision_samples(rows, w)
    assert (idx[0] == 0).all() and (idx[2] == 0).all()
    assert (idx[1] == 5).all()


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_slicers(m):
    soft = _cplx(np.random.default_rng(100 + m), (16, 128))
    got = slicers.slice_bits(m, torch.from_numpy(soft)).numpy()
    ref = np.asarray(j_slicers.slice_bits(m, jnp.asarray(soft)))
    assert got.dtype == np.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if m >= 8:
        np.testing.assert_array_equal(
            slicers.mpsk_code(m, torch.from_numpy(soft)).numpy(),
            np.asarray(j_slicers.mpsk_code(m, jnp.asarray(soft))))
    if m == 8:
        np.testing.assert_array_equal(
            slicers.slice_8psk(torch.from_numpy(soft)).numpy(),
            np.asarray(j_slicers.slice_8psk(jnp.asarray(soft))))


@pytest.mark.parametrize("kind", ["rrc", "boxcar"])
def test_matched_filter(kind):
    cfg = DemodConfig(sps=4, matched_filter=kind, rrc_span=4)
    jcfg = JaxDemodConfig(sps=4, matched_filter=kind, rrc_span=4)
    taps = matched_filter.filter_taps(cfg)
    np.testing.assert_array_equal(taps, j_mf.filter_taps(jcfg))
    rng = np.random.default_rng(7)
    x = _cplx(rng, (3, 200))
    tail = _cplx(rng, (3, taps.size - 1))
    y, t2 = matched_filter.streaming_filter(
        torch.from_numpy(x), torch.from_numpy(tail), torch.from_numpy(taps))
    y_ref, t2_ref = j_mf.streaming_filter(jnp.asarray(x), jnp.asarray(tail),
                                          jnp.asarray(taps))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(t2_ref))
    assert matched_filter.filter_taps(DemodConfig()) is None
