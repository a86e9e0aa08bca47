"""Port parity, the blind probe: psk_soft_tpu_torch's ops/probe
(estimate_baud, classify_psk) against the JAX package on the CPU, in the
cases of tests/test_probe.py, fed the same numpy captures.

On every planted channel the estimates agree: sps within 1e-3 relative
(the FFTs sum in another order, which moves the parabolic fit's three
magnitudes by rounding), the PSK order exactly, the CFO within 1e-5
cycles/sample, and the confidences within 1e-3 relative.  Noise-only
channels are held to what tests/test_probe.py asks of them (an argmax
over noise can pick another bin when a mean is summed in another order).
The planted values are recovered as tests/test_probe.py requires.
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu.ops import probe as jpr
from psk_soft_tpu_torch.ops import probe as tpr
from psk_soft_tpu_torch.testing.signals import gen_psk_channel

torch.set_num_threads(1)

SPS_RTOL = 1e-3
CFO_TOL = 1e-5
CONF_RTOL = 1e-3


def _rect_psk(num_symbols, sps, m, rng, cfo=0.0, snr_db=20.0):
    """Rectangular M-PSK at possibly fractional sps
    (tests/test_probe.py:10-19)."""
    n = int(num_symbols * sps)
    idx = rng.integers(0, m, num_symbols + 1)
    sym_of_sample = np.floor(np.arange(n) / sps).astype(np.int64)
    x = np.exp(2j * np.pi * (idx[sym_of_sample] / m + cfo * np.arange(n)))
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    x = x + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _baud_both(x, **kw):
    got = tpr.estimate_baud(x, device="cpu", **kw)
    ref = jpr.estimate_baud(x, **kw)
    return got, ref


@pytest.mark.parametrize("case", ["rect8", "rect7.5", "rrc8"])
def test_baud_matches_jax(case):
    rng = np.random.default_rng({"rect8": 51, "rect7.5": 52,
                                 "rrc8": 53}[case])
    if case == "rrc8":
        x, _ = gen_psk_channel(3000, 8, 4, snr_db=20.0, pulse="rrc", seed=53)
        want, conf_min = 8.0, 10.0
    else:
        want = 8.0 if case == "rect8" else 7.5
        conf_min = 20.0 if case == "rect8" else 10.0
        x = _rect_psk(2000, want, 4, rng)
    (sps, conf), (jsps, jconf) = _baud_both(x, sps_min=2, sps_max=32)
    assert isinstance(sps, float) and isinstance(conf, float)
    assert abs(sps - jsps) <= SPS_RTOL * jsps
    assert conf == pytest.approx(jconf, rel=CONF_RTOL)
    assert abs(sps - want) < 0.05 and conf > conf_min


def test_baud_batched_noise_and_nfft():
    rng = np.random.default_rng(54)
    sig = _rect_psk(1500, 10, 4, rng)
    noise = (rng.standard_normal(sig.size)
             + 1j * rng.standard_normal(sig.size)).astype(np.complex64)
    x = np.stack([sig, noise])
    for nfft in (None, 1 << 14):
        (sps, conf), (jsps, jconf) = _baud_both(x, sps_min=2, sps_max=32,
                                                nfft=nfft)
        assert sps.shape == conf.shape == (2,)
        assert abs(sps[0] - jsps[0]) <= SPS_RTOL * jsps[0]
        assert conf[0] == pytest.approx(jconf[0], rel=CONF_RTOL)
        assert abs(sps[0] - 10.0) < 0.05
        assert conf[0] > 5 * conf[1] and jconf[0] > 5 * jconf[1]


@pytest.mark.parametrize("m", [2, 4, 8])
def test_classify_order_and_cfo(m):
    rng = np.random.default_rng(55 + m)
    cfo = 0.011
    x = _rect_psk(3000, 8, m, rng, cfo=cfo, snr_db=18.0)
    got = tpr.classify_psk(x, max_m=8, device="cpu")
    ref = jpr.classify_psk(x, max_m=8)
    assert isinstance(got[0], int) and got[0] == ref[0] == m
    assert abs(got[1] - ref[1]) <= CFO_TOL
    assert got[2] == pytest.approx(ref[2], rel=CONF_RTOL)
    assert abs(got[1] - cfo) < 2e-4 and got[2] > 8.0


def test_classify_noise_and_batch():
    rng = np.random.default_rng(60)
    rows = [_rect_psk(2000, 8, 2, rng, cfo=0.003),
            _rect_psk(2000, 8, 4, rng, cfo=-0.02),
            (rng.standard_normal(16000)
             + 1j * rng.standard_normal(16000)).astype(np.complex64)]
    x = np.stack(rows)
    for max_m in (8, 32):
        m, cfo, conf = tpr.classify_psk(x, max_m=max_m, device="cpu")
        jm, jcfo, jconf = jpr.classify_psk(x, max_m=max_m)
        assert m.tolist() == jm.tolist() == [2, 4, 0]
        np.testing.assert_allclose(cfo, jcfo, atol=CFO_TOL, rtol=0)
        np.testing.assert_allclose(conf[:2], jconf[:2], rtol=CONF_RTOL)
        assert abs(cfo[0] - 0.003) < 2e-4 and abs(cfo[1] + 0.02) < 2e-4
        assert conf[2] == 0.0


def test_tensor_input_stays_on_its_device():
    """A tensor is probed where it lies (here a CPU tensor under the
    default device "cuda"); a real-valued one is taken as complex."""
    rng = np.random.default_rng(61)
    x = _rect_psk(1200, 8, 4, rng, cfo=0.004)
    t = torch.from_numpy(x)
    assert tpr.estimate_baud(t, sps_min=2, sps_max=32) == \
        tpr.estimate_baud(x, sps_min=2, sps_max=32, device="cpu")
    assert tpr.classify_psk(t[None])[0].tolist() == [4]
    sps_r, _ = tpr.estimate_baud(torch.from_numpy(x.real.copy()),
                                 sps_min=2, sps_max=32)
    jsps_r, _ = jpr.estimate_baud(x.real.copy(), sps_min=2, sps_max=32)
    assert abs(sps_r - jsps_r) <= SPS_RTOL * jsps_r


def test_numpy_input_goes_to_the_default_device():
    """Without an explicit device a numpy capture is uploaded to "cuda":
    on a machine without a card that raises (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the upload succeeds")
    x = np.zeros(64, np.complex64)
    with pytest.raises((RuntimeError, AssertionError)):
        tpr.estimate_baud(x)
    with pytest.raises((RuntimeError, AssertionError)):
        tpr.classify_psk(x)


def test_validation():
    for mod, kw in ((tpr, dict(device="cpu")), (jpr, {})):
        with pytest.raises(ValueError):
            mod.estimate_baud(np.zeros(4, np.complex64), **kw)
        with pytest.raises(ValueError):
            mod.estimate_baud(np.zeros(64, np.complex64), sps_min=8,
                              sps_max=4, **kw)
        with pytest.raises(ValueError):
            mod.classify_psk(np.zeros(64, np.complex64), max_m=6, **kw)
        with pytest.raises(ValueError):
            mod.classify_psk(np.zeros(4, np.complex64), **kw)
        with pytest.raises(ValueError):
            mod.estimate_baud(np.zeros(16, np.complex64), sps_min=30,
                              sps_max=32, **kw)


def test_parabolic_matches_jax():
    rng = np.random.default_rng(62)
    row = rng.uniform(0, 1, 64)
    for k in (0, 1, 17, 62, 63):
        assert tpr._parabolic(row, k) == jpr._parabolic(row, k)
    assert tpr._parabolic(np.ones(8), 3) == 0.0
