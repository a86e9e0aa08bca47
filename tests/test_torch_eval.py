"""Port parity, evaluation layer: psk_soft_tpu_torch/eval/{ber,coded,
baseline_configs} against the JAX eval modules on the same seeds.

- eval/ber: the counting half fed JAX's own feed-forward soft output gives
  the JAX BerPoint exactly; the whole measure_ber (the port's demod) gives
  equal delay, rotation, slips and error counts.
- eval/coded: measure_coded_ber's CodedBerPoint equal to JAX's (the plain
  decoder on the CPU stands in for kernel B2); union_bound equal, with the
  same ValueErrors (the chain FER: tests/test_torch_chain_fer.py).
- eval/baseline_configs: configs 1-4 quick pass on the CPU and agree with
  JAX's; config 5 (the sharded demod) passes on a one-device mesh, and on
  8 CPU shards agrees with JAX's on its 8 virtual CPU devices: the same
  mesh, channels and verdicts, soft within the config's 1e-3 gate.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.eval import baseline_configs as jax_baseline
from psk_soft_tpu.eval import ber as jax_ber
from psk_soft_tpu.eval import coded as jax_coded
from psk_soft_tpu.ops import fec as jax_fec
from psk_soft_tpu.testing.signals import gen_psk_channel as jax_gen
from psk_soft_tpu.utils.transfer import to_host as jax_to_host
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.eval import baseline_configs, ber, coded
from psk_soft_tpu_torch.ops import fec

torch.set_num_threads(1)

BER_CASES = {
    # name: (DemodConfig fields, measure_ber keywords)
    "qpsk_cfo": (dict(sps=8, num_avg=50, constellation_size=4, phase_avg=50),
                 dict(esn0_db=8.0, freq_offset=2e-4, seed=1)),
    "bpsk_diff": (dict(sps=8, num_avg=50, constellation_size=2, phase_avg=30,
                       differential=True), dict(esn0_db=4.0, seed=2)),
    "8psk_rrc": (dict(sps=8, num_avg=50, constellation_size=8, phase_avg=40,
                      matched_filter="rrc", timing_interp=True),
                 dict(esn0_db=14.0, pulse="rrc", seed=9)),
}


def _configs(**kw):
    return DemodConfig(**kw), JaxDemodConfig(**kw)


def test_ber_helpers_match_jax():
    x = np.linspace(-3.0, 6.0, 37)
    np.testing.assert_array_equal(ber.qfunc(x), jax_ber.qfunc(x))
    esn0 = np.arange(-2.0, 20.0, 1.5)
    rng = np.random.default_rng(5)
    soft = (rng.standard_normal(500) + 1j * rng.standard_normal(500)
            ).astype(np.complex64)
    for m in (2, 4, 8, 16, 32):
        np.testing.assert_array_equal(ber.theoretical_ber(m, esn0),
                                      jax_ber.theoretical_ber(m, esn0))
        np.testing.assert_array_equal(ber._bit_map(m), jax_ber._bit_map(m))
        np.testing.assert_array_equal(ber.decide_indices(soft, m),
                                      jax_ber.decide_indices(soft, m))
    with pytest.raises(ValueError):
        ber.theoretical_ber(3, esn0)


@pytest.mark.parametrize("case", sorted(BER_CASES))
def test_count_errors_on_jax_soft_gives_jax_point(case):
    fields, kw = BER_CASES[case]
    cfg, jcfg = _configs(**fields)
    pulse = kw.get("pulse", "rect")
    x, tx_idx = jax_gen(4000, sps=cfg.sps, m=cfg.constellation_size,
                        differential=cfg.differential, seed=kw["seed"],
                        freq_offset=kw.get("freq_offset", 0.0),
                        snr_db=kw["esn0_db"], pulse=pulse,
                        rrc_beta=cfg.rrc_beta, rrc_span=cfg.rrc_span)
    from psk_soft_tpu.models.blockpsk import ff_init, make_ff_demod_fn
    _, out = make_ff_demod_fn(jcfg)(ff_init(jcfg), jnp.asarray(x))
    out = jax_to_host(out)
    got = ber.count_errors(cfg, kw["esn0_db"], out.soft[out.valid], tx_idx,
                           500, ber._max_delay(cfg, pulse))
    ref = jax_ber.measure_ber(jcfg, num_symbols=4000, **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)


@pytest.mark.parametrize("case", sorted(BER_CASES))
def test_measure_ber_matches_jax(case):
    fields, kw = BER_CASES[case]
    cfg, jcfg = _configs(**fields)
    got = ber.measure_ber(cfg, num_symbols=4000, device="cpu", **kw)
    ref = jax_ber.measure_ber(jcfg, num_symbols=4000, **kw)
    assert isinstance(got, ber.BerPoint)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert got.ser == ref.ser and got.ber == ref.ber


def test_ber_sweep_and_validation():
    cfg, jcfg = _configs(sps=8, num_avg=50, constellation_size=4,
                         phase_avg=50)
    pts = ber.ber_sweep(cfg, [6.0, 10.0], num_symbols=3000, seed=4,
                        device="cpu")
    ref = jax_ber.ber_sweep(jcfg, [6.0, 10.0], num_symbols=3000, seed=4)
    assert [dataclasses.astuple(p) for p in pts] == \
        [dataclasses.astuple(p) for p in ref]
    assert pts[0].ber > pts[1].ber
    with pytest.raises(ValueError, match="skip"):
        ber.measure_ber(cfg, 10.0, skip=8, device="cpu")


def test_union_bound_matches_jax():
    ebn0 = np.array([0.0, 2.0, 4.5, 6.0])
    for code, jcode in ((fec.CODE_K7, jax_fec.CODE_K7),
                        (fec.CODE_K3, jax_fec.CODE_K3)):
        np.testing.assert_array_equal(coded.union_bound(code, ebn0),
                                      jax_coded.union_bound(jcode, ebn0))
        assert coded.union_bound(code, 3.0).shape == ()
    with pytest.raises(ValueError, match="unpunctured"):
        coded.union_bound(fec.ConvCode(7, (0o171, 0o133),
                                       fec.PUNCTURE_2_3), 4.0)
    with pytest.raises(ValueError, match="no tabulated spectrum"):
        coded.union_bound(fec.ConvCode(5, (0o35, 0o23)), 4.0)


CODED_CASES = {
    "k7_qpsk": (lambda f: f.CODE_K7, 4, 4.0, dict(num_bits=20_000, seed=1)),
    "k3_bpsk": (lambda f: f.CODE_K3, 2, 1.0, dict(num_bits=20_000, seed=4)),
    "k7_punctured": (lambda f: f.ConvCode(7, (0o171, 0o133),
                                          f.PUNCTURE_2_3), 4, 4.5,
                     dict(num_bits=15_000, seed=5)),
    "k7_gray_interleaved_8psk": (lambda f: f.CODE_K7, 8, 6.0,
                                 dict(num_bits=10_000, labeling="gray",
                                      interleave_rows=4, seed=6)),
}


@pytest.mark.parametrize("case", sorted(CODED_CASES))
def test_measure_coded_ber_matches_jax(case):
    make, m, esn0, kw = CODED_CASES[case]
    got = coded.measure_coded_ber(make(fec), m, esn0, device="cpu", **kw)
    ref = jax_coded.measure_coded_ber(make(jax_fec), m, esn0, **kw)
    assert isinstance(got, coded.CodedBerPoint)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert got.n_errors > 0            # the point is not trivially clean


def test_coded_ber_sweep_matches_jax():
    pts = coded.coded_ber_sweep(fec.CODE_K7, 2, [-1.0, 1.0], num_bits=8000,
                                seed=2, device="cpu")
    ref = jax_coded.coded_ber_sweep(jax_fec.CODE_K7, 2, [-1.0, 1.0],
                                    num_bits=8000, seed=2)
    assert [dataclasses.astuple(p) for p in pts] == \
        [dataclasses.astuple(p) for p in ref]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_baseline_config_passes_and_matches_jax(n):
    got = baseline_configs.run_config(n, quick=True, device="cpu")
    assert got["pass"], got
    ref = jax_baseline.run_config(n, quick=True)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if k in ("max_soft_error", "worst_p95_slot_error"):
            assert abs(got[k] - v) < 1e-3, (k, got[k], v)
        else:
            assert got[k] == v, k


def test_baseline_config5_waits_for_sharding():
    # Config 5 is ported (parallel/): one device is a 1 x 1 mesh.
    got = baseline_configs.run_config(5, quick=True, device="cpu")
    assert got["pass"] and got["mesh"] == [1, 1] and got["channels"] == 64


def test_baseline_config5_matches_jax():
    import jax

    n = len(jax.devices())
    got = baseline_configs.config5_sharded_qpsk(quick=True,
                                                devices=["cpu"] * n)
    ref = jax_baseline.run_config(5, quick=True)
    assert got.keys() == ref.keys()
    assert got["pass"] and ref["pass"]
    for k in ("config", "channels", "mesh", "bits_equal"):
        assert got[k] == ref[k], k
    assert got["max_soft_diff_vs_single_device"] < 1e-3
