"""Port parity, the quality tap: psk_soft_tpu_torch's ops/quality
(block_quality, snr_db, evm_pct) and runtime/quality.QualityMonitor against
the JAX package on the CPU, fed the same numpy soft blocks.

Tolerances (tests/test_quality.py's): amp, power and lock within rtol 1e-5,
EVM within rtol 1e-4, SNR within rtol 1e-3; counts and alarms equal.
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.ops import quality as jq
from psk_soft_tpu.runtime.engine import BatchEngine as JaxBatchEngine
from psk_soft_tpu.runtime.quality import QualityMonitor as JaxMonitor
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.ops import quality as tq
from psk_soft_tpu_torch.runtime.engine_batch import BatchEngine
from psk_soft_tpu_torch.runtime.quality import QualityMonitor
from psk_soft_tpu_torch.runtime.streams import PORT_SOFT, SRI, Packet

torch.set_num_threads(1)

RTOL = dict(amp=1e-5, power=1e-5, lock=1e-5, evm=1e-4, snr=1e-3)


def _psk_soft(c, s, m, snr_db_val, seed=0, rot=0.0):
    """(c, s) soft decisions: unit M-PSK + complex AWGN at the given SNR."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, m, size=(c, s))
    pts = np.exp(1j * (2 * np.pi * k / m + rot))
    sigma = 10.0 ** (-snr_db_val / 20.0)
    n = (rng.standard_normal((c, s)) + 1j * rng.standard_normal((c, s)))
    return (pts + sigma * n / np.sqrt(2.0)).astype(np.complex64)


def _assert_block(got, want):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for name, rtol in RTOL.items():
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["snr_ladder", "8psk_rotated", "noise",
                                  "per_channel_m", "valid_mask", "empty",
                                  "scaled"])
def test_block_quality_matches_jax(case):
    """The JAX tests' inputs: an SNR ladder, rotated 8-PSK, pure noise, a
    per-channel M plane, a valid mask over corrupted symbols, empty rows
    (neutral zeros) and a 3x amplitude."""
    m, valid = 4, None
    if case == "snr_ladder":
        soft = np.stack([_psk_soft(1, 4096, 4, s, seed=i)[0]
                         for i, s in enumerate((5.0, 10.0, 15.0, 20.0))])
    elif case == "8psk_rotated":
        soft = _psk_soft(2, 4096, 8, 25.0, seed=7) * np.exp(1j * 0.77)
        m = 8
    elif case == "noise":
        rng = np.random.default_rng(2)
        soft = rng.standard_normal((2, 4096)) \
            + 1j * rng.standard_normal((2, 4096))
    elif case == "per_channel_m":
        m = np.array([2, 4, 8, 16], np.int32)
        soft = np.stack([_psk_soft(1, 4096, int(k), 12.0, seed=int(k))[0]
                         for k in m])
    elif case in ("valid_mask", "empty"):
        soft = _psk_soft(2, 512, 4, 18.0, seed=3)
        soft[:, :256] = 50.0 * (1 + 1j)
        valid = np.zeros((2, 512), bool)
        if case == "valid_mask":
            valid[:, 256:] = True
    else:
        soft = 3.0 * _psk_soft(1, 4096, 4, 20.0, seed=4)
    soft = soft.astype(np.complex64)
    want = jq.block_quality(soft, m, valid=valid)
    got = tq.block_quality(torch.from_numpy(soft),
                           m if np.isscalar(m) else torch.from_numpy(m),
                           valid=None if valid is None
                           else torch.from_numpy(valid))
    _assert_block(got, want)
    np.testing.assert_array_equal(tq.snr_db(np.asarray(want.snr)),
                                  jq.snr_db(np.asarray(want.snr)))
    np.testing.assert_array_equal(tq.evm_pct(np.asarray(want.evm)),
                                  jq.evm_pct(np.asarray(want.evm)))
    fn = tq.make_quality_fn(m if np.isscalar(m) else torch.from_numpy(m))
    _assert_block(fn(torch.from_numpy(soft),
                     valid=None if valid is None
                     else torch.from_numpy(valid)), want)


class _Stub:
    """Packet source with the bank-engine surface: emits the given soft
    blocks as PORT_SOFT packets."""

    def __init__(self, blocks, m=None, device="cpu"):
        self.cfg = DemodConfig(sps=8, num_avg=50, constellation_size=4,
                               phase_avg=50)
        self.channels = blocks[0].shape[0]
        self.device = torch.device(device)
        self._blocks = list(blocks)
        self.resets = 0
        if m is not None:
            self.params = type("P", (), {"m": m})()

    def step_packets(self):
        if not self._blocks:
            return None
        return {PORT_SOFT: Packet(data=self._blocks.pop(0), sri=SRI("q"))}

    def flush_packets(self):
        return self.step_packets() or {}

    def reset(self):
        self.resets += 1


def _snap_equal(got, want):
    np.testing.assert_array_equal(got["symbols"], want["symbols"])
    for name, rtol in (("amp", 1e-5), ("power", 1e-5), ("lock", 1e-5),
                       ("evm_pct", 1e-4)):
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got["snr_db"], want["snr_db"], atol=5e-3)


@pytest.mark.parametrize("alpha", [0.05, 1.0])
def test_monitor_matches_jax(alpha):
    """Six blocks of varying length (two locked channels, one noise-only,
    one with an empty block), folded by both monitors: snapshots and
    alarms equal; flush taps; reset_quality clears; reset reaches the
    engine."""
    rng = np.random.default_rng(0)
    blocks = []
    for b, s in enumerate((256, 100, 256, 0, 64, 256)):
        blk = np.concatenate([_psk_soft(2, s, 4, 20.0, seed=b),
                              (0.1 * (rng.standard_normal((1, s)) + 1j
                                      * rng.standard_normal((1, s))))],
                             axis=0).astype(np.complex64)
        blocks.append(blk)
    jmon = JaxMonitor(_Stub(blocks), alpha=alpha)
    mon = QualityMonitor(_Stub(blocks), alpha=alpha)
    for _ in range(len(blocks) - 1):
        jmon.step_packets()
        mon.step_packets()
        _snap_equal(mon.snapshot(), jmon.snapshot())
    jmon.flush_packets()
    mon.flush_packets()
    _snap_equal(mon.snapshot(), jmon.snapshot())
    np.testing.assert_array_equal(mon.alarms(), jmon.alarms())
    np.testing.assert_array_equal(mon.alarms(0.9, 30.0),
                                  jmon.alarms(0.9, 30.0))
    assert list(mon.alarms()) == [False, False, True]
    mon.reset_quality()
    assert mon.snapshot()["symbols"].sum() == 0 and not mon.alarms().any()
    mon.reset()
    assert mon.engine.resets == 1 and mon.channels == 3


def test_monitor_mixed_bank_uses_mode_plane():
    """M comes from engine.params.m (a tensor on the port's mixed bank),
    as the JAX monitor reads it; an explicit scalar m overrides it."""
    soft = np.stack([_psk_soft(1, 2048, 2, 25.0, seed=5)[0],
                     _psk_soft(1, 2048, 8, 25.0, seed=6)[0]])
    ms = np.array([2, 8], np.int32)
    for m_over in (None, 4):
        jstub = _Stub([soft], m=ms)
        jmon = JaxMonitor(jstub, alpha=1.0, m=m_over)
        mon = QualityMonitor(_Stub([soft], m=torch.from_numpy(ms)),
                             alpha=1.0, m=m_over)
        jmon.observe(soft)
        mon.observe(torch.from_numpy(soft))
        _snap_equal(mon.snapshot(), jmon.snapshot())
    assert mon.snapshot()["lock"][1] < 0.5     # wrong M=4 on the 8-PSK


def test_monitor_on_live_engines_matches_jax():
    """The JAX test's live BatchEngine bank (two channels locked, one dead)
    behind each package's monitor: snapshot within the engines' soft
    agreement, alarms equal; no data ports, no quality."""
    cfg_kw = dict(sps=8, num_avg=50, constellation_size=4, phase_avg=50)
    c, s = 3, 256
    rng = np.random.default_rng(0)
    need = s * 8
    blocks = []
    for _ in range(6):
        rows = []
        for ch in range(c):
            if ch < 2:
                k = rng.integers(0, 4, s)
                x = np.repeat(np.exp(2j * np.pi * k / 4), 8)
                x = x + 0.02 * (rng.standard_normal(need)
                                + 1j * rng.standard_normal(need))
            else:
                x = 0.1 * (rng.standard_normal(need)
                           + 1j * rng.standard_normal(need))
            rows.append(x.astype(np.complex64))
        blocks.append(rows)
    jmon = JaxMonitor(JaxBatchEngine(JaxDemodConfig(**cfg_kw), c,
                                     block_symbols=s), alpha=0.05)
    mon = QualityMonitor(BatchEngine(DemodConfig(**cfg_kw), c,
                                     block_symbols=s, device="cpu"),
                         alpha=0.05)
    for rows in blocks:
        for ch in range(c):
            jmon.push(ch, rows[ch])
            mon.push(ch, rows[ch])
        jmon.step_packets()
        mon.step_packets()
    want, got = jmon.snapshot(), mon.snapshot()
    np.testing.assert_array_equal(got["symbols"], want["symbols"])
    for name in ("amp", "power", "lock", "evm_pct", "snr_db"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(mon.alarms(), jmon.alarms())
    assert list(mon.alarms()) == [False, False, True]
    assert got["lock"][0] > 0.8 and got["snr_db"][0] > 10.0
    dark = QualityMonitor(_Stub([np.zeros((3, 0), np.complex64)]))
    dark.step_packets()
    assert dark.snapshot()["symbols"].sum() == 0
    with pytest.raises(ValueError, match="alpha"):
        QualityMonitor(_Stub(blocks[0][:1]), alpha=0.0)
    with pytest.raises(ValueError, match="soft block"):
        mon.observe(np.zeros((2, 8), np.complex64))
