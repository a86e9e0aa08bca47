"""Port parity, the JAX package's engine soaks (tests/test_soak.py): the
same event scripts (psk_soft_tpu_torch/testing/conformance, drawn from the
JAX tests' seeds in their order of draws) through the port's engines on
the CPU and through the JAX engines.

* StreamEngine: 40 random pushes, configures, queue flushes, rate changes
  and real-mode packets, then EOS (seeds 0-2).
* BatchEngine: 30 random pushes, configures, resets and flushes (seeds
  100, 101).
* FullKernelBatchEngine: warm-up, the kernel (B1's plain version),
  configure, reset and a flush in one run (seed 7), against the JAX
  engine with the Pallas kernel in interpret mode.

Each run keeps the JAX tests' invariants (ports never skew, soft finite,
timestamps non-decreasing within a segment, every port marks EOS,
metrics.symbols_out the symbols emitted) and equals the JAX run packet for
packet (tools/gates.compare_service): ports, SRIs, timestamps, EOS and
sriChanged flags, shapes, dtypes and metrics equal, bits and sample index
equal, soft and phase within the engines' parity bounds (2e-3 for the
plain pipelines, tests/test_torch_stream_engine.py and
tests/test_torch_batch_group.py; soft 3e-3 and phase 2e-3 for the kernel
engine, tests/test_torch_engine_full.py).

The soaks' rectangular pulses put every sample of a symbol within the
noise of the others, so the timing pick is a near tie at some outputs and
the two packages' float32 window sums may break it differently.  A sample
index may differ only where both picks' window sums (float64, recorded
from the port's steps by tools/gates.TieRecord) lie within NEAR_TIE_REL of
the largest, as chip_smoke.py's B1Gate rules on the card; bits, soft and
phase are then held outside the outputs whose tracker window (phase_avg +
the trend) holds such a pick (ROADMAP, "Known gaps").
"""

import dataclasses

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.runtime import engine as jengine
from psk_soft_tpu.runtime import streams as jstreams
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime import engine, streams
from psk_soft_tpu_torch.testing import conformance as cf
from psk_soft_tpu_torch.tools.gates import TieRecord, compare_service

torch.set_num_threads(1)


def _packets(run):
    return [out for _, out, _ in run]


@pytest.mark.parametrize("seed", cf.STREAM_SOAK_SEEDS)
def test_stream_engine_soak(seed):
    script = cf.stream_soak_script(seed)
    kw = cf.STREAM_SOAK_CFG
    with TieRecord() as ties:
        eng = engine.StreamEngine(DemodConfig(**kw), cf.STREAM_SOAK_BLOCK,
                                  device="cpu")
        got = cf.run_stream_script(eng, streams, DemodConfig, script)
    jeng = jengine.StreamEngine(JaxDemodConfig(**kw), cf.STREAM_SOAK_BLOCK)
    ref = cf.run_stream_script(jeng, jstreams, JaxDemodConfig, script)

    # tests/test_soak.py:52-110's invariants, against the configuration in
    # force at each emission; timestamps re-anchor at a configure, a rate
    # change and a queue flush.
    total, last_t = 0, {}
    for ev, out, bps in got:
        if ev in ("configure", "rate"):
            last_t.clear()
            continue
        if ev == "real":
            assert out == {}
        if streams.PORT_SOFT in out:
            soft = out[streams.PORT_SOFT].data
            assert np.isfinite(soft).all()
            assert out[streams.PORT_BITS].data.size == soft.size * bps
            assert out[streams.PORT_PHASE].data.size == soft.size
            assert out[streams.PORT_SAMPLE_INDEX].data.size == soft.size
            total += soft.size
            for port, p in out.items():
                assert np.isfinite(p.t)
                if port in last_t:
                    assert p.t >= last_t[port] - 1e-9
                last_t[port] = p.t
        if ev == "flush":
            last_t.clear()
    assert got[-1][1] and all(p.eos for p in got[-1][1].values())
    assert eng.metrics.symbols_out == total > 0

    compare_service(_packets(got), _packets(ref), f"StreamEngine {seed}",
                    ties=ties, soft_tol=2e-3)
    assert dataclasses.asdict(eng.metrics) == dataclasses.asdict(jeng.metrics)


@pytest.mark.parametrize("seed", cf.BATCH_SOAK_SEEDS)
def test_batch_engine_soak(seed):
    script = cf.batch_soak_script(seed)
    kw, n = cf.BATCH_SOAK_CFG, cf.BATCH_SOAK_C
    with TieRecord() as ties:
        eng = engine.BatchEngine(DemodConfig(**kw), n, cf.BATCH_SOAK_BLOCK,
                                 device="cpu")
        eng.set_input_sri(streams.SRI(stream_id="bank", xdelta=0.01))
        got = cf.run_bank_script(eng, DemodConfig, script)
    jeng = jengine.BatchEngine(JaxDemodConfig(**kw), n, cf.BATCH_SOAK_BLOCK)
    jeng.set_input_sri(jstreams.SRI(stream_id="bank", xdelta=0.01))
    ref = cf.run_bank_script(jeng, JaxDemodConfig, script)

    # tests/test_soak.py:113-151's invariants, against the configuration
    # in force at each emission.
    total = 0
    for _, pkts, bps in got:
        if pkts:
            soft = pkts[streams.PORT_SOFT].data
            assert np.isfinite(soft).all()
            assert pkts[streams.PORT_BITS].data.size == soft.size * bps
            total += soft.size
    assert eng.metrics.symbols_out == total > 0

    compare_service(_packets(got), _packets(ref), f"BatchEngine {seed}",
                    ties=ties, soft_tol=2e-3)
    assert dataclasses.asdict(eng.metrics) == dataclasses.asdict(jeng.metrics)


def test_full_kernel_engine_soak():
    """tests/test_soak.py:154-192's events, the port's engine against the
    JAX engine with the Pallas kernel in interpret mode."""
    script = cf.full_soak_script()
    kw, n = cf.FULL_SOAK_CFG, cf.FUZZ_C
    with TieRecord() as ties:
        eng = engine.FullKernelBatchEngine(DemodConfig(**kw), n,
                                           cf.FULL_SOAK_BLOCK, device="cpu")
        eng.set_input_sri(streams.SRI(stream_id="fk", xdelta=0.01))
        got = cf.run_bank_script(eng, DemodConfig, script, drain=False)
    jeng = jengine.FullKernelBatchEngine(JaxDemodConfig(**kw), n,
                                         cf.FULL_SOAK_BLOCK, s_tile=64,
                                         interpret=True)
    jeng.set_input_sri(jstreams.SRI(stream_id="fk", xdelta=0.01))
    ref = cf.run_bank_script(jeng, JaxDemodConfig, script, drain=False)

    total = 0
    for _, pkts, bps in got:
        if pkts and streams.PORT_SOFT in pkts:
            soft = pkts[streams.PORT_SOFT].data
            assert np.isfinite(soft).all()
            assert pkts[streams.PORT_BITS].data.size == soft.size * bps
            total += soft.size
    assert got[-1][0] == "flush"
    if streams.PORT_SOFT in got[-1][1]:
        assert got[-1][1][streams.PORT_SOFT].eos
    assert eng.metrics.symbols_out == total > 0
    assert eng.cfg.phase_avg == 10

    compare_service(_packets(got), _packets(ref), "FullKernelBatchEngine",
                    ties=ties)
    assert dataclasses.asdict(eng.metrics) == dataclasses.asdict(jeng.metrics)


def test_tie_record_rules_near_ties_only():
    """TieRecord.taint: a pick differing at a near tie taints its output
    and the tracker span after it on its channel; one differing at no near
    tie raises."""
    ties = TieRecord()
    w = np.full((2, 40, 4), 10.0)
    w[:, :, 2] = 12.0                   # bin 2 on top by 20%
    w[1, 5, 3] = 12.0 * (1 - 1e-7)      # channel 1, output 5: a near tie
    ties._add(w, phase_avg=10)
    got, ref = np.full((2, 40), 2), np.full((2, 40), 2)
    got[1, 5] = 3
    taint, n, widest = ties.taint(got, ref)
    assert n == 1 and 0 < widest < 1e-6
    span = 10 + 9                       # phase_avg + the unwrap trend
    assert taint[1, 5:5 + span + 1].all() and taint.sum() == span + 1
    got[0, 7] = 0                       # 20% below the top: a fault
    with pytest.raises(AssertionError, match="window-sum gap"):
        ties.taint(got, ref)
