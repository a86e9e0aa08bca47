"""Port parity, the sharding-cost harness: psk_soft_tpu_torch/eval/scaling's
three reports on meshes of CPU shards (tests/test_scaling.py's sizes)
against the JAX package's on its 8 virtual CPU devices.

Each report has JAX's fields, top level and per point, plus
``shards_share_device`` (true here: the shards are one CPU); the chain
report plants as many frames a block as JAX's.  Times are the CPU's and
not compared: CPU shards share host cores, so, as in
tests/test_scaling.py, no efficiency bound is asserted.
"""

import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.eval import scaling as jscaling
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.eval.scaling import (chain_scaling_report,
                                             channel_scaling_report,
                                             time_shard_report)

torch.set_num_threads(1)

CFG = DemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12)
JCFG = JaxDemodConfig(sps=8, num_avg=20, constellation_size=4, phase_avg=12)
CPU8 = ["cpu"] * 8


def _same_fields(got, ref):
    assert set(got) == set(ref) | {"shards_share_device"}
    assert got["shards_share_device"] is True
    for p, q in zip(got["points"], ref["points"]):
        assert set(p) == set(q)
    for k, v in ref.items():
        if k != "points":
            assert got[k] == v, k


@pytest.mark.parametrize("pipeline", ["ff", "full"])
def test_channel_weak_scaling_report(pipeline):
    rep = channel_scaling_report(CFG, device_counts=[1, 2, 4],
                                 channels_per_device=16, symbols=64,
                                 iters=2, reps=2, pipeline=pipeline,
                                 devices=CPU8)
    assert rep["mode"] == "channel-weak"
    pts = rep["points"]
    assert [p["devices"] for p in pts] == [1, 2, 4]
    assert [p["channels"] for p in pts] == [16, 32, 64]
    assert pts[0]["efficiency"] == 1.0
    for p in pts:
        assert p["step_s"] > 0 and p["throughput_sps"] > 0
        assert 0.01 < p["efficiency"] <= 4.0
    if pipeline == "ff":
        _same_fields(rep, jscaling.channel_scaling_report(
            JCFG, device_counts=[1, 2], channels_per_device=16, symbols=64,
            iters=1, reps=1))


def test_chain_weak_scaling_report():
    cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4,
                      phase_avg=50)
    rep = chain_scaling_report(cfg, device_counts=[1, 2],
                               channels_per_device=128, symbols=512,
                               iters=1, reps=1, devices=CPU8)
    assert rep["mode"] == "chain-weak (seam)"
    assert rep["frames_per_block_per_channel"] >= 1
    pts = rep["points"]
    assert [p["devices"] for p in pts] == [1, 2]
    assert pts[0]["efficiency"] == 1.0
    for p in pts:
        assert p["step_s"] > 0 and p["infobits_per_s"] > 0
    ref = jscaling.chain_scaling_report(
        JaxDemodConfig(sps=8, num_avg=100, constellation_size=4,
                       phase_avg=50), device_counts=[1],
        channels_per_device=128, symbols=512, iters=1, reps=1,
        interpret=True)
    _same_fields(rep, ref)


def test_time_strong_scaling_report():
    rep = time_shard_report(CFG, time_counts=[1, 2, 4], channels=128,
                            total_symbols=1024, iters=1, reps=1,
                            devices=CPU8)
    pts = rep["points"]
    assert [p["time_shards"] for p in pts] == [1, 2, 4]
    assert [p["symbols_per_shard"] for p in pts] == [1024, 512, 256]
    assert pts[0]["efficiency"] == 1.0
    for p in pts:
        assert p["step_s"] > 0
    _same_fields(rep, jscaling.time_shard_report(
        JCFG, time_counts=[1], channels=128, total_symbols=1024, iters=1,
        reps=1, interpret=True))
