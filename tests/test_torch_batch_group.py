"""Port parity, bank engines of the plain pipelines: psk_soft_tpu_torch's
BatchEngine and GroupEngine against the JAX engines on the same pushes,
in the cases of tests/test_engine_groups.py and tests/test_engine.py:178
(the non-finite guard, the flush remainder, configure, pipelining, a match
with C StreamEngines, heterogeneous sps, the group packet layer and a
configure that would split a group).

Held equal: valid, bits, sample index, channel_resyncs, metrics and
packet metadata; soft and phase within 2e-3 (the JAX package's tolerance,
tests/test_oracle_parity.py:45-47), NaN where the JAX engine has NaN.
"""

import dataclasses

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.runtime import engine as jengine
from psk_soft_tpu.runtime import streams as jstreams
from psk_soft_tpu.utils.transfer import to_host
from psk_soft_tpu_torch import demod_init
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime import engine, streams

torch.set_num_threads(1)

TOL = 2e-3
KW = dict(sps=8, num_avg=20, constellation_size=4, phase_avg=10)
EXACT_PORTS = (streams.PORT_BITS, streams.PORT_SAMPLE_INDEX)


def signal(nsym, sps=8, m=4, seed=0, foff=5e-5):
    """M-PSK with all energy on sample sps//2 of each symbol, a small
    frequency offset and real noise of std 0.02."""
    rng = np.random.default_rng(seed)
    pts = np.exp(2j * np.pi * rng.integers(0, m, nsym) / m)
    x = np.zeros(nsym * sps, np.complex128)
    x[sps // 2::sps] = pts * np.exp(2j * np.pi * foff * sps
                                    * np.arange(nsym))
    return (x + 0.02 * rng.standard_normal(x.size)).astype(np.complex64)


def assert_outputs(got, ref, nb):
    if ref is None:
        assert got is None
        return
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


def assert_packets_equal(got, ref):
    assert (got is None) == (ref is None)
    if got is None:
        return
    assert set(got) == set(ref)
    for port in got:
        a, b = got[port], ref[port]
        assert dataclasses.asdict(a.sri) == dataclasses.asdict(b.sri)
        assert (a.t, a.eos, a.sri_changed) == (b.t, b.eos, b.sri_changed)
        da, db = np.asarray(a.data), np.asarray(b.data)
        assert da.dtype == db.dtype and da.shape == db.shape, port
        if port in EXACT_PORTS:
            np.testing.assert_array_equal(da, db, err_msg=port)
        else:
            np.testing.assert_allclose(da, db, atol=TOL, err_msg=port)


def pair(C, pipeline, kw=KW, **opts):
    return (engine.BatchEngine(DemodConfig(**kw), C, pipeline=pipeline,
                               device="cpu", **opts),
            jengine.BatchEngine(JaxDemodConfig(**kw), C, pipeline=pipeline,
                                **opts))


def push_both(engines, c, data):
    for e in engines:
        e.push(c, data)


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_nonfinite_channel_resyncs_alone(pipeline):
    """tests/test_engine_groups.py:10-36: NaNs in channel 2's second block
    reset that channel alone; outputs, resyncs and metrics as in JAX."""
    C = 4
    engs = pair(C, pipeline, block_symbols=64, guard_nonfinite=True)
    good = [signal(192, seed=i) for i in range(C)]
    bad = good[2].copy()
    bad[600:620] = np.nan
    bad[700] = np.inf
    for b in range(3):
        for c in range(C):
            src = bad if (c == 2 and b == 1) else good[c]
            push_both(engs, c, src[b * 512:(b + 1) * 512])
        got, ref = engs[0].step(), engs[1].step()
        assert_outputs(got, ref, 2)
    assert engs[0].channel_resyncs.tolist() == [0, 0, 1, 0]
    assert engs[0].channel_resyncs.tolist() == \
        engs[1].channel_resyncs.tolist()
    v = got.valid.numpy()
    assert v[[0, 1, 3]].all() and not v[2][:19].any() and v[2][19:].all()
    assert dataclasses.asdict(engs[0].metrics) == \
        dataclasses.asdict(engs[1].metrics)


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_flush_drains_remainder(pipeline):
    engs = pair(2, pipeline, block_symbols=64)
    for c in range(2):
        push_both(engs, c, signal(100, seed=300 + c))
    assert_outputs(engs[0].step(), engs[1].step(), 2)
    got, ref = engs[0].flush(), engs[1].flush()
    assert got.valid.shape == (2, 36)
    assert_outputs(got, ref, 2)
    assert engs[0].metrics.symbols_out == 2 * (100 - 19)
    assert engs[0].flush() is None and engs[1].flush() is None


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_batch_configure_matches_jax(pipeline):
    """phase_avg 16 -> 8 mid-stream (tests/test_engine_groups.py:83-99),
    then num_avg 20 -> 14, with packets."""
    kw0 = dict(KW, phase_avg=16)
    engs = pair(2, pipeline, kw=kw0, block_symbols=64)
    for e in engs:
        e.set_input_sri((streams if e is engs[0] else jstreams).SRI(
            "bank", xdelta=1e-3), t=1.0)
    sigs = [signal(320, seed=500 + c) for c in range(2)]
    for b, kw in enumerate((None, dict(KW, phase_avg=8), None,
                            dict(KW, phase_avg=8, num_avg=14), None)):
        if kw is not None:
            engs[0].configure(DemodConfig(**kw))
            engs[1].configure(JaxDemodConfig(**kw))
        for c in range(2):
            push_both(engs, c, sigs[c][b * 512:(b + 1) * 512])
        assert_packets_equal(engs[0].step_packets(), engs[1].step_packets())
    assert engs[0].metrics.reconfigures == 2
    assert dataclasses.asdict(engs[0].metrics) == \
        dataclasses.asdict(engs[1].metrics)


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_pipelined_packets_match(pipeline):
    """Depth 1 emits the depth-0 packets one call later (merged at EOS),
    and both match the JAX engine at the same depth."""
    C = 3
    sigs = [signal(300, seed=40 + c) for c in range(C)]
    runs = {}
    for depth in (0, 1):
        engs = pair(C, pipeline, block_symbols=64, pipeline_depth=depth)
        for e, mod in zip(engs, (streams, jstreams)):
            e.set_input_sri(mod.SRI("bank", xdelta=1e-6), t=2.0)
        outs = []
        for b in range(4):
            for c in range(C):
                push_both(engs, c, sigs[c][b * 512:(b + 1) * 512])
            got, ref = engs[0].step_packets(), engs[1].step_packets()
            assert_packets_equal(got, ref)
            outs.append(got)
        for c in range(C):
            push_both(engs, c, sigs[c][4 * 512:])
        got, ref = engs[0].flush_packets(), engs[1].flush_packets()
        assert_packets_equal(got, ref)
        outs.append(got)
        runs[depth] = [o for o in outs if o is not None]
    assert runs[1][0][streams.PORT_SOFT].t == runs[0][0][streams.PORT_SOFT].t
    assert runs[1][-1][streams.PORT_SOFT].eos
    flat = {d: np.concatenate([o[streams.PORT_BITS].data for o in runs[d]],
                              axis=-1) for d in runs}
    np.testing.assert_array_equal(flat[0], flat[1])
    with pytest.raises(ValueError, match="mutually exclusive"):
        engine.BatchEngine(DemodConfig(**KW), C, guard_nonfinite=True,
                           pipeline_depth=1, device="cpu")


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_batch_matches_stream_engines(pipeline):
    """tests/test_engine.py:178-193: a BatchEngine's channels equal C
    StreamEngines on the same streams, and the JAX BatchEngine."""
    C, kw = 4, dict(KW, num_avg=50, phase_avg=20)
    xs = [signal(400, seed=100 + i) for i in range(C)]
    engs = pair(C, pipeline, kw=kw, block_symbols=100)
    for c in range(C):
        push_both(engs, c, xs[c])
    outs = []
    while engs[0].ready():
        got, ref = engs[0].step(), engs[1].step()
        assert_outputs(got, ref, 2)
        outs.append(got)
    soft_b = np.concatenate([o.soft.numpy()[:, o.valid.numpy()[0]]
                             for o in outs], axis=1)
    for c in range(C):
        se = engine.StreamEngine(DemodConfig(**kw), 100, pipeline,
                                 device="cpu")
        out = se.process(streams.Packet(data=xs[c], sri=streams.SRI("s")))
        np.testing.assert_allclose(soft_b[c],
                                   out[streams.PORT_SOFT].data, atol=1e-5)


HETERO = [dict(KW), dict(KW, sps=10, constellation_size=2), dict(KW),
          dict(KW, sps=10, constellation_size=2, differential=True)]


def group_pair(cfgs, pipeline, **opts):
    return (engine.GroupEngine([DemodConfig(**k) for k in cfgs],
                               pipeline=pipeline, device="cpu", **opts),
            jengine.GroupEngine([JaxDemodConfig(**k) for k in cfgs],
                                pipeline=pipeline, **opts))


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_group_heterogeneous_sps(pipeline):
    """tests/test_engine_groups.py:39-63: groups bucketed by config,
    step_all and flush_all per channel as in JAX."""
    ge, jge = group_pair(HETERO, pipeline, block_symbols=64)
    assert len(ge.groups) == len(jge.groups) == 3
    assert ge.slot_of == jge.slot_of
    for ch, kw in enumerate(HETERO):
        x = signal(150, sps=kw["sps"], m=kw["constellation_size"],
                   seed=100 + ch)
        ge.push(ch, x)
        jge.push(ch, x)
    while True:
        got, ref = ge.step_all(), jge.step_all()
        assert set(got) == set(ref)
        if not got:
            break
        for ch in got:
            assert_outputs(got[ch], ref[ch], 2)
    got, ref = ge.flush_all(), jge.flush_all()
    assert set(got) == set(ref) == set(range(4))
    for ch in got:
        assert got[ch].valid.shape == (150 - 128,)
        assert_outputs(got[ch], ref[ch], 2)


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_group_packet_layer_and_configure(pipeline):
    """tests/test_engine_groups.py:102-131 at pipeline depth 1: per-group
    packets with rescaled SRIs and EOS, a partition-preserving configure
    mid-stream, merged port statistics; a configure that would split a
    group raises and leaves every group as it was."""
    ge, jge = group_pair(HETERO, pipeline, block_symbols=64,
                         pipeline_depth=1)
    ge.set_input_sri(streams.SRI("hetero", xdelta=1e-6), t=2.0)
    jge.set_input_sri(jstreams.SRI("hetero", xdelta=1e-6), t=2.0)
    sigs = [signal(256, sps=k["sps"], m=k["constellation_size"], seed=ch)
            for ch, k in enumerate(HETERO)]
    for b in range(4):
        if b == 2:
            new = [dict(k, phase_avg=6) for k in HETERO]
            ge.configure([DemodConfig(**k) for k in new])
            jge.configure([JaxDemodConfig(**k) for k in new])
        for ch, k in enumerate(HETERO):
            n = 64 * k["sps"]
            ge.push(ch, sigs[ch][b * n:(b + 1) * n])
            jge.push(ch, sigs[ch][b * n:(b + 1) * n])
        got, ref = ge.step_all_packets(), jge.step_all_packets()
        assert set(got) == set(ref)
        for gi in got:
            assert_packets_equal(got[gi], ref[gi])
            cfg = ge.groups[gi][0]
            assert got[gi][streams.PORT_SOFT].sri.xdelta == 1e-6 * cfg.sps
    got, ref = ge.flush_all_packets(), jge.flush_all_packets()
    assert set(got) == set(ref) == {0, 1, 2}
    for gi in got:
        assert_packets_equal(got[gi], ref[gi])
        assert got[gi][streams.PORT_SOFT].eos
    ps, jps = ge.port_stats, jge.port_stats
    assert set(ps) == set(jps)
    for port in ps:
        assert (ps[port].packets, ps[port].items, ps[port].bytes,
                ps[port].eos_count, ps[port].last_t) == (
            jps[port].packets, jps[port].items, jps[port].bytes,
            jps[port].eos_count, jps[port].last_t)
    before = [g[0] for g in ge.groups]
    split = [DemodConfig(**k) for k in HETERO]
    split[2] = DemodConfig(**dict(HETERO[2], phase_avg=12))
    with pytest.raises(ValueError, match="splits group 0"):
        ge.configure(split)
    assert [g[0] for g in ge.groups] == before
    with pytest.raises(ValueError, match="expected 4 configs"):
        ge.configure(split[:3])
    ge.reset()
    assert all(g[2].metrics.resets == 1 for g in ge.groups)


@pytest.mark.parametrize("make", [
    lambda: demod_init(DemodConfig(**KW)),
    lambda: engine.StreamEngine(DemodConfig(**KW)),
    lambda: engine.StreamEngine(DemodConfig(**KW), pipeline="exact"),
    lambda: engine.StreamRegistry(DemodConfig(**KW)).process(
        streams.Packet(data=signal(64), sri=streams.SRI("s"))),
    lambda: engine.BatchEngine(DemodConfig(**KW), 2, pipeline="exact"),
    lambda: engine.GroupEngine([DemodConfig(**k) for k in HETERO]),
], ids=["demod_init", "stream_ff", "stream_exact", "registry", "batch",
        "group"])
def test_engines_default_to_the_card(make):
    """No fallback: built without a device, a carry or an engine is on
    "cuda"; with no card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()
