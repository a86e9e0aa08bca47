"""Port parity, single-stream service path: psk_soft_tpu_torch's
StreamEngine (feed-forward and exact pipelines) and StreamRegistry against
the JAX engines, the same packet sequence into both, in the cases of
tests/test_engine.py:35-176 (packetization, real mode, queue flush, SRI
rate change, EOS with and without a final partial block, reconfigure,
timestamps, the switch to the steady program).

Held equal: the ports of every output packet, their SRIs, timestamps, EOS
and sriChanged flags, bits and sample index, the engine metrics and the
per-port statistics' counts; soft and phase within 2e-3 (the JAX package's
tolerance, tests/test_oracle_parity.py:45-47).  Signals have a decisive
timing peak, so the sample index is defined (see test_torch_exact.py).
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

torch.set_num_threads(1)

TOL = 2e-3
SPS = 8
KW = dict(sps=SPS, num_avg=30, constellation_size=4, phase_avg=15)
EXACT_PORTS = (streams.PORT_BITS, streams.PORT_SAMPLE_INDEX)


def signal(nsym, seed=0, m=4, foff=5e-5):
    """QPSK (or M-PSK) with all energy on sample 3 of each symbol, a
    small frequency offset and real noise of std 0.02."""
    rng = np.random.default_rng(seed)
    pts = np.exp(2j * np.pi * rng.integers(0, m, nsym) / m)
    x = np.zeros(nsym * SPS, np.complex128)
    x[3::SPS] = pts * np.exp(2j * np.pi * foff * SPS * np.arange(nsym))
    return (x + 0.02 * rng.standard_normal(x.size)).astype(np.complex64)


def packets(x, chunk, sid="s1", xdelta=0.01, t0=0.0, eos=True, **kw):
    """Packet specs of x in chunks (the last one EOS when ``eos``)."""
    out = []
    for i in range(0, len(x), chunk):
        out.append(dict(data=x[i:i + chunk], sid=sid, xdelta=xdelta,
                        t=t0 + i * xdelta,
                        eos=eos and i + chunk >= len(x), **kw))
    return out


def make_packet(mod, spec):
    sri = mod.SRI(stream_id=spec["sid"], xdelta=spec["xdelta"],
                  mode=spec.get("mode", 1))
    return mod.Packet(data=spec["data"], sri=sri, t=spec["t"],
                      eos=spec["eos"],
                      input_queue_flushed=spec.get("flushed", False))


def drive(eng, mod, cfg_cls, script):
    """Run a script of packet specs and ("configure", kw) steps; returns
    the list of output dicts."""
    outs = []
    for step in script:
        if isinstance(step, tuple):
            eng.configure(cfg_cls(**step[1]))
        else:
            outs.append(eng.process(make_packet(mod, step)))
    return outs


def assert_packets_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for port in g:
            a, b = g[port], r[port]
            assert dataclasses.asdict(a.sri) == dataclasses.asdict(b.sri)
            assert (a.t, a.eos, a.sri_changed) == (b.t, b.eos, b.sri_changed)
            da, db = np.asarray(a.data), np.asarray(b.data)
            assert da.dtype == db.dtype and da.shape == db.shape, port
            if port in EXACT_PORTS:
                np.testing.assert_array_equal(da, db, err_msg=port)
            else:
                np.testing.assert_allclose(da, db, atol=TOL, err_msg=port)


def assert_stats_equal(got, ref):
    assert set(got) == set(ref)
    for port in got:
        a, b = got[port], ref[port]
        assert (a.packets, a.items, a.bytes, a.eos_count, a.last_t) == (
            b.packets, b.items, b.bytes, b.eos_count, b.last_t), port


def run_both(pipeline, script, kw=KW, block_symbols=64):
    eng = engine.StreamEngine(DemodConfig(**kw), block_symbols, pipeline,
                              device="cpu")
    jeng = jengine.StreamEngine(JaxDemodConfig(**kw), block_symbols,
                                pipeline)
    got = drive(eng, streams, DemodConfig, script)
    ref = drive(jeng, jstreams, JaxDemodConfig, script)
    assert_packets_equal(got, ref)
    assert dataclasses.asdict(eng.metrics) == dataclasses.asdict(jeng.metrics)
    assert_stats_equal(eng.port_stats, jeng.port_stats)
    return eng, got


def _scripts():
    x = signal(400)
    half = len(x) // 2
    return {
        # Arbitrary packetization (tests/test_engine.py:35-54).
        "oneshot": packets(x, len(x)),
        "chunks_777": packets(x, 777),
        "chunks_130": packets(x, 130),
        # cpp/psk_soft.cpp:359-363: real data dropped and counted.
        "real_mode": (packets(x[:1000], 1000, eos=False)
                      + [dict(data=np.ones(800, np.complex64), sid="s1",
                              xdelta=0.01, t=10.0, eos=False, mode=0)]
                      + packets(x[1000:], 1000, t0=10.0)),
        # cpp/psk_soft.cpp:353-357: queue flush -> full reset.
        "flush": (packets(x[:2400], 800, eos=False)
                  + packets(x[2400:], 800, t0=24.0, flushed=True)[:1]
                  + packets(x[3200:], 800, t0=32.0)),
        # xdelta change: phase-only reset, re-anchored timestamps.
        "xdelta": (packets(x[:half], 700, eos=False)
                   + packets(x[half:], 700, xdelta=0.02, t0=16.0)),
        # EOS drains the remaining whole symbols below the block size.
        "eos_partial": packets(signal(130, seed=1)[:130 * SPS - 5], 1040),
        # EOS with nothing to emit still reaches every port.
        "eos_empty": (packets(x[:80], 80, eos=False)
                      + [dict(data=np.zeros(0, np.complex64), sid="s1",
                              xdelta=0.01, t=0.8, eos=True)]),
        # Live reconfigure (tests/test_engine.py:119-145).
        "reconf_phase_avg": (packets(x[:2400], 2400, eos=False)
                             + [("configure", dict(KW, phase_avg=8))]
                             + packets(x[2400:], 400, t0=24.0)),
        "reconf_m": (packets(x[:1200], 1200, eos=False)
                     + [("configure", dict(KW, constellation_size=8))]
                     + packets(x[1200:], 900, t0=12.0)),
        "reconf_num_avg_sps": (
            packets(x[:1600], 1600, eos=False)
            + [("configure", dict(KW, num_avg=20))]
            + packets(x[1600:2400], 800, t0=16.0, eos=False)
            + [("configure", dict(KW, num_avg=20, sps=4))]
            + packets(x[2400:], 640, t0=24.0)),
        # Timestamps track emitted symbols (tests/test_engine.py:148-159).
        "timestamps": packets(x, half, t0=5.0),
    }


SCRIPTS = _scripts()


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_stream_engine_matches_jax(pipeline, name):
    eng, got = run_both(pipeline, SCRIPTS[name],
                        block_symbols=512 if name == "eos_partial" else 64)
    if name == "eos_partial":
        assert got[-1][streams.PORT_SOFT].data.size == 130 - 1 - 29
    if name.startswith("eos") or name == "oneshot":
        assert all(p.eos for p in got[-1].values()) and len(got[-1]) == 4
    if name == "real_mode":
        assert eng.metrics.real_mode_drops == 1
    if name == "flush":
        assert eng.metrics.resets == 1


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_steady_switch_matches_jax(pipeline):
    """The feed-forward engine switches to the assume_steady program
    mid-stream (tests/test_engine.py:162-176); the exact one never does.
    Both match the JAX engines, and the switch leaves bits unchanged
    against a never-steady run."""
    kw = dict(sps=SPS, num_avg=40, constellation_size=4, phase_avg=20)
    x = signal(1200, seed=4)
    _, got = run_both(pipeline, packets(x, len(x)), kw=kw, block_symbols=64)
    _, whole = run_both(pipeline, packets(x, len(x)), kw=kw,
                        block_symbols=2048)
    np.testing.assert_array_equal(got[0][streams.PORT_BITS].data,
                                  whole[0][streams.PORT_BITS].data)


def test_sri_propagation_matches_jax():
    """Rate rescaling (cpp/psk_soft.cpp:393-404) for every M."""
    for m in (2, 4, 8):
        kw = dict(KW, constellation_size=m)
        got = streams.propagate_sri(DemodConfig(**kw),
                                    streams.SRI("s", xdelta=0.01))
        ref = jstreams.propagate_sri(JaxDemodConfig(**kw),
                                     jstreams.SRI("s", xdelta=0.01))
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in ref.items()}


@pytest.mark.parametrize("pipeline", ["ff", "exact"])
def test_stream_registry_matches_jax(pipeline):
    """Three interleaved streams, one retired by EOS mid-run, then a
    registry-wide configure while the other two go on."""
    xs = {f"s{i}": signal(260, seed=10 + i) for i in range(3)}
    feeds = {sid: packets(x, 520, sid=sid, xdelta=0.001 * (i + 1), eos=False)
             for i, (sid, x) in enumerate(xs.items())}
    feeds["s1"] = feeds["s1"][:2] + [dict(feeds["s1"][2], eos=True)]
    order = []
    for k in range(max(len(f) for f in feeds.values())):
        order += [f[k] for f in feeds.values() if k < len(f)]
        if k == 2:
            order.append(("configure", dict(KW, phase_avg=10)))
    reg = engine.StreamRegistry(DemodConfig(**KW), 64, pipeline,
                                device="cpu")
    jreg = jengine.StreamRegistry(JaxDemodConfig(**KW), 64, pipeline)
    got = drive(reg, streams, DemodConfig, order)
    ref = drive(jreg, jstreams, JaxDemodConfig, order)
    assert_packets_equal(got, ref)
    assert sorted(reg.engines) == sorted(jreg.engines) == ["s0", "s2"]
    for sid in reg.engines:
        assert dataclasses.asdict(reg.engines[sid].metrics) == \
            dataclasses.asdict(jreg.engines[sid].metrics)
    with pytest.raises(RuntimeError, match="stream limit"):
        small = engine.StreamRegistry(DemodConfig(**KW), 64, pipeline,
                                      max_streams=1, device="cpu")
        for sid in ("a", "b"):
            small.process(make_packet(streams, packets(
                xs["s0"][:64], 64, sid=sid, eos=False)[0]))
