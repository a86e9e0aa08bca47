"""Port parity, the native packet queue: psk_soft_tpu_torch's
runtime/native_queue (NativePacketQueue over native/pskq.cpp, built by the
port into build/psk_soft_tpu_torch/, and FeedThread) against the JAX
package's, the same pushes into both.

Held equal: every popped packet (data, SRI, t, EOS, sriChanged,
inputQueueFlushed) and the queue statistics.  FeedThread drives the port's
StreamEngine on the CPU; its output packets equal JAX's StreamEngine fed
the same packets directly (bits and sample index exact, soft and phase
within 2e-3, the tolerance of tests/test_torch_stream_engine.py).
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from psk_soft_tpu import DemodConfig as JaxDemodConfig
from psk_soft_tpu.runtime import engine as jengine
from psk_soft_tpu.runtime import native_queue as jnq
from psk_soft_tpu.runtime import streams as jstreams
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime import engine, native_queue as tnq, streams
from psk_soft_tpu_torch.utils.build import BUILD_DIR

torch.set_num_threads(1)

TOL = 2e-3
KW = dict(sps=8, num_avg=30, constellation_size=4, phase_avg=15)


def _sri(mod, sid="nq", xdelta=0.01, mode=1):
    return mod.SRI(stream_id=sid, xdelta=xdelta, mode=mode)


def _assert_packet_equal(a, b):
    assert a is not None and b is not None
    assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
    np.testing.assert_array_equal(a.data, b.data)
    assert dataclasses.asdict(a.sri) == dataclasses.asdict(b.sri)
    assert (a.t, a.eos, a.sri_changed, a.input_queue_flushed) == (
        b.t, b.eos, b.sri_changed, b.input_queue_flushed)


def test_library_built_by_the_port():
    """The port's library is compiled from native/pskq.cpp into
    build/psk_soft_tpu_torch/; the JAX package's native/libpskq.so is not
    the one loaded."""
    lib = tnq._load_lib()
    assert lib._name.startswith(str(BUILD_DIR))
    assert "libpskq" not in lib._name


PUSHES = [
    (np.arange(8) + 1j * np.arange(8), dict(sid="a", xdelta=0.01), 1.5,
     False, False),
    (np.arange(6, dtype=np.float32), dict(sid="r", mode=0), 0.0, False,
     True),
    (np.zeros(0, np.complex64), dict(sid="e", xdelta=0.5), 3.0, True,
     False),
    ((np.random.default_rng(0).standard_normal(300)
      + 1j).astype(np.complex64), dict(sid="long-stream-id" * 4), 7.25,
     False, True),
]


def test_roundtrip_matches_jax():
    """Complex and real-mode packets, an empty EOS packet and a long
    stream ID come out of both queues alike, in order."""
    q, jq = tnq.NativePacketQueue(), jnq.NativePacketQueue()
    for data, sri, t, eos, sric in PUSHES:
        for mod, qq in ((streams, q), (jstreams, jq)):
            assert not qq.push(data, _sri(mod, **sri), t=t, eos=eos,
                               sri_changed=sric)
    assert q.depth() == jq.depth() == len(PUSHES)
    for _ in PUSHES:
        _assert_packet_equal(q.pop(timeout=1.0), jq.pop(timeout=1.0))
    assert dataclasses.asdict(q.stats()) == dataclasses.asdict(jq.stats())
    q.close()
    jq.close()


def test_pop_timeout_is_a_deadline():
    q = tnq.NativePacketQueue()
    t0 = time.monotonic()
    assert q.pop(timeout=0.05) is None
    dt = time.monotonic() - t0
    assert 0.04 <= dt < 2.0
    q.close()


@pytest.mark.parametrize("cap,maxp,n", [(1024, 4, 3), (1 << 20, 2, 5)])
def test_overflow_flush_matches_jax(cap, maxp, n):
    """A push onto a full queue (by bytes or by packet count) drops the
    backlog and flags the next delivered packet, as in JAX."""
    q, jq = tnq.NativePacketQueue(cap, maxp), jnq.NativePacketQueue(cap, maxp)
    flags = []
    for i in range(n):
        x = np.full(64, i, np.complex64)             # 512 bytes each
        flags.append((q.push(x, _sri(streams)), jq.push(x, _sri(jstreams))))
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert any(a for a, _ in flags)
    while q.depth():
        _assert_packet_equal(q.pop(timeout=1.0), jq.pop(timeout=1.0))
    st, jst = q.stats(), jq.stats()
    assert isinstance(st, tnq.QueueStats)
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert st.flushes >= 1 and st.dropped_packets >= 1


def test_pop_trims_and_repeeks():
    """_pop_exact trims to the floats actually copied (a stale, larger
    peek) and returns None for a buffer too small (the packet stays queued
    and pop re-peeks its true size)."""
    q = tnq.NativePacketQueue()
    q.push(np.arange(6, dtype=np.float32).view(np.complex64),
           _sri(streams, mode=1))
    pkt = q._pop_exact(64)
    assert pkt.data.size == 3
    np.testing.assert_array_equal(pkt.data.view(np.float32),
                                  np.arange(6, dtype=np.float32))
    q.push(np.arange(8, dtype=np.float32), _sri(streams, mode=0))
    assert q._pop_exact(4) is None
    pkt = q.pop(timeout=1.0)
    assert pkt is not None and pkt.data.size == 8
    q.close()


def test_blocking_pop_wakes_on_push():
    q = tnq.NativePacketQueue()
    got = {}

    def consumer():
        got["pkt"] = q.pop(timeout=5.0)

    th = threading.Thread(target=consumer)
    th.start()
    time.sleep(0.05)
    q.push(np.ones(4, np.complex64), _sri(streams))
    th.join(timeout=5.0)
    assert not th.is_alive()
    assert got["pkt"] is not None and got["pkt"].data.size == 4
    q.close()


def test_concurrent_producers():
    """16 producer threads (more than the cores) against one consumer with
    a short switch interval: every packet arrives once, unmixed."""
    q = tnq.NativePacketQueue(capacity_bytes=64 << 20, max_packets=4096)
    n_threads, per = 16, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def producer(tid):
            for k in range(per):
                q.push(np.full(64, tid * 1000 + k, np.complex64),
                       _sri(streams, sid=f"t{tid}"))

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        seen = set()
        for _ in range(n_threads * per):
            pkt = q.pop(timeout=5.0)
            assert pkt is not None
            vals = np.unique(pkt.data)
            assert vals.size == 1
            assert pkt.sri.stream_id == f"t{int(vals[0].real) // 1000}"
            seen.add(complex(vals[0]))
        for t in threads:
            t.join(timeout=5.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(seen) == n_threads * per
    st = q.stats()
    assert st.pushed == st.popped == n_threads * per and st.flushes == 0
    q.close()


def _signal(nsym, seed=0):
    """QPSK with all energy on sample 3 of each symbol (a decisive timing
    peak) and real noise of std 0.02."""
    rng = np.random.default_rng(seed)
    pts = np.exp(2j * np.pi * rng.integers(0, 4, nsym) / 4)
    x = np.zeros(nsym * 8, np.complex128)
    x[3::8] = pts
    return (x + 0.02 * rng.standard_normal(x.size)).astype(np.complex64)


def _assert_outputs_equal(got, ref):
    assert set(got) == set(ref)
    for port in got:
        assert len(got[port]) == len(ref[port]), port
        for a, b in zip(got[port], ref[port]):
            assert dataclasses.asdict(a.sri) == dataclasses.asdict(b.sri)
            assert (a.t, a.eos, a.sri_changed) == (b.t, b.eos, b.sri_changed)
            assert a.data.dtype == b.data.dtype
            if port in (streams.PORT_BITS, streams.PORT_SAMPLE_INDEX):
                np.testing.assert_array_equal(a.data, b.data, err_msg=port)
            else:
                np.testing.assert_allclose(a.data, b.data, atol=TOL,
                                           err_msg=port)


def _jax_outputs(packets):
    jeng = jengine.StreamEngine(JaxDemodConfig(**KW), 64)
    out = {}
    for p in packets:
        pkt = jstreams.Packet(data=p.data, sri=jstreams.SRI(
            stream_id=p.sri.stream_id, xdelta=p.sri.xdelta,
            mode=p.sri.mode), t=p.t, eos=p.eos,
            sri_changed=p.sri_changed,
            input_queue_flushed=p.input_queue_flushed)
        for port, o in jeng.process(pkt).items():
            out.setdefault(port, []).append(o)
    return out, jeng


def test_feed_thread_end_to_end_matches_jax():
    """Producer thread -> queue -> FeedThread -> the port's StreamEngine:
    the outputs equal JAX's StreamEngine over the packets the queue
    delivered."""
    q = tnq.NativePacketQueue()
    eng = engine.StreamEngine(DemodConfig(**KW), 64, device="cpu")
    delivered = []
    proc = eng.process

    def recording(pkt):
        delivered.append(pkt)
        return proc(pkt)

    eng.process = recording
    feeder = tnq.FeedThread(q, eng)
    feeder.start()
    x = _signal(500)
    segs = np.split(x, 10)

    def producer():
        for i, seg in enumerate(segs):
            q.push(seg, _sri(streams), t=i * 4.0, eos=(i == 9))

    th = threading.Thread(target=producer)
    th.start()
    th.join(timeout=10.0)
    feeder.join(timeout=60.0)
    assert not feeder.is_alive()
    assert q.stats().popped == 10 and len(delivered) == 10
    ref, jeng = _jax_outputs(delivered)
    _assert_outputs_equal(feeder.outputs, ref)
    soft = np.concatenate([p.data for p in
                           feeder.outputs[streams.PORT_SOFT]])
    assert soft.size == 500 - (KW["num_avg"] - 1)
    assert dataclasses.asdict(eng.metrics) == dataclasses.asdict(jeng.metrics)


def test_feed_thread_overflow_resets_engine():
    """An overflow flush flags the next packet; the engine fed by the
    FeedThread resets, as JAX's does on the same packets."""
    q = tnq.NativePacketQueue(capacity_bytes=3 * 64 * 8 * 8, max_packets=64)
    x = _signal(64 * 6, seed=3)
    segs = np.split(x, 6)                     # 4096 bytes each
    for i, seg in enumerate(segs[:4]):        # the 4th push flushes
        q.push(seg, _sri(streams), t=float(i))
    eng = engine.StreamEngine(DemodConfig(**KW), 64, device="cpu")
    delivered = []
    proc = eng.process
    eng.process = lambda p: (delivered.append(p), proc(p))[1]
    feeder = tnq.FeedThread(q, eng)
    feeder.start()
    for i, seg in enumerate(segs[4:], start=4):
        q.push(seg, _sri(streams), t=float(i), eos=(i == 5))
    feeder.join(timeout=60.0)
    assert not feeder.is_alive()
    assert [p.input_queue_flushed for p in delivered] == [True, False, False]
    assert eng.metrics.resets == 1 and q.stats().flushes == 1
    ref, jeng = _jax_outputs(delivered)
    _assert_outputs_equal(feeder.outputs, ref)
    assert dataclasses.asdict(eng.metrics) == dataclasses.asdict(jeng.metrics)


def test_feed_thread_surfaces_exception():
    class Broken:
        def process(self, pkt):
            raise RuntimeError("engine failed")

    q = tnq.NativePacketQueue()
    feeder = tnq.FeedThread(q, Broken(), poll_timeout=0.01)
    feeder.start()
    q.push(np.ones(8, np.complex64), _sri(streams))
    with pytest.raises(RuntimeError, match="engine failed"):
        feeder.join(timeout=10.0)
    assert not feeder.is_alive()


def test_feed_thread_stop():
    q = tnq.NativePacketQueue()
    feeder = tnq.FeedThread(q, engine.StreamEngine(DemodConfig(**KW), 64,
                                                   device="cpu"),
                            poll_timeout=0.01)
    feeder.start()
    feeder.stop()
    feeder.join(timeout=5.0)
    assert not feeder.is_alive() and feeder.outputs == {}
