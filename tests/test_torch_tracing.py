"""The port's tracer (psk_soft_tpu_torch/utils/profiling.py) and its spans
in the bank engines, on the CPU:

* spans nest, and a span's self time is its duration less its children's
  (a stubbed clock); counters add; ``reset`` forgets both;
* off, the tracer records nothing, reads no clock and makes no torch call;
* under a CPU ``torch.profiler``, each span is a ``record_function`` of its
  name inside the caller's;
* ``FullKernelBatchEngine`` at 128 channels, depths 0 and 1: upload,
  launch and emit once a steady block, fetch inside emit, and the packets
  bit-equal to a run with the tracer off.
"""

import numpy as np
import pytest
import torch

from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
from psk_soft_tpu_torch.utils.profiling import TRACER, Tracer, annotate

torch.set_num_threads(1)

C, S = 128, 256
CFG = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
ENGINE_SPANS = ("psk.engine.upload", "psk.engine.launch", "psk.engine.emit",
                "psk.engine.fetch")


@pytest.fixture(autouse=True)
def tracer_off():
    TRACER.disable()
    TRACER.reset()
    yield
    TRACER.disable()
    TRACER.reset()


def test_nesting_and_self_time():
    ticks = iter([0, 10, 40, 50, 60, 100, 200, 230])
    tr = Tracer(clock=lambda: next(ticks))
    tr.enable()
    with tr.span("outer", block=7):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            pass
    with tr.span("inner"):
        pass
    snap = tr.snapshot()["spans"]
    assert snap["outer"] == {"seconds": pytest.approx(100e-9),
                             "self_seconds": pytest.approx(60e-9),
                             "count": 1}
    assert snap["inner"] == {"seconds": pytest.approx(70e-9),
                             "self_seconds": pytest.approx(70e-9),
                             "count": 3}


def test_counters_and_reset():
    tr = Tracer()
    tr.count("bytes", 5)
    tr.enable()
    tr.count("bytes", 3)
    tr.count("bytes", 4)
    tr.count("copies")
    with tr.span("s"):
        pass
    assert tr.snapshot()["counters"] == {"bytes": 7, "copies": 1}
    tr.disable()
    tr.count("bytes", 100)
    assert tr.snapshot()["counters"]["bytes"] == 7
    tr.reset()
    assert tr.snapshot() == {"spans": {}, "counters": {}}


def test_off_records_nothing_and_calls_no_torch(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while the tracer is off")

    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    tr = Tracer(clock=boom)
    first = tr.span("a", 1)
    assert tr.span("b") is first and annotate("c") is first
    with tr.span("a", 1):
        with annotate("c"):
            tr.count("n", 3)
    assert tr.snapshot() == {"spans": {}, "counters": {}}


def _events(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def test_spans_are_profiler_records():
    from torch.profiler import ProfilerActivity, profile, record_function

    TRACER.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            with TRACER.span("psk.test.outer", block=3):
                with annotate("psk.test.inner"):
                    torch.ones(4).sum()
    with TRACER.span("psk.test.outer"):       # no profiler: no record
        pass
    ev = {n: (s, t) for n, s, t in _events(prof)}
    assert {"caller", "psk.test.outer", "psk.test.inner"} <= set(ev)
    for child, parent in (("psk.test.outer", "caller"),
                          ("psk.test.inner", "psk.test.outer")):
        assert ev[parent][0] <= ev[child][0] <= ev[child][1] <= ev[parent][1]
    assert TRACER.snapshot()["spans"]["psk.test.outer"]["count"] == 2


def _run(depth, blocks, warm, traced):
    """Packets of ``blocks`` blocks through a CPU engine; with ``traced``
    the tracer is reset and on after ``warm`` blocks."""
    eng = FullKernelBatchEngine(CFG, C, block_symbols=S,
                                pipeline_depth=depth, device="cpu")
    rng = np.random.default_rng(20)
    out = []
    for b in range(blocks):
        if traced and b == warm:
            TRACER.reset()
            TRACER.enable()
        re, im = (torch.from_numpy(rng.standard_normal(
            (S * CFG.sps, C)).astype(np.float32)) for _ in range(2))
        eng.push_planes(re, im)
        out.append(eng.step_packets())
    TRACER.disable()
    return out


@pytest.mark.parametrize("depth", [0, 1])
def test_engine_spans(depth):
    from torch.profiler import ProfilerActivity, profile

    warm, steady = 2, 3
    plain = _run(depth, warm + steady, warm, traced=False)
    assert TRACER.snapshot() == {"spans": {}, "counters": {}}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _run(depth, warm + steady, warm, traced=True)
    snap = TRACER.snapshot()["spans"]
    assert set(snap) == set(ENGINE_SPANS)
    for name in ENGINE_SPANS:
        assert snap[name]["count"] == steady, name
    emit, fetch = snap["psk.engine.emit"], snap["psk.engine.fetch"]
    assert emit["seconds"] - emit["self_seconds"] == pytest.approx(
        fetch["seconds"], abs=1e-9)
    ev = _events(prof)
    emits = [(s, t) for n, s, t in ev if n == "psk.engine.emit"]
    fetches = [(s, t) for n, s, t in ev if n == "psk.engine.fetch"]
    assert len(fetches) == steady
    assert all(any(s0 <= s and t <= t0 for s0, t0 in emits)
               for s, t in fetches)
    assert [p is None for p in traced] == [p is None for p in plain]
    for a, b in zip(plain, traced):
        if a is None:
            continue
        assert a.keys() == b.keys()
        for port in a:
            np.testing.assert_array_equal(a[port].data, b[port].data)
            assert a[port].t == b[port].t
