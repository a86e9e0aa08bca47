"""Tracing and profiling hooks (port of ``psk_soft_tpu/utils/profiling.py``).

* :data:`TRACER` -- the port's one tracer, off by default: named spans
  (host time with self time, and a ``torch.profiler`` record while a
  profiler records) and counters, placed at the bank engines' internal
  boundaries (``runtime/engine_full``, ``runtime/engine_bank``):

  ==========================  ======================================
  ``psk.engine.upload``       plane staging and the host-to-device copy
  ``psk.engine.launch``       kernel B1's host dispatch
  ``psk.engine.emit``         tap, assembly and port statistics of one
                              block; its self time is the assembly
  ``psk.engine.fetch``        the device-to-host fetches of one block,
                              any wait for the device included
  ``psk.engine.h2d_bytes``,   bytes and copies of the plane uploads
  ``psk.engine.h2d_copies``   (from another device than the engine's)
  ``psk.engine.d2h_bytes``,   bytes and copies fetched by
  ``psk.engine.d2h_copies``   ``engine_bank.to_host``
  ==========================  ======================================

  A span's ``block`` is the engine's count of steady blocks, the
  identifier that one block's spans share.
* :func:`trace` -- context manager around ``torch.profiler`` writing a
  Chrome/Perfetto trace into a directory.
* :func:`annotate` -- a named span of :data:`TRACER`.

Host stamps are ``time.perf_counter_ns()``, whose origin is not the
profiler's: a span is placed in a device trace only by its own profiler
record, never by its stamps.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host (and, with CUDA, device) profile into ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class _Off:
    """The span while the tracer is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "block", "t0", "child_ns", "rf", "nvtx")

    def __init__(self, tracer: "Tracer", name: str, block):
        self.tracer, self.name, self.block = tracer, name, block

    def __enter__(self):
        tr = self.tracer
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(
                self.name, None if self.block is None else str(self.block))
            self.rf.__enter__()
        self.nvtx = tr._nvtx
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.child_ns = 0
        tr._stack().append(self)
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        dt = tr.clock() - self.t0
        stack = tr._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += dt
        with tr._lock:
            acc = tr.spans.setdefault(self.name, [0, 0, 0])
            acc[0] += dt
            acc[1] += dt - self.child_ns
            acc[2] += 1
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """Named spans and counters, in memory, read by :meth:`snapshot`.

    Off (the default), :meth:`span` returns one shared no-op object after
    one attribute test and :meth:`count` returns at once: no clock
    reading, no allocation, no torch call.  On, a span adds its host
    duration and self time (its duration less its children's, children
    taken from a per-thread stack) to its name's totals; while a
    ``torch.profiler`` records it is also a ``record_function`` of its
    name, with ``block`` as the record's args; with CUDA it is an NVTX
    range too."""

    def __init__(self, clock=time.perf_counter_ns):
        self.on = False
        self.clock = clock
        self._nvtx = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def enable(self) -> None:
        self._nvtx = torch.cuda.is_available()
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        """Forget every total and counter (open spans still close)."""
        with self._lock:
            self.spans: dict[str, list] = {}   # name -> [ns, self ns, count]
            self.counters: dict[str, int] = {}

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, block=None):
        """Context manager timing ``name`` (``block``: the block's
        ordinal, or None)."""
        if not self.on:
            return _OFF
        return _Span(self, name, block)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def snapshot(self) -> dict:
        """``{"spans": {name: {"seconds", "self_seconds", "count"}},
        "counters": {name: n}}``."""
        with self._lock:
            return {"spans": {k: {"seconds": v[0] * 1e-9,
                                  "self_seconds": v[1] * 1e-9,
                                  "count": v[2]}
                              for k, v in self.spans.items()},
                    "counters": dict(self.counters)}


TRACER = Tracer()


def annotate(name: str):
    """Named region: a span of :data:`TRACER` (a profiler record and an
    NVTX range while the tracer is on)."""
    return TRACER.span(name)
