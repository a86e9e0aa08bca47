"""The harness's spans: a host-clock timer around each call into the
program, named ``<layer>.<call>``.  While ``active`` each span adds its
seconds to ``total[name]``; while ``profiling`` it is also a
``torch.profiler.record_function`` of the same name, so a device trace can
say what the host was doing in each idle gap."""

from __future__ import annotations

import time


class Spans:
    def __init__(self):
        self.active = False
        self.profiling = False
        self.total: dict[str, float] = {}
        self.names: set[str] = set()

    def __call__(self, name: str) -> "_Span":
        self.names.add(name)
        return _Span(self, name)

    def layer_seconds(self, layer: str) -> float:
        """Seconds in every span of ``layer`` while active."""
        return sum(v for k, v in self.total.items()
                   if k.split(".", 1)[0] == layer)


class _Span:
    __slots__ = ("spans", "name", "t0", "rf")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        if self.spans.profiling:
            from torch.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.spans.profiling:
            self.rf.__exit__(*exc)
        if self.spans.active:
            self.spans.total[self.name] = self.spans.total.get(self.name,
                                                               0.0) + dt
        return False
