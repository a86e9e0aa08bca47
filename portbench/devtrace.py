"""Reads a ``torch.profiler`` trace of the traced stretch: the device's
busy time (the union of its kernels, copies and memsets), the stretch's
length, each device operation's time and count, and the idle gaps split by
the harness span the host was in (``spans.Spans`` marks each call into the
program, and ``STRETCH`` each block of the stretch).  Host and device
events share the profiler's clock."""

from __future__ import annotations

from typing import NamedTuple

STRETCH = "portbench.block"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_IDLE = "harness"          # a gap while the host was in no span


class Trace(NamedTuple):
    busy_s: float
    window_s: float
    ops: dict                  # device op name -> [seconds, count]
    idle: dict                 # host span name -> idle device seconds


def _is_device(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if callable(kind):
        return kind() in DEVICE_ACTIVITIES
    return "CUDA" in str(e.device_type()) and not e.is_user_annotation()


def _union(iv: list) -> list:
    out: list = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def read(prof, span_names) -> Trace | None:
    """The trace of the blocks marked ``STRETCH``; None if the profiler
    recorded no device activity in them."""
    blocks, spans, dev = [], [], []
    names = set(span_names)
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if _is_device(e):
            dev.append((s, t, e.name()))
        elif e.name() == STRETCH:
            blocks.append((s, t))
        elif e.name() in names:
            spans.append((s, t, e.name()))
    if not blocks:
        return None
    w0 = min(s for s, _ in blocks)
    w1 = max(t for _, t in blocks)
    ops: dict = {}
    iv = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        iv.append((s, t))
        acc = ops.setdefault(name, [0.0, 0])
        acc[0] += (t - s) * 1e-9
        acc[1] += 1
    if not iv:
        return None
    busy = _union(iv)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if prev < w1:
        gaps.append((prev, w1))
    idle: dict = {}
    spans.sort()
    for g0, g1 in gaps:
        covered = 0
        for s, t, name in spans:
            if t <= g0 or s >= g1:
                continue
            ov = min(t, g1) - max(s, g0)
            idle[name] = idle.get(name, 0.0) + ov * 1e-9
            covered += ov
        rest = (g1 - g0) - covered
        if rest > 0:
            idle[HOST_IDLE] = idle.get(HOST_IDLE, 0.0) + rest * 1e-9
    return Trace(sum(t - s for s, t in busy) * 1e-9, (w1 - w0) * 1e-9, ops,
                 idle)


def top(d: dict, n: int = 10) -> list:
    """[[name, seconds], ...] of the n largest."""
    items = [(k, v[0] if isinstance(v, list) else v) for k, v in d.items()]
    return [[k, v] for k, v in sorted(items, key=lambda kv: -kv[1])[:n]]
