"""Tracing and profiling hooks (port of ``psk_soft_tpu/utils/profiling.py``).

* :func:`trace` -- context manager around ``torch.profiler`` writing a
  Chrome/Perfetto trace into a directory.
* :class:`StepTimer` -- per-block wall-time stats (EWMA + max) for the
  streaming engines; cheap enough to leave on.  It reads the host clock
  around a block step; CUDA launches return before the card finishes, so
  on the card it measures the host's dispatch time, not the device's
  (the engines add no synchronise for it).
* :func:`annotate` -- named region for host-side phases: an NVTX range
  when CUDA is present, and a ``torch.profiler`` record either way.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces (and in NVTX on CUDA)."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield


class StepTimer:
    """EWMA / max / count wall-clock stats for repeated steps."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.ewma_s = None
        self.max_s = 0.0
        self.count = 0
        self._t0 = None

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.ewma_s = dt if self.ewma_s is None else (
            self.alpha * dt + (1 - self.alpha) * self.ewma_s)
        self.max_s = max(self.max_s, dt)
        self.count += 1

    def summary(self) -> dict:
        return {"count": self.count, "ewma_s": self.ewma_s,
                "max_s": self.max_s}
