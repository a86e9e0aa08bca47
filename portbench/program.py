"""The program's own spans and counters (``psk_soft_tpu_torch.utils.
profiling.TRACER``), read for the per-layer metrics that name them.

The measured window runs with the program's tracer off, as every untraced
run does.  After the profiled stretch, the first reader that asks
(``read(ctx)``) opens the cell's path afresh on the same capture, feeds
``warmup_blocks`` blocks, then ``STRETCH_PER_TRACE * trace_blocks`` more
in a closed loop with the tracer reset and on, and keeps its
``snapshot()`` as ``ctx.program``, with the blocks and input samples fed.
A program without the tracer gives None, and its readers read nothing.

The stretch's spans and counters, each a block, and the harness's engine
spans over the same blocks go to standard error as ``portbench program``.
"""

from __future__ import annotations

import importlib
import json
import sys

import torch

from .paths import Reservoir
from .spans import Spans

STRETCH_PER_TRACE = 4
ENGINE_SPANS = ("psk.engine.upload", "psk.engine.launch", "psk.engine.emit")


def read(ctx):
    """``ctx.program`` (computed on first call): ``{"spans": {name:
    {"seconds", "self_seconds", "count"}}, "counters": {name: n},
    "blocks": n, "samples": n}``, or None."""
    if not hasattr(ctx, "program"):
        ctx.program = _stretch(ctx)
    return ctx.program


def span_ms(ctx, name: str, key: str = "seconds"):
    """Milliseconds a block of the program span ``name`` (its ``key``:
    ``seconds`` or ``self_seconds``), or None."""
    prog = read(ctx)
    if not prog or name not in prog["spans"] or not prog["blocks"]:
        return None
    return 1e3 * prog["spans"][name][key] / prog["blocks"]


def _tracer():
    from psk_soft_tpu_torch.utils import profiling
    return getattr(profiling, "TRACER", None)


def _stretch(ctx):
    tracer = _tracer()
    if tracer is None:
        return None
    cell = ctx.cell
    traffic = cell.traffic
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    mod = importlib.import_module(f"portbench.paths.{traffic['entry']}")
    path = mod.Path(cell.config, traffic, ctx.pool, dev, Reservoir(0, 0))
    spans = Spans()
    warm = int(traffic["warmup_blocks"])
    blocks = STRETCH_PER_TRACE * int(traffic["trace_blocks"])
    samples = 0
    try:
        for b in range(warm):
            path.feed(b, spans)
        _sync(dev)
        spans.active = True
        tracer.reset()
        tracer.enable()
        for b in range(warm, warm + blocks):
            _, got = path.feed(b, spans)
            samples += got.get("samples", 0)
        _sync(dev)
        tracer.disable()
        prog = dict(tracer.snapshot(), blocks=blocks, samples=samples)
    finally:
        tracer.disable()
        tracer.reset()
        path.close()
    _report(ctx, prog, spans)
    return prog


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _report(ctx, prog, spans):
    n = prog["blocks"]
    engine_ms = 1e3 * spans.layer_seconds("engine") / n
    covered = sum(prog["spans"].get(k, {}).get("seconds", 0.0)
                  for k in ENGINE_SPANS)
    info = {
        "blocks": n, "samples": prog["samples"],
        "span_ms": {k: [1e3 * v["seconds"] / n, 1e3 * v["self_seconds"] / n]
                    for k, v in prog["spans"].items()},
        "counters": {k: v / n for k, v in prog["counters"].items()},
        "engine_ms": engine_ms,
        "window_engine_ms": (1e3 * ctx.spans.layer_seconds("engine")
                             / ctx.iterations if ctx.iterations else None),
        "spans_over_engine": (1e3 * covered / n / engine_ms
                              if engine_ms else None),
    }
    print(f"portbench program {json.dumps(info)}", file=sys.stderr)
