"""Runs one cell of the port's benchmark once, on an NVIDIA GPU:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It makes the cell's capture from ``--seed``
(``pool.py``), brings up the cell's served path (``paths/<entry>.py``) on
the card, warms it up over the traffic mix's ``warmup_blocks``, then feeds
blocks in a closed loop, the next as soon as the last call returned, for
``--seconds``: the measured window.  After it, with ``--trace 1``, it feeds
``trace_blocks`` more under ``torch.profiler`` (the first two unrecorded).
Then it frees the program's state, checks what the window delivered
against the plain reference (``check.py``) and prints one JSON line last
on standard output: ``correct``, ``attempted`` and ``failed`` (blocks
delivered in the window, and of them the malformed), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, each
compared number beside its limit, which also end standard error.

End-to-end metrics, all by the host clock over the window:
``<work>_per_s``, the work that the path counts in what reached the user,
over the window (``samples_per_s``: the input samples of the blocks whose
outputs came back); ``block_ms_p95``, the 95th
percentile of each block's trip, from its hand-off to the bank to the
return of the call that gave its outputs to the user, over every block fed
and delivered in the window; ``setup_s``, process start to the first timed
block.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell's chips), and if JAX, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, devtrace  # noqa: E402
from .manifest import Manifest  # noqa: E402
from .paths import Reservoir  # noqa: E402
from .pool import make_pool  # noqa: E402
from .spans import Spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "psk_soft_tpu")
PROFILER_WARMUP = 2


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``psk_soft_tpu_torch`` is the port)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class NoDeviceTrace(RuntimeError):
    """The traced stretch recorded no device activity."""


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple[dict, dict]:
    """One run of ``cell``: (the result line, information for the log)."""
    config, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    pool = make_pool(config, traffic, seed, dev)
    mod = importlib.import_module(f"portbench.paths.{traffic['entry']}")
    path = mod.Path(config, traffic, pool, dev,
                    Reservoir(seed, traffic["check_blocks"]))
    spans = Spans()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    b = 0
    starts: dict = {}
    for _ in range(int(traffic["warmup_blocks"])):
        starts[b] = time.perf_counter()
        path.feed(b, spans)
        b += 1
    sync()
    gc.collect()
    spans.active = path.window = True
    trips, units, delivered, failed = [], {}, 0, 0
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    ends = []
    while True:
        t0 = time.perf_counter()
        starts[b] = t0
        d, got = path.feed(b, spans)
        t1 = time.perf_counter()
        ends.append(t1)
        b += 1
        if d is not None:
            delivered += 1
            failed += got.pop("failed", 0)
            for k, v in got.items():
                units[k] = units.get(k, 0) + v
            if starts.get(d, 0.0) >= t_open:
                trips.append(t1 - starts[d])
        if t1 - t_open >= seconds:
            break
    window_s = t1 - t_open
    spans.active = path.window = False
    sync()
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    iterations = len(ends)
    e2e = {f"{k}_per_s": v / window_s for k, v in units.items()}
    e2e.update({
        "block_ms_p95": (1e3 * statistics.quantiles(trips, n=20)[-1]
                         if len(trips) >= 2 else None),
        "setup_s": setup_s,
    })

    ctx = SimpleNamespace(cell=cell, pool=pool, iterations=iterations,
                          spans=spans, trace=None, ports=path.ports,
                          roofline=cell.man.roofline)
    if trace:
        ctx.trace = _traced_stretch(path, spans, b,
                                    int(traffic["trace_blocks"]), sync)
        if cuda and ctx.trace is None:
            raise NoDeviceTrace("the profiler recorded no device activity "
                                "in the traced stretch")
        metrics = _read_metrics(cell, ctx)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end
                   if e2e.get(m["name"]) is not None}
    tr = ctx.trace
    path_check = path.check
    path.close()
    del path
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers, info = path_check(torch.float64, dev)
    check_s = time.perf_counter() - t_check
    correct, lines = check.judge(numbers, cell.limits)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    breakdown = None
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": devtrace.top(tr.ops),
                     "idle_gaps": devtrace.top(tr.idle)}
    line = result_line(correct and failed == 0 and delivered > 0, delivered,
                       failed, metrics, device_info, lines, breakdown)
    step = np.diff(np.asarray([t_open] + ends)) * 1e3
    quarters = np.searchsorted(np.asarray(ends) - t_open,
                               np.arange(1, 5) * window_s / 4, side="right")
    info = dict(info, window_s=window_s, iterations=iterations,
                blocks_timed=len(trips), check_s=check_s,
                step_ms=np.percentile(step, [5, 50, 95, 99]).tolist(),
                blocks_by_quarter=np.diff(quarters, prepend=0).tolist(),
                seed=int(seed))
    return line, info


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, check_lines: dict, breakdown=None) -> dict:
    """The last line's object: exactly the contract's keys, ``check`` (each
    compared number beside its limit) last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = check_lines
    return line


def _read_metrics(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        v = cell.man.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _traced_stretch(path, spans, b: int, blocks: int, sync):
    """Feed ``blocks`` more under the profiler, the first PROFILER_WARMUP
    unrecorded.  Returns the devtrace.Trace, or None where the profiler
    recorded no device activity."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    spans.profiling = True
    try:
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=PROFILER_WARMUP,
                                       active=blocks, repeat=1)) as prof:
            for i in range(PROFILER_WARMUP + blocks):
                with record_function(devtrace.STRETCH):
                    path.feed(b + i, spans)
                    if i == PROFILER_WARMUP + blocks - 1:
                        sync()
                prof.step()
    finally:
        spans.profiling = False
    return devtrace.read(prof, spans.names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; the benchmark "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    cell = Manifest().cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    try:
        line, info = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    except NoDeviceTrace as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    print(f"portbench info {json.dumps(info)}", file=sys.stderr)
    for name, v in line["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
