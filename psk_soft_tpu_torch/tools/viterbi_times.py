#!/usr/bin/env python3
"""Times kernels B2 (viterbi_fused) and B3 (viterbi_acs) of one checkout of
this repository on one NVIDIA GPU:

    python3 psk_soft_tpu_torch/tools/viterbi_times.py [--root DIR]

It imports ``psk_soft_tpu_torch`` from DIR (by default the checkout that
holds this script), so one copy of the script times two checkouts alike:
run it on each in turns (parent, change, change, parent) on one card.
Per shape it prints one JSON line with

* ``event_ms``: five readings, each the CUDA-event time of 20 back-to-back
  wrapper calls divided by 20 (host work included where it is the longer);
* ``device_ms``: three readings, each the device time of the kernels whose
  name holds "viterbi" in one torch.profiler pass over 10 calls;
* the card's name and power limit (``nvidia-smi``).

Shapes (random LLRs from a seeded generator, metrics pinned to state 0):
B2 at the chain shape (K7, 6144 rows x 64 steps) and at K9, 512 rows x
1472 steps (the longest trellis the fused path takes); B3 at K7, 512 rows
x 4096 steps, and 8 rows x 4096 steps (one block: the time of a step
with nothing to hide its latency).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def event_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, iters: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.self_cpu_time_total == 0 and "viterbi" in e.key)
    if not us:
        raise AssertionError("profiler shows no device time for a Viterbi "
                             "kernel")
    return us / 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("viterbi_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from psk_soft_tpu_torch.ops import fec
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    vk.load_library()
    shapes = (("viterbi_fused", fec.CODE_K7, 6144, 64),
              ("viterbi_fused", fec.CODE_K9, 512, 1472),
              ("viterbi_acs", fec.CODE_K7, 512, 4096),
              ("viterbi_acs", fec.CODE_K7, 8, 4096))
    for name, code, rows, t in shapes:
        llr_t = torch.randn((code.n, t, rows), generator=gen, device=dev)
        pm0 = torch.full((code.states, rows), -1e9, device=dev)
        pm0[0] = 0.0
        exp = torch.from_numpy(vk.butterfly_signs(code)).to(dev)
        kw = dict(k=code.k, s_count=code.states, n=code.n, t_actual=t)
        if name == "viterbi_fused":
            call = lambda: vk.viterbi_fused(llr_t, pm0, exp,  # noqa: E731
                                            terminate=True, **kw)
        else:
            call = lambda: vk.viterbi_acs(llr_t, pm0, exp, **kw)  # noqa
        ev = [event_ms(torch, call) for _ in range(5)]
        dv = [device_ms(torch, call) for _ in range(3)]
        print(json.dumps({"label": args.label, "root": str(args.root),
                          "kernel": name, "K": code.k, "rows": rows,
                          "steps": t, "event_ms": ev, "device_ms": dv,
                          "card": card}), flush=True)
        del llr_t, pm0
    return 0


if __name__ == "__main__":
    sys.exit(main())
