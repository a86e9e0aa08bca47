#!/usr/bin/env python3
"""Times the port's kernels B1-B5 in one checkout of this repository on one
NVIDIA GPU:

    python3 psk_soft_tpu_torch/tools/kernel_times.py [--root DIR] [--label L]

It imports ``psk_soft_tpu_torch`` from DIR (by default the checkout that
holds this script) and calls only the wrappers, whose contracts every
checkout since the port's kernels exist shares, so one copy of the script
times two checkouts alike: run it on each in turns (parent, change,
change, parent) on one card.  Per shape it prints one JSON line with

* ``event_ms``: five readings, each the CUDA-event time of 20 back-to-back
  wrapper calls divided by 20 (host work included where it is the longer);
* ``host_ms``: five readings, each the host clock's time to make 20
  back-to-back wrapper calls onto an idle card divided by 20 (the host's
  cost of a call: arguments, plan, allocations, launches);
* ``device_ms``: three readings, each the device time of the kernels named
  in the line (torch.profiler, one pass over 10 calls), by kernel;
* the card's name and power limit (``nvidia-smi``).

Every event reading of every shape is taken before the first profiler
pass: in a process that has run torch.profiler, each wrapper call costs
the host more (measured on an H100: B5's 20-call reading rose from 0.055
to 0.07-0.085 ms), which event times of host-bound wrappers show.

Shapes (inputs from seeded generators on the card; the sample planes of B1
and B5 are four distinct blocks used in turn, 134 MB, so reads come from
HBM rather than L2):
B1 ``demod_full_tm`` and B5 ``timing_frontend_tm`` at 1024 channels x 512
symbols, sps 8, num_avg 100 (B1: QPSK, phase_avg 50, debug ports off),
B1's stage A (timing) and stage B (tracking) apart by device time; B1 at
BASELINE config 3's widths (8-PSK, num_avg 50, phase_avg 40, RRC 65 taps)
with its matched filter, on float32 planes (argmax timing) and config 3
whole on int16 planes, stage 0 (the filter) apart; where the checkout has
it, stage 0 alone (``matched_filter_tm``, float32 and int16) beside
``F.conv2d`` of the same float32 planes (TF32 off), a PyTorch call that
computes the same function; B2
``viterbi_fused`` at the chain shape (K7, 6144 rows x 64 steps) and K9,
512 x 1472; B3 ``viterbi_acs`` at K7, 512 x 4096 and 8 x 4096 (one block);
B4 ``viterbi_traceback`` at K7, 512 x 4096, K9, 256 x 1024 and K7, 32 x
2048 (one block; the long-trellis decode of chip_smoke.py phase 13).

Before any timing it prints one ``digest`` line per B1 filter-mode shape:
the SHA-1 of every output plane's bytes (soft, phase, bits, sample index,
carry) of one seeded block with debug ports on, so runs on two checkouts
show whether B1's outputs are equal bit for bit.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

C, S, SPS, NUM_AVG, PHASE_AVG = 1024, 512, 8, 100, 50


def event_ms(torch, fn, args_list, iters: int = 20) -> float:
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(torch, fn, args_list, iters: int = 20) -> float:
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / iters


def device_ms(torch, fn, args_list, names, iters: int = 10) -> dict:
    """Device time per call of the kernels whose name holds each of
    ``names`` (label -> a piece of the name, or a tuple of pieces), from
    one profiler pass."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args_list[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    out = {}
    for label, name in names.items():
        pieces = (name,) if isinstance(name, str) else name
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.self_cpu_time_total == 0
                 and any(n in e.key for n in pieces))
        if not us:
            raise AssertionError(f"profiler shows no device time for {name}")
        out[label] = us / 1e3 / iters
    return out


CFG3 = dict(sps=8, num_avg=50, constellation_size=8, phase_avg=40,
            matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
            timing_interp=True)


def config3_cases(torch, dev, gen, report, card, args) -> None:
    """B1 at config 3's widths with its matched filter (float32 planes with
    argmax timing; config 3 whole on int16 planes): a digest line each,
    then their timing cases; stage 0 alone where the checkout has
    ``matched_filter_tm``."""
    import dataclasses

    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk, full
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

    for name, ckw, i16 in (("matched_filter", dict(CFG3, timing_interp=False),
                            False), ("config3", CFG3, True)):
        cfg = DemodConfig(**ckw)
        rows_w = full.window_rows(cfg)
        raw = torch.zeros((C, rows_w), dtype=torch.complex64, device=dev)
        planes = full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, dev),
                                   raw_win=raw).planes
        blocks = []
        for _ in range(4):
            xr = 0.5 * torch.randn((rows_w + S * SPS, C), generator=gen,
                                   device=dev)
            xi = 0.5 * torch.randn((rows_w + S * SPS, C), generator=gen,
                                   device=dev)
            if i16:
                xr = (xr * 8000).round().to(torch.int16)
                xi = (xi * 8000).round().to(torch.int16)
            blocks.append((xr[:rows_w], xi[:rows_w], xr[rows_w:],
                           xi[rows_w:], planes))
        kw = dict(sps=cfg.sps, num_avg=cfg.num_avg, phase_avg=cfg.phase_avg,
                  m=cfg.constellation_size, diff=False,
                  mf_taps=full._static_taps(cfg),
                  timing_interp=cfg.timing_interp,
                  in_scale=1.0 / 8000 if i16 else 1.0)
        outs = dk.demod_full_tm(*blocks[0], **kw)
        torch.cuda.synchronize()
        sha = hashlib.sha1()
        for t in outs:
            sha.update(t.contiguous().cpu().numpy().tobytes())
        print(json.dumps({"label": args.label, "root": str(args.root),
                          "digest": sha.hexdigest(),
                          "kernel": f"demod_full_tm[{name}]",
                          "outputs": "soft_re, soft_im, phase, bits, "
                                     "sample_index, new_state",
                          "card": card}), flush=True)
        report(f"demod_full_tm[{name}]",
               {"channels": C, "symbols": S, "config": ckw, "int16": i16},
               lambda *a, kw=kw: dk.demod_full_tm(*a, debug_ports=False,
                                                  **kw),
               blocks, {"stage_0_filter": "demod_fir",
                        "stage_a_timing": "demod_timing",
                        "stage_b_track": "demod_track"})
        if hasattr(dk, "matched_filter_tm"):
            taps = kw["mf_taps"]
            scale = kw["in_scale"]
            rows = rows_w + S * SPS
            stacked = [torch.stack([torch.cat([b[0], b[2]]),
                                    torch.cat([b[1], b[3]])])
                       for b in blocks]
            fir_args = [(p[0], p[1]) for p in stacked]
            report("matched_filter_tm",
                   {"channels": C, "rows": rows - len(taps) + 1,
                    "ntaps": len(taps), "int16": i16},
                   lambda a, b, taps=taps, scale=scale:
                   dk.matched_filter_tm(a, b, taps, in_scale=scale),
                   fir_args, {"stage_0_filter": "demod_fir"})
            if not i16:
                weight = torch.tensor(taps, device=dev).view(1, 1, -1, 1)
                torch.backends.cudnn.allow_tf32 = False
                conv = [(p.view(2, 1, rows, C),) for p in stacked]
                ev = [event_ms(torch, lambda x: torch.nn.functional.conv2d(
                    x, weight), conv) for _ in range(5)]
                print(json.dumps({"label": args.label, "root": str(args.root),
                                  "kernel": "conv2d (same function as "
                                            "matched_filter_tm)",
                                  "channels": C, "rows": rows - len(taps) + 1,
                                  "ntaps": len(taps), "event_ms": ev,
                                  "card": card}), flush=True)
        del blocks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk, full
    from psk_soft_tpu_torch.ops import fec
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk
    from psk_soft_tpu_torch.ops.cuda import frontend_kernel as fk
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for mod in (dk, fk, vk):
        mod.load_library()

    cases = []          # (kernel, shape, fn, args_list, kernel names)

    def report(kernel, shape, fn, args_list, names):
        cases.append((kernel, shape, fn, args_list, names,
                      [event_ms(torch, fn, args_list) for _ in range(5)],
                      [host_ms(torch, fn, args_list) for _ in range(5)]))

    # B1 and B5: four distinct blocks, each with the block before as its
    # carry window.
    keep = (NUM_AVG - 1) * SPS
    blocks = [(torch.randn((S * SPS, C), generator=gen, device=dev),
               torch.randn((S * SPS, C), generator=gen, device=dev))
              for _ in range(4)]
    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    planes = full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, dev)).planes
    wins = [(p[0][-keep:], p[1][-keep:], c[0], c[1])
            for p, c in zip(blocks[-1:] + blocks[:-1], blocks)]
    shape = {"channels": C, "symbols": S, "sps": SPS, "num_avg": NUM_AVG}
    config3_cases(torch, dev, gen, report, card, args)
    report("timing_frontend_tm", shape,
           lambda *a: fk.timing_frontend_tm(*a, sps=SPS, num_avg=NUM_AVG),
           wins, {"B5": "frontend"})
    report("demod_full_tm", dict(shape, phase_avg=PHASE_AVG),
           lambda *a: dk.demod_full_tm(*a, sps=SPS, num_avg=NUM_AVG,
                                       phase_avg=PHASE_AVG, m=4, diff=False,
                                       debug_ports=False),
           [w + (planes,) for w in wins],
           {"stage_a_timing": "demod_timing", "stage_b_track": "demod_track"})

    # B2 and B3: random LLRs, metrics pinned to state 0.
    for name, code, rows, t in (("viterbi_fused", fec.CODE_K7, 6144, 64),
                                ("viterbi_fused", fec.CODE_K9, 512, 1472),
                                ("viterbi_acs", fec.CODE_K7, 512, 4096),
                                ("viterbi_acs", fec.CODE_K7, 8, 4096)):
        llr_t = torch.randn((code.n, t, rows), generator=gen, device=dev)
        pm0 = torch.full((code.states, rows), -1e9, device=dev)
        pm0[0] = 0.0
        exp = torch.from_numpy(vk.butterfly_signs(code)).to(dev)
        kw = dict(k=code.k, s_count=code.states, n=code.n, t_actual=t)
        if name == "viterbi_fused":
            fn = functools.partial(vk.viterbi_fused, llr_t, pm0, exp,
                                   terminate=True, **kw)
        else:
            fn = functools.partial(vk.viterbi_acs, llr_t, pm0, exp, **kw)
        report(name, {"K": code.k, "rows": rows, "steps": t}, fn, [()],
               {name: "viterbi_warp"})

    # B4: random 0/1 decision planes and start states.
    for k, rows, t in ((7, 512, 4096), (9, 256, 1024), (7, 32, 2048)):
        s_count = 1 << (k - 1)
        dec = torch.randint(0, 2, (t, s_count, rows), generator=gen,
                            device=dev, dtype=torch.int8)
        start = torch.randint(0, s_count, (1, rows), generator=gen,
                              device=dev, dtype=torch.int32)
        report("viterbi_traceback", {"K": k, "rows": rows, "steps": t},
               functools.partial(vk.viterbi_traceback, dec, start, k=k,
                                 s_count=s_count, t_actual=t),
               [()], {"B4": ("viterbi_traceback", "viterbi_segments",
                             "viterbi_resolve")})

    for kernel, shape, fn, args_list, names, ev, host in cases:
        dv = [device_ms(torch, fn, args_list, names) for _ in range(3)]
        print(json.dumps({"label": args.label, "root": str(args.root),
                          "kernel": kernel, **shape, "event_ms": ev,
                          "host_ms": host, "device_ms": dv, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
