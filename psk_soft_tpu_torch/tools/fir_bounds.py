#!/usr/bin/env python3
"""What bounds kernel B1's stage 0 (``demod_fir_kernel``, the matched
filter) on one NVIDIA GPU:

    python3 psk_soft_tpu_torch/tools/fir_bounds.py

It builds three libraries from this checkout's ``csrc/demod_full.cu`` into
``build/fir_bounds/`` with the port's nvcc flags: the kernel as it is;
``fma_only``, the same with no staging after a run's first tile and no
stores (its fused multiply-adds alone, on stale rows); ``copies_only``, the
same with no taps applied (every staged row and every store, outputs 0).
At BASELINE config 3's widths (1024 channels, 4488 filtered rows, RRC 65
taps, ``fir_plan``'s plan) it prints one JSON line per library and plane
type (float32, int16) with three device-time readings (torch.profiler,
10 calls over four distinct blocks each), and the card's name and power
limit.  The variants' outputs are wrong by design; only the kernel as it
is is held against the plain version (max_abs_err).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Edits that make the variants; each must match the source exactly once.
NEXT_TILE = "      stage(buf(t + 1), r0 + tile, ntaps - 1, tile);\n"
HALO = "        to[v] = from[v];\n        to[pv + v] = from[pv + v];\n"
STORE = "      if (row0 + i < run_end) {"
GROUPS = "    const int ng = ntaps / kFirGroup;"
TAIL = "for (int j = ng * kFirGroup; j < ntaps; ++j)"


def variants(src: str) -> dict:
    for piece in (NEXT_TILE, HALO, STORE, GROUPS, TAIL):
        if src.count(piece) != 1:
            raise SystemExit(f"fir_bounds: the source no longer holds "
                             f"{piece!r} once")
    return {
        "kernel": src,
        "fma_only": src.replace(NEXT_TILE, "").replace(HALO, "").replace(
            STORE, "      if (row0 + i < run_end && ar[i] == -1.5e-30f) {"),
        "copies_only": src.replace(GROUPS, "    const int ng = 0;").replace(
            TAIL, "for (int j = 0; j < 0; ++j)"),
    }


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk
    from psk_soft_tpu_torch.ops.matched_filter import rrc_taps

    if not torch.cuda.is_available():
        print("fir_bounds: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    out_dir = dk.REPO_ROOT / "build" / "fir_bounds"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(item):
        name, text = item
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        subprocess.run([dk.nvcc_path(), *dk.NVCC_FLAGS, "-I", str(dk.CSRC),
                        "-o", str(so), str(cu)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(so))
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.psk_matched_filter_tm.restype = i32
        lib.psk_matched_filter_tm.argtypes = (
            [vp, vp, ctypes.c_int64, i32, i32, f32, vp, i32, vp, vp]
            + [i32] * 6 + [vp])
        return name, lib

    with ThreadPoolExecutor(3) as pool:
        libs = dict(pool.map(build, variants(dk.SOURCE.read_text()).items()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    taps = rrc_taps(8)
    taps_t = torch.tensor(taps, device=dev)
    C, rows_f, ntaps = 1024, (50 - 1 + 512) * 8, len(taps)
    rows = rows_f + ntaps - 1
    for i16 in (False, True):
        blocks = []
        for _ in range(4):
            p = torch.randn((2, rows, C), generator=gen, device=dev)
            blocks.append((p * 8000).round().to(torch.int16) if i16 else p)
        scale = 1.0 / 8000 if i16 else 1.0
        plan = dk.fir_plan(C, rows_f, ntaps, 2 if i16 else 4)
        out = torch.empty((2, rows_f, C), device=dev)
        ref = dk.matched_filter_tm_ref(blocks[0][0], blocks[0][1], taps,
                                       in_scale=scale)
        for name, lib in libs.items():
            def call(i, lib=lib):
                p = blocks[i % 4]
                rc = lib.psk_matched_filter_tm(
                    p[0].data_ptr(), p[1].data_ptr(), rows, C, int(i16),
                    scale, taps_t.data_ptr(), ntaps, out[0].data_ptr(),
                    out[1].data_ptr(), plan.rows_per_thread, plan.tap_group,
                    plan.row_threads, plan.run_rows, plan.stages, plan.vec,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call(0)
            torch.cuda.synchronize()
            err = float(max((o - r).abs().max() for o, r in zip(out, ref)))
            readings = []
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for i in range(10):
                        call(i)
                    torch.cuda.synchronize()
                us = sum(getattr(e, "self_device_time_total", 0.0)
                         for e in prof.key_averages()
                         if e.self_cpu_time_total == 0
                         and "demod_fir" in e.key)
                readings.append(us / 1e3 / 10)
            print(json.dumps({"variant": name, "int16": i16, "channels": C,
                              "rows": rows_f, "ntaps": ntaps,
                              "plan": plan._asdict(), "device_ms": readings,
                              "max_abs_err": err if name == "kernel"
                              else None, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
