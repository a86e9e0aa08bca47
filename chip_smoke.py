#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (psk_soft_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. toolchain: the card's name and power limit, torch / CUDA / nvcc
     versions, whether triton imports;
  2. build kernel B1 (csrc/demod_full.cu) with nvcc for sm_90a;
  3. kernel against its plain-PyTorch version on the card at 1024 channels
     x 512 symbols, sps 8, num_avg 100, phase_avg 50: M in {2, 4, 8, 16},
     differential, debug ports off, int8 soft, and a two-block carry;
     bits and sample_index equal, phase within 2e-3, soft within 3e-3;
  4. the engine end to end: NativePlaneBank -> FullKernelBatchEngine on
     the card -> step_packets, 1 warm-up block + 10 steady blocks + a
     flush, against the same engine on the CPU (the plain version);
  5. per-block times with CUDA events (kernel and plain version on the
     same CUDA tensors) and the engine's end-to-end samples/s.

The last two lines of standard output are a JSON object describing each
kernel, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

C, S, SPS, NUM_AVG, PHASE_AVG = 1024, 512, 8, 100, 50
WARM = 256                    # warm-up symbols before the kernel checks
STEADY_BLOCKS = 10            # engine blocks past the hand-off
PHASE_TOL, SOFT_TOL = 2e-3, 3e-3
QPSK_TOL = 0.05               # engine soft decisions vs the QPSK points


def channels(num_symbols: int, m: int = 4, diff: bool = False,
             noise: float = 0.01) -> np.ndarray:
    """(C, num_symbols*SPS) complex64 test bank: a unit PSK impulse at
    sample 2 of every symbol (a clear energy peak), a small frequency
    offset, and real Gaussian noise of std ``noise``; channel i draws from
    seed i (tests/test_full_kernel.py's fixture at 1024 channels)."""
    out = np.empty((C, num_symbols * SPS), np.complex64)
    rot = np.exp(2j * np.pi * 2e-4 * SPS * np.arange(num_symbols))
    for i in range(C):
        rng = np.random.default_rng(i)
        pts = np.exp(2j * np.pi * rng.integers(0, m, num_symbols) / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(num_symbols * SPS, np.complex64)
        x[2::SPS] = pts * rot
        x += (noise * rng.standard_normal(x.size)).astype(np.complex64)
        out[i] = x
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def wrap_diff(a, b, period: float) -> float:
    d = (a - b).double()
    return float((d - period * (d / period).round()).abs().max())


def profile_engine(feed, need: int, card: str, blocks: int = 5) -> None:
    """torch.profiler over a few engine blocks: device busy time by
    operation and the device's idle share of the wall time.  The profiler's
    table goes to standard error."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(blocks):
            feed(100 + b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side rows (kernels, memcpys) have no CPU time; a CPU op's row
    # repeats the device time of what it launched, and the profiler's own
    # buffer requests are left out.
    dev_rows = [e for e in ka if e.self_cpu_time_total == 0 and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in dev_rows) / 1e3
    top = sorted(dev_rows, key=dev_us, reverse=True)[:6]
    print(f"{card}: {blocks} engine blocks, wall {wall:.4f} s\n"
          f"{ka.table(row_limit=30)}", file=sys.stderr)
    log(json.dumps({"phase": "profile", "what": "engine, depth 0",
                    "blocks": blocks, "wall_ms_per_block": wall * 1e3
                    / blocks, "device_busy_ms_per_block": busy / blocks,
                    "device_idle_share": 1.0 - busy / (wall * 1e3),
                    "top_device_ms_per_block": {
                        e.key: dev_us(e) / 1e3 / blocks for e in top},
                    "card": card}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk, full
    from psk_soft_tpu_torch.ops.cuda import demod_kernel
    from psk_soft_tpu_torch.ops.cuda.demod_kernel import (demod_full_tm,
                                                          demod_full_tm_ref)
    from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
    from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
    from psk_soft_tpu_torch.runtime.streams import (
        PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX, PORT_SOFT, SRI)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # --- phase 1: toolchain ---
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    nvcc = subprocess.run([demod_kernel.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    log(f"card: {card}")
    log(json.dumps({"phase": "toolchain", "python": sys.version.split()[0],
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvcc": nvcc.stdout.strip().splitlines()[-1],
                    "triton": triton_v,
                    "device": torch.cuda.get_device_name(0),
                    "capability": list(torch.cuda.get_device_capability(0)),
                    "count": torch.cuda.device_count()}))

    # --- phase 2: build ---
    t0 = time.perf_counter()
    _, build_log = demod_kernel.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # --- phase 3: kernel vs plain version, every mode, 1024 x 512 ---
    modes = [dict(m=4, diff=False), dict(m=2, diff=False),
             dict(m=8, diff=False), dict(m=16, diff=False),
             dict(m=4, diff=True),
             dict(m=4, diff=False, debug_ports=False),
             dict(m=4, diff=False, soft_i8_scale=100.0)]
    max_err = 0.0
    inputs = {}
    for mode in modes:
        m, diff = mode["m"], mode["diff"]
        cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=m,
                          phase_avg=PHASE_AVG, differential=diff)
        if (m, diff) not in inputs:
            xs = torch.from_numpy(channels(WARM + 2 * S, m, diff)).to(dev)
            st, _ = blockpsk.demod_block_ff(
                cfg, blockpsk.ff_init(cfg, C, dev), xs[:, :WARM * SPS])
            inputs[(m, diff)] = (full.full_from_ff(cfg, st),
                                 xs[:, WARM * SPS:])
        state, run = inputs[(m, diff)]
        kw = dict(sps=SPS, num_avg=NUM_AVG, phase_avg=PHASE_AVG, m=m,
                  diff=diff, soft_i8_scale=mode.get("soft_i8_scale"),
                  debug_ports=mode.get("debug_ports", True))
        errs = {}
        carry = [state.planes, state.planes]
        win = [(state.win_re, state.win_im)] * 2
        for blk in range(2):                   # two blocks: carry checked
            x = run[:, blk * S * SPS:(blk + 1) * S * SPS]
            x_re = x.real.T.contiguous()
            x_im = x.imag.T.contiguous()
            got = demod_full_tm(*win[0], x_re, x_im, carry[0], **kw)
            ref = demod_full_tm_ref(*win[1], x_re, x_im, carry[1], **kw)
            torch.cuda.synchronize()
            keep = (NUM_AVG - 1) * SPS
            win = [(x_re[-keep:], x_im[-keep:])] * 2
            carry = [got[5], ref[5]]
            g_sre, g_sim, g_ph, g_bits, g_idx, _ = got
            r_sre, r_sim, r_ph, r_bits, r_idx, _ = ref
            if not torch.equal(g_bits, r_bits):
                raise AssertionError(f"{mode} block {blk}: bits differ at "
                                     f"{int((g_bits != r_bits).sum())} "
                                     f"symbols")
            if kw["soft_i8_scale"] is None:
                errs[f"soft{blk}"] = max(float((g_sre - r_sre).abs().max()),
                                         float((g_sim - r_sim).abs().max()))
                soft_ok = errs[f"soft{blk}"] <= SOFT_TOL
            else:
                # int8 planes: equal, or one step apart where the float
                # value sits on a rounding boundary.
                d_re = (g_sre.int() - r_sre.int()).abs()
                d_im = (g_sim.int() - r_sim.int()).abs()
                errs[f"i8_steps{blk}"] = max(int(d_re.max()), int(d_im.max()))
                errs[f"i8_differ{blk}"] = int((d_re > 0).sum()
                                              + (d_im > 0).sum())
                soft_ok = errs[f"i8_steps{blk}"] <= 1
            if kw["debug_ports"]:
                if not torch.equal(g_idx, r_idx):
                    raise AssertionError(f"{mode} block {blk}: sample_index "
                                         f"differs")
                errs[f"phase{blk}"] = float((g_ph - r_ph).abs().max())
            else:
                assert g_ph is None and g_idx is None
            errs[f"planes{blk}"] = wrap_diff(got[5], ref[5], 2 * np.pi * m)
            if (not soft_ok or errs.get(f"phase{blk}", 0) > PHASE_TOL
                    or errs[f"planes{blk}"] > PHASE_TOL):
                raise AssertionError(f"{mode} block {blk}: {errs}")
        log(json.dumps({"phase": "kernel_vs_plain", "mode": mode,
                        "bits_equal": True,
                        "sample_index_equal": kw["debug_ports"], **errs}))
        max_err = max([max_err] + [v for k, v in errs.items()
                                   if k.startswith(("soft", "phase"))])
    del inputs

    # --- phase 4: the engine end to end, card vs CPU ---
    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    need = S * SPS
    n_blocks = 1 + STEADY_BLOCKS
    # Noise 0.005: the largest of ~6M noise draws stays well inside the
    # 0.05 distance-to-QPSK check.
    sig = channels(n_blocks * S + S // 2, noise=0.005)
    frames = np.ascontiguousarray(sig.T)          # (T, C) interleaved
    del sig
    sri = SRI(stream_id="smoke", xdelta=1e-6)

    def drive(device, count_launches: bool):
        eng = FullKernelBatchEngine(cfg, C, block_symbols=S, device=device)
        eng.set_input_sri(sri)
        bank = NativePlaneBank(C, capacity_samples=4 * need)
        pkts = []
        if count_launches:
            demod_full_tm.launches = 0
        for b in range(n_blocks):
            bank.push_interleaved(frames[b * need:(b + 1) * need])
            re, im, flushed = bank.pop_planes(need, timeout=0)
            assert not flushed
            eng.push_planes(re, im)
            pkts.append(eng.step_packets())
        tail = frames[n_blocks * need:]
        bank.push_interleaved(tail)
        re, im, _ = bank.pop_planes(tail.shape[0], timeout=0)
        eng.push_planes(re, im)
        pkts.append(eng.flush_packets())
        launches = demod_full_tm.launches if count_launches else None
        bank.close()
        return pkts, launches, eng

    gpu_pkts, launches, eng = drive("cuda", True)
    cpu_pkts, _, _ = drive("cpu", False)
    steady_blocks = n_blocks            # 10 steady + the flush block
    if launches < steady_blocks:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{steady_blocks} steady blocks")
    # (dtype, values per symbol) of each port's (C, ...) packet payload.
    layout = {PORT_SOFT: (np.complex64, 1), PORT_BITS: (np.int16, 2),
              PORT_PHASE: (np.float32, 1), PORT_SAMPLE_INDEX: (np.int16, 1)}
    for pkts in gpu_pkts:
        if set(pkts) != set(layout):
            raise AssertionError(f"ports {sorted(pkts)}")
        width = pkts[PORT_SOFT].data.shape[1]
        for port, (dtype, per_symbol) in layout.items():
            data = pkts[port].data
            if data.dtype != dtype or data.shape != (C, width * per_symbol):
                raise AssertionError(f"{port}: {data.dtype} {data.shape}")
    worst = {"soft": 0.0, "phase": 0.0, "qpsk": 0.0}
    total_syms = 0
    for a, b in zip(gpu_pkts, cpu_pkts):
        if set(a) != set(b):
            raise AssertionError(f"ports differ: {set(a)} vs {set(b)}")
        for port in a:
            pa, pb = a[port], b[port]
            if (pa.t != pb.t or pa.eos != pb.eos or pa.sri != pb.sri
                    or pa.data.shape != pb.data.shape
                    or pa.data.dtype != pb.data.dtype):
                raise AssertionError(f"{port}: packet metadata differs")
            if port in (PORT_BITS, PORT_SAMPLE_INDEX):
                if not np.array_equal(pa.data, pb.data):
                    raise AssertionError(f"{port}: values differ")
            elif port == PORT_SOFT:
                worst["soft"] = max(worst["soft"],
                                    float(np.abs(pa.data - pb.data).max()))
                qp = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.round(
                    (np.angle(pa.data) - np.pi / 4) / (np.pi / 2))))
                worst["qpsk"] = max(worst["qpsk"],
                                    float(np.abs(pa.data - qp).max()))
                total_syms += pa.data.shape[1]
                if not np.isfinite(pa.data).all():
                    raise AssertionError("non-finite soft decisions")
            else:
                worst["phase"] = max(worst["phase"],
                                     float(np.abs(pa.data - pb.data).max()))
    if (worst["soft"] > SOFT_TOL or worst["phase"] > PHASE_TOL
            or worst["qpsk"] > QPSK_TOL):
        raise AssertionError(f"engine card vs CPU: {worst}")
    expect_syms = n_blocks * S - (NUM_AVG - 1) + S // 2
    if total_syms != expect_syms:
        raise AssertionError(f"{total_syms} soft symbols, expected "
                             f"{expect_syms}")
    if eng.metrics.symbols_out != expect_syms * C:
        raise AssertionError(f"metrics.symbols_out "
                             f"{eng.metrics.symbols_out}")
    log(json.dumps({"phase": "engine", "launches": launches,
                    "steady_blocks": steady_blocks, "symbols": total_syms,
                    "soft_max_err": worst["soft"],
                    "phase_max_err": worst["phase"],
                    "qpsk_max_err": worst["qpsk"]}))

    # --- phase 5: timings ---
    def event_ms(fn, args_list, iters: int = 20) -> float:
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

    # Four distinct blocks (134 MB of input) so reads come from HBM, not L2.
    blocks = []
    state0 = full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, dev))
    keep = (NUM_AVG - 1) * SPS
    for b in range(4):
        x = torch.from_numpy(frames[b * need:(b + 1) * need]).to(dev)
        blocks.append((x.real.contiguous(), x.imag.contiguous()))
    timings = {}
    for debug in (False, True):
        kw = dict(sps=SPS, num_avg=NUM_AVG, phase_avg=PHASE_AVG, m=4,
                  diff=False, debug_ports=debug)
        args = [(prev[0][-keep:], prev[1][-keep:], cur[0], cur[1],
                 state0.planes)
                for prev, cur in zip(blocks[-1:] + blocks[:-1], blocks)]
        k_fn = lambda *a: demod_full_tm(*a, **kw)       # noqa: E731
        r_fn = lambda *a: demod_full_tm_ref(*a, **kw)   # noqa: E731
        # plain, kernel, kernel, plain: compare within one call.
        p1 = event_ms(r_fn, args)
        k1 = event_ms(k_fn, args)
        k2 = event_ms(k_fn, args)
        p2 = event_ms(r_fn, args)
        timings[debug] = dict(kernel_ms=[k1, k2], plain_ms=[p1, p2])
        log(json.dumps({"phase": "timing", "what": "demod_full_tm block",
                        "channels": C, "symbols": S, "sps": SPS,
                        "debug_ports": debug, "kernel_ms": [k1, k2],
                        "plain_ms": [p1, p2],
                        "kernel_samples_per_s": need * C / (min(k1, k2)
                                                            * 1e-3),
                        "card": card}))

    for depth in (0, 1):
        eng = FullKernelBatchEngine(cfg, C, block_symbols=S,
                                    pipeline_depth=depth,
                                    debug_ports=False, device="cuda")
        eng.set_input_sri(sri)
        bank = NativePlaneBank(C, capacity_samples=4 * need)
        # Host-clock breakdown of each block: bank push + pop; the engine's
        # upload + kernel launch (_step_core); fetch + packet assembly
        # (_emit, which waits for the kernel).
        acc = dict(bank=0.0, upload_launch=0.0, fetch_assemble=0.0)

        def timed(name, fn):
            def run(*a, **k):
                t = time.perf_counter()
                r = fn(*a, **k)
                acc[name] += time.perf_counter() - t
                return r
            return run

        eng._step_core = timed("upload_launch", eng._step_core)
        eng._emit = timed("fetch_assemble", eng._emit)

        def feed(b):
            t = time.perf_counter()
            bank.push_interleaved(frames[(b % n_blocks) * need:
                                         (b % n_blocks + 1) * need])
            re, im, _ = bank.pop_planes(need, timeout=0)
            acc["bank"] += time.perf_counter() - t
            eng.push_planes(re, im)
            return eng.step_packets()

        for b in range(3):                   # warm-up + hand-off + 1 steady
            feed(b)
        torch.cuda.synchronize()
        acc = dict.fromkeys(acc, 0.0)
        n_timed, emitted = 20, 0
        t0 = time.perf_counter()
        for b in range(n_timed):
            if feed(3 + b):
                emitted += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(json.dumps({"phase": "timing", "what": "engine end to end",
                        "pipeline_depth": depth, "debug_ports": False,
                        "blocks": n_timed, "emitted": emitted,
                        "seconds": dt,
                        "samples_per_s": n_timed * need * C / dt,
                        "host_ms_per_block": {k: v * 1e3 / n_timed
                                              for k, v in acc.items()},
                        "card": card}))
        if depth == 0:
            profile_engine(feed, need, card)
        bank.close()

    t = timings[False]
    print(json.dumps({"kernels": [{
        "name": "demod_full_tm",
        "route": "cuda",
        "source": "psk_soft_tpu_torch/csrc/demod_full.cu",
        "replaces": "psk_soft_tpu/ops/pallas/demod_kernel.py:546",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": min(t["kernel_ms"]),
        "plain_ms": min(t["plain_ms"]),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
