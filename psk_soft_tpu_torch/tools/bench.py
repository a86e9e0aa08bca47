#!/usr/bin/env python3
"""Throughput bench of the port on one NVIDIA GPU (port of the root
``bench.py``):

    python3 -m psk_soft_tpu_torch.tools.bench [flags]

from the repository root.  It takes ``bench.py``'s flags, defaults and
input generators (1024 channels, 512-symbol blocks, sps 8, QPSK, num_avg
100, phase_avg 50; the chain and receiver with UW 32, payload 64, K7 and
CRC-16-CCITT on the unaligned cadence) and prints one JSON line a
measurement, with ``bench.py``'s ``metric`` text; the card's name and power
limit (``nvidia-smi --query-gpu=name,power.limit``) stand where the TPU
kind stood.  ``--device cpu`` runs the kernels' plain versions on the CPU
(for tests); such lines say ``"device": "cpu"`` and carry no card.

Modes (each path and the kernels it launches):

* no flag: the full-kernel pipeline (``models/full`` after a
  ``models/blockpsk`` warm-up and ``full_from_ff``; B1 rolling over the
  previous block's planes) with debug ports, the same without them, the
  feed-forward pipeline (plain torch), then the receive chain's line;
  ``--pipeline full`` the first and the chain; ``ff``, ``exact`` (the
  exact scan, at most EXACT_STEPS steps a rep) and ``fused``
  (``models/fused``: B5) one line each.  ``--ingest i16`` and ``--soft
  i8`` set B1's int16 planes and int8 soft, ``--no-debug-ports`` its
  debug ports off;
* ``--profile config3``: BASELINE config 3 (8-PSK, RRC, timing_interp) on
  B1 with its matched filter; ``mixed``: per-channel modes on B1's mixed
  mode; ``chain``: B1 then the seam tail (frame sync, LLRs, B2, CRC);
* ``--engine``: NativePlaneBank -> FullKernelBatchEngine (with
  ``--profile mixed`` MixedKernelBatchEngine; NativeChannelBank ->
  BatchEngine where channels % 128 != 0) at pipeline depth 0 and
  ``--engine-depth``, every block's packets fetched;
* ``--receiver``: ``build_receiver(engine="full")`` on NativePlaneBank
  (``--receiver-frames-only``: data ports off; ``--receiver-fused``:
  ``engine="chain"``), every popped frame validated;
* ``--mesh``: ``eval/scaling``'s reports on 1, 2 and 4 shards of
  ``--device`` (``parallel/mesh.shard_devices``: one card repeated on a
  one-card machine, where the report measures what sharding costs).

Timing: warm-up steps first, then one gated step (below), then ``--reps``
reps of ``--iters`` steps (blocks for the engine and the receiver:
``max(10, min(50, iters // 10))``).  A rep is one Python loop of eager
steps that sums a device checksum of every output and ends in one
``.item()`` and ``torch.cuda.synchronize()``.  ``value`` is the median
rate over the reps by the host clock, ``min`` and ``max`` the others;
``device_ms_per_step`` is the median over the reps of the CUDA-event
span around the same loop over its steps; ``launches`` each kernel
wrapper's launches over all the timed reps.

Gates before timing (``tools/gates``; a failed gate raises, so the run
exits non-zero and prints no number for that mode): one steady B1 launch
on the bench's own input held by ``B1Gate``; one B5 launch by
``check_b5``; the chain's carry and rolling paths by
``check_chain_steady``; the receiver's frames by ``check_frames`` (and
at least ``(blocks - 2) * k * C`` of them a rep); the plain-torch
pipelines' soft decisions within DECISION_TOL of the QPSK points.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..config import DemodConfig
from ..ops.cuda import demod_kernel, frontend_kernel, viterbi_kernel
from . import gates

NUM_AVG, PHASE_AVG = 100, 50
I8_SCALE = 100.0              # --soft i8: round(soft * 100), bench.py's
EXACT_STEPS = 30              # the exact scan takes ~0.14 s a block
# Plain pipelines' gate: |soft - nearest QPSK point| below 0.5, where the
# decision regions' half-width is 0.77.  The repeated block's CFO ramp
# restarts at every seam, a 0.32-rad phase step that the tracker follows
# over phase_avg symbols: steady decisions sit up to ~0.31 off.
DECISION_TOL = 0.5
MESH_SHARDS = (1, 2, 4)       # --mesh: shard counts of each report
TIMING = ("value/min/max: host clock over each rep (a loop of eager steps "
          "ending in .item() and torch.cuda.synchronize()); "
          "device_ms_per_step: CUDA events around the same loop")
TIMING_CPU = ("value/min/max: host clock over each rep (a loop of eager "
              "steps ending in .item())")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python3 -m psk_soft_tpu_torch.tools.bench",
        description="Throughput bench of psk_soft_tpu_torch on one NVIDIA "
                    "GPU: one JSON line a measurement.")
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--symbols", type=int, default=512,
                    help="symbols per block")
    ap.add_argument("--sps", type=int, default=8)
    ap.add_argument("--payload", type=int, default=64,
                    help="chain and receiver: payload symbols per frame")
    ap.add_argument("--uw-len", type=int, default=32,
                    help="chain and receiver: unique-word length in symbols")
    ap.add_argument("--iters", type=int, default=50,
                    help="steps a rep (the engine and the receiver: "
                         "max(10, min(50, iters // 10)) blocks a rep)")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed reps; the line gives their median, min and "
                         "max")
    ap.add_argument("--pipeline",
                    choices=["auto", "ff", "exact", "fused", "full"],
                    default="auto",
                    help="auto = the full-kernel pipeline with and without "
                         "debug ports and the feed-forward pipeline, each "
                         "on its own line, then the chain's line")
    ap.add_argument("--no-debug-ports", action="store_true",
                    help="B1 without the phase/sampleIndex planes "
                         "(unconnected debug ports); full-kernel paths only")
    ap.add_argument("--soft", choices=["f32", "i8"], default="f32",
                    help="i8 = int8 soft planes (round(s*100)); the "
                         "full-kernel pipelines and --engine")
    ap.add_argument("--ingest", choices=["f32", "i16"], default="f32",
                    help="i16 = int16 I/Q planes dequantized in B1; the "
                         "full-kernel pipelines, the chain and --engine")
    ap.add_argument("--profile",
                    choices=["default", "config3", "mixed", "chain"],
                    default="default",
                    help="config3 = 8-PSK + RRC + fractional timing "
                         "(BASELINE config 3) on B1; mixed = per-channel "
                         "modes (BASELINE config 4); chain = demod -> "
                         "frame sync -> Viterbi -> CRC, in info-bits/s")
    ap.add_argument("--engine", action="store_true",
                    help="native deframe -> engine step -> packet "
                         "assembly, at pipeline_depth 0 and --engine-depth")
    ap.add_argument("--engine-depth", type=int, default=1,
                    help="pipeline depth compared against 0 in --engine")
    ap.add_argument("--receiver-fused", dest="fused_receiver",
                    action="store_true",
                    help="--receiver through ChainEngine (only the decoded "
                         "frame table crosses to the host per block)")
    ap.add_argument("--receiver-frames-only", dest="frames_only",
                    action="store_true",
                    help="--receiver with the soft/bits ports unconnected")
    ap.add_argument("--receiver", action="store_true",
                    help="the streaming receiver (native deframe -> engine "
                         "-> FrameSyncer -> Viterbi -> CRC -> pop_frames), "
                         "every frame validated, in info-bits/s; at "
                         "--engine-depth")
    ap.add_argument("--mesh", action="store_true",
                    help="eval/scaling's reports on shards of --device, "
                         "one JSON line each")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu (the kernels' "
                         "plain versions; for tests)")
    return ap


# --- inputs (bench.py's generators, bit for bit) ----------------------------

def qpsk_block(C: int, symbols: int, sps: int, seed: int = 0) -> np.ndarray:
    """(C, symbols*sps) complex64 QPSK block: rectangular pulses, a slow
    residual CFO, noise of std 0.01 on I (``bench.py:38-48``)."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 4, size=(C, symbols))
    pts = np.exp(1j * (2 * np.pi * sym / 4
                       + 2 * np.pi * 1e-4 * np.arange(symbols)))
    x = np.repeat(pts, sps, axis=1).astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


def plant_unaligned_frames(C: int, S: int, sps: int, fmt, code, crc, rng,
                           lfsr=None):
    """K7 + CRC frames on the unaligned cadence ``max(sep, 104) + 1`` over
    an S-periodic QPSK stream, planted with wraparound so one frame
    straddles the block seam whenever S % cadence != 0; no CFO, so the
    repeated block is phase-continuous (``bench.py:270-308``).  With
    ``lfsr`` (an ``ops/scramble.Lfsr``) each framed message (info || CRC)
    is scrambled before the encoder.  Returns (starts, k_frames, infos
    (C, k, n_msg), x (C, S*sps), n_info, n_msg)."""
    from ..ops import tx
    from ..ops.crc import append_crc
    from ..ops.fec import conv_encode, info_bits_for
    from ..ops.scramble import additive_scramble

    n_info = info_bits_for(code, fmt.payload * 2)
    n_msg = n_info - crc.degree
    cadence = max(fmt.separation, 104) + 1
    k_frames = S // cadence
    if k_frames == 0:
        raise ValueError("block too short for one frame; raise --symbols")
    starts = [(17 + j * cadence) % S for j in range(k_frames)]
    infos = rng.integers(0, 2, (C, k_frames, n_msg)).astype(np.int8)
    framed = append_crc(crc, infos)
    if lfsr is not None:
        framed = additive_scramble(lfsr, framed)
    coded = conv_encode(code, framed).numpy()
    pay_syms = tx.bits_to_symbols(4, coded, "gray")      # (C, k, payload)
    idx = rng.integers(0, 4, (C, S))
    uw_arr = np.asarray(fmt.uw, np.int64)
    for j, s0 in enumerate(starts):
        cols = (s0 + np.arange(fmt.frame_len)) % S      # wraparound plant
        idx[:, cols[:fmt.uw_len]] = uw_arr[None, :]
        idx[:, cols[fmt.uw_len:]] = pay_syms[:, j]
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)),
                  sps, axis=1).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return starts, k_frames, infos, x, n_info, n_msg


def config3_cfg(sps: int) -> DemodConfig:
    return DemodConfig(sps=sps, num_avg=NUM_AVG, constellation_size=8,
                       phase_avg=PHASE_AVG, matched_filter="rrc",
                       rrc_beta=0.35, rrc_span=8, timing_interp=True)


def qpsk_cfg(sps: int) -> DemodConfig:
    return DemodConfig(sps=sps, num_avg=NUM_AVG, constellation_size=4,
                       phase_avg=PHASE_AVG)


def config3_signal(C: int, symbols: int, sps: int) -> np.ndarray:
    """8-PSK impulses through the RRC filter, a slow CFO, noise 0.01
    (``bench.py:535-549``)."""
    from ..ops.matched_filter import rrc_taps

    rng = np.random.default_rng(0)
    sym = rng.integers(0, 8, size=(C, symbols))
    pts = np.exp(1j * (2 * np.pi * sym / 8 + 2 * np.pi * 1e-4
                       * np.arange(symbols)))
    up = np.zeros((C, symbols * sps), np.complex64)
    up[:, ::sps] = pts
    taps = rrc_taps(sps, 0.35, 8)
    x = np.stack([np.convolve(u, taps, mode="same") for u in up])
    x = x.astype(np.complex64)
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


def mixed_signal(C: int, symbols: int, sps: int):
    """Per-channel M in {2, 4, 8} and differential flags, each channel from
    its own seed (``bench.py:553-572``).  Returns (x, ms, diffs)."""
    rng = np.random.default_rng(0)
    ms = rng.choice([2, 4, 8], C)
    diffs = rng.random(C) < 0.5
    xs = []
    for i in range(C):
        r = np.random.default_rng(i)
        m = int(ms[i])
        j = r.integers(0, m, symbols)
        pts = np.exp(2j * np.pi * j / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.repeat(pts * np.exp(2j * np.pi * 1e-4 * np.arange(symbols)),
                      sps).astype(np.complex64)
        x += (0.01 * r.standard_normal(x.size)).astype(np.complex64)
        xs.append(x)
    return np.stack(xs), ms, diffs


# --- the run: device, card, counts, timing, lines ---------------------------

def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, and B1's per mode."""
    b1 = demod_kernel.demod_full_tm
    out = {"demod_full_tm": b1.launches,
           "viterbi_fused": viterbi_kernel.viterbi_fused.launches,
           "viterbi_acs": viterbi_kernel.viterbi_acs.launches,
           "viterbi_traceback": viterbi_kernel.viterbi_traceback.launches,
           "timing_frontend_tm": frontend_kernel.timing_frontend_tm.launches}
    out.update({f"demod_full_tm[{m}]": n
                for m, n in b1.mode_launches.items()})
    return out


def launches_since(before: dict) -> dict:
    """Launches since ``before`` (the counters are read, never reset: a
    caller may be counting around the whole run); B1's modes where
    any."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now
            if not k.startswith("demod_full_tm[") or now[k] > before[k]}


class Bench:
    """One run: the device, the card, the timing and the output lines."""

    def __init__(self, device: torch.device):
        self.dev = device
        self.cuda = device.type == "cuda"
        self.card = card_name() if self.cuda else None
        self.kind = self.card or "cpu"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def time_reps(self, rep, reps: int) -> dict:
        """``rep()`` runs one rep and returns (work units, steps, device
        checksum or None).  Returns the line's timing fields."""
        before = launch_counts()
        rates, dev_ms = [], []
        for _ in range(reps):
            self.sync()
            if self.cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            work, steps, chk = rep()
            if self.cuda:
                ev[1].record()
            if chk is not None:
                chk.item()
            self.sync()
            rates.append(work / (time.perf_counter() - t0))
            if self.cuda:
                dev_ms.append(ev[0].elapsed_time(ev[1]) / steps)
        return dict(value=statistics.median(rates), min=min(rates),
                    max=max(rates), reps=reps,
                    device_ms_per_step=(statistics.median(dev_ms)
                                        if dev_ms else None),
                    timing=TIMING if self.cuda else TIMING_CPU,
                    launches=launches_since(before))

    def emit(self, metric: str, unit: str, timed: dict, **fields) -> None:
        line = {"metric": metric, "value": timed["value"], "unit": unit,
                **{k: v for k, v in timed.items() if k != "value"},
                "device": self.dev.type}
        if self.card:
            line["card"] = self.card
        line.update(fields)
        print(json.dumps(line), flush=True)


def _planes(x: np.ndarray, dev, ingest: str):
    """Time-major (T, C) planes of a (C, T) block on ``dev``: float32, or
    the int16 wire format with its scale (``bench.py:185-198``).  Returns
    (x_re, x_im, in_scale or None)."""
    if ingest != "i16":
        return (torch.from_numpy(np.ascontiguousarray(x.real.T)).to(dev),
                torch.from_numpy(np.ascontiguousarray(x.imag.T)).to(dev),
                None)
    scale = float(max(np.abs(x.real).max(), np.abs(x.imag).max())) / 32000.0
    q = [torch.from_numpy(np.ascontiguousarray(
        np.round(p.T / scale).astype(np.int16))).to(dev)
        for p in (x.real, x.imag)]
    return q[0], q[1], scale


def qpsk_decisions(label: str, soft, valid=None) -> dict:
    """Gate of the plain-torch paths: every (valid) soft decision finite
    and within DECISION_TOL of its nearest QPSK point (odd multiples of
    pi/4).  Returns the count and the largest distance."""
    soft = torch.as_tensor(soft)
    if valid is not None:
        soft = soft[torch.as_tensor(valid)]
    if soft.numel() == 0 or not bool(torch.isfinite(soft).all()):
        raise AssertionError(f"{label}: no soft decisions or non-finite "
                             f"ones")
    q = torch.pi / 2
    ang = torch.round((torch.angle(soft) - q / 2) / q) * q + q / 2
    dist = float((soft - torch.polar(torch.ones_like(ang), ang)).abs().max())
    if dist > DECISION_TOL:
        raise AssertionError(f"{label}: a soft decision {dist} from its "
                             f"QPSK point (bound {DECISION_TOL})")
    return dict(decisions=int(soft.numel()), max_distance=dist)


# --- the kernel pipelines ---------------------------------------------------

def run_full(b: Bench, args, cfg, x_np: np.ndarray, raw_tail=False,
             mixed=None) -> tuple:
    """The full-kernel pipeline: warm-up through the feed-forward (or
    mixed) pipeline, ``full_from_ff``, then B1 a block, rolling over the
    repeated block's planes where the config has no matched filter (the
    window of every block is then the same block's tail, as on the
    engine's steady path), else carrying the window.  Returns (timing
    fields, B1Gate's stats)."""
    from ..models import blockpsk, full
    from ..utils.transfer import to_device

    C, T = x_np.shape
    dev = b.dev
    st_ff = blockpsk.ff_init(cfg, C, dev)
    params = None
    x = to_device(x_np, dev)
    if mixed is not None:
        from ..models.mixed import MixedParams, make_mixed_demod_fn
        params = MixedParams.make(*mixed, dev)
        st_ff, _ = make_mixed_demod_fn(cfg)(params, st_ff, x)
    else:
        st_ff, _ = blockpsk.demod_block_ff(cfg, st_ff, x)
    del x
    raw = x_np[:, T - full.window_rows(cfg):] if raw_tail else None
    state = full.full_from_ff(cfg, st_ff, raw_win=raw, mixed_params=params)
    x_re, x_im, in_scale = _planes(x_np, dev, args.ingest)
    if in_scale is not None:
        state = full.quantize_full_state(state, in_scale)
    kw = dict(mixed=mixed is not None, in_scale=in_scale or 1.0,
              soft_i8_scale=I8_SCALE if args.soft == "i8" else None,
              debug_ports=not args.no_debug_ports)
    if cfg.matched_filter == "none":
        carry = state.planes

        def step(planes):
            return full.demod_block_full_rolling(cfg, planes, x_re, x_im,
                                                 x_re, x_im, **kw)
    else:
        carry = state

        def step(st):
            return full.demod_block_full(cfg, st, x_re, x_im, **kw)

    def chksum(out):
        s = out.soft_re.float().sum() + out.bits_packed.sum()
        if out.phase is not None:        # debug planes not written otherwise
            s = s + out.phase.sum() + out.sample_index.sum()
        return s

    for _ in range(args.warmup or 1):
        carry, _ = step(carry)
    with gates.B1Gate("bench full-kernel") as gate:
        carry, _ = step(carry)
        b.sync()

    def rep():
        nonlocal carry
        chk = torch.zeros((), device=dev)
        for _ in range(args.iters):
            carry, out = step(carry)
            chk = chk + chksum(out)
        return C * T * args.iters, args.iters, chk

    return b.time_reps(rep, args.reps), gate.stats


def emit_demod(b: Bench, args, label: str, timed: dict,
               gate: dict) -> None:
    b.emit(f"{args.channels}-channel QPSK streaming demod throughput "
           f"({label}, {b.kind})", "samples/s", timed, gate=gate,
           channels=args.channels, symbols=args.symbols, sps=args.sps,
           steps=args.iters, warmup=args.warmup or 1, ingest=args.ingest,
           soft=args.soft, debug_ports=not args.no_debug_ports)


def run_plain(b: Bench, args, cfg, x_np: np.ndarray, pipeline: str) -> None:
    """The feed-forward pipeline (``models/blockpsk``) or the exact scan
    (``models/psk``) over (C,) channels, plain torch; the exact scan at
    most EXACT_STEPS steps a rep."""
    from ..models import blockpsk, psk
    from ..utils.transfer import to_device

    C, T = x_np.shape
    x = to_device(x_np, b.dev)
    if pipeline == "ff":
        state, block = blockpsk.ff_init(cfg, C, b.dev), blockpsk.demod_block_ff
        steps = args.iters
    else:
        state, block = psk.demod_init(cfg, C, b.dev), psk.demod_block
        steps = min(args.iters, EXACT_STEPS)
    for _ in range(max(args.warmup, 1)):
        state, out = block(cfg, state, x)
    state, out = block(cfg, state, x)
    gate = qpsk_decisions(f"bench {pipeline}", out.soft, out.valid)

    def rep():
        nonlocal state
        chk = torch.zeros((), device=b.dev)
        for _ in range(steps):
            state, out = block(cfg, state, x)
            chk = chk + (out.phase.sum() + out.soft.real.sum()
                         + out.bits.sum() + out.sample_index.sum())
        return C * T * steps, steps, chk

    emit_demod(b, with_args(args, iters=steps), pipeline,
               b.time_reps(rep, args.reps), gate)


def with_args(args, **changes):
    out = copy.copy(args)
    for k, v in changes.items():
        setattr(out, k, v)
    return out


def run_fused(b: Bench, args, cfg, x_np: np.ndarray) -> None:
    """``models/fused`` (B5, then the plain-torch symbol backend) with the
    converged fast path after the warm-up, planes resident on the card."""
    from ..models.fused import demod_block_fused, fused_init

    C, T = x_np.shape
    x_re, x_im, _ = _planes(x_np, b.dev, "f32")
    state = fused_init(cfg, C, b.dev)
    for _ in range(max(args.warmup, 1)):
        state, _ = demod_block_fused(cfg, state, x_re, x_im)
    gate = gates.check_b5("bench fused", state.win_re, state.win_im, x_re,
                          x_im, sps=cfg.sps, num_avg=cfg.num_avg)
    state, out = demod_block_fused(cfg, state, x_re, x_im,
                                   assume_steady=True)

    def rep():
        nonlocal state
        chk = torch.zeros((), device=b.dev)
        for _ in range(args.iters):
            state, out = demod_block_fused(cfg, state, x_re, x_im,
                                           assume_steady=True)
            chk = chk + (out.phase.sum() + out.soft.real.sum()
                         + out.bits.sum() + out.sample_index.sum())
        return C * T * args.iters, args.iters, chk

    emit_demod(b, args, "fused", b.time_reps(rep, args.reps), gate)


def full_label(args) -> str:
    label = ("full-kernel" if args.ingest == "f32"
             else "full-kernel i16-ingest")
    if args.soft == "i8":
        label += " soft-i8"
    if args.no_debug_ports:
        label += " no-debug-ports"
    return label


def run_default(b: Bench, args) -> None:
    """``--profile default``: the ``--pipeline`` lines, then (auto, full)
    the chain's line, as ``bench.py:972-1103`` and ``_chain_after_default``
    (every variant on its own line; none is picked)."""
    cfg = qpsk_cfg(args.sps)
    x_np = qpsk_block(args.channels, args.symbols, args.sps)
    if args.pipeline in ("full", "auto"):
        emit_demod(b, args, full_label(args), *run_full(b, args, cfg, x_np))
        if args.pipeline == "auto" and not args.no_debug_ports:
            ndp = with_args(args, no_debug_ports=True)
            emit_demod(b, ndp, full_label(ndp), *run_full(b, ndp, cfg, x_np))
        if args.pipeline == "auto":
            run_plain(b, args, cfg, x_np, "ff")
        run_chain(b, with_args(args, profile="chain",
                               iters=max(20, args.iters // 2)))
    elif args.pipeline == "fused":
        run_fused(b, args, cfg, x_np)
    else:
        run_plain(b, args, cfg, x_np, args.pipeline)


def run_profile(b: Bench, args) -> None:
    """BASELINE config 3 and the mixed bank on B1 (``bench.py:528-574``)."""
    C, sps = args.channels, args.sps
    if args.profile == "config3":
        x_np = config3_signal(C, args.symbols, sps)
        timed, gate = run_full(b, args, config3_cfg(sps), x_np,
                               raw_tail=True)
        emit_demod(b, args, "config3 8PSK+RRC+interp full-kernel", timed,
                   gate)
        return
    x_np, ms, diffs = mixed_signal(C, args.symbols, sps)
    timed, gate = run_full(b, args, qpsk_cfg(sps), x_np, mixed=(ms, diffs))
    emit_demod(b, args, "mixed-mode full-kernel", timed, gate)


# --- the receive chain (bench.py:311-472) ------------------------------------

def chain_frames(args, rng):
    """The chain's and the receiver's frame format and planted stream:
    (cfg, fmt, code, crc, plant_unaligned_frames(...))."""
    from ..ops.crc import CRC16_CCITT
    from ..ops.fec import CODE_K7
    from ..ops.framesync import FrameFormat

    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, args.uw_len)),
                      payload=args.payload, m=4, threshold=0.7)
    return (qpsk_cfg(args.sps), fmt, CODE_K7, CRC16_CCITT,
            plant_unaligned_frames(args.channels, args.symbols, args.sps,
                                   fmt, CODE_K7, CRC16_CCITT, rng))


def chain_setup(args, dev):
    """The seam chain on ``dev`` after the warm-up and hand-off: B1 (debug
    ports off; int16 planes with ``--ingest i16``), then the seam tail.
    Returns a namespace with ``state`` and ``tail`` (the carries),
    ``carry_step((state, tail))`` and ``roll_step((planes, tail))`` (each
    -> (carry, ChainOutputs)), and the plan: ``infos``, ``rows`` (each
    planted frame's detection row mod S), ``k_frames``, ``n_info``."""
    from ..models import blockpsk, full
    from ..models.chain import make_seam_tail_fn, seam_tail_init
    from ..utils.transfer import to_device

    cfg, fmt, code, crc, plan = chain_frames(args,
                                             np.random.default_rng(12))
    starts, k_frames, infos, x_np, n_info, _ = plan
    C, S = args.channels, args.symbols
    st_ff, _ = blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, C, dev),
                                       to_device(x_np, dev))
    state = full.full_from_ff(cfg, st_ff)
    x_re, x_im, in_scale = _planes(x_np, dev, args.ingest)
    if in_scale is not None:
        state = full.quantize_full_state(state, in_scale)
    kw = dict(debug_ports=False, in_scale=in_scale or 1.0)
    tail_step = make_seam_tail_fn(fmt, code, k_frames, crc=crc,
                                  labeling="gray")

    def carry_step(carry):
        st2, fo = full.demod_block_full(cfg, carry[0], x_re, x_im, **kw)
        tail2, out = tail_step(carry[1], fo.soft_re, fo.soft_im)
        return (st2, tail2), out

    def roll_step(carry):
        p2, fo = full.demod_block_full_rolling(cfg, carry[0], x_re, x_im,
                                               x_re, x_im, **kw)
        tail2, out = tail_step(carry[1], fo.soft_re, fo.soft_im)
        return (p2, tail2), out

    return SimpleNamespace(
        state=state, tail=seam_tail_init(fmt, C, dev), carry_step=carry_step,
        roll_step=roll_step, infos=infos, k_frames=k_frames, n_info=n_info,
        rows=[(p + cfg.num_avg - 1) % S for p in starts])


def run_chain(b: Bench, args) -> None:
    """B1 -> frame sync -> LLRs -> B2 -> CRC a block, the carry path and
    then the rolling path each gated on a steady block (every planted
    frame at its row with exact bits and the CRC green) before timing."""
    p = chain_setup(args, b.dev)
    C, S = args.channels, args.symbols
    carry = (p.state, p.tail)
    for _ in range(3):                         # the third is a steady period
        carry, outs = p.carry_step(carry)
    gate = {"carry_path_frames": gates.check_chain_steady(outs, p.infos,
                                                          p.rows, S)}
    carry, outs = p.roll_step((carry[0].planes, carry[1]))
    gate["rolling_path_frames"] = gates.check_chain_steady(outs, p.infos,
                                                           p.rows, S)
    for _ in range(args.warmup or 1):
        carry, _ = p.roll_step(carry)

    def rep():
        nonlocal carry
        chk = torch.zeros((), device=b.dev, dtype=torch.int64)
        for _ in range(args.iters):
            carry, o = p.roll_step(carry)
            chk = chk + (o.msg.to(torch.int32).sum() + o.found.sum()
                         + o.ok.sum() + o.count.sum())
        return C * p.k_frames * p.n_info * args.iters, args.iters, chk

    timed = b.time_reps(rep, args.reps)
    tag = " i16-ingest" if args.ingest == "i16" else ""
    b.emit(
        f"{C}-channel receive-chain throughput (demod+seam sync+Viterbi+CRC "
        f"one-program{tag}, {p.k_frames} frames/block/ch unaligned cadence, "
        f"{b.kind})", "infobits/s", timed, gate=gate, channels=C,
        symbols=S, sps=args.sps, steps=args.iters, warmup=args.warmup or 1,
        ingest=args.ingest, frames_per_block_per_channel=p.k_frames)


# --- the production paths ---------------------------------------------------

def engine_blocks(args) -> int:
    return max(10, min(50, args.iters // 10))


def run_engine(b: Bench, args) -> None:
    """Native bank deframe -> engine step -> packet assembly at pipeline
    depths 0 and ``--engine-depth`` (``bench.py:577-695``), every block's
    packets fetched."""
    from ..runtime.engine_batch import BatchEngine
    from ..runtime.engine_full import FullKernelBatchEngine
    from ..runtime.native_bank import NativeChannelBank, NativePlaneBank
    from ..runtime.streams import PORT_SOFT, SRI

    cfg = qpsk_cfg(args.sps)
    C, S = args.channels, args.symbols
    need = S * cfg.sps
    rng = np.random.default_rng(0)
    pts = np.exp(1j * (2 * np.pi * rng.integers(0, 4, (C, S)) / 4
                       + 2 * np.pi * 1e-4 * np.arange(S)))
    blk = np.repeat(pts, cfg.sps, axis=1).astype(np.complex64)
    blk += (0.01 * rng.standard_normal(blk.shape)).astype(np.complex64)
    frames32 = np.ascontiguousarray(blk.T).view(np.float32).ravel()
    scale = float(np.abs(frames32).max()) / 32000.0
    frames16 = np.round(frames32 / scale).astype(np.int16)
    i16, i8 = args.ingest == "i16", args.soft == "i8"
    nblocks = engine_blocks(args)
    for depth in sorted({0, max(0, args.engine_depth)}):
        kernel = C % 128 == 0
        foreign = []          # channels whose mode the QPSK block is not in
        if kernel and args.profile == "mixed":
            from ..models.mixed import MixedParams
            from ..runtime.engine_mixed import MixedKernelBatchEngine
            ms = rng.choice([2, 4, 8], C)
            eng = MixedKernelBatchEngine(
                MixedParams.make(ms, rng.random(C) < 0.5, b.dev), cfg, C,
                block_symbols=S, pipeline_depth=depth,
                ingest_scale=scale if i16 else None, soft_i8=i8,
                device=b.dev)
            label = "mixed-bank engine"
            # bench.py feeds the mixed bank the QPSK block too: a BPSK
            # channel slices QPSK points on its decision boundary, so B1's
            # bits are held on the QPSK channels only (its sample picks on
            # every channel).
            foreign = np.nonzero(ms != 4)[0].tolist()
        elif kernel:
            eng = FullKernelBatchEngine(
                cfg, C, block_symbols=S, pipeline_depth=depth,
                ingest_scale=scale if i16 else None, soft_i8=i8,
                device=b.dev)
            label = "full-kernel engine"
        else:
            eng = BatchEngine(cfg, C, block_symbols=S, pipeline_depth=depth,
                              device=b.dev)
            label = "ff engine"
        if kernel:
            label += (" i16-ingest" if i16 else "") + (" soft-i8" if i8
                                                        else "")
            bank = NativePlaneBank(C, capacity_samples=4 * need,
                                   dtype="i16" if i16 else "f32")
            frames = frames16 if i16 else frames32

            def feed_one():
                bank.push_interleaved(frames)
                re, im, _ = bank.pop_planes(need, timeout=0)
                eng.push_planes(re, im)
                return eng.step_packets()
        else:
            bank = NativeChannelBank(C, capacity_samples=4 * need)

            def feed_one():
                bank.push_interleaved(frames32)
                eng.push_block(bank.pop_block(need, timeout=0)[0])
                return eng.step_packets()
        eng.set_input_sri(SRI(stream_id="bench", xdelta=1e-6))

        # Warm-up: converge and reach the steady kernel; then one gated
        # block.
        for _ in range(max(3, (cfg.num_avg + cfg.phase_avg) // S + 2)):
            feed_one()
        if kernel:
            with gates.B1Gate(f"bench {label}", foreign) as g:
                feed_one()
                b.sync()
            gate = dict(g.stats, channels_not_held=len(foreign))
        else:
            gate = qpsk_decisions(f"bench {label}",
                                  feed_one()[PORT_SOFT].data)

        def rep():
            emitted = fed = 0
            while emitted < nblocks:
                if feed_one():
                    emitted += 1
                fed += 1
                if fed > 4 * nblocks:
                    raise RuntimeError("engine starved")
            return emitted * C * need, fed, None

        timed = b.time_reps(rep, args.reps)
        bank.close()
        b.emit(f"{C}-channel QPSK end-to-end {label} throughput "
               f"(pipeline_depth={depth}, {b.kind})", "samples/s", timed,
               gate=gate, channels=C, symbols=S, sps=args.sps,
               blocks=nblocks, ingest=args.ingest, soft=args.soft,
               pipeline_depth=depth)


def run_receiver(b: Bench, args) -> None:
    """The streaming receiver (``bench.py:698-866``): per-stage
    (``build_receiver(engine="full")``, or ``"batch"`` where channels % 128
    != 0) or, with ``--receiver-fused``, ChainEngine behind the receiver
    surface.  Every frame popped in the warm-up is validated before the
    timing; every frame popped in a rep is validated after its clock
    stops, and a rep must pop at least (blocks - 2) * k * C frames."""
    from ..runtime.receiver import build_receiver
    from ..runtime.streams import SRI

    C, S = args.channels, args.symbols
    cfg, fmt, code, crc, plan = chain_frames(args, np.random.default_rng(12))
    starts, k_frames, infos, x_np, n_info, _ = plan
    need = S * cfg.sps
    common = dict(block_symbols=S, uw=fmt.uw, frame_payload=fmt.payload,
                  uw_threshold=0.7, fec=code, fec_labeling="gray", crc=crc,
                  device=b.dev)
    if args.fused_receiver:
        if C % 128:
            raise ValueError("--receiver-fused needs channels % 128 == 0")
        rx = build_receiver(cfg, C, engine="chain",
                            engine_kwargs={"pipeline_depth": 1}, **common)
        pre = np.ascontiguousarray(x_np.real.T)
        pim = np.ascontiguousarray(x_np.imag.T)

        def feed_one():
            rx.engine.push_planes(pre, pim)
            got = rx.engine.step() or []
            rx.engine.pop_frames()
            return got

        what = (f"{C}-channel FUSED receiver throughput (ChainEngine: "
                f"one-launch demod+sync+Viterbi+CRC, frame-table-only fetch, "
                f"{k_frames} frames/block/ch, {b.kind})")
        depth, bank = 1, None
    else:
        from ..runtime.native_bank import NativeChannelBank, NativePlaneBank

        use_full = C % 128 == 0
        depth = max(0, args.engine_depth)
        ekw = {"pipeline_depth": depth}
        frames_only = use_full and args.frames_only
        if frames_only:
            ekw["data_ports"] = False
        rx = build_receiver(cfg, C, engine="full" if use_full else "batch",
                            engine_kwargs=ekw, **common)
        rx.engine.set_input_sri(SRI(stream_id="bench", xdelta=1e-6))
        frames32 = np.ascontiguousarray(x_np.T).view(np.float32).ravel()
        if use_full:
            bank = NativePlaneBank(C, capacity_samples=4 * need)

            def feed_one():
                bank.push_interleaved(frames32)
                re, im, _ = bank.pop_planes(need, timeout=0)
                rx.engine.push_planes(re, im)
                rx.engine.step_packets()
                return rx.pop_frames()
        else:
            bank = NativeChannelBank(C, capacity_samples=4 * need)

            def feed_one():
                bank.push_interleaved(frames32)
                rx.engine.push_block(bank.pop_block(need, timeout=0)[0])
                rx.engine.step_packets()
                return rx.pop_frames()

        what = (f"{C}-channel production streaming receiver throughput "
                f"(deframe->engine->FrameSyncer->Viterbi->CRC->pop_frames"
                f"{' frames-only' if frames_only else ''}, {k_frames} "
                f"frames/block/ch, depth={depth}, {b.kind})")

    # Warm-up: converge and reach frame steady state; its frames gated.
    warm = []
    for _ in range(max(4, (cfg.num_avg + cfg.phase_avg) // S + 3)):
        warm += feed_one()
    gate = {"warmup_frames": gates.check_frames("bench receiver warm-up",
                                                warm, starts, infos, S)}
    nblocks = engine_blocks(args)
    popped = []

    def rep():
        got = []
        for _ in range(nblocks):
            got += feed_one()
        popped.append(got)
        return len(got) * n_info, nblocks, None

    timed = b.time_reps(rep, args.reps)
    if bank is not None:
        bank.close()
    for got in popped:
        gates.check_frames("bench receiver", got, starts, infos, S)
        if len(got) < (nblocks - 2) * k_frames * C:
            raise AssertionError(f"receiver starved: {len(got)} frames in "
                                 f"{nblocks} blocks")
    gate["timed_frames"] = sum(len(g) for g in popped)
    b.emit(what, "infobits/s", timed, gate=gate, channels=C, symbols=S,
           sps=args.sps, blocks=nblocks, pipeline_depth=depth,
           frames_per_block_per_channel=k_frames)


def run_mesh(b: Bench, args) -> None:
    """``eval/scaling``'s channel report on B1 and (``--profile chain``)
    the chain report, and the time-sharded report, on MESH_SHARDS shards
    of ``--device``, one line each (``bench.py:491-525``)."""
    from ..eval.scaling import (chain_scaling_report, channel_scaling_report,
                                time_shard_report)
    from ..parallel.mesh import shard_devices

    cfg = config3_cfg(args.sps) if args.profile == "config3" \
        else qpsk_cfg(args.sps)
    devs = shard_devices(b.dev, max(MESH_SHARDS))
    runs = [lambda: channel_scaling_report(
        cfg, device_counts=MESH_SHARDS,
        channels_per_device=min(args.channels, 256),
        symbols=min(args.symbols, 256), iters=max(2, args.iters // 50),
        reps=args.reps, pipeline="full", devices=devs)]
    if args.profile == "chain":
        runs.append(lambda: chain_scaling_report(
            cfg, device_counts=MESH_SHARDS, channels_per_device=128,
            symbols=512,
            iters=max(2, args.iters // 100), reps=args.reps, devices=devs))
    runs.append(lambda: time_shard_report(
        cfg, time_counts=MESH_SHARDS, channels=128, total_symbols=4096,
        iters=max(2, args.iters // 100), reps=args.reps, devices=devs))
    for run in runs:
        before = launch_counts()
        rep = run()
        b.sync()
        line = {"metric": f"scaling report ({rep['mode']}, {b.kind})",
                **rep, "timing": "eval/scaling: best of reps, host clock, "
                "each step summed into a checksum read with .item()",
                "launches": launches_since(before), "device": b.dev.type}
        if rep["shards_share_device"]:
            line["label"] = ("shards of one device: the cost of sharding, "
                             "not a scaling figure")
        if b.card:
            line["card"] = b.card
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is false; the bench needs "
              "an NVIDIA GPU (--device cpu runs the kernels' plain "
              "versions)", file=sys.stderr)
        return 1
    b = Bench(dev)
    if args.receiver:
        run_receiver(b, args)
    elif args.engine:
        run_engine(b, args)
    elif args.mesh:
        run_mesh(b, args)
    elif args.profile == "chain":
        run_chain(b, args)
    elif args.profile != "default":
        run_profile(b, args)
    else:
        run_default(b, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
