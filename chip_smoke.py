#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (psk_soft_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. toolchain: the card's name and power limit, torch / CUDA / nvcc
     versions, whether triton imports;
  2. build kernel B1 (csrc/demod_full.cu), kernels B2, B3, B4
     (csrc/viterbi.cu) and B5 (csrc/frontend.cu) with nvcc for sm_90a,
     one nvcc per source, started together; print ptxas's registers and
     spills of each kernel;
  3. kernel B1 (stage A: timing and raw phase; stage B: tracking) against
     its plain-PyTorch version on the card at 1024 channels x 512
     symbols, sps 8, num_avg 100, phase_avg 50: M in {2, 4, 8, 16},
     differential, debug ports off, int8 soft, and a two-block carry;
     bits and sample_index equal, phase within 2e-3, soft within 3e-3;
     then edges (C = 1000; S in {1, 5, 37, 129} over two blocks; sps 40,
     a shorter staged chunk), poison (NaN and +inf planted: equal picks,
     non-finite values where the plain version's are) and noise (a
     differing sample index only at a near tie, counted); then B1's other
     modes at 1024 x 512 (b1_modes_phase): int16 ingest (also bit-equal to
     the float32 kernel on the dequantized planes), timing_interp, the
     matched filter at config 3's widths, config 3 whole on int16 planes,
     mixed at config 4's; edges C = 1000 and S in {1, 37} in config 3 and
     mixed; NaN and +inf raw samples under the matched filter; then stage
     0 alone (fir_phase: matched_filter_tm, C 1000 and 1024, 1-257 taps,
     float32 with NaN and +inf planted and int16, within 1e-5 of
     sum|taps| * max|raw|);
  4. the engine end to end: NativePlaneBank -> FullKernelBatchEngine on
     the card -> step_packets, 1 warm-up block + 10 steady blocks + a
     flush, against the same engine on the CPU (the plain version);
  5. per-block times with CUDA events (kernel and plain version on the
     same CUDA tensors), B1's stage times from one torch.profiler pass,
     the same for each of B1's other modes (b1_mode_times), stage 0 alone
     beside F.conv2d of the same planes (fir_times), and the engine's
     end-to-end samples/s;
  6. the Viterbi kernels against their plain versions on the card, bits
     and decisions equal (torch.equal), final metrics within 1e-5 with NaN
     where the plain version has it; B2's and B3's launch plan equal to
     the library's own at the edges.  (a) B2 and B3 at the chain shape
     (K7, n 2, 64 steps, 6144 rows) terminated and not, noisy and hard
     +/-1 LLRs, and K3, K9, K10, punctured 2/3 and 3/4, rate 1/3; then on
     random planes: B = 6145, t_actual 0 and 1, T_pad > t_actual, random
     pm0 rows, NaN in pm0 rows 5 and 40 (terminate=False, t_actual 1 and
     3: the start state takes the first NaN, as torch.argmax); B2 at its
     longest trellises (K2, K7, K9 at 1472 steps, K10 at 704; n 2, 3 and
     8), where its blocks shrink to one or two warps.  (b) The
     fused path against the two-phase path (t_tile given) at the chain
     shape.  (c) B3 + B4 on long trellises (K7 512 rows x 4096 and 4133
     steps, K9 256 x 1024); B4 on random planes from starts inside and
     outside [0, S) (S, S + 5, -1, -7): K3, K7, K9, K10, B = 6145 and 6148
     (byte and 4-byte copies), t_actual 0 and 1, T_pad > t_actual; plans
     the kernel did not expect refused;
  7. ChainEngine end to end at 1024 channels x 512 symbols (QPSK, UW 32,
     payload 64, K7, CRC-16, 4 frames per block per channel on an
     unaligned cadence): 1 warm-up block, 10 steady blocks and a flush on
     the card, every planted frame after the warm-up decoded exactly once
     with exact bits and the CRC green, the frame list equal to the same
     engine's on the CPU, B1 and B2 launched at least once per block;
  8. times: B2 per block and B3, B4 at the long shape, the wrapper's
     against their plain versions (CUDA events), and their kernels' device
     time (torch.profiler); the chain engine end to end
     at pipeline depth 0 and 1 with a host-clock breakdown, one
     torch.profiler pass (B2's and B1's device ms per block and share of
     the busy time, host-to-device copies per block);
  9. kernel B5 (csrc/frontend.cu, built with the others in phase 2)
     against its plain version at 1024 x 512: equal on planted symbols,
     with a NaN and an +inf planted (equal picks, non-finite values where
     the plain version's are) and at B1's edges (C 1000, S 1/5/37/129,
     sps 40); on pure noise a differing sample index only at a near tie
     (top two window sums within NEAR_TIE_REL), counted; its times;
 10. the fused pipeline (models/fused: B5 + the symbol backend), 1 flexible
     + 10 assume_steady blocks, against blockpsk on the same card (bits
     and sample index equal, soft 2e-4, phase 1e-3), and its samples/s
     with the planes resident on the card;
 11. FullKernelBatchEngine's lifecycle at full width: configure mid-stream
     (num_avg 100 -> 80, phase_avg 50 -> 40) against a CPU run of the
     first 128 channels; save_state -> load_state -> restore_full_state
     bit-equal to the uninterrupted run; guard_nonfinite with NaN and inf
     planted: channel_resyncs equal to the CPU run's, healthy channels
     bit-equal to an unpoisoned run;
 12. ChainEngine(acquire_cfo=True) with offsets 0.018 + 0.006*c/C
     cycles/sample: every planted frame after the warm-up decoded once
     with exact bits, the estimates within 1e-4, the plain engine under
     half;
 13. ops/fec.viterbi_decode on a 2048-step trellis (B3 then B4), bits
     equal to the plain decoder on the CPU;
 14. NativePlaneBank("i16") -> FullKernelBatchEngine at BASELINE config 3
     (8-PSK, RRC, timing_interp) with ingest_scale at 1024 channels, 1
     warm-up + 10 steady blocks + a flush, against the same engine on the
     CPU for the first 128 channels; its samples/s and a profiled pass;
 15. MixedKernelBatchEngine at config 4's widths at 1024 channels (M and
     differential per channel), set_params mid-stream, against a
     128-channel CPU run;
 16. the reference's golden vectors on the card: the port's gen_psk through
     make_demod_fn (the exact scan) for M in {2, 4, 8}, differential and
     not: 901 valid outputs, soft within 1e-3 of the transmitted symbols,
     bits exact where the rotation is known; the port's demod_reference
     on decisive signals against the card's scan (sample index equal, soft
     and phase within 2e-3);
 17. BatchEngine at 1024 x 512 (QPSK, num_avg 100, phase_avg 50): "ff" for
     1 + 10 blocks and a flush with guard_nonfinite, NaN and +inf planted
     in two channels; "exact" for 1 + 3 blocks; each against a 128-channel
     CPU run (bits, sample index and channel_resyncs equal, soft 3e-3,
     phase 2e-3); the exact scan's ms per block and the ff engine's
     samples/s at depth 0 and 1;
 18. StreamEngine, both pipelines, one stream of 20 blocks with a rate
     change, two configures, a queue flush, a real-mode packet and EOS
     with a partial block; StreamRegistry with 64 interleaved streams;
     packets, SRIs, timestamps, metrics and port_stats equal to a CPU run;
     one stream's samples/s;
 19. GroupEngine over BASELINE configs 1, 2 and 3 (1024 channels),
     step_all_packets, a partition-preserving configure, a splitting one
     that raises, flush_all_packets, against a 128-channel CPU run.
Phases 16-19 run no kernel: the exact scan and the feed-forward pipeline
are plain PyTorch, as they are plain XLA in the JAX package.
 20. the streaming Viterbi decoder (ops/fec.viterbi_stream_step: B3 and
     B4 each block, B4 for the flush): 1024 K7 streams, 6 blocks of 512
     steps, depth 70, against the plain loops on the CPU (bits and windows
     equal, metrics within 1e-5 with NaN equal) and, after the lag, one
     unterminated decode of the whole stream; known_start=False, punctured
     2/3 and K9 at 256 rows; a checkpoint saved mid-stream on the card,
     reloaded and continued; StreamFecDecoder under
     build_receiver(stream_fec=CODE_K7) over FullKernelBatchEngine at
     1024 channels against a 128-channel CPU run; B3 and B4 at the
     streaming shape (CUDA events and device time) and the window
     re-layout's time;
 21. viterbi_decode_parallel at 1024 rows x 8192 steps, chunk 512 (16,384
     windows of 652 steps on B2) and chunk 2048 (2188-step windows on B3 +
     B4), bits equal to the sequential decode and to the CPU;
 22. the per-stage receiver: NativePlaneBank -> build_receiver(engine=
     "full", UW 32, payload 64, K7 Gray, PRBS15, CRC-16) with the device
     tap at 1024 channels on phase 7's cadence (payloads scrambled at the
     transmitter): every planted frame after the warm-up popped once, CRC
     green, exact info bits; equal to a 128-channel CPU run (frame lists,
     bits and info bits equal, corr within B1's 3e-3), its frame-side
     stages replayed on the CPU from the card's tapped blocks (soft and
     corr within 1e-5), ChainEngine on the
     same stream, and the runs at depth 1 and without data ports; its
     infobits/s and samples/s at depth 0 and 1 beside ChainEngine's, the
     host ms of each stage, a profiled pass; GroupFrameSyncer over the
     config-4 MixedKernelBatchEngine against a CPU run.  Phase 7 also
     drives build_receiver(engine="chain") and wants ChainEngine's frames.
     The main run holds every B1 launch against its plain version on the
     same window, planes and carry (B1Gate: bits equal, soft and phase
     within B1's bounds where the sample index is equal, a differing
     index only at a near tie), and counts the near ties;
 23. the front-end receiver: phase 22's stream with a one-symbol echo, a
     carrier offset beyond the tracker's lock range, a level per channel
     in -20..+10 dB and 4 noise-only channels, uploaded once, through
     build_receiver(engine="full", agc, equalize=EqConfig(taps=33),
     acquire_cfo, quality, UW 32, payload 64, K7 Gray, PRBS15, CRC-16) at
     1024 channels for 8 convergence + 10 steady blocks and a flush, every
     B1 launch held by B1Gate: every planted frame after convergence
     popped once, CRC green, exact info bits; CFOs within 2e-4; the CMA
     cost down 5x; lock > 0.8 and alarms exactly the noise channels;
     against a 128-channel CPU run (frames, CFOs, AGC gains, equalizer
     weights, quality EMAs); B1 once a steady block and B2 once a drain;
     infobits/s and samples/s beside phase 22's, host ms per front end, a
     profiled pass.
 24. the input side (ROADMAP A.8 part 2), each part against a CPU run:
     (a) a wideband capture of 1024 channels (raised-cosine QPSK, 4 left
     empty, a polyphase synthesis bank) -> ChannelizerFrontEnd (8 taps a
     branch) -> FullKernelBatchEngine, 1 warm-up + 6 steady blocks of 512
     symbols, every B1 launch held by B1Gate: the channelizer within 2e-5
     of its CPU run and of the direct DDC on 8 channels, B1 once a steady
     block, packets equal a 128-channel CPU run, every occupied channel's
     99th-percentile QPSK angle error under 0.1, one block of
     channelize_block_os2 within 2e-5 of its CPU run; (b)
     ResampledBankEngine into B1 at 1024 channels on the gather path
     (native sps 7.3-9.25), the uniform path (10 -> 8) and the grouped
     path (7.3, 8.0, 8.9, 9.25), 1 + 4 blocks and a flush each, B1 once a
     steady block, packets equal a 128-channel CPU run; (c) estimate_baud
     and classify_psk on 1024 x 8192 samples (planted sps, M in {2, 4, 8},
     CFO; noise channels): card equals CPU, planted values recovered; (d)
     a producer thread -> NativePacketQueue -> FeedThread -> StreamEngine
     on the card, 64 packets, equal to a CPU StreamEngine, and a forced
     overflow that flags the next packet and resets the engine.  Times:
     the channelizer's device ms a block beside its bound and the
     upload's ms, the wideband path's samples/s, each resampler path's
     host and device ms a block, the probe's ms.
 25. the TX and evaluation layer (ROADMAP A.9, A.10): (a) the step
     factories at 1024 x 512: make_scanned_full_demod_fn over 4 blocks
     bit-equal (torch.equal, every output and the final carry) to 4
     demod_block_full calls, make_mixed_full_demod_fn one block at config
     4's widths, B1 launched 4 and 1 times; (b) eval/coded.
     measure_chain_fer at 1024 channels, 3 blocks, at
     tests/test_coded_ber.py's points and gates (12 dB with a CFO spread,
     8 dB, -2 dB, the acquisition leg), B1 and B2 once a block, the 8 dB
     point at 128 channels equal on the card and the CPU; (c)
     measure_coded_ber on B2 at tests/test_coded_ber.py's points, each
     equal to the CPU, B2 once a point; (d) BASELINE configs 1-4 at full
     size, each pass; (e) the CLI as subprocesses (selftest, baseline
     --config 1, ber --esn0 8,11 -M 4, gen-frames), rc 0, the gen-frames
     capture through build_receiver on the card with every truth frame
     decoded.  Every B1 launch of (a) and (b) is held by B1Gate (the
     chain runs without debug ports: the gate adds a checking launch with
     them).  Times: seconds and information bits/s per chain-FER point,
     coded bits/s, measure_ber's symbols/s, seconds per config, the
     phase's total.
 26. the port's CLI (ROADMAP A.13) through ``cli.main`` in-process on
     capture files of 1024 channels x 6 blocks of 512 symbols (phase 7's
     planted K7 + CRC-16 frames, Gray, 201 MB of cf32 wire), each run's
     launches counted around it: (a) demod-batch --pipeline full --uw
     --fec k7 --crc crc16, every planted frame after the warm-up block
     decoded once with the CRC green and exact info bits, .bits.i16 and
     .index.i16 byte-equal to NativePlaneBank -> FullKernelBatchEngine
     in-process on the card, .soft.cf32 and .phase.f32 within B1's bounds
     of it; (b) --fused-chain, the same frames; (c) --in-format ci16
     --no-debug-ports --soft-i8 on the capture quantized to int16, equal
     to the int16-ingest engine in-process, and the same run as ``python
     -m psk_soft_tpu_torch demod-batch`` in a subprocess, byte-equal; (d)
     --fec-stream k7, .fecstream.i8 equal to StreamFecDecoder in-process
     over the run's soft port; (e) --agc --acquire-cfo --quality-report
     with the frame flags on the capture with carrier offsets 0.018 +
     0.006*c/C cycles/sample, every planted frame after acquisition
     decoded, the report parsed; (f) demod ff over one stream of 2^20
     samples and exact over two blocks, each equal to StreamEngine
     in-process.  Each run's seconds, wire Msamples/s and information
     bits/s, beside phases 5, 7 and 22's in-process rates, and one more
     run of (a) under cProfile: the host functions with the most own time.
 27. the sharding layer (ROADMAP A.11) on meshes whose shards are the one
     card (its "cuda:0" repeated), at BASELINE config 5's widths (4096
     QPSK channels, sps 8, num_avg 100, phase_avg 50; signals made on the
     card from a seed): (a) make_sharded_demod at 4096 x 1024 on meshes
     1x1, 2x4, 4x2, 1x8, each equal to the single-device ff under config
     5's gate (bits equal on valid, soft within 1e-3), the first 128
     channels equal to a CPU mesh's run; (b) make_sharded_full_demod on 1,
     2 and 4 chan shards over 10 steady blocks after the ff warm-up and
     full_from_ff, every output and the carry torch.equal to
     demod_block_full on one device, B1 launched shards x blocks times;
     (c) make_time_sharded_full_demod at 4096 x 2048 on meshes 1x4, 2x2,
     2x4 in six profiles (QPSK, 8-PSK, differential; config 3's RRC +
     timing_interp; mixed at config 4's widths; int16 in with int8 soft
     out) against the ff (the mixed pipeline; the float32 run) as
     tests/test_time_sharded_full.py holds them, B1 once a shard a call;
     every B1 launch of (b) and (c) held by B1Gate; (d)
     make_sharded_channelize on phase 24a's capture over 4 time shards
     within 2e-5 of channelize_block; (e) DistributedBatchEngine at 4096
     channels, 1 + 10 blocks and a flush, in a world-size-1 NCCL group in
     this process and as two processes over gloo on the card (2048
     channels each), packets equal to BatchEngine's; (f) run_config(5,
     quick=False) and ``baseline --config 5 --full`` as a subprocess; (g)
     eval/scaling's three reports on 1, 2 and 4 shards of the card
     (labelled: sharding's cost, not scaling), B1 and B2 counted; (h)
     graft_entry.dryrun_multichip(8) on the card (B1, B2, B3, B4).  Each
     path's ms a call beside its single-device path's.
 28. the port's bench (psk_soft_tpu_torch/tools/bench.py, the root
     bench.py's counterpart) through ``bench.main`` in-process on every
     mode at --iters 5 --reps 2: the default run (B1 with and without
     debug ports, the feed-forward pipeline, the chain), --pipeline full
     with int16 in and int8 soft out, ff, exact and fused, --profile
     config3, mixed and chain, --engine (float32; int16 + int8; the mixed
     bank), the three receivers and --mesh with the chain report; each
     mode returns 0 with its lines, each line names the card and carries
     its gate (B1Gate, check_b5, the chain's steady check, the frame
     check; tools/gates.py, which holds the gates of phases 7, 9 and
     22-27 too), and the kernels of each mode launched in its timed
     windows; each mode's launches counted around its whole run.
 29. conformance: the port held to the JAX package's randomized suites
     (psk_soft_tpu_torch/testing/conformance.py, the cases of
     tests/test_fuzz_full_kernel.py, test_fuzz_output_formats.py,
     test_fuzz_bitlayer.py and test_soak*.py) at shapes no other phase
     takes, one line a case with its launch plan: (a) B1 against its plain
     version (B1Gate) at every full-kernel and format case and at sps 2,
     num_avg 20, phase_avg 10, QPSK, each at 1024, 1002 and 1001 channels
     (16-, 8- and 4-byte copies; 2-byte on int16 planes): the feed-forward
     warm-up on the card, full_from_ff, two blocks, with the case's int16
     planes, int8 soft, debug ports off, unpacked outputs and RRC filter
     (stage 0); (b) B5 against its plain version (check_b5) at each case's
     sps and num_avg at 1024 and 1001 channels; (c) B2 through the
     bit-layer loopback of every tests/test_fuzz_bitlayer.py case at 1024
     channels (K3, K7, punctured 2/3 and 3/4; check_loopback, frames equal
     to a 128-channel CPU run), and B3 + B4 through the stream-FEC soak
     script at K3 and K7 over 1024 rows, popped bits equal to the plain
     decoder's on the card's LLRs (check_fec_soak); (d) the engine soaks as
     event scripts through StreamEngine, BatchEngine and
     FullKernelBatchEngine (B1Gate) at 128 channels on the card and on
     the CPU, packets held equal by compare_service (a differing sample
     pick only at a near tie, TieRecord) and the metrics equal.
Phases run in the order 1-5, 9-11, 14, 15, 6-8, 12, 13, 16-29.  Each
path's launch counts are set to 0 just before it runs and read just after;
the kernels line takes B1's and B2's from phase 7, B3's and B4's from
phase 20 (their times at its shape), B5's from phase 10, B1's int16,
timing_interp, matched-filter, config-3 and stage-0 launches from phase 14
and its mixed launches from phase 15; each kernel's conformance_launches
are phase 29's.

The last two lines of standard output are a JSON object describing each
kernel, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from psk_soft_tpu_torch.tools.gates import (INTERP_TIE, NEAR_TIE_REL,
                                            PHASE_TOL, SOFT_TOL, B1Gate,
                                            TieRecord, check_b5,
                                            check_fec_soak, check_frames,
                                            check_loopback, compare_service,
                                            required_frames)

C, S, SPS, NUM_AVG, PHASE_AVG = 1024, 512, 8, 100, 50
WARM = 256                    # warm-up symbols before the kernel checks
STEADY_BLOCKS = 10            # engine blocks past the hand-off
QPSK_TOL = 0.05               # engine soft decisions vs the QPSK points
PM_TOL = 1e-5                 # B3 final path metrics vs the plain version
FUSED_SOFT_TOL, FUSED_PHASE_TOL = 2e-4, 1e-3   # tests/test_fused.py:67-75
CFO_TOL = 1e-4                # acquire_cfo estimates vs the planted offsets
CPU_C = 128                   # channels of the CPU comparison runs
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # float32 outside the tensor cores


def channels(num_symbols: int, m: int = 4, diff: bool = False,
             noise: float = 0.01, n_ch: int = C,
             sps: int = SPS) -> np.ndarray:
    """(n_ch, num_symbols*sps) complex64 test bank: a unit PSK impulse at
    sample 2 of every symbol (a clear energy peak), a small frequency
    offset, and real Gaussian noise of std ``noise``; channel i draws from
    seed i (tests/test_full_kernel.py's fixture at 1024 channels)."""
    out = np.empty((n_ch, num_symbols * sps), np.complex64)
    rot = np.exp(2j * np.pi * 2e-4 * sps * np.arange(num_symbols))
    for i in range(n_ch):
        rng = np.random.default_rng(i)
        pts = np.exp(2j * np.pi * rng.integers(0, m, num_symbols) / m)
        if diff:
            pts = np.cumprod(pts)
        x = np.zeros(num_symbols * sps, np.complex64)
        x[2::sps] = pts * rot
        x += (noise * rng.standard_normal(x.size)).astype(np.complex64)
        out[i] = x
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def nonfinite_match(a, b) -> bool:
    """NaN and inf at the same places, and the infs of the same sign."""
    import torch
    ia = a.isinf()
    return (torch.equal(a.isnan(), b.isnan()) and torch.equal(ia, b.isinf())
            and torch.equal(a[ia], b[ia]))


def finite_err(a, b, period: float | None = None) -> float:
    """Largest |a - b| over the finite values (modulo ``period`` if
    given); inf where the non-finite values differ in place."""
    if not nonfinite_match(a, b):
        return float("inf")
    keep = a.isfinite()
    if not bool(keep.any()):
        return 0.0
    d = (a[keep] - b[keep]).double()
    if period is not None:
        d = d - period * (d / period).round()
    return float(d.abs().max())


def b1_errors(got, ref, m: int, kw: dict, what: str) -> dict:
    """Kernel B1's outputs against its plain version's on the same inputs:
    bits equal, sample index equal (debug ports on), soft within SOFT_TOL
    (int8 soft: at most one step apart, where the float value sits on a
    rounding boundary), phase within PHASE_TOL, the carry planes within
    PHASE_TOL modulo M*2pi; NaN and inf only where the plain version has
    them.  Returns the errors; raises on a failure."""
    import torch
    g_sre, g_sim, g_ph, g_bits, g_idx, g_st = got
    r_sre, r_sim, r_ph, r_bits, r_idx, r_st = ref
    if not torch.equal(g_bits, r_bits):
        raise AssertionError(f"{what}: bits differ at "
                             f"{int((g_bits != r_bits).sum())} symbols")
    errs = {}
    if kw.get("soft_i8_scale") is None:
        errs["soft"] = max(finite_err(g_sre, r_sre), finite_err(g_sim, r_sim))
        soft_ok = errs["soft"] <= SOFT_TOL
    else:
        d_re = (g_sre.int() - r_sre.int()).abs()
        d_im = (g_sim.int() - r_sim.int()).abs()
        errs["i8_steps"] = max(int(d_re.max()), int(d_im.max()))
        errs["i8_differ"] = int((d_re > 0).sum() + (d_im > 0).sum())
        soft_ok = errs["i8_steps"] <= 1
    if kw.get("debug_ports", True):
        if not torch.equal(g_idx, r_idx):
            raise AssertionError(f"{what}: sample_index differs at "
                                 f"{int((g_idx != r_idx).sum())} symbols")
        errs["phase"] = finite_err(g_ph, r_ph)
    elif g_ph is not None or g_idx is not None:
        raise AssertionError(f"{what}: debug ports off but planes returned")
    errs["planes"] = finite_err(g_st, r_st, 2 * np.pi * m)
    if (not soft_ok or errs.get("phase", 0.0) > PHASE_TOL
            or errs["planes"] > PHASE_TOL):
        raise AssertionError(f"{what}: {errs}")
    return errs


def dev_us(e) -> float:
    """Device time of a torch.profiler key_averages() row, in us."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


# Kernel names (torch.profiler keys) of B2 and B3 at K7, n = 2, and B4's
# two passes.
B2_KERNEL = "viterbi_warp_kernel<2, 2, true>"
B3_KERNEL = "viterbi_warp_kernel<2, 2, false>"
B4_KERNEL = ("viterbi_segments_kernel", "viterbi_resolve_kernel")

B1_STAGES = {"stage_0_filter": "demod_fir", "stage_a_timing": "demod_timing",
             "stage_b_track": "demod_track", "first_bad_memset": "Memset"}


PROFILER_PASSES = 3    # a pass that records none of the kernels is repeated


def profiled_rows(torch, run, has) -> list:
    """Device-side rows of torch.profiler's key_averages() over ``run()``;
    a pass whose rows fail ``has`` (none of the kernels looked for: the
    profiler now and then records no device activity for a pass) is made
    again, up to PROFILER_PASSES times, and the repeats are logged."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILER_PASSES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.self_cpu_time_total == 0]
        if has(rows):
            if attempt > 1:
                log(json.dumps({"phase": "profiler", "passes": attempt}))
            return rows
    raise AssertionError(f"profiler shows no device time in "
                         f"{PROFILER_PASSES} passes")


def b1_stage_ms(torch, fn, args_list, iters: int = 20) -> dict:
    """One torch.profiler pass over ``iters`` calls of B1's wrapper: the
    device time of each of its launches per call, read by kernel name
    (stage 0 under a matched filter, stage A, stage B, the memset of the
    non-finite record)."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])

    def stage_us(rows, name):
        return sum(dev_us(e) for e in rows if name in e.key)

    rows = profiled_rows(torch, run, lambda rows: all(
        stage_us(rows, B1_STAGES[s]) for s in ("stage_a_timing",
                                               "stage_b_track")))
    return {stage: stage_us(rows, name) / 1e3 / iters
            for stage, name in B1_STAGES.items()}


def kernel_device_ms(torch, fn, name, iters: int = 10) -> float:
    """Device time of the kernels whose name holds ``name`` (or one of a
    tuple of names), per call of ``fn``, from one torch.profiler pass over
    ``iters`` calls (the wrapper's host work is not in it)."""
    names = (name,) if isinstance(name, str) else name
    fn()
    torch.cuda.synchronize()

    def us(rows):
        return sum(dev_us(e) for e in rows
                   if any(n in e.key for n in names))

    def run():
        for _ in range(iters):
            fn()

    return us(profiled_rows(torch, run, us)) / 1e3 / iters


def profile_engine(feed, card: str, what: str = "engine, depth 0",
                   blocks: int = 5, watch: dict | None = None) -> None:
    """torch.profiler over a few engine blocks: device busy time by
    operation, the device's idle share of the wall time, the host-to-device
    copies per block, and the device time of each kernel in ``watch``
    (label -> a piece of its kernel's name).  The profiler's table goes to
    standard error."""
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

    # Device-side rows (kernels, memcpys) have no CPU time; a CPU op's row
    # repeats the device time of what it launched, and the profiler's own
    # buffer requests are left out.
    dev_rows = [e for e in ka if e.self_cpu_time_total == 0 and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in dev_rows) / 1e3
    top = sorted(dev_rows, key=dev_us, reverse=True)[:6]
    watched = {label: sum(dev_us(e) for e in dev_rows if name in e.key)
               / 1e3 / blocks for label, name in (watch or {}).items()}
    print(f"{card}: {blocks} engine blocks, wall {wall:.4f} s\n"
          f"{ka.table(row_limit=30)}", file=sys.stderr)
    log(json.dumps({"phase": "profile", "what": what,
                    "blocks": blocks, "wall_ms_per_block": wall * 1e3
                    / blocks, "device_busy_ms_per_block": busy / blocks,
                    "device_idle_share": 1.0 - busy / (wall * 1e3),
                    "device_ops_per_block": sum(e.count for e in dev_rows)
                    / blocks,
                    "htod_copies_per_block": sum(
                        e.count for e in dev_rows if "HtoD" in e.key)
                    / blocks,
                    "kernel_ms_per_block": watched,
                    "kernel_share_of_busy": {
                        k: v * blocks / busy if busy else 0.0
                        for k, v in watched.items()},
                    "top_device_ms_per_block": {
                        e.key: dev_us(e) / 1e3 / blocks for e in top},
                    "card": card}))


def b1_warm(torch, dev, n_ch: int, sps: int, num_avg: int, symbols: int,
            m: int = 4, diff: bool = False):
    """A test bank warmed up through blockpsk for WARM symbols: returns
    (FullState carry, x_re, x_im) with ``symbols`` symbols of (rows, n_ch)
    planes after the warm-up."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk, full

    cfg = DemodConfig(sps=sps, num_avg=num_avg, constellation_size=m,
                      phase_avg=PHASE_AVG, differential=diff)
    xs = torch.from_numpy(channels(WARM + symbols, m, diff, n_ch=n_ch,
                                   sps=sps)).to(dev)
    st, _ = blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, n_ch, dev),
                                    xs[:, :WARM * sps])
    run = xs[:, WARM * sps:]
    return (full.full_from_ff(cfg, st), run.real.T.contiguous(),
            run.imag.T.contiguous())


def b1_blocks(torch, case: dict, state, x_re, x_im, n_sym: int,
              blocks: int, kw: dict, log_it: bool = True):
    """Kernel B1 and its plain version through ``blocks`` consecutive
    n_sym-symbol blocks from one carry, each on its own output of the
    block before (carry planes and window rows), held by b1_errors after
    every block.  The launch plan's shared memory must equal the
    library's own count.  Returns ([(got, ref) per block], errors)."""
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

    lib = dk.load_library()[0]
    sps, m = kw["sps"], kw["m"]
    n_ch = x_re.shape[1]
    ntaps = len(kw.get("mf_taps") or ())
    keep = (kw["num_avg"] - 1) * sps + max(ntaps - 1, 0)
    esize = 4 if ntaps or x_re.dtype == torch.float32 else 2
    interp = bool(kw.get("timing_interp"))
    plan = dk.launch_plan(n_ch, n_sym, sps, kw["phase_avg"], 16,
                          x_re.element_size(), interp, ntaps,
                          keep - max(ntaps - 1, 0) + n_sym * sps)
    lib_smem = (lib.psk_demod_full_smem(0, sps, 0, plan.timing.chunk,
                                        plan.timing.group, esize, interp, 0),
                lib.psk_demod_full_smem(1, 0, kw["phase_avg"], plan.chunk, 0,
                                        0, 0, 0),
                lib.psk_demod_full_smem(2, 0, 0, plan.fir.tile,
                                        plan.fir.stages, x_re.element_size(),
                                        0, ntaps) if ntaps else 0)
    if lib_smem != (plan.timing.smem, plan.track_smem,
                    plan.fir.smem if ntaps else 0):
        raise AssertionError(f"{case}: plan shared memory "
                             f"{(plan.timing.smem, plan.track_smem)}, "
                             f"library {lib_smem}")
    win = [(state.win_re, state.win_im)] * 2
    carry = [state.planes, state.planes]
    errs, outs = {}, []
    for blk in range(blocks):
        rows = slice(blk * n_sym * sps, (blk + 1) * n_sym * sps)
        xr, xi = x_re[rows].contiguous(), x_im[rows].contiguous()
        got = dk.demod_full_tm(*win[0], xr, xi, carry[0], **kw)
        ref = dk.demod_full_tm_ref(*win[1], xr, xi, carry[1], **kw)
        torch.cuda.synchronize()
        for name, v in b1_errors(got, ref, m, kw,
                                 f"{case} block {blk}").items():
            errs[f"{name}{blk}"] = v
        outs.append((got, ref))
        win = [(torch.cat([win[0][0], xr])[-keep:].contiguous(),
                torch.cat([win[0][1], xi])[-keep:].contiguous())] * 2
        carry = [got[5], ref[5]]
    if log_it:
        log(json.dumps({"phase": "kernel_vs_plain", **case,
                        "channels": n_ch, "symbols": n_sym,
                        "blocks": blocks, "chunk": plan.chunk,
                        "timing_plan": plan.timing._asdict(),
                        "bits_equal": True,
                        "sample_index_equal": kw.get("debug_ports", True),
                        **errs}))
    return outs, errs


def b1_phase(torch, dev) -> float:
    """Phase 3: kernel B1 against its plain version through the wrapper,
    from the carry of a real warm-up, two blocks each unless said.
    Modes at 1024 x 512: M in {2, 4, 8, 16}, differential, debug ports
    off, int8 soft.  (a) Edges: C = 1000 (not a multiple of any channel
    group), QPSK and differential, one block; S in {1, 5, 37, 129} at C =
    1024 (S < 8 and S < n1 reach into the carry's trend and FIR rows);
    sps 40 (stage A's shorter chunks) at C = 256, num_avg 20.  (b) A NaN at
    channel 11's block symbol 300 and +inf at channel 23's symbol 100:
    sample index and bits equal on every channel, NaN and inf where the
    plain version's are.  (c) One pure-noise block: a differing sample
    index only where the plain version's top two window sums are within
    NEAR_TIE_REL, counted (bits are counted, not held: on noise a rounding
    difference can flip a sign or a wrap count).  Returns the largest soft
    or phase error."""
    from psk_soft_tpu_torch.ops import timing
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

    worst = 0.0

    def check(case, state, x_re, x_im, n_sym, blocks, log_it=True, **kw):
        nonlocal worst
        kw = dict(dict(sps=SPS, num_avg=NUM_AVG, phase_avg=PHASE_AVG, m=4,
                       diff=False), **kw)
        outs, errs = b1_blocks(torch, case, state, x_re, x_im, n_sym,
                               blocks, kw, log_it)
        worst = max([worst] + [v for k, v in errs.items()
                               if k.startswith(("soft", "phase"))])
        return outs

    modes = [dict(m=4, diff=False), dict(m=2, diff=False),
             dict(m=8, diff=False), dict(m=16, diff=False),
             dict(m=4, diff=True),
             dict(m=4, diff=False, debug_ports=False),
             dict(m=4, diff=False, soft_i8_scale=100.0)]
    inputs = {}
    for mode in modes:
        key = (mode["m"], mode["diff"])
        if key not in inputs:
            inputs[key] = b1_warm(torch, dev, C, SPS, NUM_AVG, 2 * S, *key)
        check({"mode": mode}, *inputs[key], S, 2, **mode)
    del inputs

    # --- (a) edges ---
    for diff in (False, True):
        st, xr, xi = b1_warm(torch, dev, 1000, SPS, NUM_AVG, S, diff=diff)
        check({"case": "C=1000", "diff": diff}, st, xr, xi, S, 1, diff=diff)
    st, xr, xi = b1_warm(torch, dev, C, SPS, NUM_AVG, 2 * 129)
    for n_sym in (1, 5, 37, 129):
        check({"case": f"S={n_sym}"}, st, xr, xi, n_sym, 2)
    st, xr, xi = b1_warm(torch, dev, 256, 40, 20, 2 * S)
    check({"case": "sps=40", "num_avg": 20}, st, xr, xi, S, 2, sps=40,
          num_avg=20)

    # --- (b) poison: NaN at channel 11's symbol 300, +inf at 23's 100 ---
    st, xr, xi = b1_warm(torch, dev, C, SPS, NUM_AVG, S)
    xr[300 * SPS + 5, 11] = float("nan")
    xi[100 * SPS + 3, 23] = float("inf")
    (got, ref), = check({"case": "poison"}, st, xr, xi, S, 1, log_it=False)
    bad = torch.nonzero(~got[0].isfinite().all(dim=0)).flatten().tolist()
    if bad != [11, 23]:
        raise AssertionError(f"poison: non-finite soft on channels {bad}")
    # From the first output symbol whose window reaches the sample on,
    # the poisoned bin is the pick (first NaN, or inf then NaN).
    if not (bool((ref[4][300:, 11] == 5).all())
            and bool((ref[4][100:, 23] == 3).all())):
        raise AssertionError("poison: the plain version does not pick the "
                             "poisoned bins")
    log(json.dumps({"phase": "kernel_vs_plain", "case": "poison",
                    "nan": [11, 300], "inf": [23, 100],
                    "nonfinite_soft_channels": bad,
                    "nonfinite_soft_symbols": int((~got[0].isfinite())
                                                  .sum()),
                    "bits_equal": True, "sample_index_equal": True,
                    "nonfinite_where_plain": True}))

    # --- (c) noise: near ties only ---
    gen = torch.Generator(device=dev).manual_seed(3)
    keep = (NUM_AVG - 1) * SPS
    rows = keep + S * SPS
    re = torch.randn((rows, C), generator=gen, device=dev)
    im = torch.randn((rows, C), generator=gen, device=dev)
    kw = dict(sps=SPS, num_avg=NUM_AVG, phase_avg=PHASE_AVG, m=4,
              diff=False)
    args = (re[:keep], im[:keep], re[keep:], im[keep:], st.planes)
    got = dk.demod_full_tm(*args, **kw)
    ref = dk.demod_full_tm_ref(*args, **kw)
    e = (re * re + im * im).reshape(S + NUM_AVG - 1, SPS, C).permute(2, 0, 1)
    top2 = timing.windowed_bin_sums(e, NUM_AVG).topk(2, dim=-1).values
    gap = ((top2[..., 0] - top2[..., 1]) / top2[..., 0]).T       # (S, C)
    torch.cuda.synchronize()
    differ = got[4] != ref[4]
    n_differ = int(differ.sum())
    widest = float(gap[differ].max()) if n_differ else 0.0
    if widest >= NEAR_TIE_REL:
        raise AssertionError(f"B1 on noise: {n_differ} indices differ, "
                             f"widest gap {widest} (near-tie bound "
                             f"{NEAR_TIE_REL})")
    log(json.dumps({"phase": "kernel_vs_plain", "case": "noise",
                    "channels": C, "symbols": S,
                    "noise_index_differ": n_differ,
                    "noise_outputs": S * C,
                    "channels_with_a_difference": int(differ.any(dim=0)
                                                      .sum()),
                    "bits_differ": int((got[3] != ref[3]).sum()),
                    "noise_widest_relative_gap": widest,
                    "near_tie_bound": NEAR_TIE_REL}))
    return worst


def viterbi_llrs(code, rows: int, n_info: int, hard: bool,
                 seed: int) -> np.ndarray:
    """(rows, L) float32 LLRs of random coded frames (terminated): +/-1
    with Gaussian noise of std 0.8, or hard +/-1 with 5% of the code bits
    flipped, which makes ties everywhere."""
    from psk_soft_tpu_torch.ops import fec

    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (rows, n_info)).astype(np.int8)
    bits = fec.conv_encode(code, info).numpy()
    if hard:
        bits = bits ^ (rng.random(bits.shape) < 0.05)
        return (1.0 - 2.0 * bits).astype(np.float32)
    return ((1.0 - 2.0 * bits)
            + 0.8 * rng.standard_normal(bits.shape)).astype(np.float32)


def viterbi_plans(vk) -> int:
    """The Python launch plan of B2 and B3 against the library's own
    (psk_viterbi_plan) at the edges: equal plans, and the same launches
    refused.  Returns the number of shapes held."""
    import ctypes

    lib = vk.load_library()[0]
    out = (ctypes.c_int32 * 8)()
    held = 0
    for fused in (True, False):
        for s_count in (2, 4, 64, 128, 256, 512):
            for n in (1, 2, 3, 8):
                for t in (0, 1, 64, 191, 704, 705, 1472, 1473, 4133):
                    for b in (1, 6145):
                        try:
                            want = tuple(vk.launch_plan(s_count, n, t, b,
                                                        fused))
                        except ValueError:
                            want = None
                        rc = lib.psk_viterbi_plan(int(fused), s_count, n, t,
                                                  b, out)
                        got = tuple(out) if rc == 0 else None
                        if got != want:
                            raise AssertionError(
                                f"plan fused={fused} S={s_count} n={n} t={t}"
                                f" B={b}: Python {want}, library {got}")
                        held += 1
    return held


def viterbi_check(torch, vk, label: str, llr_t, pm0, exp, kw: dict,
                  terminate: bool, fused: bool = True) -> float:
    """B2 (when ``fused``) and B3 against their plain versions on the same
    planes: bits and decisions equal (torch.equal), final metrics within
    PM_TOL with NaN and inf where the plain version's are.  Returns the
    metrics' largest error; raises on a difference."""
    if fused:
        got = vk.viterbi_fused(llr_t, pm0, exp, terminate=terminate, **kw)
        ref = vk.viterbi_fused_ref(llr_t, pm0, exp, terminate=terminate,
                                   **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"B2 {label}: bits differ at "
                                 f"{int((got != ref).sum())} of "
                                 f"{got.numel()}")
        del got, ref
    dec, pm = vk.viterbi_acs(llr_t, pm0, exp, **kw)
    dec_r, pm_r = vk.viterbi_acs_ref(llr_t, pm0, exp, **kw)
    torch.cuda.synchronize()
    err = finite_err(pm, pm_r)
    if not torch.equal(dec, dec_r) or err > PM_TOL:
        raise AssertionError(f"B3 {label}: decisions differ at "
                             f"{int((dec != dec_r).sum())}, metrics {err}")
    return err


def kernel_and_plain_ms(event_ms, kernel, plain, iters_plain: int = 2):
    """CUDA-event times of a kernel's wrapper and its plain version on the
    same inputs, in turns (plain, kernel, kernel, plain): ([k1, k2], [p1,
    p2])."""
    p1 = event_ms(plain, [()], iters=iters_plain)
    k1 = event_ms(kernel, [()])
    k2 = event_ms(kernel, [()])
    p2 = event_ms(plain, [()], iters=iters_plain)
    return [k1, k2], [p1, p2]


def viterbi_phases(torch, dev, card: str, event_ms) -> dict:
    """Phases 6 and 8a: kernels B2, B3 and B4 against their plain versions
    on the card, and their times.  Returns, per kernel, the numbers of the
    kernels line."""
    from psk_soft_tpu_torch.ops import fec
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

    def planes(code, llr):
        return vk.decode_planes(code, torch.from_numpy(llr).to(dev))

    log(json.dumps({"phase": "viterbi_plan", "shapes_equal_to_library":
                    viterbi_plans(vk)}))

    # --- phase 6a: B2 and B3 at the chain shape (64 steps, 6144 rows) and
    # others, then the new design's edges on random planes.
    rows = C * (S // 96 + 1)                  # ChainEngine's capacity k = 6
    p23 = fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_2_3)
    p34 = fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_3_4)
    k10 = fec.ConvCode(10, (0o1167, 0o1545))
    r13 = fec.ConvCode(7, (0o133, 0o165, 0o171))
    cases = [("K7", fec.CODE_K7, 58, False, True),
             ("K7 terminate=False", fec.CODE_K7, 58, False, False),
             ("K7 hard +/-1", fec.CODE_K7, 58, True, True),
             ("K3", fec.CODE_K3, 62, False, True),
             ("K9", fec.CODE_K9, 56, False, True),
             ("K7 punctured 2/3", p23, 58, False, True),
             ("K7 punctured 3/4", p34, 60, False, True),
             ("K10", k10, 55, False, True),
             ("K7 rate 1/3", r13, 58, False, True)]
    chain_args = None
    pm_err = 0.0
    for i, (label, code, n_info, hard, terminate) in enumerate(cases):
        llr_t, pm0, exp, t, _ = planes(code, viterbi_llrs(code, rows, n_info,
                                                          hard, 60 + i))
        kw = dict(k=code.k, s_count=code.states, n=code.n, t_actual=t)
        pm_err = max(pm_err, viterbi_check(torch, vk, label, llr_t, pm0, exp,
                                           kw, terminate))
        log(json.dumps({"phase": "viterbi_vs_plain", "kernel": "B2, B3",
                        "case": label, "rows": rows, "steps": t,
                        "bits_equal": True, "decisions_equal": True}))
        if chain_args is None:
            chain_args = (llr_t, pm0, exp, dict(kw, terminate=terminate))

    gen = torch.Generator(device=dev).manual_seed(61)
    code = fec.CODE_K7
    exp = torch.from_numpy(vk.butterfly_signs(code)).to(dev)
    edges = [("B=6145", 6145, 64, 64, "pinned", True),
             ("t_actual 0", rows, 64, 0, "random", False),
             ("t_actual 1", rows, 64, 1, "random", False),
             ("T_pad > t_actual", rows, 64, 50, "random", False),
             ("NaN in pm0 rows 5, 40, t_actual 1", rows, 64, 1, "nan",
              False),
             ("NaN in pm0 rows 5, 40, t_actual 3", rows, 64, 3, "nan",
              False)]
    for label, b, t_pad, t, start, terminate in edges:
        llr_t = torch.randn((2, t_pad, b), generator=gen, device=dev)
        pm0 = torch.full((64, b), -1e9, device=dev)
        pm0[0] = 0.0
        if start != "pinned":
            pm0 = 10.0 * torch.randn((64, b), generator=gen, device=dev)
        if start == "nan":
            pm0[[5, 40]] = float("nan")
        kw = dict(k=7, s_count=64, n=2, t_actual=t)
        pm_err = max(pm_err, viterbi_check(torch, vk, label, llr_t, pm0, exp,
                                           kw, terminate))
        log(json.dumps({"phase": "viterbi_vs_plain", "kernel": "B2, B3",
                        "case": f"K7 {label}", "rows": b, "steps": t,
                        "t_pad": t_pad, "pm0": start,
                        "terminate": terminate, "bits_equal": True,
                        "decisions_equal": True}))

    # B2 at the ends of its envelope (1472 steps, 704 at K10), where the
    # plan drops to one or two warps a block and, at n = 8, to 16-step
    # chunks that end inside a 32-step word group; random +/-1 signs.
    for k, n, t in ((9, 2, 1472), (9, 8, 1472), (10, 2, 704), (7, 3, 1472),
                    (2, 8, 1472)):
        s_count, b = 1 << (k - 1), 333
        exp_r = (2.0 * torch.randint(0, 2, (2 * s_count, n), generator=gen,
                                     device=dev) - 1.0).float()
        llr_t = torch.randn((n, t, b), generator=gen, device=dev)
        pm0 = 10.0 * torch.randn((s_count, b), generator=gen, device=dev)
        kw = dict(k=k, s_count=s_count, n=n, t_actual=t)
        pm_err = max(pm_err, viterbi_check(torch, vk, f"K{k} n {n} {t} "
                                           f"steps", llr_t, pm0, exp_r, kw,
                                           False))
        log(json.dumps({"phase": "viterbi_vs_plain", "kernel": "B2, B3",
                        "case": f"K{k} n {n} at B2's longest trellis",
                        "rows": b, "steps": t, "plan": vk.launch_plan(
                            s_count, n, t, b, True)._asdict(),
                        "bits_equal": True, "decisions_equal": True}))

    # --- phase 6b: fused against two-phase at the chain shape, and both
    # against the plain decoder on the CPU.
    llr = viterbi_llrs(fec.CODE_K7, rows, 58, False, 70)
    on_card = torch.from_numpy(llr).to(dev)
    fused = vk.viterbi_decode_kernel(fec.CODE_K7, on_card)
    two_phase = vk.viterbi_decode_kernel(fec.CODE_K7, on_card, t_tile=16)
    cpu = fec.viterbi_decode(fec.CODE_K7, torch.from_numpy(llr))
    if not (torch.equal(fused, two_phase) and torch.equal(fused.cpu(), cpu)):
        raise AssertionError("fused and two-phase decodes differ")
    log(json.dumps({"phase": "viterbi_vs_plain", "kernel": "B2 vs B3+B4",
                    "rows": rows, "steps": 64, "bits_equal": True,
                    "equal_to_cpu_decoder": True}))

    # --- phase 6c: B3 + B4 on long trellises (4133 steps: not a whole
    # number of chunks).
    long_args = None
    for code, n_rows, steps, seed in ((fec.CODE_K7, 512, 4096, 87),
                                      (fec.CODE_K9, 256, 1024, 89),
                                      (fec.CODE_K7, 512, 4096 + 37, 120)):
        llr_t, pm0, exp, t, _ = planes(code, viterbi_llrs(
            code, n_rows, steps - (code.k - 1), False, seed))
        kw = dict(k=code.k, s_count=code.states, n=code.n, t_actual=t)
        dec, pm = vk.viterbi_acs(llr_t, pm0, exp, **kw)
        dec_r, pm_r = vk.viterbi_acs_ref(llr_t, pm0, exp, **kw)
        start = torch.argmax(pm, dim=0).to(torch.int32)[None]
        tb = dict(k=code.k, s_count=code.states, t_actual=t)
        bits = vk.viterbi_traceback(dec, start, **tb)
        bits_r = vk.viterbi_traceback_ref(dec, start, **tb)
        torch.cuda.synchronize()
        err = float((pm - pm_r).abs().max())
        if not torch.equal(dec, dec_r) or err > PM_TOL:
            raise AssertionError(f"B3 K{code.k}: decisions differ at "
                                 f"{int((dec != dec_r).sum())}, metrics "
                                 f"{err}")
        if not torch.equal(bits, bits_r):
            raise AssertionError(f"B4 K{code.k}: bits differ at "
                                 f"{int((bits != bits_r).sum())}")
        pm_err = max(pm_err, err)
        plan = vk.launch_plan(code.states, code.n, t, n_rows, False)
        log(json.dumps({"phase": "viterbi_vs_plain", "kernel": "B3+B4",
                        "K": code.k, "rows": n_rows, "steps": t,
                        "chunk": plan.chunk,
                        "decisions_equal": True, "bits_equal": True,
                        "metrics_max_abs_err": err}))
        if long_args is None:
            long_args = (llr_t, pm0, exp, kw, dec, start, tb)
        del dec, dec_r, pm_r, bits, bits_r

    # --- phase 6c (B4's edges): random decision planes, starts inside and
    # outside [0, S) (S, S + 5, -1, -7 in the first columns); K3, K7, K10;
    # B = 6145 (byte copies), 6148 (4-byte), 512 (16-byte); t_actual 0, 1
    # and T_pad > t_actual; then a plan the kernel did not expect.
    import ctypes

    def starts(s_count, b):
        st = torch.randint(0, s_count, (1, b), generator=gen, device=dev,
                           dtype=torch.int32)
        st[0, :4] = torch.tensor([s_count, s_count + 5, -1, -7])
        return st

    tb_cases = [(3, 6145, 64, 50), (7, 6145, 40, 40), (7, 6148, 70, 70),
                (7, 512, 64, 0), (7, 512, 64, 1), (10, 333, 100, 97),
                (9, 512, 300, 257)]
    for k, b, t_pad, t in tb_cases:
        s_count = 1 << (k - 1)
        dec = torch.randint(0, 2, (t_pad, s_count, b), generator=gen,
                            device=dev, dtype=torch.int8)
        st = starts(s_count, b)
        tb = dict(k=k, s_count=s_count, t_actual=t)
        bits = vk.viterbi_traceback(dec, st, **tb)
        bits_r = vk.viterbi_traceback_ref(dec, st, **tb)
        torch.cuda.synchronize()
        if not torch.equal(bits, bits_r):
            raise AssertionError(f"B4 K{k} B={b} t={t}/{t_pad}: bits differ "
                                 f"at {int((bits != bits_r).sum())}")
        log(json.dumps({"phase": "viterbi_vs_plain", "kernel": "B4",
                        "K": k, "rows": b, "steps": t, "t_pad": t_pad,
                        "starts_outside": [s_count, s_count + 5, -1, -7],
                        "plan": vk.traceback_plan(s_count, b, t)._asdict(),
                        "bits_equal": True}))
    llr_t, pm0, exp, kw, dec, start, tb = long_args
    st = start.clone()
    st[0, :4] = torch.tensor([64, 69, -1, -7])
    bits = vk.viterbi_traceback(dec, st, **tb)
    if not torch.equal(bits, vk.viterbi_traceback_ref(dec, st, **tb)):
        raise AssertionError("B4 K7 512 x 4096, starts outside [0, S): "
                             "bits differ")
    lib = vk.load_library()[0]
    plan = vk.traceback_plan(64, 512, tb["t_actual"])
    for field, value in (("grid", plan.grid + 1), ("smem", plan.smem - 1),
                         ("vec", 8), ("segments", plan.segments - 1)):
        bad = plan._replace(**{field: value})
        rc = lib.psk_viterbi_traceback(
            *(ctypes.c_void_p(x.data_ptr()) for x in (dec, st, bits, bits,
                                                      bits)),
            64, 7, tb["t_actual"], 512, *bad,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc == 0:
            raise AssertionError(f"B4 took a plan with {field} {value}")
    log(json.dumps({"phase": "viterbi_vs_plain", "kernel": "B4",
                    "K": 7, "rows": 512, "steps": tb["t_actual"],
                    "starts_outside": [64, 69, -1, -7], "bits_equal": True,
                    "unexpected_plans_refused": 4}))
    del dec, bits, st

    # --- phase 8a: times (plain, kernel, kernel, plain within the call).
    # The kernels line's "ms" is the CUDA-event time of 20 back-to-back
    # wrapper calls, the lower of two readings, as for B1 and B5; the
    # timing lines add each kernel's own device time (torch.profiler, by
    # kernel name, two passes of 10 calls), which leaves out the wrapper's
    # host work where that is the longer (B2).
    out = {}
    llr_t, pm0, exp, kw = chain_args
    fused_call = lambda: vk.viterbi_fused(llr_t, pm0, exp, **kw)  # noqa
    k_ms, p_ms = kernel_and_plain_ms(
        event_ms, fused_call,
        lambda: vk.viterbi_fused_ref(llr_t, pm0, exp, **kw), 10)
    dev_ms = [kernel_device_ms(torch, fused_call, B2_KERNEL)
              for _ in range(2)]
    t, b, s_count, n = kw["t_actual"], llr_t.shape[2], kw["s_count"], kw["n"]
    acs_ops = t * b * s_count * (4 * n + 3)   # per (step, row, state)
    out["viterbi_fused"] = dict(
        ms=min(k_ms), plain_ms=min(p_ms), max_abs_err=0.0, ops=acs_ops,
        bytes=(llr_t.nbytes + pm0.nbytes + exp.nbytes + t * b))
    log(json.dumps({"phase": "timing", "what": "viterbi_fused (B2) per "
                    "chain block", "rows": b, "steps": t, "K": kw["k"],
                    "plan": vk.launch_plan(s_count, n, t, b, True)._asdict(),
                    "kernel_ms": k_ms, "device_ms": dev_ms,
                    "plain_ms": p_ms,
                    "kernel_infobits_per_s": b * (t - kw["k"] + 1)
                    / (min(k_ms) * 1e-3), "card": card}))

    llr_t, pm0, exp, kw, dec, start, tb = long_args
    t, b, s_count, n = kw["t_actual"], llr_t.shape[2], kw["s_count"], kw["n"]
    acs_call = lambda: vk.viterbi_acs(llr_t, pm0, exp, **kw)  # noqa: E731
    k_ms, p_ms = kernel_and_plain_ms(
        event_ms, acs_call, lambda: vk.viterbi_acs_ref(llr_t, pm0, exp, **kw))
    dev_ms = [kernel_device_ms(torch, acs_call, B3_KERNEL) for _ in range(2)]
    out["viterbi_acs"] = dict(
        ms=min(k_ms), plain_ms=min(p_ms), max_abs_err=pm_err,
        ops=t * b * s_count * (4 * n + 3),
        bytes=(llr_t.nbytes + 2 * pm0.nbytes + exp.nbytes + t * s_count * b))
    log(json.dumps({"phase": "timing", "what": "viterbi_acs (B3)",
                    "rows": b, "steps": t, "K": kw["k"], "kernel_ms": k_ms,
                    "device_ms": dev_ms, "plain_ms": p_ms,
                    "plan": vk.launch_plan(s_count, n, t, b, False)._asdict(),
                    "card": card}))
    tb_call = lambda: vk.viterbi_traceback(dec, start, **tb)  # noqa: E731
    k_ms, p_ms = kernel_and_plain_ms(
        event_ms, tb_call, lambda: vk.viterbi_traceback_ref(dec, start, **tb))
    dev_ms = [kernel_device_ms(torch, tb_call, B4_KERNEL) for _ in range(2)]
    # The walk reads one decision byte per (step, row): what this data
    # needs, not the whole plane.
    out["viterbi_traceback"] = dict(
        ms=min(k_ms), plain_ms=min(p_ms), max_abs_err=0.0, ops=4 * t * b,
        bytes=t * b + start.nbytes + t * b)
    log(json.dumps({"phase": "timing", "what": "viterbi_traceback (B4)",
                    "rows": b, "steps": t, "K": kw["k"], "kernel_ms": k_ms,
                    "device_ms": dev_ms, "plain_ms": p_ms, "card": card}))
    return out


def plant_chain_stream(fmt, code, crc, rng, lfsr=None):
    """tools/bench.plant_unaligned_frames (bench.py's
    _plant_unaligned_frames) at C x S: K7 + CRC-16 frames on the cadence
    max(sep, 104) + 1 over the S-periodic stream, planted with wraparound;
    with ``lfsr`` each framed message (info || CRC) is scrambled before
    the encoder.  Returns (starts, infos (C, k, n_msg), x (C, S*SPS)
    complex64, n_info)."""
    from psk_soft_tpu_torch.tools.bench import plant_unaligned_frames

    starts, _, infos, x, n_info, _ = plant_unaligned_frames(
        C, S, SPS, fmt, code, crc, rng, lfsr)
    return starts, infos, x, n_info


def chain_phases(torch, dev, card: str, profile) -> dict:
    """Phases 7 and 8b: ChainEngine end to end on the card against the
    CPU (and behind build_receiver(engine="chain")), then its times.
    Returns the kernel launch counts of the main path's run and the
    engine's infobits/s at depth 0 and 1."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
    from psk_soft_tpu_torch.ops.cuda import demod_kernel, viterbi_kernel
    from psk_soft_tpu_torch.ops.fec import CODE_K7
    from psk_soft_tpu_torch.ops.framesync import FrameFormat
    from psk_soft_tpu_torch.runtime.chain_engine import ChainEngine
    from psk_soft_tpu_torch.runtime.receiver import build_receiver

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    rng = np.random.default_rng(12)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    starts, infos, x, n_info = plant_chain_stream(fmt, CODE_K7, CRC16_CCITT,
                                                  rng)
    re = np.ascontiguousarray(x.real.T)           # one S-periodic block
    im = np.ascontiguousarray(x.imag.T)
    del x
    need = S * SPS
    n_blocks = 1 + STEADY_BLOCKS
    wrappers = {"demod_full_tm": demod_kernel.demod_full_tm,
                "viterbi_fused": viterbi_kernel.viterbi_fused,
                "viterbi_acs": viterbi_kernel.viterbi_acs,
                "viterbi_traceback": viterbi_kernel.viterbi_traceback}

    def engine(device, depth=0):
        return ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT,
                           block_symbols=S, pipeline_depth=depth,
                           device=device)

    def drive(eng):
        for _ in range(n_blocks):
            eng.push_planes(re, im)
            eng.step()
        eng.flush()
        torch.cuda.synchronize()
        return eng.pop_frames()

    # --- phase 7: the main path on the card, counts read around it ---
    gpu = engine(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    frames = drive(gpu)
    gpu_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    if min(launches["demod_full_tm"], launches["viterbi_fused"]) \
            < STEADY_BLOCKS:
        raise AssertionError(f"launches {launches} for {STEADY_BLOCKS} "
                             f"steady blocks")
    t0 = time.perf_counter()
    cpu_frames = drive(engine("cpu"))
    cpu_s = time.perf_counter() - t0

    # Demod rows exist for input symbols below n_blocks * S - NUM_AVG + 1;
    # every frame after the warm-up block whose symbols all have rows must
    # come.
    must = required_frames(starts, C, S, n_blocks, fmt.frame_len,
                           NUM_AVG - 1)
    check_frames("chain engine", frames, starts, infos, S, must)
    if gpu.overflow_peaks or gpu.crc_failures:
        raise AssertionError(f"overflow {gpu.overflow_peaks}, CRC failures "
                             f"{gpu.crc_failures}")

    def key(fr):
        return [(f.channel, f.start, f.crc_ok, f.info_bits.tobytes())
                for f in fr]

    if key(frames) != key(cpu_frames):
        raise AssertionError("frame lists differ between card and CPU")
    # The same engine behind the receiver surface gives the same frames.
    rx = build_receiver(cfg, C, engine="chain", block_symbols=S, uw=fmt.uw,
                        frame_payload=fmt.payload,
                        uw_threshold=fmt.threshold, fec=CODE_K7,
                        fec_labeling="gray", crc=CRC16_CCITT, device=dev)
    if key(drive(rx.engine)) != key(frames):
        raise AssertionError("build_receiver(engine='chain') frames differ "
                             "from ChainEngine's")
    log(json.dumps({"phase": "chain_engine", "channels": C, "symbols": S,
                    "blocks": n_blocks, "frames": len(frames),
                    "frames_required": len(must),
                    "frames_per_block_per_channel": len(starts),
                    "launches": launches, "warmup_symbols":
                    gpu.warmup_symbols, "card_s": gpu_s, "cpu_s": cpu_s,
                    "equal_to_cpu": True,
                    "receiver_chain_equal_to_engine": True}))

    # --- phase 8b: the chain engine's times, depth 0 and 1 ---
    rates = {}
    for depth in (0, 1):
        eng = engine(dev, depth)
        acc = dict(push=0.0, upload=0.0, chain_enqueue=0.0,
                   commit_fetch=0.0)

        def timed(name, fn):
            def run(*a, **k):
                t = time.perf_counter()
                r = fn(*a, **k)
                acc[name] += time.perf_counter() - t
                return r
            return run

        eng._upload = timed("upload", eng._upload)
        eng._step = timed("chain_enqueue", eng._step)
        eng._commit = timed("commit_fetch", eng._commit)

        def feed(_b):
            t = time.perf_counter()
            eng.push_planes(re, im)
            acc["push"] += time.perf_counter() - t
            return eng.step()

        for b in range(3):                  # warm-up + hand-off + 1 steady
            feed(b)
        torch.cuda.synchronize()
        acc = dict.fromkeys(acc, 0.0)
        n_timed, decoded = 20, 0
        t0 = time.perf_counter()
        for b in range(n_timed):
            decoded += len(feed(3 + b))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[depth] = decoded * n_info / dt
        log(json.dumps({"phase": "timing", "what": "chain engine end to end",
                        "pipeline_depth": depth, "blocks": n_timed,
                        "frames": decoded, "seconds": dt,
                        "infobits_per_s": decoded * n_info / dt,
                        "samples_per_s": n_timed * need * C / dt,
                        "host_ms_per_block": {k: v * 1e3 / n_timed
                                              for k, v in acc.items()},
                        "card": card}))
        if depth == 0:
            profile(feed, card, "chain engine, depth 0",
                    watch={"viterbi_fused (B2)": B2_KERNEL,
                           "demod_full_tm (B1)": "demod_"})
    return {"launches": launches, "infobits_per_s": rates}


def frontend_phase(torch, dev, card: str, event_ms, blocks) -> dict:
    """Phase 9: kernel B5 against its plain version at 1024 x 512 (sps 8,
    num_avg 100): equal on planted symbols plus noise; with a NaN and an
    +inf planted (equal picks, non-finite values where the plain version
    has them); at B1's edges (C = 1000; S in {1, 5, 37, 129}; sps 40); on
    pure noise a differing sample index is allowed only at a near tie of
    the plain version's top two window sums.  Then its times on
    ``blocks``.  Returns the numbers of the kernels line."""
    from psk_soft_tpu_torch.ops.cuda import frontend_kernel as fk

    kw = dict(sps=SPS, num_avg=NUM_AVG)
    keep = (NUM_AVG - 1) * SPS
    rows = (S + NUM_AVG - 1) * SPS

    def split(re, im):
        return re[:keep], im[:keep], re[keep:], im[keep:]

    def held(label, re, im, sps=SPS, num_avg=NUM_AVG):
        """B5 against its plain version: sample index equal, decision
        samples equal, NaN and inf where the plain version's are."""
        keep_ = (num_avg - 1) * sps
        a = (re[:keep_], im[:keep_], re[keep_:], im[keep_:])
        got = fk.timing_frontend_tm(*a, sps=sps, num_avg=num_avg)
        ref = fk.timing_frontend_tm_ref(*a, sps=sps, num_avg=num_avg)
        torch.cuda.synchronize()
        if not torch.equal(got[2], ref[2]) or not all(
                nonfinite_match(x, y) and torch.equal(x[x.isfinite()],
                                                      y[y.isfinite()])
                for x, y in zip(got[:2], ref[:2])):
            raise AssertionError(f"B5 {label}: sample index differs at "
                                 f"{int((got[2] != ref[2]).sum())}")
        return got, ref

    def planted(n_sym, n_ch=C, sps=SPS):
        sig = torch.from_numpy(np.ascontiguousarray(
            channels(n_sym, n_ch=n_ch, sps=sps).T)).to(dev)    # (rows, C)
        return sig.real.contiguous(), sig.imag.contiguous()

    got, ref = held("planted", *planted(S + NUM_AVG - 1))
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], ref[:2]))

    # Poison: NaN at channel 11's block symbol 300, +inf at 23's symbol 100
    # (phase 3's case); from the first output whose window reaches it on,
    # the poisoned bin is the pick, to the end of the block.
    re, im = planted(S + NUM_AVG - 1)
    re[keep + 300 * SPS + 5, 11] = float("nan")
    im[keep + 100 * SPS + 3, 23] = float("inf")
    got, ref = held("poison", re, im)
    bad = torch.nonzero(~(got[0].isfinite() & got[1].isfinite()).all(dim=0)
                        ).flatten().tolist()
    if bad != [11, 23] or not (bool((got[2][300:, 11] == 5).all())
                               and bool((got[2][100:, 23] == 3).all())):
        raise AssertionError(f"B5 poison: non-finite channels {bad}, or "
                             f"the poisoned bins not picked")
    # B1's edges: C = 1000, S in {1, 5, 37, 129}, sps 40 (num_avg 20).
    edges = [("C=1000", 1000, S, SPS, NUM_AVG)] + [
        (f"S={n}", C, n, SPS, NUM_AVG) for n in (1, 5, 37, 129)] + [
        ("sps=40", 256, S, 40, 20)]
    for label, n_ch, n_sym, sps, num_avg in edges:
        held(label, *planted(n_sym + num_avg - 1, n_ch, sps), sps, num_avg)
    log(json.dumps({"phase": "frontend_vs_plain", "kernel": "B5",
                    "cases": ["planted", "poison"] + [e[0] for e in edges],
                    "sample_index_equal": True, "samples_equal": True,
                    "nonfinite_where_plain": True,
                    "poison_nonfinite_channels": bad}))
    del re, im, got, ref

    gen = torch.Generator(device=dev).manual_seed(9)
    re = torch.randn((rows, C), generator=gen, device=dev)
    im = torch.randn((rows, C), generator=gen, device=dev)
    noise = check_b5("on noise", *split(re, im), **kw)
    torch.cuda.synchronize()
    log(json.dumps({"phase": "frontend_vs_plain", "kernel": "B5",
                    "channels": C, "symbols": S, "sps": SPS,
                    "num_avg": NUM_AVG, "planted_equal": True,
                    "noise_index_differ": noise["index_differ"],
                    "noise_outputs": S * C,
                    "noise_widest_relative_gap": noise["widest_gap"],
                    "near_tie_bound": NEAR_TIE_REL}))
    del re, im, noise

    targs = [(p[0][-keep:], p[1][-keep:], c[0], c[1])
             for p, c in zip(blocks[-1:] + blocks[:-1], blocks)]
    k_fn = lambda *a: fk.timing_frontend_tm(*a, **kw)       # noqa: E731
    r_fn = lambda *a: fk.timing_frontend_tm_ref(*a, **kw)   # noqa: E731
    p1 = event_ms(r_fn, targs)
    k1 = event_ms(k_fn, targs)
    k2 = event_ms(k_fn, targs)
    p2 = event_ms(r_fn, targs)
    log(json.dumps({"phase": "timing", "what": "timing_frontend_tm (B5) "
                    "block", "channels": C, "symbols": S,
                    "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                    "plan": fk.timing_plan(C, SPS)._asdict(),
                    "card": card}))
    # Per input sample its energy (3 operations); per (symbol, bin) the
    # window slide (2) and the first-max compare (1).
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), max_abs_err=err,
                bytes=2 * 4 * rows * C + 3 * 4 * S * C,
                ops=3 * rows * C + 3 * S * SPS * C)


def fused_phase(torch, dev, card: str, frames, profile) -> int:
    """Phase 10: the fused pipeline (B5 + the symbol backend) on the card,
    1 flexible + 10 assume_steady blocks, against the port's blockpsk
    feed-forward pipeline on the same card; then its input samples/s with
    the planes resident on the card.  Returns B5's launches in the run."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk
    from psk_soft_tpu_torch.models.fused import (fused_init,
                                                 make_fused_demod_fn)
    from psk_soft_tpu_torch.ops.cuda import frontend_kernel as fk

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    need = S * SPS
    flex = make_fused_demod_fn(cfg)
    steady = make_fused_demod_fn(cfg, assume_steady=True)

    def planes(b):
        x = torch.from_numpy(frames[b * need:(b + 1) * need]).to(dev)
        return x.real.contiguous(), x.imag.contiguous()

    fk.timing_frontend_tm.launches = 0
    st = fused_init(cfg, C, dev)
    outs = []
    for b in range(1 + STEADY_BLOCKS):
        st, out = (flex if b == 0 else steady)(st, *planes(b))
        outs.append(out)
    torch.cuda.synchronize()
    launches = fk.timing_frontend_tm.launches
    if launches != 1 + STEADY_BLOCKS:
        raise AssertionError(f"B5 launched {launches} times for "
                             f"{1 + STEADY_BLOCKS} blocks")
    worst = {"soft": 0.0, "phase": 0.0}
    ff = blockpsk.ff_init(cfg, C, dev)
    for b, out in enumerate(outs):
        re, im = planes(b)
        ff, ref = blockpsk.demod_block_ff(cfg, ff,
                                          torch.complex(re.T, im.T))
        v = ref.valid
        if not torch.equal(out.valid, v) or not (
                torch.equal(out.bits[v], ref.bits[v])
                and torch.equal(out.sample_index[v], ref.sample_index[v])):
            raise AssertionError(f"fused block {b}: validity, bits or "
                                 f"sample index differ from blockpsk")
        worst["soft"] = max(worst["soft"], float(
            (out.soft[v] - ref.soft[v]).abs().max()))
        worst["phase"] = max(worst["phase"], float(
            (out.phase[v] - ref.phase[v]).abs().max()))
    if worst["soft"] > FUSED_SOFT_TOL or worst["phase"] > FUSED_PHASE_TOL:
        raise AssertionError(f"fused vs blockpsk: {worst}")
    del outs

    re, im = planes(0)
    iters, best = 10, float("inf")
    for _ in range(2):
        st, out = steady(st, re, im)
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            st, out = steady(st, re, im)
        float(out.phase[0, 0])
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    log(json.dumps({"phase": "fused", "blocks": 1 + STEADY_BLOCKS,
                    "launches": launches, "bits_equal": True,
                    "sample_index_equal": True,
                    "soft_max_err": worst["soft"],
                    "phase_max_err": worst["phase"]}))
    log(json.dumps({"phase": "timing", "what": "fused pipeline, planes "
                    "resident on the card", "blocks": iters,
                    "ms_per_block": best * 1e3 / iters,
                    "samples_per_s": C * need * iters / best,
                    "card": card}))

    def feed(_b):
        nonlocal st
        st, _ = steady(st, re, im)

    profile(feed, card, "fused pipeline, planes resident", blocks=10)
    return launches


def lifecycle_phases(torch, dev, card: str, frames) -> int:
    """Phase 11: FullKernelBatchEngine's lifecycle at full width on the
    card: configure mid-stream against a CPU run of the first CPU_C
    channels; save_state -> load_state -> restore_full_state against the
    uninterrupted run; guard_nonfinite with NaN and inf planted in one
    channel (and inf in another's warm-up block).  Returns B1's launches
    in the configure run."""
    import dataclasses
    import tempfile

    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.cuda import demod_kernel
    from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
    from psk_soft_tpu_torch.runtime.streams import (PORT_BITS,
                                                    PORT_SAMPLE_INDEX, SRI)
    from psk_soft_tpu_torch.utils.build import BUILD_DIR
    from psk_soft_tpu_torch.utils.checkpoint import load_state, save_state

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    cfg2 = dataclasses.replace(cfg, num_avg=80, phase_avg=40)
    need = S * SPS
    blocks = [frames[b * need:(b + 1) * need] for b in range(8)]

    def planes(blk, width=C):
        return (np.ascontiguousarray(blk.real[:, :width]),
                np.ascontiguousarray(blk.imag[:, :width]))

    # --- configure mid-stream: num_avg 100 -> 80, phase_avg 50 -> 40 ---
    def run_configure(device, width):
        eng = FullKernelBatchEngine(cfg, width, block_symbols=S,
                                    device=device)
        eng.set_input_sri(SRI(stream_id="life", xdelta=1e-6))
        pkts = []
        for b, blk in enumerate(blocks):
            if b == 4:
                eng.configure(cfg2)
            eng.push_planes(*planes(blk, width))
            p = eng.step_packets()
            if p is not None:
                pkts.append(p)
        pkts.append(eng.flush_packets())
        return pkts, eng

    demod_kernel.demod_full_tm.launches = 0
    gpu_pkts, gpu = run_configure(dev, C)
    torch.cuda.synchronize()
    launches = demod_kernel.demod_full_tm.launches
    cpu_pkts, _ = run_configure("cpu", CPU_C)
    if not gpu.steady or gpu.metrics.reconfigures != 1 or launches < 6:
        raise AssertionError(f"configure: steady {gpu.steady}, launches "
                             f"{launches}")
    err = max(compare_service(gpu_pkts, cpu_pkts, "configure",
                              rows=CPU_C).values())
    log(json.dumps({"phase": "lifecycle", "what": "configure num_avg "
                    "100->80, phase_avg 50->40 after 4 blocks",
                    "channels": C, "cpu_channels": CPU_C,
                    "launches": launches, "back_to_kernel": True,
                    "max_err_vs_cpu": err}))

    # --- checkpoint: save, load, restore in a fresh engine ---
    run = FullKernelBatchEngine(cfg, C, block_symbols=S, device=dev)
    for blk in blocks[:4]:
        run.push_planes(*planes(blk))
        run.step_packets()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        path = f"{tmp}/full_state.npz"
        save_state(path, run.full_state, cfg, extra={"blocks_done": 4})
        state, cfg_l, extra = load_state(path, dev)
    resumed = FullKernelBatchEngine(cfg_l, C, block_symbols=S, device=dev)
    resumed.restore_full_state(state)
    for blk in blocks[4:7]:
        run.push_planes(*planes(blk))
        resumed.push_planes(*planes(blk))
        a, b = run.step_packets(), resumed.step_packets()
        if set(a) != set(b) or not all(
                np.array_equal(a[p].data, b[p].data) for p in a):
            raise AssertionError("restored engine differs from the "
                                 "uninterrupted run")
    log(json.dumps({"phase": "lifecycle", "what": "save_state -> "
                    "load_state -> restore_full_state", "blocks_after": 3,
                    "bit_equal": True, "extra": extra}))

    # --- guard_nonfinite: NaN and inf in channel 7, inf in 3's warm-up ---
    poisoned = [blk.copy() for blk in blocks[:6]]
    poisoned[0][:16, 3] = np.inf
    poisoned[2][100:120, 7] = np.nan
    poisoned[4][400, 7] = np.inf + 1j * np.inf

    def run_guard(device, width, data, guard):
        eng = FullKernelBatchEngine(cfg, width, block_symbols=S,
                                    guard_nonfinite=guard, device=device)
        pkts = []
        for blk in data:
            eng.push_planes(*planes(blk, width))
            pkts.append(eng.step_packets())
        return pkts, eng

    g_pkts, g_eng = run_guard(dev, C, poisoned, True)
    r_pkts, _ = run_guard(dev, C, blocks[:6], False)
    _, cpu_eng = run_guard("cpu", CPU_C, poisoned, True)
    torch.cuda.synchronize()
    resyncs = g_eng.channel_resyncs
    if not (np.array_equal(resyncs[:CPU_C], cpu_eng.channel_resyncs)
            and not resyncs[CPU_C:].any()
            and resyncs[3] == 1 and resyncs[7] == 2
            and resyncs.sum() == 3):
        raise AssertionError(f"channel_resyncs {np.flatnonzero(resyncs)} "
                             f"-> {resyncs[resyncs > 0]}, CPU "
                             f"{cpu_eng.channel_resyncs[:8]}")
    healthy = np.ones(C, bool)
    healthy[[3, 7]] = False
    for a, b in zip(g_pkts, r_pkts):
        for port in a:
            da, db = a[port].data, b[port].data
            if not np.array_equal(da[healthy], db[healthy]):
                raise AssertionError(f"guard: healthy channels of {port} "
                                     f"differ from the unpoisoned run")
    last = g_pkts[-1]["softDecision_dataFloat_out"].data
    if not np.isfinite(last).all():
        raise AssertionError("guarded channel still non-finite")
    log(json.dumps({"phase": "lifecycle", "what": "guard_nonfinite, NaN "
                    "and inf planted", "channel_resyncs": {
                        str(c): int(resyncs[c])
                        for c in np.flatnonzero(resyncs)},
                    "equal_to_cpu": True, "healthy_bit_equal": True}))
    return launches


def acquire_phase(torch, dev, card: str) -> dict:
    """Phase 12: ChainEngine(acquire_cfo=True) at full width on the card,
    per-channel carrier offsets 0.018 + 0.006*c/C cycles/sample (beyond the
    QPSK tracker's pull-in): every planted frame after the warm-up decoded
    once with exact bits and the CRC green, the estimates within 1e-4 of
    the truth, the plain engine decoding fewer than half.  Returns B1's and
    B2's launches in the acquiring run."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
    from psk_soft_tpu_torch.ops.cuda import demod_kernel, viterbi_kernel
    from psk_soft_tpu_torch.ops.fec import CODE_K7
    from psk_soft_tpu_torch.ops.framesync import FrameFormat
    from psk_soft_tpu_torch.runtime.chain_engine import ChainEngine

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    rng = np.random.default_rng(21)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    starts, infos, x, n_info = plant_chain_stream(fmt, CODE_K7, CRC16_CCITT,
                                                  rng)
    freqs = (0.018 + 0.006 * np.arange(C) / C).astype(np.float32)
    need = S * SPS
    n_blocks = 1 + STEADY_BLOCKS
    planes = []
    for b in range(n_blocks):
        t = np.arange(b * need, (b + 1) * need, dtype=np.float64)
        y = (x * np.exp(2j * np.pi * freqs[:, None].astype(np.float64)
                        * t[None])).astype(np.complex64)
        planes.append((np.ascontiguousarray(y.real.T),
                       np.ascontiguousarray(y.imag.T)))
    del x, y

    def drive(eng):
        for re, im in planes:
            eng.push_planes(re, im)
            eng.step()
        eng.flush()
        torch.cuda.synchronize()
        return eng.pop_frames()

    acq = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S,
                      acquire_cfo=True, device=dev)
    demod_kernel.demod_full_tm.launches = 0
    viterbi_kernel.viterbi_fused.launches = 0
    t0 = time.perf_counter()
    frames = drive(acq)
    acq_s = time.perf_counter() - t0
    launches = {"demod_full_tm": demod_kernel.demod_full_tm.launches,
                "viterbi_fused": viterbi_kernel.viterbi_fused.launches}
    if min(launches.values()) < STEADY_BLOCKS:
        raise AssertionError(f"acquire_cfo launches {launches}")
    plain_ok = sum(f.crc_ok for f in drive(ChainEngine(
        cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S, device=dev)))

    a1 = NUM_AVG - 1
    planted = {(c, b * S + s0): j for b in range(n_blocks)
               for j, s0 in enumerate(starts) for c in range(C)}
    must = {key for key in planted if key[1] >= S
            and key[1] + fmt.frame_len <= n_blocks * S - a1}
    keys = [(f.channel, f.start) for f in frames]
    if len(set(keys)) != len(keys) or not must <= set(keys) <= set(planted):
        raise AssertionError(f"acquire_cfo: {len(must - set(keys))} "
                             f"planted frames missed, "
                             f"{len(keys) - len(set(keys))} twice")
    for f in frames:
        if not f.crc_ok or not np.array_equal(
                f.info_bits, infos[f.channel, planted[(f.channel,
                                                       f.start)]]):
            raise AssertionError(f"acquire_cfo frame {(f.channel, f.start)}"
                                 f": CRC {f.crc_ok} or info bits wrong")
    cfo_err = float(np.abs(acq.cfo_estimates - freqs).max())
    if cfo_err > CFO_TOL or acq.crc_failures or acq.overflow_peaks:
        raise AssertionError(f"cfo error {cfo_err}, CRC failures "
                             f"{acq.crc_failures}")
    if plain_ok >= len(must) / 2:
        raise AssertionError(f"the plain engine decoded {plain_ok} of "
                             f"{len(must)}: the offsets are not beyond "
                             f"its pull-in")
    log(json.dumps({"phase": "chain_acquire_cfo", "channels": C,
                    "blocks": n_blocks, "frames": len(frames),
                    "frames_required": len(must),
                    "plain_engine_crc_ok": plain_ok,
                    "cfo_max_abs_err": cfo_err, "launches": launches,
                    "card_s": acq_s, "card": card}))
    return launches


def long_trellis_phase(torch, dev) -> dict:
    """Phase 13: ops/fec.viterbi_decode on a trellis longer than the fused
    kernel holds (2048 steps): kernels B3 then B4, bits equal to the plain
    decoder on the CPU.  Returns their launches in that call."""
    from psk_soft_tpu_torch.ops import fec
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

    llr = viterbi_llrs(fec.CODE_K7, 32, 2048 - 6, False, 91)
    vk.viterbi_acs.launches = vk.viterbi_traceback.launches = 0
    bits = fec.viterbi_decode(fec.CODE_K7, torch.from_numpy(llr).to(dev))
    torch.cuda.synchronize()
    launches = {"viterbi_acs": vk.viterbi_acs.launches,
                "viterbi_traceback": vk.viterbi_traceback.launches}
    cpu = fec.viterbi_decode(fec.CODE_K7, torch.from_numpy(llr))
    if min(launches.values()) < 1 or not torch.equal(bits.cpu(), cpu):
        raise AssertionError(f"long trellis: launches {launches}, bits "
                             f"equal {torch.equal(bits.cpu(), cpu)}")
    log(json.dumps({"phase": "long_trellis", "rows": 32, "steps": 2048,
                    "launches": launches, "bits_equal_to_cpu": True}))
    return launches


# BASELINE config 3 (8-PSK, RRC beta 0.35 span 8, early-late timing) and
# config 4's shared widths (a BPSK/QPSK/8-PSK bank, modes per channel):
# psk_soft_tpu/eval/baseline_configs.py.
CFG3 = dict(sps=8, num_avg=50, constellation_size=8, phase_avg=40,
            matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
            timing_interp=True)
CFG4 = dict(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
I16_FULL_SCALE = 30000.0      # int16 wire: the largest sample's code
P99_8PSK_RAD = 0.2            # config 3: soft decisions near 8-PSK points
                              # (half of the pi/8 decision distance)


def shaped_channels(num_symbols: int, m: int, n_ch: int = C,
                    noise: float = 0.01) -> np.ndarray:
    """(n_ch, num_symbols*8) complex64 RRC-shaped M-PSK (config 3's pulse:
    beta 0.35, span 8, sps 8) with a small frequency offset and complex
    Gaussian noise of std ``noise``; channel i draws from seed 1000 + i."""
    from psk_soft_tpu_torch.ops.matched_filter import rrc_taps

    taps = rrc_taps(8, CFG3["rrc_beta"], CFG3["rrc_span"]).astype(np.float64)
    n = num_symbols * 8
    rot = np.exp(2j * np.pi * 2e-5 * np.arange(n))
    out = np.empty((n_ch, n), np.complex64)
    for i in range(n_ch):
        rng = np.random.default_rng(1000 + i)
        up = np.zeros(n, np.complex128)
        up[::8] = np.exp(2j * np.pi * rng.integers(0, m, num_symbols) / m)
        x = np.convolve(up, taps)[:n] * rot
        x += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        out[i] = x
    return out


def mixed_modes(n_ch: int, seed: int = 4):
    """Per-channel M in {2, 4, 8} and differential flags (config 4)."""
    rng = np.random.default_rng(seed)
    return rng.choice([2, 4, 8], n_ch), rng.random(n_ch) < 0.5


def mixed_channels(num_symbols: int, ms, diffs, noise: float = 0.01,
                   seed0: int = 0) -> np.ndarray:
    """channels() with each channel's own M and differential flag."""
    n_ch = len(ms)
    out = np.empty((n_ch, num_symbols * SPS), np.complex64)
    rot = np.exp(2j * np.pi * 2e-4 * SPS * np.arange(num_symbols))
    for i in range(n_ch):
        rng = np.random.default_rng(seed0 + i)
        m = int(ms[i])
        pts = np.exp(2j * np.pi * rng.integers(0, m, num_symbols) / m)
        if diffs[i]:
            pts = np.cumprod(pts)
        x = np.zeros(num_symbols * SPS, np.complex64)
        x[2::SPS] = pts * rot
        x += (noise * rng.standard_normal(x.size)).astype(np.complex64)
        out[i] = x
    return out


def wire(x: np.ndarray):
    """int16 wire planes of a channel-major complex bank: (re, im) (T, C)
    int16 and the scale that dequantizes them (I16_FULL_SCALE at the
    largest sample)."""
    scale = float(max(np.abs(x.real).max(), np.abs(x.imag).max())
                  / I16_FULL_SCALE)
    q = lambda v: np.round(np.ascontiguousarray(v.T) / scale).astype(  # noqa: E731,E501
        np.int16)
    return q(x.real), q(x.imag), scale


def mode_inputs(torch, dev, cfg, xs: np.ndarray, warm: int = WARM,
                params=None, i16: bool = False):
    """Warm a bank up through the feed-forward pipeline (models/blockpsk,
    or models/mixed with ``params``) for ``warm`` symbols and hand it to
    the kernel: returns (FullState, x_re, x_im, kernel keywords) with the
    rest of ``xs`` as (rows, C) planes, int16 wire planes and an int16
    window with ``i16``."""
    from psk_soft_tpu_torch.models import blockpsk, full, mixed

    n_ch = xs.shape[0]
    kw = dict(sps=cfg.sps, num_avg=cfg.num_avg, phase_avg=cfg.phase_avg,
              m=cfg.constellation_size, diff=cfg.differential,
              mf_taps=full._static_taps(cfg),
              timing_interp=cfg.timing_interp)
    scale = None
    if i16:
        re_w, im_w, scale = wire(xs)
        xs = ((re_w.astype(np.float32) * scale).T
              + 1j * (im_w.astype(np.float32) * scale).T).astype(np.complex64)
        kw["in_scale"] = scale
    t = torch.from_numpy(xs).to(dev)
    w = warm * cfg.sps
    if params is None:
        st, _ = blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, n_ch, dev),
                                        t[:, :w])
    else:
        st, _ = mixed.demod_block_mixed(cfg, params, mixed.mixed_init(
            cfg, n_ch, dev), t[:, :w])
        kw["mixed"] = True
    raw = t[:, w - full.window_rows(cfg):w]
    state = full.full_from_ff(cfg, st, raw_win=raw if kw["mf_taps"] else None,
                              mixed_params=params)
    if i16:
        state = full.quantize_full_state(state, scale)
        x_re = torch.from_numpy(re_w[w:]).to(dev)
        x_im = torch.from_numpy(im_w[w:]).to(dev)
    else:
        x_re = t[:, w:].real.T.contiguous()
        x_im = t[:, w:].imag.T.contiguous()
    return state, x_re, x_im, kw


def b1_modes_phase(torch, dev) -> dict:
    """Phase 3, the modes of kernel B1 that take other inputs: against the
    plain version on the card at 1024 x 512, two blocks from one carry
    each, held by b1_errors (bits and sample index equal, soft 3e-3, phase
    2e-3): int16 ingest (QPSK at sps 8, num_avg 100, phase_avg 50; also
    bit-equal to the float32 kernel on the dequantized planes);
    timing_interp (same widths); the matched filter at config 3's widths
    (RRC, 65 taps, argmax timing); config 3 whole (int16 + RRC +
    timing_interp); mixed at config 4's (M in {2, 4, 8}, differential per
    channel).  Edges in config 3 and in mixed: C = 1000, S in {1, 37}.
    Poison under the matched filter: a NaN raw sample in channel 5 (block
    symbol 307) and an +inf in channel 9 (symbol 102).  Returns the largest soft or phase error of each
    mode."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models.mixed import MixedParams
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

    worst = {}

    def check(name, case, inputs, n_sym, blocks, **extra):
        state, x_re, x_im, kw = inputs
        kw = dict(kw, **extra)
        outs, errs = b1_blocks(torch, {"mode": name, **case}, state, x_re,
                               x_im, n_sym, blocks, kw)
        worst[name] = max([worst.get(name, 0.0)]
                          + [v for k, v in errs.items()
                             if k.startswith(("soft", "phase"))])
        return outs

    base = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                       phase_avg=PHASE_AVG)
    xs = channels(WARM + 2 * S)
    i16_in = mode_inputs(torch, dev, base, xs, i16=True)
    outs = check("int16", {}, i16_in, S, 2)
    # The same planes dequantized, through the float32 kernel: bit-equal.
    st, x_re, x_im, kw = i16_in
    sc = kw.pop("in_scale")
    f32 = dk.demod_full_tm(st.win_re.float() * sc, st.win_im.float() * sc,
                           x_re[:S * SPS].float() * sc,
                           x_im[:S * SPS].float() * sc, st.planes, **kw)
    if not all(torch.equal(a, b) for a, b in zip(outs[0][0], f32)):
        raise AssertionError("int16 kernel differs from the float32 kernel "
                             "on the dequantized planes")
    del i16_in, f32
    check("timing_interp", {}, mode_inputs(
        torch, dev, dataclasses.replace(base, timing_interp=True), xs), S, 2)

    cfg3 = DemodConfig(**CFG3)
    sx = shaped_channels(WARM + 2 * S, 8)
    check("matched_filter", {"config": 3, "timing_interp": False},
          mode_inputs(torch, dev, dataclasses.replace(
              cfg3, timing_interp=False), sx), S, 2)
    c3 = mode_inputs(torch, dev, cfg3, sx, i16=True)
    check("config3", {"int16": True}, c3, S, 2)
    check("config3", {"case": "S=37"}, c3, 37, 2)
    check("config3", {"case": "S=1"}, c3, 1, 2)
    del sx, c3
    check("config3", {"case": "C=1000"}, mode_inputs(
        torch, dev, cfg3, shaped_channels(WARM + S, 8, n_ch=1000),
        i16=True), S, 1)

    cfg4 = DemodConfig(**CFG4)
    ms, diffs = mixed_modes(C)
    mx = mode_inputs(torch, dev, cfg4, mixed_channels(WARM + 2 * S, ms, diffs),
                     params=MixedParams.make(ms, diffs, dev))
    check("mixed", {"config": 4}, mx, S, 2, m=2)
    check("mixed", {"case": "S=37"}, mx, 37, 2, m=2)
    check("mixed", {"case": "S=1"}, mx, 1, 2, m=2)
    del mx
    ms1, d1 = mixed_modes(1000, seed=5)
    check("mixed", {"case": "C=1000"}, mode_inputs(
        torch, dev, cfg4, mixed_channels(WARM + S, ms1, d1),
        params=MixedParams.make(ms1, d1, dev)), S, 1, m=2)

    # Poison under the matched filter: one NaN raw sample poisons the 65
    # filtered samples that reach it, an +inf as many; the plain version's
    # first-NaN / first-inf rule then holds on the filtered stream.
    st, x_re, x_im, kw = mode_inputs(
        torch, dev, dataclasses.replace(cfg3, timing_interp=False),
        shaped_channels(WARM + S, 8))
    sn, si = S * 3 // 5, S // 5
    x_re[sn * SPS + 5, 5] = float("nan")
    x_im[si * SPS + 3, 9] = float("inf")
    (got, ref), = check("matched_filter", {"case": "poison"},
                        (st, x_re, x_im, kw), S, 1)
    bad = torch.nonzero(~got[0].isfinite().all(dim=0)).flatten().tolist()
    if bad != [5, 9]:
        raise AssertionError(f"poison under the filter: non-finite soft on "
                             f"channels {bad}")
    log(json.dumps({"phase": "kernel_vs_plain", "case": "poison, matched "
                    "filter", "nan": [5, sn], "inf": [9, si],
                    "nonfinite_soft_symbols": int((~got[0].isfinite())
                                                  .sum()),
                    "nonfinite_where_plain": True}))
    return worst


def config3_engine_phase(torch, dev, card, profile) -> dict:
    """Phase 14: NativePlaneBank("i16") -> FullKernelBatchEngine at BASELINE
    config 3 (8-PSK, RRC, timing_interp) with ingest_scale, at 1024
    channels: 1 warm-up block, STEADY_BLOCKS steady blocks and a flush on
    the card against the same engine on the CPU for the first CPU_C
    channels (compare_service), the window carry int16, every symbol
    emitted (the flush masks the filter's last ceil(64/8) symbols) and
    near an 8-PSK point; then its samples/s and one profiled pass (the
    host-to-device copies of int16 planes).  Returns B1's launches on the
    path, in all and per mode."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk
    from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
    from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
    from psk_soft_tpu_torch.runtime.streams import PORT_SOFT, SRI

    cfg = DemodConfig(**CFG3)
    need = S * SPS
    n_blocks = 1 + STEADY_BLOCKS
    re_w, im_w, scale = wire(shaped_channels(n_blocks * S + S // 2, 8))
    frames = np.stack([re_w, im_w], -1)           # (T, C, 2) I/Q pairs
    del re_w, im_w

    def drive(device, width):
        eng = FullKernelBatchEngine(cfg, width, block_symbols=S,
                                    ingest_scale=scale, device=device)
        eng.set_input_sri(SRI(stream_id="config3", xdelta=1e-6))
        bank = NativePlaneBank(width, capacity_samples=4 * need, dtype="i16")
        pkts = []
        for b in range(n_blocks + 1):
            rows = frames[b * need:(b + 1) * need, :width]
            bank.push_interleaved(rows)
            re, im, flushed = bank.pop_planes(rows.shape[0], timeout=0)
            if flushed or re.dtype != np.int16:
                raise AssertionError(f"i16 bank: flushed {flushed}, "
                                     f"{re.dtype}")
            eng.push_planes(re, im)
            pkts.append(eng.step_packets() if b < n_blocks
                        else eng.flush_packets())
        bank.close()
        return pkts, eng

    dk.demod_full_tm.launches = 0
    dk.demod_full_tm.mode_launches = dict.fromkeys(
        dk.demod_full_tm.mode_launches, 0)
    gpu_pkts, gpu = drive(dev, C)
    torch.cuda.synchronize()
    launches = dk.demod_full_tm.launches
    modes = dict(dk.demod_full_tm.mode_launches)
    cpu_pkts, _ = drive("cpu", CPU_C)
    if launches < STEADY_BLOCKS + 1 or modes["int16"] != launches \
            or modes["matched_filter"] != launches \
            or modes["timing_interp"] != launches:
        raise AssertionError(f"config 3: launches {launches}, {modes}")
    if gpu.full_state.win_re.dtype != torch.int16:
        raise AssertionError("config 3: the window carry left int16")
    err = max(compare_service(gpu_pkts, cpu_pkts, "config 3",
                              rows=CPU_C).values())
    soft = np.concatenate([p[PORT_SOFT].data for p in gpu_pkts], axis=1)
    expect = n_blocks * S - (cfg.num_avg - 1) + S // 2 - 8
    slot = np.angle(soft) * 8 / (2 * np.pi)
    dist = np.abs(slot - np.round(slot)) * (2 * np.pi / 8)
    if soft.shape != (C, expect) or not np.isfinite(soft).all() \
            or float(np.percentile(dist, 99)) > P99_8PSK_RAD:
        raise AssertionError(f"config 3: soft {soft.shape} (expected "
                             f"{expect}), p99 distance "
                             f"{np.percentile(dist, 99)}")
    log(json.dumps({"phase": "config3_engine", "channels": C,
                    "cpu_channels": CPU_C, "ingest": "int16",
                    "in_scale": scale, "launches": launches,
                    "mode_launches": modes, "symbols": expect,
                    "max_err_vs_cpu": err,
                    "p99_distance_to_8psk_rad": float(np.percentile(dist,
                                                                    99)),
                    "card": card}))

    # Samples/s at depth 0 with debug ports off, then one profiled pass.
    eng = FullKernelBatchEngine(cfg, C, block_symbols=S, ingest_scale=scale,
                                debug_ports=False, device=dev)
    bank = NativePlaneBank(C, capacity_samples=4 * need, dtype="i16")

    def feed(b):
        bank.push_interleaved(frames[(b % n_blocks) * need:
                                     (b % n_blocks + 1) * need])
        re, im, _ = bank.pop_planes(need, timeout=0)
        eng.push_planes(re, im)
        return eng.step_packets()

    for b in range(3):
        feed(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(20):
        feed(3 + b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(json.dumps({"phase": "timing", "what": "config-3 int16 engine end "
                    "to end", "pipeline_depth": 0, "debug_ports": False,
                    "blocks": 20, "seconds": dt,
                    "samples_per_s": 20 * need * C / dt, "card": card}))
    profile(feed, card, what="config-3 int16 engine, depth 0",
            watch={"b1_stage0_filter": "demod_fir",
                   "b1_stage_a": "demod_timing",
                   "b1_stage_b": "demod_track"})
    bank.close()
    return {"launches": launches, "modes": modes}


def mixed_engine_phase(torch, dev, card) -> int:
    """Phase 15: MixedKernelBatchEngine at config 4's widths on the card at
    1024 channels (M in {2, 4, 8} and the differential flag drawn per
    channel): 1 warm-up block, STEADY_BLOCKS blocks with set_params before
    block 5 (channels 0-63 of M 2 or 4 double it, so their tracking
    restarts and the bank re-warms for a block), a flush; against the same
    engine on the CPU for the first CPU_C channels.  Returns B1's
    mixed-mode launches on the path."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models.mixed import MixedParams
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk
    from psk_soft_tpu_torch.runtime.engine_mixed import MixedKernelBatchEngine
    from psk_soft_tpu_torch.runtime.streams import PORT_BITS, SRI

    cfg = DemodConfig(**CFG4)
    need = S * SPS
    n_blocks = 1 + STEADY_BLOCKS
    ms, diffs = mixed_modes(C)
    sig = mixed_channels(n_blocks * S + S // 2, ms, diffs)
    re = np.ascontiguousarray(sig.real.T)
    im = np.ascontiguousarray(sig.imag.T)
    del sig
    # Channels 0-63 of M 2 or 4 double their M: their signals' points are
    # points of the new constellation, so every decision stays decisive.
    new_m = ms.copy()
    new_m[:64] = np.where(ms[:64] == 8, 8, 2 * ms[:64])

    def drive(device, width):
        eng = MixedKernelBatchEngine(
            MixedParams.make(ms[:width], diffs[:width], device), cfg, width,
            block_symbols=S, device=device)
        eng.set_input_sri(SRI(stream_id="mixed", xdelta=1e-6))
        pkts = []
        for b in range(n_blocks + 1):
            if b == n_blocks // 2:
                eng.set_params(MixedParams.make(new_m[:width],
                                                diffs[:width], device))
            rows = slice(b * need, (b + 1) * need)
            eng.push_planes(re[rows, :width], im[rows, :width])
            p = (eng.step_packets() if b < n_blocks
                 else eng.flush_packets())
            pkts.append(p)
        return pkts, eng

    dk.demod_full_tm.launches = 0
    dk.demod_full_tm.mode_launches = dict.fromkeys(
        dk.demod_full_tm.mode_launches, 0)
    gpu_pkts, gpu = drive(dev, C)
    torch.cuda.synchronize()
    launches = dk.demod_full_tm.mode_launches["mixed"]
    cpu_pkts, _ = drive("cpu", CPU_C)
    if launches < STEADY_BLOCKS - 1 or launches != dk.demod_full_tm.launches:
        raise AssertionError(f"mixed: {launches} mixed launches of "
                             f"{dk.demod_full_tm.launches}")
    if not gpu.steady or gpu.metrics.reconfigures != 1:
        raise AssertionError("mixed: not back on the kernel after "
                             "set_params")
    err = max(compare_service(gpu_pkts, cpu_pkts, "mixed",
                              rows=CPU_C).values())
    width = {p[PORT_BITS].data.shape[1] // max(1, p["softDecision_"
             "dataFloat_out"].data.shape[1]) for p in gpu_pkts if p}
    if width != {3}:
        raise AssertionError(f"mixed: bit port widths {width}")
    log(json.dumps({"phase": "mixed_engine", "channels": C,
                    "cpu_channels": CPU_C, "launches": launches,
                    "set_params_channels_changed": int((new_m != ms).sum()),
                    "max_err_vs_cpu": err, "card": card}))
    return launches


# The Pallas kernel's in-kernel matched filter (chunked banded matmuls).
MF_PALLAS = "psk_soft_tpu/ops/pallas/demod_kernel.py:342"
FIR_NTAPS = (1, 2, 9, 65, 257)  # stage 0's checks: boxcar-short to long RRC
FIR_TOL = 1e-5                # stage 0: |diff| <= FIR_TOL * sum|taps|
                              # * max|raw|


def fir_taps(ntaps: int) -> np.ndarray:
    """Stage 0's test taps: config 3's RRC at 65 taps, else seeded normal
    ones (a sum of mixed signs)."""
    from psk_soft_tpu_torch.ops.matched_filter import rrc_taps

    if ntaps == 65:
        return rrc_taps(SPS)
    return np.random.default_rng(ntaps).standard_normal(ntaps).astype(
        np.float32)


def fir_phase(torch, dev) -> float:
    """Phase 3, stage 0 of B1 alone (matched_filter_tm, the redesigned
    demod_fir_kernel) against its plain version on the card: config 3's
    4488 filtered rows at C 1000 and 1024, ntaps in FIR_NTAPS, float32
    planes with a NaN and an +inf raw sample planted, and int16 planes
    (i16 * in_scale).  Each plan's shared memory equals the library's own
    count.  Holds |diff| <= FIR_TOL * sum|taps| * max|raw| on finite
    values (the plain version rounds each product and sum apart, the
    kernel takes one fused multiply-add a tap) and NaN and inf exactly
    where the plain version has them.  Returns the largest absolute error
    at C 1024 and 65 taps (config 3's RRC), by plane type (int16 or
    not)."""
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

    lib = dk.load_library()[0]
    gen = torch.Generator(device=dev).manual_seed(13)
    rows_f = (CFG3["num_avg"] - 1 + S) * SPS
    worst = {}
    for n_ch in (1000, C):
        for ntaps in FIR_NTAPS:
            taps = fir_taps(ntaps)
            rows = rows_f + ntaps - 1
            for i16 in (False, True):
                re = torch.randn((rows, n_ch), generator=gen, device=dev)
                im = torch.randn((rows, n_ch), generator=gen, device=dev)
                scale = 1.0
                if i16:
                    scale = 1.0 / 8000
                    re = (re * 8000).round().to(torch.int16)
                    im = (im * 8000).round().to(torch.int16)
                else:
                    re[rows // 2, 7] = float("nan")
                    im[rows // 3, n_ch - 3] = float("inf")
                plan = dk.fir_plan(n_ch, rows_f, ntaps, re.element_size(),
                                   dk.plane_align(re, im))
                lib_smem = lib.psk_demod_full_smem(
                    2, 0, 0, plan.tile, plan.stages, re.element_size(), 0,
                    ntaps)
                if lib_smem != plan.smem:
                    raise AssertionError(f"stage 0 plan {plan}: library "
                                         f"shared memory {lib_smem}")
                got = dk.matched_filter_tm(re, im, taps, in_scale=scale)
                ref = dk.matched_filter_tm_ref(re, im, taps, in_scale=scale)
                torch.cuda.synchronize()
                raw_max = max(float((t.float() * scale).nan_to_num(
                    0.0, 0.0, 0.0).abs().max()) for t in (re, im))
                tol = FIR_TOL * float(np.abs(taps).sum()) * raw_max
                err = max(finite_err(g, r) for g, r in zip(got, ref))
                if err > tol:
                    raise AssertionError(f"stage 0, C {n_ch}, {ntaps} taps, "
                                         f"int16 {i16}: error {err} > {tol}")
                bad = int(sum((~g.isfinite()).sum() for g in got))
                if not i16 and not bad:
                    raise AssertionError("stage 0: the planted NaN and inf "
                                         "reached no output")
                if n_ch == C and ntaps == 65:
                    worst[i16] = err
                log(json.dumps({"phase": "kernel_vs_plain",
                                "kernel": "matched_filter_tm",
                                "channels": n_ch, "rows": rows_f,
                                "ntaps": ntaps, "int16": i16,
                                "max_abs_err": err, "tol": tol,
                                "nonfinite_outputs": bad,
                                "nonfinite_where_plain": True,
                                "plan": plan._asdict()}))
    return worst


def fir_times(torch, dev, card, event_ms) -> dict:
    """Phase 5c: stage 0 alone (matched_filter_tm) at config 3's widths
    (1024 channels, 4488 filtered rows, RRC 65 taps) over four distinct
    blocks, float32 and int16: the wrapper by CUDA events against its plain
    version (plain, kernel, kernel, plain), its device time (torch.profiler)
    and, on float32 planes, F.conv2d of the stacked (2, 1, rows, C) planes
    with the (65, 1) taps in float32 (TF32 off), the best of three event
    readings: one PyTorch call that computes the same function, timed here
    and used nowhere in the port.  Returns per plane type the numbers of
    its kernels-line row."""
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

    conv2d = torch.nn.functional.conv2d
    gen = torch.Generator(device=dev).manual_seed(17)
    taps = fir_taps(65)
    rows_f = (CFG3["num_avg"] - 1 + S) * SPS
    rows = rows_f + 64
    weight = torch.tensor(taps, device=dev).view(1, 1, 65, 1)
    out = {}
    for i16 in (False, True):
        blocks = []
        for _ in range(4):
            planes = torch.randn((2, rows, C), generator=gen, device=dev)
            if i16:
                planes = (planes * 8000).round().to(torch.int16)
            blocks.append((planes[0], planes[1], planes))
        scale = 1.0 / 8000 if i16 else 1.0
        k_fn = lambda a, b, _p: dk.matched_filter_tm(      # noqa: E731
            a, b, taps, in_scale=scale)
        r_fn = lambda a, b, _p: dk.matched_filter_tm_ref(  # noqa: E731
            a, b, taps, in_scale=scale)
        p1 = event_ms(r_fn, blocks)
        k1 = event_ms(k_fn, blocks)
        k2 = event_ms(k_fn, blocks)
        p2 = event_ms(r_fn, blocks)
        lib_ms = None
        if not i16:
            lib_ms = [event_ms(lambda a, b, p: conv2d(
                p.view(2, 1, rows, C), weight), blocks) for _ in range(3)]
            got = dk.matched_filter_tm(*blocks[0][:2], taps)
            want = conv2d(blocks[0][2].view(2, 1, rows, C), weight)
            torch.cuda.synchronize()
            conv_err = max(float((g - w.view(rows_f, C)).abs().max())
                           for g, w in zip(got, want))
        nxt = itertools.cycle(blocks).__next__
        dev_ms = kernel_device_ms(torch, lambda: k_fn(*nxt()), "demod_fir")
        es = 2 if i16 else 4
        nbytes = 2 * rows * C * es + 4 * 65 + 2 * rows_f * C * 4
        ops = 4 * 65 * rows_f * C
        out[i16] = dict(kernel_ms=[k1, k2], plain_ms=[p1, p2],
                        device_ms=dev_ms, library_ms=lib_ms, bytes=nbytes,
                        ops=ops)
        log(json.dumps({"phase": "timing", "what": "matched_filter_tm "
                        "(B1 stage 0)", "channels": C, "rows": rows_f,
                        "ntaps": 65, "int16": i16, "kernel_ms": [k1, k2],
                        "plain_ms": [p1, p2], "device_ms": dev_ms,
                        "conv2d_ms": lib_ms,
                        "conv2d_max_abs_diff": None if i16 else conv_err,
                        "bytes": nbytes, "ops": ops, "card": card}))
        del blocks
    return out


B1_MODE_NAMES = ("int16", "timing_interp", "matched_filter", "config3",
                 "mixed")


def b1_mode_times(torch, dev, card, event_ms) -> dict:
    """Phase 5b: kernel B1 in each mode at 1024 x 512 with debug ports off,
    over four distinct random blocks: the wrapper by CUDA events against
    its plain version (plain, kernel, kernel, plain), its stages' device
    time (one torch.profiler pass), and the bytes and operations its bound
    is reckoned from.  int16 and timing_interp at the default widths (sps
    8, num_avg 100, phase_avg 50, QPSK); the matched filter at config 3's
    (RRC 65 taps, argmax timing); config 3 whole on int16 planes; mixed at
    config 4's."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk, full
    from psk_soft_tpu_torch.models.mixed import MixedParams
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk

    base = dict(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                phase_avg=PHASE_AVG)
    cases = {"int16": (base, True, False),
             "timing_interp": (dict(base, timing_interp=True), False, False),
             "matched_filter": (dict(CFG3, timing_interp=False), False,
                                False),
             "config3": (CFG3, True, False),
             "mixed": (CFG4, False, True)}
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for name, (ckw, i16, is_mixed) in cases.items():
        cfg = DemodConfig(**ckw)
        params = (MixedParams.make(*mixed_modes(C), dev) if is_mixed
                  else None)
        rows_w = full.window_rows(cfg)
        raw = torch.zeros((C, rows_w), dtype=torch.complex64, device=dev)
        state = full.full_from_ff(cfg, blockpsk.ff_init(cfg, C, dev),
                                  raw_win=raw if cfg.matched_filter != "none"
                                  else None, mixed_params=params)
        blocks = []
        for _ in range(4):
            xr = 0.5 * torch.randn((rows_w + S * SPS, C), generator=gen,
                                   device=dev)
            xi = 0.5 * torch.randn((rows_w + S * SPS, C), generator=gen,
                                   device=dev)
            if i16:
                xr = (xr * 8000).round().to(torch.int16)
                xi = (xi * 8000).round().to(torch.int16)
            blocks.append((xr, xi))
        kw = dict(sps=cfg.sps, num_avg=cfg.num_avg, phase_avg=cfg.phase_avg,
                  m=cfg.constellation_size, diff=False,
                  mf_taps=full._static_taps(cfg),
                  timing_interp=cfg.timing_interp, mixed=is_mixed,
                  in_scale=1.0 / 8000 if i16 else 1.0, debug_ports=False)
        args = [(xr[:rows_w], xi[:rows_w], xr[rows_w:], xi[rows_w:],
                 state.planes) for xr, xi in blocks]
        k_fn = lambda *a: dk.demod_full_tm(*a, **kw)       # noqa: E731
        r_fn = lambda *a: dk.demod_full_tm_ref(*a, **kw)   # noqa: E731
        p1 = event_ms(r_fn, args)
        k1 = event_ms(k_fn, args)
        k2 = event_ms(k_fn, args)
        p2 = event_ms(r_fn, args)
        stages = b1_stage_ms(torch, k_fn, args)
        es = 2 if i16 else 4
        ntaps = len(kw["mf_taps"] or ())
        n_in = (rows_w + S * SPS) * C
        rs = dk.state_rows(cfg.phase_avg) * C
        nbytes = (2 * n_in * es + rs * 4 + 4 * ntaps
                  + 2 * S * C * 4 + S * C + rs * 4)
        rows_f = (cfg.num_avg - 1 + S) * SPS
        ops = (3 * rows_f * C + S * C * (2 * cfg.phase_avg + 40)
               + 4 * ntaps * rows_f * C
               + (S * C * (4 * SPS + 30) if cfg.timing_interp else 0))
        out[name] = dict(kernel_ms=[k1, k2], plain_ms=[p1, p2],
                         stage_ms=stages, bytes=nbytes, ops=ops)
        log(json.dumps({"phase": "timing", "what": f"demod_full_tm block, "
                        f"{name}", "channels": C, "symbols": S,
                        "config": ckw, "int16": i16, "kernel_ms": [k1, k2],
                        "plain_ms": [p1, p2], "stage_ms": stages,
                        "bytes": nbytes, "ops": ops, "card": card}))
        del blocks, args
    return out


# --- phases 16-19: the plain service path (exact scan, StreamEngine,
# StreamRegistry, BatchEngine, GroupEngine); no kernel runs on it.
GOLDEN_NSYM = 1000            # tests/test_golden.py's golden vectors
GOLDEN_TOL = 1e-3             # the reference's own soft tolerance
ORACLE_CASES = ((2, False, 0.0), (4, False, 1e-4), (8, False, 0.0),
                (4, True, 0.0))   # tests/test_oracle_parity.py:27-28
EXACT_STEADY_BLOCKS = 3       # the exact scan: 1 warm-up + 3 blocks
# BASELINE configs 1 and 2 (config 3 is CFG3): eval/baseline_configs.py.
CFG1 = dict(sps=8, num_avg=100, constellation_size=2, phase_avg=50)
CFG2 = dict(sps=10, num_avg=50, constellation_size=4, phase_avg=50)
REGISTRY_STREAMS = 64         # BASELINE config 4's channel count
NAN_AT, INF_AT = (5, 2), (77, 6)   # phase 17's (channel, block) plantings


def decisive_signal(nsym: int, sps: int, m: int, peak: int, seed: int,
                    diff: bool = False, foff: float = 0.0) -> np.ndarray:
    """tests/test_oracle_parity.py:13-23: PSK with all energy on sample
    ``peak`` of each symbol, a frequency offset, real noise of std 0.02."""
    rng = np.random.default_rng(seed)
    j = rng.integers(0, m, nsym)
    pts = np.exp(2j * np.pi * j / m)
    if diff:
        pts = np.cumprod(pts)
    x = np.zeros(nsym * sps, np.complex64)
    x[peak::sps] = pts * np.exp(2j * np.pi * foff * sps * np.arange(nsym))
    x += (0.02 * rng.standard_normal(x.size)).astype(np.complex64)
    return x


def golden_phase(torch, dev, card) -> dict:
    """Phase 16: the reference's golden vectors on the card.  The port's
    gen_psk (1000 symbols, sps 8, num_avg 100, phase_avg 50) through
    make_demod_fn(cfg) with the carry on the card, M in {2, 4, 8},
    differential and not (tests/test_golden.py's six scenarios): 901 valid
    outputs; the largest soft error against the transmitted symbols under
    1e-3 (modulo the M rotations when not differential, symbol 0 left out
    when differential); bits exact where the rotation is known
    (differential).  Then the port's demod_reference on
    tests/test_oracle_parity.py's decisive signals against the card's
    exact scan: sample index equal, soft and phase within 2e-3."""
    from psk_soft_tpu_torch import DemodConfig, demod_init, make_demod_fn
    from psk_soft_tpu_torch.testing.oracle import demod_reference
    from psk_soft_tpu_torch.testing.signals import gen_psk

    golden = {}
    for m in (2, 4, 8):
        for diff in (False, True):
            cfg = DemodConfig(sps=8, num_avg=100, constellation_size=m,
                              phase_avg=50, differential=diff)
            x, syms = gen_psk(GOLDEN_NSYM, 8, m, differential=diff)
            st = demod_init(cfg, device=dev)
            t0 = time.perf_counter()
            st, out = make_demod_fn(cfg)(st, x)
            valid = out.valid.cpu().numpy()
            host_s = time.perf_counter() - t0
            on = torch.device(dev).type
            if out.soft.device.type != on or st.ring.device.type != on:
                raise AssertionError("golden: the scan left the card")
            soft = out.soft.cpu().numpy()[valid]
            bits = out.bits.cpu().numpy()[valid]
            n = soft.shape[0]
            if n != GOLDEN_NSYM - (cfg.num_avg - 1):
                raise AssertionError(f"golden M{m} diff {diff}: {n} valid")
            exp = syms[:n]
            if diff:
                rot = np.exp(1j * np.pi / 4) if m == 4 else 1.0
                err = float(np.abs(soft[1:] - exp[1:] * rot).max())
                j = np.round(np.angle(exp) / (2 * np.pi / m)).astype(
                    int) % m
                if m == 2:
                    want = j[:, None]
                elif m == 4:
                    ang = 2 * np.pi * j / 4 + np.pi / 4
                    si = (np.sin(ang) < 0).astype(int)
                    want = np.stack([(np.cos(ang) < 0).astype(int) ^ si,
                                     si], axis=1)
                else:
                    want = np.stack([(j >> k) & 1 for k in range(3)], 1)
                nb = cfg.bits_per_symbol
                if not np.array_equal(bits[1:, :nb], want[1:, :nb]):
                    raise AssertionError(f"golden M{m} differential: bits")
            else:
                thetas = [k * 2 * np.pi / m + (np.pi / 4 if m == 4 else 0)
                          for k in range(m)]
                err = min(float(np.abs(soft[1:] * np.exp(1j * t)
                                       - exp[1:]).max()) for t in thetas)
            if not err < GOLDEN_TOL:
                raise AssertionError(f"golden M{m} diff {diff}: soft "
                                     f"error {err}")
            golden[f"M{m}{'d' if diff else ''}"] = dict(
                valid=int(n), soft_max_err=err, host_s=host_s)
    oracle = {}
    for m, diff, foff in ORACLE_CASES:
        x = decisive_signal(300, 8, m, peak=5, seed=m, diff=diff, foff=foff)
        ref = demod_reference(x, 8, 30, m, 15, differential=diff)
        cfg = DemodConfig(sps=8, num_avg=30, constellation_size=m,
                          phase_avg=15, differential=diff)
        _, out = make_demod_fn(cfg)(demod_init(cfg, device=dev), x)
        v = out.valid.cpu().numpy()
        idx = out.sample_index.cpu().numpy()[v]
        if v.sum() != ref["soft"].size or not np.array_equal(
                idx, ref["sample_index"]):
            raise AssertionError(f"oracle M{m}: {v.sum()} outputs vs "
                                 f"{ref['soft'].size}, or indices differ")
        errs = dict(soft=float(np.abs(out.soft.cpu().numpy()[v]
                                      - ref["soft"]).max()),
                    phase=float(np.abs(out.phase.cpu().numpy()[v]
                                       - ref["phase"]).max()))
        if max(errs.values()) > PHASE_TOL:
            raise AssertionError(f"oracle M{m} diff {diff}: {errs}")
        oracle[f"M{m}{'d' if diff else ''}_f{foff}"] = errs
    log(json.dumps({"phase": "golden", "scenarios": golden,
                    "oracle_vs_card": oracle, "card": card}))
    return {"golden_max_err": max(g["soft_max_err"]
                                  for g in golden.values()),
            "oracle_max_err": max(max(e.values()) for e in oracle.values())}


def bank_drive(eng, x: np.ndarray, n_blocks: int, tail: bool) -> list:
    """Push (C, T) samples channel by channel into a BatchEngine, one
    block at a time, step_packets after each; then the rest and
    flush_packets when ``tail``."""
    need = eng.block_symbols * eng.cfg.sps
    pkts = []
    for b in range(n_blocks):
        for c in range(eng.channels):
            eng.push(c, x[c, b * need:(b + 1) * need])
        pkts.append(eng.step_packets())
    if tail:
        for c in range(eng.channels):
            eng.push(c, x[c, n_blocks * need:])
        pkts.append(eng.flush_packets())
    return pkts


def batch_engine_phase(torch, dev, card) -> dict:
    """Phase 17: BatchEngine at the engine cell's widths (1024 channels x
    512 symbols, sps 8, QPSK, num_avg 100, phase_avg 50) on the card
    against the same engine on the CPU for the first CPU_C channels
    (compare_service; channel_resyncs equal).  Pipeline "ff": 1 warm-up +
    STEADY_BLOCKS blocks and a flush, guard_nonfinite with NaN and +inf
    planted in two channels (NAN_AT, INF_AT).  Pipeline
    "exact": 1 + EXACT_STEADY_BLOCKS blocks.  Then the exact scan's ms per
    block (CUDA events and the host clock) with one profiled pass (device
    busy share, operations a block), and the ff engine's samples/s at
    pipeline depth 0 and 1."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models.psk import demod_block
    from psk_soft_tpu_torch.runtime.engine import BatchEngine
    from psk_soft_tpu_torch.runtime.streams import SRI

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    need = S * SPS
    n_blocks = 1 + STEADY_BLOCKS
    x = channels(n_blocks * S + S // 2, n_ch=C)
    poisoned = x.copy()
    poisoned[NAN_AT[0], NAN_AT[1] * need + 100:
             NAN_AT[1] * need + 120] = np.nan
    poisoned[INF_AT[0], INF_AT[1] * need + 400] = np.inf

    def run(device, width, pipeline, data, blocks, tail, **kw):
        eng = BatchEngine(cfg, width, block_symbols=S, pipeline=pipeline,
                          device=device, **kw)
        eng.set_input_sri(SRI(stream_id="bank", xdelta=1e-6), t=1.0)
        return bank_drive(eng, data[:width], blocks, tail), eng

    out = {}
    for pipeline, data, blocks, tail, kw in (
            ("ff", poisoned, n_blocks, True, dict(guard_nonfinite=True)),
            ("exact", x, 1 + EXACT_STEADY_BLOCKS, False, {})):
        t0 = time.perf_counter()
        gpu_pkts, gpu = run(dev, C, pipeline, data, blocks, tail, **kw)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        cpu_pkts, cpu = run("cpu", CPU_C, pipeline, data, blocks, tail, **kw)
        err = compare_service(gpu_pkts, cpu_pkts, f"BatchEngine "
                              f"{pipeline}", rows=CPU_C)
        resyncs = gpu.channel_resyncs
        if not np.array_equal(resyncs[:CPU_C], cpu.channel_resyncs) \
                or (pipeline == "ff" and {int(c): int(resyncs[c]) for c in
                                          np.flatnonzero(resyncs)}
                    != {NAN_AT[0]: 1, INF_AT[0]: 1}):
            raise AssertionError(f"{pipeline}: channel_resyncs "
                                 f"{np.flatnonzero(resyncs)}")
        expect = blocks * S - (NUM_AVG - 1) + (S // 2 if tail else 0)
        soft = np.concatenate([p["softDecision_dataFloat_out"].data
                               for p in gpu_pkts if p], axis=1)
        # A resynced channel warms up again: num_avg - 1 fewer outputs.
        lost = (NUM_AVG - 1) * int(resyncs.sum())
        if soft.shape != (C, expect) or gpu.metrics.symbols_out \
                != C * expect - lost:
            raise AssertionError(f"{pipeline}: soft {soft.shape}, "
                                 f"expected {expect} symbols")
        healthy = np.isfinite(soft).all(axis=1)
        out[pipeline] = dict(blocks=blocks, flush=tail, symbols=expect,
                             max_err_vs_cpu=err, seconds=gpu_s,
                             nonfinite_channels=np.flatnonzero(
                                 ~healthy).tolist())
        if pipeline == "exact":
            state = gpu._state
    log(json.dumps({"phase": "batch_engine", "channels": C,
                    "cpu_channels": CPU_C, "runs": out,
                    "channel_resyncs": {str(NAN_AT[0]): 1,
                                        str(INF_AT[0]): 1}, "card": card}))

    # The exact scan's block time: demod_block on the card from the warm
    # carry, three blocks, CUDA events and the host clock (dispatch alone,
    # and until the card is done).
    xb = [torch.from_numpy(x[:, b * need:(b + 1) * need]).to(dev)
          for b in range(EXACT_STEADY_BLOCKS)]
    demod_block(cfg, state, xb[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for blk in xb:
        state, _ = demod_block(cfg, state, blk)
    stop.record()
    t_dispatch = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    n = len(xb)
    exact_times = dict(event_ms=start.elapsed_time(stop) / n,
                       host_ms=t_host * 1e3 / n,
                       host_dispatch_ms=t_dispatch * 1e3 / n)
    log(json.dumps({"phase": "timing", "what": "exact scan block "
                    "(models/psk.demod_block)", "channels": C,
                    "symbols": S, "sps": SPS, "blocks": n, **exact_times,
                    "samples_per_s": need * C / (exact_times["host_ms"]
                                                 * 1e-3),
                    "card": card}))

    def exact_feed(b):
        nonlocal state
        state, _ = demod_block(cfg, state, xb[b % n])

    profile_engine(exact_feed, card, what="exact scan block", blocks=2)

    # The ff BatchEngine end to end (pushes, step, fetch and assembly).
    ff_times = {}
    for depth in (0, 1):
        eng = BatchEngine(cfg, C, block_symbols=S, pipeline_depth=depth,
                          device=dev)
        eng.set_input_sri(SRI(stream_id="bank", xdelta=1e-6))
        bank_drive(eng, x, 3, False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(STEADY_BLOCKS):
            for c in range(C):
                eng.push(c, x[c, (b % n_blocks) * need:
                              (b % n_blocks + 1) * need])
            eng.step_packets()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ff_times[depth] = STEADY_BLOCKS * need * C / dt
        log(json.dumps({"phase": "timing", "what": "BatchEngine ff end to "
                        "end", "pipeline_depth": depth, "channels": C,
                        "blocks": STEADY_BLOCKS, "seconds": dt,
                        "samples_per_s": ff_times[depth], "card": card}))
    return dict(exact=exact_times, ff_samples_per_s=ff_times)


def service_script(x: np.ndarray) -> list:
    """One stream's packets of the phase-18 script: 26 packets from t = 0,
    xdelta 1e-3, the rate doubled from packet 5 (times follow it),
    configure phase_avg 50 -> 40 before packet 8 and M 4 -> 8 before packet
    15, packet 10 flagged as after a queue flush, a real-mode packet before
    packet 12, and EOS on the last (a partial block and a tail shorter
    than sps when x ends so)."""
    steps, t, xd = [], 0.0, 1e-3
    size = -(-x.size // 26)
    for k, i in enumerate(range(0, x.size, size)):
        if k == 5:
            xd = 2e-3
        if k == 8:
            steps.append(("configure", dict(phase_avg=40)))
        if k == 12:
            steps.append(dict(data=np.ones(800, np.complex64), t=t, xd=xd,
                              mode=0))
        if k == 15:
            steps.append(("configure", dict(phase_avg=40,
                                            constellation_size=8)))
        seg = x[i:i + size]
        steps.append(dict(data=seg, t=t, xd=xd, flushed=k == 10,
                          eos=i + size >= x.size))
        t += seg.size * xd
    return steps


def service_phase(torch, dev, card) -> dict:
    """Phase 18: StreamEngine and StreamRegistry on the card against a CPU
    run.  One stream of 20 blocks of 512 symbols (sps 8, QPSK, num_avg
    100, phase_avg 50) through each pipeline with service_script's events
    (rate change, two configures, queue flush, real-mode packet, EOS with
    a partial block); then REGISTRY_STREAMS interleaved streams at config
    4's widths through StreamRegistry (ff).  Packets, SRIs, timestamps,
    metrics and port_stats counts equal the CPU run's (compare_service).
    Then one stream's samples/s in each pipeline."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.runtime.engine import (StreamEngine,
                                                   StreamRegistry)
    from psk_soft_tpu_torch.runtime.streams import SRI, Packet

    kw0 = dict(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
               phase_avg=PHASE_AVG)
    x = channels(20 * S, n_ch=1)[0][:20 * S * SPS - S * SPS // 2 - 3]
    script = service_script(x)

    def run_stream(device, pipeline):
        eng = StreamEngine(DemodConfig(**kw0), S, pipeline, device=device)
        outs = []
        for st in script:
            if isinstance(st, tuple):
                eng.configure(DemodConfig(**dict(kw0, **st[1])))
                continue
            sri = SRI(stream_id="one", xdelta=st["xd"],
                      mode=st.get("mode", 1))
            outs.append(eng.process(Packet(
                data=st["data"], sri=sri, t=st["t"],
                eos=st.get("eos", False),
                input_queue_flushed=st.get("flushed", False))))
        return outs, eng

    def stats(eng):
        return {p: (s.packets, s.items, s.bytes, s.eos_count, s.last_t)
                for p, s in eng.port_stats.items()}

    res = {}
    for pipeline in ("ff", "exact"):
        g, ge = run_stream(dev, pipeline)
        c, ce = run_stream("cpu", pipeline)
        err = compare_service(g, c, f"StreamEngine {pipeline}")
        if dataclasses.asdict(ge.metrics) != dataclasses.asdict(ce.metrics) \
                or stats(ge) != stats(ce) or ge.metrics.reconfigures != 2 \
                or ge.metrics.real_mode_drops != 1 \
                or ge.metrics.resets != 1 or not all(
                    p.eos for p in g[-1].values()):
            raise AssertionError(f"StreamEngine {pipeline}: metrics "
                                 f"{ge.metrics} vs {ce.metrics}")
        res[pipeline] = dict(max_err_vs_cpu=err,
                             metrics=dataclasses.asdict(ge.metrics))

    cfg4 = DemodConfig(**CFG4)
    xs = channels(2 * S + S // 2 + 7, n_ch=REGISTRY_STREAMS)
    order = []
    for i in range(0, xs.shape[1], 1024):
        for s in range(REGISTRY_STREAMS):
            order.append((f"s{s}", xs[s, i:i + 1024], i * 1e-6,
                          i + 1024 >= xs.shape[1]))

    def run_registry(device):
        reg = StreamRegistry(cfg4, S, "ff", device=device)
        outs = [reg.process(Packet(data=d, sri=SRI(stream_id=sid,
                                                   xdelta=1e-6),
                                   t=t, eos=eos))
                for sid, d, t, eos in order]
        return outs, reg

    g, greg = run_registry(dev)
    c, _ = run_registry("cpu")
    reg_err = compare_service(g, c, "StreamRegistry")
    if greg.engines:
        raise AssertionError("StreamRegistry: streams left after EOS")
    res["registry"] = dict(streams=REGISTRY_STREAMS, outputs=len(g),
                           max_err_vs_cpu=reg_err)
    log(json.dumps({"phase": "stream_engine", "symbols": x.size // SPS,
                    **res, "card": card}))

    rates = {}
    for pipeline in ("ff", "exact"):
        eng = StreamEngine(DemodConfig(**kw0), S, pipeline, device=dev)
        sri = SRI(stream_id="rate", xdelta=1e-6)
        blocks = [x[b * S * SPS:(b + 1) * S * SPS] for b in range(12)]
        for blk in blocks[:2]:
            eng.process(Packet(data=blk, sri=sri))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk in blocks[2:]:
            eng.process(Packet(data=blk, sri=sri))
        dt = time.perf_counter() - t0
        rates[pipeline] = 10 * S * SPS / dt
        log(json.dumps({"phase": "timing", "what": "StreamEngine one "
                        "stream", "pipeline": pipeline, "blocks": 10,
                        "seconds": dt, "samples_per_s": rates[pipeline],
                        "card": card}))
    return dict(stream_samples_per_s=rates)


def group_phase(torch, dev, card) -> dict:
    """Phase 19: GroupEngine over BASELINE configs 1, 2 and 3 (channel c
    takes config c % 3), 1024 channels in all, on the card against a CPU
    run of the first CPU_C channels: 4 blocks of 512 symbols through
    step_all_packets with a partition-preserving configure (config 1
    phase_avg 50 -> 40, config 2 num_avg 50 -> 40, config 3 phase_avg 40
    -> 30) before the third, then the rest through flush_all_packets; a
    configure that would split a group raises and changes nothing."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.runtime.engine import GroupEngine
    from psk_soft_tpu_torch.runtime.streams import SRI

    kws = (CFG1, CFG2, CFG3)
    news = (dict(CFG1, phase_avg=40), dict(CFG2, num_avg=40),
            dict(CFG3, phase_avg=30))
    members = [list(range(g, C, 3)) for g in range(3)]
    n_sym = 4 * S + S // 2
    sigs = {}
    for g, ch in enumerate(members):
        kw = kws[g]
        bank = (shaped_channels(n_sym, 8, n_ch=len(ch)) if g == 2 else
                channels(n_sym, m=kw["constellation_size"], n_ch=len(ch),
                         sps=kw["sps"]))
        for slot, c in enumerate(ch):
            sigs[c] = bank[slot]

    def run(device, width):
        ge = GroupEngine([DemodConfig(**kws[c % 3]) for c in range(width)],
                         block_symbols=S, device=device)
        ge.set_input_sri(SRI(stream_id="group", xdelta=1e-6), t=3.0)
        outs = []
        for b in range(4):
            if b == 2:
                ge.configure([DemodConfig(**news[c % 3])
                              for c in range(width)])
            for c in range(width):
                n = S * kws[c % 3]["sps"]
                ge.push(c, sigs[c][b * n:(b + 1) * n])
            outs.append(ge.step_all_packets())
        split = [DemodConfig(**news[c % 3]) for c in range(width)]
        split[3] = DemodConfig(**CFG1)
        try:
            ge.configure(split)
        except ValueError as e:
            if "splits group 0" not in str(e):
                raise
        else:
            raise AssertionError("a splitting configure did not raise")
        if [g[0] for g in ge.groups] != [DemodConfig(**k) for k in news]:
            raise AssertionError("the refused configure changed a group")
        for c in range(width):
            n = S * kws[c % 3]["sps"]
            ge.push(c, sigs[c][4 * n:])
        outs.append(ge.flush_all_packets())
        return outs, ge

    t0 = time.perf_counter()
    g_outs, gge = run(dev, C)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    c_outs, cge = run("cpu", CPU_C)
    err = {"soft": 0.0, "phase": 0.0}
    for gi in range(3):
        k = len(cge.groups[gi][1])
        e = compare_service([o.get(gi) for o in g_outs],
                            [o.get(gi) for o in c_outs], f"group {gi}",
                            rows=k)
        err = {key: max(err[key], e[key]) for key in err}
    symbols = {}
    for gi, (cfg, mem, eng) in enumerate(gge.groups):
        soft = np.concatenate([o[gi]["softDecision_dataFloat_out"].data
                               for o in g_outs if o.get(gi)], axis=1)
        if soft.shape[0] != len(mem) or not np.isfinite(soft).all():
            raise AssertionError(f"group {gi}: soft {soft.shape}")
        symbols[gi] = soft.shape[1]
    ps = gge.port_stats
    if ps["softDecision_dataFloat_out"].eos_count != 3:
        raise AssertionError(f"group port_stats: {ps}")
    log(json.dumps({"phase": "group_engine", "channels": C,
                    "cpu_channels": CPU_C,
                    "groups": [len(m) for m in members],
                    "symbols_per_group": symbols, "max_err_vs_cpu": err,
                    "split_configure_raised": True, "seconds": gpu_s,
                    "card": card}))
    return err


# --- phases 20-22: the per-stage bit layer (ROADMAP A.7) -------------------

STREAM_DEPTH = 70             # phase 20's traceback window (10 K at K7)
STREAM_BLOCKS = 6             # its 512-step blocks
STREAM_SIDE_ROWS = 256        # rows of its other cases (K9, punctured, ...)
STREAM_SIGMA = 0.5            # LLR noise: decodes cleanly, ties rare
PAR_STEPS = 8192              # phase 21: steps a row, ...
PAR_MARGIN = 70               # ... the windows' margin
RX_WARM_BLOCKS = 1            # phase 22: warm-up blocks before the kernel
RX_FRAME_TOL = SOFT_TOL       # frame corr, card vs CPU (B1's soft bound)
STAGE_TOL = 1e-5              # frame soft/corr, stage on card vs on CPU


def stream_steps(code, rows: int, steps: int, seed: int):
    """Random bits through ``code`` (not terminated) as noisy LLRs: the
    (rows, L) wire and its (rows, steps, n) depunctured steps (numpy),
    and the bits."""
    import torch
    from psk_soft_tpu_torch.ops import fec

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (rows, steps)).astype(np.int8)
    coded = fec.conv_encode(code, bits, terminate=False).numpy()
    wire = ((1.0 - 2.0 * coded) + STREAM_SIGMA * rng.standard_normal(
        coded.shape)).astype(np.float32)
    full = fec.depuncture(code, torch.from_numpy(wire)).numpy()
    return wire, full.reshape(rows, steps, code.n), bits


def run_stream(fec, code, steps, depth: int, blocks: int, device,
               known_start: bool = True, states: bool = False):
    """The streaming decoder over ``blocks`` equal blocks of the (rows, T,
    n) steps tensor and a flush: (list of each block's bits and the
    flush's, list of the carries after each block)."""
    import torch

    rows, t = steps.shape[0], steps.shape[1] // blocks
    st = fec.viterbi_stream_init(code, rows, depth, known_start,
                                 device=device)
    outs, carries = [], []
    for b in range(blocks):
        st, bits = fec.viterbi_stream_step(
            code, st, steps[:, b * t:(b + 1) * t])
        outs.append(bits)
        if states:
            carries.append(st)
    outs.append(fec.viterbi_stream_flush(code, st))
    torch.cuda.synchronize()
    return outs, carries or [st]


def stream_equal(label: str, got, ref) -> float:
    """Card stream run against the CPU run: each block's bits and the
    flush equal, each carry's window equal and metrics within PM_TOL with
    NaN equal.  Returns the metrics' largest error."""
    import torch

    (g_out, g_st), (r_out, r_st) = got, ref
    for i, (a, b) in enumerate(zip(g_out, r_out)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{label}: bits of output {i} differ at "
                                 f"{int((a.cpu() != b).sum())}")
    err = 0.0
    for i, (a, b) in enumerate(zip(g_st, r_st)):
        if not torch.equal(a.dec.cpu(), b.dec):
            raise AssertionError(f"{label}: decision window {i} differs")
        err = max(err, finite_err(a.pm.cpu(), b.pm))
    if err > PM_TOL:
        raise AssertionError(f"{label}: metrics differ by {err}")
    return err


def coded_qpsk(bits_per_row: int, n_ch: int, seed: int):
    """A continuous K7-coded, Gray-mapped QPSK stream per channel (the
    phase-7 waveform: one impulse per symbol, rotated 0.4 rad, noise
    0.01): ((T, C) re, im planes, (C, n) sent bits)."""
    from psk_soft_tpu_torch.ops import fec, slicers

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_ch, bits_per_row)).astype(np.int8)
    coded = fec.conv_encode(fec.CODE_K7, bits, terminate=False).numpy()
    labels = slicers.bit_labels(4, "gray").astype(np.int64)
    lut = np.zeros(4, np.int64)
    lut[labels[:, 0] + 2 * labels[:, 1]] = np.arange(4)
    idx = lut[coded[:, 0::2] + 2 * coded[:, 1::2]]
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)), SPS,
                  axis=1).astype(np.complex64)
    x += (0.01 * (rng.standard_normal(x.shape)
                  + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return (np.ascontiguousarray(x.real.T), np.ascontiguousarray(x.imag.T),
            bits)


def stream_fec_phase(torch, dev, card: str, event_ms) -> dict:
    """Phase 20: the streaming decoder on the card (B3 + B4 a block, B4
    for the flush) against the plain loops on the CPU, then
    StreamFecDecoder under build_receiver.  Returns the main path's
    launches and the kernels line's numbers for B3 and B4 at the
    streaming shape."""
    import tempfile

    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops import fec
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk
    from psk_soft_tpu_torch.runtime.receiver import build_receiver
    from psk_soft_tpu_torch.utils.build import BUILD_DIR
    from psk_soft_tpu_torch.utils.checkpoint import load_state, save_state

    code = fec.CODE_K7
    steps_total = STREAM_BLOCKS * S
    wire, steps, bits = stream_steps(code, C, steps_total, 20)
    on_card = torch.from_numpy(steps).to(dev)
    on_cpu = torch.from_numpy(steps)

    # --- the main path: 1024 streams, 6 blocks and a flush, counted ---
    vk.viterbi_acs.launches = vk.viterbi_traceback.launches = 0
    t0 = time.perf_counter()
    card_run = run_stream(fec, code, on_card, STREAM_DEPTH, STREAM_BLOCKS,
                          dev, states=True)
    card_s = time.perf_counter() - t0
    launches = {"viterbi_acs": vk.viterbi_acs.launches,
                "viterbi_traceback": vk.viterbi_traceback.launches}
    if launches != {"viterbi_acs": STREAM_BLOCKS,
                    "viterbi_traceback": STREAM_BLOCKS + 1}:
        raise AssertionError(f"stream launches {launches}")
    t0 = time.perf_counter()
    cpu_run = run_stream(fec, code, on_cpu, STREAM_DEPTH, STREAM_BLOCKS,
                         "cpu", states=True)
    cpu_s = time.perf_counter() - t0
    pm_err = stream_equal("stream K7", card_run, cpu_run)
    got = torch.cat(card_run[0], dim=1)[:, STREAM_DEPTH:].cpu()
    one_shot = fec.viterbi_decode(code, torch.from_numpy(wire).to(dev),
                                  terminate=False).cpu()
    if not torch.equal(got, one_shot):
        raise AssertionError(f"stream vs one-shot: "
                             f"{int((got != one_shot).sum())} bits differ")
    bit_errors = int((got.numpy() != bits).sum())

    # --- known_start=False, punctured 2/3, K9 (256 rows, 2 blocks) ---
    side = {}
    p23 = fec.ConvCode(7, (0o171, 0o133), fec.PUNCTURE_2_3)
    for label, c, depth, known in (("unknown_start", code, STREAM_DEPTH,
                                    False),
                                   ("punctured_2_3", p23, 96, True),
                                   ("k9", fec.CODE_K9, 90, True)):
        _, st2, _ = stream_steps(c, STREAM_SIDE_ROWS, 2 * S, 21)
        t2 = torch.from_numpy(st2)
        side[label] = stream_equal(
            label, run_stream(fec, c, t2.to(dev), depth, 2, dev, known,
                              states=True),
            run_stream(fec, c, t2, depth, 2, "cpu", known, states=True))

    # --- a checkpoint saved mid-stream on the card, reloaded, continued ---
    half = STREAM_BLOCKS // 2
    st = card_run[1][half - 1]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        save_state(f"{tmp}/stream.npz", st, cfg)
        st, _, _ = load_state(f"{tmp}/stream.npz", dev)
    resumed = []
    for b in range(half, STREAM_BLOCKS):
        st, out = fec.viterbi_stream_step(code, st,
                                          on_card[:, b * S:(b + 1) * S])
        resumed.append(out)
    resumed.append(fec.viterbi_stream_flush(code, st))
    if not all(torch.equal(a, b) for a, b in zip(resumed,
                                                  card_run[0][half:])):
        raise AssertionError("stream checkpoint: continuation differs")
    log(json.dumps({"phase": "stream_fec", "rows": C, "blocks": STREAM_BLOCKS,
                    "steps_a_block": S, "depth": STREAM_DEPTH,
                    "launches": launches, "pm_max_err": pm_err,
                    "equal_to_cpu": True, "equal_to_one_shot_after_lag": True,
                    "bit_errors_vs_sent": bit_errors,
                    "side_cases_pm_err": side, "checkpoint_equal": True,
                    "card_s": card_s, "cpu_s": cpu_s, "card": card}))
    del on_card, card_run, cpu_run

    # --- StreamFecDecoder via build_receiver over the kernel-B1 bank ---
    n_blocks = 1 + 4
    re, im, _ = coded_qpsk(n_blocks * S + S // 2, C, 22)
    need = S * SPS

    def drive(device, width):
        rx = build_receiver(cfg, width, engine="full", block_symbols=S,
                            stream_fec=code, fec_labeling="gray",
                            device=device)
        for b in range(n_blocks):
            rx.engine.push_planes(re[b * need:(b + 1) * need, :width],
                                  im[b * need:(b + 1) * need, :width])
            rx.engine.step_packets()
        rx.engine.push_planes(re[n_blocks * need:, :width],
                              im[n_blocks * need:, :width])
        rx.engine.flush_packets()
        torch.cuda.synchronize()
        return rx.stream_fec.pop_bits(), rx.stream_fec.steps_decoded

    vk.viterbi_acs.launches = vk.viterbi_traceback.launches = 0
    g_bits, g_steps = drive(dev, C)
    rx_launches = {"viterbi_acs": vk.viterbi_acs.launches,
                   "viterbi_traceback": vk.viterbi_traceback.launches}
    c_bits, c_steps = drive("cpu", CPU_C)
    if (g_steps != c_steps or not np.array_equal(g_bits[:CPU_C], c_bits)
            or min(rx_launches.values()) < 1):
        raise AssertionError(f"StreamFecDecoder: steps {g_steps} vs "
                             f"{c_steps}, launches {rx_launches}")
    log(json.dumps({"phase": "stream_fec", "what": "build_receiver("
                    "stream_fec=CODE_K7) over FullKernelBatchEngine",
                    "channels": C, "cpu_channels": CPU_C,
                    "steps_decoded": g_steps, "launches": rx_launches,
                    "bits_equal_to_cpu": True, "card": card}))

    # --- B3 and B4 at the streaming shape, and the window re-layout ---
    st = fec.viterbi_stream_init(code, C, STREAM_DEPTH, device=dev)
    y = torch.from_numpy(steps[:, :S]).to(dev)
    st, _ = fec.viterbi_stream_step(code, st, y)
    llr_t = y.permute(2, 1, 0).contiguous()
    pm0 = st.pm.T.contiguous()
    exp = vk._signs_on(code, dev)
    kw = dict(k=code.k, s_count=code.states, n=code.n, t_actual=S)
    dec_new, pm2 = vk.viterbi_acs(llr_t, pm0, exp, **kw)
    full = torch.cat([st.dec.permute(0, 2, 1).to(torch.int8), dec_new])
    start = torch.argmax(pm2, dim=0).to(torch.int32)[None]
    tb = dict(k=code.k, s_count=code.states, t_actual=STREAM_DEPTH + S)

    def relayout():
        f = torch.cat([st.dec.permute(0, 2, 1).to(torch.int8), dec_new])
        return f[S:].permute(0, 2, 1).to(torch.bool).contiguous()

    acs_call = lambda: vk.viterbi_acs(llr_t, pm0, exp, **kw)  # noqa: E731
    tb_call = lambda: vk.viterbi_traceback(full, start, **tb)  # noqa: E731
    out = {}
    k_ms, p_ms = kernel_and_plain_ms(
        event_ms, acs_call, lambda: vk.viterbi_acs_ref(llr_t, pm0, exp, **kw))
    dev_ms = [kernel_device_ms(torch, acs_call, B3_KERNEL) for _ in range(2)]
    # B3 reads the LLRs, the metrics and the signs once and writes the
    # (T, S, B) decision plane and the metrics.
    out["viterbi_acs"] = dict(
        ms=min(k_ms), plain_ms=min(p_ms), max_abs_err=pm_err,
        ops=S * C * code.states * (4 * code.n + 3),
        bytes=(llr_t.nbytes + 2 * pm0.nbytes + exp.nbytes
               + S * code.states * C))
    log(json.dumps({"phase": "timing", "what": "viterbi_acs (B3) at the "
                    "streaming shape", "rows": C, "steps": S, "K": code.k,
                    "kernel_ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
                    "plan": vk.launch_plan(code.states, code.n, S, C,
                                           False)._asdict(), "card": card}))
    k_ms, p_ms = kernel_and_plain_ms(
        event_ms, tb_call, lambda: vk.viterbi_traceback_ref(full, start, **tb))
    dev_ms = [kernel_device_ms(torch, tb_call, B4_KERNEL) for _ in range(2)]
    t_tb = STREAM_DEPTH + S
    # The walk reads one decision byte per (step, row) and writes a bit
    # per (step, row): what this data needs, not the whole plane.
    out["viterbi_traceback"] = dict(
        ms=min(k_ms), plain_ms=min(p_ms), max_abs_err=0.0, ops=4 * t_tb * C,
        bytes=t_tb * C + start.nbytes + t_tb * C)
    relayout_ms = [event_ms(relayout, [()]) for _ in range(2)]
    log(json.dumps({"phase": "timing", "what": "viterbi_traceback (B4) at "
                    "the streaming shape", "rows": C, "steps": t_tb,
                    "K": code.k, "kernel_ms": k_ms, "device_ms": dev_ms,
                    "plain_ms": p_ms, "history_relayout_ms": relayout_ms,
                    "plan": vk.traceback_plan(code.states, C, t_tb)._asdict(),
                    "card": card}))
    step_ms = [event_ms(lambda: fec.viterbi_stream_step(code, st, y), [()])
               for _ in range(2)]
    log(json.dumps({"phase": "timing", "what": "viterbi_stream_step "
                    "(B3 + re-layout + B4) per 512-step block",
                    "rows": C, "ms": step_ms, "card": card}))
    return {"launches": launches, "kernels": out,
            "receiver_launches": rx_launches}


def parallel_decode_phase(torch, dev, card: str) -> dict:
    """Phase 21: viterbi_decode_parallel at 1024 rows x 8192 steps, chunk
    512 (16 windows a row, 16384 rows x 652 steps on B2) and chunk 2048
    (2188-step windows: B3 + B4), bits equal to the sequential B3 + B4
    decode on the card and to the CPU (first CPU_C rows).  Returns each
    chunk's launches."""
    from psk_soft_tpu_torch.ops import fec
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk

    code = fec.CODE_K7
    wire, _, bits = stream_steps(code, C, PAR_STEPS, 23)
    on_card = torch.from_numpy(wire).to(dev)
    seq = fec.viterbi_decode(code, on_card, terminate=False)
    out = {}
    for chunk in (S, 4 * S):
        for w in (vk.viterbi_fused, vk.viterbi_acs, vk.viterbi_traceback):
            w.launches = 0
        t0 = time.perf_counter()
        got = fec.viterbi_decode_parallel(code, on_card, chunk=chunk,
                                          margin=PAR_MARGIN)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in (
            vk.viterbi_fused, vk.viterbi_acs, vk.viterbi_traceback)}
        span = chunk + 2 * PAR_MARGIN
        fused = vk.fused_fits(code.states, span)
        if (launches["viterbi_fused"] if fused
                else min(launches["viterbi_acs"],
                         launches["viterbi_traceback"])) < 1:
            raise AssertionError(f"parallel chunk {chunk}: {launches}")
        cpu = fec.viterbi_decode_parallel(
            code, torch.from_numpy(wire[:CPU_C]), chunk=chunk,
            margin=PAR_MARGIN)
        if not torch.equal(got, seq) or not torch.equal(got[:CPU_C].cpu(),
                                                        cpu):
            raise AssertionError(f"parallel chunk {chunk}: bits differ from "
                                 f"the sequential decode or the CPU")
        log(json.dumps({"phase": "parallel_decode", "rows": C,
                        "steps": PAR_STEPS, "chunk": chunk,
                        "margin": PAR_MARGIN, "windows": C * -(-PAR_STEPS
                                                               // chunk),
                        "span": span, "route": "B2" if fused else "B3+B4",
                        "launches": launches, "card_s": card_s,
                        "bit_errors_vs_sent": int(
                            (got.cpu().numpy() != bits).sum()),
                        "equal_to_sequential": True, "equal_to_cpu": True,
                        "card": card}))
        out[chunk] = launches
    return out


FRAME_FIELDS = ("channel", "start", "rotation", "bits", "info_bits",
                "corrected", "crc_ok")


def frame_rows(frames, n_ch=None):
    """Sortable (channel, start, rotation, bits, info bits, corrected,
    crc_ok) rows of a frame list (channels below ``n_ch``)."""
    return sorted((f.channel, f.start, f.rotation, f.bits.tobytes(),
                   b"" if f.info_bits is None else f.info_bits.tobytes(),
                   f.corrected, f.crc_ok)
                  for f in frames if n_ch is None or f.channel < n_ch)


def frames_close(label: str, got, ref, tol: float, n_ch=None,
                 gate_soft: bool = True) -> dict:
    """Frame lists equal (channels below ``n_ch``) with correlation values
    and (``gate_soft``) soft payloads within ``tol``.  Returns the largest
    errors."""
    rows_g, rows_r = frame_rows(got, n_ch), frame_rows(ref, n_ch)
    if rows_g != rows_r:
        by_key = {r[:2]: r for r in rows_r}
        diffs = [(r[:2], [name for name, a, b
                          in zip(FRAME_FIELDS, r, by_key[r[:2]]) if a != b])
                 for r in rows_g if r[:2] in by_key and by_key[r[:2]] != r]
        raise AssertionError(
            f"{label}: frame lists differ: {len(rows_g)} vs {len(rows_r)} "
            f"frames, {len({r[:2] for r in rows_g} - set(by_key))} only in "
            f"the first, fields differing in {len(diffs)}: {diffs[:4]}")
    key = lambda f: (f.start, f.channel)  # noqa: E731
    a = sorted((f for f in got if n_ch is None or f.channel < n_ch), key=key)
    b = sorted(ref, key=key)
    err = {"soft": 0.0, "corr": 0.0}
    for fa, fb in zip(a, b):
        err["soft"] = max(err["soft"], float(np.abs(fa.soft - fb.soft).max()))
        err["corr"] = max(err["corr"], abs(fa.corr - fb.corr))
    if err["corr"] > tol or (gate_soft and err["soft"] > tol):
        raise AssertionError(f"{label}: {err} over {tol}")
    return err


def receiver_phase(torch, dev, card: str, profile, chain_rate) -> dict:
    """Phase 22: NativePlaneBank -> build_receiver(engine="full", UW 32,
    payload 64, K7 Gray, PRBS15 descrambling, CRC-16) at 1024 channels on
    the phase-7 cadence, payloads scrambled at the transmitter.  Every
    planted frame after the warm-up decodes once with the CRC green and
    exact info bits; the frames equal a 128-channel CPU run of the stack
    (corr within B1's soft bound; soft logged: near-tie timing picks), the
    frame-side stages replayed on the CPU from the card's tapped blocks
    (soft and corr within 1e-5),
    ChainEngine on the same stream (info bits through the keystream),
    and the runs at depth 1 and without data ports.  Then the stack's
    times.  Returns the main run's launches."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops import scramble
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
    from psk_soft_tpu_torch.ops.cuda import demod_kernel, viterbi_kernel
    from psk_soft_tpu_torch.ops.fec import CODE_K7
    from psk_soft_tpu_torch.ops.framesync import FrameFormat
    from psk_soft_tpu_torch.runtime import crc as rcrc
    from psk_soft_tpu_torch.runtime import framesync as rfs
    from psk_soft_tpu_torch.runtime import scramble as rsc
    from psk_soft_tpu_torch.runtime.chain_engine import ChainEngine
    from psk_soft_tpu_torch.runtime.fec import FecFrameDecoder
    from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
    from psk_soft_tpu_torch.runtime.receiver import build_receiver

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    rng = np.random.default_rng(12)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    lfsr = scramble.prbs15()
    starts, infos, x, n_info = plant_chain_stream(fmt, CODE_K7, CRC16_CCITT,
                                                  rng, lfsr=lfsr)
    n_msg = n_info - CRC16_CCITT.degree
    x_t = np.ascontiguousarray(x.T)               # (S*SPS, C) interleaved
    del x
    need = S * SPS
    n_blocks = 1 + STEADY_BLOCKS
    wrappers = {"demod_full_tm": demod_kernel.demod_full_tm,
                "viterbi_fused": viterbi_kernel.viterbi_fused,
                "viterbi_acs": viterbi_kernel.viterbi_acs,
                "viterbi_traceback": viterbi_kernel.viterbi_traceback}

    def stack(device, width, depth=0, data_ports=True):
        return build_receiver(
            cfg, width, engine="full", block_symbols=S, uw=fmt.uw,
            frame_payload=fmt.payload, uw_threshold=fmt.threshold,
            fec=CODE_K7, fec_labeling="gray", descramble=lfsr,
            crc=CRC16_CCITT, device=device,
            engine_kwargs=dict(pipeline_depth=depth, data_ports=data_ports))

    def drive(rx, width):
        block = x_t if width == C else np.ascontiguousarray(x_t[:, :width])
        bank = NativePlaneBank(width, capacity_samples=4 * need)
        frames = []
        for _ in range(n_blocks):
            bank.push_interleaved(block)
            re, im, _ = bank.pop_planes(need, timeout=0)
            rx.engine.push_planes(re, im)
            rx.engine.step_packets()
            frames += rx.pop_frames()
        rx.engine.flush_packets()
        frames += rx.pop_frames()
        torch.cuda.synchronize()
        bank.close()
        return frames

    # --- the main path on the card, counts read around it ---
    rx = stack(dev, C)
    captured = []
    tap = rx.syncer._observe_engine_out

    def capture(out):
        soft = rfs.engine_out_soft(out)
        if soft is not None:
            captured.append(soft[:CPU_C].cpu())
        tap(out)

    rx.syncer.engine.set_device_tap(capture)
    for w in wrappers.values():
        w.launches = 0
    with B1Gate("receiver") as gate:
        t0 = time.perf_counter()
        frames = drive(rx, C)
        card_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    if min(launches["demod_full_tm"], launches["viterbi_fused"]) \
            < STEADY_BLOCKS:
        raise AssertionError(f"receiver launches {launches}")

    # Every frame at a planted offset, once, CRC green, exact info bits;
    # every planted frame of the steady blocks present.
    must = required_frames(starts, C, S, n_blocks, fmt.frame_len,
                           NUM_AVG - 1)
    check_frames("receiver", frames, starts, infos, S, must)

    # --- the stack on the CPU, and its stages replayed on the CPU ---
    t0 = time.perf_counter()
    cpu_frames = drive(stack("cpu", CPU_C), CPU_C)
    cpu_s = time.perf_counter() - t0
    # The rectangular pulses of this waveform give every sample of a
    # symbol the same energy but for the noise, so B1 and its plain
    # version may pick another sample at a near tie (PERF.md): the frame
    # lists, bits and corr are held here, the soft payloads only by the
    # stage replay below.
    err_cpu = frames_close("receiver vs CPU", frames, cpu_frames,
                           RX_FRAME_TOL, CPU_C, gate_soft=False)
    sync = rfs.FrameSyncer(CPU_C, fmt, device="cpu")
    tail = rcrc.FrameCrcChecker(rsc.FrameDescrambler(
        FecFrameDecoder(sync, CODE_K7, labeling="gray", device="cpu"), lfsr,
        device="cpu"), CRC16_CCITT, device="cpu")
    replayed = []
    for soft in captured:
        sync.observe_device(soft)
        replayed += tail.pop_frames()
    sync.finalize()
    replayed += tail.pop_frames()
    err_stage = frames_close("receiver stages vs CPU", frames, replayed,
                             STAGE_TOL, CPU_C)

    # --- ChainEngine on the same stream: the same frames after the
    # warm-up block, info bits through the keystream (the chain does not
    # descramble, so its CRCs fail) ---
    chain = ChainEngine(cfg, C, fmt, CODE_K7, CRC16_CCITT, block_symbols=S,
                        device=dev)
    re_p = np.ascontiguousarray(x_t.real)
    im_p = np.ascontiguousarray(x_t.imag)
    for _ in range(n_blocks):
        chain.push_planes(re_p, im_p)
        chain.step()
    chain.flush()
    chain_frames = chain.pop_frames()
    ks = scramble.keystream(lfsr, n_info)[:n_msg].astype(np.int8)
    ours = {(f.channel, f.start): f for f in frames}
    for f in chain_frames:
        g = ours.get((f.channel, f.start))
        if g is None or not np.array_equal(f.info_bits ^ ks, g.info_bits):
            raise AssertionError(f"chain frame {(f.channel, f.start)} not "
                                 f"in the receiver's frames")
    chain_keys = {(f.channel, f.start) for f in chain_frames}
    extra = [k for k in ours if k not in chain_keys]
    if any(start >= S for _, start in extra):
        raise AssertionError("receiver frames past the warm-up block that "
                             "the chain lacks")

    # --- pipelined assembly and no data ports: the same frames ---
    variants = {}
    for depth, ports in ((1, True), (0, False), (1, False)):
        got = drive(stack(dev, C, depth, ports), C)
        variants[f"depth{depth}_ports{int(ports)}"] = len(got)
        if frame_rows(got) != frame_rows(frames):
            raise AssertionError(f"receiver depth {depth} data_ports "
                                 f"{ports}: frames differ")
    log(json.dumps({"phase": "receiver", "channels": C, "blocks": n_blocks,
                    "frames": len(frames), "frames_required": len(must),
                    "launches": launches, "b1_gate": gate.stats,
                    "max_err_vs_cpu": err_cpu,
                    "stage_max_err_vs_cpu": err_stage,
                    "chain_frames": len(chain_frames),
                    "warmup_block_frames_chain_drops": len(extra),
                    "variants_frames": variants, "card_s": card_s,
                    "cpu_s": cpu_s, "card": card}))

    # --- times: frames only (data_ports off), depth 0 and 1 ---
    for depth in (0, 1):
        rx = stack(dev, C, depth, False)
        bank = NativePlaneBank(C, capacity_samples=4 * need)
        eng, syncer, fec_stage = rx.syncer.engine, rx.syncer, rx.fec
        acc = dict.fromkeys(("bank", "engine", "sync_scan_fetch", "extract",
                             "viterbi_drain", "descramble_crc", "sync_total",
                             "pop_total"), 0.0)

        def timed(name, fn):
            def run(*a, **k):
                t = time.perf_counter()
                r = fn(*a, **k)
                acc[name] += time.perf_counter() - t
                return r
            return run

        saved = [(rfs, "detect_uw_sparse"), (rfs, "extract_heads"),
                 (rsc, "additive_scramble"), (rcrc, "check_crc")]
        saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
        rfs.detect_uw_sparse = timed("sync_scan_fetch", rfs.detect_uw_sparse)
        rfs.extract_heads = timed("extract", rfs.extract_heads)
        rsc.additive_scramble = timed("descramble_crc",
                                      rsc.additive_scramble)
        rcrc.check_crc = timed("descramble_crc", rcrc.check_crc)
        eng._step_core = timed("engine", eng._step_core)
        eng.set_device_tap(timed("sync_total", syncer._observe_engine_out))
        fec_stage.decode_payloads = timed("viterbi_drain",
                                          fec_stage.decode_payloads)
        pop = timed("pop_total", rx.pop_frames)

        def feed(_b):
            t = time.perf_counter()
            bank.push_interleaved(x_t)
            re, im, _ = bank.pop_planes(need, timeout=0)
            acc["bank"] += time.perf_counter() - t
            rx.engine.push_planes(re, im)
            rx.engine.step_packets()
            return pop()

        for b in range(3):                  # warm-up + hand-off + 1 steady
            feed(b)
        torch.cuda.synchronize()
        acc = dict.fromkeys(acc, 0.0)
        n_timed, decoded = 20, 0
        t0 = time.perf_counter()
        for b in range(n_timed):
            decoded += len(feed(3 + b))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        host = {k: v * 1e3 / n_timed for k, v in acc.items()}
        host["frame_assembly"] = (
            host["sync_total"] - host["sync_scan_fetch"] - host["extract"]
            + host["pop_total"] - host["viterbi_drain"]
            - host["descramble_crc"])
        rates = {"infobits_per_s": decoded * n_info / dt,
                 "samples_per_s": n_timed * need * C / dt}
        if depth == 0:
            rates0 = rates
        log(json.dumps({"phase": "timing", "what": "per-stage receiver end "
                        "to end (frames only)", "pipeline_depth": depth,
                        "blocks": n_timed, "frames": decoded,
                        "seconds": dt, **rates,
                        "chain_engine_infobits_per_s": chain_rate[depth],
                        "host_ms_per_block": host, "card": card}))
        if depth == 0:
            profile(feed, card, "per-stage receiver, depth 0",
                    watch={"demod_full_tm (B1)": "demod_",
                           "viterbi_fused (B2)": B2_KERNEL})
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        bank.close()
    return dict(launches=launches, b1_gate=gate.stats, rates=rates0)


def group_sync_phase(torch, dev, card: str) -> int:
    """Phase 22 (groups): GroupFrameSyncer over the config-4
    MixedKernelBatchEngine at 1024 channels (M per channel; differential
    off, so each UW sits in symbol space), uncoded UW-led frames at each
    channel's M: every frame at a planted offset with exact bits, every
    planted frame of the steady blocks found, and the frame list equal to
    a 128-channel CPU run.  Returns the frames found."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models.mixed import MixedParams
    from psk_soft_tpu_torch.ops import slicers
    from psk_soft_tpu_torch.ops.framesync import FrameFormat, psk_points
    from psk_soft_tpu_torch.runtime.engine_mixed import MixedKernelBatchEngine
    from psk_soft_tpu_torch.runtime.framesync import GroupFrameSyncer

    cfg = DemodConfig(**CFG4)
    ms, _ = mixed_modes(C)
    diffs = np.zeros(C, bool)
    rng = np.random.default_rng(24)
    fmts = {m: FrameFormat(uw=tuple(int(v) for v in rng.integers(0, m, 32)),
                           payload=48, m=int(m), threshold=0.7)
            for m in (2, 4, 8)}
    fl = fmts[2].frame_len
    starts = [(23 + j * (fl + 41)) % S for j in range(S // (fl + 41))]
    idx = rng.integers(0, 8, (C, S)) % ms[:, None]
    want = {}
    for c in range(C):
        fmt = fmts[int(ms[c])]
        nb = int(np.log2(fmt.m))
        for s0 in starts:
            cols = (s0 + np.arange(fl)) % S
            idx[c, cols[:fmt.uw_len]] = fmt.uw
            pay = idx[c, cols[fmt.uw_len:]]
            want[(c, s0)] = slicers.slice_bits(fmt.m, torch.from_numpy(
                psk_points(pay, fmt.m)))[..., :nb].reshape(-1).numpy()
    x = np.zeros((C, S * SPS), np.complex64)
    x[:, 2::SPS] = np.exp(2j * np.pi * idx / ms[:, None])
    x += (0.01 * rng.standard_normal(x.shape)).astype(np.complex64)
    re, im = np.ascontiguousarray(x.real.T), np.ascontiguousarray(x.imag.T)
    del x
    n_blocks = 1 + 4

    def drive(device, width):
        eng = MixedKernelBatchEngine(
            MixedParams.make(ms[:width], diffs[:width], device), cfg, width,
            block_symbols=S, device=device)
        top = GroupFrameSyncer(eng, [fmts[int(m)] for m in ms[:width]],
                               device=device)
        frames = []
        for _ in range(n_blocks):
            top.push_planes(re[:, :width].copy(), im[:, :width].copy())
            top.step_packets()
            frames += top.pop_frames()
        top.flush_packets()
        torch.cuda.synchronize()
        return frames + top.pop_frames()

    frames = drive(dev, C)
    for f in frames:
        key = (f.channel, f.start % S)
        if key not in want or not np.array_equal(f.bits, want[key]):
            raise AssertionError(f"group frame {(f.channel, f.start)}: "
                                 f"unplanted or bits wrong")
    got = {(f.channel, f.start) for f in frames}
    a1 = cfg.num_avg - 1
    must = {(c, b * S + s0) for b in range(1, n_blocks) for s0 in starts
            for c in range(C) if b * S + s0 + fl <= n_blocks * S - a1}
    if len(got) != len(frames) or not must <= got:
        raise AssertionError(f"group: {len(must - got)} planted frames "
                             f"missed")
    err = frames_close("group vs CPU", frames, drive("cpu", CPU_C),
                       RX_FRAME_TOL, CPU_C)
    log(json.dumps({"phase": "group_sync", "channels": C,
                    "cpu_channels": CPU_C, "frames": len(frames),
                    "frames_required": len(must), "max_err_vs_cpu": err,
                    "card": card}))
    return len(frames)


# --- phase 23: the front-end receiver (ROADMAP A.8 part 1) ------------------

FRONT_SEED = 23
FRONT_LEVEL_DB = (-20.0, 10.0)      # per-channel input level
FRONT_ECHO = (1.0,) + (0.0,) * 7 + (0.5j,)   # tests/test_equalizer.py:156
FRONT_NOISE = (5, 77, 600, 1000)    # channels that carry noise only
# mu * samples a block = 0.1, the JAX live test's per-block step
# (mu 5e-5 over 2048 samples, tests/test_equalizer.py:170); 5e-5 over this
# phase's 4096-sample blocks left CRC failures every block in the CPU
# rehearsal (PERF.md).
FRONT_MU = 2.5e-5
FRONT_CONV_BLOCKS = 8               # blocks to converge (CPU rehearsal)
FRONT_STEADY = 10                   # steady blocks after convergence
# The bank's mean CMA cost, first block over last.  The 33-tap filter
# centred at tap 16 spans three terms of the echo's inverse, so the cost
# floors near 0.04 (8.5x down after 90 blocks in the rehearsal); the 15x of
# tests/test_equalizer.py:98 is for a channel a 15-tap filter inverts.
FRONT_CM_DROP = 5.0
FRONT_LOCK = 0.8
FRONT_CFO_TOL = 2e-4                # tests/test_autocfo.py:78
FRONT_GAIN_DB_TOL = 4.4e-4          # rtol 1e-4 on the power, test_agc.py:124
FRONT_W_TOL = 1e-5                  # tests/test_equalizer.py:77
FRONT_Q_RTOL = 1e-3                 # amp, power, lock: test_quality.py:52
FRONT_EVM_RTOL = 0.15               # tests/test_quality.py:43
FRONT_SNR_DB_TOL = 1.0              # tests/test_quality.py:35


def front_stream(fmt, code, crc, lfsr, rng, n_blocks: int):
    """Phase 22's S-periodic stream at C channels made harder, block by
    block (continuous across blocks): the one-symbol echo FRONT_ECHO, a
    carrier offset 0.018 + 0.006 c/C cycles/sample (phase 12's), a level
    per channel in FRONT_LEVEL_DB, and FRONT_NOISE carrying unit-power
    noise only.  Returns (starts, infos, n_info, freqs, [(T, C) complex64
    interleaved blocks])."""
    from psk_soft_tpu_torch.ops.equalizer import multipath

    starts, infos, x, n_info = plant_chain_stream(fmt, code, crc, rng,
                                                  lfsr=lfsr)
    freqs = 0.018 + 0.006 * np.arange(C) / C
    level = 10.0 ** (rng.uniform(*FRONT_LEVEL_DB, C) / 20.0)
    need = S * SPS
    prev = np.zeros((C, len(FRONT_ECHO) - 1), np.complex64)
    blocks = []
    for b in range(n_blocks):
        y = multipath(np.concatenate([prev, x], axis=1),
                      FRONT_ECHO)[:, prev.shape[1]:]
        prev = x[:, -prev.shape[1]:]
        t = np.arange(b * need, (b + 1) * need, dtype=np.float64)
        y = y * np.exp(2j * np.pi * freqs[:, None] * t[None, :])
        for c in FRONT_NOISE:
            y[c] = (rng.standard_normal(need)
                    + 1j * rng.standard_normal(need)) / np.sqrt(2.0)
        blocks.append(np.ascontiguousarray(
            (y * level[:, None]).T.astype(np.complex64)))
    return starts, infos, n_info, freqs, blocks


def front_stages(rx) -> dict:
    """The stages of build_receiver's front-end stack by name."""
    q = rx.quality
    agc = q.engine
    eq = agc.engine
    cfo = eq.engine
    return dict(quality=q, agc=agc, eq=eq, cfo=cfo, engine=cfo.engine)


def front_receiver_phase(torch, dev, card: str, profile, rx22: dict) -> dict:
    """Phase 23: NativePlaneBank -> planes uploaded once -> build_receiver(
    engine="full", agc, equalize=EqConfig(taps=33, mu=FRONT_MU),
    acquire_cfo, quality, UW 32, payload 64, K7 Gray, PRBS15, CRC-16) at
    1024 channels on front_stream, FRONT_CONV_BLOCKS + FRONT_STEADY blocks
    and a flush, every B1 launch held by B1Gate.  Every planted frame after
    convergence pops once, CRC green, exact info bits; CFOs within 2e-4 of
    the truth; the CMA cost down FRONT_CM_DROP x; lock > 0.8 on every
    planted channel and alarms() exactly FRONT_NOISE; against a
    128-channel CPU run: frame lists, bits and info bits equal, corr
    within B1's soft bound, CFOs, AGC gains, equalizer weights and quality
    EMAs within the FRONT_* tolerances.  Then its times beside phase 22's
    receiver.  Returns the main run's launches and numbers."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops import scramble
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
    from psk_soft_tpu_torch.ops.cuda import demod_kernel, viterbi_kernel
    from psk_soft_tpu_torch.ops.equalizer import EqConfig
    from psk_soft_tpu_torch.ops.fec import CODE_K7
    from psk_soft_tpu_torch.ops.framesync import FrameFormat
    from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
    from psk_soft_tpu_torch.runtime.receiver import build_receiver

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    rng = np.random.default_rng(FRONT_SEED)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    lfsr = scramble.prbs15()
    n_blocks = FRONT_CONV_BLOCKS + FRONT_STEADY
    starts, infos, n_info, freqs, blocks = front_stream(
        fmt, CODE_K7, CRC16_CCITT, lfsr, rng, n_blocks)
    need = S * SPS
    noise = np.zeros(C, bool)
    noise[list(FRONT_NOISE)] = True

    def upload(device, width):
        bank = NativePlaneBank(width, capacity_samples=4 * need)
        planes = []
        for blk in blocks:
            bank.push_interleaved(blk if width == C
                                  else np.ascontiguousarray(blk[:, :width]))
            re, im, flushed = bank.pop_planes(need, timeout=0)
            assert not flushed
            planes.append((torch.from_numpy(re).to(device),
                           torch.from_numpy(im).to(device)))
        bank.close()
        return planes

    def stack(device, width):
        return build_receiver(
            cfg, width, engine="full", block_symbols=S, agc=True,
            equalize=EqConfig(taps=33, mu=FRONT_MU), acquire_cfo=True,
            quality=True, uw=fmt.uw, frame_payload=fmt.payload,
            uw_threshold=fmt.threshold, fec=CODE_K7, fec_labeling="gray",
            descramble=lfsr, crc=CRC16_CCITT, device=device)

    def drive(rx, planes):
        st = front_stages(rx)
        frames, cm0, drains = [], None, [0]
        decode = rx.fec.decode_payloads

        def counted(payloads):
            drains[0] += 1
            return decode(payloads)

        rx.fec.decode_payloads = counted
        for re, im in planes:
            rx.engine.push_planes(re, im)
            while rx.engine.ready():
                rx.engine.step_packets()
            if cm0 is None:
                cm0 = st["eq"].cm_err
            frames += rx.pop_frames()
        rx.engine.flush_packets()
        frames += rx.pop_frames()
        torch.cuda.synchronize()
        return frames, cm0, drains[0]

    # --- the main path on the card, counts read around it ---
    planes = upload(dev, C)
    rx = stack(dev, C)
    wrappers = {"demod_full_tm": demod_kernel.demod_full_tm,
                "viterbi_fused": viterbi_kernel.viterbi_fused,
                "viterbi_acs": viterbi_kernel.viterbi_acs,
                "viterbi_traceback": viterbi_kernel.viterbi_traceback}
    for w in wrappers.values():
        w.launches = 0
    with B1Gate("front-end receiver", FRONT_NOISE) as gate:
        t0 = time.perf_counter()
        frames, cm0, drains = drive(rx, planes)
        card_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    st = front_stages(rx)
    steady = n_blocks - RX_WARM_BLOCKS
    if (launches["demod_full_tm"] != steady
            or launches["viterbi_fused"] != drains
            or launches["viterbi_acs"] or launches["viterbi_traceback"]):
        raise AssertionError(f"front-end receiver launches {launches}: "
                             f"want B1 {steady} (one a steady block), B2 "
                             f"{drains} (one a drain)")

    # Frames: at planted offsets (shifted by the equalizer's group delay,
    # one for all), once each; after convergence CRC green with exact info
    # bits, and every planted frame present.
    keys = [(f.channel, f.start) for f in frames]
    if len(set(keys)) != len(keys):
        raise AssertionError("front-end receiver: a frame was popped twice")
    if any(noise[f.channel] for f in frames):
        raise AssertionError("front-end receiver: a frame on a noise-only "
                             "channel")
    by_off = {s0: j for j, s0 in enumerate(starts)}
    def offset(start, s0):
        return (start - s0 + S // 2) % S - S // 2

    delays = {offset(f.start, s0) for f in frames if f.crc_ok
              for s0 in starts if abs(offset(f.start, s0)) <= 4}
    if len(delays) != 1:
        raise AssertionError(f"front-end receiver: frame delays {delays}")
    delay = delays.pop()
    conv = FRONT_CONV_BLOCKS * S
    late = [f for f in frames if f.start >= conv]
    for f in late:
        j = by_off.get((f.start - delay) % S)
        if (j is None or not f.crc_ok or f.suspect
                or not np.array_equal(f.info_bits, infos[f.channel, j])):
            raise AssertionError(f"front-end receiver frame "
                                 f"{(f.channel, f.start)}: CRC {f.crc_ok}")
    a1 = NUM_AVG - 1
    must = {(c, b * S + s0 + delay) for b in range(n_blocks) for s0 in starts
            for c in range(C) if not noise[c]
            and b * S + s0 + delay >= conv
            and b * S + s0 + delay + fmt.frame_len <= n_blocks * S - a1}
    if not must <= set(keys):
        raise AssertionError(f"front-end receiver: {len(must - set(keys))} "
                             f"planted frames missed")

    # Front ends: CFOs, the CMA cost's fall, lock and alarms.
    sig = ~noise
    cfo_err = float(np.abs(st["cfo"].cfo - freqs)[sig].max())
    cm1 = st["eq"].cm_err
    cm_drop = float(cm0[sig].mean() / cm1[sig].mean())
    snap = st["quality"].snapshot()
    alarms = np.nonzero(st["quality"].alarms())[0].tolist()
    lock_min = float(snap["lock"][sig].min())
    if (cfo_err > FRONT_CFO_TOL or cm_drop < FRONT_CM_DROP
            or lock_min <= FRONT_LOCK or alarms != sorted(FRONT_NOISE)):
        raise AssertionError(f"front ends: cfo error {cfo_err}, cm_err "
                             f"drop {cm_drop}, lock {lock_min}, alarms "
                             f"{alarms}")

    # --- the same stack on the CPU at 128 channels ---
    t0 = time.perf_counter()
    cpu_rx = stack("cpu", CPU_C)
    cpu_frames, _, _ = drive(cpu_rx, upload("cpu", CPU_C))
    cpu_s = time.perf_counter() - t0
    err_cpu = frames_close("front-end receiver vs CPU", frames, cpu_frames,
                           RX_FRAME_TOL, CPU_C, gate_soft=False)
    cst = front_stages(cpu_rx)
    csnap = cst["quality"].snapshot()
    w = slice(0, CPU_C)

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))

    front_err = {
        "cfo": float(np.abs(st["cfo"].cfo[w] - cst["cfo"].cfo).max()),
        "agc_gain_db": float(np.abs(st["agc"].gains_db[w]
                                    - cst["agc"].gains_db).max()),
        "eq_weights": float(np.abs(st["eq"].weights[w]
                                   - cst["eq"].weights).max()),
        "quality_rel": max(rel(snap[k][w], csnap[k])
                           for k in ("amp", "power", "lock")),
        "evm_rel": rel(snap["evm_pct"][w], csnap["evm_pct"]),
        "snr_db": float(np.abs(snap["snr_db"][w]
                               - csnap["snr_db"]).max()),
        "alarms_equal": bool(np.array_equal(
            st["quality"].alarms()[w], cst["quality"].alarms()))}
    log(json.dumps({"phase": "front_receiver_vs_cpu", **front_err,
                    "frames_soft_max_err": err_cpu["soft"],
                    "frames_corr_max_err": err_cpu["corr"]}))
    if (front_err["cfo"] > FRONT_CFO_TOL
            or front_err["agc_gain_db"] > FRONT_GAIN_DB_TOL
            or front_err["eq_weights"] > FRONT_W_TOL
            or front_err["quality_rel"] > FRONT_Q_RTOL
            or front_err["evm_rel"] > FRONT_EVM_RTOL
            or front_err["snr_db"] > FRONT_SNR_DB_TOL
            or not front_err["alarms_equal"]):
        raise AssertionError(f"front ends, card vs CPU: {front_err}")
    log(json.dumps({"phase": "front_receiver", "channels": C,
                    "blocks": n_blocks, "convergence_blocks":
                    FRONT_CONV_BLOCKS, "frames": len(frames),
                    "frames_after_convergence": len(late),
                    "frames_required": len(must), "frame_delay": delay,
                    "launches": launches, "drains": drains,
                    "b1_gate": gate.stats, "cfo_max_abs_err": cfo_err,
                    "cm_err_drop": cm_drop,
                    "cm_err_drop_worst_channel": float(
                        (cm0 / cm1)[sig].min()),
                    "cm_err_last_max": float(cm1[sig].max()),
                    "lock_min": lock_min, "alarms": alarms,
                    "snr_db_min": float(snap["snr_db"][sig].min()),
                    "evm_pct_max": float(snap["evm_pct"][sig].max()),
                    "max_err_vs_cpu": err_cpu, "card_s": card_s,
                    "cpu_s": cpu_s, "card": card}))

    # --- times at depth 0: the whole stack, host ms per front end ---
    rx = stack(dev, C)
    st = front_stages(rx)
    acc = dict.fromkeys(("agc", "eq", "cfo", "engine_push", "step",
                         "quality", "pop"), 0.0)

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            r = fn(*a, **k)
            acc[name] += time.perf_counter() - t
            return r
        return run

    st["agc"].push_planes = timed("agc", st["agc"].push_planes)
    st["eq"].push_planes = timed("eq", st["eq"].push_planes)
    st["cfo"].push_planes = timed("cfo", st["cfo"].push_planes)
    st["engine"].push_planes = timed("engine_push", st["engine"].push_planes)
    st["quality"].observe = timed("quality", st["quality"].observe)
    step = timed("step", rx.engine.step_packets)
    pop = timed("pop", rx.pop_frames)

    def feed(b):
        re, im = planes[b % len(planes)]
        rx.engine.push_planes(re, im)
        while rx.engine.ready():
            step()
        return pop()

    for b in range(3):
        feed(b)
    torch.cuda.synchronize()
    acc = dict.fromkeys(acc, 0.0)
    n_timed, decoded = 20, 0
    t0 = time.perf_counter()
    for b in range(n_timed):
        decoded += len(feed(3 + b))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    host = {k: v * 1e3 / n_timed for k, v in acc.items()}
    own = {"agc": host["agc"] - host["eq"], "eq": host["eq"] - host["cfo"],
           "cfo": host["cfo"] - host["engine_push"],
           "quality": host["quality"],
           "engine_push": host["engine_push"]}
    rates = {"infobits_per_s": decoded * n_info / dt,
             "samples_per_s": n_timed * need * C / dt}
    log(json.dumps({"phase": "timing", "what": "front-end receiver end to "
                    "end (data ports on: the quality tap reads soft)",
                    "pipeline_depth": 0, "blocks": n_timed,
                    "frames": decoded, "seconds": dt, **rates,
                    "receiver_without_front_ends": rx22["rates"],
                    "host_ms_per_block": host,
                    "front_end_own_host_ms_per_block": own, "card": card}))
    profile(feed, card, "front-end receiver, depth 0",
            watch={"demod_full_tm (B1)": "demod_",
                   "viterbi_fused (B2)": B2_KERNEL})
    return dict(launches=launches, b1_gate=gate.stats, rates=rates)


# --- phase 24: the input side (ROADMAP A.8 part 2) ---------------------------

IN_SEED = 24
WB_K = 8                      # the channelizer's taps per branch
WB_STEADY = 6                 # wideband: steady blocks after the warm-up
WB_SIGMA = 0.03               # noise floor of every channel (30 dB down)
WB_TOL = 2e-5                 # channelizer: tests/test_channelizer.py:42-43
WB_ORACLE_ROWS = 1024         # rows of a block held against the direct DDC
WB_ANGLE = 0.1                # QPSK angle error, 99th percentile, per
#                               occupied channel (tests/test_channelizer.py
#                               :223-226)
RS_STEADY = 4                 # resampler runs: steady blocks after warm-up
RS_TAPS = 8                   # ResamplerBank's taps_per_phase (default)
PROBE_T = 8192                # probe: channel-rate samples per channel
PROBE_SPS = (5.5, 6.25, 7.5, 8.0)    # rectangular pulses put a line at every
#   harmonic of the baud; the estimator folds back the 2nd and 3rd only,
#   so every planted sps keeps its 4th harmonic at or above Nyquist
PROBE_M = (2, 4, 8)
PROBE_SNR_DB = 20.0
PROBE_SPS_RTOL = 1e-3         # card vs CPU (tests/test_torch_probe.py)
PROBE_CFO_TOL = 1e-5
PROBE_CONF_RTOL = 1e-3
QUEUE_PACKETS = 64


def wideband_capture(rng, n_blocks: int, noise) -> list:
    """(S*SPS*C,) complex64 wideband blocks: raised-cosine QPSK at sps SPS
    on every channel but ``noise``, a noise floor WB_SIGMA on all, summed
    by the polyphase synthesis bank (one inverse FFT per channel-rate
    row, WB_K taps per branch), continuous across blocks."""
    from psk_soft_tpu_torch.ops.channelizer import prototype_taps
    from psk_soft_tpu_torch.testing.wideband import rc_psk, synthesize

    rows = S * SPS
    x, _ = rc_psk(np.full(C, float(SPS)), n_blocks * rows, 4, rng)
    x[list(noise)] = 0
    for part in (1, 1j):
        x += part * (WB_SIGMA / np.sqrt(2.0)) * rng.standard_normal(
            x.shape, dtype=np.float32)
    taps = prototype_taps(C, WB_K)
    blocks, carry = [], None
    for b in range(n_blocks):
        w, carry = synthesize(x[:, b * rows:(b + 1) * rows].T, taps, carry)
        blocks.append(w)
    return blocks


def wideband_phase(torch, dev, card: str, event_ms) -> dict:
    """Phase 24a: a wideband capture (C channels x WB_STEADY + 1 blocks of
    S symbols, 4 left empty) -> ChannelizerFrontEnd -> the planes on the
    card -> FullKernelBatchEngine, every B1 launch held by B1Gate.  The
    channelizer's card output within WB_TOL of the port's CPU run (all
    blocks) and of the direct DDC (8 channels of one block); B1 once a
    steady block; packets equal a CPU run (engine at CPU_C channels on the
    CPU front end's planes); every occupied channel's QPSK angle error
    after the warm-up under WB_ANGLE; one block of the 2x-oversampled bank
    within WB_TOL of its CPU run.  Then the channelizer's device ms a
    block beside its bound, the upload's ms and the path's samples/s."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops import channelizer as ch
    from psk_soft_tpu_torch.ops.cuda import demod_kernel
    from psk_soft_tpu_torch.runtime.channelizer import ChannelizerFrontEnd
    from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
    from psk_soft_tpu_torch.runtime.streams import PORT_SOFT, SRI

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    # The empty channels lie outside the first CPU_C, which the CPU run
    # compares.
    noise = tuple(CPU_C + (C - CPU_C) * k // 4 + 7 for k in range(4))
    rows = S * SPS
    t0 = time.perf_counter()
    blocks = wideband_capture(np.random.default_rng(IN_SEED), 1 + WB_STEADY,
                              noise)
    synth_s = time.perf_counter() - t0
    sri = SRI(stream_id="wideband", xdelta=1e-6)

    def drive(device, width, tap):
        fe = ChannelizerFrontEnd(C, taps_per_branch=WB_K, device=device)
        eng = FullKernelBatchEngine(cfg, width, block_symbols=S,
                                    device=device)
        eng.set_input_sri(sri)
        pkts = []
        for blk in blocks:
            fe.push(blk)
            re, im = fe.step_planes(rows)
            tap.append((re, im))
            if width != C:
                re, im = re[:, :width], im[:, :width]
            eng.push_planes(re, im)
            pkts.append(eng.step_packets())
        pkts.append(eng.flush_packets())
        return pkts

    # --- the main path on the card, B1's count read around it ---
    card_planes = []
    demod_kernel.demod_full_tm.launches = 0
    with B1Gate("wideband channelizer", noise) as gate:
        t0 = time.perf_counter()
        gpu = drive(dev, C, card_planes)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    launches = demod_kernel.demod_full_tm.launches
    if launches != WB_STEADY:
        raise AssertionError(f"wideband: B1 launched {launches} times for "
                             f"{WB_STEADY} steady blocks")
    for re, im in card_planes:
        if (re.device.type != torch.device(dev).type
                or re.dtype != torch.float32 or not re.is_contiguous()
                or not im.is_contiguous() or tuple(re.shape) != (rows, C)):
            raise AssertionError("wideband: the front end's planes are not "
                                 "contiguous float32 (rows, C) on the card")

    # --- the same stack on the CPU ---
    cpu_planes = []
    t0 = time.perf_counter()
    cpu = drive("cpu", CPU_C, cpu_planes)
    cpu_s = time.perf_counter() - t0
    ch_err = max(float(max((a.cpu() - b).abs().max() for a, b in zip(g, c)))
                 for g, c in zip(card_planes, cpu_planes))

    # Direct DDC of one block on a few channels (float64 on the host).
    chans = np.unique(np.r_[0, 1, 5, C // 3, C // 2, noise[0], C - 2, C - 1])
    L = WB_K * C
    xx = np.concatenate([blocks[0][-(WB_K - 1) * C:],
                         blocks[1][:(WB_ORACLE_ROWS + WB_K - 1) * C]])
    win = np.lib.stride_tricks.sliding_window_view(
        xx.astype(np.complex128), L)[::C][:WB_ORACLE_ROWS]
    taps = ch.prototype_taps(C, WB_K).astype(np.float64)
    want = win @ (taps[:, None] * np.exp(-2j * np.pi * np.outer(
        np.arange(L), chans) / C))
    re1, im1 = (p[:WB_ORACLE_ROWS, torch.from_numpy(chans).to(p.device)]
                .cpu().numpy() for p in card_planes[1])
    oracle_err = float(np.abs(re1 + 1j * im1 - want).max())
    if ch_err > WB_TOL or oracle_err > WB_TOL:
        raise AssertionError(f"channelizer: card vs CPU {ch_err}, vs the "
                             f"direct DDC {oracle_err} (bound {WB_TOL})")
    del win, want

    pkt_err = compare_service(gpu, cpu, "wideband engine vs CPU",
                              rows=CPU_C)
    occupied = np.ones(C, bool)
    occupied[list(noise)] = False
    soft = np.concatenate([p[PORT_SOFT].data for p in gpu[1:]
                           if p and p[PORT_SOFT].data.size], axis=1)
    ang = np.angle(soft[occupied] * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
    p99 = np.percentile(np.minimum(ang, np.pi / 2 - ang), 99, axis=1)
    if soft.shape != (C, WB_STEADY * S) or float(p99.max()) >= WB_ANGLE:
        raise AssertionError(f"wideband: soft {soft.shape}, worst channel's "
                             f"99th-percentile angle error {p99.max()}")

    # One block of the 2x-oversampled bank, card vs CPU.
    t_dev = torch.from_numpy(ch.prototype_taps(C, WB_K))
    os2 = []
    for device in (dev, "cpu"):
        _, y = ch.channelize_block_os2(
            t_dev.to(device), ch.channelizer_os2_init(C, WB_K, device),
            torch.from_numpy(blocks[1]).to(device))
        os2.append(y.cpu())
    os2_err = float((os2[0] - os2[1]).abs().max())
    if os2_err > WB_TOL or tuple(os2[0].shape) != (2 * rows, C):
        raise AssertionError(f"channelize_block_os2 card vs CPU: {os2_err}")
    del os2, card_planes, cpu_planes

    # --- times: the channelizer alone, the upload, the path end to end ---
    taps_d = t_dev.to(dev)
    carry_d = ch.channelizer_init(C, WB_K, dev)
    xs = [(torch.from_numpy(b).to(dev),) for b in blocks[:4]]
    chan_ms = event_ms(lambda x: ch.channelize_block(taps_d, carry_d, x), xs)
    up_ms = event_ms(lambda b: torch.from_numpy(b).to(dev),
                     [(b,) for b in blocks[:4]])
    del xs
    # Bound: the block and carry read once, the rows and carry written once;
    # K complex multiply-adds a sample plus a C-point FFT (5 C log2 C) a row.
    ch_bytes = (2 * rows * C + 2 * (WB_K - 1) * C) * 8 + WB_K * C * 4
    ch_ops = rows * C * 8 * WB_K + rows * 5 * C * np.log2(C)
    bound = {"bytes_ms": ch_bytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": ch_ops / FP32_OPS_PER_S * 1e3}

    fe = ChannelizerFrontEnd(C, taps_per_branch=WB_K, device=dev)
    eng = FullKernelBatchEngine(cfg, C, block_symbols=S, device=dev)
    eng.set_input_sri(sri)
    acc = dict(front_end=0.0, engine=0.0)

    def feed(b):
        t = time.perf_counter()
        fe.push(blocks[b % len(blocks)])
        planes = fe.step_planes(rows)
        acc["front_end"] += time.perf_counter() - t
        t = time.perf_counter()
        eng.push_planes(*planes)
        out = eng.step_packets()
        acc["engine"] += time.perf_counter() - t
        return out

    for b in range(2):
        feed(b)
    torch.cuda.synchronize()
    acc = dict.fromkeys(acc, 0.0)
    n_timed = 6
    t0 = time.perf_counter()
    for b in range(n_timed):
        feed(2 + b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = dict(launches=launches, b1_gate=gate.stats,
               channelizer_max_abs_err=max(ch_err, oracle_err, os2_err),
               samples_per_s=n_timed * rows * C / dt)
    log(json.dumps({"phase": "wideband", "channels": C, "taps_per_branch":
                    WB_K, "blocks": len(blocks), "launches": launches,
                    "channelizer_vs_cpu": ch_err,
                    "channelizer_vs_direct_ddc": oracle_err,
                    "oracle_channels": chans.tolist(), "os2_vs_cpu": os2_err,
                    "packets_vs_cpu": pkt_err, "b1_gate": gate.stats,
                    "qpsk_angle_p99_worst": float(p99.max()),
                    "noise_channels": list(noise),
                    "synthesis_s": synth_s, "card_s": card_s,
                    "cpu_s": cpu_s, "card": card}))
    log(json.dumps({"phase": "timing", "what": "wideband input side",
                    "channelizer_device_ms_per_block": chan_ms,
                    "channelizer_bound_ms": bound,
                    "upload_ms_per_block": up_ms,
                    "block_bytes": rows * C * 8, "pipeline_depth": 0,
                    "blocks": n_timed, "seconds": dt,
                    "input_samples_per_s": res["samples_per_s"],
                    "host_ms_per_block": {k: v * 1e3 / n_timed
                                          for k, v in acc.items()},
                    "card": card}))
    return res


RS_PATHS = (
    # (name, native sps of channel c, ResamplerBank options)
    ("gather", lambda c: 7.3 + 1.95 * (c % CPU_C) / (CPU_C - 1),
     dict(uniform=False)),
    ("uniform", lambda c: 10.0, {}),
    ("grouped", lambda c: (7.3, 8.0, 8.9, 9.25)[c % 4], {}),
)


def blank_tail(pkts: list, live: np.ndarray) -> list:
    """Copies of a bank's packet dicts with each channel's values past its
    first ``live[c]`` emitted symbols set to 0: there the timing windows
    read only the resampler's EOS zero padding and its lead-out, whose
    energies tie."""
    from psk_soft_tpu_torch.runtime.streams import PORT_SOFT

    out, done = [], 0
    for p in pkts:
        if not p:
            out.append(p)
            continue
        width = p[PORT_SOFT].data.shape[-1]
        q = {}
        for port, pk in p.items():
            d = pk.data
            if d.ndim == 2 and width:
                per = d.shape[1] // width
                sym = done + np.arange(d.shape[1]) // per
                d = np.where(sym[None, :] < live[:d.shape[0], None], d,
                             np.zeros((), d.dtype))
            q[port] = dataclasses.replace(pk, data=d)
        done += width
        out.append(q)
    return out


def resampler_device_ms(torch, dev, bank, event_ms) -> dict:
    """The device work of one ResamplerBank block step, by CUDA events:
    the step runs once with its uploads and device steps
    (ops/resample's functions) recorded, then each is replayed alone, so
    the host's window fill is left out."""
    from psk_soft_tpu_torch.runtime import resampler as mod

    uploads, calls = [], []
    banks = [bank] + [sub for _, _, sub in bank._groups or ()]
    steps = {n: getattr(mod, n)
             for n in ("resample_block", "resample_block_uniform")}

    def recorded(fn):
        def run(*a):
            calls.append((fn, a))
            return fn(*a)
        return run

    def recorded_upload(up):
        def run(a):
            uploads.append(np.ascontiguousarray(a))
            return up(a)
        return run

    for n, fn in steps.items():
        setattr(mod, n, recorded(fn))
    for b in banks:
        b._upload = recorded_upload(b._upload)
    try:
        if bank.step_planes() is None:
            raise AssertionError("resampler not ready for the replay")
    finally:
        for n, fn in steps.items():
            setattr(mod, n, fn)
        for b in banks:
            del b._upload
    return {"upload": event_ms(lambda: [torch.from_numpy(a).to(dev)
                                        for a in uploads], [()]),
            "steps": event_ms(lambda: [fn(*a) for fn, a in calls], [()]),
            "uploads": len(uploads), "upload_bytes": sum(
                a.nbytes for a in uploads), "step_calls": len(calls)}


def resampled_phase(torch, dev, card: str, event_ms) -> dict:
    """Phase 24b: ResampledBankEngine(pipeline="full") at C channels into
    B1 on each resampler path (RS_PATHS: the gather path over native sps
    7.3-9.25, the uniform banded product at sps 10 -> 8, the grouped path
    over examples/hetero_rate_bank.py's four rates), raised-cosine QPSK at
    each channel's native rate pushed a block at a time, RS_STEADY + 1
    blocks and a flush, every B1 launch before the flush held by B1Gate:
    B1 once a steady block (the flush's drained blocks included); packets
    equal a CPU run at CPU_C channels (the drained tail past the pushed
    samples blanked on both); the engine's SRI rescaled.  Then each path's
    host ms (push, step) and device ms (resampler_device_ms) a block."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.cuda import demod_kernel
    from psk_soft_tpu_torch.runtime.resampler import (ResampledBankEngine,
                                                      ResamplerBank)
    from psk_soft_tpu_torch.runtime.streams import SRI
    from psk_soft_tpu_torch.testing.wideband import rc_psk

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    rows = S * SPS
    n_blocks = 1 + RS_STEADY
    rng = np.random.default_rng(IN_SEED + 1)
    out = {}
    for name, native_of, kw in RS_PATHS:
        native = np.array([native_of(c) for c in range(C)], np.float64)
        ratios = native / SPS
        n_c = np.ceil(n_blocks * rows * ratios).astype(np.int64) + 16
        chunk = np.ceil(rows * ratios).astype(np.int64)
        t0 = time.perf_counter()
        x, _ = rc_psk(native, int(n_c.max()), 4, rng,
                      offset=RS_TAPS // 2 - 1)
        for part in (1, 1j):
            x += part * (WB_SIGMA / np.sqrt(2.0)) * rng.standard_normal(
                x.shape, dtype=np.float32)
        gen_s = time.perf_counter() - t0

        def run(device, width, gate=None):
            eng = ResampledBankEngine(cfg, width, native[:width],
                                      block_symbols=S, device=device,
                                      resampler_kwargs=kw)
            eng.set_input_sri(SRI(stream_id=name, xdelta=1e-6))
            fed = [0]
            feed = eng._feed

            def counted(blk):
                fed[0] += 1
                return feed(blk)

            eng._feed = counted
            pkts = []
            with gate or contextlib.nullcontext():
                for b in range(-(-int(n_c.max()) // int(chunk.min()))):
                    for c in range(width):
                        lo = b * chunk[c]
                        if lo < n_c[c]:
                            eng.push(c, x[c, lo:min(lo + chunk[c], n_c[c])])
                    while (p := eng.step_packets()) is not None:
                        pkts.append(p)
            # The drained blocks end in windows of EOS zero padding alone,
            # where every sample ties at 0: B1's carried sums pick by
            # rounding residue and its plain version picks sample 0, so
            # the gate holds the blocks before the flush.
            return pkts + eng.flush_packets(), fed[0], eng

        demod_kernel.demod_full_tm.launches = 0
        gate = B1Gate(f"resampled bank ({name})")
        t0 = time.perf_counter()
        gpu, fed, eng = run(dev, C, gate)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = demod_kernel.demod_full_tm.launches
        bank = eng.resampler
        path = ("grouped" if bank._groups is not None else
                "uniform" if bank._uniform is not None else "gather")
        if path != name or launches != fed - 1 or fed < n_blocks:
            raise AssertionError(f"resampled bank ({name}): path {path}, "
                                 f"B1 launched {launches} times for {fed} "
                                 f"blocks (1 warm-up)")
        scale = ratios[0] if np.allclose(ratios, ratios[0]) \
            else np.median(ratios)
        if eng.engine.assembler.sri.xdelta != 1e-6 * scale:
            raise AssertionError(f"resampled bank ({name}): SRI xdelta "
                                 f"{eng.engine.assembler.sri.xdelta}")
        t0 = time.perf_counter()
        cpu, _, _ = run("cpu", CPU_C)
        cpu_s = time.perf_counter() - t0
        # emitted symbols whose timing window still reads pushed samples
        live = ((n_c - 2 * RS_TAPS) / ratios / SPS).astype(np.int64) - 2
        err = compare_service(blank_tail(gpu, live), blank_tail(cpu, live),
                              f"resampled bank ({name}) vs CPU", rows=CPU_C)

        # --- times: push and step on the host clock, step on the device ---
        tb = ResamplerBank(ratios, rows, device=dev, **kw)
        acc = dict(push=0.0, step=0.0)
        n_timed = 3
        for c in range(C):
            tb.push(c, x[c, :chunk[c]])
        for b in range(1, n_timed + 2):
            t = time.perf_counter()
            for c in range(C):
                tb.push(c, x[c, b * chunk[c]:(b + 1) * chunk[c]])
            t1 = time.perf_counter()
            got = tb.step_planes()
            torch.cuda.synchronize()
            if b > 1:                      # the first step warms up
                acc["push"] += t1 - t
                acc["step"] += time.perf_counter() - t1
            if got is None:
                raise AssertionError(f"resampler ({name}) not ready")
        for c in range(C):                 # samples for the replayed step
            tb.push(c, x[c, :2 * chunk[c]])
        dev_ms = resampler_device_ms(torch, dev, tb, event_ms)
        out[name] = dict(launches=launches, blocks=fed, max_err_vs_cpu=err,
                         b1_gate=gate.stats)
        log(json.dumps({"phase": "resampled_bank", "path": name,
                        "channels": C, "native_sps": [float(native.min()),
                                                      float(native.max())],
                        "blocks": fed, "launches": launches,
                        "packets_vs_cpu": err, "b1_gate": gate.stats,
                        "signal_s": gen_s, "card_s": card_s, "cpu_s": cpu_s,
                        "card": card}))
        log(json.dumps({"phase": "timing", "what": f"resampler ({name})",
                        "channels": C, "block_rows": rows,
                        "host_ms_per_block": {k: v * 1e3 / n_timed
                                              for k, v in acc.items()},
                        "device_ms_per_block": dev_ms, "card": card}))
    return out


def probe_capture(rng):
    """(C, PROBE_T) rectangular M-PSK (tests/test_probe.py's _rect_psk) at
    PROBE_SNR_DB, channel c at sps PROBE_SPS[c % 4], M PROBE_M[c % 3] and a
    CFO in (-0.0125, 0.0125); every 16th channel noise only.  Returns
    (x, sps, m, cfo, noise mask)."""
    c = np.arange(C)
    sps = np.array(PROBE_SPS)[c % len(PROBE_SPS)]
    m = np.array(PROBE_M)[c % len(PROBE_M)]
    cfo = 0.025 * (((c * 37) % 101) / 100.0 - 0.5)
    noise = c % 16 == 15
    n = np.arange(PROBE_T)
    sym = np.floor(n[None, :] / sps[:, None]).astype(np.int64)
    idx = rng.integers(0, m[:, None], (C, int(PROBE_T / min(PROBE_SPS)) + 2))
    ph = np.take_along_axis(idx, sym, axis=1) / m[:, None] \
        + cfo[:, None] * n[None, :]
    sigma = 10 ** (-PROBE_SNR_DB / 20) / np.sqrt(2)
    x = np.exp(2j * np.pi * ph) + sigma * (
        rng.standard_normal((C, PROBE_T))
        + 1j * rng.standard_normal((C, PROBE_T)))
    x[noise] = (rng.standard_normal((int(noise.sum()), PROBE_T))
                + 1j * rng.standard_normal((int(noise.sum()), PROBE_T)))
    return x.astype(np.complex64), sps, m, cfo, noise


def probe_phase(torch, dev, card: str) -> dict:
    """Phase 24c: estimate_baud and classify_psk on C x PROBE_T samples,
    on the card and on the CPU.  Planted channels: sps within
    PROBE_SPS_RTOL relative, M exact, CFO within PROBE_CFO_TOL, the
    confidences within PROBE_CONF_RTOL relative; and as tests/test_probe.py
    requires, sps within 0.05 of the planted (confidence > 10), M the
    planted (confidence > 8), CFO within 2e-4; on noise channels no PSK
    line (M 0), and every planted baud confidence over 5x the noise
    channels' median one (a signal row against a noise row, as there).  Then each call's ms (numpy in, and the capture on the card)."""
    from psk_soft_tpu_torch.ops.probe import classify_psk, estimate_baud

    x, sps, m, cfo, noise = probe_capture(np.random.default_rng(IN_SEED + 2))
    sig = ~noise
    res = {}
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        b = estimate_baud(x, sps_min=2, sps_max=32, device=device)
        t1 = time.perf_counter()
        k = classify_psk(x, max_m=8, device=device)
        res[device] = (b, k, t1 - t0, time.perf_counter() - t1)
    (g_sps, g_conf), (g_m, g_cfo, g_mconf), *_ = res[dev]
    (c_sps, c_conf), (c_m, c_cfo, c_mconf), *_ = res["cpu"]
    vs_cpu = {
        "sps_rel": float(np.max(np.abs(g_sps - c_sps)[sig] / c_sps[sig])),
        "baud_conf_rel": float(np.max(np.abs(g_conf - c_conf)[sig]
                                      / c_conf[sig])),
        "m_differ": int((g_m != c_m)[sig].sum()),
        "cfo": float(np.abs(g_cfo - c_cfo)[sig].max()),
        "m_conf_rel": float(np.max(np.abs(g_mconf - c_mconf)[sig]
                                   / c_mconf[sig]))}
    if (vs_cpu["sps_rel"] > PROBE_SPS_RTOL or vs_cpu["m_differ"]
            or vs_cpu["cfo"] > PROBE_CFO_TOL
            or vs_cpu["baud_conf_rel"] > PROBE_CONF_RTOL
            or vs_cpu["m_conf_rel"] > PROBE_CONF_RTOL):
        raise AssertionError(f"probe card vs CPU: {vs_cpu}")
    planted = {
        "sps_err": float(np.abs(g_sps - sps)[sig].max()),
        "baud_conf_min": float(g_conf[sig].min()),
        "m_wrong": int((g_m != m)[sig].sum()),
        "cfo_err": float(np.abs(g_cfo - cfo)[sig].max()),
        "m_conf_min": float(g_mconf[sig].min()),
        "noise_m_nonzero": int((g_m[noise] != 0).sum()),
        "noise_baud_conf_median": float(np.median(g_conf[noise])),
        "noise_baud_conf_max": float(g_conf[noise].max())}
    if (planted["sps_err"] >= 0.05 or planted["baud_conf_min"] <= 10.0
            or planted["m_wrong"] or planted["cfo_err"] >= 2e-4
            or planted["m_conf_min"] <= 8.0 or planted["noise_m_nonzero"]
            or planted["baud_conf_min"]
            <= 5 * planted["noise_baud_conf_median"]):
        raise AssertionError(f"probe: planted values not recovered: "
                             f"{planted}")
    xd = torch.from_numpy(x).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    estimate_baud(xd, sps_min=2, sps_max=32)
    t1 = time.perf_counter()
    classify_psk(xd, max_m=8)
    t2 = time.perf_counter()
    times = {"estimate_baud_ms": res[dev][2] * 1e3,
             "classify_psk_ms": res[dev][3] * 1e3,
             "estimate_baud_on_card_ms": (t1 - t0) * 1e3,
             "classify_psk_on_card_ms": (t2 - t1) * 1e3,
             "cpu_estimate_baud_ms": res["cpu"][2] * 1e3,
             "cpu_classify_psk_ms": res["cpu"][3] * 1e3}
    log(json.dumps({"phase": "probe", "channels": C, "samples": PROBE_T,
                    "noise_channels": int(noise.sum()), "vs_cpu": vs_cpu,
                    "planted": planted, "card": card}))
    log(json.dumps({"phase": "timing", "what": "probe", **times,
                    "card": card}))
    return dict(vs_cpu=vs_cpu, planted=planted, times=times)


def queue_phase(torch, dev, card: str) -> dict:
    """Phase 24d: a producer thread pushes QUEUE_PACKETS packets of one
    stream (one S-symbol block each, the last EOS) into
    NativePacketQueue while a FeedThread drives a StreamEngine on the
    card; its outputs equal a CPU StreamEngine.process over the packets
    the queue delivered (compare_service).  Then a forced overflow: the
    next packet comes flagged and the card's engine resets, as the CPU
    run does."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.runtime.engine import StreamEngine
    from psk_soft_tpu_torch.runtime.native_queue import (FeedThread,
                                                         NativePacketQueue)
    from psk_soft_tpu_torch.runtime.streams import SRI

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    x = channels(QUEUE_PACKETS * S, n_ch=1)[0]
    segs = np.split(x, QUEUE_PACKETS)
    sri = SRI(stream_id="queued", xdelta=1e-6)

    def feed_thread(q, eng, delivered):
        outs = []
        proc = eng.process

        def recording(pkt):
            delivered.append(pkt)
            return proc(pkt)

        eng.process = recording
        th = FeedThread(q, eng, sink=outs.append)
        th.start()
        return th, outs

    def cpu_run(delivered):
        eng = StreamEngine(cfg, S, device="cpu")
        return [eng.process(p) for p in delivered], eng

    res = {}
    # Main run: producer and feeder threads at once.
    q = NativePacketQueue()
    eng = StreamEngine(cfg, S, device=dev)
    delivered = []
    th, outs = feed_thread(q, eng, delivered)

    def produce():
        for i, seg in enumerate(segs):
            q.push(seg, sri, t=i * seg.size * 1e-6,
                   eos=i == QUEUE_PACKETS - 1)

    prod = threading.Thread(target=produce)
    t0 = time.perf_counter()
    prod.start()
    prod.join(timeout=60)
    th.join(timeout=300)
    dt = time.perf_counter() - t0
    if prod.is_alive() or th.is_alive() or len(delivered) != QUEUE_PACKETS:
        raise AssertionError(f"queue: {len(delivered)} packets delivered")
    ref, ceng = cpu_run(delivered)
    res["err"] = compare_service(outs, ref, "queue -> FeedThread vs CPU")
    if (dataclasses.asdict(eng.metrics) != dataclasses.asdict(ceng.metrics)
            or q.stats().popped != QUEUE_PACKETS
            or eng.metrics.symbols_out != QUEUE_PACKETS * S - NUM_AVG + 1):
        raise AssertionError(f"queue: metrics {eng.metrics} vs "
                             f"{ceng.metrics}")
    res["samples_per_s"] = x.size / dt
    q.close()

    # Forced overflow: 5 packets fit, the 6th push flushes the backlog.
    q = NativePacketQueue(max_packets=5)
    flags = [q.push(seg, sri, t=float(i)) for i, seg in enumerate(segs[:8])]
    eng = StreamEngine(cfg, S, device=dev)
    delivered = []
    th, outs = feed_thread(q, eng, delivered)
    q.push(segs[8], sri, t=8.0, eos=True)
    th.join(timeout=300)
    if th.is_alive():
        raise AssertionError("queue: the feeder did not reach EOS")
    ref, ceng = cpu_run(delivered)
    res["overflow_err"] = compare_service(outs, ref, "queue overflow vs CPU")
    flagged = [p.input_queue_flushed for p in delivered]
    if (flags != [False] * 5 + [True] + [False] * 2
            or flagged != [True] + [False] * 3 or eng.metrics.resets != 1
            or dataclasses.asdict(eng.metrics)
            != dataclasses.asdict(ceng.metrics)
            or q.stats().dropped_packets != 5):
        raise AssertionError(f"queue overflow: pushes {flags}, delivered "
                             f"{flagged}, resets {eng.metrics.resets}")
    q.close()
    log(json.dumps({"phase": "queue", "packets": QUEUE_PACKETS,
                    "vs_cpu": res["err"], "overflow_vs_cpu":
                    res["overflow_err"], "resets_after_overflow": 1,
                    "samples_per_s": res["samples_per_s"], "card": card}))
    return res


# --- phase 25: the TX and evaluation layer (ROADMAP A.9, A.10) --------------

EVAL_K = 4                    # 25a: blocks through the scanned factory
FER_BLOCKS = 3                # 25b: blocks a chain-FER point
FER_SEED = 3                  # tests/test_coded_ber.py:78-116's seed
# tests/test_coded_ber.py's operating points: (name, Es/N0, keywords)
FER_POINTS = (("hi", 12.0, dict(cfo=2e-5)), ("mid", 8.0, {}),
              ("lo", -2.0, {}), ("acquisition", 12.0, dict(front_cfo=0.02)))
CLI_SYMBOLS = 4096            # 25e: gen-frames capture, symbols a channel
CLI_INTERVAL = 600            # its frame interval (first frame after warm-up)


def kernel_counts():
    """B1's and B2-B4's launch counters, by name."""
    from psk_soft_tpu_torch.ops.cuda import demod_kernel, viterbi_kernel

    return {"demod_full_tm": demod_kernel.demod_full_tm,
            "viterbi_fused": viterbi_kernel.viterbi_fused,
            "viterbi_acs": viterbi_kernel.viterbi_acs,
            "viterbi_traceback": viterbi_kernel.viterbi_traceback}


def counted(torch, fn):
    """Run ``fn`` with every kernel count set to 0 just before it; returns
    (its result, the counts just after, host seconds)."""
    wrappers = kernel_counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return res, {k: w.launches for k, w in wrappers.items()}, dt


def factories_phase(torch, dev, card) -> dict:
    """25a: models/full.make_scanned_full_demod_fn over EVAL_K blocks of
    1024 x 512 (cell 1's config), every output and the final carry
    bit-equal (torch.equal) to EVAL_K demod_block_full calls;
    make_mixed_full_demod_fn one block at config 4's widths.  Every B1
    launch of both held by B1Gate; B1 launched EVAL_K times and once."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import full
    from psk_soft_tpu_torch.models.mixed import MixedParams

    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    state0, x_re, x_im = b1_warm(torch, dev, C, SPS, NUM_AVG, EVAL_K * S)
    xs_re = x_re.reshape(EVAL_K, S * SPS, C)
    xs_im = x_im.reshape(EVAL_K, S * SPS, C)
    scan = full.make_scanned_full_demod_fn(cfg)
    with B1Gate("scanned full factory") as gate:
        (st, out), launches, _ = counted(torch, lambda: scan(state0, xs_re,
                                                             xs_im))
    res = {"scanned": launches["demod_full_tm"], "gate": gate.stats}
    one = state0
    for k in range(EVAL_K):
        one, o = full.demod_block_full(cfg, one, xs_re[k], xs_im[k])
        for name, a, b in zip(o._fields, o, out):
            if not torch.equal(a, b[k]):
                raise AssertionError(f"25a: scanned {name} of block {k} "
                                     f"differs from demod_block_full's")
    for name, a, b in zip(one._fields, one, st):
        if not torch.equal(a, b):
            raise AssertionError(f"25a: scanned carry {name} differs")

    cfg4 = DemodConfig(sps=SPS, num_avg=50, constellation_size=4,
                       phase_avg=20)
    ms, diffs = mixed_modes(C)
    params = MixedParams.make(ms, diffs, dev)
    state4, y_re, y_im, _ = mode_inputs(
        torch, dev, cfg4, mixed_channels(WARM + S, ms, diffs), params=params)
    step = full.make_mixed_full_demod_fn(cfg4)
    with B1Gate("mixed full factory") as gate4:
        (_, mout), mlaunch, _ = counted(torch, lambda: step(state4, y_re,
                                                            y_im))
    if mout.soft_re.shape != (S, C) or not bool(
            torch.isfinite(mout.soft_re).all()):
        raise AssertionError("25a: mixed factory outputs")
    res["mixed"] = mlaunch["demod_full_tm"]
    res["mixed_gate"] = gate4.stats
    if (res["scanned"], res["mixed"]) != (EVAL_K, 1) or (
            gate.stats["launches_checked"], gate4.stats["launches_checked"]
    ) != (EVAL_K, 1):
        raise AssertionError(f"25a: B1 launches {res}")
    log(json.dumps({"phase": "eval_factories", "channels": C, "symbols": S,
                    "blocks": EVAL_K, "launches": {
                        "scanned": res["scanned"], "mixed": res["mixed"]},
                    "bit_equal_to_per_block_calls": True,
                    "b1_gate": gate.stats, "mixed_b1_gate": gate4.stats,
                    "card": card}))
    return res


def chain_fer_phase(torch, dev, card) -> dict:
    """25b: eval/coded.measure_chain_fer at 1024 channels, FER_BLOCKS
    blocks, at tests/test_coded_ber.py's points and gates (12 dB with a
    CFO spread: FER <= 0.01, every frame found; 8 dB: <= 0.08; -2 dB: >=
    0.3 and lo > mid >= hi; the acquisition leg at front_cfo 0.02: <=
    0.01, every frame found), every B1 launch held by B1Gate (bits held
    where no near-tie pick moved the tracker: ``tied_bits``), B1's and
    B2's launches counted per point; the 8 dB point at 128 channels equal
    (every ChainFerPoint field) on the card and on the CPU."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.eval.coded import measure_chain_fer
    from psk_soft_tpu_torch.models.chain import chain_msg_bits
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
    from psk_soft_tpu_torch.ops.fec import CODE_K7
    from psk_soft_tpu_torch.ops.framesync import FrameFormat

    # tests/test_coded_ber.py's chain: UW 32 drawn from seed 31.
    uw = np.random.default_rng(31).integers(0, 4, 32)
    args = (DemodConfig(sps=8, num_avg=40, constellation_size=4,
                        phase_avg=30),
            FrameFormat(uw=tuple(int(v) for v in uw), payload=48, m=4,
                        threshold=0.7), CODE_K7, CRC16_CCITT)
    n_msg = chain_msg_bits(*args[1:])
    res, pts = {}, {}
    for name, esn0, kw in FER_POINTS:
        with B1Gate(f"chain FER {name}", tied_bits=True) as gate:
            p, launches, dt = counted(torch, lambda: measure_chain_fer(
                *args, esn0, channels=C, blocks=FER_BLOCKS, seed=FER_SEED,
                device=dev, **kw))
        if (launches["demod_full_tm"], launches["viterbi_fused"]) != (
                FER_BLOCKS, FER_BLOCKS) or gate.stats[
                    "launches_checked"] != FER_BLOCKS:
            raise AssertionError(f"25b {name}: launches {launches}")
        pts[name] = p
        res[name] = dict(point=p._asdict(), fer=p.fer, launches={
            k: v for k, v in launches.items() if v}, seconds=dt,
            infobits_per_s=p.frames * n_msg / dt, b1_gate=gate.stats)
        log(json.dumps({"phase": "eval_chain_fer", "point": name,
                        "esn0_db": esn0, **kw, "channels": C,
                        "blocks": FER_BLOCKS, **res[name], "card": card}))
    hi, mid, lo, acq = (pts[k] for k in ("hi", "mid", "lo", "acquisition"))
    if not (hi.fer <= 0.01 and hi.found == hi.frames and mid.fer <= 0.08
            and lo.fer >= 0.3 and lo.fer > mid.fer >= hi.fer
            and acq.fer <= 0.01 and acq.found == acq.frames
            and (lo.overflow == 0 or lo.overflow < lo.frames)):
        raise AssertionError(f"25b: chain FER gates: {pts}")
    card_pt = measure_chain_fer(*args, 8.0, channels=CPU_C,
                                blocks=FER_BLOCKS, seed=FER_SEED, device=dev)
    cpu_pt = measure_chain_fer(*args, 8.0, channels=CPU_C,
                               blocks=FER_BLOCKS, seed=FER_SEED,
                               device="cpu")
    if tuple(card_pt) != tuple(cpu_pt):
        raise AssertionError(f"25b: 128 channels, card {card_pt} vs CPU "
                             f"{cpu_pt}")
    res["card_vs_cpu_128"] = card_pt._asdict()
    log(json.dumps({"phase": "eval_chain_fer", "point": "mid, 128 channels",
                    "card": card_pt._asdict(), "cpu": cpu_pt._asdict(),
                    "equal": True}))
    return res


def coded_ber_phase(torch, dev, card) -> dict:
    """25c: eval/coded.measure_coded_ber on B2 at tests/test_coded_ber.py's
    points (K7 QPSK 5 dB, 100k bits; K7 BPSK at -1 and 0 dB, 120k bits; K3
    BPSK 1 dB, 40k; K7 punctured 2/3 QPSK 6 dB, 30k), each CodedBerPoint
    equal field by field to the same call on the CPU, B2 launched once a
    point and B3/B4 never, and the JAX tests' assertions on the card's
    numbers."""
    from psk_soft_tpu_torch.eval.ber import theoretical_ber
    from psk_soft_tpu_torch.eval.coded import measure_coded_ber, union_bound
    from psk_soft_tpu_torch.ops.fec import (CODE_K3, CODE_K7, PUNCTURE_2_3,
                                            ConvCode, conv_encode)

    punct = ConvCode(7, (0o171, 0o133), PUNCTURE_2_3)
    cases = (("k7_qpsk_5db", CODE_K7, 4, 5.0, 100_000, 1),
             ("k7_bpsk_-1db", CODE_K7, 2, -1.0, 120_000, 2),
             ("k7_bpsk_0db", CODE_K7, 2, 0.0, 120_000, 2),
             ("k3_bpsk_1db", CODE_K3, 2, 1.0, 40_000, 4),
             ("k7_2/3_qpsk_6db", punct, 4, 6.0, 30_000, 5))
    res = {}
    for name, code, m, esn0, nbits, seed in cases:
        run = lambda dv: measure_coded_ber(  # noqa: E731
            code, m, esn0, num_bits=nbits, seed=seed, device=dv)
        p, launches, dt = counted(torch, lambda: run(dev))
        ref = run("cpu")
        if dataclasses.astuple(p) != dataclasses.astuple(ref):
            raise AssertionError(f"25c {name}: card {p} vs CPU {ref}")
        if (launches["viterbi_fused"], launches["viterbi_acs"],
                launches["viterbi_traceback"]) != (1, 0, 0):
            raise AssertionError(f"25c {name}: launches {launches}")
        coded_bits = p.n_frames * conv_encode(
            code, np.zeros(p.n_bits // p.n_frames, np.int8)).shape[-1]
        res[name] = dict(point=dataclasses.asdict(p), seconds=dt,
                         coded_bits_per_s=coded_bits / dt,
                         infobits_per_s=p.n_bits / dt,
                         launches={"viterbi_fused": 1})
        log(json.dumps({"phase": "eval_coded_ber", "case": name,
                        **res[name], "card": card}))
    pts = {k: v["point"] for k, v in res.items()}
    q = pts["k7_qpsk_5db"]
    uncoded = float(theoretical_ber(4, np.asarray(5.0)))
    ok = abs(q["ebn0_db"] - 5.0) < 1e-6 and q["ber"] < uncoded / 20
    for k in ("k7_bpsk_-1db", "k7_bpsk_0db"):
        b = pts[k]
        bound = float(union_bound(CODE_K7, b["ebn0_db"]))
        ok &= bound / 10.0 <= b["ber"] <= 2.0 * bound + 5.0 / b["n_bits"]
    k3 = pts["k3_bpsk_1db"]
    ok &= (abs(k3["ebn0_db"] - (1.0 + 10 * np.log10(2.0))) < 1e-6
           and k3["ber"] < float(theoretical_ber(2, np.asarray(1.0))))
    pp = pts["k7_2/3_qpsk_6db"]
    ok &= (abs(pp["ebn0_db"] - (6.0 - 10 * np.log10(4 / 3))) < 1e-3
           and 0 <= pp["ber"] < 0.02)
    if not ok:
        raise AssertionError(f"25c: coded-BER gates: {pts}")
    return res


def baseline_phase(torch, dev, card) -> dict:
    """25d: BASELINE configs 1-4 at full size (quick=False) on the card,
    each pass: true; seconds per config and measure_ber's symbols/s."""
    from psk_soft_tpu_torch.eval.baseline_configs import run_config

    res = {}
    for n in (1, 2, 3, 4):
        r, _, dt = counted(torch, lambda: run_config(n, quick=False,
                                                     device=dev))
        if not r["pass"]:
            raise AssertionError(f"25d: config {n}: {r}")
        res[n] = dict(result=r, seconds=dt)
    # measure_ber's symbols: config 2 one 100k-symbol point, config 3 seven
    # of 50k.
    ber_rate = {"config2": 100_000 / res[2]["seconds"],
                "config3": 7 * 50_000 / res[3]["seconds"]}
    log(json.dumps({"phase": "eval_baseline", "full_size": True,
                    "configs": {n: {"pass": v["result"]["pass"],
                                    "seconds": v["seconds"]}
                                for n, v in res.items()},
                    "results": {n: v["result"] for n, v in res.items()},
                    "measure_ber_symbols_per_s": ber_rate, "card": card}))
    return {"seconds": {n: v["seconds"] for n, v in res.items()},
            "measure_ber_symbols_per_s": ber_rate}


def cli_phase(torch, dev, card) -> dict:
    """25e: ``python -m psk_soft_tpu_torch`` as subprocesses, started
    together: selftest, baseline --config 1, ber --esn0 8,11 -M 4 and
    gen-frames (K7, CRC-16, PRBS15, Gray, 128 channels) into a temporary
    file, each rc 0; the capture read back through build_receiver
    (engine="full") on the card, every truth frame decoded once with the
    CRC green and exact info bits."""
    import os
    import tempfile

    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
    from psk_soft_tpu_torch.ops.fec import CODE_K7
    from psk_soft_tpu_torch.ops.scramble import prbs15
    from psk_soft_tpu_torch.runtime.receiver import build_receiver

    uw = [int(v) for v in np.random.default_rng(15).integers(0, 4, 32)]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        cap, truth = os.path.join(tmp, "link.cf32"), os.path.join(
            tmp, "truth.jsonl")
        cmds = {
            "selftest": ["selftest"],
            "baseline": ["baseline", "--config", "1"],
            "ber": ["ber", "--esn0", "8,11", "-M", "4"],
            "gen-frames": ["gen-frames", "--out", cap, "--truth", truth,
                           "--channels", str(CPU_C), "--symbols",
                           str(CLI_SYMBOLS), "--sps", str(SPS), "-M", "4",
                           "--uw", ",".join(map(str, uw)),
                           "--frame-payload", "64", "--fec", "k7",
                           "--crc", "crc16", "--scramble", "prbs15",
                           "--labeling", "gray", "--frame-interval",
                           str(CLI_INTERVAL), "--snr", "18", "--seed", "3"]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "psk_soft_tpu_torch"] + v, cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for k, v in cmds.items()}
        outs = {}
        for k, p in procs.items():
            out, err = p.communicate(timeout=300)
            outs[k] = (p.returncode, out, err)
        cli_s = time.perf_counter() - t0
        bad = {k: v for k, v in outs.items() if v[0] != 0}
        if bad:
            raise AssertionError(f"25e: CLI rc != 0: {bad}")
        if not outs["selftest"][1].strip().endswith("selftest PASS") or \
                not json.loads(outs["baseline"][1])["pass"] or \
                len(outs["ber"][1].splitlines()) != 2:
            raise AssertionError(f"25e: CLI outputs {outs}")
        wire = np.fromfile(cap, np.complex64).reshape(-1, CPU_C)
        want = {}
        for line in open(truth).read().splitlines():
            r = json.loads(line)
            want[(r["channel"], r["start"])] = np.asarray(r["info_bits"],
                                                          np.int8)
    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    rx = build_receiver(cfg, CPU_C, engine="full", block_symbols=S, uw=uw,
                        frame_payload=64, fec=CODE_K7, fec_labeling="gray",
                        descramble=prbs15(), crc=CRC16_CCITT, device=dev)
    need = S * SPS
    frames = []
    for b in range(CLI_SYMBOLS // S):
        blk = wire[b * need:(b + 1) * need]
        rx.engine.push_planes(
            torch.from_numpy(np.ascontiguousarray(blk.real)).to(dev),
            torch.from_numpy(np.ascontiguousarray(blk.imag)).to(dev))
        rx.engine.step_packets()
        frames += rx.pop_frames()
    rx.engine.flush_packets()
    frames += rx.pop_frames()
    got = {}
    for f in frames:
        key = (f.channel, f.start)
        if key in got or key not in want or not f.crc_ok or f.suspect \
                or not np.array_equal(f.info_bits, want[key]):
            raise AssertionError(f"25e: frame {key}: CRC {f.crc_ok}")
        got[key] = f
    if set(got) != set(want):
        raise AssertionError(f"25e: {len(set(want) - set(got))} of "
                             f"{len(want)} truth frames missed")
    log(json.dumps({"phase": "eval_cli", "rc": {k: v[0] for k, v in
                                                outs.items()},
                    "cli_seconds_together": cli_s,
                    "gen_frames_decoded": len(got), "truth_frames": len(want),
                    "card": card}))
    return {"cli_seconds": cli_s, "frames": len(got)}


def eval_phase(torch, dev, card) -> dict:
    """Phase 25 (25a-25e), with its total time."""
    t0 = time.perf_counter()
    res = {"factories": factories_phase(torch, dev, card),
           "chain_fer": chain_fer_phase(torch, dev, card),
           "coded_ber": coded_ber_phase(torch, dev, card),
           "baseline": baseline_phase(torch, dev, card),
           "cli": cli_phase(torch, dev, card)}
    res["seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase": "eval", "seconds": res["seconds"],
                    "card": card}))
    return res


# --- phase 26: the CLI's demod and demod-batch (ROADMAP A.13) ----------------

CLI_BLOCKS = 6                # 26: 1 warm-up + 5 steady blocks of the capture
CLI_CFO = (0.018, 0.006)      # 26e: offset 0.018 + 0.006*c/C cycles/sample
DEMOD_SAMPLES = 1 << 20       # 26f: the ff demod's single stream
DEMOD_EXACT_BLOCKS = 2        # 26f: the exact demod's blocks


def run_cli(torch, argv) -> tuple:
    """``cli.main(argv)`` in-process, every kernel count set to 0 just
    before it: (the stderr metrics JSON, the launches, seconds)."""
    import contextlib
    import io

    from psk_soft_tpu_torch import cli
    from psk_soft_tpu_torch.ops.cuda import demod_kernel

    b1 = demod_kernel.demod_full_tm
    b1.mode_launches = dict.fromkeys(b1.mode_launches, 0)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, launches, dt = counted(torch, lambda: cli.main(argv))
    lines = err.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"26: {argv[:1]} rc {rc}: {lines[-3:]}")
    launches.update({f"demod_full_tm[{k}]": v
                     for k, v in b1.mode_launches.items()})
    return json.loads(lines[-1]), {k: v for k, v in launches.items() if v}, dt


def cli_host_profile(argv, top: int = 12) -> dict:
    """One more run of the CLI under cProfile (beside the gated one, not
    counted): its seconds and the host functions with the most own time,
    [file:line:function, calls, own s, cumulative s]."""
    import contextlib
    import cProfile
    import io
    import os
    import pstats

    from psk_soft_tpu_torch import cli

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        prof.runcall(cli.main, argv)
    dt = time.perf_counter() - t0
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return {"seconds": dt, "top_own_time": [
        [f"{os.path.basename(f)}:{line}:{fn}", nc, tt, ct]
        for (f, line, fn), (_, nc, tt, ct, _) in rows]}


def read_frames(path) -> dict:
    """{(channel, start): record} of a .frames.jsonl, no key twice."""
    rows = [json.loads(r) for r in open(path).read().splitlines()]
    out = {(r["channel"], r["start"]): r for r in rows}
    if len(out) != len(rows):
        raise AssertionError(f"26: a frame of {path} was written twice")
    return out


def gate_planted(label, frames, starts, infos, n_blocks, frame_len) -> int:
    """Every frame at a planted offset with the CRC green and exact info
    bits; every planted frame after the first block whose symbols all have
    demod rows present.  Returns the frames decoded."""
    planted = {s0: j for j, s0 in enumerate(starts)}
    for (c, start), f in frames.items():
        j = planted.get(start % S)
        if (j is None or f.get("crc_ok") is not True or f.get("suspect")
                or f["info_bits"] != infos[c, j].tolist()):
            raise AssertionError(f"{label}: frame {(c, start)} at offset "
                                 f"{start % S}, CRC {f.get('crc_ok')}")
    last = n_blocks * S - (NUM_AVG - 1)
    must = {(c, b * S + s0) for b in range(1, n_blocks) for s0 in starts
            for c in range(C) if b * S + s0 + frame_len <= last}
    if not must <= set(frames):
        raise AssertionError(f"{label}: {len(must - set(frames))} of "
                             f"{len(must)} planted frames missed")
    return len(frames)


def engine_files(torch, dev, cfg, wire, n_blocks, scale=None,
                 debug=True, soft_i8=False) -> dict:
    """NativePlaneBank -> FullKernelBatchEngine in-process on the card over
    the capture, written in the CLI's file layout: {ext: bytes}."""
    from psk_soft_tpu_torch.runtime.engine_full import FullKernelBatchEngine
    from psk_soft_tpu_torch.runtime.native_bank import NativePlaneBank
    from psk_soft_tpu_torch.runtime.streams import (
        PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX, PORT_SOFT, SRI)

    need = S * SPS
    eng = FullKernelBatchEngine(cfg, C, block_symbols=S, ingest_scale=scale,
                                debug_ports=debug, soft_i8=soft_i8,
                                device=dev)
    eng.set_input_sri(SRI(stream_id="cli-batch", xdelta=1.0, mode=1))
    bank = NativePlaneBank(C, capacity_samples=4 * need,
                           dtype="f32" if scale is None else "i16")
    pkts = []
    for b in range(n_blocks):
        bank.push_interleaved(wire[b * need:(b + 1) * need].reshape(-1))
        re, im, _ = bank.pop_planes(need, timeout=0)
        eng.push_planes(re, im)
        pkts.append(eng.step_packets())
    pkts.append(eng.flush_packets())
    bank.close()
    out = {}
    for port, ext in ((PORT_SOFT, ".soft.cf32"), (PORT_BITS, ".bits.i16"),
                      (PORT_PHASE, ".phase.f32"),
                      (PORT_SAMPLE_INDEX, ".index.i16")):
        datas = [p[port].data for p in pkts
                 if p and port in p and p[port].data.size]
        if not datas:
            continue
        d = np.concatenate(datas, axis=1)
        if port == PORT_BITS:
            d = d.reshape(C, -1, 2).transpose(1, 0, 2)
        else:
            d = d.T
        out[ext] = np.ascontiguousarray(d).tobytes()
    return out


def files_equal(label, prefix, ref: dict) -> dict:
    """The CLI's files against the in-process run's: bits and sample index
    byte-equal, soft within SOFT_TOL, phase within PHASE_TOL."""
    import os

    errs = {}
    for ext, want in ref.items():
        got = open(prefix + ext, "rb").read()
        if ext in (".bits.i16", ".index.i16"):
            if got != want:
                raise AssertionError(f"{label}: {ext} differs from the "
                                     f"in-process engine's")
            continue
        dt = np.complex64 if ext == ".soft.cf32" else np.float32
        a, b = np.frombuffer(got, dt), np.frombuffer(want, dt)
        if a.shape != b.shape:
            raise AssertionError(f"{label}: {ext} {a.shape} vs {b.shape}")
        errs[ext] = float(np.abs(a - b).max()) if a.size else 0.0
        if errs[ext] > (SOFT_TOL if ext == ".soft.cf32" else PHASE_TOL):
            raise AssertionError(f"{label}: {ext} off by {errs[ext]}")
    extra = {e for e in (".phase.f32", ".index.i16")
             if os.path.exists(prefix + e)} - set(ref)
    if extra:
        raise AssertionError(f"{label}: unexpected files {extra}")
    return errs


def cli_demod_phase(torch, dev, card, rates) -> dict:
    """Phase 26: the port's CLI (``cli.main``) on capture files at full
    width, each run's launches counted around it.  26a the per-stage
    stack; 26b --fused-chain; 26c int16 wire (also as a subprocess); 26d
    --fec-stream; 26e front ends on a carrier offset; 26f ``demod``, ff
    and exact.  ``rates``: phases 5, 7 and 22's in-process rates, printed
    beside the CLI's."""
    import os
    import tempfile

    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.crc import CRC16_CCITT
    from psk_soft_tpu_torch.ops.fec import CODE_K7
    from psk_soft_tpu_torch.ops.framesync import FrameFormat
    from psk_soft_tpu_torch.runtime.engine import StreamEngine
    from psk_soft_tpu_torch.runtime.fec import StreamFecDecoder
    from psk_soft_tpu_torch.runtime.streams import (
        SRI, Packet, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX, PORT_SOFT)

    t_phase = time.perf_counter()
    cfg = DemodConfig(sps=SPS, num_avg=NUM_AVG, constellation_size=4,
                      phase_avg=PHASE_AVG)
    rng = np.random.default_rng(26)
    fmt = FrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                      threshold=0.7)
    starts, infos, x, n_info = plant_chain_stream(fmt, CODE_K7, CRC16_CCITT,
                                                  rng)
    n_msg = n_info - CRC16_CCITT.degree
    block = np.ascontiguousarray(x.T)             # (S*SPS, C), S-periodic
    del x
    n = CLI_BLOCKS
    need = S * SPS
    wire_samples = n * need * C
    uw = ",".join(str(v) for v in fmt.uw)
    common = ["--channels", str(C), "--sps", str(SPS), "-M", "4",
              "--num-avg", str(NUM_AVG), "--phase-avg", str(PHASE_AVG),
              "--block-symbols", str(S), "--device", str(dev)]
    frame_flags = ["--uw", uw, "--frame-payload", str(fmt.payload),
                   "--fec", "k7", "--fec-labeling", "gray", "--crc", "crc16"]
    res, runs = {}, {}

    def note(name, dt, launches, frames=None, samples=wire_samples, **kw):
        runs[name] = dict(seconds=dt, launches=launches,
                          wire_msamples_per_s=samples / dt / 1e6, **kw)
        if frames is not None:
            runs[name]["frames"] = frames
            runs[name]["infobits_per_s"] = frames * n_msg / dt
        log(json.dumps({"phase": "cli_demod", "run": name, **runs[name],
                        "card": card}))

    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "bank.cf32")
        with open(cap, "wb") as f:
            for _ in range(n):
                f.write(block.tobytes())
        wire = np.tile(block, (n, 1))              # (n*S*SPS, C) complex64

        # --- 26a: the per-stage stack, files against the engine in-process
        pa = os.path.join(tmp, "a")
        metrics, launches, dt = run_cli(torch, [
            "demod-batch", "--in", cap, "--out-prefix", pa, *common,
            "--pipeline", "full", *frame_flags])
        frames_a = read_frames(pa + ".frames.jsonl")
        got = gate_planted("26a", frames_a, starts, infos, n, fmt.frame_len)
        if (metrics["samples_in"], metrics["frames_synced"],
                metrics["crc_failures"]) != (wire_samples, got, 0):
            raise AssertionError(f"26a: metrics {metrics}")
        if launches.get("demod_full_tm", 0) < n - 1 or launches.get(
                "viterbi_fused", 0) < n - 1:
            raise AssertionError(f"26a: launches {launches}")
        note("26a per-stage", dt, launches, got)
        res["26a"] = files_equal("26a", pa, engine_files(
            torch, dev, cfg, wire.view(np.float32), n))
        log(json.dumps({"phase": "cli_demod_profile", "run": "26a",
                        **cli_host_profile([
                            "demod-batch", "--in", cap, "--out-prefix",
                            os.path.join(tmp, "prof"), *common,
                            "--pipeline", "full", *frame_flags]),
                        "card": card}))

        # --- 26b: --fused-chain, the same frames
        pb = os.path.join(tmp, "b")
        metrics, launches, dt = run_cli(torch, [
            "demod-batch", "--in", cap, "--out-prefix", pb, *common,
            "--fused-chain", *frame_flags])
        frames_b = read_frames(pb + ".frames.jsonl")
        got = gate_planted("26b", frames_b, starts, infos, n, fmt.frame_len)

        def rows(fr):
            return {(k, tuple(f["info_bits"]), f["crc_ok"])
                    for k, f in fr.items()}

        # The chain loses the frames wholly inside its warm-up block (the
        # reference's behaviour), the per-stage stack decodes them: equal
        # from the first steady block on, a subset before it.
        late = {k: f for k, f in frames_a.items() if k[1] >= S}
        if not rows(late) <= rows(frames_b) <= rows(frames_a):
            raise AssertionError(
                f"26b: the fused chain's frames differ from the per-stage "
                f"stack's: {len(set(late) - set(frames_b))} steady frames "
                f"missing, {len(set(frames_b) - set(frames_a))} extra")
        if metrics["crc_failures"] or metrics["overflow_peaks"] or min(
                launches.get("demod_full_tm", 0),
                launches.get("viterbi_fused", 0)) < n - 1:
            raise AssertionError(f"26b: {metrics} launches {launches}")
        note("26b fused chain", dt, launches, got)

        # --- 26c: int16 wire, no debug ports, int8 soft (and a subprocess)
        scale = float(np.abs(block.view(np.float32)).max()) / 32000.0
        w16 = np.round(block.view(np.float32) / scale).astype(np.int16)
        cap16 = os.path.join(tmp, "bank.ci16")
        with open(cap16, "wb") as f:
            for _ in range(n):
                f.write(w16.tobytes())
        argv_c = ["demod-batch", "--in", cap16, *common, "--pipeline",
                  "full", "--in-format", "ci16", "--in-scale", repr(scale),
                  "--no-debug-ports", "--soft-i8"]
        pc = os.path.join(tmp, "c")
        metrics, launches, dt = run_cli(torch, argv_c + ["--out-prefix", pc])
        if min(launches.get("demod_full_tm", 0),
               launches.get("demod_full_tm[int16]", 0)) < n - 1:
            raise AssertionError(f"26c: launches {launches}")
        note("26c int16 wire", dt, launches)
        res["26c"] = files_equal("26c", pc, engine_files(
            torch, dev, cfg, np.tile(w16, (n, 1)), n, scale=scale,
            debug=False, soft_i8=True))
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        ps = os.path.join(tmp, "s")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "psk_soft_tpu_torch",
                               *argv_c, "--out-prefix", ps], cwd=root,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"26c subprocess: {proc.stderr[-2000:]}")
        for ext in (".soft.cf32", ".bits.i16"):
            if open(ps + ext, "rb").read() != open(pc + ext, "rb").read():
                raise AssertionError(f"26c: the subprocess's {ext} differs")
        note("26c as python -m psk_soft_tpu_torch", sub_s, {})

        # --- 26d: --fec-stream k7 against StreamFecDecoder in-process
        pd = os.path.join(tmp, "d")
        metrics, launches, dt = run_cli(torch, [
            "demod-batch", "--in", cap, "--out-prefix", pd, *common,
            "--pipeline", "full", "--fec-stream", "k7"])
        if min(launches.get("viterbi_acs", 0),
               launches.get("viterbi_traceback", 0)) < 1:
            raise AssertionError(f"26d: launches {launches}")
        soft = np.fromfile(pd + ".soft.cf32", np.complex64).reshape(-1, C).T
        dec = StreamFecDecoder(C, code=CODE_K7, m=4, device=dev)
        dec.observe(np.ascontiguousarray(soft))
        dec.finalize()
        want = dec.pop_bits()
        got_bits = np.fromfile(pd + ".fecstream.i8", np.int8).reshape(-1, C)
        if metrics["fec_stream_bits"] != want.shape[1] or not np.array_equal(
                got_bits.T, want):
            raise AssertionError("26d: .fecstream.i8 differs from "
                                 "StreamFecDecoder over the soft port")
        note("26d fec stream", dt, launches, fec_stream_bits=want.shape[1])

        # --- 26e: AGC + carrier acquisition + quality report on an offset
        freq = CLI_CFO[0] + CLI_CFO[1] * np.arange(C) / C
        t = np.arange(n * need, dtype=np.float64)[:, None]
        rot = np.exp(2j * np.pi * ((t * freq[None, :]) % 1.0))
        cfo_cap = os.path.join(tmp, "cfo.cf32")
        (wire * rot.astype(np.complex64)).tofile(cfo_cap)
        del rot, t
        pe, qpath = os.path.join(tmp, "e"), os.path.join(tmp, "q.json")
        metrics, launches, dt = run_cli(torch, [
            "demod-batch", "--in", cfo_cap, "--out-prefix", pe, *common,
            "--pipeline", "full", "--agc", "--acquire-cfo",
            "--quality-report", qpath, *frame_flags])
        frames_e = read_frames(pe + ".frames.jsonl")
        got = gate_planted("26e", frames_e, starts, infos, n, fmt.frame_len)
        q = json.loads(open(qpath).read())
        if sorted(q) != ["amp", "evm_pct", "lock", "power", "snr_db",
                         "symbols"] or any(len(v) != C for v in q.values()) \
                or min(q["symbols"]) <= 0 or min(q["lock"]) < 0.8:
            raise AssertionError(f"26e: quality report {str(q)[:300]}")
        note("26e front ends", dt, launches, got,
             min_lock=min(q["lock"]), min_snr_db=min(q["snr_db"]))
        del wire

        # --- 26f: demod, one long stream ff and two blocks exact
        from psk_soft_tpu_torch.testing.signals import gen_psk_channel
        xs, _ = gen_psk_channel(DEMOD_SAMPLES // SPS, sps=SPS, m=4,
                                snr_db=20.0, freq_offset=1e-4, seed=26)
        xs = xs.astype(np.complex64)
        for pipe, nsamp in (("ff", DEMOD_SAMPLES),
                            ("exact", DEMOD_EXACT_BLOCKS * need)):
            one = os.path.join(tmp, f"one_{pipe}.cf32")
            xs[:nsamp].tofile(one)
            pf = os.path.join(tmp, f"f_{pipe}")
            metrics, launches, dt = run_cli(torch, [
                "demod", "--in", one, "--out-prefix", pf, "--sps", str(SPS),
                "-M", "4", "--num-avg", str(NUM_AVG), "--phase-avg",
                str(PHASE_AVG), "--block-symbols", str(S), "--pipeline",
                pipe, "--device", str(dev)])
            eng = StreamEngine(cfg, block_symbols=S, pipeline=pipe,
                               device=dev)
            ref = eng.process(Packet(data=xs[:nsamp], sri=SRI(
                stream_id="cli", xdelta=1.0, mode=1), t=0.0, eos=True))
            errs = {}
            for port, ext, dt_ in ((PORT_SOFT, ".soft.cf32", np.complex64),
                                   (PORT_BITS, ".bits.i16", np.int16),
                                   (PORT_PHASE, ".phase.f32", np.float32),
                                   (PORT_SAMPLE_INDEX, ".index.i16",
                                    np.int16)):
                a = np.fromfile(pf + ext, dt_)
                b = np.asarray(ref[port].data, dt_).reshape(-1)
                if a.shape != b.shape:
                    raise AssertionError(f"26f {pipe}: {ext} {a.shape} vs "
                                         f"{b.shape}")
                if dt_ is np.int16:
                    if not np.array_equal(a, b):
                        raise AssertionError(f"26f {pipe}: {ext} differs")
                else:
                    errs[ext] = float(np.abs(a - b).max())
            if errs[".soft.cf32"] > 1e-5 or errs[".phase.f32"] > 1e-4 or \
                    metrics["samples_in"] != nsamp:
                raise AssertionError(f"26f {pipe}: {errs} {metrics}")
            note(f"26f demod {pipe}", dt, launches, samples=nsamp,
                 max_err=errs)
            res[f"26f_{pipe}"] = errs
    res["runs"] = runs
    res["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"phase": "cli_demod", "seconds": res["seconds"],
                    "file_errors": {k: v for k, v in res.items()
                                    if k not in ("runs", "seconds")},
                    "in_process_rates": rates, "card": card}))
    return res


# --- phase 27: the sharding layer (ROADMAP A.11) ----------------------------

C5 = 4096                     # BASELINE config 5's channels (full size)
C5_SYMBOLS = 1024             # 27a: its symbols a channel
C5_SOFT_TOL = 1e-3            # its gate (eval/baseline_configs.py)
SHARD_MESHES = ((1, 1), (2, 4), (4, 2), (1, 8))      # 27a: (chan, time)
CHAN_SHARDS = (1, 2, 4)       # 27b: chan shards of the one card
TIME_MESHES = ((1, 4), (2, 2), (2, 4))               # 27c
TIME_SYMBOLS = 2048           # 27c: symbols a channel
ROT_TOL = 5e-3                # 27c: tests/test_time_sharded_full.py
I8_SCALE = 100.0              # 27c: int8 soft scale
WB_TIME = 4                   # 27d: time shards of the channelizer
SCALING_COUNTS = (1, 2, 4)    # 27g: shards of the one card
DRYRUN_SHARDS = 8             # 27h

DIST_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import chip_smoke
from psk_soft_tpu_torch.config import DemodConfig
from psk_soft_tpu_torch.parallel import launch
from psk_soft_tpu_torch.runtime.distributed import DistributedBatchEngine
from psk_soft_tpu_torch.runtime.streams import SRI

launch.initialize(backend="gloo")    # PSK_COORDINATOR etc.; one card
rank = torch.distributed.get_rank()
mesh = launch.global_mesh(devices=[sys.argv[3]])
cfg = DemodConfig(sps=8, num_avg=100, constellation_size=4, phase_avg=50)
n_sym, seed, device, n_ch = sys.argv[1:5]
x = chip_smoke.c5_signal(torch, device, int(n_ch), int(n_sym), int(seed))
eng = DistributedBatchEngine(cfg, int(n_ch), mesh=mesh,
                             block_symbols=chip_smoke.S)
eng.set_input_sri(SRI(stream_id="dist", xdelta=1e-6))
lo, n = eng.local_offset, eng.channels
pkts = chip_smoke.drive_bank(eng, x[lo:lo + n].cpu().numpy())
out = {"lo": lo, "n": n}
for i, d in enumerate(pkts):
    for port, p in (d or {}).items():
        out[f"{i}:{port}"] = p.data
        out[f"{i}:{port}:t"] = np.float64(p.t)
        out[f"{i}:{port}:eos"] = np.bool_(p.eos)
np.savez(os.path.join(os.environ["PSK_OUT"], f"dist_{rank}.npz"), **out)
torch.distributed.destroy_process_group()
print("DONE", flush=True)
"""


def c5_signal(torch, dev, n_ch: int, n_sym: int, seed: int, m=4,
              diff=False, pulse=None):
    """(n_ch, n_sym*SPS) complex64 made on ``dev`` from ``seed`` (the same
    values in every process): M-PSK impulses on intra-symbol sample 3
    (timing-decisive), a 1e-4 cycles/sample offset, noise of std 0.01 on
    each part (config 5's and tests/test_time_sharded_full.py's signal).
    ``m`` and ``diff`` may be (n_ch,) tensors (a mixed bank); ``pulse``
    (odd-length taps) shapes the impulses, centred as gen_psk_channel's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m_t = torch.as_tensor(m, device=dev).reshape(-1, 1).double()
    k = torch.floor(torch.rand((n_ch, n_sym), generator=g, device=dev,
                               dtype=torch.float64) * m_t)
    ang = 2 * np.pi * k / m_t
    d = torch.as_tensor(diff, device=dev).reshape(-1, 1)
    ang = torch.where(d, torch.cumsum(ang, dim=1), ang)
    ang = ang + 2 * np.pi * 1e-4 * SPS * torch.arange(n_sym, device=dev)
    x = torch.zeros((n_ch, n_sym, SPS), dtype=torch.complex64, device=dev)
    x[:, :, 3] = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    x = x.reshape(n_ch, -1)
    if pulse is not None:
        taps = torch.as_tensor(np.asarray(pulse, np.float32), device=dev)
        conv = lambda v: torch.nn.functional.conv1d(      # noqa: E731
            v[:, None], taps.flip(0)[None, None],
            padding=taps.numel() // 2)[:, 0]           # np.convolve "same"
        x = torch.complex(conv(x.real.contiguous()),
                          conv(x.imag.contiguous()))
    noise = torch.randn((2, n_ch, n_sym * SPS), generator=g, device=dev)
    return x + 0.01 * torch.complex(noise[0], noise[1])


def drive_bank(eng, x: np.ndarray) -> list:
    """Push (C, T) samples into a bank engine a block at a time with
    step_packets, then flush_packets: the packet dicts in order."""
    need = S * SPS
    pkts = []
    for pos in range(0, x.shape[1] - need + 1, need):
        eng.push_block(x[:, pos:pos + need])
        pkts.append(eng.step_packets())
    eng.push_block(x[:, x.shape[1] - x.shape[1] % need:])
    pkts.append(eng.flush_packets())
    return pkts


def mesh_of(dev, chan: int, time_: int):
    """A chan x time mesh of shards of the one card."""
    from psk_soft_tpu_torch.parallel.mesh import make_mesh, shard_devices

    return make_mesh(chan, time_, shard_devices(dev, chan * time_))


def host_ms(torch, fn, reps: int = 3) -> float:
    """Best host-clock ms of ``fn()`` over ``reps`` runs, the card synced
    before and after each."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def c5_cfg(**kw):
    from psk_soft_tpu_torch.config import DemodConfig

    return DemodConfig(**dict(dict(sps=SPS, num_avg=NUM_AVG,
                                   constellation_size=4,
                                   phase_avg=PHASE_AVG), **kw))


def sharded_demod_phase(torch, dev, card) -> dict:
    """27a: make_sharded_demod (plain torch, seams by collectives between
    shard threads) at 4096 x 1024 symbols on SHARD_MESHES of the card:
    each equal to the single-device ff on the card under config 5's gate
    (valid counts equal, bits equal on valid, soft within 1e-3); the (2, 4)
    run's first CPU_C channels equal a CPU run on a CPU mesh (bits and
    sample index equal, soft within 1e-3); ms a call beside the ff's."""
    from psk_soft_tpu_torch.models.blockpsk import ff_init, make_ff_demod_fn
    from psk_soft_tpu_torch.parallel.sharded import make_sharded_demod

    cfg = c5_cfg()
    x = c5_signal(torch, dev, C5, C5_SYMBOLS, 271)
    ff = make_ff_demod_fn(cfg, channels=C5)
    _, ref = ff(ff_init(cfg, C5, dev), x)
    ff_ms = host_ms(torch, lambda: ff(ff_init(cfg, C5, dev), x))
    v1 = ref.valid
    n_valid = C5 * (C5_SYMBOLS - NUM_AVG + 1)
    res, keep = {}, None
    for chan, time_ in SHARD_MESHES:
        run = make_sharded_demod(cfg, mesh_of(dev, chan, time_), C5_SYMBOLS)
        out = run(x)
        v2 = out.valid
        if not int(v1.sum()) == int(v2.sum()) == n_valid:
            raise AssertionError(f"27a {chan}x{time_}: valid counts "
                                 f"{int(v1.sum())}, {int(v2.sum())}")
        if not torch.equal(out.bits[v2], ref.bits[v1]):
            raise AssertionError(f"27a {chan}x{time_}: bits differ")
        err = float((out.soft[v2] - ref.soft[v1]).abs().max())
        if not err < C5_SOFT_TOL:
            raise AssertionError(f"27a {chan}x{time_}: soft {err}")
        ms = host_ms(torch, lambda: run(x))
        res[f"{chan}x{time_}"] = dict(ms=ms, soft_max_err=err,
                                      samples_per_s=C5 * C5_SYMBOLS * SPS
                                      / (ms * 1e-3))
        if (chan, time_) == (2, 4):
            keep = out
    from psk_soft_tpu_torch.parallel.mesh import make_mesh

    cpu = make_sharded_demod(cfg, make_mesh(2, 4, ["cpu"] * 8), C5_SYMBOLS)(
        x[:CPU_C].cpu())
    v = cpu.valid
    if not (torch.equal(keep.valid[:CPU_C].cpu(), v)
            and torch.equal(keep.bits[:CPU_C].cpu()[v], cpu.bits[v])
            and torch.equal(keep.sample_index[:CPU_C].cpu()[v],
                            cpu.sample_index[v])):
        raise AssertionError("27a: card and CPU differ")
    cpu_err = float((keep.soft[:CPU_C].cpu()[v] - cpu.soft[v]).abs().max())
    if not cpu_err < C5_SOFT_TOL:
        raise AssertionError(f"27a: card vs CPU soft {cpu_err}")
    log(json.dumps({"phase": "sharded_demod", "channels": C5,
                    "symbols": C5_SYMBOLS, "meshes": res,
                    "single_device_ff_ms": ff_ms,
                    "single_device_samples_per_s": C5 * C5_SYMBOLS * SPS
                    / (ff_ms * 1e-3),
                    "cpu_soft_max_err": cpu_err,
                    "shards_share_one_card": True, "card": card}))
    return res


def sharded_full_phase(torch, dev, card) -> dict:
    """27b: make_sharded_full_demod over CHAN_SHARDS chan shards of the
    card, after ff warm-up and full_from_ff, 1 + STEADY_BLOCKS blocks of S
    symbols at 4096 channels: every output and the final carry equal
    (torch.equal) to single-device demod_block_full, every B1 launch held
    by B1Gate, B1 launched shards x blocks times; ms a block beside the
    single device's."""
    from psk_soft_tpu_torch.models.blockpsk import ff_init, make_ff_demod_fn
    from psk_soft_tpu_torch.models.full import demod_block_full, full_from_ff
    from psk_soft_tpu_torch.ops.cuda import demod_kernel
    from psk_soft_tpu_torch.parallel.mesh import unshard
    from psk_soft_tpu_torch.parallel.sharded_full import (
        make_sharded_full_demod, shard_full_state)

    cfg = c5_cfg()
    need = S * SPS
    x = c5_signal(torch, dev, C5, (1 + STEADY_BLOCKS) * S, 272)
    st_ff, _ = make_ff_demod_fn(cfg, channels=C5)(ff_init(cfg, C5, dev),
                                                   x[:, :need])
    state0 = full_from_ff(cfg, st_ff)
    blocks = [(x[:, b * need:(b + 1) * need].real.T.contiguous(),
               x[:, b * need:(b + 1) * need].imag.T.contiguous())
              for b in range(1, 1 + STEADY_BLOCKS)]
    del x

    def single():
        st, outs = state0, []
        for re, im in blocks:
            st, out = demod_block_full(cfg, st, re, im)
            outs.append(out)
        return st, outs

    ref_st, ref = single()
    single_ms = host_ms(torch, single) / STEADY_BLOCKS
    res = {}
    for n in CHAN_SHARDS:
        mesh = mesh_of(dev, n, 1)
        fn = make_sharded_full_demod(cfg, mesh)

        def run():
            st, outs = shard_full_state(state0, mesh), []
            for re, im in blocks:
                st, out = fn(st, re, im)
                outs.append(out)
            return st, outs

        demod_kernel.demod_full_tm.launches = 0
        with B1Gate(f"27b chan {n}") as gate:
            st, outs = run()
            torch.cuda.synchronize()
        launches = demod_kernel.demod_full_tm.launches
        if launches != n * STEADY_BLOCKS:
            raise AssertionError(f"27b chan {n}: B1 launched {launches} "
                                 f"times for {n} shards x {STEADY_BLOCKS}")
        for b, (o, r) in enumerate(zip(outs, ref)):
            for name, a, w in zip(o._fields, o, r):
                if not torch.equal(unshard(a), w):
                    raise AssertionError(f"27b chan {n} block {b}: {name} "
                                         f"differs from one device")
        for name, a, w in zip(st._fields, st, ref_st):
            if not torch.equal(unshard(a), w):
                raise AssertionError(f"27b chan {n}: carry {name} differs")
        ms = host_ms(torch, run) / STEADY_BLOCKS
        res[n] = dict(launches=launches, ms_per_block=ms,
                      samples_per_s=need * C5 / (ms * 1e-3),
                      b1_gate=dict(gate.stats))
    log(json.dumps({"phase": "sharded_full", "channels": C5,
                    "blocks": STEADY_BLOCKS, "chan_shards": res,
                    "single_device_ms_per_block": single_ms,
                    "single_device_samples_per_s": need * C5
                    / (single_ms * 1e-3),
                    "shards_share_one_card": True, "card": card}))
    return res


def interp_margins(torch, cfg, x):
    """(C, S) float64: for each stream symbol of the feed-forward pipeline
    under a matched filter and timing_interp, the fraction of its window
    sums' total that moves the centroid across a rounding edge (B1Gate's
    near-tie measure, INTERP_TIE), from the filtered samples in float64 as
    the feed-forward pipeline filters them (a zero tail: a lag of ntaps-1
    samples)."""
    from psk_soft_tpu_torch.ops.matched_filter import filter_taps

    taps = torch.as_tensor(filter_taps(cfg), dtype=torch.float64,
                           device=x.device)
    n_ch, sps, na = x.shape[0], cfg.sps, cfg.num_avg
    lag = taps.numel() - 1

    def fir(v):
        v = torch.nn.functional.pad(v.double()[:, None], (lag, 0))
        return torch.nn.functional.conv1d(v, taps[None, None])[:, 0]

    e = fir(x.real) ** 2 + fir(x.imag) ** 2
    e = e.reshape(n_ch, -1, sps)
    cs = torch.cat([torch.zeros_like(e[:, :1]), e.cumsum(1)], dim=1)
    w = cs[:, na:] - cs[:, :-na]                        # (C, S-na+1, sps)
    ang = torch.arange(sps, dtype=torch.float64, device=x.device) * (
        2 * np.pi / sps)
    zr, zi = (w * torch.cos(ang)).sum(-1), (w * torch.sin(ang)).sum(-1)
    pos = torch.atan2(zi, zr) * (sps / (2 * np.pi))
    pos = torch.where(pos < -0.5, pos + sps, pos)
    total = w.sum(-1)
    gap = ((pos - torch.floor(pos) - 0.5).abs() * (2 * np.pi / sps)
           * torch.hypot(zr, zi)
           / torch.where(total > 0, total, torch.ones_like(total)))
    return torch.nn.functional.pad(gap, (0, na - 1), value=1.0)


def time_profiles(torch, dev):
    """27c's profiles: (name, cfg, keywords of the factory, (C, T) samples,
    reference (soft, index, bits-or-None, near-tie margins or None)
    re-indexed to stream symbols, M for the rotation check or None for a
    direct one)."""
    from psk_soft_tpu_torch.models.blockpsk import ff_init, make_ff_demod_fn
    from psk_soft_tpu_torch.models.mixed import (MixedParams,
                                                 make_mixed_demod_fn,
                                                 mixed_init)
    from psk_soft_tpu_torch.ops.matched_filter import rrc_taps

    def reindex(cfg, out, x):
        a1 = cfg.num_avg - 1
        soft = torch.zeros((C5, TIME_SYMBOLS), dtype=torch.complex64,
                           device=dev)
        idx = torch.zeros((C5, TIME_SYMBOLS), dtype=torch.int32,
                          device=dev)
        soft[:, :TIME_SYMBOLS - a1] = out.soft[:, a1:]
        idx[:, :TIME_SYMBOLS - a1] = out.sample_index[:, a1:]
        bits, margins = None, None
        if cfg.timing_interp:
            margins = interp_margins(torch, cfg, x)
        if out.bits is not None:
            b = out.bits[:, a1:].int()
            bits = torch.zeros((C5, TIME_SYMBOLS), dtype=torch.int32,
                               device=dev)
            bits[:, :TIME_SYMBOLS - a1] = b[..., 0] + 2 * b[..., 1] \
                + 4 * b[..., 2]
        return soft, idx, bits, margins

    def ff_ref(cfg, x):
        _, out = make_ff_demod_fn(cfg, channels=C5)(ff_init(cfg, C5, dev), x)
        return reindex(cfg, out, x)

    profs = []
    for name, m, diff, seed in (("qpsk", 4, False, 2731),
                                ("8psk", 8, False, 2732),
                                ("qpsk_diff", 4, True, 2733)):
        cfg = c5_cfg(constellation_size=m, differential=diff)
        x = c5_signal(torch, dev, C5, TIME_SYMBOLS, seed, m=m, diff=diff)
        profs.append((name, cfg, {}, x, ff_ref(cfg, x), m))
    cfg3 = c5_cfg(num_avg=50, constellation_size=8, phase_avg=40,
                  matched_filter="rrc", rrc_beta=0.35, rrc_span=8,
                  timing_interp=True)
    x = c5_signal(torch, dev, C5, TIME_SYMBOLS, 2734, m=8,
                  pulse=rrc_taps(SPS, 0.35, 8))
    profs.append(("config3", cfg3, {}, x, ff_ref(cfg3, x), 8))
    cfg4 = c5_cfg(num_avg=50, phase_avg=20)
    rng = np.random.default_rng(2735)
    ms = rng.choice([2, 4, 8], C5)
    diffs = rng.random(C5) < 0.5
    x = c5_signal(torch, dev, C5, TIME_SYMBOLS, 2735,
                  m=torch.as_tensor(ms), diff=torch.as_tensor(diffs))
    params = MixedParams.make(ms, diffs, dev)
    _, out = make_mixed_demod_fn(cfg4)(params, mixed_init(cfg4, C5, dev), x)
    profs.append(("mixed", cfg4, dict(mixed_params=params), x,
                  reindex(cfg4, out, x), None))
    x = c5_signal(torch, dev, C5, TIME_SYMBOLS, 2736)
    profs.append(("int16_int8", c5_cfg(), {}, x, None, 4))
    return profs


def check_time_sharded(torch, what, outs, ref, m):
    """tests/test_time_sharded_full.py's rule: sample index equal on
    valid (under timing_interp, apart from near ties: INTERP_TIE),
    soft after the best M-fold rotation within ROT_TOL (M None: no
    rotation, and the reference's bits equal), bits re-derived from soft.
    Returns (soft error, near-tie index differences)."""
    from psk_soft_tpu_torch.ops import slicers

    soft_re, soft_im, _, packed, idx, valid = outs
    soft = torch.complex(soft_re, soft_im).T
    valid = valid.T
    ref_soft, ref_idx, ref_bits, margins = ref
    if not (bool(valid.any()) and bool((~valid).any())):
        raise AssertionError(f"{what}: valid mask {int(valid.sum())}")
    differ = (idx.T != ref_idx) & valid
    ties = int(differ.sum())
    if ties and (margins is None
                 or float(margins[differ].max()) >= INTERP_TIE):
        raise AssertionError(f"{what}: sample index differs at {ties}")
    if m is None:
        err = float((soft[valid] - ref_soft[valid]).abs().max())
        if not torch.equal(packed.T[valid], ref_bits[valid]):
            raise AssertionError(f"{what}: bits differ from the reference")
    else:
        err = min(float((soft[valid] * np.exp(2j * np.pi * r / m)
                         - ref_soft[valid]).abs().max()) for r in range(m))
        b = slicers.slice_bits(m, soft[valid]).int()
        if not torch.equal(packed.T[valid], b[:, 0] + 2 * b[:, 1]
                           + 4 * b[:, 2]):
            raise AssertionError(f"{what}: bits do not re-derive from soft")
    if not err < ROT_TOL:
        raise AssertionError(f"{what}: soft {err}")
    return err, ties


def time_sharded_phase(torch, dev, card) -> dict:
    """27c: make_time_sharded_full_demod at 4096 x 2048 on TIME_MESHES of
    the card, in six profiles (QPSK, 8-PSK and differential QPSK at config
    5's widths; config 3's RRC filter + timing_interp; mixed at config 4's
    widths; int16 planes in, int8 soft out): each against the single-device
    ff (mixed: the mixed pipeline; int16: the float32 run on the
    dequantized planes), every B1 launch held by B1Gate, B1 once a shard a
    call; ms a call."""
    from psk_soft_tpu_torch.ops.cuda import demod_kernel
    from psk_soft_tpu_torch.parallel.sharded_full import \
        make_time_sharded_full_demod

    res = {}
    for name, cfg, kw, x, ref, m in time_profiles(torch, dev):
        re, im = x.real.T.contiguous(), x.imag.T.contiguous()
        del x
        if name == "int16_int8":
            scale = float(torch.maximum(re.abs().max(), im.abs().max())
                          ) / 32000.0
            re16 = torch.round(re / scale).to(torch.int16)
            im16 = torch.round(im / scale).to(torch.int16)
            re, im = re16.float() * scale, im16.float() * scale
        for chan, time_ in TIME_MESHES:
            what = f"27c {name} {chan}x{time_}"
            mesh = mesh_of(dev, chan, time_)
            run = make_time_sharded_full_demod(cfg, mesh, TIME_SYMBOLS, **kw)
            if name == "int16_int8":
                run8 = make_time_sharded_full_demod(
                    cfg, mesh, TIME_SYMBOLS, in_scale=scale,
                    soft_i8_scale=I8_SCALE)
                o32 = run(re, im)
                args, main = (re16, im16), run8
            else:
                args, main = (re, im), run
            for k in demod_kernel.demod_full_tm.mode_launches:
                demod_kernel.demod_full_tm.mode_launches[k] = 0
            demod_kernel.demod_full_tm.launches = 0
            with B1Gate(what) as gate:
                outs = main(*args)
                torch.cuda.synchronize()
            launches = demod_kernel.demod_full_tm.launches
            modes = {k: v for k, v in
                     demod_kernel.demod_full_tm.mode_launches.items() if v}
            if launches != chan * time_:
                raise AssertionError(f"{what}: B1 launched {launches} times "
                                     f"on {chan * time_} shards")
            if name == "int16_int8":
                valid = outs[5]
                if not (torch.equal(valid, o32[5])
                        and torch.equal(outs[3][valid], o32[3][valid])
                        and torch.equal(outs[4][valid], o32[4][valid])
                        and outs[0].dtype == torch.int8):
                    raise AssertionError(f"{what}: differs from float32")
                err = max(float((q.float() / I8_SCALE
                                 - f.clamp(-1.27, 1.27)).abs()[valid].max())
                          for q, f in ((outs[0], o32[0]),
                                       (outs[1], o32[1])))
                if not err <= 0.5 / I8_SCALE + 1e-6:
                    raise AssertionError(f"{what}: int8 soft {err}")
                if modes.get("int16") != launches:
                    raise AssertionError(f"{what}: int16 launches {modes}")
                ties = 0
            else:
                err, ties = check_time_sharded(torch, what, outs, ref, m)
            ms = host_ms(torch, lambda: main(*args))
            res[f"{name} {chan}x{time_}"] = dict(
                launches=launches, modes=modes, soft_err=err, ms=ms,
                samples_per_s=C5 * TIME_SYMBOLS * SPS / (ms * 1e-3),
                b1_near_ties=gate.stats["index_differ"],
                b1_padding_outputs=gate.stats.get("padding_outputs", 0),
                ff_near_ties=ties)
    log(json.dumps({"phase": "time_sharded_full", "channels": C5,
                    "symbols": TIME_SYMBOLS, "runs": res,
                    "shards_share_one_card": True, "card": card}))
    return res


def sharded_channelize_phase(torch, dev, card) -> dict:
    """27d: make_sharded_channelize on a block of phase 24a's capture (C
    channels, WB_K taps a branch), rows over WB_TIME time shards of the
    card, within WB_TOL of channelize_block with a zero carry."""
    from psk_soft_tpu_torch.ops import channelizer as ch
    from psk_soft_tpu_torch.parallel.wideband import make_sharded_channelize

    noise = tuple(CPU_C + (C - CPU_C) * k // 4 + 7 for k in range(4))
    z = torch.from_numpy(wideband_capture(np.random.default_rng(IN_SEED), 1,
                                          noise)[0]).to(dev)
    taps = ch.prototype_taps(C, WB_K)
    _, ref = ch.channelize_block(torch.from_numpy(taps).to(dev),
                                 ch.channelizer_init(C, WB_K, dev), z)
    run = make_sharded_channelize(taps, C, mesh_of(dev, 1, WB_TIME))
    y = run(z.reshape(-1, C))
    err = float((y - ref).abs().max())
    if not err <= WB_TOL:
        raise AssertionError(f"27d: sharded channelizer {err}")
    ms = host_ms(torch, lambda: run(z.reshape(-1, C)))
    log(json.dumps({"phase": "sharded_channelize", "channels": C,
                    "rows": int(y.shape[0]), "time_shards": WB_TIME,
                    "max_err": err, "ms": ms, "card": card}))
    return dict(max_err=err, ms=ms)


def distributed_phase(torch, dev, card, backend: str = "nccl") -> dict:
    """27e: DistributedBatchEngine at 4096 channels, 1 + STEADY_BLOCKS
    blocks and a flush: in this process in a world-size-1 NCCL group, and
    as two processes over gloo on the card (2048 channels each); the
    packets of both equal to BatchEngine on the card (the NCCL run exactly;
    the two processes' halves bits and sample index equal, soft and phase
    within 1e-5, timestamps and EOS equal)."""
    import os
    import socket
    import tempfile

    from psk_soft_tpu_torch.parallel import launch
    from psk_soft_tpu_torch.runtime.distributed import DistributedBatchEngine
    from psk_soft_tpu_torch.runtime.engine_batch import BatchEngine
    from psk_soft_tpu_torch.runtime.streams import (PORT_BITS,
                                                    PORT_SAMPLE_INDEX, SRI)

    cfg = c5_cfg()
    n_sym = (1 + STEADY_BLOCKS) * S + S // 2
    x = c5_signal(torch, dev, C5, n_sym, 275).cpu().numpy()

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PSK_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    script = os.path.join(tmp.name, "worker.py")
    with open(script, "w") as f:
        f.write(DIST_WORKER)
    t0 = time.perf_counter()
    worker_dev = "cuda:0" if torch.device(dev).type == "cuda" else "cpu"
    procs = [subprocess.Popen(
        [sys.executable, script, str(n_sym), "275", worker_dev, str(C5)],
        cwd=root,
        env=dict(env, PSK_OUT=tmp.name, PSK_COORDINATOR=f"localhost:{port}",
                 PSK_NUM_PROCESSES="2", PSK_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]

    def bank(eng):
        eng.set_input_sri(SRI(stream_id="dist", xdelta=1e-6))
        return drive_bank(eng, x)

    try:
        ref = bank(BatchEngine(cfg, C5, block_symbols=S, device=dev))
        launch.initialize(f"localhost:{free_port()}", 1, 0, backend=backend)
        try:
            one = torch.ones(1, device=worker_dev)
            torch.distributed.all_reduce(one)      # the group works
            mesh = launch.global_mesh(devices=[worker_dev])
            got = bank(DistributedBatchEngine(cfg, C5, mesh=mesh,
                                              block_symbols=S))
        finally:
            torch.distributed.destroy_process_group()
        if float(one) != 1.0:
            raise AssertionError(f"27e: all_reduce over one process {one}")
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if len(got) != len(ref):
        raise AssertionError("27e: NCCL run emitted another packet count")
    for i, (a, b) in enumerate(zip(got, ref)):
        for p in set(a or {}) | set(b or {}):
            if not (np.array_equal(a[p].data, b[p].data)
                    and (a[p].t, a[p].eos) == (b[p].t, b[p].eos)):
                raise AssertionError(f"27e: NCCL run #{i} {p} differs")
    worst = {"soft": 0.0, "phase": 0.0}
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "DONE" not in out:
            raise AssertionError(f"27e: worker {r} rc {p.returncode}: "
                                 f"{err[-3000:]}")
    two_s = time.perf_counter() - t0
    for r in range(2):
        z = np.load(os.path.join(tmp.name, f"dist_{r}.npz"))
        lo, n = int(z["lo"]), int(z["n"])
        if (lo, n) != (r * C5 // 2, C5 // 2):
            raise AssertionError(f"27e: worker {r} owns {lo}+{n}")
        for i, d in enumerate(ref):
            for port, pk in (d or {}).items():
                w = pk.data[lo:lo + n]
                g = z[f"{i}:{port}"]
                if float(z[f"{i}:{port}:t"]) != pk.t or \
                        bool(z[f"{i}:{port}:eos"]) != pk.eos or \
                        g.shape != w.shape:
                    raise AssertionError(f"27e: worker {r} #{i} {port}")
                if port in (PORT_BITS, PORT_SAMPLE_INDEX):
                    if not np.array_equal(g, w):
                        raise AssertionError(f"27e: worker {r} #{i} {port}")
                elif g.size:
                    k = "soft" if np.iscomplexobj(g) else "phase"
                    worst[k] = max(worst[k], float(np.abs(g - w).max()))
    tmp.cleanup()
    if max(worst.values()) > 1e-5:
        raise AssertionError(f"27e: two processes vs one: {worst}")
    log(json.dumps({"phase": "distributed_engine", "channels": C5,
                    "blocks": 1 + STEADY_BLOCKS, "nccl_world_1": "equal",
                    "gloo_two_processes": worst,
                    "two_process_seconds": two_s, "card": card}))
    return dict(worst=worst, two_process_seconds=two_s)


def config5_phase(torch, dev, card, cli) -> dict:
    """27f: run_config(5, quick=False) on the card (4096 channels, a 1 x 1
    mesh) and ``python -m psk_soft_tpu_torch baseline --config 5 --full``
    (started at the phase's start as ``cli``), each pass."""
    from psk_soft_tpu_torch.eval.baseline_configs import run_config

    t0 = time.perf_counter()
    r = run_config(5, quick=False, device=dev)
    dt = time.perf_counter() - t0
    out, err = cli.communicate(timeout=600)
    sub = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
    if not r["pass"] or r["channels"] != C5 or cli.returncode != 0 \
            or not sub.get("pass"):
        raise AssertionError(f"27f: config 5 {r}; CLI rc {cli.returncode} "
                             f"{out[-500:]} {err[-2000:]}")
    log(json.dumps({"phase": "config5", "result": r, "seconds": dt,
                    "cli": sub, "card": card}))
    return dict(result=r, seconds=dt)


def scaling_phase(torch, dev, card) -> dict:
    """27g: eval/scaling's three reports with SCALING_COUNTS shards of the
    one card (``shards_share_device``: the "efficiency" is the cost of
    sharding, not scaling), each path's ms a call and samples/s beside its
    single shard's; launches counted around each."""
    from psk_soft_tpu_torch.eval import scaling
    from psk_soft_tpu_torch.parallel.mesh import shard_devices

    cfg = c5_cfg()
    devs = shard_devices(dev, max(SCALING_COUNTS))
    runs = {
        "channel_ff": lambda: scaling.channel_scaling_report(
            cfg, device_counts=SCALING_COUNTS, channels_per_device=1024,
            symbols=S, iters=5, reps=3, devices=devs),
        "channel_full": lambda: scaling.channel_scaling_report(
            cfg, device_counts=SCALING_COUNTS, channels_per_device=1024,
            symbols=S, iters=5, reps=3, pipeline="full", devices=devs),
        "chain": lambda: scaling.chain_scaling_report(
            cfg, device_counts=SCALING_COUNTS, channels_per_device=1024,
            symbols=S, iters=3, reps=2, devices=devs),
        "time": lambda: scaling.time_shard_report(
            cfg, time_counts=SCALING_COUNTS, channels=C5,
            total_symbols=TIME_SYMBOLS, iters=5, reps=3, devices=devs)}
    res = {}
    for name, fn in runs.items():
        rep, counts, dt = counted(torch, fn)
        if not rep["shards_share_device"]:
            raise AssertionError(f"27g {name}: shards on separate devices")
        res[name] = dict(report=rep, launches=counts, seconds=dt)
        log(json.dumps({"phase": "scaling", "report": name,
                        "label": "shards of one card (sharding cost, not "
                                 "scaling)",
                        "points": [dict(p, ms=p["step_s"] * 1e3)
                                   for p in rep["points"]],
                        "launches": counts, "card": card}))
    return res


def dryrun_phase(torch, dev, card) -> dict:
    """27h: graft_entry.dryrun_multichip over DRYRUN_SHARDS shards of the
    card (every section's checks), launches counted."""
    from psk_soft_tpu_torch import graft_entry

    _, counts, dt = counted(torch, lambda: graft_entry.dryrun_multichip(
        DRYRUN_SHARDS, device=dev))
    log(json.dumps({"phase": "dryrun_multichip", "shards": DRYRUN_SHARDS,
                    "launches": counts, "seconds": dt, "card": card}))
    return counts


def sharding_phases(torch, dev, card) -> dict:
    """Phase 27 (27a-27h), with its total time."""
    import os

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cli = subprocess.Popen(
        [sys.executable, "-m", "psk_soft_tpu_torch", "baseline", "--config",
         "5", "--full"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=root + os.pathsep
                 + os.environ.get("PYTHONPATH", "")))
    try:
        res = {"demod": sharded_demod_phase(torch, dev, card),
               "full": sharded_full_phase(torch, dev, card),
               "time": time_sharded_phase(torch, dev, card),
               "channelize": sharded_channelize_phase(torch, dev, card),
               "distributed": distributed_phase(torch, dev, card),
               "config5": config5_phase(torch, dev, card, cli),
               "scaling": scaling_phase(torch, dev, card),
               "dryrun": dryrun_phase(torch, dev, card)}
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    res["seconds"] = time.perf_counter() - t0
    log(json.dumps({"phase": "sharding", "seconds": res["seconds"],
                    "card": card}))
    return res


# --- phase 28: the port's bench (tools/bench) on every mode -----------------

BENCH_ARGS = ["--iters", "5", "--reps", "2"]
# (name, flags, lines it prints, kernels its timed windows must launch)
BENCH_MODES = (
    ("default", [], 4, ("demod_full_tm", "viterbi_fused")),
    ("pipeline full i16 i8", ["--pipeline", "full", "--ingest", "i16",
                              "--soft", "i8"], 2,
     ("demod_full_tm", "demod_full_tm[int16]", "viterbi_fused")),
    ("pipeline ff", ["--pipeline", "ff"], 1, ()),
    ("pipeline exact", ["--pipeline", "exact"], 1, ()),
    ("pipeline fused", ["--pipeline", "fused"], 1, ("timing_frontend_tm",)),
    ("profile config3", ["--profile", "config3"], 1,
     ("demod_full_tm[matched_filter]", "demod_full_tm[timing_interp]")),
    ("profile mixed", ["--profile", "mixed"], 1, ("demod_full_tm[mixed]",)),
    ("profile chain", ["--profile", "chain"], 1,
     ("demod_full_tm", "viterbi_fused")),
    ("engine", ["--engine"], 2, ("demod_full_tm",)),
    ("engine i16 i8", ["--engine", "--ingest", "i16", "--soft", "i8"], 2,
     ("demod_full_tm[int16]",)),
    ("engine mixed", ["--engine", "--profile", "mixed"], 2,
     ("demod_full_tm[mixed]",)),
    ("receiver", ["--receiver"], 1, ("demod_full_tm", "viterbi_fused")),
    ("receiver fused", ["--receiver", "--receiver-fused"], 1,
     ("demod_full_tm", "viterbi_fused")),
    ("receiver frames-only", ["--receiver", "--receiver-frames-only"], 1,
     ("demod_full_tm", "viterbi_fused")),
    ("mesh", ["--mesh", "--profile", "chain"], 3,
     ("demod_full_tm", "viterbi_fused")),
)


def bench_phase(torch, dev, card) -> dict:
    """Phase 28: ``tools/bench.main`` in-process on every mode at
    BENCH_ARGS (the default run, each --pipeline, each --profile, the
    engines with int16 in and int8 soft out and the mixed bank, the three
    receivers, the scaling reports): each returns 0 having printed its
    lines, every line names the card, every line of a mode but the
    scaling reports carries its gate (the bench gates each path before
    timing it and raises on a failure), and the mode's timed windows
    launched its kernels.  Each mode's launches are counted around its
    whole run (warm-up and gate included).  Returns {mode: counts}."""
    import io

    from psk_soft_tpu_torch.ops.cuda import demod_kernel, frontend_kernel
    from psk_soft_tpu_torch.tools import bench

    t0 = time.perf_counter()
    wrappers = dict(kernel_counts(),
                    timing_frontend_tm=frontend_kernel.timing_frontend_tm)
    modes = demod_kernel.demod_full_tm.mode_launches
    res = {}
    for name, flags, n_lines, kernels in BENCH_MODES:
        for w in wrappers.values():
            w.launches = 0
        for k in modes:
            modes[k] = 0
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(flags + BENCH_ARGS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = {k: w.launches for k, w in wrappers.items()}
        counts.update({f"demod_full_tm[{k}]": v for k, v in modes.items()
                       if v})
        lines = [json.loads(r) for r in buf.getvalue().splitlines()]
        if rc != 0 or len(lines) != n_lines:
            raise AssertionError(f"28 {name}: rc {rc}, {len(lines)} lines "
                                 f"of {n_lines}")
        timed = {}
        for line in lines:
            if (line.get("card") != card
                    or line.get("device") != torch.device(dev).type):
                raise AssertionError(f"28 {name}: a line names "
                                     f"{line.get('card')}, not {card}")
            if "gate" not in line and not line["metric"].startswith(
                    "scaling report"):
                raise AssertionError(f"28 {name}: a line without its gate")
            for k, v in line["launches"].items():
                timed[k] = timed.get(k, 0) + v
            log(json.dumps({"phase": "bench", "mode": name,
                            **{k: v for k, v in line.items()
                               if k != "timing"}}))
        missing = [k for k in kernels if not timed.get(k)]
        if missing:
            raise AssertionError(f"28 {name}: {missing} not launched in the "
                                 f"timed windows ({timed})")
        res[name] = counts
        log(json.dumps({"phase": "bench_mode", "mode": name,
                        "argv": flags + BENCH_ARGS, "lines": len(lines),
                        "launches": counts, "seconds": seconds,
                        "card": card}))
    log(json.dumps({"phase": "bench_total",
                    "seconds": time.perf_counter() - t0, "card": card}))
    return res


CONF_C = (1024, 1002, 1001)   # 29a: B1's channels (16-, 8-, 4-byte rows)
CONF_B5_C = (1024, 1001)      # 29b: B5's
CONF_LOOP_C = 1024            # 29c: loopback channels (B2)
CONF_FEC_ROWS = 1024          # 29c: stream-FEC soak rows (B3 + B4)
CONF_FEC_SEEDS = (400,)       # 29c: of conformance.FEC_SOAK_SEEDS


def b1_mode(case: dict) -> str:
    """A B1 case's modes, as one word: f32 or i16 in, then the matched
    filter, timing_interp, int8 soft, no debug ports, unpacked outputs."""
    cfg = case["cfg"]
    parts = ["i16" if case["i16"] else "f32"]
    if cfg.get("matched_filter", "none") != "none":
        parts.append(cfg["matched_filter"])
    parts += [w for w, on in (("interp", cfg.get("timing_interp")),
                              ("i8", case["soft_i8"]),
                              ("nodebug", not case["debug_ports"]),
                              ("unpacked", case["pack_out"] is False)) if on]
    return "+".join(parts)


def conformance_b1(torch, dev, card) -> dict:
    """29a: kernel B1 against its plain version (B1Gate) at every
    full-kernel and format case of the JAX fuzz suites and the sps-2 case
    (testing/conformance.b1_cases), at CONF_C channels: the port's
    feed-forward warm-up on the card, full_from_ff, then two blocks (the
    second's window a view of the first's rows), with the case's options
    (int16 planes, int8 soft, debug ports off, pack_out off; RRC through
    stage 0, held with tied_bits).  One line a case and channel count with
    B1's launch plan."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk, full
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk
    from psk_soft_tpu_torch.testing import conformance as cf

    plans, plan_fn = [], dk.launch_plan

    def recording(*a, **k):
        plans.append(plan_fn(*a, **k))
        return plans[-1]

    res, combos = {}, {}
    dk.launch_plan = recording
    try:
        for case in cf.b1_cases():
            cfg = DemodConfig(**case["cfg"])
            sps, keep = cfg.sps, full.window_rows(cfg)
            warm_t, run_t = case["warm"] * sps, case["run"] * sps
            xs = cf.fuzz_signal(cfg, case["warm"] + 2 * case["run"],
                                max(CONF_C))
            scale = cf.FORMAT_SCALE if case["soft_i8"] else None
            for n_ch in CONF_C:
                x = torch.from_numpy(xs[:n_ch]).to(dev)
                fn = blockpsk.make_ff_demod_fn(cfg, channels=n_ch)
                st_ff, _ = fn(blockpsk.ff_init(cfg, n_ch, dev), x[:, :warm_t])
                raw_win = (x[:, warm_t - keep:warm_t]
                           if cfg.matched_filter != "none" else None)
                st = full.full_from_ff(cfg, st_ff, raw_win=raw_win)
                run = xs[:n_ch, warm_t:]
                in_scale = 1.0
                if case["i16"]:
                    in_scale, p_re, p_im = cf.int16_wire(run)
                    st = full.quantize_full_state(st, in_scale)
                else:
                    p_re = np.ascontiguousarray(run.real.T)
                    p_im = np.ascontiguousarray(run.imag.T)
                p_re = torch.from_numpy(p_re).to(dev)
                p_im = torch.from_numpy(p_im).to(dev)
                label = f"29a {case['name']} C {n_ch}"
                plans.clear()
                # Under the RRC filter at odd sps the pulse peaks half a
                # sample between two bins a symbol apart, so a near-tie
                # pick is another symbol: tied_bits.
                with B1Gate(label, tied_bits=raw_win is not None) as gate:
                    for b in range(2):
                        st, out = full.demod_block_full(
                            cfg, st, p_re[b * run_t:(b + 1) * run_t],
                            p_im[b * run_t:(b + 1) * run_t],
                            in_scale=in_scale, pack_out=case["pack_out"],
                            soft_i8_scale=scale,
                            debug_ports=case["debug_ports"])
                    torch.cuda.synchronize()
                if gate.stats["launches_checked"] != 2:
                    raise AssertionError(f"{label}: "
                                         f"{gate.stats['launches_checked']} "
                                         f"B1 launches held, not 2")
                plan = plans[0] if plans else None     # None off the card
                res[(case["name"], n_ch)] = gate.stats
                combo = (case["i16"], cfg.matched_filter != "none",
                         cfg.timing_interp)
                combos[combo] = combos.get(combo, 0) + 2
                log(json.dumps({
                    "phase": "conformance", "kernel": "B1",
                    "case": case["name"], "C": n_ch, "sps": sps,
                    "num_avg": cfg.num_avg, "phase_avg": cfg.phase_avg,
                    "M": cfg.constellation_size, "mode": b1_mode(case),
                    "plan": plan and {
                        "group": plan.timing.group,
                        "chunk": plan.timing.chunk, "vec": plan.timing.vec,
                        "track_chunk": plan.chunk,
                        "fir_vec": plan.fir.vec if plan.fir else None},
                    "result": "pass", "gate": gate.stats, "card": card}))
    finally:
        dk.launch_plan = plan_fn
    return dict(cases=res, combos=combos)


def conformance_b5(torch, dev, card) -> dict:
    """29b: kernel B5 against its plain version (check_b5) at each B1
    case's (sps, num_avg) on its signal, at CONF_B5_C channels; the window
    a view of the rows before the block, as an engine's carry is."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.ops.cuda import demod_kernel as dk
    from psk_soft_tpu_torch.testing import conformance as cf

    res = {}
    for case in cf.b1_cases():
        cfg = DemodConfig(**case["cfg"])
        sps, na = cfg.sps, cfg.num_avg
        t0, t1 = case["warm"] * sps, (case["warm"] + case["run"]) * sps
        xs = cf.fuzz_signal(cfg, case["warm"] + case["run"], max(CONF_B5_C))
        for n_ch in CONF_B5_C:
            re = torch.from_numpy(np.ascontiguousarray(
                xs[:n_ch].real.T)).to(dev)
            im = torch.from_numpy(np.ascontiguousarray(
                xs[:n_ch].imag.T)).to(dev)
            w0 = t0 - (na - 1) * sps
            planes = (re[w0:t0], im[w0:t0], re[t0:t1], im[t0:t1])
            plan = dk.timing_plan(n_ch, sps, dk.plane_align(*planes))
            label = f"29b {case['name']} C {n_ch}"
            got = check_b5(label, *planes, sps=sps, num_avg=na)
            res[(case["name"], n_ch)] = got
            log(json.dumps({
                "phase": "conformance", "kernel": "B5", "case": case["name"],
                "C": n_ch, "sps": sps, "num_avg": na,
                "phase_avg": cfg.phase_avg, "M": cfg.constellation_size,
                "mode": "f32", "plan": {"group": plan.group,
                                        "chunk": plan.chunk,
                                        "vec": plan.vec},
                "result": "pass", "gate": got, "card": card}))
    return res


def conformance_fec(torch, dev, card) -> dict:
    """29c: B2 through the bit-layer loopback of every case of
    tests/test_fuzz_bitlayer.py at CONF_LOOP_C channels (check_loopback;
    frames equal to the same stack on the CPU over the first CPU_C
    channels), and B3 + B4 through the stream-FEC soak scripts at K3 and
    K7 over CONF_FEC_ROWS rows, popped bits equal to the plain decoder's
    on the CPU fed the card's LLRs (check_fec_soak)."""
    from psk_soft_tpu_torch.ops import fec
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel as vk
    from psk_soft_tpu_torch.ops.framesync import FrameFormat
    from psk_soft_tpu_torch.runtime.crc import FrameCrcChecker
    from psk_soft_tpu_torch.runtime.fec import (FecFrameDecoder,
                                                StreamFecDecoder)
    from psk_soft_tpu_torch.runtime.framesync import FrameSyncer
    from psk_soft_tpu_torch.runtime.scramble import FrameDescrambler
    from psk_soft_tpu_torch.testing import conformance as cf

    stages = (FrameSyncer, FecFrameDecoder, FrameDescrambler,
              FrameCrcChecker)
    res = {}
    for case in cf.BITLAYER_CASES:
        m, payload, _, il_rows, labeling, _, _ = case
        code, lfsr, crc = cf.bitlayer_parts(case)
        uw, starts, infos, soft = cf.bitlayer_stream(case, CONF_LOOP_C)
        fmt = FrameFormat(uw=uw, payload=payload, m=m, threshold=0.6)
        runs = []
        for device, n_ch in ((dev, CONF_LOOP_C), ("cpu", CPU_C)):
            sync, top = cf.frame_stack(stages, n_ch, fmt, code, lfsr, crc,
                                       il_rows, labeling, device=device)
            before = vk.viterbi_fused.launches
            runs.append(cf.run_loopback(sync, top, soft[:n_ch]))
            torch.cuda.synchronize()
            if len(runs) == 1:
                launches = vk.viterbi_fused.launches - before
        label = f"29c loopback {cf.bitlayer_id(case)}"
        n = check_loopback(label, runs[0], starts, infos,
                           code is not None, crc is not None)
        frames_close(label, runs[0], runs[1], 1e-5, n_ch=CPU_C)
        if code is not None and torch.device(dev).type == "cuda" \
                and launches < 1:
            raise AssertionError(f"{label}: B2 not launched")
        plan = (vk.launch_plan(code.states, code.n, 64, CONF_LOOP_C, True)
                if code is not None else None)
        res[cf.bitlayer_id(case)] = dict(frames=n, viterbi_fused=launches)
        log(json.dumps({
            "phase": "conformance", "kernel": "B2", "case":
            cf.bitlayer_id(case), "C": CONF_LOOP_C, "M": m,
            "code": case[2], "mode": labeling,
            "plan": plan and {"lanes_per_row": plan.lanes_per_row,
                              "rows_per_warp": plan.rows_per_warp},
            "frames": n, "launches": launches, "result": "pass",
            "card": card}))

    llrs = fec.psk_llrs
    for k, code in ((3, fec.CODE_K3), (7, fec.CODE_K7)):
        for seed in CONF_FEC_SEEDS:
            script = cf.fec_soak_script(seed, CONF_FEC_ROWS)
            runs = []
            for device in (dev, "cpu"):
                if runs:                # the card's LLRs, on the CPU
                    fec.psk_llrs = lambda m, s, **kw: llrs(      # noqa: E731
                        m, s.to(dev), **kw).cpu()
                before = (vk.viterbi_acs.launches,
                          vk.viterbi_traceback.launches)
                try:
                    dec = StreamFecDecoder(
                        CONF_FEC_ROWS, code, m=4, depth=cf.FEC_SOAK_DEPTH,
                        block_steps=cf.FEC_SOAK_BLOCK, device=device)
                    runs.append(cf.run_fec_soak(dec, script))
                    torch.cuda.synchronize()
                finally:
                    fec.psk_llrs = llrs
                if len(runs) == 1:
                    counts = dict(
                        viterbi_acs=vk.viterbi_acs.launches - before[0],
                        viterbi_traceback=vk.viterbi_traceback.launches
                        - before[1])
            label = f"29c stream FEC K{k} seed {seed}"
            bits = check_fec_soak(label, *runs)
            if torch.device(dev).type == "cuda" and min(counts.values()) < 1:
                raise AssertionError(f"{label}: B3/B4 not launched {counts}")
            plan = vk.launch_plan(code.states, code.n, cf.FEC_SOAK_BLOCK,
                                  CONF_FEC_ROWS, False)
            res[f"stream K{k} {seed}"] = dict(bits=bits, **counts)
            log(json.dumps({
                "phase": "conformance", "kernel": "B3+B4",
                "case": f"stream-fec K{k} seed {seed}", "C": CONF_FEC_ROWS,
                "M": 4, "code": f"k{k}", "mode": "stream",
                "plan": {"lanes_per_row": plan.lanes_per_row,
                         "rows_per_warp": plan.rows_per_warp},
                "bits": bits, "launches": counts, "result": "pass",
                "card": card}))
    return res


def conformance_soaks(torch, dev, card) -> dict:
    """29d: the engine soaks of tests/test_soak.py as event scripts
    (testing/conformance): each stream script through StreamEngine, each
    batch script (at CPU_C channels) through BatchEngine and the
    FullKernelBatchEngine soak at its 128 channels (B1, held by
    B1Gate), on the card and on
    the CPU, packets held equal by compare_service (a differing sample
    pick only at a near tie: TieRecord of the card run) and the metrics
    equal."""
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.runtime import engine, streams
    from psk_soft_tpu_torch.testing import conformance as cf

    def stream(device, script):
        eng = engine.StreamEngine(DemodConfig(**cf.STREAM_SOAK_CFG),
                                  cf.STREAM_SOAK_BLOCK, device=device)
        return eng, cf.run_stream_script(eng, streams, DemodConfig, script)

    def batch(device, script):
        eng = engine.BatchEngine(DemodConfig(**cf.BATCH_SOAK_CFG), CPU_C,
                                 cf.BATCH_SOAK_BLOCK, device=device)
        eng.set_input_sri(streams.SRI(stream_id="bank", xdelta=0.01))
        return eng, cf.run_bank_script(eng, DemodConfig, script)

    def full_kernel(device, script):
        eng = engine.FullKernelBatchEngine(DemodConfig(**cf.FULL_SOAK_CFG),
                                           cf.FUZZ_C, cf.FULL_SOAK_BLOCK,
                                           device=device)
        eng.set_input_sri(streams.SRI(stream_id="fk", xdelta=0.01))
        return eng, cf.run_bank_script(eng, DemodConfig, script, drain=False)

    cases = ([(f"StreamEngine {s}", stream, cf.stream_soak_script(s), 2e-3)
              for s in cf.STREAM_SOAK_SEEDS]
             + [(f"BatchEngine {s}", batch, cf.batch_soak_script(s, CPU_C),
                 2e-3) for s in cf.BATCH_SOAK_SEEDS]
             + [("FullKernelBatchEngine", full_kernel,
                 cf.full_soak_script(), SOFT_TOL)])
    res = {}
    for name, run, script, soft_tol in cases:
        label = f"29d {name}"
        b1 = kernel_counts()["demod_full_tm"]
        before = b1.launches
        with B1Gate(label) as gate, TieRecord() as ties:
            g_eng, got = run(dev, script)
            torch.cuda.synchronize()
        launches = b1.launches - before
        c_eng, ref = run("cpu", script)
        err = compare_service([o for _, o, _ in got], [o for _, o, _ in ref],
                              label, ties=ties, soft_tol=soft_tol)
        if dataclasses.asdict(g_eng.metrics) != dataclasses.asdict(
                c_eng.metrics):
            raise AssertionError(f"{label}: metrics {g_eng.metrics} vs "
                                 f"{c_eng.metrics}")
        if name.startswith("Full") and torch.device(dev).type == "cuda" \
                and launches < 1:
            raise AssertionError(f"{label}: B1 not launched")
        res[name] = dict(max_err_vs_cpu=err, demod_full_tm=launches,
                         b1_gate_launches=gate.stats["launches_checked"])
        log(json.dumps({"phase": "conformance", "kernel": "soak",
                        "case": name, "events": len(script),
                        "outputs": len(got), "result": "pass", **res[name],
                        "card": card}))
    return res


def conformance_phase(torch, dev, card) -> dict:
    """Phase 29: the port held to the JAX package's randomized suites on
    the card (29a-d above).  Every kernel's launches are counted over the
    whole phase (the kernels line's conformance_launches)."""
    from psk_soft_tpu_torch.ops.cuda import demod_kernel, frontend_kernel

    t0 = time.perf_counter()
    wrappers = dict(kernel_counts(),
                    timing_frontend_tm=frontend_kernel.timing_frontend_tm)
    modes = demod_kernel.demod_full_tm.mode_launches
    launches = {}
    parts = {}
    for name, fn in (("b1", conformance_b1), ("b5", conformance_b5),
                     ("fec", conformance_fec), ("soaks", conformance_soaks)):
        for w in wrappers.values():
            w.launches = 0
        for k in modes:
            modes[k] = 0
        t = time.perf_counter()
        parts[name] = fn(torch, dev, card)
        torch.cuda.synchronize()
        for k, w in wrappers.items():
            launches[k] = launches.get(k, 0) + w.launches
        for k, v in modes.items():
            launches[f"demod_full_tm[{k}]"] = launches.get(
                f"demod_full_tm[{k}]", 0) + v
        log(json.dumps({"phase": "conformance_part", "part": name,
                        "seconds": time.perf_counter() - t, "card": card}))
    combos = parts["b1"]["combos"]
    launches["demod_full_tm[config3]"] = sum(
        v for (i16, mf, interp), v in combos.items() if i16 and mf and interp)
    launches["demod_full_tm[stage0, int16]"] = sum(
        v for (i16, mf, _), v in combos.items() if i16 and mf)
    log(json.dumps({"phase": "conformance_total",
                    "b1_cases": len(parts["b1"]["cases"]),
                    "b5_cases": len(parts["b5"]),
                    "fec_cases": len(parts["fec"]),
                    "soaks": len(parts["soaks"]), "launches": launches,
                    "seconds": time.perf_counter() - t0, "card": card}))
    return dict(parts, launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from psk_soft_tpu_torch.config import DemodConfig
    from psk_soft_tpu_torch.models import blockpsk, full
    from psk_soft_tpu_torch.ops.cuda import demod_kernel, frontend_kernel
    from psk_soft_tpu_torch.ops.cuda import viterbi_kernel
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

    # --- phase 2: build, one nvcc per source, all started together ---
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = {src: pool.submit(mod.load_library) for src, mod in (
            ("demod_full.cu", demod_kernel), ("viterbi.cu", viterbi_kernel),
            ("frontend.cu", frontend_kernel))}
        build_logs = {src: f.result()[1] for src, f in builds.items()}
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, build_log in build_logs.items():
        for line in build_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  ptxas {src}: {line.strip()}")

    # --- phase 3: B1 vs its plain version: modes, edges, poison, noise
    max_err = b1_phase(torch, dev)
    mode_err = b1_modes_phase(torch, dev)
    fir_err = fir_phase(torch, dev)

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
        stages = b1_stage_ms(torch, k_fn, args)
        log(json.dumps({"phase": "timing", "what": "demod_full_tm block",
                        "channels": C, "symbols": S, "sps": SPS,
                        "debug_ports": debug, "kernel_ms": [k1, k2],
                        "plain_ms": [p1, p2], "stage_ms": stages,
                        "kernel_samples_per_s": need * C / (min(k1, k2)
                                                            * 1e-3),
                        "card": card}))

    mode_times = b1_mode_times(torch, dev, card, event_ms)
    stage0_times = fir_times(torch, dev, card, event_ms)

    engine_rates = {}
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
        engine_rates[depth] = n_timed * need * C / dt
        log(json.dumps({"phase": "timing", "what": "engine end to end",
                        "pipeline_depth": depth, "debug_ports": False,
                        "blocks": n_timed, "emitted": emitted,
                        "seconds": dt,
                        "samples_per_s": n_timed * need * C / dt,
                        "host_ms_per_block": {k: v * 1e3 / n_timed
                                              for k, v in acc.items()},
                        "card": card}))
        if depth == 0:
            profile_engine(feed, card)
        bank.close()

    b5 = frontend_phase(torch, dev, card, event_ms, blocks)
    del blocks
    b5["launches"] = fused_phase(torch, dev, card, frames, profile_engine)
    b1_lifecycle = lifecycle_phases(torch, dev, card, frames)
    del frames
    c3 = config3_engine_phase(torch, dev, card, profile_engine)
    mixed_launches = mixed_engine_phase(torch, dev, card)
    vit = viterbi_phases(torch, dev, card, event_ms)
    chain = chain_phases(torch, dev, card, profile_engine)
    acq = acquire_phase(torch, dev, card)
    long_launches = long_trellis_phase(torch, dev)
    golden = golden_phase(torch, dev, card)
    bank17 = batch_engine_phase(torch, dev, card)
    stream18 = service_phase(torch, dev, card)
    group19 = group_phase(torch, dev, card)
    log(json.dumps({"phase": "service_path", "golden": golden,
                    "exact_block_ms": bank17["exact"],
                    "batch_ff_samples_per_s": bank17["ff_samples_per_s"],
                    **stream18, "group_max_err_vs_cpu": group19,
                    "card": card}))
    stream20 = stream_fec_phase(torch, dev, card, event_ms)
    parallel21 = parallel_decode_phase(torch, dev, card)
    receiver22 = receiver_phase(torch, dev, card, profile_engine,
                                chain["infobits_per_s"])
    group22 = group_sync_phase(torch, dev, card)
    front23 = front_receiver_phase(torch, dev, card, profile_engine,
                                   receiver22)
    wide24 = wideband_phase(torch, dev, card, event_ms)
    resampled24 = resampled_phase(torch, dev, card, event_ms)
    probe24 = probe_phase(torch, dev, card)
    queue24 = queue_phase(torch, dev, card)
    log(json.dumps({"phase": "input_side", "wideband_samples_per_s":
                    wide24["samples_per_s"], "probe_ms": probe24["times"],
                    "queue_samples_per_s": queue24["samples_per_s"],
                    "card": card}))
    eval25 = eval_phase(torch, dev, card)
    cli26 = cli_demod_phase(torch, dev, card, {
        "phase5_engine_samples_per_s": engine_rates[0],
        "phase7_chain_infobits_per_s": chain["infobits_per_s"][0],
        "phase22_receiver_infobits_per_s":
            receiver22["rates"]["infobits_per_s"]})
    shard27 = sharding_phases(torch, dev, card)
    bench28 = bench_phase(torch, dev, card)
    conf29 = conformance_phase(torch, dev, card)
    log(json.dumps({"phase": "b1_gate_near_ties",
                    "receiver": receiver22["b1_gate"],
                    "front_receiver": front23["b1_gate"],
                    "wideband": wide24["b1_gate"],
                    **{f"resampled_{k}": v["b1_gate"]
                       for k, v in resampled24.items()},
                    "eval_factories": eval25["factories"]["gate"],
                    **{f"eval_chain_fer_{k}": eval25["chain_fer"][k][
                        "b1_gate"] for k, _, _ in FER_POINTS},
                    **{f"sharded_full_chan_{n}": v["b1_gate"]
                       for n, v in shard27["full"].items()}}))
    log(json.dumps({"phase": "launches_by_path", "chain": chain["launches"],
                    "fused": {"timing_frontend_tm": b5["launches"]},
                    "lifecycle": {"demod_full_tm": b1_lifecycle},
                    "config3_int16_engine": c3,
                    "mixed_engine": {"demod_full_tm[mixed]": mixed_launches},
                    "chain_acquire_cfo": acq,
                    "long_trellis_decode": long_launches,
                    "stream_fec": stream20["launches"],
                    "stream_fec_receiver": stream20["receiver_launches"],
                    "parallel_decode": {f"chunk_{k}": v
                                        for k, v in parallel21.items()},
                    "receiver_full": receiver22["launches"],
                    "group_sync_frames": group22,
                    "receiver_front_ends": front23["launches"],
                    "wideband_channelizer": {
                        "demod_full_tm": wide24["launches"]},
                    **{f"resampled_bank_{k}": {"demod_full_tm":
                                               v["launches"]}
                       for k, v in resampled24.items()},
                    "scanned_full_factory": {"demod_full_tm": eval25[
                        "factories"]["scanned"]},
                    "mixed_full_factory": {"demod_full_tm[mixed]": eval25[
                        "factories"]["mixed"]},
                    **{f"chain_fer_{k}": eval25["chain_fer"][k]["launches"]
                       for k, _, _ in FER_POINTS},
                    "coded_ber": {k: v["launches"] for k, v in
                                  eval25["coded_ber"].items()},
                    **{f"cli {k}": v["launches"]
                       for k, v in cli26["runs"].items()},
                    **{f"sharded_full chan {n}": {"demod_full_tm":
                                                  v["launches"]}
                       for n, v in shard27["full"].items()},
                    **{f"time_sharded {k}": {"demod_full_tm": v["launches"],
                                             **{f"demod_full_tm[{m}]": c
                                                for m, c in
                                                v["modes"].items()}}
                       for k, v in shard27["time"].items()},
                    **{f"scaling {k}": v["launches"]
                       for k, v in shard27["scaling"].items()},
                    "dryrun_multichip": shard27["dryrun"],
                    **{f"bench {k}": v for k, v in bench28.items()}}))

    # --- the kernels line ---
    t = timings[False]
    b1_in = (2 * (NUM_AVG - 1) * SPS * C + 2 * need * C
             + demod_kernel.state_rows(PHASE_AVG) * C) * 4
    b1_out = (2 * S * C * 4 + S * C
              + demod_kernel.state_rows(PHASE_AVG) * C * 4)
    # Per input sample its energy (3 operations); per symbol the M-th power,
    # three atan2/sincos, the 9-tap trend and the phase_avg-tap FIR (about
    # 2 * phase_avg + 40 operations).
    b1_ops = 3 * need * C + S * C * (2 * PHASE_AVG + 40)
    rows = [dict(name="demod_full_tm", source="demod_full.cu",
                 replaces="psk_soft_tpu/ops/pallas/demod_kernel.py:546",
                 launches=chain["launches"]["demod_full_tm"],
                 max_abs_err=max_err, ms=min(t["kernel_ms"]),
                 plain_ms=min(t["plain_ms"]), bytes=b1_in + b1_out,
                 ops=b1_ops)]
    # B1's other modes: int16, timing_interp and the matched filter launch
    # on the config-3 engine's path (all three in each launch), mixed on
    # the mixed engine's.
    mode_launch = dict(c3["modes"], config3=c3["launches"],
                       mixed=mixed_launches)
    for name in B1_MODE_NAMES:
        t = mode_times[name]
        rows.append(dict(name=f"demod_full_tm[{name}]", source="demod_full.cu",
                         replaces="psk_soft_tpu/ops/pallas/demod_kernel.py:546",
                         launches=mode_launch[name],
                         max_abs_err=mode_err[name], ms=min(t["kernel_ms"]),
                         plain_ms=min(t["plain_ms"]), bytes=t["bytes"],
                         ops=t["ops"]))
    # B1's stage 0 (timed alone through matched_filter_tm) launches once
    # in each matched-filter launch of B1 on the config-3 engine's path.
    for i16, suffix in ((False, ""), (True, ", int16")):
        t = stage0_times[i16]
        rows.append(dict(name=f"demod_full_tm[stage0{suffix}]",
                         source="demod_full.cu", replaces=MF_PALLAS,
                         launches=c3["modes"]["matched_filter"],
                         max_abs_err=fir_err[i16],
                         ms=min(t["kernel_ms"]), plain_ms=min(t["plain_ms"]),
                         bytes=t["bytes"], ops=t["ops"],
                         library_ms=(min(t["library_ms"]) if t["library_ms"]
                                     else None)))
    # B2 runs on the chain path, timed at its shape; B3 and B4 on the
    # streaming decoder's path (phase 20), timed at its shape.
    path_launches = {"viterbi_fused": chain["launches"]["viterbi_fused"],
                     **stream20["launches"]}
    for name, line in (("viterbi_fused", 312), ("viterbi_acs", 349),
                       ("viterbi_traceback", 391)):
        v = stream20["kernels"].get(name, vit[name])
        rows.append(dict(
            name=name, source="viterbi.cu",
            replaces=f"psk_soft_tpu/ops/pallas/viterbi_kernel.py:{line}",
            launches=path_launches[name], max_abs_err=v["max_abs_err"],
            ms=v["ms"], plain_ms=v["plain_ms"], bytes=v["bytes"],
            ops=v["ops"]))
    rows.append(dict(name="timing_frontend_tm", source="frontend.cu",
                     replaces="psk_soft_tpu/ops/pallas/frontend.py:83",
                     **b5))
    if min(r["launches"] for r in rows) < 1:
        raise AssertionError(f"a kernel was not launched on its path: "
                             f"{[(r['name'], r['launches']) for r in rows]}")
    # Phase 29's launches of each row's kernel (stage 0 runs inside every
    # matched-filter launch of B1).
    conf = dict(conf29["launches"])
    conf["demod_full_tm[stage0]"] = conf["demod_full_tm[matched_filter]"]
    kernels = []
    for r in rows:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": "psk_soft_tpu_torch/csrc/" + r["source"],
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r.get("library_ms"),
            "conformance_launches": conf[r["name"]]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
