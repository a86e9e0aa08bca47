"""Command-line interface of the port (port of ``psk_soft_tpu/cli.py``).

  python -m psk_soft_tpu_torch demod --in iq.cf32 --out-prefix out --sps 8 -M 4
  python -m psk_soft_tpu_torch demod-batch --in bank.cf32 --channels 1024 \\
      --pipeline full --sps 8 -M 4 --uw $UW --frame-payload 64 --fec k7
  python -m psk_soft_tpu_torch gen --symbols 1000 -M 4 --out iq.cf32
  python -m psk_soft_tpu_torch ber --esn0 0,2,4,6,8,10 -M 4
  python -m psk_soft_tpu_torch baseline --config 3 --full
  python -m psk_soft_tpu_torch selftest

($UW: the unique word's symbol indices, comma-separated, e.g. 32 of
them.)  The arguments, output files and stderr metrics are the JAX
CLI's.  Every subcommand that runs the demod, the decoder or the probe
takes ``--device`` (default ``cuda``; ``cpu`` runs the plain versions of
the kernels) and fails on a machine without a GPU unless ``--device cpu``
is given.  ``demod-batch`` has no ``--interpret`` (a Pallas mode; ``--device
cpu`` serves the plain versions instead), and its native deframing banks
have no numpy fallback: the port builds ``native/pskbank.cpp`` itself, so a
failed build is an error.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

def _add_demod_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config-json", default=None,
                   help="DemodConfig JSON file (the PRF-file equivalent); "
                        "overrides the individual flags")
    p.add_argument("--sps", type=int, default=10,
                   help="samples per symbol (samplesPerBaud)")
    p.add_argument("--num-avg", type=int, default=100,
                   help="timing window in symbols (numAvg)")
    p.add_argument("-M", "--constellation", type=int, default=4,
                   choices=(2, 4, 8, 16, 32),
                   help="constellation size (16/32 are an extension "
                        "beyond the reference's {2,4,8})")
    p.add_argument("--phase-avg", type=int, default=50,
                   help="phase tracker window (phaseAvg)")
    p.add_argument("--differential", action="store_true")
    p.add_argument("--matched-filter", choices=("none", "boxcar", "rrc"),
                   default="none")
    p.add_argument("--rrc-beta", type=float, default=0.35)
    p.add_argument("--rrc-span", type=int, default=8)
    p.add_argument("--timing-interp", action="store_true",
                   help="fractional early-late timing refinement")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu (the plain "
                        "versions of the kernels)")


def _config_from_args(args):
    from .config import DemodConfig

    if getattr(args, "config_json", None):
        with open(args.config_json) as f:
            return DemodConfig.from_json(f.read())
    return DemodConfig(
        sps=args.sps, num_avg=args.num_avg,
        constellation_size=args.constellation, phase_avg=args.phase_avg,
        differential=args.differential, matched_filter=args.matched_filter,
        rrc_beta=args.rrc_beta, rrc_span=args.rrc_span,
        timing_interp=args.timing_interp)


def _code_from_args(args, name: str | None = None):
    """The ConvCode of ``--fec`` (or of ``name``), with ``--fec-puncture``."""
    from .ops import fec as fec_ops

    code = {"k7": fec_ops.CODE_K7, "k9": fec_ops.CODE_K9}[name or args.fec]
    if args.fec_puncture:
        pat = {"2/3": fec_ops.PUNCTURE_2_3,
               "3/4": fec_ops.PUNCTURE_3_4}[args.fec_puncture]
        code = fec_ops.ConvCode(code.k, code.polys, pat)
    return code


def cmd_demod(args) -> int:
    from .runtime.engine import StreamEngine
    from .runtime.streams import (SRI, Packet, PORT_BITS, PORT_PHASE,
                                  PORT_SAMPLE_INDEX, PORT_SOFT)

    cfg = _config_from_args(args)
    eng = StreamEngine(cfg, block_symbols=args.block_symbols,
                       pipeline=args.pipeline, device=args.device)
    sri = SRI(stream_id=args.stream_id, xdelta=1.0 / args.sample_rate, mode=1)

    src = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    sinks = {
        PORT_SOFT: open(f"{args.out_prefix}.soft.cf32", "wb"),
        PORT_BITS: open(f"{args.out_prefix}.bits.i16", "wb"),
    }
    if not args.no_debug_ports:
        sinks[PORT_PHASE] = open(f"{args.out_prefix}.phase.f32", "wb")
        sinks[PORT_SAMPLE_INDEX] = open(f"{args.out_prefix}.index.i16", "wb")
    chunk_bytes = args.chunk_samples * 8  # complex64
    t = 0.0
    try:
        while True:
            raw = src.read(chunk_bytes)
            eos = len(raw) < chunk_bytes
            usable = len(raw) - (len(raw) % 4)  # whole float32s only
            data = np.frombuffer(raw[:usable], np.float32)
            if data.size % 2:
                data = data[:-1]
            cx = data.view(np.complex64) if data.size else np.zeros(
                0, np.complex64)
            outs = eng.process(Packet(data=cx, sri=sri, t=t, eos=eos))
            for port, pkt in outs.items():
                if port not in sinks:  # debug ports left unconnected
                    continue
                sinks[port].write(np.ascontiguousarray(pkt.data).tobytes())
            t += cx.size * sri.xdelta
            if eos:
                break
    finally:
        for f in sinks.values():
            f.close()
        if src is not sys.stdin.buffer:
            src.close()
    m = eng.metrics
    print(json.dumps({
        "samples_in": m.samples_in, "symbols_out": m.symbols_out,
        "bits_out": m.bits_out, "packets_in": m.packets_in,
    }), file=sys.stderr)
    return 0


class _HeadReader:
    """File-like: replays a peeked head before the underlying stream
    (exact-n reads, the contract the ingest loop's EOS check relies on)."""

    def __init__(self, head: bytes, src):
        self._head = head
        self._src = src

    def read(self, n: int) -> bytes:
        out = b""
        if self._head:
            out, self._head = self._head[:n], self._head[n:]
        while len(out) < n:
            more = self._src.read(n - len(out))
            if not more:
                break
            out += more
        return out

    def close(self) -> None:
        if self._src is not sys.stdin.buffer:
            self._src.close()


def _frame_format(args, m: int):
    from .ops.framesync import FrameFormat

    return FrameFormat(uw=tuple(int(v) for v in args.uw.split(",")),
                       payload=args.frame_payload, m=m,
                       threshold=args.uw_threshold)


def _run_fused_chain(args, cfg) -> int:
    """demod-batch --fused-chain: ChainEngine (demod, seam frame sync,
    Viterbi and CRC a block: kernels B1 and B2 on the card) instead of the
    per-stage stack; only decoded frames come back to the host.  Writes
    <out-prefix>.frames.jsonl (info_bits records; no raw-bits field)."""
    from .ops.crc import crc_preset
    from .runtime.chain_engine import ChainEngine
    from .runtime.native_bank import NativePlaneBank

    if not args.uw or not args.fec:
        raise SystemExit("--fused-chain composes sync+FEC in-program; it "
                         "requires --uw and --fec")
    if args.fec_labeling != "gray":
        raise SystemExit("--fused-chain decodes gray-labeled payloads "
                         "(--fec-labeling gray)")
    for flag, name in ((args.agc, "--agc"), (args.equalize, "--equalize"),
                       (args.acquire_cfo, "--acquire-cfo"),
                       (args.quality_report, "--quality-report"),
                       (args.descramble, "--descramble"),
                       (args.descramble_selfsync, "--descramble-selfsync"),
                       (args.fec_stream, "--fec-stream"),
                       (args.fec_interleave, "--fec-interleave"),
                       (args.channelize, "--channelize"),
                       (args.native_sps, "--native-sps"),
                       (args.auto, "--auto"),
                       (args.soft_i8, "--soft-i8"),
                       (args.guard_nonfinite, "--guard-nonfinite"),
                       (args.cfo_track, "--cfo-track")):
        if flag:
            raise SystemExit(f"{name} needs the per-stage stack; drop "
                             f"--fused-chain to combine them")
    C = args.channels
    i16 = args.in_format == "ci16"
    crc = crc_preset(args.crc) if args.crc else None
    try:
        eng = ChainEngine(cfg, C, _frame_format(args, cfg.constellation_size),
                          _code_from_args(args), crc,
                          block_symbols=args.block_symbols,
                          pipeline_depth=args.pipeline_depth,
                          labeling=args.fec_labeling, device=args.device)
    except ValueError as e:
        raise SystemExit(f"--fused-chain: {e}")
    # Native plane deframe: a strided C++ pass straight to the kernel's
    # (T, C) layout.  Capacity covers both the block and the read chunk
    # (an undersized ring would overflow-flush and drop input).
    plane_bank = NativePlaneBank(
        C, capacity_samples=max(4 * args.block_symbols * cfg.sps,
                                2 * args.chunk_samples, 1 << 16),
        dtype="i16" if i16 else "f32")

    src = (sys.stdin.buffer if args.infile == "-"
           else open(args.infile, "rb"))
    frames_sink = open(f"{args.out_prefix}.frames.jsonl", "w")
    frame_bytes = C * (4 if i16 else 8)
    chunk = args.chunk_samples * frame_bytes
    samples_in = 0

    def drain():
        for f in eng.pop_frames():
            rec = {"channel": f.channel, "start": f.start,
                   "residual_phase": round(f.residual_phase, 4),
                   "info_bits": f.info_bits.tolist()}
            if f.crc_ok is not None:
                rec["crc_ok"] = f.crc_ok
            frames_sink.write(json.dumps(rec) + "\n")

    try:
        while True:
            raw = src.read(chunk)
            usable = len(raw) - (len(raw) % frame_bytes)
            if usable:
                samples_in += (usable // frame_bytes) * C
                plane_bank.push_interleaved(np.frombuffer(
                    raw[:usable], np.int16 if i16 else np.float32))
                # Drain everything available, never just this chunk: a
                # partially served earlier pop must not strand a backlog.
                avail = plane_bank.depth()
                r = plane_bank.pop_planes(avail, timeout=0) if avail else None
                if r is not None:
                    re, im = r[0], r[1]
                    if i16:
                        re = re.astype(np.float32) * args.in_scale
                        im = im.astype(np.float32) * args.in_scale
                    eng.push_planes(re, im)
            while eng.step() is not None:
                drain()
            if len(raw) < chunk:
                eng.flush()
                drain()
                break
    finally:
        frames_sink.close()
        plane_bank.close()
        if src is not sys.stdin.buffer:
            src.close()
    print(json.dumps({
        "samples_in": samples_in,
        "frames_synced": eng.frames_synced,
        "crc_failures": eng.crc_failures,
        "overflow_peaks": eng.overflow_peaks,
        "warmup_symbols": eng.warmup_symbols,
    }), file=sys.stderr)
    return 0


def _probe_config(args, cfg, src, i16: bool):
    """--auto: the bank's sps and M from a blind probe of the capture head
    on ``--device``; returns (cfg, a reader that replays the head)."""
    import dataclasses

    from .ops.probe import classify_psk, estimate_baud

    C = args.channels
    frame = C * (4 if i16 else 8)
    head = src.read(args.auto_samples * frame)
    usable = len(head) - (len(head) % frame)
    if usable < 1024 * frame:
        raise SystemExit("--auto: capture too short to probe")
    if i16:
        w = np.frombuffer(head[:usable], np.int16).reshape(-1, C, 2)
        x = ((w[..., 0].astype(np.float32)
              + 1j * w[..., 1].astype(np.float32))
             * args.in_scale).astype(np.complex64)
    else:
        x = np.frombuffer(head[:usable], np.complex64).reshape(-1, C)
    x = np.array(x.T, order="C")       # a writable (C, T) copy
    sps_est, bconf = estimate_baud(x, sps_min=2, sps_max=64,
                                   device=args.device)
    m_est, _, _ = classify_psk(x, max_m=32, device=args.device)
    good = bconf > 5.0
    if not good.any():
        raise SystemExit("--auto: no usable baud line in the capture "
                         "(noise-only, CW, or transition-free signal); "
                         "configure --sps/-M explicitly")
    sps_f = float(np.median(sps_est[good]))
    sps = int(round(sps_f))
    if abs(sps_f - sps) > 0.15:
        raise SystemExit(f"--auto: estimated sps {sps_f:.2f} is "
                         f"fractional; resample via --native-sps "
                         f"{sps_f:.2f} --sps {int(np.ceil(sps_f))}")
    ms = m_est[good & (m_est > 0)]
    if ms.size == 0:
        raise SystemExit("--auto: PSK order not identifiable; pass -M")
    m = int(np.bincount(ms).argmax())
    cfg = dataclasses.replace(cfg, sps=sps, constellation_size=m)
    print(json.dumps({"auto": {"sps": sps, "sps_raw": round(sps_f, 3),
                               "m": m,
                               "confident_channels": int(good.sum())}}),
          file=sys.stderr)
    return cfg, _HeadReader(head, src)   # the probe loses no data


def cmd_demod_batch(args) -> int:
    """Multichannel demod: input is sample-interleaved across channels
    (s0c0 s0c1 ... s0c[C-1] s1c0 ..., complex64 or int16 pairs each) -- a
    channelizer's natural output order.  Soft decisions are written
    symbol-interleaved the same way; bits as int16 (bits_per_symbol per
    channel per symbol)."""
    from .runtime.engine import BatchEngine, FullKernelBatchEngine
    from .runtime.streams import (SRI, PORT_BITS, PORT_PHASE,
                                  PORT_SAMPLE_INDEX, PORT_SOFT)

    cfg = _config_from_args(args)
    if args.fused_chain:
        return _run_fused_chain(args, cfg)
    C = args.channels
    dev = args.device
    i16 = args.in_format == "ci16"
    src_pre = None
    if args.auto:
        if args.channelize or args.native_sps is not None:
            raise SystemExit("--auto probes the bank's own rate; it cannot "
                             "combine with --channelize / --native-sps")
        cfg, src_pre = _probe_config(
            args, cfg, sys.stdin.buffer if args.infile == "-"
            else open(args.infile, "rb"), i16)
    resampler = None
    if args.native_sps is not None:
        from .runtime.resampler import ResamplerBank
        vals = [float(v) for v in args.native_sps.split(",")]
        if len(vals) == 1:
            vals = vals * C
        if len(vals) != C:
            raise SystemExit(f"--native-sps needs 1 or {C} values, got "
                             f"{len(vals)}")
        resampler = ResamplerBank([v / cfg.sps for v in vals],
                                  block_out=args.block_symbols * cfg.sps,
                                  device=dev)
    chanfe = None
    if args.channelize:
        if args.native_sps is not None:
            raise SystemExit("--channelize and --native-sps cannot combine "
                             "in one run (channelize first, then resample "
                             "in a second run if the band rates differ)")
        from .runtime.channelizer import ChannelizerFrontEnd
        chanfe = ChannelizerFrontEnd(C, taps_per_branch=args.chan_taps,
                                     oversample=args.chan_oversample,
                                     device=dev)
    full = args.pipeline == "full"
    if full:
        # int16 wire planes reach kernel B1 untouched only when nothing
        # sits between the bank and the engine that must see float32.
        wire_i16 = (i16 and resampler is None and not args.channelize
                    and not args.acquire_cfo and not args.agc)
        eng = FullKernelBatchEngine(cfg, channels=C,
                                    block_symbols=args.block_symbols,
                                    pipeline_depth=args.pipeline_depth,
                                    ingest_scale=args.in_scale
                                    if wire_i16 else None,
                                    guard_nonfinite=args.guard_nonfinite,
                                    debug_ports=not args.no_debug_ports,
                                    soft_i8=args.soft_i8, device=dev)
    else:
        if args.soft_i8:
            raise SystemExit("--soft-i8 requires --pipeline full (the "
                             "quantization runs inside the fused kernel)")
        eng = BatchEngine(cfg, channels=C, block_symbols=args.block_symbols,
                          pipeline_depth=args.pipeline_depth,
                          guard_nonfinite=args.guard_nonfinite, device=dev)
    # Front ends, innermost first: quality o AGC o EQ o CFO o engine.
    if args.acquire_cfo:
        # The NCO mixes before the engine, so wire dequantization (when
        # any) moves to the push site below and ingest_scale stays off.
        from .runtime.autocfo import AutoCfoEngine
        eng = AutoCfoEngine(eng, acq_samples=args.acq_samples,
                            track=args.cfo_track)
    if args.equalize:
        # Between AGC and the NCO: the CMA cost is rotation-invariant, so
        # residual CFO passes the converged equalizer untouched.
        from .ops.equalizer import EqConfig
        from .runtime.equalizer import EqFrontEnd
        eng = EqFrontEnd(eng, EqConfig(taps=args.eq_taps, mu=args.eq_mu,
                                       stride=args.eq_stride))
    if args.agc:
        from .ops.agc import AgcConfig
        from .runtime.agc import AgcFrontEnd
        eng = AgcFrontEnd(eng, AgcConfig(target_rms=args.agc_target,
                                         alpha=args.agc_alpha,
                                         chunk=cfg.sps,
                                         squelch_power=args.squelch))
    monitor = None
    if args.quality_report:
        from .runtime.quality import QualityMonitor
        eng = monitor = QualityMonitor(eng)
    syncer = None
    if args.uw:
        from .runtime.framesync import FrameSyncer
        eng = syncer = FrameSyncer(
            eng, _frame_format(args, cfg.constellation_size), device=dev)
    sfec = None
    if args.fec_stream:
        from .runtime.fec import StreamFecDecoder
        eng = sfec = StreamFecDecoder(
            eng, _code_from_args(args, args.fec_stream),
            labeling=args.fec_labeling, device=dev)
    fec = None
    if args.fec:
        if syncer is None:
            raise SystemExit("--fec decodes frame payloads; it requires "
                             "--uw frame sync")
        from .runtime.fec import FecFrameDecoder
        try:
            fec = FecFrameDecoder(syncer, _code_from_args(args),
                                  interleave_rows=args.fec_interleave,
                                  labeling=args.fec_labeling, device=dev)
        except ValueError as e:
            raise SystemExit(f"--fec: {e}")
    frames_src = fec or syncer
    if args.descramble:
        if syncer is None:
            raise SystemExit("--descramble is frame-synchronous; it "
                             "requires --uw frame sync")
        from .ops.scramble import lfsr_preset
        from .runtime.scramble import FrameDescrambler
        name, _, seed = args.descramble.partition(":")
        try:
            lf = lfsr_preset(name, int(seed, 0) if seed else None)
        except ValueError as e:
            raise SystemExit(f"--descramble: {e}")
        frames_src = FrameDescrambler(frames_src, lf, device=dev)
    if args.crc:
        if syncer is None:
            raise SystemExit("--crc checks frame payloads; it requires "
                             "--uw frame sync")
        from .ops.crc import crc_preset
        from .runtime.crc import FrameCrcChecker
        try:
            frames_src = FrameCrcChecker(frames_src, crc_preset(args.crc),
                                         device=dev)
        except ValueError as e:
            raise SystemExit(f"--crc: {e}")
    crc_checker = frames_src if args.crc else None
    sdesc = None
    if args.descramble_selfsync:
        from .runtime.scramble import StreamDescrambler
        taps = tuple(int(v) for v in args.descramble_selfsync.split(","))
        try:
            sdesc = StreamDescrambler(C, taps)
        except ValueError as e:
            raise SystemExit(f"--descramble-selfsync: {e}")
    xdelta = 1.0 / args.sample_rate
    if resampler is not None:
        rs_ratios = resampler.ratios
        if np.allclose(rs_ratios, rs_ratios[0]):
            # one resampled sample spans ratio/sample_rate seconds of
            # capture time, so the packet clock rescales exactly
            xdelta = float(rs_ratios[0]) / args.sample_rate
        else:
            print("warning: --native-sps values differ per channel; the "
                  "bank packet clock (SRI xdelta/timestamps) follows the "
                  "common grid and cannot be exact for every channel's "
                  "wall-clock rate -- split rates into separate runs if "
                  "downstream consumers need exact clocks", file=sys.stderr)
            xdelta = float(np.median(rs_ratios)) / args.sample_rate
    if chanfe is not None:
        # each channel runs at sample_rate * oversample / C
        xdelta = C / (args.sample_rate * args.chan_oversample)
    eng.set_input_sri(SRI(stream_id=args.stream_id, xdelta=xdelta, mode=1))
    # Deframing: sample-interleaved -> device layout in the native rings
    # (a strided C++ pass).  The full engine takes the plane bank
    # (time-major (T, C) planes, the kernel's layout; int16 wire too), the
    # ff engine the channel-major bank on float32 wire.  The resampler's
    # ragged consumption and the channelizer's single wideband stream
    # cannot ride the fixed-frame rings, and ff on int16 wire dequantizes
    # per channel: those deframe in numpy.
    need = args.block_symbols * cfg.sps
    bank = plane_bank = None
    if resampler is None and chanfe is None:
        from .runtime.native_bank import NativeChannelBank, NativePlaneBank
        if full:
            plane_bank = NativePlaneBank(
                C, capacity_samples=max(4 * need, 1 << 16),
                dtype="i16" if i16 else "f32")
        elif not i16:
            bank = NativeChannelBank(C, capacity_samples=max(4 * need,
                                                             1 << 16))
    src = src_pre if src_pre is not None else (
        sys.stdin.buffer if args.infile == "-"
        else open(args.infile, "rb"))
    # All four SCD ports (psk_soft.scd.xml:32-73), symbol-interleaved across
    # channels like the input sample order.
    sinks = {
        PORT_SOFT: open(f"{args.out_prefix}.soft.cf32", "wb"),
        PORT_BITS: open(f"{args.out_prefix}.bits.i16", "wb"),
    }
    if not args.no_debug_ports:
        sinks[PORT_PHASE] = open(f"{args.out_prefix}.phase.f32", "wb")
        sinks[PORT_SAMPLE_INDEX] = open(f"{args.out_prefix}.index.i16", "wb")
    # --channelize reads ONE wideband stream: a "frame" is a single
    # complex sample, not a C-channel row.
    frame_bytes = (1 if chanfe is not None else C) * (4 if i16 else 8)
    chunk = args.chunk_samples * frame_bytes
    nb = cfg.bits_per_symbol

    frames_sink = open(f"{args.out_prefix}.frames.jsonl", "w") \
        if args.uw else None
    sfec_sink = open(f"{args.out_prefix}.fecstream.i8", "wb") \
        if args.fec_stream else None

    def drain_sfec():
        bits = sfec.pop_bits()
        if bits.size:
            # channel-interleaved (N, C) int8, matching the port layout
            sfec_sink.write(np.ascontiguousarray(bits.T).tobytes())

    def drain_frames():
        for f in frames_src.pop_frames():
            rec = {
                "channel": f.channel, "start": f.start,
                "rotation": f.rotation, "corr": round(f.corr, 4),
                "residual_phase": round(f.residual_phase, 4),
                "bits": f.bits.tolist(),
            }
            if f.info_bits is not None:
                rec["info_bits"] = f.info_bits.tolist()
                rec["corrected"] = f.corrected
                rec["suspect"] = f.suspect
            if f.crc_ok is not None:
                rec["crc_ok"] = f.crc_ok
            frames_sink.write(json.dumps(rec) + "\n")

    def write(pkts):
        for port, pkt in pkts.items():
            if port not in sinks:      # debug ports left unconnected
                continue
            d = pkt.data
            if d.size == 0:
                continue
            if port == PORT_BITS:    # (C, Sv*nb) -> (Sv, C, nb) interleaved
                if sdesc is not None:
                    d = sdesc.observe(d.astype(np.int8)).astype(d.dtype)
                d = d.reshape(C, -1, nb).transpose(1, 0, 2)
            else:                    # (C, Sv) -> (Sv, C)
                d = d.T
            sinks[port].write(np.ascontiguousarray(d).tobytes())

    def drain_outputs():
        if syncer is not None:
            drain_frames()
        if sfec is not None:
            drain_sfec()

    def pump():
        # Frames are popped after every block, not after every read: a
        # syncer holds at most max_frames (4096) unpopped frames, which a
        # read of several blocks of a wide bank would overrun.
        while True:
            pkts = eng.step_packets()
            if pkts is None:
                break
            write(pkts)
            drain_outputs()

    wire_dtype = np.int16 if i16 else np.float32

    def dequant_cmajor(flat):
        """(frames*2C,) wire array -> channel-major complex64."""
        pairs = flat.reshape(-1, C, 2)
        if i16:
            re = pairs[..., 0].astype(np.float32) * args.in_scale
            im = pairs[..., 1].astype(np.float32) * args.in_scale
        else:
            re, im = pairs[..., 0], pairs[..., 1]
        return (re + 1j * im).astype(np.complex64).T

    def push(r):
        """Hand a block on: (re, im) planes to the full engine, a
        channel-major (C, n) block to the ff engine."""
        if full:
            eng.push_planes(*r)
        else:
            eng.push_block(r)

    wire_samples = [0]    # capture-rate complex samples actually read

    def wire_planes(r):
        """int16 wire planes dequantize on the host when the NCO or the AGC
        sits in front of the engine (mixing must see float32); otherwise
        they ride the kernel's own int16 ingest untouched."""
        if i16 and (args.acquire_cfo or args.agc):
            return (np.asarray(r[0], np.float32) * args.in_scale,
                    np.asarray(r[1], np.float32) * args.in_scale)
        return r[0], r[1]

    def ingest(raw):
        usable = len(raw) - (len(raw) % frame_bytes)
        if not usable:
            return
        flat = np.frombuffer(raw[:usable], wire_dtype)
        wire_samples[0] += flat.size // 2
        if chanfe is not None:
            pairs = flat.reshape(-1, 2)
            if i16:
                w = (pairs[:, 0].astype(np.float32) * args.in_scale
                     + 1j * (pairs[:, 1].astype(np.float32)
                             * args.in_scale)).astype(np.complex64)
            else:
                w = (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)
            chanfe.push(w)
            while True:
                # planes: the filterbank's device-resident (rows, C)
                # output is the kernel's input layout
                r = (chanfe.step_planes(need) if full
                     else chanfe.step_block(need))
                if r is None:
                    break
                push(r)
        elif plane_bank is not None:
            plane_bank.push_interleaved(flat)
            while True:
                r = plane_bank.pop_planes(need, timeout=0)
                if r is None:
                    break
                eng.push_planes(*wire_planes(r))
        elif bank is not None:
            bank.push_interleaved(flat)
            while True:
                r = bank.pop_block(need, timeout=0)
                if r is None:
                    break
                eng.push_block(r[0])
        elif resampler is not None:
            data = dequant_cmajor(flat)
            for c in range(C):
                resampler.push(c, np.ascontiguousarray(data[c]))
            while True:
                blk = resampler.step_planes() if full else resampler.step()
                if blk is None:
                    break
                push(blk)
        else:
            data = dequant_cmajor(flat)
            for c in range(C):
                eng.push(c, np.ascontiguousarray(data[c]))

    try:
        while True:
            raw = src.read(chunk)
            ingest(raw)
            pump()
            if len(raw) < chunk:
                # EOS, in order: the native ring's sub-block remainder, the
                # front ends' drains, the blocks they make ready, then the
                # engine's staged tail.
                if plane_bank is not None and plane_bank.depth():
                    r = plane_bank.pop_planes(plane_bank.depth(), timeout=0)
                    if r is not None:
                        eng.push_planes(*wire_planes(r))
                if bank is not None and bank.depth():
                    r = bank.pop_block(bank.depth(), timeout=0)
                    if r is not None:
                        eng.push_block(r[0])
                if chanfe is not None:
                    r = chanfe.drain(planes=full)
                    if r is not None:
                        push(r)
                if resampler is not None:
                    for blk in resampler.drain(planes=full):
                        push(blk)
                    pump()
                write(eng.flush_packets())
                drain_outputs()
                break
    finally:
        for f in sinks.values():
            f.close()
        if frames_sink is not None:
            frames_sink.close()
        if sfec_sink is not None:
            sfec_sink.close()
        for b in (bank, plane_bank):
            if b is not None:
                b.close()
        if src is not sys.stdin.buffer:
            src.close()
    metrics = {"samples_in": eng.metrics.samples_in,
               "symbols_out": eng.metrics.symbols_out}
    if syncer is not None:
        metrics["frames_synced"] = syncer.frames_synced
    if fec is not None:
        metrics["frames_decoded"] = fec.frames_decoded
        metrics["errors_corrected"] = fec.errors_corrected
        metrics["suspect_frames"] = fec.suspect_frames
    if crc_checker is not None:
        metrics["crc_failures"] = crc_checker.crc_failures
    if sfec is not None:
        metrics["fec_stream_bits"] = sfec.steps_decoded
    if monitor is not None:
        snap = {k: (v.tolist() if hasattr(v, "tolist") else v)
                for k, v in monitor.snapshot().items()}
        report = json.dumps(snap)
        if args.quality_report == "-":
            print(report, file=sys.stderr)
        else:
            with open(args.quality_report, "w") as qf:
                qf.write(report + "\n")
    if resampler is not None:
        # samples_in stays the wire samples read (as in every other mode);
        # the engine's own counter sees post-resample samples
        metrics["samples_in"] = wire_samples[0]
        metrics["resampled_in"] = eng.metrics.samples_in
    print(json.dumps(metrics), file=sys.stderr)
    return 0


def cmd_gen(args) -> int:
    from .testing.signals import gen_psk, gen_psk_channel

    if args.golden:
        x, _ = gen_psk(args.symbols, args.sps, args.constellation,
                       differential=args.differential)
    else:
        x, _ = gen_psk_channel(
            args.symbols, sps=args.sps, m=args.constellation,
            differential=args.differential, seed=args.seed,
            freq_offset=args.freq_offset, snr_db=args.snr,
            pulse=args.pulse, rrc_beta=args.rrc_beta, rrc_span=args.rrc_span)
    out = sys.stdout.buffer if args.out == "-" else open(args.out, "wb")
    out.write(np.ascontiguousarray(x, np.complex64).tobytes())
    if out is not sys.stdout.buffer:
        out.close()
    print(f"wrote {x.size} complex samples", file=sys.stderr)
    return 0


def cmd_ber(args) -> int:
    from .eval.ber import ber_sweep, theoretical_ber

    cfg = _config_from_args(args)
    esn0 = [float(v) for v in args.esn0.split(",")]
    if args.fec:
        from .eval.coded import coded_ber_sweep, union_bound
        code = _code_from_args(args)
        pts = coded_ber_sweep(code, cfg.constellation_size, esn0,
                              num_bits=args.symbols * cfg.bits_per_symbol,
                              labeling=args.fec_labeling, device=args.device)
        for p in pts:
            rec = {"esn0_db": p.esn0_db, "ebn0_db": round(p.ebn0_db, 3),
                   "ber": p.ber, "n_bits": p.n_bits,
                   "frame_errors": p.frame_errors,
                   "n_frames": p.n_frames}
            try:
                rec["union_bound"] = float(union_bound(code, p.ebn0_db))
            except ValueError:
                pass                     # punctured / untabulated code
            print(json.dumps(rec))
        return 0
    pts = ber_sweep(cfg, esn0, num_symbols=args.symbols,
                    freq_offset=args.freq_offset, pulse=args.pulse,
                    device=args.device)
    th = theoretical_ber(cfg.constellation_size, np.array(esn0))
    for p, t in zip(pts, th):
        print(json.dumps({
            "esn0_db": p.esn0_db, "ber": p.ber, "ser": p.ser,
            "theory_ber": float(t), "n_bits": p.n_bits,
            "slips": p.slips,
        }))
    return 0


def cmd_gen_frames(args) -> int:
    """Generate a framed (optionally coded + scrambled) bank capture.

    Per channel, frames at a fixed interval carry random info bits through
    [CRC] -> [scramble] -> [FEC encode] -> [interleave] -> UW framing ->
    M-PSK -> pulse shaping (ops/tx), plus optional CFO and AWGN.  Ground
    truth (per-frame info bits) goes to ``--truth`` as JSONL.
    """
    from .ops import tx
    from .ops.framesync import FrameFormat

    rng = np.random.default_rng(args.seed)
    fmt = FrameFormat(uw=tuple(int(v) for v in args.uw.split(",")),
                      payload=args.frame_payload, m=args.constellation)
    code = lfsr = None
    nb = int(np.log2(fmt.m))
    n_info = fmt.payload * nb
    if args.fec:
        from .ops import fec as fec_ops
        code = _code_from_args(args)
        try:
            n_info = fec_ops.info_bits_for(code, n_info)
        except ValueError as e:
            raise SystemExit(f"--fec: {e}")
    if args.scramble:
        from .ops.scramble import lfsr_preset
        name, _, seed = args.scramble.partition(":")
        try:
            lfsr = lfsr_preset(name, int(seed, 0) if seed else None)
        except ValueError as e:
            raise SystemExit(f"--scramble: {e}")
    crc = None
    if args.crc:
        from .ops.crc import crc_preset
        crc = crc_preset(args.crc)
        if n_info <= crc.degree:
            raise SystemExit(f"--crc: frame capacity {n_info} bits cannot "
                             f"carry a {crc.degree}-bit CRC")
        n_info -= crc.degree
    interval = args.frame_interval or 4 * fmt.frame_len
    starts = list(range(interval, args.symbols - fmt.frame_len,
                        interval))
    truth = open(args.truth, "w") if args.truth else None
    rows = []
    for c in range(args.channels):
        infos = [rng.integers(0, 2, n_info, np.int8) for _ in starts]
        idx = tx.frame_stream(fmt, infos, starts, args.symbols,
                              code=code, lfsr=lfsr, crc=crc,
                              interleave_rows=args.interleave,
                              labeling=args.labeling,
                              seed=args.seed + 1000 + c)
        x = tx.shape(fmt.m, idx, args.sps, pulse=args.pulse,
                     rrc_beta=args.rrc_beta, rrc_span=args.rrc_span)
        if args.freq_offset:
            x = x * np.exp(2j * np.pi * args.freq_offset
                           * np.arange(x.size))
        if args.snr is not None:
            sigma = 10 ** (-args.snr / 20) / np.sqrt(2)
            x = x + sigma * (rng.standard_normal(x.size)
                             + 1j * rng.standard_normal(x.size))
        rows.append(x.astype(np.complex64))
        if truth is not None:
            for s0, info in zip(starts, infos):
                truth.write(json.dumps({
                    "channel": c, "start": s0,
                    "info_bits": info.tolist()}) + "\n")
    if truth is not None:
        truth.close()
    wire = np.ascontiguousarray(np.stack(rows).T)      # sample-interleaved
    out = sys.stdout.buffer if args.out == "-" else open(args.out, "wb")
    out.write(wire.tobytes())
    if out is not sys.stdout.buffer:
        out.close()
    print(f"wrote {wire.size} samples ({args.channels} ch x "
          f"{args.symbols} syms x sps {args.sps}), "
          f"{len(starts)} frames/ch, {n_info} info bits/frame",
          file=sys.stderr)
    return 0


def cmd_probe(args) -> int:
    """Blind signal survey: per-channel baud / PSK order / coarse CFO."""
    from .ops.probe import classify_psk, estimate_baud

    c = args.channels
    if args.infile == "-":
        raw = sys.stdin.buffer.read(args.samples * c * 8)
    else:
        with open(args.infile, "rb") as f:
            raw = f.read(args.samples * c * 8)
    wire = np.frombuffer(raw, np.complex64)
    wire = wire[:(wire.size // c) * c]
    if wire.size < 8 * c:
        raise SystemExit("capture too short to probe")
    x = np.ascontiguousarray(wire.reshape(-1, c).T)    # (C, T)
    sps, baud_conf = estimate_baud(x, sps_min=args.sps_min,
                                   sps_max=args.sps_max, device=args.device)
    m, cfo, line_conf = classify_psk(x, max_m=args.max_m, device=args.device)
    for ch in range(c):
        print(json.dumps({
            "channel": ch,
            "sps": round(float(sps[ch]), 3),
            "baud_confidence": round(float(baud_conf[ch]), 1),
            "m": int(m[ch]),
            "cfo": float(cfo[ch]),
            "line_confidence": round(float(line_conf[ch]), 1),
        }))
    return 0


def cmd_baseline(args) -> int:
    """Run one of the BASELINE.json evaluation configs (1-5)."""
    from .eval.baseline_configs import run_config

    try:
        result = run_config(args.config, quick=not args.full,
                            device=args.device)
    except ValueError as e:
        print(f"psk_soft_tpu_torch: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0 if result.get("pass") else 1


def cmd_selftest(args) -> int:
    from .config import DemodConfig
    from .models.psk import demod_init, make_demod_fn
    from .testing.signals import gen_psk
    from .utils.transfer import to_host

    ok = True
    for m in (2, 4, 8):
        for diff in (False, True):
            cfg = DemodConfig(sps=8, num_avg=100, constellation_size=m,
                              phase_avg=50, differential=diff)
            x, syms = gen_psk(1000, 8, m, differential=diff)
            st, out = make_demod_fn(cfg)(demod_init(cfg, device=args.device),
                                         x)
            out = to_host(out)
            soft = out.soft[out.valid]
            exp = syms[: soft.size]
            if diff and m == 4:
                exp = exp * np.exp(1j * np.pi / 4)
            if diff:
                err = np.abs(soft[1:] - exp[1:]).max()
            else:
                thetas = ([2 * np.pi * k / m for k in range(m)] if m != 4
                          else [np.pi / 4 + np.pi / 2 * k for k in range(4)])
                err = min(np.abs(soft[1:] * np.exp(1j * t) - exp[1:]).max()
                          for t in thetas)
            passed = err < 1e-3
            ok &= passed
            print(f"M={m} differential={diff}: max_err={err:.2e} "
                  f"{'PASS' if passed else 'FAIL'}")
    print("selftest", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="psk_soft_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demod", help="demodulate an IQ file / stdin stream")
    _add_demod_config_args(d)
    d.add_argument("--in", dest="infile", default="-",
                   help="input .cf32 file (interleaved float32 IQ), - = stdin")
    d.add_argument("--out-prefix", default="psk_out")
    d.add_argument("--sample-rate", type=float, default=1.0)
    d.add_argument("--stream-id", default="cli")
    d.add_argument("--block-symbols", type=int, default=512)
    d.add_argument("--chunk-samples", type=int, default=1 << 16)
    d.add_argument("--pipeline", choices=("ff", "exact"), default="ff")
    d.add_argument("--no-debug-ports", action="store_true",
                    help="do not write the phase/sampleIndex debug outputs")
    _add_device_arg(d)
    d.set_defaults(fn=cmd_demod)

    db = sub.add_parser("demod-batch",
                        help="multichannel demod (sample-interleaved input)")
    _add_demod_config_args(db)
    db.add_argument("--in", dest="infile", default="-")
    db.add_argument("--out-prefix", default="psk_batch")
    db.add_argument("--channels", type=int, required=True)
    db.add_argument("--sample-rate", type=float, default=1.0)
    db.add_argument("--stream-id", default="cli-batch")
    db.add_argument("--block-symbols", type=int, default=512)
    db.add_argument("--chunk-samples", type=int, default=1 << 14,
                    help="samples per channel per read")
    db.add_argument("--pipeline", choices=("ff", "full"), default="ff")
    db.add_argument("--in-format", choices=("cf32", "ci16"), default="cf32",
                    help="wire format: cf32 = interleaved complex64 (default)"
                         "; ci16 = interleaved int16 I/Q (SDR ADC format; "
                         "with --pipeline full the int16 planes go all the "
                         "way to the kernel)")
    db.add_argument("--in-scale", type=float, default=1.0 / 32767.0,
                    help="dequantization step for ci16 (sample = i16 * "
                         "scale)")
    db.add_argument("--no-debug-ports", action="store_true",
                    help="leave the phase/sampleIndex debug ports "
                         "unconnected: no .phase.f32/.index.i16 outputs, "
                         "and the full pipeline skips those plane writes "
                         "in-kernel")
    db.add_argument("--guard-nonfinite", action="store_true",
                    help="per-channel drop-and-resync when a channel's "
                         "output goes non-finite (isolated recovery; "
                         "incompatible with --pipeline-depth > 0 on "
                         "either pipeline)")
    db.add_argument("--pipeline-depth", type=int, default=0,
                    help="deferred-assembly depth: dispatch block k, emit "
                         "block k-depth (device/host overlap); 0 = sync")
    db.add_argument("--soft-i8", action="store_true",
                    help="int8-quantized soft decisions on the device "
                         "(round(s*100), the SDR soft-bit wire format): the "
                         "dominant output plane crosses HBM and the host "
                         "link at 2 bytes/symbol/channel; the .soft.cf32 "
                         "file then carries the dequantized (grid-snapped) "
                         "values (full pipeline only)")
    db.add_argument("--native-sps", default=None,
                    help="per-channel NATIVE samples-per-baud at the "
                         "capture rate, comma-separated (or one value for "
                         "all): each channel is polyphase-resampled from "
                         "its native (possibly fractional, e.g. 7.3) rate "
                         "to the bank's common --sps before demod "
                         "(runtime/resampler.py), so heterogeneous bauds "
                         "share one kernel bank")
    db.add_argument("--channelize", action="store_true",
                    help="input is ONE wideband stream at --sample-rate: "
                         "split it into --channels equal bands with the "
                         "polyphase DFT filterbank (ops/channelizer.py) and "
                         "demodulate every band in the bank; channel m is "
                         "centered at +m/C * sample_rate (FFT bin order), "
                         "per-channel rate = sample_rate / channels")
    db.add_argument("--chan-taps", type=int, default=8,
                    help="prototype taps per polyphase branch for "
                         "--channelize (filter length = taps * channels)")
    db.add_argument("--chan-oversample", type=int, choices=(1, 2),
                    default=1,
                    help="2 = oversampled-by-2 filterbank (hop C/2): each "
                         "channel comes out at 2*sample_rate/C so "
                         "occupancy near the band edge survives; --sps "
                         "then counts samples at that doubled rate")
    db.add_argument("--acquire-cfo", action="store_true",
                    help="coarse carrier acquisition (M-th-power spectrum) "
                         "on the first --acq-samples per channel, then "
                         "phase-continuous NCO derotation in front of the "
                         "demod (runtime/autocfo.py): recovers offsets far "
                         "beyond the phase tracker's 1/(2*M*sps) lock "
                         "range; nothing is dropped during acquisition")
    db.add_argument("--acq-samples", type=int, default=4096,
                    help="samples staged for coarse CFO acquisition "
                         "(with --native-sps acquisition runs on the "
                         "common grid, after resampling)")
    db.add_argument("--cfo-track", action="store_true",
                    help="fold phase-port residual drift back into the NCO "
                         "whenever it nears the lock-range edge "
                         "(doppler-slew immunity)")
    db.add_argument("--fused-chain", dest="fused_chain",
                    action="store_true",
                    help="run the ONE-LAUNCH chain engine (demod + seam "
                         "frame sync + Viterbi + CRC as a single device "
                         "program per block, runtime/chain_engine.py) "
                         "instead of the per-stage stack; requires --uw "
                         "and --fec with gray labeling, excludes the "
                         "sample-side wrappers; fastest path for a fixed "
                         "frame format (only decoded frames cross to "
                         "the host)")
    db.add_argument("--agc", action="store_true",
                    help="automatic gain control in front of the demod "
                         "(runtime/agc.py): per-symbol gain from a chunked "
                         "power EMA pins soft-decision amplitudes to "
                         "--agc-target regardless of input level")
    db.add_argument("--agc-target", type=float, default=1.0,
                    help="AGC output RMS target")
    db.add_argument("--agc-alpha", type=float, default=0.05,
                    help="AGC per-symbol EMA weight (time constant "
                         "sps/alpha samples)")
    db.add_argument("--squelch", type=float, default=0.0,
                    help="mean-square power threshold; channels tracking "
                         "below it are muted until they return (0 = off; "
                         "implies --agc)")
    db.add_argument("--equalize", action="store_true",
                    help="blind CMA multipath equalization in front of the "
                         "demod (runtime/equalizer.py): Block-LMS schedule, "
                         "phase-blind (composes with the M-th-power "
                         "recovery's ambiguity); targets constant-envelope "
                         "streams -- for band-limited pulses set "
                         "--eq-stride to the symbol period")
    db.add_argument("--eq-taps", type=int, default=15,
                    help="equalizer FIR length")
    db.add_argument("--eq-mu", type=float, default=5e-5,
                    help="CMA step per error sample (keep mu * block "
                         "error count <~ 0.25 at unit power)")
    db.add_argument("--eq-stride", type=int, default=1,
                    help="error-sample spacing (1 = every sample for "
                         "rectangular pulses; sps for RRC)")
    db.add_argument("--quality-report", metavar="PATH",
                    help="write a per-channel link-quality JSON snapshot "
                         "(EVM / M2M4 SNR / carrier lock, "
                         "runtime/quality.py) at EOS; '-' = stderr")
    db.add_argument("--uw", metavar="K,K,...",
                    help="unique-word symbol indices: detect frames in the "
                         "soft stream, resolve the M-fold carrier "
                         "ambiguity per frame, and write aligned payloads "
                         "to <out-prefix>.frames.jsonl "
                         "(runtime/framesync.py)")
    db.add_argument("--frame-payload", type=int, default=0,
                    help="payload symbols following the UW")
    db.add_argument("--uw-threshold", type=float, default=0.7,
                    help="normalized-correlation detection threshold "
                         "(size the UW so threshold^2 * len >= ~14)")
    db.add_argument("--fec", choices=("k7", "k9"),
                    help="Viterbi-decode each frame payload (ops/fec.py; "
                         "requires --uw): k7 = (171,133) rate 1/2, k9 = "
                         "(561,753); adds info_bits/corrected/suspect to "
                         "<out-prefix>.frames.jsonl; k9 runs 4x the "
                         "trellis states of k7")
    db.add_argument("--fec-puncture", choices=("2/3", "3/4"),
                    help="DVB puncturing of the --fec / --fec-stream code")
    db.add_argument("--auto", action="store_true",
                    help="self-configure from the capture: probe the first "
                         "--auto-samples (blind baud + PSK-order survey, "
                         "ops/probe.py), override --sps/-M, then demodulate "
                         "everything including the probed head")
    db.add_argument("--auto-samples", type=int, default=16384,
                    help="samples per channel the --auto probe reads")
    db.add_argument("--fec-labeling", choices=("scd", "gray"),
                    default="scd",
                    help="payload bit labeling the TX used: scd = the "
                         "documented port mapping; gray = the coded-"
                         "transmission mapping that sits on the union "
                         "bound (~20x lower coded BER at the same SNR, "
                         "eval/coded.py)")
    db.add_argument("--fec-interleave", type=int, metavar="ROWS",
                    help="block deinterleave (ROWS) of each frame's code "
                         "bits before Viterbi (burst-error protection; "
                         "match gen-frames --interleave)")
    db.add_argument("--fec-stream", choices=("k7", "k9"),
                    help="streaming Viterbi over the continuous soft "
                         "stream (windowed traceback, no framing): "
                         "decoded bits go to <out-prefix>.fecstream.i8, "
                         "channel-interleaved int8 (runtime/fec.py "
                         "StreamFecDecoder)")
    db.add_argument("--crc", choices=("crc16", "crc32"),
                    help="check + strip each frame's trailing CRC field "
                         "(after --fec / --descramble; requires --uw): "
                         "adds crc_ok per frame and a crc_failures "
                         "metric (ops/crc.py)")
    db.add_argument("--descramble", metavar="PRBS[:SEED]",
                    help="frame-synchronous additive descrambling of each "
                         "frame's final bits (info_bits when --fec, else "
                         "payload bits): prbs7|prbs15|prbs23 with an "
                         "optional seed (e.g. prbs15:0x7fff); requires "
                         "--uw (ops/scramble.py)")
    db.add_argument("--descramble-selfsync", metavar="T1,T2,...",
                    help="self-synchronizing multiplicative descrambling "
                         "of the continuous bits port (per-channel "
                         "history carry), tap delays in bits")
    _add_device_arg(db)
    db.set_defaults(fn=cmd_demod_batch)


    gf = sub.add_parser("gen-frames",
                        help="generate a framed / coded / scrambled bank "
                             "capture with ground truth (ops/tx.py)")
    gf.add_argument("--out", default="-",
                    help="cf32 capture path ('-' = stdout)")
    gf.add_argument("--truth", help="JSONL ground-truth path "
                                    "(per-frame info bits)")
    gf.add_argument("--channels", type=int, default=1)
    gf.add_argument("--symbols", type=int, default=4096)
    gf.add_argument("--sps", type=int, default=8)
    gf.add_argument("-M", "--constellation", type=int, default=4)
    gf.add_argument("--uw", required=True, metavar="K,K,...")
    gf.add_argument("--frame-payload", type=int, required=True)
    gf.add_argument("--frame-interval", type=int, default=0,
                    help="symbols between frame starts (default: "
                         "4 x frame length)")
    gf.add_argument("--fec", choices=("k7", "k9"))
    gf.add_argument("--fec-puncture", choices=("2/3", "3/4"))
    gf.add_argument("--scramble", metavar="PRBS[:SEED]")
    gf.add_argument("--crc", choices=("crc16", "crc32"),
                    help="append a CRC to each frame's info bits "
                         "(innermost: before scrambling/FEC)")
    gf.add_argument("--labeling", choices=("scd", "gray"), default="scd",
                    help="payload bit-to-symbol labeling (gray = the "
                         "coded-transmission mapping)")
    gf.add_argument("--interleave", type=int, metavar="ROWS",
                    help="block-interleave each frame's code bits")
    gf.add_argument("--pulse", choices=("rect", "rrc"), default="rect")
    gf.add_argument("--rrc-beta", type=float, default=0.35)
    gf.add_argument("--rrc-span", type=int, default=8)
    gf.add_argument("--freq-offset", type=float, default=0.0)
    gf.add_argument("--snr", type=float, default=None,
                    help="per-sample Es/N0 in dB (omit = noiseless)")
    gf.add_argument("--seed", type=int, default=0)
    gf.set_defaults(fn=cmd_gen_frames)

    pr = sub.add_parser("probe",
                        help="blind survey of a capture: per-channel "
                             "baud / PSK order / coarse CFO (ops/probe.py)")
    pr.add_argument("--in", dest="infile", default="-",
                    help="cf32 capture (sample-interleaved when "
                         "--channels > 1); '-' = stdin")
    pr.add_argument("--channels", type=int, default=1)
    pr.add_argument("--samples", type=int, default=1 << 15,
                    help="samples per channel to analyze")
    pr.add_argument("--sps-min", type=float, default=2.0)
    pr.add_argument("--sps-max", type=float, default=64.0)
    pr.add_argument("--max-m", type=int, default=8,
                    help="largest candidate PSK order (power of two)")
    _add_device_arg(pr)
    pr.set_defaults(fn=cmd_probe)

    g = sub.add_parser("gen", help="generate a PSK test signal")
    g.add_argument("--symbols", type=int, default=1000)
    g.add_argument("--sps", type=int, default=8)
    g.add_argument("-M", "--constellation", type=int, default=4)
    g.add_argument("--differential", action="store_true")
    g.add_argument("--golden", action="store_true",
                   help="reference test fixture (seed 100, py2 RNG)")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--freq-offset", type=float, default=0.0)
    g.add_argument("--snr", type=float, default=None)
    g.add_argument("--pulse", choices=("rect", "rrc"), default="rect")
    g.add_argument("--rrc-beta", type=float, default=0.35)
    g.add_argument("--rrc-span", type=int, default=8)
    g.add_argument("--out", default="-")
    g.set_defaults(fn=cmd_gen)

    b = sub.add_parser("ber", help="Es/N0 BER sweep")
    _add_demod_config_args(b)
    b.add_argument("--esn0", default="0,2,4,6,8,10",
                   help="comma-separated Es/N0 dB points")
    b.add_argument("--symbols", type=int, default=20000)
    b.add_argument("--freq-offset", type=float, default=0.0)
    b.add_argument("--pulse", choices=("rect", "rrc"), default="rect")
    b.add_argument("--fec", choices=("k7", "k9"),
                   help="coded-BER sweep of the FEC layer itself over the "
                        "AWGN channel (eval/coded.py): reports Eb/N0 and "
                        "the soft-decision union bound")
    b.add_argument("--fec-puncture", choices=("2/3", "3/4"))
    b.add_argument("--fec-labeling", choices=("scd", "gray"),
                   default="scd")
    _add_device_arg(b)
    b.set_defaults(fn=cmd_ber)

    s = sub.add_parser("selftest", help="golden parity quick check")
    _add_device_arg(s)
    s.set_defaults(fn=cmd_selftest)

    bl = sub.add_parser("baseline",
                        help="run a BASELINE.json evaluation config (1-5)")
    bl.add_argument("--config", type=int, required=True, choices=range(1, 6))
    bl.add_argument("--full", action="store_true",
                    help="full-size run (default: quick sizes)")
    _add_device_arg(bl)
    bl.set_defaults(fn=cmd_baseline)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = getattr(args, "device", None)
    if device is not None and device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("psk_soft_tpu_torch: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
