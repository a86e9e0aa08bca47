"""Command-line interface of the port (port of ``psk_soft_tpu/cli.py``'s
``gen``, ``gen-frames``, ``ber``, ``baseline``, ``selftest`` and ``probe``).

  python -m psk_soft_tpu_torch gen --symbols 1000 -M 4 --out iq.cf32
  python -m psk_soft_tpu_torch ber --esn0 0,2,4,6,8,10 -M 4
  python -m psk_soft_tpu_torch baseline --config 3 --full
  python -m psk_soft_tpu_torch selftest

The arguments are the JAX parser's.  Every subcommand that runs the demod,
the decoder or the probe takes ``--device`` (default ``cuda``; ``cpu``
runs the plain versions) and fails on a machine without a GPU unless
``--device cpu`` is given.  ``demod`` and ``demod-batch`` are registered
and exit non-zero: they are ROADMAP step A.13.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_NOT_PORTED = ("demod", "demod-batch")


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


def _code_from_args(args):
    from .ops import fec as fec_ops

    code = {"k7": fec_ops.CODE_K7, "k9": fec_ops.CODE_K9}[args.fec]
    if args.fec_puncture:
        pat = {"2/3": fec_ops.PUNCTURE_2_3,
               "3/4": fec_ops.PUNCTURE_3_4}[args.fec_puncture]
        code = fec_ops.ConvCode(code.k, code.polys, pat)
    return code


def cmd_not_ported(args) -> int:
    print(f"psk_soft_tpu_torch: '{args.cmd}' is not ported yet (ROADMAP "
          f"A.13); run it with python -m psk_soft_tpu", file=sys.stderr)
    return 2


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
    """Run one of the BASELINE.json evaluation configs (1-4)."""
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

    for name, what in zip(_NOT_PORTED, (
            "demodulate an IQ file / stream (not ported yet: ROADMAP A.13)",
            "multichannel demod (not ported yet: ROADMAP A.13)")):
        sub.add_parser(name, help=what).set_defaults(fn=cmd_not_ported)

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
                        help="run a BASELINE.json evaluation config (1-4; "
                             "5 waits for ROADMAP A.11)")
    bl.add_argument("--config", type=int, required=True, choices=range(1, 6))
    bl.add_argument("--full", action="store_true",
                    help="full-size run (default: quick sizes)")
    _add_device_arg(bl)
    bl.set_defaults(fn=cmd_baseline)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    if args.cmd in _NOT_PORTED:
        return args.fn(args)
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
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
