"""The JAX package's randomized suites as data: case lists, signals and
event scripts, drawn from the same generators and seeds, so the port's CPU
tests and ``chip_smoke.py``'s conformance phase hold the port to the same
cases.

* :data:`FULL_KERNEL_CASES` (``tests/test_fuzz_full_kernel.py:19-33``),
  :data:`FORMAT_CASES` (``tests/test_fuzz_output_formats.py:41-59``) and
  :data:`EQUIV_CASES` (``tests/test_fuzz_equiv.py:16-29``): the same dicts
  as those modules' ``CASES``, TPU-only keys (``s_tile``,
  ``double_buffer``) included; :func:`b1_cases` puts the first two (and
  :data:`SPS2_CASE`) in one form for kernel B1.
* :data:`BITLAYER_CASES` (``tests/test_fuzz_bitlayer.py:29-43``) with
  codes, scramblers and CRCs by name (:func:`bitlayer_parts` builds the
  port's objects) and :func:`bitlayer_stream`, the loopback's signal.
* The soaks (``tests/test_soak.py``, ``tests/test_soak_receiver.py``) as
  event scripts, lists of ``(event, argument)`` drawn from a seed in the
  JAX tests' order of draws, and runners that take a script through an
  engine of either package (the module of packets is passed in).
* :func:`tie_signal` (``tests/test_tiebreak.py:22``).

Host numpy; nothing here imports jax (the frame scripts call the port's
numpy transmitter).
"""

from __future__ import annotations

import zlib

import numpy as np

FUZZ_C = 128                  # channels of the JAX fuzz tests
FULL_KERNEL_SEED = 20260818
FORMAT_SEED = 20260818 + 1
EQUIV_SEED = 20260817
FORMAT_SCALE = 100.0          # the format fuzz's int8 soft scale
FORMAT_WARM, FORMAT_RUN = 256, 128   # its warm-up and run symbols


def _full_kernel_cases() -> list:
    rng = np.random.default_rng(FULL_KERNEL_SEED)
    cases = []
    for _ in range(8):
        sps = int(rng.integers(4, 11))
        mf = str(rng.choice(["none", "none", "rrc", "boxcar"]))
        cases.append(dict(
            sps=sps,
            num_avg=int(rng.integers(8, 40)),
            constellation_size=int(rng.choice([2, 4, 8])),
            phase_avg=int(rng.integers(10, 30)),
            differential=bool(rng.integers(0, 2)),
            matched_filter=mf,
            rrc_span=int(rng.integers(3, 7)),
            timing_interp=bool(rng.integers(0, 2)),
            s_tile=int(rng.choice([32, 64, 128])),
            double_buffer=[None, False, True][int(rng.integers(0, 3))],
            nsym=int(rng.choice([256, 384])),
        ))
    return cases


def _format_cases() -> list:
    rng = np.random.default_rng(FORMAT_SEED)
    cases = []
    for _ in range(6):
        cases.append(dict(
            sps=int(rng.integers(4, 11)),
            num_avg=int(rng.integers(8, 40)),
            constellation_size=int(rng.choice([2, 4, 8])),
            phase_avg=int(rng.integers(10, 30)),
            differential=bool(rng.integers(0, 2)),
            matched_filter=str(rng.choice(["none", "none", "rrc"])),
            soft_i8=bool(rng.integers(0, 2)),
            debug_ports=bool(rng.integers(0, 2)),
            i16=bool(rng.integers(0, 2)),
            pack_out=[None, False][int(rng.integers(0, 2))],
            s_tile=int(rng.choice([32, 64])),
        ))
    # The densest interaction, always in the sweep.
    cases.append(dict(sps=8, num_avg=20, constellation_size=4, phase_avg=15,
                      differential=True, matched_filter="none", soft_i8=True,
                      debug_ports=False, i16=True, pack_out=None, s_tile=64))
    return cases


def _equiv_cases() -> list:
    rng = np.random.default_rng(EQUIV_SEED)
    cases = []
    for _ in range(12):
        sps = int(rng.integers(2, 13))
        cases.append(dict(
            sps=sps,
            num_avg=int(rng.integers(2, 40)),
            constellation_size=int(rng.choice([2, 4, 8])),
            phase_avg=int(rng.integers(1, 35)),
            differential=bool(rng.integers(0, 2)),
            nsym=int(rng.integers(80, 300)),
            splits=int(rng.integers(1, 5)),
            snr=float(rng.uniform(18, 30)),
            foff=float(rng.uniform(-2e-4, 2e-4)),
        ))
    return cases


FULL_KERNEL_CASES = _full_kernel_cases()
FORMAT_CASES = _format_cases()
EQUIV_CASES = _equiv_cases()

# The smallest sps and phase_avg kernel B1 takes (phase_avg >= the unwrap
# trend's 9 + 1), at the JAX fuzz's signal and block sizes.
SPS2_CASE = dict(sps=2, num_avg=20, constellation_size=4, phase_avg=10,
                 differential=False, matched_filter="none", nsym=384)

CFG_KEYS = ("sps", "num_avg", "constellation_size", "phase_avg",
            "differential", "matched_filter", "rrc_span", "timing_interp")


def case_cfg(case: dict) -> dict:
    """The DemodConfig keyword arguments of a fuzz case."""
    return {k: case[k] for k in CFG_KEYS if k in case}


def b1_cases() -> list:
    """Kernel B1's cases in one form: every full-kernel case, every format
    case and :data:`SPS2_CASE`, each ``dict(name, cfg, warm, run, i16,
    soft_i8, debug_ports, pack_out)``: DemodConfig keywords, warm-up and
    run symbols (the JAX tests' splits), and the B1 options (the full-
    kernel cases run none)."""
    out = []
    plain = dict(i16=False, soft_i8=False, debug_ports=True, pack_out=None)
    for i, c in enumerate(FULL_KERNEL_CASES):
        out.append(dict(name=f"full-{i}", cfg=case_cfg(c), warm=c["nsym"] // 2,
                        run=c["nsym"] - c["nsym"] // 2, **plain))
    for i, c in enumerate(FORMAT_CASES):
        cfg = case_cfg(c)
        out.append(dict(name=f"format-{i}", cfg=cfg, warm=FORMAT_WARM,
                        run=format_run_symbols(cfg), i16=c["i16"],
                        soft_i8=c["soft_i8"], debug_ports=c["debug_ports"],
                        pack_out=c["pack_out"]))
    out.append(dict(name="sps2", cfg=case_cfg(SPS2_CASE),
                    warm=SPS2_CASE["nsym"] // 2,
                    run=SPS2_CASE["nsym"] - SPS2_CASE["nsym"] // 2, **plain))
    return out


def format_run_symbols(cfg_kw: dict) -> int:
    """The format fuzz's run length: FORMAT_RUN symbols, or enough to hold
    the carry window and 8 more (tests/test_fuzz_output_formats.py:93-95)."""
    from ..config import DemodConfig
    from ..models.full import window_rows

    keep = window_rows(DemodConfig(**cfg_kw))
    sps = cfg_kw["sps"]
    return FORMAT_RUN if FORMAT_RUN * sps >= keep else -(-keep // sps) + 8


def impulse_channels(nsym: int, sps: int, m: int, differential: bool,
                     channels: int = FUZZ_C) -> np.ndarray:
    """(channels, nsym * sps) complex64: the fuzz tests' timing-decisive
    signal, every symbol's energy at sample 2 (sample 1 at sps 2) with a
    1e-4 offset and noise of std 0.005, channel i from seed i."""
    peak = min(2, sps - 1)
    xs = np.empty((channels, nsym * sps), np.complex64)
    for i in range(channels):
        r = np.random.default_rng(i)
        j = r.integers(0, m, nsym)
        pts = np.exp(2j * np.pi * j / m)
        if differential:
            pts = np.cumprod(pts)
        x = np.zeros(nsym * sps, np.complex64)
        x[peak::sps] = pts * np.exp(2j * np.pi * 1e-4 * sps
                                    * np.arange(nsym))
        x += (0.005 * r.standard_normal(x.size)).astype(np.complex64)
        xs[i] = x
    return xs


def fuzz_signal(cfg, nsym: int, channels: int = FUZZ_C) -> np.ndarray:
    """A fuzz case's (channels, nsym * sps) input for a config object:
    RRC-shaped PSK at 28 dB (``gen_psk_channel``) under a matched filter,
    else :func:`impulse_channels` (tests/test_fuzz_full_kernel.py:53-74)."""
    from .signals import gen_psk_channel

    sps, m = cfg.sps, cfg.constellation_size
    if cfg.matched_filter != "none":
        return np.stack([
            gen_psk_channel(nsym, sps=sps, m=m, seed=i, snr_db=28,
                            differential=cfg.differential, freq_offset=1e-4,
                            pulse="rrc", rrc_beta=cfg.rrc_beta,
                            rrc_span=cfg.rrc_span)[0]
            for i in range(channels)])
    return impulse_channels(nsym, sps, m, cfg.differential, channels)


def equiv_blocks(case: dict, sps: int) -> list:
    """tests/test_fuzz_equiv.py's stream of a case cut into its uneven,
    symbol-aligned blocks."""
    from .signals import gen_psk_channel

    x, _ = gen_psk_channel(case["nsym"], sps=sps,
                           m=case["constellation_size"],
                           differential=case["differential"],
                           seed=case["nsym"], snr_db=case["snr"],
                           freq_offset=case["foff"], timing_offset=1)
    cut = np.linspace(0, case["nsym"], case["splits"] + 1).astype(int)
    return [x[a * sps:b * sps] for a, b in zip(cut[:-1], cut[1:]) if b > a]


def int16_wire(run: np.ndarray):
    """The format fuzz's int16 ingest of a (C, T) block: in_scale (the
    largest component over 32000) and the time-major int16 planes."""
    in_scale = float(max(np.abs(run.real).max(),
                         np.abs(run.imag).max())) / 32000.0
    q_re = np.round(run.real.T / in_scale).astype(np.int16)
    q_im = np.round(run.imag.T / in_scale).astype(np.int16)
    return in_scale, np.ascontiguousarray(q_re), np.ascontiguousarray(q_im)


def tie_signal(num_symbols: int, sps: int, m: int, seed: int = 7):
    """A rectangular-pulse, noiseless, offset-free M-PSK stream: every
    sample of a symbol equal, so every timing bin's window sum ties
    exactly (tests/test_tiebreak.py:22)."""
    rng = np.random.default_rng(seed)
    pts = np.exp(2j * np.pi * rng.integers(0, m, num_symbols) / m)
    return np.repeat(pts, sps).astype(np.complex64)


TIE_CFG = dict(sps=8, num_avg=20, constellation_size=4, phase_avg=10)

# ---------------------------------------------------------------- bit layer

# (m, payload_symbols, code, interleave_rows, labeling, scrambler, crc):
# tests/test_fuzz_bitlayer.py's CASES with the objects named.
BITLAYER_CASES = [
    (4, 64, "k7", None, "scd", None, None),
    (4, 64, "k7", 8, "gray", "prbs15", "crc16"),
    (4, 64, "k7", 16, "scd", "prbs7", "crc32"),
    (2, 80, "k3", None, "gray", "prbs15", None),
    (2, 128, "k7", 32, "scd", None, "crc16"),
    (8, 64, "k7", None, "gray", "prbs15", "crc16"),
    (8, 48, "k7p34", 16, "scd", None, None),
    (4, 66, "k7p23", 4, "gray", "prbs7", "crc16"),
    (4, 60, None, None, "scd", "prbs15", "crc16"),
    (8, 40, None, None, "scd", None, "crc32"),
]
BITLAYER_SPLITS = (0, 171, 530)   # the uneven observe blocks' first symbols
LOOP_VARIANTS = 8             # distinct loopback streams over the channels


def bitlayer_id(case) -> str:
    m, p, code, il, lab, lf, crc = case
    return (f"m{m}-p{p}-{code or 'u'}-{lab}{'-il' if il else ''}"
            f"{'-scr' if lf else ''}{'-crc' if crc else ''}")


def bitlayer_parts(case):
    """The port's (code, lfsr, crc) objects of a bit-layer case (None where
    the case has none)."""
    from ..ops.crc import CRC16_CCITT, CRC32_MPEG2
    from ..ops.fec import (CODE_K3, CODE_K7, PUNCTURE_2_3, PUNCTURE_3_4,
                           ConvCode)
    from ..ops.scramble import prbs7, prbs15

    codes = {None: None, "k7": CODE_K7, "k3": CODE_K3,
             "k7p23": ConvCode(7, (0o171, 0o133), PUNCTURE_2_3),
             "k7p34": ConvCode(7, (0o171, 0o133), PUNCTURE_3_4)}
    lfsrs = {None: None, "prbs7": prbs7, "prbs15": prbs15}
    crcs = {None: None, "crc16": CRC16_CCITT, "crc32": CRC32_MPEG2}
    lf = lfsrs[case[5]]
    return codes[case[2]], (lf() if lf else None), crcs[case[6]]


def bitlayer_stream(case, channels: int = 1):
    """A loopback case's transmission (tests/test_fuzz_bitlayer.py:46-82)
    on ``channels`` channels: LOOP_VARIANTS distinct streams (each its own
    info bits, ambiguity rotation and noise, seeded from the case) repeated
    over the channels.  Returns (uw, starts, infos (channels, 3, n_info)
    int8, soft (channels, total) complex64).  One channel draws as the JAX
    test does from one seed, the case's name hashed with CRC-32 (the JAX
    test's ``hash(str(case))`` changes with the interpreter's hash seed)."""
    from ..ops import tx
    from ..ops.fec import info_bits_for
    from ..ops.framesync import FrameFormat

    m, payload, _, il_rows, labeling, _, _ = case
    code, lfsr, crc = bitlayer_parts(case)
    code_bits = payload * int(np.log2(m))
    n_info = info_bits_for(code, code_bits) if code is not None \
        else code_bits
    if crc is not None:
        n_info -= crc.degree
    rng = np.random.default_rng(zlib.crc32(bitlayer_id(case).encode()))
    uw = tuple(int(u) for u in rng.integers(0, m, 32))
    fmt = FrameFormat(uw=uw, payload=payload, m=m, threshold=0.6)
    starts = [60, 60 + fmt.frame_len + 40, 60 + 2 * (fmt.frame_len + 40)]
    total = starts[-1] + fmt.frame_len + 60
    n_var = min(channels, LOOP_VARIANTS)
    infos = np.zeros((n_var, len(starts), n_info), np.int8)
    soft = np.zeros((n_var, total), np.complex64)
    sigma = 0.02 if m == 8 else 0.05
    for v in range(n_var):
        infos[v] = [rng.integers(0, 2, n_info, np.int8) for _ in starts]
        idx = tx.frame_stream(fmt, list(infos[v]), starts, total, code=code,
                              lfsr=lfsr, crc=crc, interleave_rows=il_rows,
                              labeling=labeling, seed=3)
        x = tx.symbols_to_iq(m, idx).astype(np.complex64)
        rot = np.exp(2j * np.pi * int(rng.integers(0, m)) / m)
        soft[v] = (x * rot + sigma * (rng.standard_normal(x.size)
                                      + 1j * rng.standard_normal(x.size)))
    reps = -(-channels // n_var)
    return (uw, starts, np.tile(infos, (reps, 1, 1))[:channels],
            np.tile(soft, (reps, 1))[:channels])


# ------------------------------------------------------------------ soaks

def chunk(rng, n: int, m: int, sps: int) -> np.ndarray:
    """n samples of rectangular M-PSK plus noise of std 0.01
    (tests/test_soak.py:31-40)."""
    syms = int(np.ceil(n / sps)) + 1
    pts = np.exp(2j * np.pi * rng.integers(0, m, syms) / m)
    x = np.repeat(pts, sps)[:n].astype(np.complex64)
    return x + (0.01 * rng.standard_normal(n)).astype(np.complex64)


def rand_cfg(rng, sps: int = 8) -> dict:
    """A random configuration's DemodConfig keywords
    (tests/test_soak.py:43-50)."""
    return dict(sps=sps,
                num_avg=int(rng.choice([30, 50, 100])),
                constellation_size=int(rng.choice([2, 4, 8])),
                phase_avg=int(rng.choice([10, 20, 50])),
                differential=bool(rng.random() < 0.5))


STREAM_SOAK_CFG = dict(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
STREAM_SOAK_SEEDS = (0, 1, 2)
STREAM_SOAK_BLOCK = 64
STREAM_SOAK_XDELTA = 0.01


def stream_soak_script(seed: int) -> list:
    """tests/test_soak.py:52-110's events for one StreamEngine: 40 draws
    of ("push", x), ("configure", kw), ("flush", x) (a push flagged as
    after a queue flush), ("rate", xdelta) or ("real", x) (a real-mode
    push), then ("eos", x)."""
    rng = np.random.default_rng(seed)
    sps, m = STREAM_SOAK_CFG["sps"], STREAM_SOAK_CFG["constellation_size"]
    script = []
    for _ in range(40):
        ev = str(rng.choice(["push", "push", "push", "push", "reconf",
                             "flush", "rate", "real"]))
        if ev == "push":
            script.append(("push", chunk(rng, int(rng.integers(100, 3000)),
                                         m, sps)))
        elif ev == "reconf":
            kw = rand_cfg(rng)
            m = kw["constellation_size"]
            script.append(("configure", kw))
        elif ev == "flush":
            script.append(("flush", chunk(rng, 800, m, sps)))
        elif ev == "rate":
            script.append(("rate", float(rng.choice([0.005, 0.01, 0.02]))))
        else:
            script.append(("real", np.ones(160, np.complex64)))
    script.append(("eos", chunk(rng, 4096, m, sps)))
    return script


def run_stream_script(eng, streams, cfg_cls, script) -> list:
    """Drive a StreamEngine of either package through a
    :func:`stream_soak_script` (``streams``: that package's packet module,
    ``cfg_cls`` its DemodConfig).  Returns [(event, outputs,
    bits_per_symbol of the configuration in force)] for every event (None
    for a configure and a rate change, which emit nothing)."""
    xdelta, t, outs = STREAM_SOAK_XDELTA, 0.0, []
    for ev, arg in script:
        if ev in ("configure", "rate"):
            if ev == "configure":
                eng.configure(cfg_cls(**arg))
            else:
                xdelta = arg
            outs.append((ev, None, eng.cfg.bits_per_symbol))
            continue
        sri = streams.SRI(stream_id="soak", xdelta=xdelta,
                          mode=0 if ev == "real" else 1)
        pkt = streams.Packet(data=arg, sri=sri, t=t,
                             input_queue_flushed=ev == "flush",
                             eos=ev == "eos")
        t += arg.size * xdelta
        outs.append((ev, eng.process(pkt), eng.cfg.bits_per_symbol))
    return outs


BATCH_SOAK_CFG = dict(sps=8, num_avg=30, constellation_size=4, phase_avg=10)
BATCH_SOAK_SEEDS = (100, 101)
BATCH_SOAK_C = 4
BATCH_SOAK_BLOCK = 32


def batch_soak_script(seed: int, channels: int = BATCH_SOAK_C) -> list:
    """tests/test_soak.py:113-151's events for one BatchEngine: 30 draws of
    ("push", (channels, n) block), ("configure", kw), ("reset", None) or
    ("flush", None), then ("flush", None)."""
    rng = np.random.default_rng(seed)
    sps, m = BATCH_SOAK_CFG["sps"], BATCH_SOAK_CFG["constellation_size"]
    script = []
    for _ in range(30):
        ev = str(rng.choice(["push", "push", "push", "reconf", "reset",
                             "flush"]))
        if ev == "push":
            n = int(rng.integers(1, 4)) * BATCH_SOAK_BLOCK * sps
            script.append(("push", np.stack([chunk(rng, n, m, sps)
                                             for _ in range(channels)])))
        elif ev == "reconf":
            kw = rand_cfg(rng)
            m = kw["constellation_size"]
            script.append(("configure", kw))
        else:
            script.append((ev, None))
    script.append(("flush", None))
    return script


FULL_SOAK_CFG = dict(sps=8, num_avg=50, constellation_size=4, phase_avg=20)
FULL_SOAK_SEED = 7
FULL_SOAK_BLOCK = 64


def full_soak_script() -> list:
    """tests/test_soak.py:154-192's events for a FullKernelBatchEngine at
    FUZZ_C channels: 4 blocks (warm-up, then the kernel), configure
    phase_avg 20 -> 10, 3 blocks, reset, 2 blocks, flush."""
    rng = np.random.default_rng(FULL_SOAK_SEED)
    sps, m = FULL_SOAK_CFG["sps"], FULL_SOAK_CFG["constellation_size"]

    def blocks(k):
        return [("push", np.stack([chunk(rng, FULL_SOAK_BLOCK * sps, m, sps)
                                   for _ in range(FUZZ_C)]))
                for _ in range(k)]

    return (blocks(4) + [("configure", dict(FULL_SOAK_CFG, phase_avg=10))]
            + blocks(3) + [("reset", None)] + blocks(2)
            + [("flush", None)])


def run_bank_script(eng, cfg_cls, script, drain: bool = True) -> list:
    """Drive a bank engine of either package through a batch or full soak
    script: after each push, step_packets until it returns None (``drain``,
    the BatchEngine soak) or once (the FullKernelBatchEngine soak).
    Returns [(event, packets, bits_per_symbol of the configuration in
    force)] of every step and flush."""
    outs = []
    for ev, arg in script:
        if ev == "push":
            eng.push_block(arg)
            while True:
                pkts = eng.step_packets()
                if pkts is None:
                    break
                outs.append((ev, pkts, eng.cfg.bits_per_symbol))
                if not drain:
                    break
        elif ev == "configure":
            eng.configure(cfg_cls(**arg))
        elif ev == "reset":
            eng.reset()
        else:
            outs.append((ev, eng.flush_packets(), eng.cfg.bits_per_symbol))
    return outs


FRAME_SOAK_SEEDS = (300, 301, 302)
FRAME_SOAK_MAX_FRAMES = 16


def frame_soak_script(seed: int) -> tuple:
    """tests/test_soak_receiver.py:31-84's events for the frame stack
    (FrameSyncer(2) -> FecFrameDecoder(K7) -> FrameDescrambler(PRBS15) ->
    FrameCrcChecker(CRC-16)): the UW, then 60 draws of ("observe", (2, s)
    soft), ("drain", None), ("finalize", None) or ("reset", None)."""
    from ..ops import tx
    from ..ops.crc import CRC16_CCITT
    from ..ops.fec import CODE_K7, info_bits_for
    from ..ops.framesync import FrameFormat
    from ..ops.scramble import prbs15

    rng = np.random.default_rng(seed)
    uw = tuple(int(u) for u in rng.integers(0, 4, 32))
    fmt = FrameFormat(uw=uw, payload=64, m=4, threshold=0.7)
    n_msg = info_bits_for(CODE_K7, 128) - CRC16_CCITT.degree
    script = []
    for _ in range(60):
        ev = str(rng.choice(["observe", "observe", "observe", "drain",
                             "finalize", "reset"]))
        if ev != "observe":
            script.append((ev, None))
            continue
        s = int(rng.integers(1, 260))
        if s >= fmt.frame_len + 8:
            info = rng.integers(0, 2, n_msg, np.int8)
            idx = tx.frame_stream(fmt, [info], [4], s, code=CODE_K7,
                                  lfsr=prbs15(), crc=CRC16_CCITT,
                                  seed=int(rng.integers(1 << 30)))
        else:
            idx = rng.integers(0, 4, s)
        x = tx.symbols_to_iq(4, np.stack([idx, idx[::-1]]))
        script.append(("observe", (x + 0.03 * (
            rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
        ).astype(np.complex64)))
    return uw, n_msg, script


FEC_SOAK_SEEDS = (400, 401)
FEC_SOAK_DEPTH, FEC_SOAK_BLOCK = 70, 128


def fec_soak_script(seed: int, rows: int = 2) -> list:
    """tests/test_soak_receiver.py:87-115's events for a StreamFecDecoder
    (QPSK): 40 draws of ("observe", (rows, s) soft), ("pop", None),
    ("reset", None) or ("finalize", None), then ("finalize", None) and
    ("pop", None)."""
    from ..ops import tx

    rng = np.random.default_rng(seed)
    script = []
    for _ in range(40):
        ev = str(rng.choice(["observe", "observe", "observe", "pop", "reset",
                             "finalize"]))
        if ev == "observe":
            s = int(rng.integers(1, 400))
            soft = tx.symbols_to_iq(4, rng.integers(0, 4, (rows, s)))
            script.append((ev, (soft + 0.05 * rng.standard_normal(soft.shape)
                                ).astype(np.complex64)))
        else:
            script.append((ev, None))
    return script + [("finalize", None), ("pop", None)]


def frame_stack(classes, channels: int, fmt, code=None, lfsr=None, crc=None,
                interleave_rows=None, labeling: str = "scd",
                max_frames: int = 4096, **kw):
    """The standalone frame path of either package: ``classes`` = its
    (FrameSyncer, FecFrameDecoder, FrameDescrambler, FrameCrcChecker),
    ``kw`` the port's ``device``.  Returns (syncer, top stage)."""
    syncer_cls, fec_cls, descramble_cls, crc_cls = classes
    sync = top = syncer_cls(channels, fmt, max_frames=max_frames, **kw)
    if code is not None:
        top = fec_cls(top, code, interleave_rows=interleave_rows,
                      labeling=labeling, **kw)
    if lfsr is not None:
        top = descramble_cls(top, lfsr, **kw)
    if crc is not None:
        top = crc_cls(top, crc, **kw)
    return sync, top


def run_loopback(sync, top, soft) -> list:
    """tests/test_fuzz_bitlayer.py's drive: the (C, total) soft stream in
    the uneven blocks of BITLAYER_SPLITS, finalize, pop."""
    cuts = BITLAYER_SPLITS + (soft.shape[1],)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        sync.observe(soft[:, lo:hi])
    sync.finalize()
    return top.pop_frames()


def run_frame_soak(sync, top, script) -> list:
    """Drive a frame stack through a :func:`frame_soak_script`; returns,
    after every event, (event, frames drained, frames_synced,
    dropped_frames, frames_decoded, frames_descrambled, frames_checked)."""
    out = []
    for ev, arg in script:
        frames = []
        if ev == "observe":
            sync.observe(arg)
        elif ev == "finalize":
            sync.finalize()
        elif ev == "reset":
            top.reset()
        else:
            frames = top.pop_frames()
        out.append((ev, frames, sync.frames_synced, sync.dropped_frames,
                    top.frames_decoded, top.frames_descrambled,
                    top.frames_checked))
    return out


def run_fec_soak(dec, script) -> list:
    """Drive a StreamFecDecoder through a :func:`fec_soak_script`; returns
    [(event, bits popped or None, steps_decoded)]."""
    out = []
    for ev, arg in script:
        bits = None
        if ev == "observe":
            dec.observe(arg)
        elif ev == "pop":
            bits = dec.pop_bits()
        elif ev == "finalize":
            dec.finalize()
        else:
            dec.reset()
        out.append((ev, None if bits is None else np.asarray(bits),
                    dec.steps_decoded))
    return out
