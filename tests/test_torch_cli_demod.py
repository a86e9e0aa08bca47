"""Port parity, command line: ``python -m psk_soft_tpu_torch``'s ``demod``
and ``demod-batch`` against ``psk_soft_tpu.cli`` in-process, case by case.

Each case of ``tests/test_cli.py`` that runs ``demod`` or ``demod-batch``,
and ``tests/test_review_fixes.py::test_cli_demod_batch_flushes_remainder``,
is one parametrized case here: the same numpy-made capture from the same
seed and the same arguments go through both CLIs (the port with ``--device
cpu``, JAX with ``--interpret`` where it runs ``--pipeline full`` or
``--fused-chain``), and the files they write are held against each other:

* ``.bits.i16``, ``.index.i16`` and ``.fecstream.i8`` byte-equal;
* ``.soft.cf32`` within 3e-3 on the full pipeline and 2e-3 on ff, and
  ``.phase.f32`` within 2e-3 (modulo M*2pi on the full pipeline, whose
  kernel re-wraps the phase history per block where Pallas re-wraps per
  tile) -- ``tests/test_full_kernel.py:60-68``'s and
  ``tests/test_oracle_parity.py:45-47``'s tolerances;
* ``.frames.jsonl``: the same (channel, start) set, ``bits``,
  ``info_bits``, ``rotation``, ``corrected``, ``suspect`` and ``crc_ok``
  equal, ``corr`` and ``residual_phase`` within 1e-3;
* a sample index may differ only at a near tie: the window sums of the
  engine's input (float64, after the matched filter) at the two picks lie
  within 1e-5 of the largest, as ``chip_smoke.py``'s B1Gate rules on the
  card.  The test captures' rectangular pulses put every sample of a
  symbol within the noise of the others, and the two packages' windowed
  sums round such a tie differently.  Soft and phase are held where the
  tracker window (phase_avg + the trend) holds no differing pick, bits
  everywhere (in the zero-padded tail a resampler drains at EOS, where a
  window below a millionth of its channel's typical sum holds no signal
  and ties at every sample, from the first differing pick on);
* the quality report within ``tests/test_torch_quality.py``'s engine-level
  tolerances (rtol 1e-3, atol 1e-4; symbol counts equal);
* the stderr metrics (and ``--auto``'s line) equal, and every flag-contract
  error the same ``SystemExit`` message word for word.

Then each case's own gates from ``tests/test_cli.py`` hold on the port's
files alone.  Also: the parsers' option sets are the JAX ones less
``--interpret``, plus ``--device``, and ``--interpret`` is refused.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from psk_soft_tpu import cli as jax_cli
from psk_soft_tpu_torch import cli

torch.set_num_threads(1)

PREFIX = "<prefix>"           # replaced by each CLI's own output prefix
QUALITY = "<quality>"         # replaced by each CLI's own report path
SOFT_TOL = {"full": 3e-3, "ff": 2e-3}
PHASE_TOL = 2e-3
FRAME_TOL = 1e-3
FRAME_EQUAL = ("bits", "info_bits", "rotation", "corrected", "suspect",
               "crc_ok")
NEAR_TIE_REL = 1e-5
SILENT = 1e-6
PORT_FILES = ((".soft.cf32", np.complex64), (".bits.i16", np.int16),
              (".phase.f32", np.float32), (".index.i16", np.int16),
              (".fecstream.i8", np.int8))


@dataclasses.dataclass
class Run:
    argv: list
    pipeline: str = "ff"      # "ff" or "full" (the JAX side gets --interpret)
    fails: bool = False       # a flag-contract error: compare the messages
    m: int = 4
    ties: dict | None = None  # the engine's input, for the near-tie rule:
    # x (C, T) complex, sps, num_avg, phase_avg, taps (matched filter),
    # tied_bits (a differing pick taints its channel to the end)


@dataclasses.dataclass
class Out:
    rc: object                # 0, or the SystemExit message
    err: list                 # stderr lines
    files: dict               # extension -> array, for the files written
    frames: list | None
    quality: dict | None


def _invoke(main, argv, prefix, capsys):
    argv = [str(prefix) if a == PREFIX else
            f"{prefix}.quality.json" if a == QUALITY else a for a in argv]
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    err = capsys.readouterr().err.strip().splitlines()
    files = {}
    for ext, dtype in PORT_FILES:
        path = prefix.parent / (prefix.name + ext)
        if path.exists():
            files[ext] = np.fromfile(path, dtype)
    fpath = prefix.parent / (prefix.name + ".frames.jsonl")
    frames = ([json.loads(line) for line in fpath.read_text().splitlines()]
              if fpath.exists() else None)
    qpath = prefix.parent / (prefix.name + ".quality.json")
    quality = json.loads(qpath.read_text()) if qpath.exists() else None
    return Out(rc, err, files, frames, quality)


def _json_lines(err):
    return [json.loads(line) for line in err if line.startswith("{")]


def _wrapped(a, b, period):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d - period * np.round(d / period)).max()


def _compare(got: Out, want: Out, run: Run):
    if run.fails:
        assert isinstance(got.rc, str) and got.rc == want.rc, (got.rc,
                                                               want.rc)
        return
    assert got.rc == want.rc == 0, (got.rc, got.err, want.rc)
    assert _json_lines(got.err) == _json_lines(want.err)
    assert ([l for l in got.err if l.startswith("warning")]
            == [l for l in want.err if l.startswith("warning")])
    assert set(got.files) == set(want.files)
    for ext, a in got.files.items():
        assert a.shape == want.files[ext].shape, (ext, a.shape)
    n_ch = _channels(run)
    moved = bits_moved = None
    if ".index.i16" in got.files:
        gi, wi = (o.files[".index.i16"].reshape(-1, n_ch) for o in (got,
                                                                     want))
        moved, bits_moved = _tainted(gi, wi, run.ties)
    for ext, a in got.files.items():
        b = want.files[ext]
        if ext in (".soft.cf32", ".phase.f32"):
            a, b = a.reshape(-1, n_ch), b.reshape(-1, n_ch)
            if moved is not None:
                a, b = a[~moved], b[~moved]
            if not a.size:
                continue
            if ext == ".soft.cf32":
                err, tol = np.abs(a - b).max(), SOFT_TOL[run.pipeline]
            else:
                err = (_wrapped(a, b, run.m * 2 * np.pi)
                       if run.pipeline == "full" else np.abs(a - b).max())
                tol = PHASE_TOL
            assert err <= tol, (ext, err)
        elif ext == ".bits.i16" and bits_moved is not None \
                and bits_moved.any():
            keep, rows = ~bits_moved, bits_moved.shape[0]
            assert np.array_equal(a.reshape(rows, n_ch, -1)[keep],
                                  b.reshape(rows, n_ch, -1)[keep]), ext
        elif ext != ".index.i16":
            assert a.tobytes() == b.tobytes(), ext
    assert (got.frames is None) == (want.frames is None)
    if got.frames is not None:
        g = {(f["channel"], f["start"]): f for f in got.frames}
        w = {(f["channel"], f["start"]): f for f in want.frames}
        assert len(g) == len(got.frames) and set(g) == set(w)
        for key, f in g.items():
            assert set(f) == set(w[key]), key
            for name in FRAME_EQUAL:
                if name in f:
                    assert f[name] == w[key][name], (key, name)
            for name in ("corr", "residual_phase"):
                if name in f:
                    assert abs(f[name] - w[key][name]) <= FRAME_TOL, (key,
                                                                      name)
    assert (got.quality is None) == (want.quality is None)
    if got.quality is not None:
        assert set(got.quality) == set(want.quality)
        assert got.quality["symbols"] == want.quality["symbols"]
        for name in ("amp", "power", "lock", "evm_pct", "snr_db"):
            np.testing.assert_allclose(got.quality[name], want.quality[name],
                                       rtol=1e-3, atol=1e-4, err_msg=name)


def _channels(run):
    argv = run.argv
    return int(argv[argv.index("--channels") + 1]) if "--channels" in argv \
        else 1


def _tainted(gi, wi, ties):
    """(rows, C) masks of the outputs a differing sample index moved (soft
    and phase), and of the bits it may move, after holding every
    differing pick to the near-tie rule on the engine's input."""
    from psk_soft_tpu_torch.ops.phase import UNWRAP_TREND_LEN

    differ = gi != wi
    if not differ.any():
        return differ, differ
    assert ties is not None, f"sample index differs at {differ.sum()} " \
        f"outputs of a run with no near-tie input"
    x = np.asarray(ties["x"], np.complex128)
    if ties.get("taps") is not None:
        x = np.stack([np.convolve(r, ties["taps"])[:r.size] for r in x])
    sps, na = ties["sps"], ties["num_avg"]
    n_sym = x.shape[1] // sps
    e = (np.abs(x[:, :n_sym * sps]) ** 2).reshape(x.shape[0], n_sym, sps)
    csum = np.concatenate([np.zeros_like(e[:, :1]), e.cumsum(axis=1)], 1)
    tops = (csum[:, na:] - csum[:, :-na]).max(axis=2)   # (C, symbols)
    for r, c in zip(*np.nonzero(differ)):
        w = e[c, r:r + na].sum(axis=0)      # output r is symbol r + na - 1
        # A window without signal (below a millionth of the channel's
        # typical sum: the EOS padding) ties at every sample.
        bound = NEAR_TIE_REL * w.max() + SILENT * np.median(tops[c])
        for pick in (gi[r, c], wi[r, c]):
            assert w.max() - w[pick] <= bound, (r, c, w, pick)
    count = np.cumsum(differ, axis=0)
    span = ties["phase_avg"] + UNWRAP_TREND_LEN
    before = np.zeros_like(count)
    before[span + 1:] = count[:-span - 1]
    moved = count - before > 0
    return moved, (count > 0 if ties.get("tied_bits") else
                   np.zeros_like(moved))


# -- the cases: each returns (runs, gate on the port's outputs) ---------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _signal(channels=1, symbols=384, seed=0):
    from psk_soft_tpu_torch.testing.signals import gen_psk_channel
    return np.stack([gen_psk_channel(symbols, 8, 4, snr_db=25.0,
                                     freq_offset=1e-4, seed=seed + c)[0]
                     .astype(np.complex64) for c in range(channels)])


def _cfg(**kw):
    from psk_soft_tpu_torch.config import DemodConfig
    kw = dict(dict(sps=8, num_avg=20, constellation_size=4, phase_avg=10),
              **kw)
    return DemodConfig(**kw)


def _write(path, x):
    path.write_bytes(np.ascontiguousarray(x).tobytes())
    return str(path)


COMMON = ["--sps", "8", "-M", "4", "--num-avg", "20", "--phase-avg", "10"]


@case
def demod_matches_in_process_engine(tmp):          # tests/test_cli.py:54
    x = _signal()[0]
    infile = _write(tmp / "iq.cf32", x)
    runs = [Run(["demod", "--in", infile, "--out-prefix", PREFIX, *COMMON,
                 "--block-symbols", "64", "--chunk-samples", "1000"])]

    def gate(outs):
        from psk_soft_tpu_torch.runtime.engine import StreamEngine
        from psk_soft_tpu_torch.runtime.streams import (
            SRI, Packet, PORT_BITS, PORT_PHASE, PORT_SAMPLE_INDEX, PORT_SOFT)
        o = outs[0]
        metrics = json.loads(o.err[-1])
        assert metrics["samples_in"] == x.size
        eng = StreamEngine(_cfg(), block_symbols=64, device="cpu")
        ref = eng.process(Packet(data=x, sri=SRI(stream_id="t", xdelta=1.0,
                                                 mode=1), t=0.0, eos=True))
        np.testing.assert_allclose(o.files[".soft.cf32"],
                                   ref[PORT_SOFT].data, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(o.files[".bits.i16"],
                                      ref[PORT_BITS].data)
        np.testing.assert_allclose(o.files[".phase.f32"],
                                   ref[PORT_PHASE].data, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(o.files[".index.i16"],
                                      ref[PORT_SAMPLE_INDEX].data)
        assert metrics["symbols_out"] == o.files[".soft.cf32"].size
        assert metrics["bits_out"] == o.files[".bits.i16"].size
    return runs, gate


@case
def demod_batch_interleaved_channels(tmp):         # tests/test_cli.py:96
    C = 2
    xs = _signal(channels=C, symbols=320, seed=7)
    infile = _write(tmp / "batch.cf32", xs.T)
    runs = [Run(["demod-batch", "--in", infile, "--channels", str(C),
                 "--out-prefix", PREFIX, *COMMON, "--block-symbols", "64",
                 "--chunk-samples", "512"])]

    def gate(outs):
        from psk_soft_tpu_torch.runtime.engine import BatchEngine
        from psk_soft_tpu_torch.utils.transfer import to_host
        o = outs[0]
        assert json.loads(o.err[-1])["samples_in"] == xs.size
        soft = o.files[".soft.cf32"].reshape(-1, C)
        bits = o.files[".bits.i16"].reshape(-1, C, 2)
        assert soft.shape[0] == bits.shape[0] > 0
        assert np.all(np.isfinite(soft))
        assert np.all((bits == 0) | (bits == 1))
        eng = BatchEngine(_cfg(), channels=C, block_symbols=64, device="cpu")
        for c in range(C):
            eng.push(c, xs[c])
        ref = []
        while (out := eng.step()) is not None:
            out = to_host(out)
            ref.append(out.soft[:, out.valid[0]])
        ref = np.concatenate(ref, axis=1)
        n = min(soft.shape[0], ref.shape[1])
        assert n > 100
        np.testing.assert_allclose(soft[:n], ref[:, :n].T, rtol=0,
                                   atol=1e-5)
    return runs, gate


def _ci16(xs):
    scale = float(max(np.abs(xs.real).max(), np.abs(xs.imag).max())) / 32000.0
    inter = np.ascontiguousarray(xs.T)
    wire = np.empty((inter.shape[0], xs.shape[0], 2), np.int16)
    wire[..., 0] = np.round(inter.real / scale)
    wire[..., 1] = np.round(inter.imag / scale)
    deq = ((wire[..., 0].astype(np.float32) * scale)
           + 1j * (wire[..., 1].astype(np.float32) * scale)).astype(
               np.complex64)
    return wire, deq, scale


@case
def demod_batch_ci16_wire_format(tmp):             # tests/test_cli.py:153
    C = 2
    wire, deq, scale = _ci16(_signal(channels=C, symbols=320, seed=11))
    common = ["--channels", str(C), *COMMON, "--block-symbols", "64",
              "--chunk-samples", "512", "--out-prefix", PREFIX]
    runs = [Run(["demod-batch", "--in", _write(tmp / "wire.ci16", wire),
                 "--in-format", "ci16", "--in-scale", repr(scale), *common]),
            Run(["demod-batch", "--in", _write(tmp / "wire.cf32", deq),
                 *common])]

    def gate(outs):
        s16, s32 = (o.files[".soft.cf32"] for o in outs)
        assert s16.size == s32.size > 0
        np.testing.assert_allclose(s16, s32, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(outs[0].files[".bits.i16"],
                                      outs[1].files[".bits.i16"])
    return runs, gate


@case
def demod_batch_full_pipeline_soft_i8(tmp):        # tests/test_cli.py:192
    C, S, sps = 128, 384, 8
    rng = np.random.default_rng(3)
    pts = np.exp(2j * np.pi * rng.integers(0, 4, (C, S)) / 4
                 + 2j * np.pi * 1e-4 * np.arange(S))
    xs = np.repeat(pts, sps, axis=1).astype(np.complex64)
    xs += (0.01 * rng.standard_normal(xs.shape)).astype(np.complex64)
    base = ["demod-batch", "--in", _write(tmp / "bank.cf32", xs.T),
            "--channels", str(C), "--sps", str(sps), "-M", "4", "--num-avg",
            "50", "--phase-avg", "20", "--block-symbols", "128",
            "--pipeline", "full", "--out-prefix", PREFIX]
    ties = dict(x=xs, sps=sps, num_avg=50, phase_avg=20)
    runs = [Run(base, "full", ties=ties),
            Run(base + ["--soft-i8"], "full", ties=ties)]

    def gate(outs):
        a, b = (o.files[".soft.cf32"] for o in outs)
        assert a.size == b.size > 0
        assert np.abs(a - b).max() <= 0.7072 / 100.0 + 1e-6
        np.testing.assert_array_equal(outs[0].files[".bits.i16"],
                                      outs[1].files[".bits.i16"])
    return runs, gate


def _bandlimited(seed, nsym, sps, offset=0.0):
    from psk_soft_tpu_torch.ops.matched_filter import rrc_taps
    rng = np.random.default_rng(seed)
    up = np.zeros((nsym + 16) * sps, np.complex128)
    up[::sps] = np.exp(2j * np.pi * rng.integers(0, 4, nsym + 16) / 4
                       + 1j * offset)
    return np.convolve(up, rrc_taps(sps, 0.35, 8).astype(np.float64),
                       mode="same")


@case
def demod_batch_native_sps_resampling(tmp):        # tests/test_cli.py:224
    from psk_soft_tpu_torch.testing.signals import sinc_interp
    C, sps, nsym = 2, 8, 420
    native = [7.3, 8.0]
    n_capture = nsym * sps
    xs = np.stack([
        sinc_interp(_bandlimited(20 + c, nsym, sps, np.pi / 4),
                    np.arange(n_capture) / (native[c] / sps))
        for c in range(C)]).astype(np.complex64)
    runs = [Run(["demod-batch", "--in", _write(tmp / "hetero.cf32", xs.T),
                 "--channels", str(C), "--out-prefix", PREFIX, *COMMON,
                 "--block-symbols", "64", "--chunk-samples", "333",
                 "--native-sps", ",".join(str(v) for v in native)])]

    def gate(outs):
        from psk_soft_tpu_torch.runtime.engine import BatchEngine
        from psk_soft_tpu_torch.runtime.resampler import ResamplerBank
        from psk_soft_tpu_torch.utils.transfer import to_host
        o = outs[0]
        metrics = json.loads(o.err[-1])
        soft = o.files[".soft.cf32"].reshape(-1, C)
        assert soft.shape[0] > 300
        assert metrics["symbols_out"] == soft.shape[0] * C
        assert metrics["samples_in"] == xs.size
        assert metrics["resampled_in"] > 0
        rs = ResamplerBank([v / sps for v in native], block_out=64 * sps,
                           device="cpu")
        eng = BatchEngine(_cfg(), channels=C, block_symbols=64, device="cpu")
        for c in range(C):
            rs.push(c, xs[c])
        while (blk := rs.step()) is not None:
            eng.push_block(blk)
        for blk in rs.drain(planes=False):
            eng.push_block(blk)
        ref = []
        while (out := eng.step()) is not None:
            out = to_host(out)
            ref.append(out.soft[:, out.valid[0]])
        ref = np.concatenate(ref, axis=1)
        n = min(soft.shape[0], ref.shape[1])
        assert n > 300
        np.testing.assert_allclose(soft[:n], ref[:, :n].T, rtol=0,
                                   atol=1e-5)
    return runs, gate


@case
def demod_batch_native_sps_full_pipeline(tmp):     # tests/test_cli.py:302
    from psk_soft_tpu_torch.ops.matched_filter import rrc_taps
    from psk_soft_tpu_torch.runtime.resampler import ResamplerBank
    C, sps, nsym = 128, 8, 384
    rng = np.random.default_rng(5)
    native = np.round(rng.uniform(7.0, 9.5, C), 2)

    def channel(c):
        x8 = _bandlimited(100 + c, nsym, sps)
        t = np.arange(nsym * sps) / (native[c] / sps)
        base = np.floor(t).astype(np.int64)
        b1 = np.minimum(base + 1, x8.size - 1)
        fr = t - base
        return ((1 - fr) * x8[np.minimum(base, x8.size - 1)]
                + fr * x8[b1]).astype(np.complex64)

    xs = np.stack([channel(c) for c in range(C)])
    # The engine's input: the bank resampled (the port's resampler, within
    # 1e-6 of JAX's) and the drain's zero padding.
    rs = ResamplerBank(native / sps, block_out=64 * sps, device="cpu")
    for c in range(C):
        rs.push(c, xs[c])
    planes = []
    while (blk := rs.step_planes()) is not None:
        planes.append(blk)
    planes += rs.drain(planes=True)
    x = torch.cat([torch.complex(*p) for p in planes]).T.numpy()
    runs = [Run(["demod-batch", "--in", _write(tmp / "hf.cf32", xs.T),
                 "--channels", str(C), "--out-prefix", PREFIX, *COMMON,
                 "--matched-filter", "rrc", "--block-symbols", "64",
                 "--pipeline", "full",
                 "--native-sps", ",".join(str(v) for v in native)], "full",
                ties=dict(x=x, sps=sps, num_avg=20, phase_avg=10,
                          taps=rrc_taps(sps, 0.35, 8), tied_bits=True))]

    def gate(outs):
        o = outs[0]
        soft = o.files[".soft.cf32"].reshape(-1, C)
        assert soft.shape[0] > 200
        assert json.loads(o.err[-1])["symbols_out"] == soft.shape[0] * C
        assert np.all(np.isfinite(soft))
        mags = np.abs(soft[64:-32])
        assert np.median(mags) > 0.7
        assert (np.abs(np.median(mags, axis=0) - 1.0) < 0.35).all()
    return runs, gate


@case
def demod_batch_native_sps_ci16_wire(tmp):         # tests/test_cli.py:355
    C = 2
    wire, deq, scale = _ci16(_signal(channels=C, symbols=300, seed=13))
    common = ["--channels", str(C), *COMMON, "--block-symbols", "64",
              "--native-sps", "7.5,8.25", "--out-prefix", PREFIX]
    runs = [Run(["demod-batch", "--in", _write(tmp / "rs.ci16", wire),
                 "--in-format", "ci16", "--in-scale", repr(scale), *common]),
            Run(["demod-batch", "--in", _write(tmp / "rs.cf32", deq),
                 *common])]

    def gate(outs):
        s16, s32 = (o.files[".soft.cf32"] for o in outs)
        assert s16.size == s32.size > 0
        np.testing.assert_allclose(s16, s32, rtol=0, atol=1e-5)
    return runs, gate


@case
def demod_batch_acquire_cfo(tmp):                  # tests/test_cli.py:393
    C, sps, m, ns = 2, 8, 4, 1400
    f = 3.0 / (2 * m * sps)
    rng = np.random.default_rng(21)
    xs, syms = [], []
    for c in range(C):
        j = rng.integers(0, m, ns)
        x = np.repeat(np.exp(2j * np.pi * j / m), sps)
        x = x * np.exp(2j * np.pi * (f if c == 0 else -f)
                       * np.arange(x.size))
        x = x + 0.002 * (rng.standard_normal(x.size)
                         + 1j * rng.standard_normal(x.size))
        xs.append(x.astype(np.complex64))
        syms.append(np.exp(2j * np.pi * j / m))
    common = ["demod-batch", "--in", _write(tmp / "cfo.cf32",
                                            np.stack(xs).T),
              "--channels", str(C), "--sps", str(sps), "-M", str(m),
              "--num-avg", "20", "--phase-avg", "10", "--block-symbols",
              "64", "--out-prefix", PREFIX]
    # |x|^2 is the NCO's invariant: the capture's energies are the
    # engine's.
    runs = [Run(common + ["--acquire-cfo", "--acq-samples", "4096"],
                ties=dict(x=np.stack(xs), sps=sps, num_avg=20, phase_avg=10)),
            Run(common)]

    def ser(o, c):
        soft = o.files[".soft.cf32"].reshape(-1, C)[200:, c]
        best = 1.0
        for d in range(60):
            e = syms[c][200 + d:200 + d + soft.size]
            s = soft[:e.size]
            for k in range(m):
                rot = np.exp(2j * np.pi * k / m) * np.exp(1j * np.pi / 4)
                best = min(best, float(np.mean(np.abs(s - e * rot) > 0.5)))
        return best

    def gate(outs):
        for c in range(C):
            assert ser(outs[0], c) < 0.01
        assert ser(outs[1], 0) > 0.2
    return runs, gate


@case
def demod_batch_channelize(tmp):                   # tests/test_cli.py:443
    from psk_soft_tpu_torch.testing.signals import sinc_interp
    C, K, sps, S = 8, 8, 8, 220
    rng = np.random.default_rng(11)
    n_rows = S * sps
    n = np.arange(n_rows * C)
    wide = np.zeros(n_rows * C, np.complex64)
    for m in range(C):
        pts = np.exp(2j * np.pi * rng.integers(0, 4, S) / 4)
        up = sinc_interp(np.repeat(pts, sps).astype(np.complex64),
                         np.arange(n_rows * C) / C)
        wide += (up * np.exp(2j * np.pi * m * n / C)).astype(np.complex64)
    runs = [Run(["demod-batch", "--in", _write(tmp / "wide.cf32", wide),
                 "--channels", str(C), "--channelize", "--chan-taps", str(K),
                 "--out-prefix", PREFIX, *COMMON, "--block-symbols", "64",
                 "--chunk-samples", "1000"])]

    def gate(outs):
        from psk_soft_tpu_torch.runtime.channelizer import ChannelizerFrontEnd
        from psk_soft_tpu_torch.runtime.engine import BatchEngine
        from psk_soft_tpu_torch.runtime.streams import PORT_SOFT, SRI
        o = outs[0]
        assert json.loads(o.err[-1])["samples_in"] == wide.size
        soft = o.files[".soft.cf32"].reshape(-1, C)
        assert soft.shape[0] > 100 and np.isfinite(soft).all()
        ang = np.angle(soft[5:] * np.exp(-1j * np.pi / 4)) % (np.pi / 2)
        assert np.percentile(np.minimum(ang, np.pi / 2 - ang), 99) < 0.1
        fe = ChannelizerFrontEnd(C, taps_per_branch=K, device="cpu")
        fe.push(wide)
        eng = BatchEngine(_cfg(), C, block_symbols=64, device="cpu")
        eng.set_input_sri(SRI(stream_id="ref", xdelta=1.0))
        ref = []
        while (blk := fe.step_block(64 * sps)) is not None:
            eng.push_block(blk)
            while (pkts := eng.step_packets()) is not None:
                if pkts:
                    ref.append(pkts[PORT_SOFT].data)
        blk = fe.drain(planes=False)
        if blk is not None:
            eng.push_block(blk)
        pkts = eng.flush_packets()
        if pkts and pkts[PORT_SOFT].data.size:
            ref.append(pkts[PORT_SOFT].data)
        np.testing.assert_array_equal(soft, np.concatenate(ref, axis=1).T)
    return runs, gate


def _gray_lut():
    from psk_soft_tpu.ops import slicers
    from psk_soft_tpu.ops.framesync import psk_points
    labels = np.asarray(slicers.slice_bits(4, psk_points(np.arange(4), 4)))[
        :, :2]
    lut = np.zeros(4, np.int64)
    for sym, (b0, b1) in enumerate(labels):
        lut[b0 + 2 * b1] = sym
    return lut


@case
def demod_batch_equalize_uw_quality(tmp):          # tests/test_cli.py:513
    from psk_soft_tpu.ops import slicers
    from psk_soft_tpu.ops.framesync import uw_points
    C, sps = 2, 8
    rng = np.random.default_rng(11)
    uw = rng.integers(0, 4, 32)
    payload = 24
    idx = rng.integers(0, 4, (C, 4096))
    sent = {}
    for c in range(C):
        for i, s0 in enumerate(range(1200, 3800, 400)):
            pl = rng.integers(0, 4, payload)
            idx[c, s0:s0 + 32] = uw
            idx[c, s0 + 32:s0 + 32 + payload] = pl
            sent[(c, i)] = pl
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 2.2)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    rx = x.copy()
    rx[:, sps:] += 0.5j * x[:, :-sps]     # a one-symbol echo
    runs = [Run(["demod-batch", "--in", _write(tmp / "eq_uw.cf32", rx.T),
                 "--channels", str(C), "--out-prefix", PREFIX, "--sps",
                 str(sps), "-M", "4", "--num-avg", "50", "--phase-avg", "50",
                 "--block-symbols", "256", "--equalize", "--eq-taps", "33",
                 "--eq-mu", "5e-5", "--uw", ",".join(str(v) for v in uw),
                 "--frame-payload", str(payload), "--uw-threshold", "0.7",
                 "--quality-report", QUALITY])]

    def ideal_bits(pl):
        return np.asarray(slicers.slice_bits(4, uw_points(pl, 4)))[
            :, :2].reshape(-1)

    def gate(outs):
        o = outs[0]
        assert json.loads(o.err[-1])["frames_synced"] == len(o.frames)
        assert len(o.frames) >= 5 * C, len(o.frames)
        for f in o.frames:
            assert min(np.abs(np.asarray(f["bits"]) - ideal_bits(
                sent[(f["channel"], i)])).sum() for i in range(7)) == 0
        q = o.quality
        assert len(q["snr_db"]) == C
        assert all(v > 0.6 for v in q["lock"]), q
        assert all(v > 8.0 for v in q["snr_db"]), q
        assert all(v < 35.0 for v in q["evm_pct"]), q
    return runs, gate


@case
def demod_batch_fec(tmp):                          # tests/test_cli.py:592
    from psk_soft_tpu.ops.fec import CODE_K7, conv_encode
    C, sps = 2, 8
    rng = np.random.default_rng(12)
    uw = rng.integers(0, 4, 32)
    payload = 64
    idx = rng.integers(0, 4, (C, 2048))
    lut = _gray_lut()
    sent = {}
    starts = list(range(300, 1800, 300))
    for c in range(C):
        for i, s0 in enumerate(starts):
            info = rng.integers(0, 2, 58)
            coded = np.asarray(conv_encode(CODE_K7, info)).reshape(-1, 2)
            idx[c, s0:s0 + 32] = uw
            idx[c, s0 + 32:s0 + 32 + payload] = \
                lut[coded[:, 0] + 2 * coded[:, 1]]
            sent[(c, i)] = info
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.9)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    runs = [Run(["demod-batch", "--in", _write(tmp / "fec.cf32", x.T),
                 "--channels", str(C), "--out-prefix", PREFIX, "--sps",
                 str(sps), "-M", "4", "--num-avg", "20", "--phase-avg", "20",
                 "--block-symbols", "256",
                 "--uw", ",".join(str(v) for v in uw),
                 "--frame-payload", str(payload), "--fec", "k7"],
                ties=dict(x=x, sps=sps, num_avg=20, phase_avg=20))]

    def gate(outs):
        o = outs[0]
        metrics = json.loads(o.err[-1])
        assert metrics["frames_synced"] == len(o.frames)
        assert metrics["frames_decoded"] == len(o.frames)
        assert metrics["suspect_frames"] == 0
        assert len(o.frames) == len(starts) * C
        for f in o.frames:
            want = sent[(f["channel"], starts.index(f["start"]))]
            assert np.array_equal(np.asarray(f["info_bits"]), want)
            assert not f["suspect"]
        assert metrics["errors_corrected"] == sum(f["corrected"]
                                                  for f in o.frames)
    return runs, gate


@case
def fec_requires_uw_and_validates(tmp):            # tests/test_cli.py:656
    infile = _write(tmp / "x.cf32", np.zeros(1024, np.complex64))
    base = ["demod-batch", "--in", infile, "--channels", "1",
            "--out-prefix", PREFIX]
    runs = [Run(base + ["--fec", "k7"], fails=True),
            Run(base + ["--uw", "0,1,2,3", "--frame-payload", "3", "--fec",
                        "k7"], fails=True)]

    def gate(outs):
        assert "requires --uw" in outs[0].rc
        assert "--fec:" in outs[1].rc
    return runs, gate


@case
def demod_batch_descramble(tmp):                   # tests/test_cli.py:677
    from psk_soft_tpu.ops.scramble import additive_scramble, prbs15
    C, sps = 1, 8
    rng = np.random.default_rng(13)
    uw = rng.integers(0, 4, 32)
    payload = 40
    idx = rng.integers(0, 4, (C, 1500))
    lut = _gray_lut()
    lf = prbs15()
    sent = {}
    starts = list(range(200, 1300, 250))
    for i, s0 in enumerate(starts):
        info = rng.integers(0, 2, payload * 2, np.int8)
        wire = np.asarray(additive_scramble(lf, info)).reshape(-1, 2)
        idx[0, s0:s0 + 32] = uw
        idx[0, s0 + 32:s0 + 32 + payload] = lut[wire[:, 0] + 2 * wire[:, 1]]
        sent[i] = info
    x = np.repeat(np.exp(1j * (2 * np.pi * idx / 4 + 0.4)), sps, axis=1)
    x = (x + 0.02 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    base = ["demod-batch", "--in", _write(tmp / "scr.cf32", x.T),
            "--channels", str(C), "--sps", str(sps), "-M", "4",
            "--num-avg", "20", "--phase-avg", "20", "--block-symbols", "256",
            "--uw", ",".join(str(v) for v in uw),
            "--frame-payload", str(payload), "--out-prefix", PREFIX]
    runs = [Run(base + ["--descramble", "prbs15"]), Run(base),
            Run(base + ["--descramble-selfsync", "18,23"]),
            Run(base[:9] + ["--out-prefix", PREFIX, "--descramble",
                            "prbs9"], fails=True)]

    def gate(outs):
        from psk_soft_tpu_torch.runtime.scramble import StreamDescrambler
        frames = outs[0].frames
        assert len(frames) == len(starts)
        for f in frames:
            assert np.array_equal(np.asarray(f["bits"]),
                                  sent[starts.index(f["start"])])
        plain = outs[1].files[".bits.i16"]
        want = StreamDescrambler(C, (18, 23)).observe(
            plain.reshape(1, -1).astype(np.int8)).reshape(-1)
        assert np.array_equal(outs[2].files[".bits.i16"],
                              want.astype(np.int16))
        assert "--descramble" in outs[3].rc
    return runs, gate


def _gen_frames(tmp, capsys, argv):
    cap, truth = tmp / "link.cf32", tmp / "truth.jsonl"
    assert cli.main(["gen-frames", "--out", str(cap), "--truth", str(truth),
                     *argv]) == 0
    capsys.readouterr()
    rows = [json.loads(line) for line in truth.read_text().splitlines()]
    return str(cap), {(r["channel"], r["start"]): r["info_bits"]
                      for r in rows}


@case
def gen_frames_full_loop(tmp, capsys):             # tests/test_cli.py:780
    uw = ",".join(str(v) for v in
                  np.random.default_rng(15).integers(0, 4, 32))
    cap, truth = _gen_frames(tmp, capsys, [
        "--channels", "2", "--symbols", "2200", "--sps", "8", "-M", "4",
        "--uw", uw, "--frame-payload", "64", "--fec", "k7", "--scramble",
        "prbs15", "--crc", "crc16", "--labeling", "gray", "--interleave",
        "8", "--frame-interval", "300", "--snr", "18", "--freq-offset",
        "2e-4", "--seed", "3"])
    runs = [Run(["demod-batch", "--in", cap, "--channels", "2",
                 "--out-prefix", PREFIX, "--sps", "8", "-M", "4",
                 "--num-avg", "20", "--phase-avg", "30", "--block-symbols",
                 "256", "--uw", uw, "--frame-payload", "64", "--fec", "k7",
                 "--descramble", "prbs15", "--crc", "crc16",
                 "--fec-labeling", "gray", "--fec-interleave", "8"])]

    def gate(outs):
        o = outs[0]
        assert json.loads(o.err[-1])["crc_failures"] == 0
        assert len(o.frames) >= len(truth) - 2, (len(o.frames), len(truth))
        for f in o.frames:
            assert not f["suspect"] and f["crc_ok"] is True
            assert f["info_bits"] == truth[(f["channel"], f["start"])]
    return runs, gate


@case
def fec_stream(tmp):                               # tests/test_cli.py:824
    C = 2
    x = _signal(channels=C, symbols=900, seed=4)
    base = ["demod-batch", "--in", _write(tmp / "sf.cf32", x.T),
            "--channels", str(C), "--sps", "8", "-M", "4", "--num-avg", "20",
            "--phase-avg", "20", "--block-symbols", "128", "--out-prefix",
            PREFIX]
    runs = [Run(base), Run(base + ["--fec-stream", "k7"])]

    def gate(outs):
        from psk_soft_tpu_torch.ops.fec import CODE_K7
        from psk_soft_tpu_torch.runtime.fec import StreamFecDecoder
        soft = outs[0].files[".soft.cf32"].reshape(-1, C).T
        dec = StreamFecDecoder(C, code=CODE_K7, m=4, device="cpu")
        dec.observe(np.ascontiguousarray(soft))
        dec.finalize()
        want = dec.pop_bits()
        got = outs[1].files[".fecstream.i8"].reshape(-1, C).T
        assert json.loads(outs[1].err[-1])["fec_stream_bits"] == \
            want.shape[1]
        assert np.array_equal(got, want)
    return runs, gate


@case
def demod_batch_auto(tmp):                         # tests/test_cli.py:855
    C, sps, m = 2, 8, 8
    rng = np.random.default_rng(16)
    idx = rng.integers(0, m, (C, 2600))
    x = np.repeat(np.exp(2j * np.pi * (idx / m + 0.03)), sps, axis=1)
    x = (x + 0.03 * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    base = ["demod-batch", "--in", _write(tmp / "auto.cf32", x.T),
            "--channels", str(C), "--num-avg", "20", "--phase-avg", "20",
            "--block-symbols", "128", "--out-prefix", PREFIX]
    noise = (0.1 * (rng.standard_normal(40000)
                    + 1j * rng.standard_normal(40000))).astype(np.complex64)
    runs = [Run(base + ["--auto", "--auto-samples", "8192"], m=m),
            Run(base + ["--sps", str(sps), "-M", str(m)], m=m),
            Run(["demod-batch", "--in", _write(tmp / "noise.cf32", noise),
                 "--channels", "1", "--out-prefix", PREFIX, "--auto"],
                fails=True)]

    def gate(outs):
        auto = json.loads(outs[0].err[-2])["auto"]
        assert (auto["sps"], auto["m"]) == (sps, m)
        for ext in (".soft.cf32", ".bits.i16", ".phase.f32", ".index.i16"):
            assert outs[0].files[ext].tobytes() == \
                outs[1].files[ext].tobytes(), ext
        assert "--auto" in outs[2].rc
    return runs, gate


@case
def fused_chain_loop(tmp, capsys):                 # tests/test_cli.py:901
    uw = ",".join(str(v) for v in
                  np.random.default_rng(16).integers(0, 4, 32))
    cap, truth = _gen_frames(tmp, capsys, [
        "--channels", "128", "--symbols", "1536", "--sps", "8", "-M", "4",
        "--uw", uw, "--frame-payload", "48", "--fec", "k7", "--crc",
        "crc16", "--labeling", "gray", "--frame-interval", "333", "--snr",
        "25", "--seed", "4"])
    base = ["demod-batch", "--in", cap, "--channels", "128",
            "--out-prefix", PREFIX, "--fused-chain"]
    frame_flags = ["--uw", uw, "--frame-payload", "48", "--fec", "k7",
                   "--fec-labeling", "gray"]
    runs = [Run(base + ["--sps", "8", "-M", "4", "--num-avg", "40",
                        "--phase-avg", "30", "--block-symbols", "256",
                        *frame_flags, "--crc", "crc16"], "full"),
            Run(base, fails=True),
            Run(base + frame_flags + ["--agc"], fails=True)]

    def gate(outs):
        o = outs[0]
        metrics = json.loads(o.err[-1])
        assert metrics["crc_failures"] == 0 and metrics["overflow_peaks"] == 0
        for f in o.frames:
            want = truth[(f["channel"], f["start"])]
            assert f["crc_ok"] is True and f["info_bits"][:len(want)] == want
        assert len(o.frames) >= len(truth) - 128, (len(o.frames), len(truth))
        assert "requires --uw and --fec" in outs[1].rc
        assert "per-stage stack" in outs[2].rc
    return runs, gate


@case
def demod_batch_flushes_remainder(tmp):  # test_review_fixes.py:90
    from psk_soft_tpu_torch.testing.signals import gen_psk
    C = 2
    xs = np.stack([gen_psk(200, 8, 4, seed=700 + c)[0] for c in range(C)])
    runs = [Run(["demod-batch", "--in", _write(tmp / "in.cf32", xs.T),
                 "--out-prefix", PREFIX, "--channels", str(C), "--sps", "8",
                 "--num-avg", "50", "-M", "4", "--phase-avg", "20",
                 "--block-symbols", "128"],
                ties=dict(x=xs, sps=8, num_avg=50, phase_avg=20))]

    def gate(outs):
        # 200 symbols: one 128-block + 72 remainder; all 151 valid outputs.
        assert outs[0].files[".soft.cf32"].reshape(-1, C).shape[0] == 200 - 49
    return runs, gate


@pytest.mark.parametrize("name", list(CASES))
def test_port_cli_matches_jax(name, tmp_path, capsys):
    fn = CASES[name]
    made = (fn(tmp_path, capsys) if fn.__code__.co_argcount == 2
            else fn(tmp_path))
    runs, gate = made
    outs = []
    for k, run in enumerate(runs):
        got = _invoke(cli.main, run.argv + ["--device", "cpu"],
                      tmp_path / f"port{k}", capsys)
        want = _invoke(jax_cli.main, run.argv + (
            ["--interpret"] if run.pipeline == "full" else []),
            tmp_path / f"jax{k}", capsys)
        _compare(got, want, run)
        outs.append(got)
    gate(outs)


def _options(ap, cmd):
    sub = next(a for a in ap._actions if a.dest == "cmd")
    return {s for a in sub.choices[cmd]._actions for s in a.option_strings}


@pytest.mark.parametrize("cmd", ["demod", "demod-batch"])
def test_parser_options_are_jax_less_interpret_plus_device(cmd,
                                                           monkeypatch):
    import argparse
    seen = []                  # the JAX CLI builds its parser in main()

    def grab(self, *args, **kwargs):
        seen.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jax_cli.main([cmd])
    monkeypatch.undo()
    want = _options(seen[0], cmd) - {"--interpret"} | {"--device"}
    assert _options(cli.build_parser(), cmd) == want


def test_interpret_is_refused(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["demod-batch", "--channels", "128", "--pipeline", "full",
                  "--interpret", "--device", "cpu"])
    assert e.value.code == 2
    assert "unrecognized arguments: --interpret" in capsys.readouterr().err


def test_frames_are_popped_every_block(tmp_path, capsys, monkeypatch):
    """Named divergence: the port's CLI pops the frame side after every
    block, the JAX CLI after every read.  With a syncer that holds two
    unpopped frames (a read of eight 256-symbol blocks carries ten), the
    port still writes every frame and passes the case's gates; the JAX CLI
    drops the oldest."""
    from psk_soft_tpu.runtime import framesync as jax_fs
    from psk_soft_tpu_torch.runtime import framesync as port_fs

    for mod in (jax_fs, port_fs):
        small = type("SmallSyncer", (mod.FrameSyncer,), {
            "__init__": lambda self, *a, _i=mod.FrameSyncer.__init__, **k:
                _i(self, *a, **dict(k, max_frames=2))})
        monkeypatch.setattr(mod, "FrameSyncer", small)
    runs, gate = CASES["demod_batch_fec"](tmp_path)
    got = _invoke(cli.main, runs[0].argv + ["--device", "cpu"],
                  tmp_path / "port", capsys)
    want = _invoke(jax_cli.main, runs[0].argv, tmp_path / "jax", capsys)
    gate([got])
    assert len(want.frames) < len(got.frames) == 10
