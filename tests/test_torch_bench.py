"""The port's bench (psk_soft_tpu_torch/tools/bench.py) and the gates it
shares with chip_smoke.py (tools/gates.py), on the CPU at 128 channels:

* its options and --pipeline/--profile choices are the root bench.py's
  (read from the parser bench.py's main builds), plus --device;
* its input generators equal bench.py's bit for bit: the QPSK block, the
  planted K7 + CRC frames, the config-3 and mixed-profile signals;
* each gate passes on a right path and fails on a planted fault: the
  chain's steady check on one flipped information bit and on one dropped
  frame, the frame check, B1Gate and check_b5 on a corrupted kernel;
* main() with --device cpu prints its lines for the chain, the engine and
  the receiver; with the default device and no card it fails and prints
  no number.
"""

import argparse
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from psk_soft_tpu.ops.crc import CRC16_CCITT as J_CRC16
from psk_soft_tpu.ops.fec import CODE_K7 as J_K7
from psk_soft_tpu.ops.framesync import FrameFormat as JFrameFormat
from psk_soft_tpu_torch.ops.cuda import demod_kernel, frontend_kernel
from psk_soft_tpu_torch.tools import bench, gates

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
C = 128
LINE_KEYS = {"metric", "value", "unit", "min", "max", "reps",
             "device_ms_per_step", "timing", "launches", "device", "gate"}


@pytest.fixture()
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench_mod",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(*argv):
    return bench.build_parser().parse_args(
        ["--channels", str(C), "--device", "cpu", *argv])


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}


def test_options_match_root_bench(jax_bench, monkeypatch):
    """bench.py's main builds its parser, then parses: stop it there."""
    captured = {}

    class Built(Exception):
        pass

    def parse_args(self, *a, **k):
        captured["parser"] = self
        raise Built

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Built):
        jax_bench.main()
    ref = _options(captured["parser"])
    port = _options(bench.build_parser())
    assert set(port) == set(ref) | {"--device"}
    for opt in ("--pipeline", "--profile", "--soft", "--ingest"):
        assert port[opt].choices == ref[opt].choices
        assert port[opt].default == ref[opt].default
    assert {o: port[o].dest for o in ref} == {o: a.dest
                                              for o, a in ref.items()}


def test_inputs_equal_root_bench(jax_bench, monkeypatch):
    np.testing.assert_array_equal(bench.qpsk_block(C, 512, 8),
                                  jax_bench._qpsk_block(C, 512, 8))

    rng = np.random.default_rng(12)
    fmt = JFrameFormat(uw=tuple(rng.integers(0, 4, 32)), payload=64, m=4,
                       threshold=0.7)
    ref = jax_bench._plant_unaligned_frames(C, 512, 8, fmt, J_K7, J_CRC16,
                                            rng)
    *_, got = bench.chain_frames(_args(), np.random.default_rng(12))
    assert got[0] == ref[0] and got[1] == ref[1] == 4
    assert got[4:] == ref[4:]
    for a, b in zip(got[2:4], ref[2:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    seen = {}

    def run_full(args, cfg, C_, T, x_np, raw_tail=False, mixed=None):
        seen[args.profile] = (x_np, mixed)
        return 1.0

    monkeypatch.setattr(jax_bench, "run_full", run_full)
    monkeypatch.setattr(jax_bench, "emit", lambda *a: 0)
    for profile in ("config3", "mixed"):
        jax_bench.run_profile(argparse.Namespace(
            channels=C, symbols=512, sps=8, profile=profile))
    x3 = bench.config3_signal(C, 512, 8)
    assert x3.dtype == seen["config3"][0].dtype
    np.testing.assert_array_equal(x3, seen["config3"][0])
    xm, ms, diffs = bench.mixed_signal(C, 512, 8)
    np.testing.assert_array_equal(xm, seen["mixed"][0])
    np.testing.assert_array_equal(ms, seen["mixed"][1][0])
    np.testing.assert_array_equal(diffs, seen["mixed"][1][1])


def test_chain_gate_holds_and_fails():
    p = bench.chain_setup(_args(), "cpu")
    S = 512
    carry = (p.state, p.tail)
    for _ in range(3):
        carry, outs = p.carry_step(carry)
    assert gates.check_chain_steady(outs, p.infos, p.rows, S) == C * 4
    _, roll = p.roll_step((carry[0].planes, carry[1]))
    assert gates.check_chain_steady(roll, p.infos, p.rows, S) == C * 4
    msg = outs.msg.clone()
    msg[5, 1, 3] ^= 1
    with pytest.raises(AssertionError, match="info bits"):
        gates.check_chain_steady(outs._replace(msg=msg), p.infos, p.rows, S)
    found = outs.found.clone()
    found[7, 2] = False
    with pytest.raises(AssertionError, match="missed"):
        gates.check_chain_steady(outs._replace(found=found), p.infos,
                                 p.rows, S)


def test_frame_check_holds_and_fails():
    starts, period = [17, 122], 512
    infos = np.random.default_rng(0).integers(0, 2, (2, 2, 10)).astype(
        np.int8)

    def frame(c, start, j, **kw):
        f = dict(channel=c, start=start, crc_ok=True, suspect=False,
                 info_bits=np.concatenate([infos[c, j], [1, 0]]))
        f.update(kw)
        return SimpleNamespace(**f)

    good = [frame(c, b * period + s0, j) for b in (1, 2)
            for j, s0 in enumerate(starts) for c in (0, 1)]
    need = gates.required_frames(starts, 2, period, 3, 40, 99)
    assert len(need) == 8
    assert gates.check_frames("t", good, starts, infos, period, need) == 8
    bad_bits = frame(0, period + 17, 0)
    bad_bits.info_bits = bad_bits.info_bits.copy()
    bad_bits.info_bits[4] ^= 1
    for frames, what in (
            (good[1:], "missed"), (good + good[:1], "twice"),
            (good[1:] + [bad_bits], "info bits"),
            (good + [frame(0, period + 18, 0)], "offset"),
            (good[1:] + [frame(0, period + 17, 0, crc_ok=False)], "CRC")):
        with pytest.raises(AssertionError, match=what):
            gates.check_frames("t", frames, starts, infos, period, need)


def _b1_launch():
    """The bench's full-kernel path at 128 channels after the warm-up:
    (cfg, the kernel's carry, the block's planes)."""
    from psk_soft_tpu_torch.models import blockpsk, full

    cfg = bench.qpsk_cfg(8)
    x = bench.qpsk_block(C, 512, 8)
    st, _ = blockpsk.demod_block_ff(cfg, blockpsk.ff_init(cfg, C, "cpu"),
                                    torch.from_numpy(x))
    state = full.full_from_ff(cfg, st)
    re, im, _ = bench._planes(x, "cpu", "f32")
    return cfg, state, re, im


def test_b1_gate_holds_and_fails(monkeypatch):
    from psk_soft_tpu_torch.models import full

    cfg, state, re, im = _b1_launch()
    with gates.B1Gate("t") as gate:
        full.demod_block_full_rolling(cfg, state.planes, re, im, re, im,
                                      debug_ports=False)
    assert gate.stats["launches_checked"] == 1
    assert gate.stats["outputs"] == 512 * C
    plain = demod_kernel.demod_full_tm

    def wrong_bits(*a, **k):
        out = list(plain(*a, **k))
        out[3] = out[3].clone()
        out[3][200, 9] ^= 1
        return tuple(out)

    monkeypatch.setattr(demod_kernel, "demod_full_tm", wrong_bits)
    with pytest.raises(AssertionError, match="bits differ"):
        with gates.B1Gate("t"):
            full.demod_block_full(cfg, state, re, im)


def test_b5_gate_holds_and_fails(monkeypatch):
    x = bench.qpsk_block(C, 512 + 99, 8)
    re, im, _ = bench._planes(x, "cpu", "f32")
    keep = 99 * 8
    args = (re[:keep], im[:keep], re[keep:], im[keep:])
    res = gates.check_b5("t", *args, sps=8, num_avg=100)
    assert res["index_differ"] == 0 and res["widest_gap"] == 0.0
    plain = frontend_kernel.timing_frontend_tm

    def shifted(*a, **k):
        s_re, s_im, idx = plain(*a, **k)
        return s_re, s_im, (idx + 1) % 8

    monkeypatch.setattr(frontend_kernel, "timing_frontend_tm", shifted)
    with pytest.raises(AssertionError, match="indices differ"):
        gates.check_b5("t", *args, sps=8, num_avg=100)


def _lines(capsys, argv):
    assert bench.main(["--channels", str(C), "--device", "cpu", "--reps",
                       "1", "--warmup", "1", *argv]) == 0
    lines = [json.loads(r) for r in capsys.readouterr().out.splitlines()]
    for line in lines:
        assert LINE_KEYS <= set(line) and "card" not in line
        assert line["device"] == "cpu" and line["reps"] == 1
        assert line["device_ms_per_step"] is None
        assert 0 < line["min"] <= line["value"] <= line["max"]
        assert line["metric"].startswith(f"{C}-channel")
        assert line["metric"].endswith(", cpu)")
    return lines


def test_main_chain_line(capsys):
    (line,) = _lines(capsys, ["--profile", "chain", "--iters", "2"])
    assert line["unit"] == "infobits/s"
    assert line["gate"] == {"carry_path_frames": C * 4,
                            "rolling_path_frames": C * 4}
    assert "receive-chain" in line["metric"]


def test_main_engine_lines(capsys):
    lines = _lines(capsys, ["--engine", "--iters", "2"])
    assert [ln["pipeline_depth"] for ln in lines] == [0, 1]
    for line in lines:
        assert line["unit"] == "samples/s" and line["blocks"] == 10
        assert "full-kernel engine" in line["metric"]
        assert line["gate"]["launches_checked"] == 1


def test_main_receiver_line(capsys):
    (line,) = _lines(capsys, ["--receiver", "--iters", "2"])
    assert line["unit"] == "infobits/s"
    assert line["gate"]["timed_frames"] >= 8 * 4 * C
    assert line["gate"]["warmup_frames"] > 0


def test_no_card_no_number(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--channels", str(C)]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "NVIDIA GPU" in out.err
