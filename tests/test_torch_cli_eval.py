"""Port parity, command line: ``python -m psk_soft_tpu_torch``'s gen,
gen-frames, ber, baseline, selftest and probe against ``psk_soft_tpu.cli``
in-process with the same arguments (gen and gen-frames write the same
bytes and the same truth JSONL; ber and baseline print the same records),
run with ``--device cpu``; without a GPU every device subcommand, demod
and demod-batch included, fails unless ``--device cpu`` is given (demod
and demod-batch are held against JAX in test_torch_cli_demod.py)."""

import json

import pytest
import torch

from psk_soft_tpu import cli as jax_cli
from psk_soft_tpu_torch import cli

torch.set_num_threads(1)


def _run_both(capsys, argv, jax_argv=None):
    """(port rc, port stdout, JAX rc, JAX stdout)."""
    rc = cli.main(argv)
    out = capsys.readouterr().out
    jrc = jax_cli.main(jax_argv if jax_argv is not None else argv)
    jout = capsys.readouterr().out
    return rc, out, jrc, jout


@pytest.mark.parametrize("extra", [
    ["--golden", "-M", "8", "--differential"],
    ["--pulse", "rrc", "--snr", "12", "--freq-offset", "1e-3",
     "--seed", "5", "--sps", "4"],
])
def test_gen_writes_jax_bytes(tmp_path, capsys, extra):
    a, b = tmp_path / "port.cf32", tmp_path / "jax.cf32"
    base = ["gen", "--symbols", "700"] + extra
    assert cli.main(base + ["--out", str(a)]) == 0
    assert jax_cli.main(base + ["--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes() and a.stat().st_size == 700 * (
        4 if "--sps" in extra else 8) * 8


@pytest.mark.parametrize("extra", [
    ["--fec", "k7", "--crc", "crc16", "--scramble", "prbs15",
     "--labeling", "gray", "--interleave", "4", "--snr", "15",
     "--freq-offset", "2e-4"],
    ["--fec", "k7", "--fec-puncture", "2/3", "--crc", "crc32",
     "--scramble", "prbs7:0x55", "--pulse", "rrc", "-M", "8"],
    [],
])
def test_gen_frames_writes_jax_bytes_and_truth(tmp_path, capsys, extra):
    base = ["gen-frames", "--channels", "3", "--symbols", "1500",
            "--uw", "0,1,2,3,3,2,1,0,0,2,1,3,1,1,2,2", "--frame-payload",
            "96", "--seed", "11"] + extra
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        wire, truth = tmp_path / f"{name}.cf32", tmp_path / f"{name}.jsonl"
        assert main(base + ["--out", str(wire), "--truth", str(truth)]) == 0
        outs[name] = (wire.read_bytes(), truth.read_text())
    assert outs["port"] == outs["jax"]
    rows = [json.loads(r) for r in outs["port"][1].splitlines()]
    assert len(rows) == 3 * 3 and {r["channel"] for r in rows} == {0, 1, 2}
    assert len(outs["port"][0]) == 3 * 1500 * 8 * 8


@pytest.mark.parametrize("argv", [
    ["ber", "--esn0", "8,11", "-M", "4", "--symbols", "4000"],
    ["ber", "--esn0", "3,5", "-M", "4", "--symbols", "4000", "--fec", "k7"],
    ["ber", "--esn0", "5", "-M", "4", "--symbols", "3000", "--fec", "k7",
     "--fec-puncture", "2/3", "--fec-labeling", "gray"],
])
def test_ber_prints_jax_records(capsys, argv):
    rc, out, jrc, jout = _run_both(capsys, argv + ["--device", "cpu"], argv)
    assert rc == jrc == 0
    assert out.splitlines() and out == jout


def test_baseline_config1_and_config5(capsys):
    rc, out, jrc, jout = _run_both(
        capsys, ["baseline", "--config", "1", "--device", "cpu"],
        ["baseline", "--config", "1"])
    assert rc == jrc == 0
    got, ref = json.loads(out), json.loads(jout)
    assert got["pass"] and got["symbols"] == ref["symbols"] == 901
    assert abs(got["max_soft_error"] - ref["max_soft_error"]) < 1e-4
    rc, out, jrc, jout = _run_both(
        capsys, ["baseline", "--config", "5", "--device", "cpu"],
        ["baseline", "--config", "5"])
    assert rc == jrc == 0
    got, ref = json.loads(out), json.loads(jout)
    assert got["pass"] and ref["pass"] and got["config"] == 5
    assert got["mesh"] == [1, 1] and got["channels"] == 64


def test_selftest(capsys):
    assert cli.main(["selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 7 and out.strip().endswith("selftest PASS")


def test_probe_prints_jax_survey(tmp_path, capsys):
    wire = tmp_path / "cap.cf32"
    assert cli.main(["gen-frames", "--channels", "2", "--symbols", "2048",
                     "--uw", "0,1,2,3", "--frame-payload", "60", "--snr",
                     "20", "--freq-offset", "0.002", "--out",
                     str(wire)]) == 0
    argv = ["probe", "--in", str(wire), "--channels", "2",
            "--samples", "8192"]
    rc, out, jrc, jout = _run_both(capsys, argv + ["--device", "cpu"], argv)
    assert rc == jrc == 0
    got = [json.loads(r) for r in out.splitlines()]
    ref = [json.loads(r) for r in jout.splitlines()]
    assert len(got) == 2
    for g, r in zip(got, ref):
        assert (g["channel"], g["m"], g["sps"]) == (r["channel"], r["m"],
                                                    r["sps"]) == (
            g["channel"], 4, 8.0)
        assert abs(g["cfo"] - r["cfo"]) < 1e-6 and abs(g["cfo"] - 0.002) < 1e-4


def test_device_subcommands_need_a_gpu_or_cpu_flag(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["selftest"], ["baseline", "--config", "1"],
                 ["ber", "--esn0", "10"], ["demod", "--in", "x.cf32"],
                 ["demod-batch", "--channels", "4", "--in", "x.cf32"]):
        assert cli.main(argv) == 2
        assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["selftest", "--no-such-flag"])
