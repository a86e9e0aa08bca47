"""Port parity, examples: each of ``psk_soft_tpu_torch.examples`` runs
in-process with ``--device cpu`` and prints what its JAX twin in
``examples/`` prints on the CPU (run in-process as ``__main__``; the JAX
examples fall back to Pallas interpret mode off a TPU).  Text is equal;
each printed number is equal to the last digit printed.  Without a GPU an
example run on the default device stops with rc 2 and names ``--device
cpu``."""

import contextlib
import importlib
import io
import re
import runpy
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("bank_demod", "coded_link", "frame_sync", "hetero_rate_bank",
            "one_launch_chain", "sharded_mesh", "stream_demod",
            "wideband_bank")
NUMBER = re.compile(r"-?\d+(?:\.(\d+))?(?:e[-+]?\d+)?")


def _printed(run) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run()
    return buf.getvalue()


def _same_print(got: str, want: str) -> None:
    """Equal text; numbers equal to the last digit printed."""
    assert NUMBER.split(got)[::2] == NUMBER.split(want)[::2], (got, want)
    g, w = list(NUMBER.finditer(got)), list(NUMBER.finditer(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if a.group(1) is None and "e" not in a.group(0):
            assert a.group(0) == b.group(0), (a.group(0), b.group(0))
        else:
            ulp = 10.0 ** -len(a.group(1) or "")
            assert abs(float(a.group(0)) - float(b.group(0))) <= ulp * 1.01, (
                a.group(0), b.group(0))


def _run_jax(name: str) -> None:
    try:
        runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                       run_name="__main__")
    except SystemExit as e:             # sys.exit(main()) at the end
        assert e.code in (0, None)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_its_jax_twin_prints(name):
    mod = importlib.import_module(f"psk_soft_tpu_torch.examples.{name}")
    rc = []
    got = _printed(lambda: rc.append(mod.main(["--device", "cpu"])))
    want = _printed(lambda: _run_jax(name))
    assert rc == [0] and got.strip()
    _same_print(got, want)


def test_examples_need_a_gpu_or_cpu_flag(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in EXAMPLES:
        mod = importlib.import_module(f"psk_soft_tpu_torch.examples.{name}")
        assert mod.main([]) == 2
        assert "--device cpu" in capsys.readouterr().err
