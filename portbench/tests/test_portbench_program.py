"""The metrics that read the program's own spans and counters
(``portbench/program.py``): none without the program's tracer, as on a
program that has none; their arithmetic on a given snapshot; and a tiny
traced CPU run reporting all four."""

from types import SimpleNamespace

import pytest

from portbench import program
from portbench.manifest import Manifest

from .helpers import run_tiny

NEW = ("upload_ms.samples", "fetch_ms.samples", "assemble_ms.samples",
       "copy_bytes.samples")


def _readers():
    man = Manifest()
    return {name: man.metric_reader(name) for name in NEW}


@pytest.mark.parametrize("prog", [None, {"spans": {}, "counters": {},
                                         "blocks": 4, "samples": 4096}],
                         ids=["no-tracer", "no-spans"])
def test_nothing_to_read(prog):
    for name, read in _readers().items():
        assert read(SimpleNamespace(program=prog)) is None, name


def test_readings_of_a_snapshot():
    def span(sec, self_sec):
        return {"seconds": sec, "self_seconds": self_sec, "count": 4}

    prog = {"spans": {"psk.engine.upload": span(0.02, 0.02),
                      "psk.engine.launch": span(0.001, 0.001),
                      "psk.engine.emit": span(0.05, 0.03),
                      "psk.engine.fetch": span(0.02, 0.02)},
            "counters": {"psk.engine.h2d_bytes": 32768,
                         "psk.engine.d2h_bytes": 7168,
                         "psk.engine.h2d_copies": 8},
            "blocks": 4, "samples": 4096}
    got = {k: r(SimpleNamespace(program=prog))
           for k, r in _readers().items()}
    assert got == pytest.approx({"upload_ms.samples": 5.0,
                                 "fetch_ms.samples": 5.0,
                                 "assemble_ms.samples": 7.5,
                                 "copy_bytes.samples": 9.75})


def test_tiny_traced_run_reports_them(capsys):
    line, _ = run_tiny("qpsk1024.ports", trace=True)
    assert line["correct"]
    m = line["metrics"]
    assert set(NEW) <= set(m)
    for name in NEW[:3]:
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    # The CPU engine moves nothing across a bus.
    assert m["copy_bytes.samples"] == {"value": 0.0, "unit": "B/sample"}
    assert "portbench program " in capsys.readouterr().err


def test_a_program_without_the_tracer(monkeypatch):
    """A program without the tracer (the parent of the tracer's change):
    the traced run still comes out correct, with the older metrics and
    without the new ones."""
    monkeypatch.setattr(program, "_tracer", lambda: None)
    line, _ = run_tiny("qpsk1024.i16", trace=True)
    assert line["correct"]
    assert {"ingest_ms.samples", "engine_ms.samples"} <= set(line["metrics"])
    assert not set(NEW) & set(line["metrics"])
