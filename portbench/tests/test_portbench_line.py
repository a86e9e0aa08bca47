"""The result line has exactly the contract's keys, ``check`` last, and a
machine without a card gets no line."""

import json

from portbench import run

from .helpers import run_tiny


def test_line_keys():
    line, _ = run_tiny("qpsk1024.ports")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
    for v in line["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_keys():
    line, _ = run_tiny("qpsk1024.i16", trace=True)
    assert list(line)[-1] == "check"
    assert {"ingest_ms.samples", "engine_ms.samples"} <= set(line["metrics"])
    line = run.result_line(True, 3, 0, {}, {"platform": "gpu"}, {},
                           {"device_ops": [], "idle_gaps": []})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]


def test_no_card_no_line(capsys):
    import torch

    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "qpsk1024.ports", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
