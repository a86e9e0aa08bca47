"""The manifest keeps the benchmark's contract, and a cell, a traffic mix,
a configuration and a per-layer metric are found by name."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import manifest
from portbench.manifest import Manifest

from .helpers import run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REPO = manifest.HERE.parent
DATA = json.loads(manifest.MANIFEST.read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_and_paths():
    assert set(DATA) == KEYS
    assert DATA["paths"] == ["portbench"]
    assert 1 <= DATA["run_seconds"] <= 51
    cells = 24
    budget = (2 + 14 * cells) * (DATA["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert budget <= 43200
    for word in DATA["command"]:
        assert not word.startswith("/") and ".." not in word
    assert manifest.MANIFEST.stat().st_size <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in DATA[group]]
    assert len(names) == len(set(names))
    for e in DATA[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_configs_and_cells():
    configs = {c["name"]: c for c in DATA["configs"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        on_disk = json.loads((REPO / c["file"]).read_text())
        assert on_disk["source"] == c["source"]
        assert on_disk["reduced"] == c["reduced"]
    used = set()
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        used.add(w["config"])
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_reach_every_cell():
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in DATA["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    man = Manifest()
    for w in DATA["workloads"]:
        cell = man.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert callable(man.metric_reader(m["name"]))


def test_found_by_name():
    man = Manifest()
    cell = man.cell("qpsk1024.ports")
    assert cell.config["channels"] == 1024
    assert cell.traffic["entry"] == "engine"
    assert set(cell.limits) == {"index_mismatches", "bit_mismatches",
                                "soft_gap", "phase_gap"}
    assert man.metric_reader("ingest_ms.samples") is not None
    assert man.roofline("b1").work(128, 64, 8, 100, 50)[1] > 0
    with pytest.raises(KeyError):
        man.cell("no.such.cell")
    with pytest.raises(KeyError):
        man.metric_reader("no_such_metric.samples")


def _digest(root: Path) -> dict:
    return {p: hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_by_new_files_only(tmp_path):
    """A new configuration, traffic mix, per-layer metric and cell are new
    files and new manifest entries: the harness runs them, and no file of
    the benchmark changes."""
    before = _digest(manifest.HERE)
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics", "rooflines"):
        shutil.copytree(manifest.HERE / sub, root / sub)
    shutil.copy(manifest.HERE / "peaks.json", root / "peaks.json")
    cfg = json.loads((root / "configs" / "qpsk1024.json").read_text())
    cfg.update(channels=256, reduced=["channels"])
    (root / "configs" / "qpsk256.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "ports.json").read_text())
    mix.update(noise_std=0.02)
    (root / "traffic" / "noisy.json").write_text(json.dumps(mix))
    (root / "limits" / "qpsk256.noisy.json").write_text(
        (root / "limits" / "qpsk1024.ports.json").read_text())
    (root / "metrics" / "blocks_fed.py").write_text(
        "def read(ctx):\n    return float(ctx.iterations)\n")
    data = json.loads(manifest.MANIFEST.read_text())
    data["configs"].append(dict(data["configs"][0], name="qpsk256",
                                file="portbench/configs/qpsk256.json",
                                reduced=["channels"]))
    data["workloads"].append({"name": "qpsk256.noisy", "config": "qpsk256",
                              "traffic": "noisy", "chips": 1,
                              "why": "a test cell"})
    data["end_to_end"][0]["workloads"].append("qpsk256.noisy")
    data["per_layer"].append({"name": "blocks_fed.samples", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "samples_per_s",
                              "workloads": ["qpsk256.noisy"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(data))
    man = Manifest(path, root)
    line, _ = run_tiny("qpsk256.noisy", trace=True, man=man)
    assert line["correct"]
    assert line["metrics"]["blocks_fed.samples"]["value"] > 0
    assert _digest(manifest.HERE) == before
