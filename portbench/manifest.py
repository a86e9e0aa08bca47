"""Finds everything a cell needs by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: a deployment's widths (``source``,
  ``assumed``, ``reduced``, ``chips``, ``channels``, ``block_symbols`` and
  the ``demod`` group);
* ``traffic/<mix>.json``: the parameters of ``pool.make_pool`` and the
  path that differ from ``pool.DEFAULTS``, ``entry`` naming the path
  (``paths/<entry>.py``);
* ``limits/<workload>.json``: the limit of each number the cell's check
  compares;
* ``metrics/<metric>.py``: a per-layer metric's reader, by the metric's
  whole name or else by its name without the part after the last dot (the
  suffix that splits one quantity by the end-to-end metric it moves);
* ``rooflines/<kernel>.py``: a kernel's operations and bytes at given
  shapes.

A later cell, mix, configuration or metric is new files and new manifest
entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from .pool import DEFAULTS

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a reader file by its path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, path: Path = MANIFEST, root: Path = HERE):
        self.path = Path(path)
        self.root = Path(root)
        self.data = _json(self.path)

    def cell(self, workload: str) -> "Cell":
        for w in self.data["workloads"]:
            if w["name"] == workload:
                return Cell(self, w)
        raise KeyError(f"no workload {workload!r} in {self.path}")

    def metric_reader(self, name: str):
        for stem in (name, name.rsplit(".", 1)[0]):
            path = self.root / "metrics" / f"{stem}.py"
            if path.exists():
                return load_module(path, stem).read
        raise KeyError(f"no reader for metric {name!r}")

    def roofline(self, kernel: str):
        return load_module(self.root / "rooflines" / f"{kernel}.py", kernel)


def _listed(metric: dict, workload: str, e2e_of_cell) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


class Cell:
    """One workload with its configuration, traffic mix, limits and the
    metrics it reports."""

    def __init__(self, man: Manifest, entry: dict):
        self.man = man
        self.name = entry["name"]
        self.chips = int(entry["chips"])
        self.config_name = entry["config"]
        self.traffic_name = entry["traffic"]
        root = man.root
        self.config = _json(root / "configs" / f"{self.config_name}.json")
        self.traffic = dict(DEFAULTS, **_json(
            root / "traffic" / f"{self.traffic_name}.json"))
        self.limits = _json(root / "limits" / f"{self.name}.json")
        self.end_to_end = [m for m in man.data["end_to_end"]
                           if _listed(m, self.name, ())]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in man.data["per_layer"]
                          if _listed(m, self.name, e2e)]
