"""On the card: one short run of each cell through the benchmark's own
command comes out correct with its metrics."""

import json
import subprocess
import sys

import pytest

from portbench import manifest

CELLS = [w["name"] for w in json.loads(
    manifest.MANIFEST.read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(card, workload):
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=manifest.HERE.parent, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
