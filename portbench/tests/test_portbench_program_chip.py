"""On the card: a short traced run of each cell reads the program's spans
and counters, and the bus carries exactly the bytes the cell's formats
say: up 8 (int16 wire: 4) bytes a sample; down the soft planes 1 (int8:
0.25), the phase 0.5, the sample index and the packed bits 0.125 each."""

import json
import subprocess
import sys

import pytest

from portbench import manifest

COPY_BYTES = {"qpsk1024.ports": 9.75, "qpsk1024.i16": 5.0}


@pytest.mark.chip
@pytest.mark.parametrize("workload", sorted(COPY_BYTES))
def test_traced_run_reads_the_program(card, workload):
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 77), "--seconds", "5", "--trace", "1"],
        cwd=manifest.HERE.parent, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    m = line["metrics"]
    assert line["correct"]
    assert m["copy_bytes.samples"]["value"] == COPY_BYTES[workload]
    for name in ("upload_ms.samples", "fetch_ms.samples",
                 "assemble_ms.samples", "engine_ms.samples",
                 "idle_pct.samples", "b1_roofline.samples"):
        assert m[name]["value"] > 0, name
    assert "portbench program " in res.stderr
