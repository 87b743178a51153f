"""The control at a cell's own size, on the card: three seeds each of the
unbroken run and of the control (benchmark/control.py), in one process a
cell.  Run on the card's machine:
python3 -m pytest benchmark/tests -m card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_sound_runs_pass(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "control.py"),
         "--workload", cell, "--seeds", "101,202,303", "--seconds", "3",
         "--sound"], capture_output=True, text=True, timeout=3000,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(runs) == 6
    for r in runs:
        assert r["correct"] == (r["run"] == "sound"), r
