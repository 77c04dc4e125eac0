"""On the card: each cell runs end to end through the command, short, and
comes out correct with every metric it owes (``cuda`` marker; run with
``python -m pytest h100bench/tests -m cuda``)."""

import json
import subprocess
import sys

import pytest

import harness
from smallcells import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    c = harness.load_cell(ROOT, cell)
    owed = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if not trace:
        owed.discard("solve_ms_p95")    # needs 200 solves; 3 s is short
    assert owed <= set(result["metrics"])
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
