"""On the card: each cell's command, short, prints a correct result line,
and the control at the cell's own size comes out not correct. Skips on a
host without a card. Run on the card with

    python -m pytest retrieval_bench/tests/test_rb_card.py -q
"""

import json
import subprocess
import sys

import pytest

from retrieval_bench import control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_command_prints_a_correct_result(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "retrieval_bench.run", "--workload", name, "--seed", "424242",
         "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == set(harness.metric_names(name, False))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    out = harness.run(name, 525252, 2.0, False, device=card, factory=control.factory("control"))
    assert not out["correct"], out["checks"]
