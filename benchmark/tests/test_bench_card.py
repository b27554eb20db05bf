"""A short run of every cell on the card: the result line's keys, the
device, and correct true. Skips without a card; on the card:
``python -m pytest benchmark/tests -m gpu``."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import ROOT, read_json

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run(card, cell, trace):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1 and line["metrics"]
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
