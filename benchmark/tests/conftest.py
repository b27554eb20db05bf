"""CPU tests of the benchmark's harness: ``python -m pytest benchmark/tests``.
Tests that need a CUDA card carry the ``gpu`` marker and skip without one
(``python -m pytest benchmark/tests -m gpu`` on the card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# a cell small enough for the CPU: the slim trunk, a 32 x 32 grid, 64 x 128
# images; the same drivers, feeds, checks and limits as the real cells
TINY = {"variant": "slim", "final_dim": [64, 128], "ncams": 6, "downsample": 16,
        "camC": 64, "outC": 1, "pos_weight": 2.13, "label_mode": "vehicle_binary",
        "grid": {"xbound": [-16.0, 16.0, 1.0], "ybound": [-16.0, 16.0, 1.0],
                 "zbound": [-10.0, 10.0, 20.0], "dbound": [4.0, 12.0, 1.0]}}


@pytest.fixture
def tiny_cell():
    """Make a ``harness.Cell`` of a real cell's workload and traffic files
    around the TINY configuration, to run on the CPU."""
    import torch

    from benchmark.harness import BENCH, Cell, process_start, read_json
    torch.set_num_threads(4)

    def make(workload, traffic, seconds=1.0, fault=None, **work):
        w = dict(read_json(BENCH / "workloads" / f"{workload}.json"), **work)
        t = read_json(BENCH / "traffic" / f"{traffic}.json")
        if t["generator"] == "fixture":
            t.update(scenes=3, samples_per_scene=4, H=96, W=192)
        if t["generator"] == "poisson":
            t.update(rate_per_s=20, sample=16, workers=8, warmup=2, bodies=8)
        if t["generator"] == "staged":
            t.update(batches=4)
        return Cell(workload, 2 ** 31 + 7, seconds, False, {}, dict(TINY), t, w,
                    device="cpu", start=process_start(), fault=fault)
    return make
