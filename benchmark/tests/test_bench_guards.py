"""What a run refuses: a machine without the card, and JAX or the JAX
package in the process; and that the plain reference imports nothing of
either package."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.harness import BENCH, ROOT


def test_no_card_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoCard):
        harness.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(harness.NoCard):
        harness.require_cards(4)


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "b0-fast-train",
                        "--seed", str(2 ** 31 + 3), "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_outside_a_checkout_exits_non_zero(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files only."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "b0-fast-train",
                        "--seed", "5", "--seconds", "1"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    monkeypatch.setitem(sys.modules, "lss_carla_tpu_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "lss_carla_tpu.models", object())
    assert harness.forbidden_modules() == ["jax", "lss_carla_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, drivers and the port's modules they use,
    in a fresh interpreter: no top-level jax, jaxlib, flax or
    lss_carla_tpu."""
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.harness as h, benchmark.drivers.train, benchmark.drivers.serve,"
            " benchmark.calibrate, benchmark.openloop;"
            "import lss_carla_torch.server, lss_carla_torch.serving,"
            " lss_carla_torch.data.loader, lss_carla_torch.training.step,"
            " lss_carla_torch.training.state, lss_carla_torch.models.lss;"
            "print(h.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_neither_package(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"lss_carla_torch", "lss_carla_tpu", "jax", "jaxlib", "flax"}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}
