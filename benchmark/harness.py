"""The benchmark's harness: finds a cell's files by name, checks the card,
runs the cell's traffic driver, judges its outputs and prints the result.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``benchmark/workloads/<cell>.json``: the driver (a module of
  ``benchmark/drivers/``), the path's settings and the limits of the
  numbers that decide ``correct``;
* ``benchmark/configs/<config>.json``: the model's sizes;
* ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters;
* ``benchmark/metrics/<metric>.py``: a ``read(run)`` that returns the
  per-layer metric's value, or None where the run has nothing to read.

A driver's ``run(cell)`` returns a ``Run`` (below); the harness adds
nothing to what it measured.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lss_carla_tpu")
# a metric's value's letters; a unit's
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")
UNIT_CHARS = NAME_CHARS | set("/%")


class NoCard(SystemExit):
    """The run needs CUDA cards that this machine does not have."""


def valid_name(name: str) -> bool:
    return (isinstance(name, str) and 0 < len(name) <= 64
            and name[0] not in ".-" and set(name) <= NAME_CHARS)


def valid_unit(unit: str) -> bool:
    return isinstance(unit, str) and 0 < len(unit) <= 16 and set(unit) <= UNIT_CHARS


def boot_clock() -> float:
    """Seconds on the clock that ``process_start`` reads."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """When this process started, on ``boot_clock``'s scale (10 ms steps)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark measures the port on the "
                     "card and has no other path")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, this machine has "
                     f"{torch.cuda.device_count()}")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One run of one cell: the manifest entry, its files and the run's
    arguments. ``device`` is "cuda" on the card; the CPU tests drive the
    rest of a run with "cpu"."""
    name: str
    seed: int
    seconds: float
    trace: bool
    entry: dict
    config: dict
    traffic: dict
    work: dict
    device: str = "cuda"
    start: float = 0.0           # process start, on boot_clock
    fault: Optional[str] = None  # a planted fault (tests of the check only)


@dataclasses.dataclass
class Run:
    """What a driver measured. ``e2e``: end-to-end values by name (the
    traced run's are not reported). ``checks``: {name: (value, limit)} of
    the numbers compared with the reference. ``layer``: what the
    per-layer readers read (``trace``: a ``trace.Summary`` or None,
    counters, spans, FLOPs, byte bounds)."""
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    layer: dict = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)


def load_cell(name: str, root: Path = ROOT, **kw) -> Cell:
    manifest = read_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json "
                         f"({', '.join(entries)})")
    entry = entries[name]
    bench = root / "benchmark"
    return Cell(name=name, entry=entry,
                config=read_json(bench / "configs" / f"{entry['config']}.json"),
                traffic=read_json(bench / "traffic" / f"{entry['traffic']}.json"),
                work=read_json(bench / "workloads" / f"{name}.json"), **kw)


def cell_metrics(manifest: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: the
    end-to-end ones that list it under ``workloads`` or have no such key,
    and the per-layer ones that list it under ``workloads``, which every
    per-layer entry has."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m for m in manifest["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def load_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def judge(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Correct when every number is finite and within its limit."""
    return bool(checks) and all(v == v and v <= lim for v, lim in checks.values())


def result_line(cell: Cell, run: Run, manifest: dict, device: dict,
                root: Path = ROOT) -> dict:
    e2e, layer = cell_metrics(manifest, cell.name)
    metrics = {}
    if cell.trace:
        for m in layer:
            value = load_reader(m["name"], root)(run.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    out = {"correct": judge(run.checks), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if cell.trace and run.layer.get("trace") is not None:
        out["breakdown"] = run.layer["trace"].breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def device_info(run: Run, chips: int, trace) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if trace is not None:
        info["busy_s"], info["window_s"] = trace.busy_s, trace.window_s
    return info


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    start = process_start()
    manifest = read_json(ROOT / "BENCHMARK.json")
    cell = load_cell(args.workload, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), start=start)
    chips = int(cell.entry["chips"])
    require_cards(chips)
    run = load_driver(cell.work["driver"]).run(cell)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    trace = run.layer.get("trace") if cell.trace else None
    line = result_line(cell, run, manifest, device_info(run, chips, trace))
    for note in run.notes:
        print(note, file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
