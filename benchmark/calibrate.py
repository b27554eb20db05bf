#!/usr/bin/env python3
"""Readings that a cell's limits and serving rates are set from, several
seeds in one process (the benchmark's runs never run this):

    python3 benchmark/calibrate.py readings --workload b0-fast-train --seeds 1-12
    python3 benchmark/calibrate.py sweep --workload b0-serve-overload --rates 60,90,120

``readings`` runs the cell's set-up and check for each seed with a window
of ``--seconds`` and prints one JSON line a seed: the program's numbers
against the reference, the control's (the reference in the next precision
down in the program's place: every tensor the program keeps in its
compute dtype rounded to fp8 e4m3 for a bf16 cell, to bf16 for an f32
one), each with its verdict under the cell's own limits
(``harness.judge``), and, with ``--faults``, each fault that the cell can
have planted in the program on the first ``--fault-seeds`` seeds, with its
verdict; ``--witness`` runs the first two seeds' program in f32 with TF32
off as well. ``sweep`` runs the serving
cell at each rate and prints what was offered, answered and its tail.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def verdict(numbers, limits):
    """The numbers a cell compares, and ``correct`` under its limits."""
    from benchmark.harness import judge
    checks = {k: (numbers[k], lim) for k, lim in limits.items() if k in numbers}
    return {"compared": {k: v for k, (v, _) in checks.items()}, "correct": judge(checks)}


def train_readings(cell, faults, witness):
    import torch

    from benchmark import compare
    from benchmark.drivers import train
    from benchmark.reference import lss
    run = train.run(cell)
    chk = run.layer["check"]
    readings = compare.train_numbers(chk["prog"], chk["ref"])[1]
    quant = lss.fp8_e4m3 if cell.work["compute_dtype"] == "bfloat16" else \
        lss.rounded(torch.bfloat16)
    control = train.reference(cell, torch.device(cell.device), chk["checked"],
                              chk["masks"], chk["after"], quant)
    ctrl, ctrl_readings = compare.train_numbers(control, chk["ref"])
    if witness:     # the reference itself in the program's precision
        emulated = train.reference(cell, torch.device(cell.device), chk["checked"],
                                   chk["masks"], chk["after"], lss.rounded(torch.bfloat16))
        witnessed = compare.train_numbers(emulated, chk["ref"])[0]
        del emulated
    limits = {k: v for k, v in cell.work["limits"].items() if k != "image_levels"}
    out = {"program": chk["numbers"], "correct": verdict(chk["numbers"], cell.work["limits"]),
           "control": ctrl, "control_verdict": verdict(ctrl, limits),
           "program_readings": readings, "control_loss_gaps": ctrl_readings["loss_gaps"],
           "notes": run.notes}
    del run, chk, control
    for fault in faults:
        r = train.run(cell.__class__(**{**cell.__dict__, "fault": fault}))
        out[fault] = {"numbers": r.layer["check"]["numbers"],
                      "verdict": verdict(r.layer["check"]["numbers"], cell.work["limits"])}
    if witness:
        work = dict(cell.work, compute_dtype="float32")
        with lss.full_f32():
            r = train.run(cell.__class__(**{**cell.__dict__, "work": work}))
        out["f32_witness"] = r.layer["check"]["numbers"]
        out["bf16_reference"] = witnessed
    return out


def serve_readings(cell, faults, witness):
    import torch

    from benchmark.drivers import serve
    from benchmark.reference import lss
    run = serve.run(cell)
    chk = run.layer["check"]
    control = serve.reference_answers(cell, torch.device(cell.device), chk["ids"],
                                      (lss.rounded(torch.bfloat16),))[0]
    ctrl = serve.logit_numbers(chk["ids"], [control[int(i)] for i in chk["ids"]],
                               chk["want"], chk["scale"])
    ctrl["unanswered"] = 0.0
    out = {"program": chk["numbers"], "correct": verdict(chk["numbers"], cell.work["limits"]),
           "control": ctrl, "control_verdict": verdict(ctrl, cell.work["limits"]),
           "notes": run.notes}
    for fault in faults:
        r = serve.run(cell.__class__(**{**cell.__dict__, "fault": fault}))
        out[fault] = {"numbers": r.layer["check"]["numbers"],
                      "verdict": verdict(r.layer["check"]["numbers"], cell.work["limits"])}
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("what", choices=("readings", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--rates", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--witness", action="store_true")
    a = p.parse_args()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache" / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import load_cell, load_driver, process_start
    faults = [f for f in a.faults.split(",") if f]
    for i, seed in enumerate(seeds(a.seeds)):
        if a.what == "sweep":
            for rate in a.rates.split(","):
                cell = load_cell(a.workload, seed=seed, seconds=a.seconds, trace=False,
                                 start=process_start())
                cell.traffic = dict(cell.traffic, rate_per_s=float(rate))
                run = load_driver("serve").run(cell)
                print(json.dumps({"seed": seed, "rate": float(rate),
                                  "answered_per_s": run.e2e["serve_samples_per_s"],
                                  "p95_ms": run.e2e["serve_p95_ms"], "notes": run.notes}),
                      flush=True)
            continue
        cell = load_cell(a.workload, seed=seed, seconds=a.seconds, trace=False,
                         start=process_start())
        fn = train_readings if cell.work["driver"] == "train" else serve_readings
        out = fn(cell, faults if i < a.fault_seeds else [], a.witness and i < 2)
        print(json.dumps({"seed": seed, **out}), flush=True)


if __name__ == "__main__":
    main()
