#!/usr/bin/env python3
"""Readings that the ``bevfusion-seg-train`` cell's limits are set from,
several seeds in one process (the benchmark's runs never run this):

    python3 benchmark/calibrate_bevfusion.py --seeds 1-12 --seconds 3 \\
        --faults half_batch,late_half_batch --fault-seeds 2 --witness-seeds 4

For each seed, one JSON line: the program's numbers against the reference
(a run of the cell's driver with a window of ``--seconds``), the fp8
control's (the reference with every tensor the program keeps in bf16
rounded to fp8 e4m3 in the program's place), each with its verdict under
the cell's limits; on the first ``--witness-seeds`` seeds the bf16 witness
(the reference itself with those tensors rounded to bf16); and on the
first ``--fault-seeds`` seeds each fault planted in the program, with its
verdict. ``calibrate.py`` does the same for the LSS cells.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="bevfusion-seg-train")
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=2)
    p.add_argument("--witness-seeds", type=int, default=4)
    a = p.parse_args()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache" / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.calibrate import seeds, verdict
    from benchmark.drivers import train_bevfusion as drv
    from benchmark.harness import load_cell, process_start
    from benchmark.reference.lss import fp8_e4m3, rounded
    faults = [f for f in a.faults.split(",") if f]
    dev = torch.device("cuda")
    for i, seed in enumerate(seeds(a.seeds)):
        cell = load_cell(a.workload, seed=seed, seconds=a.seconds, trace=False,
                         start=process_start())
        limits = cell.work["limits"]
        run = drv.run(cell)
        chk = run.layer["check"]
        out = {"seed": seed, "program": chk["numbers"],
               "correct": verdict(chk["numbers"], limits), "notes": run.notes}
        del run
        for name, quant, seeded in (("control", fp8_e4m3, True),
                                    ("bf16_witness", rounded(torch.bfloat16),
                                     i < a.witness_seeds)):
            if seeded:
                other = drv.reference(cell, dev, chk["checked"], chk["masks"], chk["after"],
                                      quant, chk["replay"])
                numbers, readings = drv.numbers(other, chk["ref"])
                out[name] = {"numbers": numbers, "verdict": verdict(numbers, limits),
                             "loss_gaps": readings["loss_gaps"]}
                del other
        del chk
        for fault in faults if i < a.fault_seeds else []:
            r = drv.run(cell.__class__(**{**cell.__dict__, "fault": fault}))
            out[fault] = {"numbers": r.layer["check"]["numbers"],
                          "verdict": verdict(r.layer["check"]["numbers"], limits)}
            del r
        torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
