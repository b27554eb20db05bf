#!/usr/bin/env python3
"""Run one cell of the benchmark of ``lss_carla_torch`` on this machine's
CUDA cards and print its result as the last line of standard output:

    python3 benchmark/run.py --workload b0-fast-train --seed 1 --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window. The cells, configurations,
traffic mixes and metrics are the files ``BENCHMARK.json`` names
(``benchmark/README.md``). Without a CUDA card the run exits non-zero and
prints no result.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # every build and kernel cache at a fixed place inside the checkout
    cache = ROOT / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import main
    sys.exit(main())
