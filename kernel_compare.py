#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's two kernels in several checkouts, on one GPU.

    python3 kernel_compare.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` for this one; an older
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). The roots run in turns, forwards and then backwards (A, B, B, A),
each in a fresh process that imports that ROOT's ``lss_carla_torch`` and
``chip_smoke.py``, builds its kernels, and times, by CUDA events around
calls queued behind a sleep kernel (device time back to back, launch gaps
included, the host's issue time not):

* ``dw_conv_stats_forward`` at the 16 depthwise shapes of the B0 trunk at
  N 24 (one bsz-4 train forward) in f32, and blocks 0, 1 and 11 in bf16;
* ``splat_forward`` (the whole call, whatever it launches) on seeded
  random ids (B 8, P 43,296, C 64, S 40,000, ~7 % at the sentinel); on
  the main path's own ids (the lift and geometry of a seeded B0 model at
  bsz 8) in f32 and in bf16; on ``chip_smoke.rig``'s ids at the stretch
  grid (bsz 4, S 160,000) with seeded bf16 features; and on its
  5-camera ids at bsz 4 (the nuScenes train batch's shape) in f32.

Each run prints one JSON line; the last line is a JSON summary with every
run's numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def queued_ms(fn, iters: int = 50) -> float:
    """Device time per call of ``fn`` back to back, without the host's
    time to issue the calls: they queue behind a sleep kernel that lasts
    at least twice their issue time, and two CUDA events, in the stream
    after the sleep, bracket them (launch gaps on the device included).
    ``chip_smoke.py`` times with it too."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_s * 2e9) + 1_000_000)  # cycles, <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def worker(root: str) -> dict:
    """The timings of ROOT's kernels (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.models.lss import compile_model
    from lss_carla_torch.ops import mbconv_cuda, splat_cuda
    from lss_carla_torch.ops.splat import voxel_indices

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root, "dw": {}, "splat": {}}
    for block, k, s, shape in cs.dw_shapes():
        for dtype in ((torch.float32, torch.bfloat16) if block in (0, 1, 11)
                      else (torch.float32,)):
            x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            w = 0.3 * torch.randn(shape[1], 1, k, k, generator=gen, device="cuda")
            name = f"{block} {'f32' if dtype == torch.float32 else 'bf16'}"
            out["dw"][name] = queued_ms(
                lambda: mbconv_cuda.dw_conv_stats_forward(x, w, s))
    out["dw_f32_total"] = sum(v for n, v in out["dw"].items() if n.endswith("f32"))

    S = 200 * 200
    pts, ids = cs.random_splat_inputs(gen, 8, 6 * 41 * 8 * 22, 64, S, torch.float32)
    out["splat"]["random f32"] = queued_ms(lambda: splat_cuda.splat_forward(pts, ids, S))
    model = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                          device="cpu", generator=torch.Generator().manual_seed(0))
    model = model.eval().cuda()
    with torch.inference_mode():
        t = [torch.as_tensor(a).cuda() for a in
             cs.inputs(np.random.default_rng(0), 8, True, (128, 352))]
        geom = model.get_geometry(*t[1:])
        pts = model.get_cam_feats(t[0]).reshape(8, -1, 64).contiguous()
        ids = voxel_indices(geom, model.dx, model.bx, model.nx)[0].reshape(8, -1).contiguous()
    out["splat"]["main path f32"] = queued_ms(lambda: splat_cuda.splat_forward(pts, ids, S))
    pts = pts.to(torch.bfloat16)
    out["splat"]["main path bf16"] = queued_ms(lambda: splat_cuda.splat_forward(pts, ids, S))
    for name, grid, B, ncams, dtype in (
            ("stretch bf16", cs.STRETCH_GRID, 4, 6, torch.bfloat16),
            ("5-camera f32", GridConf(), 4, 5, torch.float32)):
        rig = cs.rig(np.random.default_rng(0), B, ncams, (128, 352))
        model = compile_model(grid, DataAugConf(), outC=1, variant="slim",
                              device="cpu").cuda()
        with torch.inference_mode():
            geom = model.get_geometry(*[torch.as_tensor(a).cuda() for a in rig])
            ids = voxel_indices(geom, model.dx, model.bx, model.nx)[0].reshape(B, -1).contiguous()
        S = int(np.prod(model.nx))
        pts = torch.randn(B, ids.shape[1], 64, generator=gen, device="cuda").to(dtype)
        out["splat"][name] = queued_ms(lambda: splat_cuda.splat_forward(pts, ids, S))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.roots[0])), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    runs = []
    for root in args.roots + args.roots[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
