"""Does an imported trunk help? The port of
``scripts/pretrained_trunk_probe.py``: a transfer experiment through
``train(pretrained_trunk=...)``.

The reference's accuracy rests on starting from a pretrained EfficientNet
trunk (reference ``src/models.py:43``). With no ImageNet file at hand, the
probe shows the same mechanism end to end:

1. pretrain: train LSS on fixture A (scenes of seed 0) and checkpoint;
2. probe: train twice on fixture B (other scenes, seed 100) with the same
   data and seeds, once from random init and once with
   ``pretrained_trunk=<phase 1's ckpts/>`` (only the camera trunk
   transfers);
3. print both train-IoU curves, the step at which each first reaches the
   random run's last IoU and each phase's wall time, and write them to
   ``<workdir>/probe_result.json``.

A trunk that transfers reaches a given IoU in fewer steps than random init.

    python -m lss_carla_torch.trunk_probe --pretrain_steps 500 \\
        --probe_steps 200 --dtype bfloat16 [--workdir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.training.loop import train
from lss_carla_torch.utils.backend import card_line, resolve_device

# the JAX probe's fixtures: 8 scenes x 24 samples at the generator's
# default 224 x 480 sources and 200 x 200 labels
FIXTURE = dict(num_scenes=8, samples_per_scene=24)


def iou_curve(logdir) -> list:
    """(step, train/iou) pairs of a run's ``metrics.jsonl``."""
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["train/iou"]) for r in recs if "train/iou" in r]


def first_step_at(curve: dict, target: float) -> Optional[int]:
    """The first logged step whose IoU reaches ``target`` (None: never)."""
    return next((s for s, v in sorted(curve.items()) if v >= target), None)


def run_probe(workdir, pretrain_steps: int = 500, probe_steps: int = 200,
              dtype: str = "bfloat16", bsz: int = 8, device="cuda",
              fixture: Optional[dict] = None, **train_kw) -> dict:
    """Both phases in ``workdir``; returns what ``probe_result.json``
    holds. ``fixture`` overrides ``FIXTURE``'s generator arguments and
    ``train_kw`` the runs' common ``train()`` keywords (the tests' tiny
    shapes)."""
    dev = resolve_device(device)
    work = Path(workdir)
    print(f"workdir: {work}", flush=True)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    fix = {**FIXTURE, **(fixture or {})}
    fix_a = generate_fixture(work / "fix_a", **fix, seed=0)
    fix_b = generate_fixture(work / "fix_b", **fix, seed=100)
    common = dict(nepochs=10_000, bsz=bsz, nworkers=8, lr=1e-3, val_step=0,
                  save_step=0, viz_step=0, iou_log_step=20,
                  compute_dtype=dtype, n_devices=1, device=device)
    common.update(train_kw)
    seconds = {}

    print("=== phase 1: pretrain on fixture A ===", flush=True)
    t0 = time.perf_counter()
    train(dataroot=str(fix_a), logdir=str(work / "pretrain"),
          max_steps=pretrain_steps, **{**common, "save_step": pretrain_steps})
    seconds["pretrain"] = time.perf_counter() - t0
    ckpt = str(work / "pretrain" / "ckpts")

    print("=== phase 2: probe runs on fixture B ===", flush=True)
    for name, trunk in (("random", None), ("pretrained", ckpt)):
        t0 = time.perf_counter()
        train(dataroot=str(fix_b), logdir=str(work / f"probe_{name}"),
              max_steps=probe_steps, pretrained_trunk=trunk, seed=7, **common)
        seconds[name] = time.perf_counter() - t0

    curves = {name: dict(iou_curve(work / f"probe_{name}"))
              for name in ("random", "pretrained")}
    print("\n=== early train-IoU trajectories (fixture B) ===")
    print(f"{'step':>6} {'random':>10} {'pretrained':>12}")
    for s in sorted(set(curves["random"]) | set(curves["pretrained"])):
        print(f"{s:>6} {curves['random'].get(s, float('nan')):>10.4f} "
              f"{curves['pretrained'].get(s, float('nan')):>12.4f}")
    target = curves["random"][max(curves["random"])]
    steps_to = {name: first_step_at(c, target) for name, c in curves.items()}
    print(f"first step at the random run's last IoU {target:.4f}: "
          f"random {steps_to['random']}, pretrained {steps_to['pretrained']}")
    print("wall s: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    out = {**curves, "steps_to_target": {"target": target, **steps_to},
           "seconds": seconds, "card": card,
           "config": {"pretrain_steps": pretrain_steps,
                      "probe_steps": probe_steps, "dtype": dtype, "bsz": bsz}}
    with open(work / "probe_result.json", "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwritten: {work / 'probe_result.json'}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pretrain_steps", type=int, default=500)
    p.add_argument("--probe_steps", type=int, default=200)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--bsz", type=int, default=8)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    run_probe(args.workdir or tempfile.mkdtemp(prefix="trunk_probe_"),
              args.pretrain_steps, args.probe_steps, args.dtype, args.bsz,
              args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
