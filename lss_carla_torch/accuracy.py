"""The fast recipe against the JAX package's accuracy band, on one GPU.

    python -m lss_carla_torch.accuracy --out runs/accuracy --seed 42

1. Makes the ``docs/ACCURACY.md`` fixture with the port's generator
   (``data/fixtures.py``): 48 scenes of 32 samples, seed 11, 224 x 480
   sources (1,216 train and 320 val samples), under ``OUT/fixture``; an
   existing one is reused.
2. Trains through ``train()`` with exactly ``recipes/simbev_fast.sh``'s
   flags (``FAST_FLAGS``: bsz 8, 4 workers, bf16, ``--resize_lim 0.70
   0.85``, cosine with 500 warm-up steps over 4,000, 4,000 steps,
   validation every 500, a checkpoint every 1,000) into ``OUT/run``.
3. Evaluates that run's ``model_best.pt`` with ``eval_model_iou``, in the
   trained dtype and again with its eligible convs in int8
   (``quantize=True``, ``ops/quant.py``).
4. Writes ``OUT/accuracy.json`` and prints it on one line: ``val/iou`` at
   every validation, the best and its step, the float and int8 IoU of the
   same checkpoint, wall times, and the card's name and power limit.

The JAX package's band for this recipe is 0.712 +- 0.005 over 5 runs
(``docs/ACCURACY.md``); ``BEST_FLOOR`` 0.70 is the best val IoU that
holds the port to it. The script records; it does not judge a run.
Everything it writes (fixture, checkpoints) stays under ``OUT``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from lss_carla_torch.configs import GridConf
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.explore import eval_model_iou
from lss_carla_torch.train import build_parser, train_kwargs
from lss_carla_torch.training.loop import train
from lss_carla_torch.utils.backend import card_line, resolve_device

# recipes/simbev_fast.sh, less --dataroot and --logdir
FAST_FLAGS = ("--bsz", "8", "--nworkers", "4", "--compute_dtype", "bfloat16",
              "--resize_lim", "0.70", "0.85", "--lr_schedule", "cosine",
              "--warmup_steps", "500", "--decay_steps", "4000",
              "--max_steps", "4000", "--val_step", "500",
              "--save_step", "1000")
# docs/ACCURACY.md's fixture (generate_fixture's keywords)
FIXTURE = {"num_scenes": 48, "samples_per_scene": 32, "seed": 11,
           "H": 224, "W": 480}
JAX_BAND = (0.712, 0.005)   # mean and spread of 5 runs, docs/ACCURACY.md
BEST_FLOOR = 0.70


def _read_jsonl(path: Path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def run(out, seed: int = 42, device: str = "cuda",
        fixture: Optional[dict] = None, extra_flags: Sequence[str] = ()) -> dict:
    """Steps 1-4 above. ``fixture`` replaces ``FIXTURE`` and
    ``extra_flags`` follow ``FAST_FLAGS`` (the tests' tiny run); the
    recipe is what runs without them. Returns the record."""
    dev = resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    fixture = dict(FIXTURE if fixture is None else fixture)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"accuracy: {card}, seed {seed}, out {out}", flush=True)

    t0 = time.perf_counter()
    root = out / "fixture"
    if not (root / "SimBEV_cvt_label").is_dir():
        generate_fixture(root, **fixture)
    fixture_s = time.perf_counter() - t0

    logdir = out / "run"
    argv = ["--dataroot", str(root), "--logdir", str(logdir), *FAST_FLAGS,
            "--seed", str(seed), "--device", dev.type, *extra_flags]
    kw = train_kwargs(build_parser().parse_args(argv))
    t0 = time.perf_counter()
    result = train(**kw)
    train_s = time.perf_counter() - t0

    grid_conf = GridConf(xbound=kw["xbound"], ybound=kw["ybound"],
                         zbound=kw["zbound"], dbound=kw["dbound"])
    evals, eval_s = {}, {}
    for name, quantize in (("float", False), ("int8", True)):
        t0 = time.perf_counter()
        evals[name] = eval_model_iou(
            str(root), str(logdir / "ckpts"), best=True, bsz=kw["bsz"],
            nworkers=kw["nworkers"], quantize=quantize, device=str(dev),
            H=kw["H"], W=kw["W"], final_dim=kw["final_dim"],
            grid_conf=grid_conf, compute_dtype=kw["compute_dtype"], variant=kw["variant"])
        eval_s[name] = time.perf_counter() - t0

    metrics = _read_jsonl(logdir / "metrics.jsonl")
    curve = [{"step": m["step"], "val_iou": m["val/iou"],
              "val_loss": m["val/loss"]} for m in metrics if "val/iou" in m]
    best = max(curve, key=lambda c: c["val_iou"]) if curve else None
    step_times = [m["train/step_time"] for m in metrics
                  if "train/step_time" in m]
    record = {
        "seed": seed, "steps": result["counter"],
        "recipe": "lss_carla_torch/recipes/simbev_fast.sh",
        "flags": list(FAST_FLAGS) + list(extra_flags), "fixture": fixture,
        "curve": curve,
        "train_iou": [{"step": m["step"], "iou": m["train/iou"]}
                      for m in metrics if "train/iou" in m],
        "best_val_iou": result["best_val_iou"],
        "best_step": best["step"] if best else None,
        "float": {"iou": evals["float"]["iou"], "loss": evals["float"]["loss"]},
        "int8": {"iou": evals["int8"]["iou"], "loss": evals["int8"]["loss"]},
        "int8_drop": evals["float"]["iou"] - evals["int8"]["iou"],
        "jax_band": list(JAX_BAND), "best_floor": BEST_FLOOR,
        "wall_s": {"fixture": fixture_s, "train": train_s, **{
            f"eval_{k}": v for k, v in eval_s.items()}},
        "step_time_s_median": (float(np.median(step_times))
                               if step_times else None),
        "card": card,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    with open(out / "accuracy.json", "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="runs/accuracy",
                   help="fixture, run and accuracy.json go here")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    run(a.out, seed=a.seed, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
