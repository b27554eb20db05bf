#!/usr/bin/env python3
"""How far one B0 train step on the card lands from the same step on the CPU.

    python3 card_cpu_spread.py

For each of SEEDS: a small synthetic SimBEV fixture (5 scenes x 2
samples at 224 x 480, drawn from the seed), B0 weights drawn from the
seed, and ``chip_smoke.py``'s phase-9 step (bsz 2, ``fused_dw``, dropout
0, f32, TF32 off) on the CPU, on the card through the two kernels, on the
card through the kernels' plain versions, and once more on the CPU with
every depthwise sum and sum of squares moved by about one ulp (random
signs; NUDGES draws, the worst kept): what f32 rounding of the moments
alone does to the step, with no card involved. One JSON line a seed
gives, for each of the last three paths, the relative miss of the global
gradient norm against the CPU's and, separately for the parameters whose
gradient comes back through a train-mode BN (``bn``) and those after the
last one (``head``), as phase 9 holds them to ``BN_GRAD_TOL`` and
``GRAD_TOL``: the worst relative L2 miss of a parameter's gradient, with
the parameter's name, and the count of parameters that miss ``GRAD_TOL``.
Gradients that are 0 up to rounding, within ``GRAD_ABS`` of the global
norm, are left out. The last line holds the maximum over the seeds and
the card's name and power limit: the readings behind
``chip_smoke.BN_GRAD_TOL``.
"""

from __future__ import annotations

import json
import sys
import tempfile

import torch

import chip_smoke as cs
from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import mbconv
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step

SEEDS = range(12)
NUDGES = 4
NUDGED = "cpu, moments +-1 ulp"
PATHS = ("card", "card, plain versions", NUDGED)


def nudged_cpu_step(seed, batch, draw):
    """(model, metrics) of phase 9's CPU step with each depthwise moment
    multiplied by 1 +- 2^-23 (random signs, from ``seed`` and ``draw``)."""
    gen = torch.Generator().manual_seed(1000 * seed + draw)
    plain = mbconv.dw_conv_stats_reference

    def nudged(x, w, stride):
        y, s, ss = plain(x, w, stride)
        sign = [2.0 * torch.randint(0, 2, t.shape, generator=gen) - 1 for t in (s, ss)]
        return y, s * (1 + sign[0] * 2.0 ** -23), ss * (1 + sign[1] * 2.0 ** -23)

    model = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                          fused_dw=True, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    cs.zero_dropout(model)
    mbconv.dw_conv_stats_reference = nudged
    try:
        metrics = make_train_step(model, 2.13, device="cpu")(
            create_train_state(model), batch)
    finally:
        mbconv.dw_conv_stats_reference = plain
    return model, metrics


def spread(models, metrics) -> dict:
    """{"<path> <bn|head>": {"worst", "at", "over_grad_tol"}} and {"<path>
    grad_norm": relative miss of the global norm}."""
    nc = float(metrics["cpu"]["grad_norm"])
    out = {}
    for path in PATHS:
        out[f"{path} grad_norm"] = abs(float(metrics[path]["grad_norm"]) - nc) / nc
        misses = cs.grad_misses(models[path], models["cpu"])
        for part, tol in (("bn", cs.BN_GRAD_TOL), ("head", cs.GRAD_TOL)):
            rel = [(d / r, k) for k, (d, r) in misses.items()
                   if cs.grad_limit(k) == tol and d > cs.GRAD_ABS * nc]
            worst, at = max(rel, default=(0.0, ""))
            out[f"{path} {part}"] = {
                "worst": worst, "at": at,
                "over_grad_tol": sum(x > cs.GRAD_TOL for x, _ in rel)}
    return out


def worst_of(v) -> float:
    return v["worst"] if isinstance(v, dict) else v


def main() -> int:
    if not torch.cuda.is_available():
        print("card_cpu_spread: no CUDA GPU available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in SEEDS:
            root = generate_fixture(f"{tmp}/simbev{seed}", num_scenes=5,
                                    samples_per_scene=2, H=224, W=480, seed=seed)
            models, metrics, _, batch = cs.card_cpu_steps(root, seed)
            line = {}
            for draw in range(NUDGES):
                models[NUDGED], metrics[NUDGED] = nudged_cpu_step(seed, batch, draw)
                for key, v in spread(models, metrics).items():
                    if key not in line or worst_of(v) > worst_of(line[key]):
                        line[key] = v
            print(json.dumps({"seed": seed, **line}), flush=True)
            for key, v in line.items():
                if key not in worst or worst_of(v) >= worst_of(worst[key]):
                    worst[key] = {**(v if isinstance(v, dict) else {"worst": v}),
                                  "seed": seed}
    print(json.dumps({"card": cs.card_line(), "seeds": list(SEEDS), "max": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
