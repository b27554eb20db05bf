"""The port's recipes (lss_carla_torch/recipes/*.sh) against configs/*.sh,
and lss_carla_torch/accuracy.py: its train() arguments are the fast
recipe's, and a 2-step run on a tiny fixture writes accuracy.json."""

import json
import re
import shlex
from pathlib import Path

import pytest
import torch

from lss_carla_torch import accuracy
from lss_carla_torch.train import build_parser, train_kwargs

REPO = Path(__file__).resolve().parent.parent
RECIPES = ("simbev_default", "simbev_small", "simbev_fast", "simbev_stretch")


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's workers share the cores; these tiny models need one
    intra-op thread each (a full-width pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sh_command(path: Path):
    """(the command's tokens, its flags as {flag: [values]}, the flags the
    script names as not ported) of a recipe script: its shell variables
    expanded, the ``python ... \\`` command joined."""
    text = path.read_text()
    env = {}
    for name, value in re.findall(r"^([A-Z_]+)=(.*)$", text, re.M):
        value = re.sub(r"\s+#.*$", "", value).strip().strip('"')
        env[name] = re.sub(r"\$\{\w+:-(.*)\}", r"\1", value)
    command = text[text.index("\npython ") + 1:].replace("\\\n", " ")
    command = re.sub(r"\$(\w+)", lambda m: env[m.group(1)], command.strip())
    tokens = shlex.split(command)
    flags, current = {}, None
    for tok in tokens[2 if tokens[1] != "-m" else 3:]:
        if tok.startswith("--"):
            current = tok
            flags[current] = []
        else:
            flags[current].append(tok)
    missing = set()
    for line in re.findall(r"^# Not ported: (.*)$", text, re.M):
        missing |= set(re.findall(r"--[a-z_]+", line.split("(")[0]))
    return tokens, flags, missing


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_is_the_config_through_the_port(name):
    tokens, ours, missing = sh_command(REPO / "lss_carla_torch" / "recipes"
                                       / f"{name}.sh")
    theirs_tokens, theirs, _ = sh_command(REPO / "configs" / f"{name}.sh")
    assert tokens[:3] == ["python", "-m", "lss_carla_torch.train"]
    assert theirs_tokens[:2] == ["python", "train_simbev.py"]
    assert missing == set()
    assert ours == {k: v for k, v in theirs.items() if k not in missing}
    argv = [t for k, v in ours.items() for t in (k, *v)]
    args = build_parser().parse_args(argv)  # every flag the port has
    assert args.dataroot == ours["--dataroot"][0]


def test_accuracy_trains_exactly_the_fast_recipe():
    """accuracy.py's FAST_FLAGS give train() the keywords that
    recipes/simbev_fast.sh's flags give it."""
    _, flags, _ = sh_command(REPO / "lss_carla_torch" / "recipes"
                             / "simbev_fast.sh")
    base = ["--dataroot", "D", "--logdir", "L"]
    recipe = [t for k, v in flags.items() if k not in ("--dataroot", "--logdir")
              for t in (k, *v)]
    parse = build_parser().parse_args
    assert train_kwargs(parse(base + list(accuracy.FAST_FLAGS))) == \
        train_kwargs(parse(base + recipe))
    kw = train_kwargs(parse(base + list(accuracy.FAST_FLAGS)))
    assert (kw["bsz"], kw["nworkers"], kw["compute_dtype"], kw["resize_lim"],
            kw["lr_schedule"], kw["warmup_steps"], kw["decay_steps"],
            kw["max_steps"], kw["val_step"], kw["save_step"]) == (
        8, 4, "bfloat16", (0.70, 0.85), "cosine", 500, 4000, 4000, 500, 1000)
    assert accuracy.FIXTURE == {"num_scenes": 48, "samples_per_scene": 32,
                                "seed": 11, "H": 224, "W": 480}


def test_accuracy_runs_and_records(tmp_path):
    """Two steps on a tiny fixture, on the CPU: accuracy.json holds the
    curve, the best, the float and int8 IoU of model_best.pt and the wall
    times, and the same record is printed."""
    tiny = ["--H", "64", "--W", "128", "--final_h", "32", "--final_w", "64",
            "--xbound", "-50", "50", "6.25", "--ybound", "-50", "50", "6.25",
            "--dbound", "4", "36", "8", "--bsz", "2", "--nworkers", "2",
            "--max_steps", "2", "--val_step", "2", "--save_step", "2",
            "--iou_log_step", "1", "--viz_step", "0"]
    rec = accuracy.run(tmp_path, seed=3, device="cpu", extra_flags=tiny,
                       fixture={"num_scenes": 5, "samples_per_scene": 2,
                                "H": 64, "W": 128, "grid": 16, "seed": 11})
    on_disk = json.loads((tmp_path / "accuracy.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert {"seed", "steps", "curve", "best_val_iou", "best_step", "float",
            "int8", "int8_drop", "jax_band", "best_floor", "wall_s", "card",
            "device", "train_iou"} <= set(rec)
    assert rec["steps"] == 2 and rec["card"] == rec["device"] == "cpu"
    assert [c["step"] for c in rec["curve"]] == [2]
    assert rec["best_val_iou"] == rec["curve"][0]["val_iou"]
    assert rec["float"]["iou"] == pytest.approx(rec["best_val_iou"], abs=1e-6)
    assert set(rec["int8"]) == {"iou", "loss"}
    assert rec["int8"]["loss"] != rec["float"]["loss"]
    assert set(rec["wall_s"]) == {"fixture", "train", "eval_float", "eval_int8"}
    assert (tmp_path / "run" / "ckpts" / "model_best.pt").exists()


def test_accuracy_defaults_to_the_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        accuracy.main(["--out", str(tmp_path)])
