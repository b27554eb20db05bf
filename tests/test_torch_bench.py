"""lss_carla_torch/bench.py on the CPU: bench.py's metric names, units,
rounding and ``vs_baseline`` through a tiny monkeypatched ``build``, the
same refusals, the flags against bench.py's own, the full-width inputs
``build`` makes, the loader mode, and no fallback to the CPU."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lss_carla_torch import bench
from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step

REPO = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline"}


def tiny_build(bsz, splat_method="scatter", dtype="float32", variant="b0",
               fused_dw=False, device="cuda", accum=1, remat=False):
    """``bench.build``'s contract at the tests' tiny config."""
    grid = GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                    dbound=(4.0, 36.0, 8.0))
    model = compile_model(grid, DataAugConf(H=64, W=128, final_dim=(32, 64)),
                          variant="slim" if variant == "b0" else variant,
                          compute_dtype=dtype, fused_dw=fused_dw, remat=remat,
                          device=device)
    gen = torch.Generator().manual_seed(0)
    intrins = torch.tensor([[60.0, 0, 32], [0, 60, 16], [0, 0, 1]])
    eye = torch.eye(3).repeat(bsz, 6, 1, 1)
    batch = (torch.randn(bsz, 6, 3, 32, 64, generator=gen), eye,
             torch.zeros(bsz, 6, 3), intrins.repeat(bsz, 6, 1, 1), eye.clone(),
             torch.zeros(bsz, 6, 3),
             (torch.rand(bsz, 1, 16, 16, generator=gen) < 0.1).float())
    if accum > 1:
        batch = tuple(x.expand(accum, *x.shape) for x in batch)
    return (make_train_step(model, 2.13, accum_steps=accum, device=device),
            create_train_state(model), batch)


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's workers share the cores; these tiny models need one
    intra-op thread each (a full-width pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def run(monkeypatch, capsys):
    monkeypatch.setattr(bench, "build", tiny_build)

    def _run(*argv):
        assert bench.main(["--device", "cpu", "--bsz", "2", "--iters", "1",
                           "--warmup", "1", *argv]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("bench settings: ")
        settings = json.loads(lines[0][len("bench settings: "):])
        metrics = [json.loads(ln) for ln in lines if ln.startswith("{")]
        info = [ln for ln in lines if ln.startswith("bench: ")]
        return settings, metrics, info

    return _run


def _check(line, name, unit="ms", baseline=None):
    assert set(line) == KEYS and line["metric"] == name and line["unit"] == unit
    v = line["value"]
    assert v > 0 and round(v, 3) == v
    if baseline is not None:
        # value = round(ms, 3) and vs_baseline = round(baseline / ms, 3) of
        # the unrounded ms (bench.py's lines). With |ms - value| <= 5e-4:
        # |vs_baseline - baseline / value|
        #   <= |vs_baseline - baseline / ms| + |baseline / ms - baseline / value|
        #   <= 5e-4 + baseline * |value - ms| / (ms * value)
        #   <= 5e-4 + baseline * 5e-4 / (value * (value - 5e-4)),
        # ~ 5e-4 + baseline * 5e-4 / value**2; plus float rounding
        ratio = baseline / v
        bound = 5e-4 + baseline * 5e-4 / (v * (v - 5e-4))
        assert abs(line["vs_baseline"] - ratio) <= bound + 1e-9 * ratio


def test_mode_all_prints_bench_py_lines(run):
    settings, metrics, info = run()
    assert set(settings) == {"cudnn_allow_tf32", "matmul_allow_tf32", "torch",
                             "cuda", "device", "card"}
    assert settings["card"] == settings["device"] == "cpu"
    assert [m["metric"] for m in metrics] == [
        "train_step_ms_bsz2", "inference_ms_per_sample_bsz2",
        "train_step_ms_bsz2_bfloat16"]
    _check(metrics[0], "train_step_ms_bsz2", baseline=bench.BASELINE_STEP_MS)
    _check(metrics[1], "inference_ms_per_sample_bsz2", baseline=100.0)
    _check(metrics[2], "train_step_ms_bsz2_bfloat16",
           baseline=bench.BASELINE_STEP_MS)
    assert len(info) == 3 and "imgs (2, 6, 3, 32, 64) float32" in info[0]
    assert "bfloat16" in info[1] and "bfloat16" in info[2]
    windows = re.findall(r"\[([^\]]+)\]$", info[0])[0].split(", ")
    assert len(windows) == 3


@pytest.mark.parametrize("argv,name,baseline", [
    (("--mode", "step", "--dtype", "float32", "--accum", "2", "--fused_dw"),
     "train_step_ms_bsz2_accum2_fused_dw", 2 * bench.BASELINE_STEP_MS),
    (("--mode", "step", "--dtype", "bfloat16", "--variant", "resnet18"),
     "train_step_ms_bsz2_bfloat16_resnet18", bench.BASELINE_STEP_MS),
    (("--mode", "infer", "--quantize", "--quant_min_channels", "8"),
     "inference_ms_per_sample_bsz2_int8", 100.0),
    (("--mode", "infer", "--dtype", "float32", "--variant", "resnet18"),
     "inference_ms_per_sample_bsz2_resnet18", 100.0),
])
def test_single_modes_name_their_options(run, argv, name, baseline):
    _, metrics, info = run(*argv)
    assert len(metrics) == 1
    _check(metrics[0], name, baseline=baseline)
    if "--accum" in argv:
        assert "imgs (2, 2, 6, 3, 32, 64)" in info[0]
    if "--quantize" in argv:
        assert "int8 convs" in info[0]


@pytest.mark.parametrize("argv,message", [
    (("--dtype", "float32"), "always emits both dtypes"),
    (("--variant", "b4"), "--variant only applies"),
    (("--mode", "input", "--variant", "resnet18"), "--variant only applies"),
    (("--mode", "step", "--quantize"), "--quantize only applies"),
    (("--mode", "infer", "--accum", "2"), "--accum only applies"),
    (("--mode", "infer", "--fused_dw"), "--fused_dw only applies"),
])
def test_refuses_what_bench_py_refuses(capsys, argv, message):
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_remat_step_keeps_its_metric_name(run):
    """``--remat`` reaches ``compile_model(remat=True)`` and, as in
    ``bench.py``, keeps the metric's name."""
    _, metrics, info = run("--mode", "step", "--remat")
    assert [m["metric"] for m in metrics] == ["train_step_ms_bsz2_bfloat16"]
    _check(metrics[0], "train_step_ms_bsz2_bfloat16",
           baseline=bench.BASELINE_STEP_MS)
    assert len(info) == 1 and ", remat," in info[0]


def test_flags_are_bench_py_s_less_compiler_option():
    """Every flag of bench.py but ``--compiler_option`` (XLA), plus
    ``--device``; the same baseline."""
    import bench as jax_bench  # the root script; it imports JAX lazily
    out = subprocess.run([sys.executable, "bench.py", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    theirs = set(re.findall(r"--[a-z_]+", out.stdout)) - {"--help"}
    ours = {o for a in bench.build_parser()._actions for o in a.option_strings
            if o.startswith("--")} - {"--help"}
    assert ours == theirs - {"--compiler_option"} | {"--device"}
    assert bench.BASELINE_STEP_MS == jax_bench.BASELINE_STEP_MS


def test_build_makes_bench_py_s_inputs():
    """bsz 1 at full width on the CPU: B0, 6 x 128 x 352 cameras, a 200 x
    200 grid with D 41, seeded as bench.py seeds its inputs."""
    step, state, batch = bench.build(1, device="cpu")
    shapes = [tuple(x.shape) for x in batch]
    assert shapes == [(1, 6, 3, 128, 352), (1, 6, 3, 3), (1, 6, 3),
                      (1, 6, 3, 3), (1, 6, 3, 3), (1, 6, 3), (1, 1, 200, 200)]
    model = state.model
    assert model.variant == "b0" and model.D == 41
    assert tuple(int(n) for n in model.nx) == (200, 200, 1)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        batch[0].numpy(), rng.normal(size=(1, 6, 3, 128, 352)).astype(np.float32))
    assert float(batch[3][0, 0, 0, 0]) == 200.0 and float(batch[3][0, 0, 0, 2]) == 176.0


def test_input_mode_reads_the_loader(capsys):
    assert bench.main(["--device", "cpu", "--mode", "input", "--bsz", "4",
                       "--iters", "5"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["metric"] == "input_pipeline_images_per_sec"
    assert line["unit"] == "img/s" and line["vs_baseline"] is None
    assert line["value"] > 0


def test_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main(["--mode", "step"])
