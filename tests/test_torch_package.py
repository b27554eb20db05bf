"""lss_carla_torch as a package: it imports neither JAX nor the JAX
package, and its entry points run on the GPU unless the caller asks for
the CPU -- without a GPU they raise rather than move to the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lss_carla_torch import serving
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.server import serve
from lss_carla_torch.utils.backend import resolve_device

from test_torch_convert import tiny_confs

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    """Every module of the port, and the imports of chip_smoke.py and the
    other card scripts beside it, in a fresh interpreter: neither jax nor
    flax nor lss_carla_tpu gets loaded."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "lss_carla_torch").rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "for m in ('chip_smoke', 'kernel_compare', 'card_cpu_spread'):\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'flax', 'lss_carla_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert {"lss_carla_torch.ops.splat_cuda", "lss_carla_torch.ops.mbconv_cuda",
            "lss_carla_torch.ops.mbconv", "lss_carla_torch.training.loop",
            "lss_carla_torch.training.bn_recal", "lss_carla_torch.training.state",
            "lss_carla_torch.training.step", "lss_carla_torch.data.simbev",
            "lss_carla_torch.data.loader", "lss_carla_torch.utils.checkpoint",
            "lss_carla_torch.train", "lss_carla_torch.models.resnet",
            "lss_carla_torch.explore", "lss_carla_torch.tools",
            "lss_carla_torch.training.watchdog", "lss_carla_torch.utils.supervise",
            "lss_carla_torch.utils.viz", "lss_carla_torch.ops.quant",
            "lss_carla_torch.bench", "lss_carla_torch.accuracy",
            "lss_carla_torch.native.__init__", "lss_carla_torch.native.fastimage",
            "lss_carla_torch.data.decode", "lss_carla_torch.data.nuscenes",
            "lss_carla_torch.data.nusc_maps",
            "lss_carla_torch.data.fixtures_nuscenes",
            "lss_carla_torch.train_nuscenes", "lss_carla_torch.parallel.__init__",
            "lss_carla_torch.parallel.mesh", "lss_carla_torch.parallel.step",
            "lss_carla_torch.parallel.camera",
            "lss_carla_torch.parallel.dryrun", "lss_carla_torch.parallel.halo",
            "lss_carla_torch.parallel.grid", "lss_carla_torch.ops.library",
            "lss_carla_torch.serving", "lss_carla_torch.server",
            "lss_carla_torch.utils.convert",
            "lss_carla_torch.trunk_probe"} <= set(modules)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_resolve_device_raises_without_gpu(no_gpu, device):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device(device)


def test_resolve_device_takes_cpu_when_asked(no_gpu):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """compile_model, load_predict and serve default to cuda and raise
    with no GPU; with device='cpu' they run. Nothing returns a CPU result
    unless the CPU was asked for."""
    grid, aug = tiny_confs()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        compile_model(grid, aug, variant="slim")
    model = compile_model(grid, aug, variant="slim", device="cpu")
    assert next(model.parameters()).device.type == "cpu"

    path = str(tmp_path / "a.pt")
    serving.export_predict(model, path, bsz=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serving.load_predict(path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve(path, port=0)
    predict = serving.load_predict(path, device="cpu")
    args = serving.example_args(serving.read_signature(path))
    assert predict(*args).device.type == "cpu"


def test_training_entry_points_raise_without_gpu(no_gpu, tmp_path):
    """train(), the training CLI, the trunk probe and the step factories
    default to cuda and raise with no GPU, before reading or writing any
    data."""
    from lss_carla_torch.train import main
    from lss_carla_torch.training.loop import train
    from lss_carla_torch.training.step import (make_eval_step,
                                               make_predict_step,
                                               make_train_step)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train(str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["--dataroot", str(tmp_path / "nowhere")])
    from lss_carla_torch import trunk_probe
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trunk_probe.main(["--workdir", str(tmp_path / "probe")])
    assert not (tmp_path / "probe").exists()  # no fixture written first
    model = torch.nn.Linear(1, 1)
    for build in (make_train_step, make_eval_step, make_predict_step):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            build(model)
        assert callable(build(model, device="cpu"))


def test_explore_tools_and_resnet_raise_without_gpu(no_gpu, tmp_path):
    """The explore tools, the tools.py splat and a ResNet model default to
    cuda and raise with no GPU before reading any data; a ResNet model
    builds on the CPU when asked."""
    from lss_carla_torch import explore, tools
    nowhere = str(tmp_path / "nowhere")
    for call in (lambda: explore.eval_model_iou(nowhere, nowhere),
                 lambda: explore.model_preds(nowhere),
                 lambda: explore.viz_model_preds(nowhere),
                 lambda: explore.splat_check(),
                 lambda: explore.frustum_points(nowhere),
                 lambda: explore.lidar_check(nowhere),
                 lambda: explore.lidar_check(nowhere, dataset="nuscenes"),
                 lambda: explore.lidar_panels(nowhere),
                 lambda: explore.main(["splat_check"])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    grid, aug = tiny_confs()
    for variant in ("resnet18", "resnet34"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            compile_model(grid, aug, variant=variant)
    model = compile_model(grid, aug, variant="resnet18", device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    feats = torch.ones(4, 2)
    assert tools.cumsum_trick(feats, torch.tensor([0, 1, 1, 9]), 3).tolist() == \
        [[1.0, 1.0], [2.0, 2.0], [0.0, 0.0]]


def test_artifact_signature_round_trip(tmp_path):
    grid, aug = tiny_confs()
    model = compile_model(grid, aug, variant="slim", device="cpu")
    path = str(tmp_path / "a.pt")
    serving.export_predict(model, path, bsz=3, uint8_images=True, ncams=5)
    sig = serving.read_signature(path)
    assert sig == {"bsz": 3, "ncams": 5, "final_dim": [32, 64],
                   "img_dtype": "uint8"}
    shapes = [(a.shape, a.dtype) for a in serving.example_args(sig)]
    assert shapes == [((3, 5, 3, 32, 64), np.uint8),
                      ((3, 5, 3, 3), np.float32), ((3, 5, 3), np.float32),
                      ((3, 5, 3, 3), np.float32), ((3, 5, 3, 3), np.float32),
                      ((3, 5, 3), np.float32)]
    torch.save({"format": "something else"}, str(tmp_path / "b.pt"))
    with pytest.raises(ValueError, match="not a"):
        serving.load_predict(str(tmp_path / "b.pt"), device="cpu")


def test_chip_smoke_refuses_to_run_without_gpu():
    """chip_smoke.py exits non-zero and prints no result line without a
    GPU (this machine has none: the fixture-free check runs it as is)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
