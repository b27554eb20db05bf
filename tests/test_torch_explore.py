"""The port's explore tools (``lss_carla_torch/explore.py``) on the CPU:
``eval_model_iou`` on a port checkpoint against the JAX package's
``get_val_info(make_eval_step(...))`` with the same converted weights on
the same fixture val set (loss 1e-4 relative, IoU +-1e-3: both sum the
same f32 model in other orders); checkpoint selection by ``best`` and
``use_ema``; the PNGs of ``viz_model_preds`` and ``lidar_check``;
``splat_check``'s two sides; the CLI's flags, its four commands on a CPU
fixture, and the nuScenes and int8 flags (the nuScenes modes against JAX
are in test_torch_nuscenes.py and test_torch_nusc_maps.py)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.configs import DataAugConf as JAug
from lss_carla_tpu.configs import GridConf as JGrid
from lss_carla_tpu.data import loader as JLd
from lss_carla_tpu.data import simbev as JS
from lss_carla_tpu.models.lss import compile_model as jax_compile_model
from lss_carla_tpu.training import state as JState
from lss_carla_tpu.training.loop import get_val_info as jax_get_val_info
from lss_carla_tpu.training.step import make_eval_step as jax_make_eval_step

from lss_carla_torch import explore
from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.data.fixtures_nuscenes import generate_nuscenes_fixture
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.training.loop import get_val_info
from lss_carla_torch.training.step import make_eval_step
from lss_carla_torch.utils.checkpoint import CheckpointManager
from lss_carla_torch.utils.convert import jax_variables_to_state_dict

from test_torch_variants import random_variables

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL, IOU_ATOL = 1e-4, 1e-3
GRID = dict(xbound=(-50.0, 50.0, 6.25), ybound=(-50.0, 50.0, 6.25),
            dbound=(4.0, 36.0, 8.0))
AUG = dict(H=64, W=128, final_dim=(32, 64))
# the tools' keywords for that config
KW = dict(grid_conf=GridConf(**GRID), **AUG, device="cpu", nworkers=0)


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's workers share the cores; these tiny models need one
    intra-op thread each (a full-width pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    # 5 scenes x 3: 3 val samples, so bsz 2 pads the last val batch
    return generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                            samples_per_scene=3, H=64, W=128, grid=16, seed=5)


def _save(directory, model, ema=None, best=True, counter=3):
    """A port checkpoint of ``model`` (and an EMA) the way train() writes
    it: model_best.pt, or a numbered one."""
    mgr = CheckpointManager(directory)
    opt = torch.optim.Adam(model.parameters())
    if best:
        return mgr.save_best(counter, model, opt, 0, 0.25, ema_model=ema)
    return mgr.save(counter, model, opt, 0, ema_model=ema)


def _port_model(variant="slim", seed=0):
    return compile_model(GridConf(**GRID), DataAugConf(**AUG), variant=variant,
                         device="cpu", generator=torch.Generator().manual_seed(seed))


def test_eval_model_iou_matches_jax_get_val_info(fixture_root, tmp_path):
    """Random JAX variables (randomised BN stats), converted into a port
    checkpoint: the port tool's loss and IoU over the whole val set equal
    the JAX package's get_val_info over its own loader of the same
    fixture, both decoding with the native decoder (their defaults; the
    two libraries give the same pixels)."""
    rng = np.random.default_rng(50)
    jm = jax_compile_model(JGrid(**GRID), JAug(**AUG), outC=1, variant="slim")
    B, N = 1, 6
    sample = (jnp.zeros((B, N, 3, 32, 64)), jnp.tile(jnp.eye(3), (B, N, 1, 1)),
              jnp.zeros((B, N, 3)), jnp.tile(jnp.eye(3), (B, N, 1, 1)),
              jnp.tile(jnp.eye(3), (B, N, 1, 1)), jnp.zeros((B, N, 3)))
    variables = random_variables(jm, sample, rng)
    jds = JS.SegmentationData(fixture_root, False, JAug(**AUG), JGrid(**GRID),
                              use_native=True)
    assert jds._native
    valloader = JLd.DataLoader(jds, 2, pad_last=True, num_workers=0)
    # centre the head's bias on the first batch's logits, so that about
    # half the cells predict a vehicle and the IoU is not trivially 0
    first = next(iter(valloader))
    logits = jax.jit(jm.apply, static_argnames="train")(
        variables, *map(jnp.asarray, first[:6]), train=False)
    head = variables["params"]["bevencode"]["head"]
    head["bias"] = head["bias"] - np.float32(np.median(np.asarray(logits)))
    jstate = JState.TrainState.create(
        apply_fn=jm.apply, params=variables["params"], tx=optax.identity(),
        batch_stats=variables["batch_stats"])
    want = jax_get_val_info(jax_make_eval_step(jm, pos_weight=2.13), jstate,
                            valloader)

    port = _port_model()
    port.load_state_dict(jax_variables_to_state_dict(variables, "slim"))
    _save(tmp_path / "ckpts", port)
    got = explore.eval_model_iou(fixture_root, str(tmp_path / "ckpts"),
                                 best=True, variant="slim", bsz=2, **KW)
    assert set(got) == set(want) == {"loss", "iou"}
    assert want["iou"] > 0  # the random model predicts some vehicles
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert abs(got["iou"] - want["iou"]) <= IOU_ATOL, (got, want)


def test_checkpoint_selection_best_and_ema(fixture_root, tmp_path, capsys):
    """A directory means its newest numbered checkpoint, ``best`` its
    model_best.pt, ``use_ema`` that file's ema_state_dict; a checkpoint
    without one evaluates its raw weights and says so. Each selection
    evaluates to what the selected model scores itself."""
    raw, ema, newest = (_port_model(seed=s) for s in (1, 2, 3))
    ckpts = tmp_path / "ckpts"
    _save(ckpts, raw, ema=ema, best=True, counter=3)
    _save(ckpts, newest, best=False, counter=4)

    def scored(model):
        _, valloader = explore._build(fixture_root, bsz=2, variant="slim",
                                      **KW)[1:3]
        return get_val_info(make_eval_step(model.eval(), device="cpu"), None,
                            valloader, "cpu")

    for sel, model in (({}, newest), ({"best": True}, raw),
                       ({"best": True, "use_ema": True}, ema)):
        got = explore.eval_model_iou(fixture_root, str(ckpts), variant="slim",
                                     bsz=2, **sel, **KW)
        assert got == scored(model), sel
    capsys.readouterr()
    got = explore.eval_model_iou(fixture_root, str(ckpts / "model_000004.pt"),
                                 use_ema=True, variant="slim", bsz=2, **KW)
    assert "no EMA weights" in capsys.readouterr().out
    assert got == scored(newest)
    with pytest.raises(ValueError, match="directory"):
        explore.load_weights(str(ckpts / "model_000004.pt"), best=True)


def test_viz_model_preds_and_lidar_check_write_their_pngs(fixture_root, tmp_path):
    """One PNG per non-padded val sample (3 samples in 2 batches of 2; the
    pad duplicate is skipped), and lidar_check's one PNG; the compute parts
    give the predictions and frustum points behind them."""
    _save(tmp_path / "ckpts", _port_model())
    kw = dict(checkpoint=str(tmp_path / "ckpts"), best=True, variant="slim",
              bsz=2, **KW)
    samples, extent = explore.model_preds(fixture_root, max_batches=2, **kw)
    assert len(samples) == 3 and extent == (-50.0, 50.0, -50.0, 50.0)
    for imgs, gt, pred in samples:
        assert imgs.shape == (6, 3, 32, 64) and gt.shape == pred.shape == (16, 16)
        assert np.isfinite(pred).all() and 0 <= pred.min() <= pred.max() <= 1
    out = tmp_path / "viz"
    assert explore.viz_model_preds(fixture_root, outdir=str(out),
                                   max_batches=2, **kw) == 3
    assert sorted(p.name for p in out.iterdir()) == [
        "eval000000.png", "eval000001.png", "eval000002.png"]
    geom = explore.frustum_points(fixture_root, H=64, W=128, device="cpu")
    assert geom.shape == (6, 41, 8, 22, 3) and np.isfinite(geom).all()
    path = explore.lidar_check(fixture_root, outdir=str(tmp_path / "lc"),
                               H=64, W=128, device="cpu")
    assert Path(path).name == "lidar_check.png" and Path(path).stat().st_size > 0


@pytest.mark.parametrize("with_data", [True, False])
def test_splat_check_returns_both_sides(fixture_root, tmp_path, with_data):
    """On CPU tensors both sides run the plain splat, so they agree bit for
    bit: the same lift, ids, decode and loss reach both; the depthnet
    gradient comes back through each side's backward (the gather). With
    data, the model is a checkpoint's, as ``_build`` restores it."""
    kw = {"device": "cpu"}
    if with_data:
        _save(tmp_path / "ckpts", _port_model(seed=7))
        kw = dict(KW, dataroot=fixture_root, checkpoint=str(tmp_path / "ckpts"),
                  best=True)
    res = explore.splat_check(bsz=2, variant="slim", **kw)
    assert torch.backends.cudnn.deterministic is False  # restored
    assert set(res) == {"kernel", "plain"}
    a, b = res["kernel"], res["plain"]
    assert a["logits"].shape == ((2, 1, 16, 16) if with_data else (2, 1, 64, 64))
    torch.testing.assert_close(a["logits"], b["logits"], rtol=0, atol=0)
    torch.testing.assert_close(a["grad"], b["grad"], rtol=0, atol=0)
    assert a["loss"] == b["loss"] and np.isfinite(a["loss"])
    assert float(a["grad"].abs().max()) > 0


def test_cli_parses_the_jax_flags_and_refuses_what_waits(fixture_root, tmp_path,
                                                         monkeypatch):
    """The JAX CLI's flags parse for every command; --dataset nuscenes,
    --version and --map_folder are ported (lidar_check runs on a nuScenes
    fixture; eval and viz reach its loader and then the missing
    checkpoint); multiclass flags with nuScenes and the map underlay on
    SimBEV raise ValueError; --quantize is ported, so it goes on to read
    the (missing) checkpoint."""
    p = explore.build_parser()
    a = p.parse_args(["eval_model_iou", "--dataroot", "d", "--checkpoint", "c",
                      "--best", "--ema", "--bsz", "3", "--variant", "resnet34",
                      "--H", "900", "--W", "1600", "--dataset", "nuscenes",
                      "--version", "v1.0-trainval", "--quantize", "--xbound",
                      "-50", "50", "0.25", "--ybound", "-50", "50", "0.25",
                      "--label_mode", "multiclass", "--label_classes", "0",
                      "1"])
    assert (a.best, a.ema, a.bsz, a.variant, a.quantize, a.label_classes) == \
        (True, True, 3, "resnet34", True, [0, 1])
    a = p.parse_args(["viz_model_preds", "--map_folder", "m"])
    assert a.map_folder == "m" and a.dataset == "simbev"
    for cmd in ("splat_check", "lidar_check"):
        assert p.parse_args([cmd, "--bsz", "2"]).cmd == cmd
    base = ["--dataroot", str(fixture_root), "--device", "cpu", "--H", "64",
            "--W", "128", "--checkpoint", "c"]
    with pytest.raises(SystemExit):  # eval_model_iou takes a checkpoint
        explore.main(["eval_model_iou", *base[:-2]])
    nusc = generate_nuscenes_fixture(tmp_path / "nusc", num_scenes=2,
                                     samples_per_scene=1, H=112, W=240)
    nbase = ["--dataroot", str(nusc), "--device", "cpu", "--H", "112", "--W",
             "240", "--checkpoint", "c", "--dataset", "nuscenes"]
    with pytest.raises(FileNotFoundError, match="c"):
        explore.main(["eval_model_iou", *nbase])
    with pytest.raises(ValueError, match="vehicle_binary"):
        explore.main(["eval_model_iou", *nbase, "--label_mode", "multiclass"])
    with pytest.raises(FileNotFoundError, match="tables not found: .*v1.0-trainval"):
        explore.main(["eval_model_iou", *nbase, "--version", "v1.0-trainval"])
    with pytest.raises(FileNotFoundError, match="c"):
        explore.main(["viz_model_preds", *nbase, "--map_folder", str(nusc)])
    with pytest.raises(ValueError, match="needs dataset='nuscenes'"):
        explore.main(["viz_model_preds", *base, "--map_folder", "m"])
    monkeypatch.chdir(tmp_path)
    paths = explore.main(["lidar_check", *nbase[:-4], "--dataset", "nuscenes"])
    assert [Path(p).name for p in paths] == ["lcheck00000.png"]
    with pytest.raises(FileNotFoundError):
        explore.main(["eval_model_iou", *base, "--quantize"])


def test_cli_splat_check_takes_a_checkpoint(monkeypatch):
    """As the JAX CLI: splat_check restores --checkpoint (a file, or a
    directory's newest) and drops --best and --ema."""
    seen = {}
    monkeypatch.setattr(explore, "splat_check", lambda **kw: seen.update(kw))
    explore.main(["splat_check", "--dataroot", "d", "--checkpoint", "c",
                  "--best", "--ema", "--device", "cpu"])
    assert seen == {"bsz": 2, "dataroot": "d", "checkpoint": "c",
                    "device": "cpu", "variant": "b0",
                    "compute_dtype": "float32"}


def test_cli_runs_every_command_on_a_cpu_fixture(fixture_root, tmp_path,
                                                 monkeypatch):
    """``python -m lss_carla_torch.explore <cmd>`` for the four commands,
    a resnet18 checkpoint at the CLI's default final_dim (128 x 352) on
    the 16 x 16 fixture grid."""
    grid = GridConf(xbound=(-50.0, 50.0, 6.25), ybound=(-50.0, 50.0, 6.25))
    model = compile_model(grid, DataAugConf(H=64, W=128), variant="resnet18",
                          device="cpu")
    _save(tmp_path / "ckpts", model)
    monkeypatch.chdir(tmp_path)
    base = ["--dataroot", str(fixture_root), "--device", "cpu", "--H", "64",
            "--W", "128", "--variant", "resnet18"]
    grid_flags = ["--xbound", "-50", "50", "6.25", "--ybound", "-50", "50", "6.25"]
    ck = ["--checkpoint", str(tmp_path / "ckpts"), "--best"]
    info = explore.main(["eval_model_iou", *base, *grid_flags, *ck])
    assert set(info) == {"loss", "iou"} and np.isfinite(info["loss"])
    assert explore.main(["viz_model_preds", *base, *grid_flags, *ck,
                         "--bsz", "2"]) == 3
    assert len(list((tmp_path / "viz_outputs").glob("eval*.png"))) == 3
    res = explore.main(["splat_check", "--device", "cpu", "--variant",
                        "resnet18"])
    assert res["kernel"]["loss"] == res["plain"]["loss"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run(
        [sys.executable, "-m", "lss_carla_torch.explore", "lidar_check",
         "--dataroot", str(fixture_root), "--device", "cpu", "--H", "64",
         "--W", "128"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("lidar_check.png")
    assert (tmp_path / "viz_outputs" / "lidar_check.png").exists()
