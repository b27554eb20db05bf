"""The port's nuScenes data path (``data/nuscenes.py``,
``data/fixtures_nuscenes.py``), its trainer and tools, against the JAX
package on the CPU, on tiny fixtures (112 x 240 sources, as
``tests/test_nuscenes.py``).

Tolerances: the fixture generator writes the same bytes; items are
compared with the augmentation fixed on both sides (the JAX dataset draws
from the global ``np.random``, the port's from its ``torch.Generator``):
images exact (the same C++ decoder or the same PIL calls), geometry 1e-6,
labels exact; lidar 1e-5; a step's loss 1e-4 relative and gradients as
``tests/test_torch_training.py`` holds them; ``eval_model_iou`` with
``test_torch_explore.py``'s ``LOSS_RTOL`` and ``IOU_ATOL``."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.configs import DataAugConf as JAug
from lss_carla_tpu.configs import GridConf as JGrid
from lss_carla_tpu.data import fixtures_nuscenes as JF
from lss_carla_tpu.data import nuscenes as JN
from lss_carla_tpu.models.lss import compile_model as jax_compile_model
from lss_carla_tpu.training import loss as JLoss
from lss_carla_tpu.training import state as JState
from lss_carla_tpu.training.loop import get_val_info as jax_get_val_info
from lss_carla_tpu.training.step import make_eval_step as jax_make_eval_step

from lss_carla_torch import explore, train_nuscenes
from lss_carla_torch.configs import DataAugConf, GridConf, nuscenes_aug
from lss_carla_torch.data import fixtures_nuscenes as F
from lss_carla_torch.data import nuscenes as N
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.training.loop import train
from lss_carla_torch.training.loss import bce_with_logits
from lss_carla_torch.utils.checkpoint import CheckpointManager
from lss_carla_torch.utils.convert import (jax_variables_to_state_dict,
                                           name_map, variables_to_state_dict)

from test_torch_explore import IOU_ATOL, LOSS_RTOL
from test_torch_variants import random_variables

REPO = Path(__file__).resolve().parent.parent
SRC = dict(H=112, W=240)
GRID = dict(xbound=(-50.0, 50.0, 6.25), ybound=(-50.0, 50.0, 6.25),
            dbound=(4.0, 36.0, 8.0))
# the original config's augmentation at the fixture's size
TRAIN_AUG = dict(SRC, final_dim=(32, 64), resize_lim=(0.3, 0.4),
                 bot_pct_lim=(0.0, 0.22), rot_lim=(-5.4, 5.4), rand_flip=True,
                 Ncams=5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    # 3 scenes x 3 samples: 6 train (2 scenes), 3 val
    return F.generate_nuscenes_fixture(tmp_path_factory.mktemp("nusc"),
                                       num_scenes=3, samples_per_scene=3,
                                       **SRC, seed=4)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def test_fixture_matches_jax_generator(tmp_path):
    """The same files, byte for byte: tables (JSON), camera JPEGs, lidar
    sweeps and the map expansion."""
    kw = dict(num_scenes=2, samples_per_scene=2, **SRC, seed=3)
    a = JF.generate_nuscenes_fixture(tmp_path / "jax", **kw)
    b = F.generate_nuscenes_fixture(tmp_path / "port", **kw)
    files = _files(a)
    assert files == _files(b)
    assert {Path(f).suffix for f in files} == {".json", ".jpg", ".bin"}
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_quaternions_and_poses_match_jax():
    rng = np.random.default_rng(60)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(N.quat_to_rot(q), JN.quat_to_rot(q))
        R = N.quat_to_rot(q)
        assert F.rot_to_quat(R) == JF.rot_to_quat(R)
        np.testing.assert_allclose(N.quat_to_rot(F.rot_to_quat(R)), R,
                                   atol=1e-8)
        t = rng.normal(size=3)
        for inverse in (False, True):
            np.testing.assert_array_equal(N._pose_matrix(t, q, inverse),
                                          JN._pose_matrix(t, q, inverse))
    assert F._yaw_quat(0.3) == JF._yaw_quat(0.3)


def test_tables_index_like_jax(nusc_root):
    t, j = N.NuScenesTables(nusc_root), JN.NuScenesTables(nusc_root)
    assert t.cam_data == j.cam_data and t.anns == j.anns
    assert t.sample_data_by_token == j.sample_data_by_token
    assert t.scene2map() == j.scene2map() == {
        f"scene_{s:04d}": "boston-seaport" for s in range(3)}
    names = [t.category_name(a) for a in t.sample_annotation]
    assert names == [j.category_name(a) for a in j.sample_annotation]
    assert {"vehicle.car", "human.pedestrian.adult"} == set(names)
    with pytest.raises(FileNotFoundError, match="tables not found"):
        N.NuScenesTables(nusc_root, version="v1.0-trainval")


def _items(nusc_root, is_train, use_native, device_normalize, monkeypatch):
    """(port item, JAX item) pairs of every sample, with the port's draws
    handed to the JAX dataset: as drawn (train: a rotation, so PIL on both
    sides) and with the rotation set to 0 (the decoder's path)."""
    conf = TRAIN_AUG if is_train else dict(SRC, final_dim=(32, 64))
    tds = N.NuScenesDataset(nusc_root, is_train, DataAugConf(**conf),
                            GridConf(), use_native=use_native,
                            device_normalize=device_normalize, seed=2)
    jds = JN.NuScenesDataset(nusc_root, is_train, JAug(**conf), JGrid(),
                             device_normalize=device_normalize)
    jds._decoder.available = use_native and jds._decoder.available
    assert jds._decoder.available == use_native
    pairs = []
    for index, tok in enumerate(tds.samples):
        assert jds.samples[index] == tok
        cams, drawn = tds.draw()
        for aug in (drawn, drawn[:4] + (0.0,)):
            monkeypatch.setattr(JN, "sample_augmentation", lambda *a: aug)
            pairs.append(((*tds.get_image_data(tok, cams, aug),
                           tds.get_binimg(tok)),
                          (*jds.get_image_data(tok, cams), jds.get_binimg(tok)),
                          cams))
    return tds, pairs


@pytest.mark.parametrize("is_train,use_native,device_normalize",
                         [(True, True, True), (True, False, False),
                          (False, True, False), (False, False, True)])
def test_items_match_jax(nusc_root, monkeypatch, is_train, use_native,
                         device_normalize):
    tds, pairs = _items(nusc_root, is_train, use_native, device_normalize,
                        monkeypatch)
    for got, want, cams in pairs:
        assert got[0].shape[0] == len(cams) == (5 if is_train else 6)
        assert got[0].dtype == want[0].dtype == (
            np.uint8 if device_normalize else np.float32)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:6], want[1:6]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[6], want[6])
        assert got[6].shape == (1, 200, 200) and 0 < got[6].mean() < 0.2
    stats = tds.decoder.stats
    if not use_native:
        assert set(stats) == {"pil_off"}
    elif is_train:  # half the draws rotate
        assert stats["pil_rotate"] == stats["native_resize"] > 0
    else:
        assert set(stats) == {"native_resize"}


def test_item_contract_and_draws(nusc_root):
    """Items of the 7-tuple contract; train draws 5 of the 6 cameras from
    the dataset's generator (the same seed, the same draws), validation
    takes all 6 without drawing."""
    conf = DataAugConf(**TRAIN_AUG)
    a = N.NuScenesDataset(nusc_root, True, conf, GridConf(), seed=5)
    b = N.NuScenesDataset(nusc_root, True, conf, GridConf(), seed=5)
    draws = [a.draw() for _ in range(4)]
    assert draws == [b.draw() for _ in range(4)]
    assert all(len(c) == 5 and c == sorted(c, key=N.NUSC_CAMERA_ORDER.index)
               for c, _ in draws)
    assert len({tuple(c) for c, _ in draws}) > 1
    item = a[0]
    assert len(item) == 7 and item[0].shape == (5, 3, 32, 64)
    va = N.NuScenesDataset(nusc_root, False, conf, GridConf())
    assert va.draw()[0] == N.NUSC_CAMERA_ORDER and len(va) == 3 and len(a) == 6
    assert str(va) == "NuScenesDataset (val): 3 samples"


def test_nonvehicle_category_excluded(nusc_root):
    conf = DataAugConf(**SRC, final_dim=(32, 64))
    veh = N.NuScenesDataset(nusc_root, True, conf, GridConf())
    everything = N.NuScenesDataset(nusc_root, True, conf, GridConf(),
                                   label_category_prefix="")
    jall = JN.NuScenesDataset(nusc_root, True, JAug(**SRC, final_dim=(32, 64)),
                              JGrid(), label_category_prefix="")
    for tok in veh.samples:
        assert everything.get_binimg(tok).sum() > veh.get_binimg(tok).sum()
        np.testing.assert_array_equal(everything.get_binimg(tok),
                                      jall.get_binimg(tok))


@pytest.mark.parametrize("nsweeps,min_distance", [(1, 2.2), (3, 2.2), (1, 20.0)])
def test_get_lidar_data_matches_jax(nusc_root, nsweeps, min_distance):
    t, j = N.NuScenesTables(nusc_root), JN.NuScenesTables(nusc_root)
    for tok in list(t.cam_data)[:3]:
        got = N.get_lidar_data(t, nusc_root, tok, nsweeps, min_distance)
        want = JN.get_lidar_data(j, nusc_root, tok, nsweeps, min_distance)
        assert got.shape == want.shape == (
            5, 0 if min_distance > 15 else 48 * min(nsweeps, 2))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bsz", [2, 4])
def test_compile_data_nuscenes_batches_and_val_mask(nusc_root, bsz):
    """The train loader drops the ragged tail (6 samples), the val loader
    pads its last batch and masks the padding (3 samples); batch counts
    equal the JAX loaders'."""
    conf = DataAugConf(**TRAIN_AUG)
    tr, va = N.compile_data_nuscenes("v1.0-mini", nusc_root, conf, GridConf(),
                                     bsz=bsz, nworkers=2, device_normalize=True)
    jtr, jva = JN.compile_data_nuscenes("v1.0-mini", nusc_root,
                                        JAug(**TRAIN_AUG), JGrid(), bsz=bsz,
                                        nworkers=0)
    assert (len(tr), len(va)) == (len(jtr), len(jva)) == (6 // bsz, -(-3 // bsz))
    train_batches = list(tr)
    assert len(train_batches) == 6 // bsz
    for b in train_batches:
        assert len(b) == 7 and b[0].shape == (bsz, 5, 3, 32, 64)
        assert b[0].dtype == np.uint8 and b[6].shape == (bsz, 1, 200, 200)
    val_batches = list(va)
    masks = [b[7] for b in val_batches]
    assert all(len(b) == 8 for b in val_batches)
    np.testing.assert_array_equal(np.concatenate(masks),
                                  [1, 1, 1] + [0] * (len(va) * bsz - 3))
    assert va.dataset.decoder.stats == {"native_resize": 6 * len(va) * bsz}


def test_compile_data_nuscenes_shards_match_jax(nusc_root):
    """Two data shards (bsz 1 each): batch counts and the val loaders'
    indices and masks equal the JAX loaders' shards; shard k's train
    dataset draws from seed + k, over one global shuffle."""
    conf = DataAugConf(**TRAIN_AUG)
    for k in (0, 1):
        tr, va = N.compile_data_nuscenes(
            "v1.0-mini", nusc_root, conf, GridConf(), bsz=1, nworkers=0,
            seed=7, shard_index=k, num_shards=2)
        jtr, jva = JN.compile_data_nuscenes(
            "v1.0-mini", nusc_root, JAug(**TRAIN_AUG), JGrid(), bsz=1,
            nworkers=0, shard_index=k, num_shards=2)
        assert (len(tr), len(va)) == (len(jtr), len(jva)) == (3, 2)
        for (gi, gv), (wi, wv) in zip(va._batch_indices(), jva._batch_indices()):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gv, wv)
        assert (tr.shard_index, tr.num_shards, tr._seed) == (k, 2, 7)
        assert torch.equal(tr.dataset.generator.get_state(),
                           torch.Generator().manual_seed(7 + k).get_state())


def test_loss_and_gradients_on_a_nuscenes_batch_match_jax(nusc_root):
    """The loss and gradients of one step of a slim LSS (tiny grid) with
    converted random weights on the same 5-camera nuScenes batch (the
    port's items, which equal the JAX dataset's: above), in eval mode as
    ``tests/test_torch_training.py`` holds them: the loss within 1e-4
    relative, each gradient within 1e-2 relative plus 1e-3 of the largest.
    (In train mode the fixture's flat-coloured images leave BN batch
    variances near 0, whose rounding the normalisation magnifies.)"""
    conf = DataAugConf(**TRAIN_AUG)
    ds = N.NuScenesDataset(nusc_root, True, conf, GridConf(**GRID), seed=8)
    items = [ds[i] for i in range(2)]
    batch = tuple(np.stack(parts) for parts in zip(*items))
    assert batch[0].shape == (2, 5, 3, 32, 64) and batch[6].shape == (2, 1, 16, 16)
    jm = jax_compile_model(JGrid(**GRID), JAug(**TRAIN_AUG), outC=1,
                           variant="slim")
    rng = np.random.default_rng(61)
    args = tuple(map(jnp.asarray, batch[:6]))
    variables = random_variables(jm, args, rng)

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                       *args, train=False)
        return JLoss.bce_with_logits(out, jnp.asarray(batch[6]), 2.13)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    model = compile_model(GridConf(**GRID), conf, variant="slim", device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, "slim"))
    model.eval()
    t = tuple(map(torch.from_numpy, batch))
    loss = bce_with_logits(model(*t[:6]), t[6], 2.13)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.array, jgrads),
         "batch_stats": variables["batch_stats"]}, name_map("slim"))
    params = dict(model.named_parameters())
    gscale = max(np.abs(want[k].numpy()).max() for k in params)
    assert gscale > 0
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-2,
                                   atol=1e-3 * gscale, err_msg=k)


@pytest.fixture(scope="module")
def nusc_run(nusc_root, tmp_path_factory):
    """train(dataset="nuscenes") on the CPU: the slim trunk at the fixture
    size with the original config's augmentation, 2 steps, a validation
    and a checkpoint at step 2."""
    logdir = tmp_path_factory.mktemp("nusc_run")
    aug = {k: v for k, v in TRAIN_AUG.items() if k != "Ncams"}
    result = train(nusc_root, nepochs=2, bsz=2, nworkers=2, ncams=5,
                   variant="slim", max_steps=2, val_step=2, save_step=2,
                   iou_log_step=1, viz_step=0, dataset="nuscenes",
                   logdir=str(logdir), device="cpu", **GRID, **aug)
    return logdir, result


def test_train_takes_two_steps_on_nuscenes(nusc_run):
    logdir, result = nusc_run
    assert result["counter"] == 2 and result["best_val_iou"] is not None
    stats = result["decode_stats"]
    # training rotates every draw (PIL), validation decodes natively
    # (the loader may have decoded a batch ahead of the last step)
    assert set(stats["train"]) == {"pil_rotate"}
    assert stats["train"]["pil_rotate"] >= 2 * 2 * 5
    assert stats["train"]["pil_rotate"] % 5 == 0
    assert set(stats["val"]) == {"native_resize"}
    assert {"model_000002.pt", "model_best.pt", "model_final.pt"} <= {
        p.name for p in (logdir / "ckpts").iterdir()}


def test_train_refuses_what_nuscenes_does_not_take(nusc_root, tmp_path):
    """As the JAX trainer: nuScenes takes only binary vehicle labels and
    no extrinsic noise; an unknown dataset raises too."""
    kw = dict(nepochs=1, bsz=2, nworkers=0, **SRC, final_dim=(32, 64),
              variant="slim", logdir=str(tmp_path), device="cpu", **GRID)
    with pytest.raises(ValueError, match="vehicle_binary"):
        train(nusc_root, dataset="nuscenes", label_mode="multiclass", **kw)
    with pytest.raises(ValueError, match="extrinsic_noise"):
        train(nusc_root, dataset="nuscenes", extrinsic_noise=(1.0, 0.1), **kw)
    with pytest.raises(ValueError, match="unknown dataset"):
        train(nusc_root, dataset="kitti", **kw)


def _logged_val(logdir):
    recs = [json.loads(ln) for ln in open(logdir / "metrics.jsonl")]
    return [r for r in recs if "val/iou" in r][-1]


def test_eval_model_iou_reproduces_the_logged_validation(nusc_root, nusc_run):
    """eval_model_iou on model_best.pt gives what train() logged, exactly
    (one CPU, one order): the tools validate nuScenes on the original
    config's crop (bot_pct_lim 0-0.22, their nuScenes default), whose val
    batches equal the trainer's bit for bit. The JAX tool crops with (0,
    0), other pixels than its trainer validated on (ROADMAP.md §C). (Two
    steps leave the logits near 0, so the loss alone would not tell the
    crops apart; the batches do.)"""
    logdir, _ = nusc_run
    rec = _logged_val(logdir)
    kw = dict(dataset="nuscenes", **SRC, final_dim=(32, 64), bsz=2,
              nworkers=0, variant="slim", grid_conf=GridConf(**GRID),
              device="cpu")
    info = explore.eval_model_iou(nusc_root, str(logdir / "ckpts"), best=True,
                                  **kw)
    assert (info["loss"], info["iou"]) == (rec["val/loss"], rec["val/iou"])
    _, trainer_val = N.compile_data_nuscenes(
        "v1.0-mini", nusc_root, DataAugConf(**TRAIN_AUG), GridConf(**GRID),
        bsz=2, nworkers=0, device_normalize=True)
    kw.pop("variant")
    tool_val = list(explore._build(nusc_root, **kw)[2])
    assert len(tool_val) == len(trainer_val) == 2
    for got, want in zip(tool_val, trainer_val):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    _, jax_crop = N.compile_data_nuscenes(
        "v1.0-mini", nusc_root, DataAugConf(**SRC, final_dim=(32, 64)),
        GridConf(**GRID), bsz=2, nworkers=0, device_normalize=True)
    assert not any(np.array_equal(g[0], w[0])
                   for g, w in zip(jax_crop, trainer_val))


def test_eval_model_iou_matches_jax_get_val_info(nusc_root, tmp_path):
    """Random JAX variables converted into a port checkpoint: the port
    tool over the nuScenes val set equals the JAX package's get_val_info
    over its own nuScenes val loader (both decode natively) at the crop
    the port's tool takes (bot_pct_lim 0-0.22)."""
    rng = np.random.default_rng(62)
    jaug = JAug(**SRC, final_dim=(32, 64), bot_pct_lim=(0.0, 0.22))
    jm = jax_compile_model(JGrid(**GRID), jaug, outC=1, variant="slim")
    sample = (jnp.zeros((1, 6, 3, 32, 64)), jnp.tile(jnp.eye(3), (1, 6, 1, 1)),
              jnp.zeros((1, 6, 3)), jnp.tile(jnp.eye(3), (1, 6, 1, 1)),
              jnp.tile(jnp.eye(3), (1, 6, 1, 1)), jnp.zeros((1, 6, 3)))
    variables = random_variables(jm, sample, rng)
    _, valloader = JN.compile_data_nuscenes("v1.0-mini", nusc_root, jaug,
                                            JGrid(**GRID), bsz=2, nworkers=0)
    assert valloader.dataset._decoder.available
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

    port = compile_model(GridConf(**GRID), DataAugConf(**SRC, final_dim=(32, 64)),
                         variant="slim", device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(variables, "slim"))
    opt = torch.optim.Adam(port.parameters())
    CheckpointManager(tmp_path / "ckpts").save_best(3, port, opt, 0, 0.25)
    got = explore.eval_model_iou(
        nusc_root, str(tmp_path / "ckpts"), best=True, variant="slim", bsz=2,
        dataset="nuscenes", **SRC, final_dim=(32, 64),
        grid_conf=GridConf(**GRID), nworkers=0, device="cpu")
    assert set(got) == set(want) == {"loss", "iou"}
    assert want["iou"] > 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert abs(got["iou"] - want["iou"]) <= IOU_ATOL, (got, want)


def _jax_flags():
    """The flags of the JAX training script: its ``add_argument`` calls."""
    tree = ast.parse((REPO / "scripts" / "train_nuscenes.py").read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"}


def test_cli_parses_the_jax_flags(monkeypatch):
    """Every flag of scripts/train_nuscenes.py parses, with its default;
    the original config goes to train(); the parallel flags raise naming
    their ROADMAP item; --supervise runs this module as its child."""
    p = train_nuscenes.build_parser()
    ours = {a for action in p._actions for a in action.option_strings}
    assert _jax_flags() <= ours
    assert ours - _jax_flags() == {"--device", "-h", "--help"}
    a = p.parse_args(["--dataroot", "d"])
    kw = train_nuscenes.train_kwargs(a)
    aug = nuscenes_aug()
    assert (kw["H"], kw["W"], kw["final_dim"], kw["resize_lim"],
            kw["bot_pct_lim"], kw["rot_lim"], kw["rand_flip"], kw["ncams"]) == \
        (900, 1600, (128, 352), (0.193, 0.225), (0.0, 0.22), (-5.4, 5.4),
         True, 5) == (aug.H, aug.W, aug.final_dim, aug.resize_lim,
                      aug.bot_pct_lim, aug.rot_lim, aug.rand_flip, aug.Ncams)
    assert (kw["dataset"], kw["nuscenes_version"], kw["device_normalize"],
            kw["bsz"], kw["nworkers"], kw["logdir"], kw["device"]) == \
        ("nuscenes", "v1.0-mini", True, 16, 10, "./runs/nuscenes_style", "cuda")
    kw = train_nuscenes.train_kwargs(p.parse_args(
        ["--dataroot", "d", "--simbev_data", "--host_normalize", "--version",
         "v1.0-trainval", "--compute_dtype", "bfloat16", "--ema_decay",
         "0.999", "--lr_schedule", "cosine"]))
    assert (kw["dataset"], kw["device_normalize"], kw["nuscenes_version"],
            kw["compute_dtype"], kw["ema_decay"], kw["lr_schedule"]) == \
        ("simbev", False, "v1.0-trainval", "bfloat16", 0.999, "cosine")
    # the parallel flags reach train(): --n_devices runs data-parallel
    # ranks; --cam_devices cannot split the config's 5 training cameras
    kw = train_nuscenes.train_kwargs(p.parse_args(
        ["--dataroot", "d", "--n_devices", "2", "--cam_devices", "3"]))
    assert (kw["n_devices"], kw["cam_devices"]) == (2, 3)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)  # ranks on the CPU
    for flags, match in ((["--n_devices", "2", "--bsz", "3"],
                          "bsz=3 must be divisible"),
                         (["--n_devices", "2", "--cam_devices", "2"],
                          "ncams=5 must be divisible")):
        with pytest.raises(ValueError, match=match):
            train_nuscenes.main(["--dataroot", "d", "--device", "cpu", *flags])
    seen = {}
    from lss_carla_torch.utils import supervise
    monkeypatch.setattr(supervise, "run_supervised",
                        lambda *a, **k: seen.update(args=a, **k) or 0)
    argv = ["--dataroot", "d", "--supervise", "2", "--watchdog_secs", "5"]
    assert train_nuscenes.main(argv) == 0
    assert seen["args"] == (2, "./runs/nuscenes_style")
    assert seen["command"][1:] == ["-m", "lss_carla_torch.train_nuscenes"]
    assert seen["argv"] == argv
