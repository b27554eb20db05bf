"""The port's training slice against the JAX package, on the CPU: loss and
metrics, the optimizer against the optax chain, eval-mode loss and
gradients of a tiny LSS, the fixture generator, the SimBEV loader, and the
training loop end to end (slim trunk, tiny fixture). Inputs are seeded
numpy arrays handed to both sides; each tolerance is stated where used."""

import json
import os
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.data import fixtures as JF
from lss_carla_tpu.data import loader as JLd
from lss_carla_tpu.data import simbev as JS
from lss_carla_tpu.models.lss import compile_model as jax_compile_model
from lss_carla_tpu.training import loss as JLoss
from lss_carla_tpu.training import state as JState

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data import fixtures as F
from lss_carla_torch.data import simbev as S
from lss_carla_torch.data.loader import DataLoader, prefetch_to_device
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.training import loss as L
from lss_carla_torch.training.loop import train
from lss_carla_torch.training.state import make_lr_schedule, make_optimizer
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils.checkpoint import load_checkpoint
from lss_carla_torch.utils.convert import (jax_variables_to_state_dict, name_map,
                                           reference_state_dict,
                                           variables_to_state_dict)

from test_torch_convert import randomize_variables
from test_torch_lss import rig
from util import tiny_aug, tiny_grid

# --- loss and metrics (f32 on both sides; softplus forms differ by ulps)


@pytest.fixture(scope="module")
def rng():
    """This file's own generator: the session one in conftest.py stays the
    JAX tests' alone, so their draws do not depend on which port files share
    their worker."""
    return np.random.default_rng(0)


def _logits_targets(rng, B=3, C=1):
    logits = (3 * rng.normal(size=(B, C, 8, 8))).astype(np.float32)
    targets = (rng.uniform(size=(B, C, 8, 8)) < 0.3).astype(np.float32)
    return logits, targets


@pytest.mark.parametrize("pos_weight,C", [(2.13, 1), ((1.0, 3.0, 0.5), 3)])
def test_loss_and_metrics_match_jax(rng, pos_weight, C):
    logits, targets = _logits_targets(rng, C=C)
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    jl, jt, jv = map(jnp.asarray, (logits, targets, valid))
    tl, tt, tv = map(torch.from_numpy, (logits, targets, valid))
    np.testing.assert_allclose(L.bce_with_logits(tl, tt, pos_weight).item(),
                               float(JLoss.bce_with_logits(jl, jt, pos_weight)),
                               rtol=1e-6)
    np.testing.assert_allclose(L.SimpleLoss(pos_weight)(tl, tt).item(),
                               float(JLoss.SimpleLoss(pos_weight)(jl, jt)), rtol=1e-6)
    want = JLoss.masked_eval_metrics(jl, jt, jv, pos_weight)
    got = L.masked_eval_metrics(tl, tt, tv, pos_weight)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    assert [float(v) for v in L.get_batch_iou_counts(tl, tt)] == \
        [float(v) for v in JLoss.get_batch_iou_counts(jl, jt)]
    assert L.get_batch_iou(tl, tt) == JLoss.get_batch_iou(jl, jt)


def test_per_class_weight_must_match_the_channels(rng):
    logits, targets = map(torch.from_numpy, _logits_targets(rng, C=2))
    with pytest.raises(ValueError, match="channels"):
        L.bce_with_logits(logits, targets, (1.0, 2.0, 3.0))
    assert L.get_batch_iou(torch.full((1, 1, 2, 2), -1.0),
                           torch.zeros(1, 1, 2, 2)) == (0.0, 0.0, 1.0)


# --- the optimizer against the optax chain


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("constant", 3),
                                             ("cosine", 2), ("linear", 0),
                                             ("linear", 2)])
def test_lr_schedules_match_optax(schedule, warmup):
    want = JState.make_lr_schedule(1e-3, schedule, warmup, 9)
    got = make_lr_schedule(1e-3, schedule, warmup, 9)
    for count in range(13):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))


@pytest.mark.parametrize("schedule,warmup,grad_scale,wd", [
    ("constant", 0, 10.0, 1e-7),   # global norm > 5: the clip triggers
    ("constant", 0, 0.1, 1e-7),    # under 5: untouched
    ("constant", 2, 10.0, 0.05),   # warmup (lr 0 first), visible L2
    ("cosine", 1, 10.0, 1e-7),
    ("linear", 1, 0.1, 0.05),
])
def test_optimizer_matches_optax(rng, schedule, warmup, grad_scale, wd):
    """Three steps of the same gradients into the optax chain and the port's
    optimizer: parameters agree to 1e-6 (Adam's f32 update, ~lr, computed
    in another order) and the pre-clip global norms to 1e-6 relative."""
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = JState.make_optimizer(1e-3, wd, 5.0, schedule, warmup, 10)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tp, 1e-3, wd, 5.0, schedule, warmup, 10)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        norm = opt.step(i)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-6, err_msg=f"step {i}")


# --- a tiny LSS in eval mode: loss and parameter gradients


def test_tiny_lss_eval_loss_and_grads_match_jax(rng):
    """Loss and every parameter gradient of a slim-trunk LSS (eval mode, so
    no dropout) against the JAX model, from one converted variable tree,
    which also loads into the fused_dw model.
    The whole network chains ~60 layers and the splat, so gradients are
    held to 1e-2 relative plus 1e-3 of the largest gradient entry (as
    test_torch_lss holds the logits to 2e-3 / 1e-2)."""
    B, N = 2, 6
    fH, fW = tiny_aug().final_dim
    imgs = rng.normal(size=(B, N, 3, fH, fW)).astype(np.float32)
    args = (imgs, *rig(rng, B, N, (fH, fW)))
    binimgs = (rng.uniform(size=(B, 1, 16, 16)) < 0.2).astype(np.float32)
    jm = jax_compile_model(tiny_grid(), tiny_aug(), outC=1, variant="slim")
    variables = randomize_variables(jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False), rng)

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                       *map(jnp.asarray, args), train=False)
        return JLoss.bce_with_logits(out, jnp.asarray(binimgs), 2.13)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    port = compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                         DataAugConf.from_dict(tiny_aug().to_dict()),
                         variant="slim", device="cpu")
    sd = jax_variables_to_state_dict(variables, "slim")
    port.load_state_dict(sd)
    port.eval()
    logits = port(*map(torch.from_numpy, args))
    loss = L.bce_with_logits(logits, torch.from_numpy(binimgs), 2.13)
    loss.backward()
    # the same tree loads (strict) with fused_dw on, which eval ignores
    fused = compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                          DataAugConf.from_dict(tiny_aug().to_dict()),
                          variant="slim", fused_dw=True, device="cpu")
    fused.load_state_dict(sd, strict=True)
    with torch.no_grad():
        torch.testing.assert_close(fused.eval()(*map(torch.from_numpy, args)),
                                   logits.detach(), rtol=0, atol=0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.array, jgrads),
         "batch_stats": variables["batch_stats"]}, name_map("slim"))
    params = dict(port.named_parameters())
    gscale = max(np.abs(want[k].numpy()).max() for k in params)
    assert gscale > 0
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-2,
                                   atol=1e-3 * gscale, err_msg=k)


# --- data: fixtures and the loader


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def test_fixture_matches_jax_generator(tmp_path):
    """The same files; JPEG and JSON bytes equal; the npz labels equal
    (np.savez_compressed stamps each zip entry with the time it was
    written, so their bytes may differ)."""
    kw = dict(num_scenes=2, samples_per_scene=2, H=48, W=96, grid=20, seed=3)
    a = JF.generate_fixture(tmp_path / "jax", **kw)
    b = F.generate_fixture(tmp_path / "port", **kw)
    assert _files(a) == _files(b) and _files(a)
    for rel in _files(a):
        if rel.endswith(".npz"):
            np.testing.assert_array_equal(np.load(a / rel)["bev"],
                                          np.load(b / rel)["bev"])
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return F.generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                              samples_per_scene=3, H=64, W=128, grid=16)


@pytest.mark.parametrize("device_normalize", [True, False])
def test_val_loader_matches_jax_loader(fixture_root, device_normalize):
    """Validation batches (no randomness) from the port's SegmentationData
    and DataLoader equal the JAX loader's, both on their PIL paths
    (``use_native=False``; the native paths are held in
    test_torch_fastimage.py): bit for bit, padded last batch and validity
    mask included."""
    aug = dict(H=64, W=128, final_dim=(32, 64))
    from lss_carla_tpu.configs import DataAugConf as JAug, GridConf as JGrid
    jds = JS.SegmentationData(fixture_root, False, JAug(**aug), JGrid(),
                              use_native=False, device_normalize=device_normalize)
    tds = S.SegmentationData(fixture_root, False, DataAugConf(**aug), GridConf(),
                             device_normalize=device_normalize, use_native=False)
    assert len(jds) == len(tds) == 3
    want = list(JLd.DataLoader(jds, 2, pad_last=True, num_workers=0))
    got = list(DataLoader(tds, 2, pad_last=True, num_workers=2))
    assert len(got) == len(want) == 2
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb) == 8
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[0][0].flags.c_contiguous
    dev = list(prefetch_to_device(iter(got), "cpu"))
    assert all(torch.equal(torch.from_numpy(g), d) for g, d in zip(got[1], dev[1]))


@pytest.mark.parametrize("override", [{"front": "yaw30pitch0"},
                                      {"back": "yaw30pitch0", "front_left": "yaw30pitch0"}])
def test_viewpoint_override_matches_jax(tmp_path, override):
    """``viewpoint_override`` swaps the named cameras' image, intrinsics and
    extrinsics for another orientation's of the same token, as the JAX
    dataset does (validation items, PIL paths on both sides: bit for
    bit); a token the orientation lacks keeps the base sample's."""
    from lss_carla_tpu.configs import DataAugConf as JAug, GridConf as JGrid
    kw = dict(num_scenes=2, samples_per_scene=2, H=64, W=128,
              orientations=("yaw0pitch0", "yaw30pitch0"))
    root = F.generate_fixture(tmp_path, **kw)
    aug = dict(H=64, W=128, final_dim=(32, 64))
    tds = S.SegmentationData(root, False, DataAugConf(**aug), GridConf(),
                             viewpoint_override=override, use_native=False)
    jds = JS.SegmentationData(root, False, JAug(**aug), JGrid(),
                              viewpoint_override=override, use_native=False)
    base = S.SegmentationData(root, False, DataAugConf(**aug), GridConf(),
                              use_native=False)
    swapped = [S.CAMERA_ORDER.index(c) for c in override]
    for i in range(len(tds)):
        got, want, plain = tds[i], jds[i], base[i]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for c in range(6):
            assert np.array_equal(got[1][c], plain[1][c]) == (c not in swapped)
    tds._override_lookup["yaw30pitch0"] = {}  # tokens missing there
    for g, p in zip(tds[0], base[0]):
        np.testing.assert_array_equal(g, p)


def test_train_loader_shuffles_by_epoch_and_seed(fixture_root):
    aug = DataAugConf(H=64, W=128, final_dim=(32, 64), resize_lim=(0.9, 1.1),
                      rand_flip=True, Ncams=4)
    ds = S.SegmentationData(fixture_root, True, aug, GridConf(), seed=1)
    loader = DataLoader(ds, 4, shuffle=True, drop_last=True, num_workers=0, seed=7)
    assert len(loader) == 3 and len(ds) == 12
    first = [b[6] for b in loader]
    loader.set_epoch(0)
    again = [b[6] for b in loader]
    for a, b in zip(first, again):  # the same order for the same epoch
        np.testing.assert_array_equal(a, b)
    batch = next(iter(loader))  # Ncams 4 of the 6 cameras, f32 images
    assert batch[0].shape == (4, 4, 3, 32, 64) and batch[0].dtype == np.float32


# --- train() end to end on the CPU

TINY = dict(nepochs=3, H=64, W=128, final_dim=(32, 64), xbound=(-50.0, 50.0, 6.25),
            ybound=(-50.0, 50.0, 6.25), dbound=(4.0, 36.0, 8.0), bsz=2,
            nworkers=2, iou_log_step=1, variant="slim", device="cpu")
SCALARS = {"train/loss", "train/iou", "train/step_time", "train/samples_per_sec",
           "val/loss", "val/iou"}


@pytest.fixture
def few_threads():
    """train() runs loader threads beside torch's intra-op pool; with the
    suite's workers sharing the cores, a full-width pool oversubscribes
    them. The tiny model needs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fused_dw", [True, False])
def test_train_checkpoints_and_resume(fixture_root, tmp_path, fused_dw,
                                      few_threads):
    """train() on the CPU: it finishes, logs the JAX trainer's scalar names,
    writes the reference checkpoint files, resumes at the saved counter,
    and model_best.pt loads as the serving CLI loads a checkpoint."""
    logdir = str(tmp_path / "run")
    out = train(fixture_root, **TINY, fused_dw=fused_dw, max_steps=10,
                val_step=5, save_step=5, logdir=logdir)
    assert out["counter"] == 10 and out["start_counter"] == 0
    recs = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert SCALARS <= {k for r in recs for k in r}
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r)
    ckpts = os.path.join(logdir, "ckpts")
    assert {"model_000005.pt", "model_000010.pt", "model_best.pt",
            "model_final.pt"} <= set(os.listdir(ckpts))
    ck = load_checkpoint(os.path.join(ckpts, "model_000005.pt"))
    assert set(ck) == {"model_state_dict", "optimizer_state_dict", "counter", "epoch"}
    assert ck["counter"] == 5
    best = load_checkpoint(os.path.join(ckpts, "model_best.pt"))
    assert "val_iou" in best
    model = compile_model(GridConf(xbound=TINY["xbound"], ybound=TINY["ybound"],
                                   dbound=TINY["dbound"]),
                          DataAugConf(H=64, W=128, final_dim=(32, 64)),
                          variant="slim", device="cpu")
    model.load_state_dict(reference_state_dict(best["model_state_dict"]))
    if fused_dw:
        resumed = train(fixture_root, **TINY, fused_dw=True, max_steps=7,
                        val_step=0, save_step=0, logdir=str(tmp_path / "r"),
                        resume=os.path.join(ckpts, "model_000005.pt"))
        # 6 train batches an epoch: the resume crosses into epoch 1
        assert resumed["start_counter"] == 5 and resumed["counter"] == 7
        assert resumed["state"].step == 7


def test_empty_val_set_matches_jax(fixture_root, tmp_path, monkeypatch):
    """A val loader that yields no batch: the port's get_val_info returns
    what the JAX package's does (loss 0.0, IoU 1.0, no per-class list),
    and train() takes it as any validation, so its first one saves a best
    model at IoU 1.0 (the JAX trainer saves one too: 1.0 beats its 0.0)."""
    from lss_carla_tpu.training.loop import get_val_info as jax_get_val_info
    from lss_carla_torch.training import loop

    def never(state, batch):
        raise AssertionError("no batch to evaluate")

    want = jax_get_val_info(never, None, [])
    assert loop.get_val_info(never, None, [], device="cpu") == want == {
        "loss": 0.0, "iou": 1.0}

    real = loop.compile_data
    monkeypatch.setattr(loop, "compile_data",
                        lambda *a, **k: (real(*a, **k)[0], []))
    out = train(fixture_root, **dict(TINY, nepochs=1), max_steps=2,
                val_step=2, save_step=0, logdir=str(tmp_path))
    assert out["best_val_iou"] == 1.0
    assert load_checkpoint(tmp_path / "ckpts" / "model_best.pt")["val_iou"] == 1.0
    vals = [r for r in map(json.loads, open(tmp_path / "metrics.jsonl"))
            if "val/iou" in r]
    assert [(r["step"], r["val/loss"], r["val/iou"]) for r in vals] == [
        (2, 0.0, 1.0)]


def test_train_refuses_what_it_does_not_port(fixture_root, tmp_path,
                                             monkeypatch):
    # every keyword of the JAX trainer is one of train()'s, none refused:
    # pretrained_trunk reaches the import ("auto" with an empty hub cache)
    import inspect
    from lss_carla_tpu.training.loop import train as jax_train
    from lss_carla_torch.training import loop
    assert not hasattr(loop, "UNPORTED")
    assert set(inspect.signature(train).parameters) - set(
        inspect.signature(jax_train).parameters) == {"device", "use_native"}
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no file matches"):
        train(fixture_root, **TINY, pretrained_trunk="auto", logdir=str(tmp_path))
    # with a ResNet trunk the JAX trainer's own check comes first
    with pytest.raises(ValueError, match="no import source exists for the resnet"):
        train(fixture_root, **dict(TINY, variant="resnet18"),
              pretrained_trunk="auto", logdir=str(tmp_path))
    # the parallel keywords are ported (tests/test_torch_parallel_train.py
    # runs them): the JAX trainer's checks of them hold, before any rank
    # starts. On the CPU, ranks are clamped to the cores (8 here): bsz 2
    # does not split over 8 data ranks
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    for n in (8, 64):
        with pytest.raises(ValueError, match="bsz=2 must be divisible by the "
                                             "data-rank count 8"):
            train(fixture_root, **TINY, n_devices=n, logdir=str(tmp_path))
    # multihost without a launcher's environment; cam_devices > 1 with
    # fused_dw (as in JAX) and with cameras that do not split; the BEV-grid
    # mode on fewer ranks than its grid axis (JAX's check)
    for kw, err, match in (
            ({"multihost": True}, RuntimeError, "launcher's environment"),
            ({"n_devices": 2, "cam_devices": 2, "fused_dw": True}, ValueError,
             "composes with data parallelism only"),
            ({"n_devices": 2, "cam_devices": 2, "ncams": 5}, ValueError,
             "ncams=5 must be divisible by cam_devices=2"),
            ({"grid_devices": 2}, ValueError,
             "n_devices=1 must be divisible by grid_devices=2")):
        with pytest.raises(err, match=match):
            train(fixture_root, **dict(TINY, **kw), logdir=str(tmp_path))
    # nuScenes is ported: the keywords reach its loader (which finds no
    # tables in this SimBEV fixture), and multiclass labels raise as in JAX
    for kw, where in (({}, "v1.0-mini"),
                      ({"nuscenes_version": "v1.0-trainval"}, "v1.0-trainval")):
        with pytest.raises(FileNotFoundError, match=f"tables not found: .*{where}"):
            train(fixture_root, **TINY, dataset="nuscenes", **kw,
                  logdir=str(tmp_path))
    with pytest.raises(ValueError, match="supports only label_mode='vehicle_binary'"):
        train(fixture_root, **TINY, dataset="nuscenes", label_mode="multiclass",
              logdir=str(tmp_path))
    with pytest.raises(TypeError, match="unexpected"):
        train(fixture_root, **TINY, no_such_flag=1, logdir=str(tmp_path))
    # 6 train batches an epoch: a stack of 7 never fills
    with pytest.raises(ValueError, match="accum_steps=7 exceeds"):
        train(fixture_root, **TINY, accum_steps=7, logdir=str(tmp_path))
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(torch.nn.Linear(1, 1), accum_steps=0, device="cpu")
    # --pretrained_trunk trains: at lr 0 the final checkpoint's trunk is
    # the file's (the CLI's variants start at b0)
    from lss_carla_torch.train import main
    from lss_carla_torch.utils.convert import (imagenet_trunk_state_dict,
                                               synthetic_imagenet_state_dict)
    sd = synthetic_imagenet_state_dict("b0", seed=4)
    torch.save(sd, tmp_path / "efficientnet-b0-imagenet.pth")
    assert main(["--dataroot", str(fixture_root), "--device", "cpu",
                 "--H", "64", "--W", "128", "--final_h", "32", "--final_w", "64",
                 "--xbound", "-50", "50", "6.25", "--ybound", "-50", "50", "6.25",
                 "--dbound", "4", "36", "8", "--bsz", "2", "--nworkers", "1",
                 "--lr", "0", "--weight_decay", "0", "--max_steps", "1",
                 "--val_step", "0", "--save_step", "0", "--viz_step", "0",
                 "--logdir", str(tmp_path / "cli"), "--pretrained_trunk",
                 str(tmp_path / "efficientnet-b0-imagenet.pth")]) == 0
    final = load_checkpoint(tmp_path / "cli" / "ckpts" / "model_final.pt")
    trained = {k: v for k, v in final["model_state_dict"].items()
               if k.startswith("camencode.trunk.")}
    for k, v in imagenet_trunk_state_dict(sd, "b0").items():
        if not k.endswith(("running_mean", "running_var")):  # train-mode BN
            assert torch.equal(trained["camencode.trunk." + k], v), k
    with pytest.raises(ValueError, match="divisible by grid_devices=2"):
        main(["--dataroot", str(fixture_root), "--grid_devices", "2",
              "--device", "cpu"])
    with pytest.raises(ValueError, match="resnet"):
        main(["--dataroot", str(fixture_root), "--pretrained_trunk", "auto",
              "--variant", "resnet34"])
