"""EMA with warm-up, BN recalibration and EMA checkpoints in the port,
against the JAX package on the CPU (mirrors tests/test_ema.py and
tests/test_bn_recal.py), and ``train()`` with the stretch recipe's
options at a tiny size.

Tolerances: the EMA recursion is the same f32 arithmetic rounded in
another order (torch scales, then adds (1 - d) x; XLA fuses), a few ulps
of values near 1 after twelve steps (1e-6 relative and absolute); recalibrated moments 1e-4 relative, 1e-5
absolute, as tests/test_bn_recal.py holds the JAX recalibrator against
flax's own update (its momentum recovery divides by 1 - m = 0.01);
checkpoint round trips are exact."""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.models import efficientnet as JE
from lss_carla_tpu.models import layers as JL
from lss_carla_tpu.training import state as JState
from lss_carla_tpu.training.bn_recal import BNRecalibrator

from lss_carla_torch.data import fixtures as F
from lss_carla_torch.models.efficientnet import EfficientNetTrunk
from lss_carla_torch.models.layers import BasicBlock
from lss_carla_torch.training.bn_recal import recalibrate_bn
from lss_carla_torch.training.loop import train
from lss_carla_torch.training.state import (TrainState, create_train_state,
                                            ema_update, restore_train_state)
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils import convert as C
from lss_carla_torch.utils.checkpoint import CheckpointManager, load_checkpoint

from test_torch_convert import randomize_variables, tiny_confs
from test_torch_lss import rig

EMA_TOL = dict(rtol=1e-6, atol=1e-6)
RECAL_TOL = dict(rtol=1e-4, atol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)


@pytest.mark.parametrize("decay", [0.5, 0.9, 0.999])
def test_ema_recursion_matches_jax_over_k_steps(decay):
    """Twelve updates of a BasicBlock's parameters and BN running stats,
    with fresh numpy values for the trained model at each step: the port's
    ``ema_update`` at TrainState.step = t against the JAX ``ema_update`` at
    flax's step t (1 for the first update), every tensor at every step."""
    rng = np.random.default_rng(7)
    jm = JL.BasicBlock(8, stride=2)
    x = rng.normal(size=(2, 6, 6, 4)).astype(np.float32)
    variables = _np_tree(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x), False))
    names = C.basicblock_name_map(True)
    jstate = JState.TrainState.create(
        apply_fn=None, params=variables["params"], tx=optax.identity(),
        batch_stats=variables["batch_stats"],
        ema_params=variables["params"], ema_batch_stats=variables["batch_stats"])
    model = BasicBlock(4, 8, 2)
    model.load_state_dict(C.variables_to_state_dict(variables, names))
    state = create_train_state(model, ema_decay=decay)
    for t in range(1, 13):
        new = randomize_variables(jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), variables), rng)
        jstate = JState.ema_update(jstate.replace(
            step=t, params=new["params"], batch_stats=new["batch_stats"]),
            decay)
        model.load_state_dict(C.variables_to_state_dict(new, names))
        state.step = t
        ema_update(state, decay)
        want = C.variables_to_state_dict(
            {"params": _np_tree(jstate.ema_params),
             "batch_stats": _np_tree(jstate.ema_batch_stats)}, names)
        got = state.ema_model.state_dict()
        for k in names:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=f"{k} at t={t}", **EMA_TOL)


@pytest.mark.parametrize("t,want", [(1, 2 / 11), (4, 5 / 14), (10_000, 0.5)])
def test_ema_warmup_ramp(t, want):
    """From EMA 1 and weights 0 one update leaves the effective decay:
    min(0.5, (1 + t) / (10 + t))."""
    model = torch.nn.Linear(3, 2)
    state = create_train_state(model, ema_decay=0.5)
    with torch.no_grad():
        for p, e in zip(model.parameters(), state.ema_model.parameters()):
            p.zero_()
            e.fill_(1.0)
    state.step = t
    ema_update(state, 0.5)
    np.testing.assert_allclose(state.ema_model.weight[0, 0].item(), want, rtol=1e-6)


# --- a slim LSS on a tiny batch ------------------------------------------


def _tiny_lss(fused_dw=False, seed=0):
    from lss_carla_torch.models.lss import compile_model
    grid, aug = tiny_confs()
    return compile_model(grid, aug, variant="slim", fused_dw=fused_dw,
                         device="cpu", generator=torch.Generator().manual_seed(seed))


def _tiny_batch(rng, B=2, N=6):
    imgs = rng.normal(size=(B, N, 3, 32, 64)).astype(np.float32)
    binimgs = (rng.uniform(size=(B, 1, 16, 16)) < 0.2).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in
                 (imgs, *rig(rng, B, N, (32, 64)), binimgs))


def test_train_step_keeps_the_ema():
    """Three train steps with EMA 0.5: the EMA follows the recursion with
    t = the update count after each step (1, 2, 3) over the parameters and
    the BN running stats, and lags the trained model."""
    torch.manual_seed(0)
    model = _tiny_lss()
    state = create_train_state(model, ema_decay=0.5)
    expected = [t.detach().clone() for t in
                list(model.parameters()) + [b for k, b in model.named_buffers()
                                            if k.endswith(("_mean", "_var"))]]
    step = make_train_step(model, ema_decay=0.5, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):
        step(state, _tiny_batch(rng))
        d = min(0.5, (1.0 + state.step) / (10.0 + state.step))
        now = list(model.parameters()) + [b for k, b in model.named_buffers()
                                          if k.endswith(("_mean", "_var"))]
        expected = [e * d + x.detach() * (1 - d) for e, x in zip(expected, now)]
    assert state.step == 3
    got = list(state.ema_model.parameters()) + [
        b for k, b in state.ema_model.named_buffers() if k.endswith(("_mean", "_var"))]
    for g, e in zip(got, expected):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-7)
    assert max((g - x).abs().max().item() for g, x in zip(got, now)) > 0
    assert not any(p.requires_grad for p in state.ema_model.parameters())


# --- BN recalibration against BNRecalibrator ----------------------------


@pytest.mark.parametrize("fused_dw", [False, True])
def test_recalibrated_moments_match_jax(fused_dw):
    """A slim trunk (drop-connect 0, so no dropout on either side) over two
    batches: every BN's recalibrated mean and variance against
    ``BNRecalibrator.recalibrate``. With fused_dw the ``bn1`` moments come
    from the depthwise op, not from a BN forward."""
    rng = np.random.default_rng(11)
    jm = JE.EfficientNetTrunk("slim", drop_connect_rate=0.0)
    xs = [rng.normal(size=(2, 32, 64, 3)).astype(np.float32) + i for i in range(2)]
    variables = randomize_variables(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(xs[0]), False), rng)
    got_j = BNRecalibrator(jm, variables["batch_stats"]).recalibrate(
        variables["params"], [(jnp.asarray(x),) for x in xs])
    names = C.trunk_name_map("slim")
    want = C.variables_to_state_dict(
        {"params": variables["params"], "batch_stats": _np_tree(got_j)}, names)
    trunk = EfficientNetTrunk("slim", drop_connect_rate=0.0, fused_dw=fused_dw)
    trunk.load_state_dict(C.variables_to_state_dict(variables, names))
    assert recalibrate_bn(trunk, [(_nchw(x),) for x in xs]) == 2
    assert not trunk.training
    state = trunk.state_dict()
    keys = [k for k in names if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                   err_msg=k, **RECAL_TOL)
    # the BN layers record nothing once recalibration is over
    assert all(getattr(m, "moments", None) is None for m in trunk.modules())


def test_recalibration_of_no_batch_keeps_the_stats():
    trunk = EfficientNetTrunk("slim")
    before = {k: v.clone() for k, v in trunk.state_dict().items()}
    assert recalibrate_bn(trunk, []) == 0
    for k, v in trunk.state_dict().items():
        assert torch.equal(v, before[k]), k


# --- checkpoints with and without EMA, both ways -------------------------


def test_checkpoint_round_trip_with_and_without_ema(tmp_path):
    torch.manual_seed(0)
    rng = np.random.default_rng(2)
    model = _tiny_lss()
    state = create_train_state(model, ema_decay=0.5)
    make_train_step(model, ema_decay=0.5, device="cpu")(state, _tiny_batch(rng))
    mgr = CheckpointManager(tmp_path / "ema")
    mgr.save(1, model, state.optimizer, 0, ema_model=state.ema_model)
    ck = load_checkpoint(tmp_path / "ema")
    assert set(ck) == {"model_state_dict", "optimizer_state_dict", "counter",
                       "epoch", "ema_state_dict"}
    assert set(ck["ema_state_dict"]) == set(ck["model_state_dict"])

    def same(a, b):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b[k]), k

    # an EMA run from an EMA checkpoint: exact
    target = create_train_state(_tiny_lss(seed=9), ema_decay=0.5)
    restore_train_state(target, ck)
    assert target.step == 1
    same(target.model, model.state_dict())
    same(target.ema_model, state.ema_model.state_dict())
    # a run without EMA from an EMA checkpoint: the EMA is dropped
    plain = create_train_state(_tiny_lss(seed=9))
    restore_train_state(plain, ck)
    assert plain.ema_model is None
    same(plain.model, model.state_dict())
    # an EMA run from a checkpoint without one: seeded from the weights
    CheckpointManager(tmp_path / "raw").save(1, model, state.optimizer, 0)
    raw = load_checkpoint(tmp_path / "raw")
    assert "ema_state_dict" not in raw
    seeded = create_train_state(_tiny_lss(seed=9), ema_decay=0.5)
    restore_train_state(seeded, raw)
    same(seeded.ema_model, model.state_dict())


def test_jax_ema_converts_to_an_ema_state_dict(rng):
    """``jax_ema_to_state_dict`` takes a JAX state's EMA through the same
    name map as the weights: b0 and b4, every tensor."""
    from lss_carla_tpu.models.lss import compile_model as jax_compile_model
    from util import tiny_aug, tiny_grid
    for variant in ("b0", "b4"):
        jm = jax_compile_model(tiny_grid(), tiny_aug(), variant=variant)
        args = (jnp.zeros((1, 1, 3, 32, 64)), jnp.tile(jnp.eye(3), (1, 1, 1, 1)),
                jnp.zeros((1, 1, 3)), jnp.tile(jnp.eye(3), (1, 1, 1, 1)),
                jnp.tile(jnp.eye(3), (1, 1, 1, 1)), jnp.zeros((1, 1, 3)))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                                train=False))
        ema = jax.tree_util.tree_map(
            lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))
        got = C.jax_ema_to_state_dict(ema["params"], ema["batch_stats"], variant)
        want = C.jax_variables_to_state_dict(ema, variant)
        assert set(got) == set(want) and len(got) > 100
        for k in want:
            assert torch.equal(got[k], want[k]), k
        from lss_carla_torch.models.lss import compile_model
        grid, aug = tiny_confs()
        compile_model(grid, aug, variant=variant, device="cpu").load_state_dict(got)


# --- train() with the stretch recipe's options, tiny ---------------------


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return F.generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                              samples_per_scene=3, H=64, W=128, grid=16)


STRETCH_TINY = dict(
    nepochs=3, H=64, W=128, final_dim=(32, 64), xbound=(-50.0, 50.0, 6.25),
    ybound=(-50.0, 50.0, 6.25), dbound=(4.0, 36.0, 8.0), bsz=2, nworkers=2,
    iou_log_step=1, variant="b4", compute_dtype="bfloat16", fused_dw=True,
    label_mode="multiclass", lr_schedule="cosine", warmup_steps=1,
    ema_decay=0.999, ema_bn_recal=2, accum_steps=2, device="cpu")


@pytest.fixture
def few_threads():
    """One intra-op thread beside the loader's: the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_stretch_recipe_tiny(fixture_root, tmp_path, few_threads):
    """train() with B4, bf16, fused_dw, 4-class labels, cosine with
    warm-up, EMA with recalibration and two microbatches a step, on the
    CPU at 32 x 64: the JAX trainer's scalar names (``val/iou_raw`` beside
    the EMA's ``val/iou``, per-class IoU, ``train/lr``), finite losses,
    checkpoints with an ``ema_state_dict``, a resume that continues at the
    saved counter, and the export CLI's ``--best --ema --compute_dtype
    bfloat16`` (EMA weights) and ``--best`` alone (raw weights). 6 train
    batches an epoch make 3 steps (the loss is logged every 10 steps, the
    IoU every step here)."""
    logdir = str(tmp_path / "run")
    out = train(fixture_root, **STRETCH_TINY, max_steps=4, val_step=2,
                save_step=2, logdir=logdir)
    assert out["counter"] == 4 and out["state"].step == 4
    recs = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    keys = {k for r in recs for k in r}
    assert {"train/iou", "train/step_time", "train/lr",
            "train/samples_per_sec", "val/loss", "val/iou", "val/loss_raw",
            "val/iou_raw", "val/iou_c0", "val/iou_c3"} <= keys
    vals = [r for r in recs if "val/iou" in r]
    assert len(vals) == 2
    assert all(np.isfinite(r[k]) for r in recs for k in r
               if k.startswith(("train/iou", "val/")))
    ck = load_checkpoint(os.path.join(logdir, "ckpts", "model_000002.pt"))
    assert "ema_state_dict" in ck and ck["counter"] == 2
    assert "ema_state_dict" in load_checkpoint(os.path.join(logdir, "ckpts",
                                                            "model_best.pt"))
    resumed = train(fixture_root, **STRETCH_TINY, max_steps=3, val_step=0,
                    save_step=0, logdir=str(tmp_path / "r"),
                    resume=os.path.join(logdir, "ckpts", "model_000002.pt"))
    assert resumed["start_counter"] == 2 and resumed["counter"] == 3
    assert isinstance(resumed["state"], TrainState)

    # the export CLI: the run's best checkpoint, EMA weights, served in bf16
    from lss_carla_torch.serving import _main as export_cli
    from lss_carla_torch.serving import example_args, load_predict
    best = load_checkpoint(os.path.join(logdir, "ckpts", "model_best.pt"))
    geometry = ["--H", "64", "--W", "128", "--final_dim", "32", "64",
                "--xbound", "-50", "50", "6.25", "--ybound", "-50", "50", "6.25",
                "--dbound", "4", "36", "8", "--variant", "b4", "--outC", "4"]
    for ema, key in ((True, "ema_state_dict"), (False, "model_state_dict")):
        art = str(tmp_path / f"art_{key}.pt")
        export_cli(["--checkpoint", os.path.join(logdir, "ckpts"), "--best",
                    "--compute_dtype", "bfloat16", "--uint8", "--out", art,
                    *geometry] + (["--ema"] if ema else []))
        blob = torch.load(art, map_location="cpu", weights_only=True)
        assert blob["config"]["compute_dtype"] == "bfloat16"
        for k, v in best[key].items():
            assert torch.equal(blob["state_dict"][k], v), (key, k)
    predict = load_predict(art, device="cpu")
    logits = predict(*example_args(blob["signature"]))
    assert logits.dtype == torch.float32 and logits.shape == (1, 4, 16, 16)


@pytest.mark.slow
def test_train_stretch_recipe_logs_what_jax_logs(fixture_root, tmp_path,
                                                 few_threads):
    """The JAX trainer and the port's train() with the same stretch options
    (fused_dw off: the JAX Pallas kernel does not run on the CPU) on one
    tiny fixture: both reach the same step and log the same scalar names,
    all finite. (Their losses differ: the weights and the dropout masks
    come from different generators.)"""
    from lss_carla_tpu.training.loop import train as jax_train
    kw = dict(STRETCH_TINY, fused_dw=False)
    kw.pop("device")
    logs = {}
    for name, fn, extra in (("jax", jax_train, dict(viz_step=0, n_devices=1)),
                            ("port", train, dict(device="cpu"))):
        logdir = str(tmp_path / name)
        fn(str(fixture_root), **kw, **extra, max_steps=4, val_step=2,
           save_step=0, logdir=logdir)
        recs = [json.loads(line) for line in
                open(os.path.join(logdir, "metrics.jsonl"))]
        logs[name] = recs
        assert max(r["step"] for r in recs) == 4
        assert all(np.isfinite(r[k]) for r in recs for k in r
                   if k.startswith(("train/iou", "val/")))
    names = {n: {k for r in recs for k in r if k.startswith(("train/", "val/"))}
             for n, recs in logs.items()}
    assert names["port"] == names["jax"], names
