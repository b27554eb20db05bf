"""The pretrained trunk (``train(pretrained_trunk=...)``, reference
``src/models.py:43``) against the JAX package, on the CPU: the same
seed-made ``efficientnet_pytorch`` ImageNet file (torch names and layouts,
the classifier head included; ``convert.synthetic_imagenet_state_dict``)
goes through JAX's ``lss_carla_tpu/utils/convert.py`` and the port's
``lss_carla_torch/utils/convert.py``: the names, the merge bit for bit,
a forward of the merged models, every source, ``"auto"``, the variant
mismatches both ways, and both trainers from the file. Tolerances are
stated where used."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.models.efficientnet import EfficientNetTrunk as JTrunk
from lss_carla_tpu.models.lss import compile_model as jax_compile_model
from lss_carla_tpu.utils import convert as JC

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data import fixtures as F
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.training.loop import train
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.trunk_probe import run_probe
from lss_carla_torch.utils import convert as C
from lss_carla_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from lss_carla_torch.utils.supervise import child_argv

from test_torch_convert import randomize_variables
from test_torch_lss import rig
from util import tiny_aug, tiny_grid

PREFIX = "camencode.trunk."


@pytest.fixture(scope="module")
def rng():
    """This file's own generator (conftest.py's session one stays the JAX
    tests')."""
    return np.random.default_rng(0)


@pytest.fixture
def few_threads():
    """train() runs loader threads beside torch's intra-op pool; the tiny
    models need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def jax_trunk_to_port(trunk_vars, variant):
    """JAX trunk variables (rooted at the trunk) -> the port's names and
    layouts, without num_batches_tracked."""
    sd = C.variables_to_state_dict(trunk_vars, C.trunk_name_map(variant))
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def port_model(variant, seed=0):
    grid, aug = tiny_grid().to_dict(), tiny_aug().to_dict()
    return compile_model(GridConf.from_dict(grid), DataAugConf.from_dict(aug),
                         outC=1, variant=variant, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def assert_trunk_is(model, trunk_sd):
    """Every tensor of ``model.camencode.trunk`` but num_batches_tracked
    equals ``trunk_sd`` bit for bit, and nothing else is in it."""
    own = {k: v for k, v in model.camencode.trunk.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert own.keys() == trunk_sd.keys()
    for k, v in own.items():
        assert torch.equal(v, trunk_sd[k]), k


# --- names


@pytest.mark.parametrize("variant", ["b0", "b1", "b2", "b3", "b4"])
def test_trunk_names_equal_jax_map(variant):
    """The port's trunk names are JAX's ``build_trunk_name_map`` keys and
    the trunk module's own state-dict names; the synthetic file holds them
    all plus the head and num_batches_tracked, which both importers skip."""
    names = set(C.trunk_name_map(variant))
    assert names == set(JC.build_trunk_name_map(variant))
    assert names == {k[len(PREFIX):] for k in port_model(variant).state_dict()
                     if k.startswith(PREFIX)
                     and not k.endswith("num_batches_tracked")}
    sd = C.synthetic_imagenet_state_dict(variant, seed=1)
    assert {k for k in sd if k.startswith(("_conv_head.", "_bn1.", "_fc."))}
    assert set(C.imagenet_trunk_state_dict(sd, variant)) == names
    assert set(jax_trunk_to_port(JC.imagenet_state_dict_to_trunk_variables(
        numpy_sd(sd), variant), variant)) == names


# --- the merge against JAX's, bit for bit, and a forward of both


def jax_lss(variant, rng, B=1, N=6):
    """JAX LSS at the tiny config, its BN stats randomised, with seeded
    inputs: (model, numpy variables, inputs)."""
    jgrid, jaug = tiny_grid(), tiny_aug()
    args = (rng.normal(size=(B, N, 3, *jaug.final_dim)).astype(np.float32),
            *rig(rng, B, N, jaug.final_dim))
    jm = jax_compile_model(jgrid, jaug, outC=1, variant=variant,
                           splat_method="pallas")
    variables = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False)
    return jm, randomize_variables(variables, rng), args


@pytest.mark.parametrize("variant", ["slim", "b0"])
def test_merge_matches_jax_bit_for_bit(rng, variant):
    """One model's weights in both packages, one file merged by each: the
    port's state dict equals ``jax_variables_to_state_dict(
    merge_trunk_variables(...))`` bit for bit on the trunk and leaves every
    other tensor (its own num_batches_tracked included) as it was. At
    slim both merged models then agree on a forward within
    test_torch_lss.py's tolerance (atol 2e-3, rtol 1e-2)."""
    jm, variables, args = jax_lss(variant, rng)
    sd = C.synthetic_imagenet_state_dict(variant, seed=5)
    merged = JC.merge_trunk_variables(
        variables, JC.imagenet_state_dict_to_trunk_variables(numpy_sd(sd),
                                                             variant))
    want = C.jax_variables_to_state_dict(merged, variant)

    port = compile_model(GridConf.from_dict(tiny_grid().to_dict()),
                         DataAugConf.from_dict(tiny_aug().to_dict()), outC=1,
                         variant=variant, splat_method="pallas", device="cpu")
    port.load_state_dict(C.jax_variables_to_state_dict(variables, variant))
    with torch.no_grad():  # a count of its own, which the merge must keep
        port.camencode.trunk._bn0.num_batches_tracked.fill_(3)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    C.merge_trunk_state_dict(port, C.imagenet_trunk_state_dict(sd, variant))
    got = port.state_dict()
    trunk = 0
    for k, v in got.items():
        if k.startswith(PREFIX) and not k.endswith("num_batches_tracked"):
            trunk += 1
            assert torch.equal(v, want[k]), k
            assert torch.equal(v, sd[k[len(PREFIX):]]), k
        else:
            assert torch.equal(v, before[k]), k
    assert trunk == len(C.trunk_name_map(variant))
    assert int(port.camencode.trunk._bn0.num_batches_tracked) == 3
    if variant != "slim":
        return
    want_logits = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        merged, *map(jnp.asarray, args), train=False))
    with torch.no_grad():
        logits = port.eval()(*map(torch.from_numpy, args)).numpy()
    assert np.all(np.isfinite(logits)) and np.abs(want_logits).max() > 1e-2
    np.testing.assert_allclose(logits, want_logits, atol=2e-3, rtol=1e-2)


def test_merge_casts_to_the_model_dtype():
    """A file in f16 merges into the f32 model as f32 (JAX casts to the
    old leaf's dtype); the model's tensors stay the same objects."""
    model = port_model("slim")
    ids = {k: id(p) for k, p in model.named_parameters()}
    sd = C.imagenet_trunk_state_dict(
        C.synthetic_imagenet_state_dict("slim", seed=2), "slim")
    C.merge_trunk_state_dict(model, {k: v.half() for k, v in sd.items()})
    assert {k: id(p) for k, p in model.named_parameters()} == ids
    for k, v in model.camencode.trunk.named_parameters():
        assert v.dtype == torch.float32
        assert torch.equal(v, sd[k].half().float()), k


# --- the sources


def reference_sd(model, extra_head=True):
    """A reference LSS state dict of ``model``: its names, plus what a
    reference checkpoint carries and the port does not hold (the trunk's
    classifier head, the geometry constants)."""
    sd = dict(model.state_dict())
    if extra_head:
        head = C.synthetic_imagenet_state_dict("b0", seed=9)
        sd.update({PREFIX + k: v for k, v in head.items()
                   if k.startswith(("_conv_head.", "_bn1.", "_fc."))})
        for k in ("dx", "bx", "nx"):
            sd[k] = torch.zeros(3)
        sd["frustum"] = torch.zeros(4, 2, 2, 3)
    return sd


@pytest.fixture(scope="module")
def b0_sources(tmp_path_factory):
    """The four sources at B0, each with its expected trunk: a bare
    ImageNet file; a reference LSS .pt, raw and under model_state_dict; a
    port model_*.pt whose EMA differs from its model; its ckpts/ dir."""
    tmp = tmp_path_factory.mktemp("sources")
    sd = C.synthetic_imagenet_state_dict("b0", seed=3)
    torch.save(sd, tmp / "efficientnet-b0-imagenet.pth")
    model = port_model("b0", seed=4)
    C.merge_trunk_state_dict(model, C.imagenet_trunk_state_dict(
        C.synthetic_imagenet_state_dict("b0", seed=6), "b0"))
    ref = reference_sd(model)
    torch.save(ref, tmp / "reference_raw.pt")
    adam = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-7)
    torch.save({"model_state_dict": ref, "optimizer_state_dict":
                adam.state_dict(), "counter": 525000, "epoch": 7,
                "val_iou": 0.25}, tmp / "reference_dict.pt")
    state = create_train_state(port_model("b0", seed=8), ema_decay=0.9)
    with torch.no_grad():
        for p in state.ema_model.parameters():
            p.add_(1.0)
    path = CheckpointManager(tmp / "ckpts").save(12, state.model,
                                                 state.optimizer, 0,
                                                 ema_model=state.ema_model)
    trunk = {k[len(PREFIX):]: v for k, v in
             state.model.state_dict().items() if k.startswith(PREFIX)
             and not k.endswith("num_batches_tracked")}
    ref_trunk = {k[len(PREFIX):]: v for k, v in model.state_dict().items()
                 if k.startswith(PREFIX)
                 and not k.endswith("num_batches_tracked")}
    return {"imagenet": (tmp / "efficientnet-b0-imagenet.pth",
                         C.imagenet_trunk_state_dict(sd, "b0")),
            "reference_raw": (tmp / "reference_raw.pt", ref_trunk),
            "reference_dict": (tmp / "reference_dict.pt", ref_trunk),
            "port_file": (path, trunk),
            "port_dir": (tmp / "ckpts", trunk)}


@pytest.mark.parametrize("source", ["imagenet", "reference_raw",
                                    "reference_dict", "port_file", "port_dir"])
def test_every_source_loads_the_trunk(b0_sources, source):
    """Each source gives the trunk it holds, bit for bit (a port
    checkpoint its trained weights, not its EMA), and merges into a B0
    model; where JAX reads the same file (ImageNet and reference .pt; its
    own checkpoints are Orbax directories) it gives the same tensors."""
    path, want = b0_sources[source]
    got = C.trunk_state_dict_from_checkpoint(str(path), "b0")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if not source.startswith("port"):
        jgot = jax_trunk_to_port(JC.trunk_variables_from_checkpoint(
            str(path), "b0"), "b0")
        assert jgot.keys() == want.keys()
        for k in want:
            assert torch.equal(jgot[k], want[k]), k
    model = port_model("b0")
    C.merge_trunk_state_dict(model, got)
    assert_trunk_is(model, want)


def test_sources_refuse_what_they_cannot_read(tmp_path):
    """A directory with no checkpoint and a file that is no state dict
    raise; a file that pickles numpy arrays is refused (weights_only,
    where JAX's loader unpickles anything)."""
    with pytest.raises(FileNotFoundError, match="no checkpoint in"):
        C.trunk_state_dict_from_checkpoint(str(tmp_path), "b0")
    torch.save(torch.zeros(3), tmp_path / "t.pt")
    with pytest.raises(ValueError, match="not a state dict"):
        C.trunk_state_dict_from_checkpoint(str(tmp_path / "t.pt"), "b0")
    torch.save(numpy_sd(C.synthetic_imagenet_state_dict("b0")),
               tmp_path / "np.pth")
    with pytest.raises(pickle.UnpicklingError, match="Weights only load"):
        C.trunk_state_dict_from_checkpoint(str(tmp_path / "np.pth"), "b0")


def test_auto_searches_the_hub_cache(tmp_path, monkeypatch):
    """``"auto"`` with HOME's cache empty raises FileNotFoundError in both
    packages; with two matching files both take the last, sorted."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for load in (C.trunk_state_dict_from_checkpoint,
                 JC.trunk_variables_from_checkpoint):
        with pytest.raises(FileNotFoundError, match="no file matches"):
            load("auto", "b0")
    cache = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
    cache.mkdir(parents=True)
    files = {}
    for seed, tag in ((1, "aaaa1111"), (2, "ffff2222")):
        files[tag] = C.synthetic_imagenet_state_dict("b0", seed)
        torch.save(files[tag], cache / f"efficientnet-b0-{tag}.pth")
    torch.save(files["aaaa1111"], cache / "efficientnet-b1-zzzz.pth")
    want = C.imagenet_trunk_state_dict(files["ffff2222"], "b0")
    got = C.trunk_state_dict_from_checkpoint("auto", "b0")
    jgot = jax_trunk_to_port(JC.trunk_variables_from_checkpoint("auto", "b0"),
                             "b0")
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(jgot[k], want[k]), k


def test_variant_mismatch_raises_as_in_jax():
    """A B1 file read as B0 has blocks 16-22 unmapped: KeyError in both
    packages. A B0 trunk into a B1 model lacks names: ValueError in both
    (JAX's merge on B1 trunk variables), and the model is left as it was."""
    sd_b1 = C.synthetic_imagenet_state_dict("b1", seed=1)
    with pytest.raises(KeyError, match="_blocks.16"):
        C.imagenet_trunk_state_dict(sd_b1, "b0")
    with pytest.raises(KeyError, match="_blocks.16"):
        JC.imagenet_state_dict_to_trunk_variables(numpy_sd(sd_b1), "b0")

    sd_b0 = C.synthetic_imagenet_state_dict("b0", seed=1)
    model = port_model("b1")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="does not match the model's trunk"):
        C.merge_trunk_state_dict(model, C.imagenet_trunk_state_dict(sd_b0, "b0"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    tv = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: JTrunk("b1").init({"params": r}, jnp.zeros((1, 32, 64, 3)),
                                    train=False))(jax.random.PRNGKey(1)))
    variables = {c: {"camencode": {"trunk": tv[c]}}
                 for c in ("params", "batch_stats")}
    with pytest.raises(ValueError, match="does not match the model's trunk"):
        JC.merge_trunk_variables(variables, JC.imagenet_state_dict_to_trunk_variables(
            numpy_sd(sd_b0), "b0"))


# --- both trainers from the file

TINY = dict(H=64, W=128, final_dim=(32, 64), xbound=(-50.0, 50.0, 6.25),
            ybound=(-50.0, 50.0, 6.25), zbound=(-10.0, 10.0, 20.0),
            dbound=(4.0, 36.0, 8.0), bsz=2, nworkers=0, variant="slim",
            val_step=0, save_step=0, viz_step=0, iou_log_step=1)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return F.generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=3,
                              samples_per_scene=3, H=64, W=128, grid=16)


@pytest.fixture(scope="module")
def slim_file(tmp_path_factory):
    sd = C.synthetic_imagenet_state_dict("slim", seed=11)
    path = tmp_path_factory.mktemp("file") / "efficientnet-slim-imagenet.pth"
    torch.save(sd, path)
    return str(path), C.imagenet_trunk_state_dict(sd, "slim")


def test_both_trainers_start_from_the_file(fixture_root, slim_file, tmp_path,
                                           few_threads):
    """JAX's test_train_with_pretrained_trunk in both packages: one step at
    lr 0 with EMA from the same file; each trainer's trunk parameters equal
    the file within 1e-6 (the port's bit for bit), and each EMA was
    re-seeded from the merged weights (within 1e-6 relative: one EMA step
    of equal tensors)."""
    from lss_carla_tpu.training.loop import train as jax_train
    path, want = slim_file
    kw = dict(TINY, dataroot=str(fixture_root), nepochs=1, lr=0.0,
              weight_decay=0.0, max_steps=1, ema_decay=0.9,
              pretrained_trunk=path)
    port = train(**kw, device="cpu", logdir=str(tmp_path / "port"))["state"]
    jax_state = jax_train(**kw, n_devices=1, logdir=str(tmp_path / "jax"))[
        "state"]
    params = dict(port.model.camencode.trunk.named_parameters())
    assert params.keys() <= want.keys()
    for k, v in params.items():
        assert torch.equal(v, want[k]), k
    for k, v in port.ema_model.camencode.trunk.named_parameters():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want[k].abs().max()),
                                   err_msg=k)
    for tree in ("params", "ema_params"):
        jtrunk = jax.tree_util.tree_map(
            np.array, getattr(jax_state, tree)["camencode"]["trunk"])
        names = {k: (p, c) for k, (p, c) in C.trunk_name_map("slim").items()
                 if c == "params"}
        jsd = C.variables_to_state_dict({"params": jtrunk}, names)
        assert jsd.keys() == params.keys()
        for k in params:
            np.testing.assert_allclose(jsd[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=(tree, k))


def test_resume_overrides_the_file(fixture_root, slim_file, tmp_path,
                                   few_threads):
    """--resume after the trunk merge: the trunk is the checkpoint's, not
    the file's, and the run continues at the saved counter."""
    path, want = slim_file
    kw = dict(TINY, dataroot=str(fixture_root), nepochs=2, device="cpu")
    train(**kw, max_steps=1, logdir=str(tmp_path / "a"))
    ckpt = load_checkpoint(tmp_path / "a" / "ckpts" / "model_final.pt")
    out = train(**kw, lr=0.0, weight_decay=0.0, max_steps=2,
                resume=str(tmp_path / "a" / "ckpts"), pretrained_trunk=path,
                logdir=str(tmp_path / "b"))
    assert out["start_counter"] == 1 and out["counter"] == 2
    for k, v in out["state"].model.camencode.trunk.named_parameters():
        assert torch.equal(v, ckpt["model_state_dict"][PREFIX + k]), k
        assert not torch.equal(v, want[k]), k


def test_supervised_retries_keep_the_flag(tmp_path):
    """--supervise hands --pretrained_trunk to every child; a retry adds
    --resume, which overrides it."""
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    (ckpts / "model_000002.pt").touch()
    argv = ["--logdir", "L", "--supervise", "2", "--pretrained_trunk", "f.pth"]
    assert child_argv(argv, 0, str(ckpts)) == [
        "--logdir", "L", "--pretrained_trunk", "f.pth"]
    assert child_argv(argv, 1, str(ckpts)) == [
        "--logdir", "L", "--pretrained_trunk", "f.pth", "--resume", str(ckpts)]


def test_probe_writes_both_curves(tmp_path, few_threads):
    """``python -m lss_carla_torch.trunk_probe`` at 2 + 2 steps on tiny
    fixtures: phase 1's checkpoint feeds the pretrained run, and
    probe_result.json holds both train-IoU curves (a point a step here)."""
    out = run_probe(tmp_path, pretrain_steps=2, probe_steps=2, dtype="float32",
                    bsz=2, device="cpu",
                    fixture=dict(num_scenes=3, samples_per_scene=3, H=64,
                                 W=128, grid=16),
                    **{k: TINY[k] for k in ("H", "W", "final_dim", "xbound",
                                            "ybound", "dbound", "variant",
                                            "iou_log_step")}, nworkers=1)
    assert sorted(os.listdir(tmp_path / "pretrain" / "ckpts")) == [
        "model_000002.pt", "model_final.pt"]
    with open(tmp_path / "probe_result.json") as f:
        saved = json.load(f)
    for name in ("random", "pretrained"):
        assert sorted(saved[name]) == ["1", "2"]
        assert all(0.0 <= v <= 1.0 for v in saved[name].values())
        assert saved[name] == {str(k): v for k, v in out[name].items()}
    assert set(saved["seconds"]) == {"pretrain", "random", "pretrained"}
    assert saved["card"] == "cpu"
    logs = {name: open(tmp_path / f"probe_{name}" / "metrics.jsonl").read()
            for name in ("random", "pretrained")}
    assert logs["random"] != logs["pretrained"]
