"""The port's ResNet-18/34 camera trunk against the JAX package's, on the
CPU, in f32, through the port's converter (``utils/convert.py``'s resnet
name map): both endpoints in eval mode, the running stats after one
train-mode step, strict loads of the whole model, and a tiny LSS's
logits. The JAX package has no torch twin of this trunk's names (the
reference is EfficientNet only), so the converter is the only bridge and
the strict loads are its check. Variables are drawn with numpy (the JAX
shapes from ``jax.eval_shape``); each case draws from its own seed.

Tolerances: endpoints 2e-6 of their largest magnitude. With these random
weights the resnet34 endpoints reach ~620, where one f32 ulp is 6.1e-5,
above the JAX package's own ResNet limit of 5e-5 absolute
(tests/test_resnet_trunk.py, resnet18 only); against the port run in f64
each side is within 8e-7 of that magnitude, for both depths. Running
stats after one momentum-0.1 step: 1e-5 relative plus 1e-5 of the BN's
largest stat (a mean near 0 carries the rounding of batch moments taken
over those large activations); logits ``test_torch_variants.LOGIT_TOL``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.models import resnet as JR
from lss_carla_tpu.models.lss import compile_model as jax_compile_model

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.models.resnet import (RESNET_LAYERS, ResNetTrunk,
                                           endpoint_channels)
from lss_carla_torch.utils import convert as C

from test_torch_convert import tiny_confs
from test_torch_lss import rig
from test_torch_variants import LOGIT_TOL, random_variables
from util import tiny_aug, tiny_grid

ENDPOINT_TOL = 2e-6  # x max |endpoint|
STATS_TOL = 1e-5  # relative, and x max |stat| of the BN
VARIANTS = ["resnet18", "resnet34"]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("variant", VARIANTS)
def test_trunk_endpoints_and_train_stats_match_jax(variant):
    """Eval-mode endpoints, then one train-mode step from the same
    variables: every new running mean and variance (the trunk has no
    dropout, so the two train-mode forwards see the same function)."""
    rng = np.random.default_rng(300 + RESNET_LAYERS[variant][2])
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    jm = JR.ResNetTrunk(variant)
    variables = random_variables(jm, (jnp.asarray(x),), rng)
    want = jax.jit(jm.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False)
    names = C.trunk_name_map(variant)
    port = ResNetTrunk(variant)
    port.load_state_dict(C.variables_to_state_dict(variables, names))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    assert set(got) == set(want) == {"reduction_4", "reduction_5"}
    for k in want:
        w = np.asarray(want[k]).transpose(0, 3, 1, 2)
        assert np.abs(w).max() > 0.1, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, err_msg=k,
                                   atol=ENDPOINT_TOL * np.abs(w).max())

    _, mut = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    want_sd = C.variables_to_state_dict(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.array, mut["batch_stats"])},
        names)
    with torch.no_grad():
        port.train()(_nchw(x))
    got_sd = port.state_dict()
    keys = [k for k in names if k.endswith(("running_mean", "running_var"))]
    # stem + two BNs a block + one downsample BN for layers 2-4
    assert len(keys) == 2 * (1 + 2 * sum(RESNET_LAYERS[variant]) + 3)
    for k in keys:
        w = want_sd[k].numpy()
        np.testing.assert_allclose(got_sd[k].numpy(), w, rtol=STATS_TOL,
                                   atol=STATS_TOL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_whole_model_loads_strict(variant):
    """The name map covers the whole ResNet LSS's state dict, no more and
    no less, and a converted JAX variable tree loads with strict=True."""
    grid, aug = tiny_confs()
    model = compile_model(grid, aug, variant=variant, device="cpu")
    assert set(C.name_map(variant)) == {
        k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    B, N = 1, 1
    fH, fW = aug.final_dim
    args = (jnp.zeros((B, N, 3, fH, fW)), jnp.tile(jnp.eye(3), (B, N, 1, 1)),
            jnp.zeros((B, N, 3)), jnp.tile(jnp.eye(3), (B, N, 1, 1)),
            jnp.tile(jnp.eye(3), (B, N, 1, 1)), jnp.zeros((B, N, 3)))
    jm = jax_compile_model(tiny_grid(), tiny_aug(), outC=1, variant=variant)
    variables = random_variables(jm, args, np.random.default_rng(7))
    sd = C.jax_variables_to_state_dict(variables, variant)
    model.load_state_dict(sd, strict=True)
    w = variables["params"]["camencode"]["trunk"]["layer2_0"]["downsample_conv"]["kernel"]
    torch.testing.assert_close(
        model.state_dict()["camencode.trunk.layer2.0.downsample.0.weight"],
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))


def test_tiny_resnet18_lss_logits_match_jax():
    """The whole resnet18 LSS at the tiny config (2 cameras at 32 x 64, a
    16 x 16 grid), eval mode, against JAX ``LiftSplatShoot.apply``."""
    rng = np.random.default_rng(318)
    jgrid, jaug = tiny_grid(), tiny_aug()
    B, N = 1, 2
    fH, fW = jaug.final_dim
    imgs = rng.normal(size=(B, N, 3, fH, fW)).astype(np.float32)
    args = (imgs, *rig(rng, B, N, jaug.final_dim))
    jm = jax_compile_model(jgrid, jaug, outC=1, variant="resnet18",
                           splat_method="pallas")
    variables = random_variables(jm, tuple(map(jnp.asarray, args)), rng)
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        variables, *map(jnp.asarray, args), train=False))
    port = compile_model(GridConf.from_dict(jgrid.to_dict()),
                         DataAugConf.from_dict(jaug.to_dict()), outC=1,
                         variant="resnet18", device="cpu")
    port.load_state_dict(C.jax_variables_to_state_dict(variables, "resnet18"))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == (B, 1, 16, 16)
    assert np.abs(want).max() > 1e-2  # the BEV is not empty
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_endpoint_shapes_and_wiring(variant):
    """Stride 16 and 32 endpoints of 256 and 512 channels; CamEncode's up1
    takes 512 + 256; no depthwise conv anywhere, whatever fused_dw says."""
    with torch.no_grad():
        eps = ResNetTrunk(variant).eval()(torch.zeros(1, 3, 64, 128))
    assert {k: tuple(v.shape) for k, v in eps.items()} == {
        "reduction_4": (1, 256, 4, 8), "reduction_5": (1, 512, 2, 4)}
    assert endpoint_channels(variant) == {"reduction_4": 256, "reduction_5": 512}
    grid, aug = tiny_confs()
    model = compile_model(grid, aug, variant=variant, fused_dw=True, device="cpu")
    assert model.camencode.up1.conv[0].in_channels == 512 + 256
    assert not any(isinstance(m, torch.nn.Conv2d) and m.groups > 1
                   for m in model.modules())
    with pytest.raises(ValueError, match="resnet"):
        ResNetTrunk("resnet50")


def test_clis_take_the_resnet_variants(tmp_path):
    """The training CLI takes --variant resnet18/34; the export CLI builds a
    resnet34 artifact from a checkpoint, which serves the checkpoint's
    logits."""
    from lss_carla_torch.serving import _main as export_cli
    from lss_carla_torch.serving import example_args, load_predict, read_signature
    from lss_carla_torch.train import build_parser
    for variant in VARIANTS:
        args = build_parser().parse_args(["--dataroot", "d", "--variant", variant])
        assert args.variant == variant
    grid, aug = tiny_confs()
    model = compile_model(grid, aug, variant="resnet34", device="cpu",
                          generator=torch.Generator().manual_seed(34)).eval()
    ckpt = tmp_path / "model.pt"
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    art = tmp_path / "art.pt"
    export_cli(["--checkpoint", str(ckpt), "--out", str(art), "--variant",
                "resnet34", "--H", "64", "--W", "128", "--final_dim", "32", "64",
                "--xbound", "-40", "40", "5", "--ybound", "-40", "40", "5",
                "--dbound", "4", "36", "8", "--device", "cpu"])
    x = example_args(read_signature(str(art)))
    with torch.no_grad():
        want = model(*map(torch.from_numpy, x))
    torch.testing.assert_close(load_predict(str(art), device="cpu")(*x), want,
                               rtol=0, atol=0)
