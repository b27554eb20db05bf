"""EfficientNet-B1..B4 in the port against the JAX package, on the CPU, in
f32: the whole LSS model's eval-mode logits at a tiny config, and each
trunk's train-mode BN running stats. The same numpy-drawn variables go to
both sides (the JAX model's shapes from ``jax.eval_shape``, so no init is
compiled), through the port's converter with the variant's name map.

Tolerances: logits atol 2e-3, rtol 1e-2, as test_torch_lss.py holds B0
and slim (XLA:CPU and PyTorch sum the convs in different orders over a
23-32 block trunk); running stats 1e-5 relative plus 2e-5 absolute: one
momentum-0.01 step of f32 batch moments whose inputs differ by rounding
compounded over the blocks before them (stats near 1; over b1-b4 and
three seeds each the largest difference was 7.2e-6). Each case draws
its inputs from its own seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.configs import DataAugConf as JDataAugConf
from lss_carla_tpu.configs import GridConf as JGridConf
from lss_carla_tpu.models import efficientnet as JE
from lss_carla_tpu.models.lss import compile_model as jax_compile_model

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.efficientnet import (EfficientNetTrunk,
                                                 block_plan, endpoint_channels)
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.utils import convert as C

from test_torch_convert import randomize_variables
from test_torch_lss import rig
from util import tiny_aug, tiny_grid

LOGIT_TOL = dict(atol=2e-3, rtol=1e-2)
STATS_TOL = dict(rtol=1e-5, atol=2e-5)


def random_variables(jm, args, rng):
    """Variables of JAX module ``jm`` for ``args``, drawn with numpy: conv
    kernels with variance 2 / fan_out (the package's ``kaiming_out``),
    biases with standard deviation 0.1, then BN statistics and affine parameters randomised."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                            train=False))

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_out = int(np.prod(s.shape[:-2])) * s.shape[-1]
            return rng.normal(0, np.sqrt(2.0 / fan_out), s.shape).astype(np.float32)
        if "bias" in name:
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        return np.ones(s.shape, np.float32)  # BN scale and var, redrawn below

    variables = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    return randomize_variables(variables, rng)


def _lss_logits(rng, jgrid, jaug, variant, B, N):
    fH, fW = jaug.final_dim
    imgs = rng.normal(size=(B, N, 3, fH, fW)).astype(np.float32)
    args = (imgs, *rig(rng, B, N, jaug.final_dim))
    jm = jax_compile_model(jgrid, jaug, outC=1, variant=variant,
                           splat_method="pallas")
    variables = random_variables(jm, tuple(map(jnp.asarray, args)), rng)
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        variables, *map(jnp.asarray, args), train=False))
    port = compile_model(GridConf.from_dict(jgrid.to_dict()),
                         DataAugConf.from_dict(jaug.to_dict()), outC=1,
                         variant=variant, device="cpu")
    port.load_state_dict(C.jax_variables_to_state_dict(variables, variant))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 1e-2  # the BEV is not empty
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    return variables


@pytest.mark.parametrize("variant", ["b1", "b2", "b3", "b4"])
def test_variant_eval_logits_and_train_stats_match_jax(variant):
    """Eval logits of the whole model (2 cameras at 32 x 64), then one
    train-mode step of its trunk (drop-connect 0: the JAX trunk draws its
    own masks) from the same variables: every new running mean and
    variance."""
    rng = np.random.default_rng(100 + int(variant[1]))
    variables = _lss_logits(rng, tiny_grid(), tiny_aug(), variant, B=1, N=2)
    trunk_vars = {k: variables[k]["camencode"]["trunk"]
                  for k in ("params", "batch_stats")}
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    _, mut = JE.EfficientNetTrunk(variant, drop_connect_rate=0.0).apply(
        trunk_vars, jnp.asarray(x), True, mutable=["batch_stats"])
    names = C.trunk_name_map(variant)
    want = C.variables_to_state_dict(
        {"params": trunk_vars["params"],
         "batch_stats": jax.tree_util.tree_map(np.array, mut["batch_stats"])},
        names)
    port = EfficientNetTrunk(variant, drop_connect_rate=0.0)
    port.load_state_dict(C.variables_to_state_dict(trunk_vars, names))
    with torch.no_grad():
        port.train()(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    got = port.state_dict()
    keys = [k for k in names if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * (1 + sum(2 + (a["expand"] != 1)
                                     for a in block_plan(variant)))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **STATS_TOL)


def test_b4_wiring():
    """B4's 32 blocks and its CamEncode ``up1`` input width, 448 + 160
    (reduction_5 + reduction_4), from ``endpoint_channels``."""
    assert len(block_plan("b4")) == 32
    ch = endpoint_channels("b4")
    assert (ch["reduction_5"], ch["reduction_4"]) == (448, 160)
    grid, aug = GridConf(), DataAugConf()
    model = compile_model(grid, aug, variant="b4", device="cpu")
    assert model.camencode.up1.conv[0].in_channels == 448 + 160
    assert set(C.name_map("b4")) == {
        k for k in model.state_dict() if not k.endswith("num_batches_tracked")}


@pytest.mark.slow
def test_b4_full_width_logits_match_jax():
    """B4 at the default config: 6 cameras at 128 x 352, 41 depth bins, a
    200 x 200 grid."""
    _lss_logits(np.random.default_rng(104), JGridConf(), JDataAugConf(), "b4",
                B=1, N=6)
