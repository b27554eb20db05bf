"""The port's train-mode BatchNorm against flax's: the running variance is
the biased batch variance, as the JAX package stores it.

torch's ``nn.BatchNorm2d`` stores the unbiased variance, n / (n - 1) times
the biased one (14 % at n = 8). ``lss_carla_torch.models.layers.BatchNorm2d``
stores the biased one with flax's update. Each test runs one train-mode
step of a port module and of its JAX counterpart from the same randomised
weights and running stats, at shapes where n / (n - 1) shows (n <= 32),
and holds every new running mean and variance to 1e-6 relative (1e-7
absolute, for means near 0): the two sides differ only by f32 rounding of
the batch moments, and momentum 0.1 or 0.01 scales that down further."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lss_carla_tpu.models import efficientnet as JE
from lss_carla_tpu.models import layers as JL

from lss_carla_torch.models.efficientnet import EfficientNetTrunk
from lss_carla_torch.models.layers import BasicBlock, BatchNorm2d, Up
from lss_carla_torch.utils import convert as C

from test_torch_convert import randomize_variables

STATS_TOL = dict(rtol=1e-6, atol=1e-7)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _train_step_stats(jm, port, names, args, rng):
    """One train-mode apply on each side; returns {torch name: (port, JAX)}
    for every running mean and variance."""
    jargs = [jnp.asarray(a) for a in args]
    variables = randomize_variables(
        jax.jit(jm.init, static_argnums=len(args) + 1)(
            jax.random.PRNGKey(0), *jargs, False), rng)
    _, mut = jm.apply(variables, *jargs, True, mutable=["batch_stats"])
    want = C.variables_to_state_dict(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.array, mut["batch_stats"])},
        names)
    port.load_state_dict(C.variables_to_state_dict(variables, names))
    port.train()
    with torch.no_grad():
        port(*[_nchw(a) for a in args])
    got = port.state_dict()
    keys = [k for k in names if k.endswith(("running_mean", "running_var"))]
    assert keys
    return {k: (got[k].numpy(), want[k].numpy()) for k in keys}


def _assert_stats(pairs):
    for k, (got, want) in pairs.items():
        np.testing.assert_allclose(got, want, err_msg=k, **STATS_TOL)


def test_up_running_stats(rng):
    # x2 (2, 4, 4, 5) and x1 upsampled 2x to 4 x 4: n = 2 * 4 * 4 = 32
    x1 = rng.normal(size=(2, 2, 2, 7)).astype(np.float32)
    x2 = rng.normal(size=(2, 4, 4, 5)).astype(np.float32)
    _assert_stats(_train_step_stats(JL.Up(6, scale=2), Up(12, 6, 2),
                                    C.up_name_map(), (x1, x2), rng))


@pytest.mark.parametrize("stride,cin", [(2, 4), (1, 8)])
def test_basicblock_running_stats(rng, stride, cin):
    # stride 2: 6 x 6 -> 3 x 3, n = 18 (with the downsample BN); stride 1:
    # n = 2 * 4 * 4 = 32
    x = rng.normal(size=(2, 6 if stride == 2 else 4, 6 if stride == 2 else 4,
                         cin)).astype(np.float32)
    _assert_stats(_train_step_stats(
        JL.BasicBlock(8, stride=stride), BasicBlock(cin, 8, stride),
        C.basicblock_name_map(stride != 1 or cin != 8), (x,), rng))


def test_slim_trunk_running_stats(rng):
    # the last stages run at 1 x 2 on a 32 x 64 input: n = 4
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    _assert_stats(_train_step_stats(
        JE.EfficientNetTrunk("slim", drop_connect_rate=0.0),
        EfficientNetTrunk("slim", drop_connect_rate=0.0),
        C.trunk_name_map("slim"), (x,), rng))


def test_running_var_is_biased_and_normalisation_unchanged():
    """At n = 8 the stored variance is the biased one (torch's own module
    stores 8/7 of it); the train-mode output is torch's."""
    x = torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    ours, theirs = BatchNorm2d(3, momentum=1.0), torch.nn.BatchNorm2d(3, momentum=1.0)
    y, y_ref = ours.train()(x), theirs.train()(x)
    torch.testing.assert_close(y, y_ref)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, biased)
    torch.testing.assert_close(theirs.running_var, biased * 8 / 7)
    assert isinstance(ours, torch.nn.BatchNorm2d)
    assert ours.num_batches_tracked.item() == 1
