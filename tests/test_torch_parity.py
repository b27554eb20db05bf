"""fp32 numerical parity vs torch for the layer semantics that are easy to
get silently wrong across frameworks (SURVEY §7 "hard parts" #1):

* conv padding (torch symmetric k//2 vs XLA SAME) incl. stride-2,
* TF-style SAME padding for the EfficientNet depthwise convs,
* BatchNorm eval-mode math (epsilon placement),
* align_corners=True bilinear upsampling inside Up blocks,
* the BasicBlock residual wiring.

Each test builds a small torch module from torch primitives, transplants its
weights into the flax twin via the converter's layout transforms, and
compares outputs elementwise.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from lss_carla_tpu.models.layers import BasicBlock, ConvBNReLU, Up
from lss_carla_tpu.utils.convert import _conv, _depthwise

ATOL = 2e-5


@pytest.fixture(scope="module")
def rng():
    """This file's own generator: the session one in conftest.py stays the
    JAX tests' alone, so their draws do not depend on which port files share
    their worker."""
    return np.random.default_rng(0)


def _to_nhwc(x_nchw):
    return np.transpose(x_nchw, (0, 2, 3, 1))


def _from_nhwc(x_nhwc):
    return np.transpose(np.asarray(x_nhwc), (0, 3, 1, 2))


def test_conv3x3_stride2_padding(rng):
    """torch Conv2d(k=3, s=2, p=1) on even input == our explicit padding."""
    x = rng.normal(size=(2, 8, 16, 20)).astype(np.float32)
    conv_t = tnn.Conv2d(8, 12, 3, stride=2, padding=1, bias=False)
    with torch.no_grad():
        want = conv_t(torch.from_numpy(x)).numpy()

    from flax import linen as nn
    from lss_carla_tpu.models.layers import torch_pad
    conv_f = nn.Conv(12, (3, 3), strides=(2, 2), padding=torch_pad(3),
                     use_bias=False)
    w = _conv(conv_t.weight.detach().numpy())
    got = conv_f.apply({"params": {"kernel": jnp.asarray(w)}},
                       jnp.asarray(_to_nhwc(x)))
    np.testing.assert_allclose(_from_nhwc(got), want, atol=ATOL)


def test_depthwise_same_padding_even_input(rng):
    """TF-style SAME (asymmetric 0/1 pad) for stride-2 depthwise conv: torch
    twin uses explicit asymmetric ZeroPad2d like the reference trunk."""
    C, k, s = 6, 3, 2
    x = rng.normal(size=(1, C, 16, 24)).astype(np.float32)
    conv_t = tnn.Conv2d(C, C, k, stride=s, groups=C, bias=False)
    pad = tnn.ZeroPad2d((0, 1, 0, 1))  # left 0, right 1 (static SAME, even in)
    with torch.no_grad():
        want = conv_t(pad(torch.from_numpy(x))).numpy()

    from flax import linen as nn
    conv_f = nn.Conv(C, (k, k), strides=(s, s), padding="SAME",
                     feature_group_count=C, use_bias=False)
    w = _depthwise(conv_t.weight.detach().numpy())
    got = conv_f.apply({"params": {"kernel": jnp.asarray(w)}},
                       jnp.asarray(_to_nhwc(x)))
    np.testing.assert_allclose(_from_nhwc(got), want, atol=ATOL)


def _make_bn_stats(rng, C):
    return (rng.normal(size=C).astype(np.float32),           # scale
            rng.normal(size=C).astype(np.float32),           # bias
            rng.normal(size=C).astype(np.float32),           # mean
            rng.uniform(0.5, 2.0, size=C).astype(np.float32))  # var


def test_batchnorm_eval_parity(rng):
    C = 5
    x = rng.normal(size=(2, C, 4, 6)).astype(np.float32)
    scale, bias, mean, var = _make_bn_stats(rng, C)
    bn_t = tnn.BatchNorm2d(C, eps=1e-5)
    with torch.no_grad():
        bn_t.weight.copy_(torch.from_numpy(scale))
        bn_t.bias.copy_(torch.from_numpy(bias))
        bn_t.running_mean.copy_(torch.from_numpy(mean))
        bn_t.running_var.copy_(torch.from_numpy(var))
        bn_t.eval()
        want = bn_t(torch.from_numpy(x)).numpy()

    from flax import linen as nn
    bn_f = nn.BatchNorm(use_running_average=True, epsilon=1e-5, momentum=0.9)
    got = bn_f.apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}},
        jnp.asarray(_to_nhwc(x)))
    np.testing.assert_allclose(_from_nhwc(got), want, atol=ATOL)


class _TorchUp(tnn.Module):
    """The reference Up block built from torch primitives
    (reference src/models.py:15-34)."""

    def __init__(self, cin, cout, scale):
        super().__init__()
        self.up = tnn.Upsample(scale_factor=scale, mode="bilinear",
                               align_corners=True)
        self.conv = tnn.Sequential(
            tnn.Conv2d(cin, cout, 3, padding=1, bias=False),
            tnn.BatchNorm2d(cout), tnn.ReLU(inplace=True),
            tnn.Conv2d(cout, cout, 3, padding=1, bias=False),
            tnn.BatchNorm2d(cout), tnn.ReLU(inplace=True))

    def forward(self, x1, x2):
        x1 = self.up(x1)
        return self.conv(torch.cat([x2, x1], dim=1))


def _transplant_convbn(params, stats, conv_t, bn_t, rng):
    """Randomize a torch conv+bn pair and mirror into flax param dicts."""
    with torch.no_grad():
        bn_t.weight.copy_(torch.from_numpy(
            rng.normal(size=bn_t.weight.shape).astype(np.float32)))
        bn_t.bias.copy_(torch.from_numpy(
            rng.normal(size=bn_t.bias.shape).astype(np.float32)))
        bn_t.running_mean.copy_(torch.from_numpy(
            rng.normal(size=bn_t.running_mean.shape).astype(np.float32)))
        bn_t.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2.0, size=bn_t.running_var.shape)
            .astype(np.float32)))
    params["Conv_0"] = {"kernel": jnp.asarray(_conv(
        conv_t.weight.detach().numpy()))}
    params["BatchNorm_0"] = {
        "scale": jnp.asarray(bn_t.weight.detach().numpy()),
        "bias": jnp.asarray(bn_t.bias.detach().numpy())}
    stats["BatchNorm_0"] = {
        "mean": jnp.asarray(bn_t.running_mean.numpy()),
        "var": jnp.asarray(bn_t.running_var.numpy())}


def test_up_block_parity(rng):
    cin_skip, cin_up, cout, scale = 5, 7, 6, 2
    t = _TorchUp(cin_skip + cin_up, cout, scale)
    x1 = rng.normal(size=(1, cin_up, 4, 6)).astype(np.float32)
    x2 = rng.normal(size=(1, cin_skip, 8, 12)).astype(np.float32)

    params = {"ConvBNReLU_0": {}, "ConvBNReLU_1": {}}
    stats = {"ConvBNReLU_0": {}, "ConvBNReLU_1": {}}
    _transplant_convbn(params["ConvBNReLU_0"], stats["ConvBNReLU_0"],
                       t.conv[0], t.conv[1], rng)
    _transplant_convbn(params["ConvBNReLU_1"], stats["ConvBNReLU_1"],
                       t.conv[3], t.conv[4], rng)
    with torch.no_grad():
        t.eval()
        want = t(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()

    up_f = Up(cout, scale=scale)
    got = up_f.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(_to_nhwc(x1)), jnp.asarray(_to_nhwc(x2)),
                     False)
    np.testing.assert_allclose(_from_nhwc(got), want, atol=5e-5)


def test_basicblock_strided_parity(rng):
    cin, cout, stride = 4, 8, 2
    from torch_twin import TorchBasic
    t = TorchBasic(cin, cout, stride)
    x = rng.normal(size=(2, cin, 10, 14)).astype(np.float32)

    params, stats = {}, {}
    _transplant_convbn(params, stats, t.conv1, t.bn1, rng)
    # second conv/bn under flax auto-names Conv_1/BatchNorm_1
    tmp_p, tmp_s = {}, {}
    _transplant_convbn(tmp_p, tmp_s, t.conv2, t.bn2, rng)
    params["Conv_1"] = tmp_p["Conv_0"]
    params["BatchNorm_1"] = tmp_p["BatchNorm_0"]
    stats["BatchNorm_1"] = tmp_s["BatchNorm_0"]
    tmp_p, tmp_s = {}, {}
    _transplant_convbn(tmp_p, tmp_s, t.downsample[0], t.downsample[1], rng)
    params["downsample_conv"] = tmp_p["Conv_0"]
    params["downsample_bn"] = tmp_p["BatchNorm_0"]
    stats["downsample_bn"] = tmp_s["BatchNorm_0"]

    with torch.no_grad():
        t.eval()
        want = t(torch.from_numpy(x)).numpy()

    blk = BasicBlock(cout, stride=stride)
    got = blk.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(_to_nhwc(x)), False)
    np.testing.assert_allclose(_from_nhwc(got), want, atol=5e-5)
