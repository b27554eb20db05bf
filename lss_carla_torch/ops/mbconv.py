"""Depthwise conv + BN batch moments (+ BN and swish): counterpart of
``lss_carla_tpu/ops/mbconv_pallas.py``.

``dw_conv_stats(x, w, stride)`` computes, in one pass, a k x k depthwise
conv with XLA "SAME" padding (k 3 or 5, stride 1 or 2) and the
per-channel f32 sum and sum of squares of its output over N*Ho*Wo: the
batch moments training-mode BN needs. It is what every MBConv block's
depthwise conv runs in train mode with ``fused_dw``.

It is the ``lss::dw_conv_stats`` operator (``ops/library.py``), whose
dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the hand-written kernel (``ops/mbconv_cuda.py``,
``csrc/dw_conv_stats.cu``) or raises, a CPU tensor takes the plain version
``dw_conv_stats_reference``. The backward is plain torch on both, as the
JAX package runs XLA's conv transposes outside its Pallas kernel: the sum
and sum-of-squares cotangents fold into the output's (d sum / d y = 1,
d sumsq / d y = 2y), then ``aten.convolution_backward`` on the padded x.

Layout is the port's NCHW, with the weight as the port's
``_depthwise_conv.weight`` (C, 1, k, k).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from lss_carla_torch.ops import library
from lss_carla_torch.ops.library import (  # noqa: F401
    dw_conv_stats_reference, same_pad)


def dw_conv_stats(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """Depthwise conv (SAME padding) + per-channel batch sum and sum of
    squares. x (N, C, H, W), w (C, 1, k, k). Returns (y (N, C, Ho, Wo) in
    x's dtype, sum (C,) f32, sumsq (C,) f32). Differentiable."""
    return library.dw_conv_stats(x, w, int(stride))


def batch_moments(s: torch.Tensor, ss: torch.Tensor, count: int):
    """(mean, biased var) from the sums, in f32, as the JAX package takes
    them: var = max(E[y^2] - mean^2, 0). This cancels badly where
    |mean| >> std; kept for parity with the reference."""
    mean = s / count
    return mean, torch.clamp(ss / count - mean * mean, min=0.0)


def bn_swish(y, mean, var, gamma, beta, eps: float):
    """Training-mode BN from precomputed moments, then swish, in f32;
    returns y's dtype. z = y * scale + (beta - mean * scale) with
    scale = gamma * rsqrt(var + eps), as the JAX MBConv block computes it."""
    scale = gamma * torch.rsqrt(var + eps)
    shift = beta - mean * scale
    z = y.to(torch.float32) * scale[:, None, None] + shift[:, None, None]
    return F.silu(z).to(y.dtype)


def fused_dw_bn_swish(x, w, gamma, beta, stride: int = 1, eps: float = 1e-3,
                      group=None):
    """swish(BN_train(dwconv(x))) with the conv and its moments in one
    pass. Returns (out, mean, var): mean and the biased var, so a caller
    can update BN running stats as flax does. ``group`` (a process group;
    no gradient flows through it, as in a recalibration) makes the moments
    those of all its ranks' values together: one all-reduce of the sums
    and the count."""
    y, s, ss = dw_conv_stats(x, w, stride)
    count = y.shape[0] * y.shape[2] * y.shape[3]
    if group is not None:
        C = s.shape[0]
        part = torch.cat([s, ss, s.new_full((1,), float(count))])
        dist.all_reduce(part, group=group)
        s, ss, count = part[:C], part[C:2 * C], part[2 * C]
    mean, var = batch_moments(s, ss, count)
    return bn_swish(y, mean, var, gamma, beta, eps), mean, var


def xla_dw_bn_swish(x, w, gamma, beta, stride: int = 1, eps: float = 1e-3):
    """The plain composition (the JAX name kept): grouped conv on the SAME
    padded input, then the moments, then BN and swish."""
    C, k = x.shape[1], w.shape[-1]
    y = F.conv2d(same_pad(x, k, stride), w.to(x.dtype).reshape(C, 1, k, k),
                 stride=stride, groups=C)
    yf = y.to(torch.float32)
    mean = yf.mean((0, 2, 3))
    var = torch.clamp((yf * yf).mean((0, 2, 3)) - mean * mean, min=0.0)
    z = ((yf - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
         * gamma[:, None, None] + beta[:, None, None])
    return F.silu(z).to(x.dtype), mean, var
