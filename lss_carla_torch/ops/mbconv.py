"""Depthwise conv + BN batch moments (+ BN and swish): counterpart of
``lss_carla_tpu/ops/mbconv_pallas.py``.

``dw_conv_stats(x, w, stride)`` computes, in one pass, a k x k depthwise
conv with XLA "SAME" padding (k 3 or 5, stride 1 or 2) and the
per-channel f32 sum and sum of squares of its output over N*Ho*Wo: the
batch moments training-mode BN needs. It is what every MBConv block's
depthwise conv runs in train mode with ``fused_dw``.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
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
import torch.nn.functional as F

from lss_carla_torch.ops import mbconv_cuda
from lss_carla_torch.ops.mbconv_cuda import same_pad_amounts


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA "SAME" padding of NCHW ``x`` for a k x k conv at stride s: the
    output has ceil(n / s) rows, and the low side gets ``total // 2``."""
    pw, ph = same_pad_amounts(x.shape[-1], k, s), same_pad_amounts(x.shape[-2], k, s)
    return F.pad(x, (*pw, *ph))  # F.pad order: W first, then H


def dw_conv_stats_reference(x: torch.Tensor, w: torch.Tensor, stride: int):
    """Plain version of the kernel: cuDNN's (or the CPU's) grouped conv in
    f32 on the padded input, then the moments of its f32 output; y is
    rounded to x's dtype last. Weights are rounded to x's dtype first."""
    C, k = x.shape[1], w.shape[-1]
    y32 = F.conv2d(same_pad(x.to(torch.float32), k, stride),
                   w.to(x.dtype).to(torch.float32).reshape(C, 1, k, k),
                   stride=stride, groups=C)
    return (y32.to(x.dtype), y32.sum((0, 2, 3)),
            (y32 * y32).sum((0, 2, 3)))


class DWConvStats(torch.autograd.Function):
    """(y, sum, sumsq) of the depthwise conv; the kernel on a CUDA tensor,
    the plain version on a CPU tensor. Saves x, w and y (as JAX does)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        if x.is_cuda:
            y, s, ss = mbconv_cuda.dw_conv_stats_forward(x, w, stride)
        else:
            y, s, ss = dw_conv_stats_reference(x, w, stride)
        ctx.save_for_backward(x, w, y)
        ctx.stride = stride
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        x, w, y = ctx.saved_tensors
        s, (C, H, W), k = ctx.stride, x.shape[1:], w.shape[-1]
        shape = (1, C, 1, 1)
        dy_total = (dy.to(torch.float32) + dsum.view(shape)
                    + 2.0 * y.to(torch.float32) * dsumsq.view(shape)).to(x.dtype)
        dxp, dw, _ = torch.ops.aten.convolution_backward(
            dy_total, same_pad(x, k, s), w.to(x.dtype).reshape(C, 1, k, k),
            None, [s, s], [0, 0], [1, 1], False, [0, 0], C,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        dx = None
        if dxp is not None:
            top, left = same_pad_amounts(H, k, s)[0], same_pad_amounts(W, k, s)[0]
            dx = dxp[:, :, top:top + H, left:left + W]
        if dw is not None:
            dw = dw.reshape(w.shape).to(w.dtype)
        return dx, dw, None


def dw_conv_stats(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """Depthwise conv (SAME padding) + per-channel batch sum and sum of
    squares. x (N, C, H, W), w (C, 1, k, k). Returns (y (N, C, Ho, Wo) in
    x's dtype, sum (C,) f32, sumsq (C,) f32). Differentiable."""
    return DWConvStats.apply(x, w, stride)


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
                      sync=None):
    """swish(BN_train(dwconv(x))) with the conv and its moments in one
    pass. Returns (out, mean, var): mean and the biased var, so a caller
    can update BN running stats as flax does. ``sync`` (a callable that
    replaces a list of tensors, in place, by their means over the ranks,
    whose batches are equal) makes the moments the ranks' batches'
    together, as sync-BN does."""
    y, s, ss = dw_conv_stats(x, w, stride)
    if sync is not None:
        sync([s, ss])
    mean, var = batch_moments(s, ss, y.shape[0] * y.shape[2] * y.shape[3])
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
