"""The port's two kernels as registered operators: ``lss::splat`` and
``lss::dw_conv_stats`` (``torch.library.custom_op``).

Each operator has four parts:

* its CUDA implementation: the hand-written kernel through its ctypes
  wrapper (``ops/splat_cuda.py``, ``ops/mbconv_cuda.py``), which counts
  its launches;
* its CPU implementation: the plain PyTorch version (``splat_reference``,
  ``dw_conv_stats_reference``);
* a fake implementation (``register_fake``) giving the outputs' shapes
  and dtypes, so ``torch.export`` and other tracers never call the kernel
  on a fake tensor;
* its backward (``register_autograd``), in plain torch on both devices, as
  the JAX package computes its kernels' backward in XLA: the splat's is a
  gather, the depthwise conv's a conv transpose.

A tensor on any other device has no implementation and raises. The model
(``ops/splat.py::splat``, ``ops/mbconv.py::dw_conv_stats``), the trainer,
and a program exported by ``serving.py`` all reach the kernels through
these operators, so one route serves training, serving and export.
Loading an exported program needs this module and what it imports (the
ops and their ctypes wrappers), never ``models/``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lss_carla_torch.ops import mbconv_cuda, splat_cuda
from lss_carla_torch.ops.mbconv_cuda import same_pad_amounts

Tensor = torch.Tensor


# --- the splat -------------------------------------------------------------

def splat_reference(pts: Tensor, ids: Tensor, num_slots: int) -> Tensor:
    """Plain version of the kernel: (B, P, C) + (B, P) ids -> (B, S, C).

    ``index_add_`` into a (B*(S+1), C) f32 buffer, with every id outside
    [0, S) sent to each item's sentinel row S, which is then dropped.
    Returns the input dtype, contiguous."""
    B, P, C = pts.shape
    S = int(num_slots)
    ids = ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < S), ids, torch.full_like(ids, S))
    rows = ids + torch.arange(B, device=ids.device)[:, None] * (S + 1)
    buf = torch.zeros((B * (S + 1), C), dtype=torch.float32, device=pts.device)
    buf.index_add_(0, rows.reshape(-1), pts.reshape(B * P, C).to(torch.float32))
    return buf.view(B, S + 1, C)[:, :S].to(pts.dtype).contiguous()


def gather_cotangent(g: Tensor, ids: Tensor, num_slots: int) -> Tensor:
    """(B, S, C) cotangent -> (B, P, C): g at each point's id, 0 where the
    id is the sentinel (or otherwise outside [0, S))."""
    valid = (ids >= 0) & (ids < num_slots)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).to(torch.int64)
    C = g.shape[-1]
    d = torch.gather(g, 1, safe[..., None].expand(-1, -1, C))
    return torch.where(valid[..., None], d, torch.zeros_like(d))


@torch.library.custom_op("lss::splat", mutates_args=(), device_types="cpu")
def splat(pts: Tensor, ids: Tensor, num_slots: int) -> Tensor:
    """(B, P, C) f32/bf16 points, (B, P) int32 ids -> (B, num_slots, C)
    sums per id; ids outside [0, num_slots) are dropped."""
    return splat_reference(pts, ids, num_slots)


@splat.register_kernel("cuda")
def _splat_cuda(pts, ids, num_slots):
    return splat_cuda.splat_forward(pts, ids, num_slots)


@splat.register_fake
def _splat_fake(pts, ids, num_slots):
    return pts.new_empty((pts.shape[0], num_slots, pts.shape[2]))


def _splat_setup(ctx, inputs, output):
    _, ids, num_slots = inputs
    ctx.save_for_backward(ids)
    ctx.num_slots = num_slots


def _splat_backward(ctx, g):
    (ids,) = ctx.saved_tensors
    return gather_cotangent(g, ids, ctx.num_slots), None, None


splat.register_autograd(_splat_backward, setup_context=_splat_setup)


# --- the depthwise conv + BN moments ---------------------------------------

def same_pad(x: Tensor, k: int, s: int) -> Tensor:
    """XLA "SAME" padding of NCHW ``x`` for a k x k conv at stride s: the
    output has ceil(n / s) rows, and the low side gets ``total // 2``."""
    pw, ph = same_pad_amounts(x.shape[-1], k, s), same_pad_amounts(x.shape[-2], k, s)
    return F.pad(x, (*pw, *ph))  # F.pad order: W first, then H


def dw_conv_stats_reference(x: Tensor, w: Tensor, stride: int):
    """Plain version of the kernel: cuDNN's (or the CPU's) grouped conv in
    f32 on the padded input, then the moments of its f32 output; y is
    rounded to x's dtype last. Weights are rounded to x's dtype first."""
    C, k = x.shape[1], w.shape[-1]
    y32 = F.conv2d(same_pad(x.to(torch.float32), k, stride),
                   w.to(x.dtype).to(torch.float32).reshape(C, 1, k, k),
                   stride=stride, groups=C)
    return (y32.to(x.dtype), y32.sum((0, 2, 3)),
            (y32 * y32).sum((0, 2, 3)))


@torch.library.custom_op("lss::dw_conv_stats", mutates_args=(),
                         device_types="cpu")
def dw_conv_stats(x: Tensor, w: Tensor, stride: int
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """x (N, C, H, W) f32/bf16, w (C, 1, k, k) -> (y (N, C, Ho, Wo) in x's
    dtype, sum (C,) f32, sumsq (C,) f32), SAME padding, Ho = ceil(H/s)."""
    return dw_conv_stats_reference(x, w, stride)


@dw_conv_stats.register_kernel("cuda")
def _dw_conv_stats_cuda(x, w, stride):
    return mbconv_cuda.dw_conv_stats_forward(x.contiguous(), w, stride)


@dw_conv_stats.register_fake
def _dw_conv_stats_fake(x, w, stride):
    N, C, H, W = x.shape
    y = x.new_empty((N, C, (H + stride - 1) // stride,
                     (W + stride - 1) // stride))
    return (y, x.new_empty((C,), dtype=torch.float32),
            x.new_empty((C,), dtype=torch.float32))


def _dw_setup(ctx, inputs, output):
    x, w, stride = inputs
    ctx.save_for_backward(x, w, output[0])
    ctx.stride = stride


def _dw_backward(ctx, dy, dsum, dsumsq):
    """The sum and sum-of-squares cotangents fold into the output's
    (d sum / d y = 1, d sumsq / d y = 2y), then
    ``aten.convolution_backward`` on the padded x."""
    x, w, y = ctx.saved_tensors
    s, (C, H, W), k = ctx.stride, x.shape[1:], w.shape[-1]
    shape = (1, C, 1, 1)
    dy_total = dy.to(torch.float32)
    if dsum is not None:
        dy_total = dy_total + dsum.view(shape)
    if dsumsq is not None:
        dy_total = dy_total + 2.0 * y.to(torch.float32) * dsumsq.view(shape)
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        dy_total.to(x.dtype), same_pad(x, k, s),
        w.to(x.dtype).reshape(C, 1, k, k), None, [s, s], [0, 0], [1, 1],
        False, [0, 0], C,
        [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
    dx = None
    if dxp is not None:
        top, left = same_pad_amounts(H, k, s)[0], same_pad_amounts(W, k, s)[0]
        dx = dxp[:, :, top:top + H, left:left + W]
    if dw is not None:
        dw = dw.reshape(w.shape).to(w.dtype)
    return dx, dw, None


dw_conv_stats.register_autograd(_dw_backward, setup_context=_dw_setup)
