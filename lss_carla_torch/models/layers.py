"""Shared building blocks (counterpart of ``lss_carla_tpu/models/layers.py``).

NCHW, torch idiom. Names follow the reference state dict: ``Up`` holds its
convs in ``conv`` (``conv.0``/``conv.1``/``conv.3``/``conv.4``), and
``ConvBNReLU`` is a ``Sequential`` that splices into a parent
``Sequential`` (``*ConvBNReLU(...)``) so the parent's indices stay the
reference's. Convolutions use symmetric ``k//2`` padding; BN is
``BatchNorm2d`` below at torch's default eps 1e-5 and momentum 0.1.

Compute dtype: every layer computes in its input's dtype, as a flax module
built with ``dtype=`` does. ``Conv2d`` casts its f32 weight and bias to the
input's dtype; ``BatchNorm2d`` takes a bf16 input with f32 affine
parameters and running stats and returns bf16, its batch moments in f32.
Parameters and running stats stay f32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lss_carla_torch.ops.image import upsample_align_corners

# channel dropout: zeroes whole feature maps in training, identity in eval
Dropout2d = nn.Dropout2d

# > 0 while ``remat`` recomputes a checkpointed forward in the backward
_RECOMPUTING = [0]


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTING[0] += 1
    try:
        yield
    finally:
        _RECOMPUTING[0] -= 1


def remat(fn, *args):
    """``fn(*args)`` with its activations rematerialised: nothing inside is
    kept for the backward but ``args``; the backward runs ``fn`` again
    (``torch.utils.checkpoint``, non-reentrant, with the CPU and CUDA
    random states of the first run, so dropout draws the same masks). The
    second run updates no BN running stats and records no moments
    (``BatchNorm2d.update_running_stats``), as flax's ``nn.remat`` updates
    them once."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing()))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the f32 weight and bias are cast
    to it (flax's ``nn.Conv(dtype=...)``). Same state-dict names."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class SyncBatchNormFn(torch.autograd.Function):
    """Train-mode BN over the batches of every rank in ``group`` together,
    with a gradient; the ranks may hold different numbers of values (a
    grid rank's slab may be empty).

    Forward: one all-reduce of the count and the sum gives the mean; a
    second, of the centred sum of squares, gives the biased variance (two
    passes, no cancellation). Backward: one all-reduce of the packed
    sums of dy and dy * x_hat; the weight and bias gradients stay this
    rank's own parts, which the step's gradient all-reduce sums. Computes
    in f32 and returns x's dtype, with the global (mean, var) beside it
    for the running stats. ``torch.nn.SyncBatchNorm`` does not serve: it
    refuses CPU tensors and keeps the unbiased variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        xf = x.to(torch.float32)
        part = torch.cat([xf.sum((0, 2, 3)),
                          xf.new_full((1,), float(xf.numel() // C))])
        dist.all_reduce(part, group=group)
        count = part[C]
        mean = part[:C] / count
        var = (xf - mean[:, None, None]).square().sum((0, 2, 3))
        dist.all_reduce(var, group=group)
        var = var / count
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        # centred first, as F.batch_norm: folding the mean into a shift
        # (x * scale + (bias - mean * scale)) cancels where |mean| >> std
        y = ((xf - mean[:, None, None]) * (weight * invstd)[:, None, None]
             + bias[:, None, None])
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, count = ctx.saved_tensors
        C = x.shape[1]
        dyf = dy.to(torch.float32)
        xhat = (x.to(torch.float32) - mean[:, None, None]) * invstd[:, None, None]
        local = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        dweight, dbias = local[C:].clone(), local[:C].clone()
        dist.all_reduce(local, group=ctx.group)
        mdy, mdyx = local[:C] / count, local[C:] / count
        dx = (weight * invstd)[:, None, None] * (
            dyf - mdy[:, None, None] - xhat * mdyx[:, None, None])
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax.

    Train mode normalises with the biased batch variance, as torch does,
    but torch stores the unbiased one (n / (n - 1) times larger) in
    ``running_var``; flax, and so the JAX package, stores the biased one.
    This class stores the biased variance, with flax's update
    ``running = (1 - m) * running + m * batch`` at torch's momentum m.
    Eval mode and the state-dict names are torch's.

    Every train-mode batch moment reaches the running stats through
    ``update_running_stats``, the fused MBConv path's too. While
    ``moments`` is a list (``training/bn_recal.py`` sets it), that method
    appends each batch's (mean, var) there and leaves the running stats
    alone. While ``group`` is set (a process group: the grid-parallel step,
    a recalibration across ranks), a train-mode forward normalises with the
    moments of all the group's ranks' values together, count-weighted, as
    sync-BN does (``SyncBatchNormFn``, with its gradient). The fused MBConv
    path hands its ``bn1.group`` to ``ops/mbconv.py::fused_dw_bn_swish``,
    which combines the kernel's sums the same way."""

    moments = None
    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            y, mean, var = SyncBatchNormFn.apply(x, self.weight, self.bias,
                                                 self.eps, self.group)
            self.update_running_stats(mean, var)
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3),
                                       correction=0)
        self.update_running_stats(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor):
        """Fold one batch's mean and biased variance into the running
        stats (or record them, see the class note); nothing while
        ``remat`` recomputes a forward."""
        if _RECOMPUTING[0]:
            return
        if self.moments is not None:
            self.moments.append((mean.detach(), var.detach()))
            return
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        self.num_batches_tracked.add_(1)


@contextlib.contextmanager
def batch_norm_group(model: nn.Module, group):
    """Within the ``with``, every ``BatchNorm2d`` of ``model`` normalises
    in train mode over ``group``'s ranks together (``BatchNorm2d.group``)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for bn in bns:
        bn.group = group
    try:
        yield
    finally:
        for bn in bns:
            bn.group = None


class ConvBNReLU(nn.Sequential):
    """conv(kxk, no bias, padding k//2) + BN + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__(
            Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                   bias=False),
            BatchNorm2d(cout, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True))


class Upsample(nn.Module):
    """Bilinear align_corners=True upsample by an integer factor."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return upsample_align_corners(x, self.scale)


class Up(nn.Module):
    """Upsample-and-fuse block (reference ``src/models.py:15-34``):
    upsample x1 by ``scale``, concat [x2, x1] on channels (skip first),
    then two ConvBNReLUs to ``cout``."""

    def __init__(self, cin: int, cout: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = nn.Sequential(*ConvBNReLU(cin, cout),
                                  *ConvBNReLU(cout, cout))

    def forward(self, x1, x2):
        x1 = upsample_align_corners(x1, self.scale)
        return self.conv(torch.cat([x2, x1], dim=1))


class BasicBlock(nn.Module):
    """torchvision resnet BasicBlock; ``init_weights`` zeroes bn2's scale
    (zero-init residual, reference models.py:96)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride=stride, bias=False),
                BatchNorm2d(cout))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation drawn from ``generator`` only.

    Bias-free convs: kaiming normal, fan_out (the JAX package's
    ``kaiming_out``). Convs with a bias (SE, depthnet, head): lecun normal
    (flax's default) and zero bias. BN: scale 1, shift 0, except the
    zero-init residual ``BasicBlock.bn2``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                if m.bias is None:
                    nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                            nonlinearity="relu",
                                            generator=generator)
                else:
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()
        for m in module.modules():
            if isinstance(m, BasicBlock):
                m.bn2.weight.zero_()
