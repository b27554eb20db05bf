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

import torch
import torch.nn.functional as F
from torch import nn

from lss_carla_torch.ops.image import upsample_align_corners

# channel dropout: zeroes whole feature maps in training, identity in eval
Dropout2d = nn.Dropout2d


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the f32 weight and bias are cast
    to it (flax's ``nn.Conv(dtype=...)``). Same state-dict names."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


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
    alone. While ``sync`` is set too (a recalibration across ranks), a
    train-mode forward normalises with the moments of the ranks' batches
    together, as sync-BN does: ``sync(tensors)`` replaces each tensor, in
    place, by its mean over the ranks. The fused MBConv path hands its
    ``bn1.sync`` to ``ops/mbconv.py::fused_dw_bn_swish``, which averages
    the kernel's sums the same way."""

    moments = None
    sync = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sync is not None:
            return self._synced(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3),
                                       correction=0)
        self.update_running_stats(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    @torch.no_grad()
    def _synced(self, x):
        """Train-mode BN over the ranks' batches together (equal batches):
        the mean of their means, then of their mean squared deviations
        from it (two passes, no cancellation)."""
        xf = x.to(torch.float32)
        mean = xf.mean((0, 2, 3))
        self.sync([mean])
        var = (xf - mean[:, None, None]).square().mean((0, 2, 3))
        self.sync([var])
        self.update_running_stats(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = xf * scale[:, None, None] + (self.bias - mean * scale)[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor):
        """Fold one batch's mean and biased variance into the running
        stats (or record them, see the class note)."""
        if self.moments is not None:
            self.moments.append((mean.detach(), var.detach()))
            return
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        self.num_batches_tracked.add_(1)


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
