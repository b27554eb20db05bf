"""EfficientNet trunk (B0..B4, slim) with the LSS endpoint harvest.

Counterpart of ``lss_carla_tpu/models/efficientnet.py``; module names follow
``efficientnet_pytorch`` (``_conv_stem``, ``_bn0``, ``_blocks.i._depthwise_conv``
...), the naming of the reference checkpoint. NCHW.

* "SAME" padding as XLA computes it, which is asymmetric: the low side gets
  ``total // 2``. It is applied with an explicit ``F.pad`` from the input's
  shape at run time, on the stem and on every depthwise conv.
* BN eps 1e-3 and torch momentum 0.01; running variances are biased, as
  flax keeps them (``layers.BatchNorm2d``).
* ``fused_dw``: in train mode each block's depthwise conv and its BN batch
  moments run in one pass (``ops/mbconv.py::dw_conv_stats``, the CUDA
  kernel on the card), with the same parameters and buffers, so one state
  dict serves both paths. Eval mode ignores it.
* SE squeezes to ``int(cin * 0.25)`` channels of the block's input filters;
  its convs have a bias.
* The residual applies only when ``stride == 1 and cin == cout``;
  drop-connect ``rate * idx / len(plan)`` only in training mode.
* ``compute_dtype``: the trunk casts its input to it at entry, and every
  layer after follows its input's dtype (``layers.Conv2d``,
  ``layers.BatchNorm2d``); parameters and running stats stay f32. The fused
  path rounds the depthwise kernel to the compute dtype, takes BN and swish
  in f32 and returns the compute dtype, as the JAX block does.

Endpoints are recorded like the reference harvest loop
(``models.py:72-82``): whenever a block reduces spatial size, the input to
that block is the next ``reduction_k``; the last block's output closes the
list. The classifier head is omitted, as the reference never runs it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from lss_carla_torch.models.layers import BatchNorm2d, Conv2d
from lss_carla_torch.ops.mbconv import fused_dw_bn_swish, same_pad

# (expand_ratio, kernel, stride, in_filters, out_filters, num_repeats)
_B0_BLOCKS = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)
_SE_RATIO = 0.25

# (width_coefficient, depth_coefficient, dropout) per variant
VARIANTS = {
    "b0": (1.0, 1.0, 0.2),
    "b1": (1.0, 1.1, 0.2),
    "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3),
    "b4": (1.4, 1.8, 0.4),
    # test-only: minimum-width single-repeat trunk with b0's stage, stride
    # and endpoint structure
    "slim": (0.1, 0.1, 0.2),
}

_BN_MOMENTUM = 0.01  # torch convention (flax 0.99)
_BN_EPS = 1e-3


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding (paper Appendix; divisor 8)."""
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_plan(variant: str) -> List[dict]:
    """Flattened per-block arguments after width/depth scaling."""
    width, depth, _ = VARIANTS[variant]
    plan = []
    for expand, k, s, cin, cout, reps in _B0_BLOCKS:
        cin_s = round_filters(cin, width)
        cout_s = round_filters(cout, width)
        for r in range(round_repeats(reps, depth)):
            plan.append(dict(
                expand=expand, kernel=k,
                stride=s if r == 0 else 1,
                cin=cin_s if r == 0 else cout_s,
                cout=cout_s,
            ))
    return plan


def endpoint_channels(variant: str) -> Dict[str, int]:
    """Channel counts of each harvested endpoint (for wiring decoders)."""
    width, _, _ = VARIANTS[variant]
    chans = {}
    k = 0
    prev_c = round_filters(32, width)  # stem output
    for args in block_plan(variant):
        if args["stride"] > 1:
            k += 1
            chans[f"reduction_{k}"] = prev_c
        prev_c = args["cout"]
    chans[f"reduction_{k + 1}"] = prev_c
    return chans


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=_BN_EPS, momentum=_BN_MOMENTUM)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation and drop-connect."""

    def __init__(self, expand: int, kernel: int, stride: int, cin: int,
                 cout: int, drop_connect_rate: float = 0.0,
                 fused_dw: bool = False):
        super().__init__()
        mid = cin * expand
        self.expand, self.kernel, self.stride = expand, kernel, stride
        self.id_skip = stride == 1 and cin == cout
        self.drop_connect_rate = drop_connect_rate
        self.fused_dw = fused_dw
        if expand != 1:
            self._expand_conv = Conv2d(cin, mid, 1, bias=False)
            self._bn0 = _bn(mid)
        self._depthwise_conv = Conv2d(mid, mid, kernel, stride=stride,
                                      groups=mid, bias=False)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(cin * _SE_RATIO))
        self._se_reduce = Conv2d(mid, se_ch, 1)
        self._se_expand = Conv2d(se_ch, mid, 1)
        self._project_conv = Conv2d(mid, cout, 1, bias=False)
        self._bn2 = _bn(cout)

    def forward(self, x):
        inputs = x
        if self.expand != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        if self.fused_dw and self.training:
            # the conv and its batch moments in one pass; BN from the moments
            # (in a recalibration across ranks, ``bn.group`` set, the global
            # batch's). The kernel takes contiguous NCHW (a channels-last
            # input, e.g. from images stacked as HWC views, is copied once
            # here)
            bn = self._bn1
            x, mean, var = fused_dw_bn_swish(
                x.contiguous(), self._depthwise_conv.weight, bn.weight,
                bn.bias, self.stride, bn.eps, bn.group)
            bn.update_running_stats(mean, var)
        else:
            x = self._depthwise_conv(same_pad(x, self.kernel, self.stride))
            x = F.silu(self._bn1(x))
        se = x.mean((2, 3), keepdim=True)
        se = self._se_expand(F.silu(self._se_reduce(se)))
        x = torch.sigmoid(se) * x
        x = self._bn2(self._project_conv(x))
        if self.id_skip:
            if self.training and self.drop_connect_rate > 0:
                # drop the whole residual branch per sample with prob `rate`
                keep = 1.0 - self.drop_connect_rate
                mask = torch.floor(keep + torch.rand(
                    (x.shape[0], 1, 1, 1), dtype=x.dtype, device=x.device))
                x = x / keep * mask
            x = x + inputs
        return x


class EfficientNetTrunk(nn.Module):
    """Stem + MBConv blocks + endpoint harvest (no classifier head)."""

    def __init__(self, variant: str = "b0", drop_connect_rate: float = 0.2,
                 fused_dw: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        width, _, _ = VARIANTS[variant]
        stem_ch = round_filters(32, width)
        self._conv_stem = Conv2d(3, stem_ch, 3, stride=2, bias=False)
        self._bn0 = _bn(stem_ch)
        plan = block_plan(variant)
        self._blocks = nn.ModuleList(
            MBConvBlock(**args,
                        drop_connect_rate=drop_connect_rate * idx / len(plan),
                        fused_dw=fused_dw)
            for idx, args in enumerate(plan))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: (N, 3, H, W) -> {"reduction_k": (N, C_k, H_k, W_k)}, in the
        compute dtype."""
        x = x.to(self.compute_dtype)
        x = F.silu(self._bn0(self._conv_stem(same_pad(x, 3, 2))))
        endpoints: Dict[str, torch.Tensor] = {}
        prev = x
        for block in self._blocks:
            x = block(x)
            if prev.shape[2] > x.shape[2]:
                endpoints[f"reduction_{len(endpoints) + 1}"] = prev
            prev = x
        endpoints[f"reduction_{len(endpoints) + 1}"] = x
        return endpoints
