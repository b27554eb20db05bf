"""BEV encoder: ResNet-18-style trunk + upsampling decoder.

Counterpart of ``lss_carla_tpu/models/bevencode.py`` (reference
``src/models.py:92-130``):

* conv7x7 stride 2 (inC -> 64) + BN + ReLU;
* resnet18 layer1 (2x BasicBlock 64), layer2 (2x 128, stride 2),
  layer3 (2x 256, stride 2) with zero-init residual BN;
* ``Up(64+256, 256, scale=4)`` skip fuse from layer1;
* Dropout2d(0.1);
* ``up2``: upsample x2 (align_corners) + conv3x3(128) + BN + ReLU +
  conv1x1(outC) head.

Takes the splat's channels-last (B, X, Y, inC) and runs NCHW with X as H
and Y as W; returns (B, X, Y, outC) like the JAX module. Everything up to
the head runs in ``compute_dtype``; the head and the logits are f32.
"""

from __future__ import annotations

import torch
from torch import nn

from lss_carla_torch.models.layers import (
    BasicBlock, BatchNorm2d, Conv2d, ConvBNReLU, Dropout2d, Up, Upsample)


class BevEncode(nn.Module):
    def __init__(self, inC: int, outC: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(inC, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.up1 = Up(64 + 256, 256, scale=4)
        self.dropout = Dropout2d(0.1)
        self.up2 = nn.Sequential(Upsample(2), *ConvBNReLU(256, 128),
                                 nn.Conv2d(128, outC, 1))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)  # (B, inC, X, Y)
        x = self.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x)
        x = self.layer3(self.layer2(x1))
        x = self.dropout(self.up1(x, x1))
        *up2, head = self.up2
        for layer in up2:
            x = layer(x)
        return head(x.to(torch.float32)).permute(0, 2, 3, 1)
