"""Camera encoder: EfficientNet trunk + FPN fuse + depth-softmax lift.

Counterpart of ``lss_carla_tpu/models/camencode.py`` (reference
``src/models.py:37-89``):

* trunk endpoints reduction_5 (stride 32) and reduction_4 (stride 16) fused
  by ``Up(.., 512)``, skip first;
* Dropout(0.2), then a 1x1 ``depthnet`` conv with bias producing D + C
  channels;
* softmax over the D depth channels, in f32;
* outer product depth x features -> per-pixel (D, C) frustum features.

Takes NCHW images; returns the lift channels-last, (B*N, D, fH, fW, C), the
layout the splat reads.
"""

from __future__ import annotations

import torch
from torch import nn

from lss_carla_torch.models.efficientnet import EfficientNetTrunk, endpoint_channels
from lss_carla_torch.models.layers import Up


class CamEncode(nn.Module):
    def __init__(self, D: int, C: int, variant: str = "b0",
                 fused_dw: bool = False):
        super().__init__()
        self.D, self.C = D, C
        self.trunk = EfficientNetTrunk(variant, fused_dw=fused_dw)
        ch = endpoint_channels(variant)
        self.up1 = Up(ch["reduction_5"] + ch["reduction_4"], 512)
        self.dropout = nn.Dropout(0.2)
        self.depthnet = nn.Conv2d(512, D + C, 1)

    def forward(self, x):
        """x (B*N, 3, H, W) -> lifted (B*N, D, fH, fW, C), depth (B*N, D, fH, fW)."""
        endpoints = self.trunk(x)
        x = self.up1(endpoints["reduction_5"], endpoints["reduction_4"])
        x = self.depthnet(self.dropout(x))
        depth = torch.softmax(x[:, :self.D].to(torch.float32), dim=1)
        feats = x[:, self.D:self.D + self.C].permute(0, 2, 3, 1)  # (BN, fH, fW, C)
        lifted = depth[..., None].to(feats.dtype) * feats[:, None]
        return lifted, depth
