"""Camera encoder: EfficientNet or ResNet trunk + FPN fuse + depth-softmax lift.

Counterpart of ``lss_carla_tpu/models/camencode.py`` (reference
``src/models.py:37-89``):

* trunk endpoints reduction_5 (stride 32) and reduction_4 (stride 16) fused
  by ``Up(.., 512)``, skip first; the trunk is EfficientNet b0-b4 (``slim``
  for tests) or, for a ``variant`` starting "resnet", ``ResNetTrunk``
  (``up1`` then takes 512 + 256 channels; ``fused_dw`` is ignored, as in
  the JAX package);
* Dropout(0.2), then a 1x1 ``depthnet`` conv with bias producing D + C
  channels;
* softmax over the D depth channels, in f32, cast back to the compute
  dtype;
* outer product depth x features -> per-pixel (D, C) frustum features.

Everything but the softmax runs in ``compute_dtype`` (f32 or bf16), which
the trunk casts its input to.

Takes NCHW images; returns the lift channels-last, (B*N, D, fH, fW, C), the
layout the splat reads.
"""

from __future__ import annotations

import torch
from torch import nn

from lss_carla_torch.models import efficientnet, resnet
from lss_carla_torch.models.layers import Conv2d, Up


class CamEncode(nn.Module):
    def __init__(self, D: int, C: int, variant: str = "b0",
                 fused_dw: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.D, self.C = D, C
        if variant.startswith("resnet"):
            self.trunk = resnet.ResNetTrunk(variant, compute_dtype=compute_dtype)
            ch = resnet.endpoint_channels(variant)
        else:
            self.trunk = efficientnet.EfficientNetTrunk(
                variant, fused_dw=fused_dw, compute_dtype=compute_dtype)
            ch = efficientnet.endpoint_channels(variant)  # B4: 448 + 160
        self.up1 = Up(ch["reduction_5"] + ch["reduction_4"], 512)
        self.dropout = nn.Dropout(0.2)
        self.depthnet = Conv2d(512, D + C, 1)

    def forward(self, x):
        """x (B*N, 3, H, W) -> lifted (B*N, D, fH, fW, C), depth (B*N, D, fH, fW)."""
        endpoints = self.trunk(x)
        x = self.up1(endpoints["reduction_5"], endpoints["reduction_4"])
        x = self.depthnet(self.dropout(x))
        depth = torch.softmax(x[:, :self.D].to(torch.float32), dim=1).to(x.dtype)
        feats = x[:, self.D:self.D + self.C].permute(0, 2, 3, 1)  # (BN, fH, fW, C)
        lifted = depth[..., None] * feats[:, None]
        return lifted, depth
