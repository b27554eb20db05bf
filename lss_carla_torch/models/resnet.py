"""ResNet-18/34 camera trunk: counterpart of ``lss_carla_tpu/models/resnet.py``.

The torchvision resnet18/34 topology (conv 7x7/2, max-pool 3/2, four
stages of ``layers.BasicBlock``), with torchvision's module names
(``conv1``, ``bn1``, ``layer{1..4}.{r}.{conv1, bn1, conv2, bn2,
downsample.0, downsample.1}``), the naming the port's ``BasicBlock``
already follows. BN is ``layers.BatchNorm2d`` at eps 1e-5 and torch
momentum 0.1 (flax 0.9), biased running variances, as the JAX trunk keeps
them; ``init_weights`` zero-inits each block's ``bn2``.

Endpoints match ``EfficientNetTrunk``'s contract: ``reduction_4`` is the
stride-16 map (layer3, 256 channels) and ``reduction_5`` the stride-32 map
(layer4, 512 channels), so ``CamEncode``'s ``Up`` fuse and depth head are
reused. ``compute_dtype``: the trunk casts its input to it and every layer
follows its input's dtype. Select with ``variant="resnet18"`` or
``"resnet34"``. ResNet has no depthwise conv, so ``fused_dw`` does not
apply and a ResNet model launches no ``dw_conv_stats``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from lss_carla_torch.models.layers import BasicBlock, BatchNorm2d, Conv2d

# stage widths are fixed across resnet18/34; only the block counts differ
_STAGE_FEATURES = (64, 128, 256, 512)
RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
}


def endpoint_channels(variant: str) -> Dict[str, int]:
    """Channel counts of the harvested endpoints (for wiring decoders)."""
    del variant
    return {"reduction_4": 256, "reduction_5": 512}


class ResNetTrunk(nn.Module):
    """conv 7x7/2 + max-pool + layer1..4, harvesting the stride-16/32 maps."""

    def __init__(self, variant: str = "resnet18",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in RESNET_LAYERS:
            raise ValueError(f"unknown resnet variant {variant!r} "
                             f"({' or '.join(RESNET_LAYERS)})")
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, (feats, reps) in enumerate(zip(_STAGE_FEATURES,
                                                  RESNET_LAYERS[variant])):
            blocks = []
            for r in range(reps):
                stride = 2 if (stage > 0 and r == 0) else 1
                blocks.append(BasicBlock(cin, feats, stride))
                cin = feats
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: (N, 3, H, W) -> {"reduction_4": (N, 256, H/16, W/16),
        "reduction_5": (N, 512, H/32, W/32)}, in the compute dtype."""
        x = x.to(self.compute_dtype)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer2(self.layer1(x))
        r4 = self.layer3(x)
        return {"reduction_4": r4, "reduction_5": self.layer4(r4)}
