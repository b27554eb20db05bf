"""Image-space ops (counterpart of ``lss_carla_tpu/ops/image.py``).

ImageNet normalisation of uint8 images, on the device (``normalize_uint8``)
or on the host (``normalize_img``, numpy), and the align_corners=True
bilinear upsample of the reference's ``Up`` blocks
(reference ``src/models.py:19-20,108-110``). The JAX package writes the
upsample as two interpolation matmuls; ``F.interpolate(mode="bilinear",
align_corners=True)`` computes the same function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics (reference tools.py:160-171)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_img(img_u8: np.ndarray) -> np.ndarray:
    """uint8 (..., H, W, 3) -> f32 ImageNet-normalised, channels last, on
    the host (the loader's ``device_normalize=False`` path)."""
    x = np.asarray(img_u8, dtype=np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3, H, W) images -> f32 ImageNet-normalised, channels
    first (reference ToTensor + Normalize, tools.py:167-171)."""
    shape = (3, 1, 1)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).view(shape)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).view(shape)
    return (x.to(torch.float32) / 255.0 - mean) / std


def upsample_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-scale bilinear align_corners=True upsample of NCHW ``x``."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)
