"""Image-space ops (counterpart of ``lss_carla_tpu/ops/image.py``).

ImageNet normalisation of uint8 images, on the device (``normalize_uint8``)
or on the host (``normalize_img``, numpy), its inverse for display
(``denormalize_img``, numpy), and the align_corners=True
bilinear upsample of the reference's ``Up`` blocks
(reference ``src/models.py:19-20,108-110``). The JAX package writes the
upsample as two interpolation matmuls; ``F.interpolate(mode="bilinear",
align_corners=True)`` computes the same function.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def denormalize_img(x: np.ndarray) -> np.ndarray:
    """Inverse of ``normalize_img``, clipped to [0, 1] (reference
    ``tools.py:147-164``), channels last."""
    return np.clip(np.asarray(x) * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


def imagenet_stats() -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet's mean and std as (3, 1, 1) f32 CPU tensors, for a module
    to hold as buffers (``models/lss.py``)."""
    return tuple(torch.from_numpy(v.copy()).view(3, 1, 1)
                 for v in (IMAGENET_MEAN, IMAGENET_STD))


def normalize_uint8(x: torch.Tensor, mean: Optional[torch.Tensor] = None,
                    std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 (..., 3, H, W) images -> f32 ImageNet-normalised, channels
    first (reference ToTensor + Normalize, tools.py:167-171). ``mean`` and
    ``std``, (3, 1, 1) f32 on x's device, are ``imagenet_stats()`` as a
    model holds them, so that the call copies nothing from the host (a
    CUDA graph's capture refuses such a copy); without them they are made
    here."""
    if mean is None or std is None:
        mean, std = (t.to(x.device) for t in imagenet_stats())
    return (x.to(torch.float32) / 255.0 - mean) / std


def upsample_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-scale bilinear align_corners=True upsample of NCHW ``x``."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)
