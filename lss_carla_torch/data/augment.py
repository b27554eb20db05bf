"""Image augmentation with exact homography tracking: the port's own copy
of ``lss_carla_tpu/data/augment.py`` (numpy + PIL).

The 2D affine (post_rot, post_tran) is kept in lockstep with the PIL
resize/crop/flip/rotate, so the model can undo the augmentation in its
geometry (reference ``src/tools.py:113-144``, ``src/data_simbev.py:119-145``).
The random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image


def get_rot2d(h: float) -> np.ndarray:
    return np.array([
        [np.cos(h), np.sin(h)],
        [-np.sin(h), np.cos(h)],
    ], dtype=np.float64)


def post_homography(resize: float, crop: Tuple[int, int, int, int],
                    flip: bool, rotate: float):
    """The 2D affine (post_rot, post_tran) matching resize/crop/flip/rotate:
    a source pixel p lands at ``post_rot @ p + post_tran`` in the output."""
    post_rot = np.eye(2, dtype=np.float64) * resize
    post_tran = -np.asarray(crop[:2], dtype=np.float64)
    crop_w = crop[2] - crop[0]
    crop_h = crop[3] - crop[1]
    if flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([crop_w, 0.0])
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = get_rot2d(rotate / 180.0 * np.pi)
    b = np.array([crop_w, crop_h], dtype=np.float64) / 2.0
    b = A @ (-b) + b
    post_rot = A @ post_rot
    post_tran = A @ post_tran + b
    return post_rot.astype(np.float32), post_tran.astype(np.float32)


def img_transform(img: Image.Image, resize: float,
                  resize_dims: Tuple[int, int], crop: Tuple[int, int, int, int],
                  flip: bool, rotate: float):
    """Apply resize/crop/flip/rotate; return (img, post_rot2, post_tran2)."""
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate)
    post_rot, post_tran = post_homography(resize, crop, flip, rotate)
    return img, post_rot, post_tran


def uniform(generator: torch.Generator, lo: float, hi: float) -> float:
    """One draw from U[lo, hi) (lo when the interval is empty)."""
    u = torch.rand((), generator=generator, dtype=torch.float64).item()
    return float(lo) + (float(hi) - float(lo)) * u


def sample_augmentation(data_aug_conf, is_train: bool,
                        generator: Optional[torch.Generator] = None):
    """One set of augmentation parameters, shared by all cameras of a
    sample (reference ``data_simbev.py:119-145,166-168``).

    Train: a random resize within resize_lim, a random bottom crop within
    bot_pct_lim, a random horizontal slide, an optional flip and a random
    rotation, drawn from ``generator``. Val: the deterministic
    ``resize = max(fH/H, fW/W)`` and a centre crop."""
    H, W = data_aug_conf.H, data_aug_conf.W
    fH, fW = data_aug_conf.final_dim
    if is_train:
        if generator is None:
            raise ValueError("train-time augmentation draws from a "
                             "torch.Generator; pass one")
        resize = uniform(generator, *data_aug_conf.resize_lim)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - uniform(generator, *data_aug_conf.bot_pct_lim))
                     * newH) - fH
        crop_w = int(uniform(generator, 0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(data_aug_conf.rand_flip and torch.randint(
            2, (), generator=generator).item())
        rotate = uniform(generator, *data_aug_conf.rot_lim)
    else:
        resize = max(fH / H, fW / W)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(data_aug_conf.bot_pct_lim)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False
        rotate = 0.0
    return resize, resize_dims, crop, flip, rotate
