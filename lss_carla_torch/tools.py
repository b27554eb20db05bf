"""The reference's ``src/tools.py`` symbol surface: counterpart of
``lss_carla_tpu/tools.py``.

Users of the reference import these names from ``src.tools``:

    gen_dx_bx, get_rot, img_transform, normalize_img, denormalize_img,
    ego_to_cam, cam_to_ego, get_only_in_img_mask,
    SimpleLoss, get_batch_iou, get_val_info, add_ego,
    get_nusc_maps, get_local_map, plot_nusc_map, get_lidar_data,
    cumsum_trick, quick_cumsum

The reference's cumsum machinery (``cumsum_trick``/``QuickCumsum``) sums
point features per voxel with a gather backward; here both names are
``splat_scatter_add``, the JAX package's signature on the port's splat
(the CUDA kernel on a CUDA tensor). The nuScenes symbols are the
devkit-free ones of ``data/nusc_maps.py`` and ``data/nuscenes.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from lss_carla_torch.data.augment import img_transform as _img_transform
from lss_carla_torch.data.nusc_maps import (  # noqa: F401
    get_local_map, get_nusc_maps, plot_nusc_map)
from lss_carla_torch.data.nuscenes import get_lidar_data  # noqa: F401
from lss_carla_torch.ops.geometry import (  # noqa: F401
    cam_to_ego, ego_to_cam, gen_dx_bx, get_only_in_img_mask, get_rot)
from lss_carla_torch.ops.image import (  # noqa: F401
    denormalize_img, normalize_img)
from lss_carla_torch.ops.splat import splat
from lss_carla_torch.training.loop import get_val_info  # noqa: F401
from lss_carla_torch.training.loss import (  # noqa: F401
    SimpleLoss, get_batch_iou)


def splat_scatter_add(feats: torch.Tensor, ids: torch.Tensor,
                      num_slots: int) -> torch.Tensor:
    """(P, C) features and (P,) voxel ids -> (num_slots, C) per-voxel sums
    in ``feats``' dtype; ids outside [0, num_slots) are dropped. The
    backward gathers the cotangent at each id (0 where dropped)."""
    return splat(feats[None].contiguous(), ids.to(torch.int32)[None].contiguous(),
                 num_slots)[0]


# the splat is the reference's QuickCumsum replacement
cumsum_trick = splat_scatter_add
quick_cumsum = splat_scatter_add


def img_transform(img, post_rot, post_tran, resize, resize_dims, crop,
                  flip, rotate):
    """The reference signature (``tools.py:120-144``): applies the
    augmentation and composes its homography onto the incoming
    (post_rot, post_tran)."""
    img, A, b = _img_transform(img, resize, resize_dims, crop, flip, rotate)
    post_rot = np.asarray(A) @ np.asarray(post_rot)
    post_tran = np.asarray(A) @ np.asarray(post_tran) + np.asarray(b)
    return img, post_rot, post_tran


def add_ego(bx, dx):
    """Draw the ego-vehicle box on the current matplotlib axes, in grid
    cells (reference ``tools.py:273-284``)."""
    import matplotlib.pyplot as plt
    W = 1.85
    pts = np.array([
        [-4.084 / 2. + 0.5, W / 2.],
        [4.084 / 2. + 0.5, W / 2.],
        [4.084 / 2. + 0.5, -W / 2.],
        [-4.084 / 2. + 0.5, -W / 2.],
    ])
    pts = (pts - bx[:2]) / dx[:2]
    pts[:, [0, 1]] = pts[:, [1, 0]]
    plt.fill(pts[:, 0], pts[:, 1], '#76b900')
