"""Frustum and camera geometry (counterpart of ``lss_carla_tpu/ops/geometry.py``).

``gen_dx_bx``, ``create_frustum`` and ``get_rot`` are host-side numpy,
copied from the JAX package. ``get_geometry`` runs on tensors, always in
f32, on whatever device its inputs are on; ``ego_to_cam``, ``cam_to_ego``
and ``get_only_in_img_mask`` project single cameras' point clouds, on
tensors (``explore.lidar_check``, ``tools.py``).

Coordinate conventions (reference + SimBEV): frustum cells hold
(pixel_x, pixel_y, depth_m) in final (post-augmentation) image coordinates;
``rots``/``trans`` are the SimBEV "ego->cam" extrinsics used as-is in the
cam->ego composition ``rots @ inv(intrins) @ pix * depth + trans``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gen_dx_bx(xbound, ybound, zbound) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Voxel size, first-voxel center, and grid dims from bound triples
    (reference ``src/tools.py:174-179``)."""
    bounds = (xbound, ybound, zbound)
    dx = np.array([row[2] for row in bounds], dtype=np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in bounds], dtype=np.float32)
    # int() truncation == torch.LongTensor semantics
    nx = np.array([int((row[1] - row[0]) / row[2]) for row in bounds], dtype=np.int32)
    return dx, bx, nx


def create_frustum(final_dim: Tuple[int, int], downsample: int,
                   dbound) -> np.ndarray:
    """Static (D, fH, fW, 3) frustum of (pixel-x, pixel-y, depth) per cell
    (reference ``src/models.py:157-168``)."""
    ogfH, ogfW = final_dim
    fH, fW = ogfH // downsample, ogfW // downsample
    ds = np.arange(dbound[0], dbound[1], dbound[2], dtype=np.float32)
    D = ds.shape[0]
    ds = np.broadcast_to(ds.reshape(-1, 1, 1), (D, fH, fW))
    xs = np.broadcast_to(
        np.linspace(0, ogfW - 1, fW, dtype=np.float32).reshape(1, 1, fW), (D, fH, fW))
    ys = np.broadcast_to(
        np.linspace(0, ogfH - 1, fH, dtype=np.float32).reshape(1, fH, 1), (D, fH, fW))
    return np.stack((xs, ys, ds), axis=-1)


def get_geometry(frustum: torch.Tensor, rots: torch.Tensor, trans: torch.Tensor,
                 intrins: torch.Tensor, post_rots: torch.Tensor,
                 post_trans: torch.Tensor) -> torch.Tensor:
    """Ego-frame (x, y, z) for every frustum cell.

    frustum (D, fH, fW, 3); rots, intrins, post_rots (B, N, 3, 3); trans,
    post_trans (B, N, 3). Returns (B, N, D, fH, fW, 3) in f32.

    The inverses use ``torch.linalg.inv_ex``: ``torch.linalg.inv`` checks
    for singular matrices and so synchronises with the host on every call.
    A singular matrix gives non-finite points, as ``jnp.linalg.inv`` does in
    the JAX package, and ``voxel_indices`` quantises them as it does there.
    """
    f32 = torch.float32
    frustum, rots, trans, intrins, post_rots, post_trans = (
        t.to(f32) for t in (frustum, rots, trans, intrins, post_rots, post_trans))

    # undo the per-image augmentation: p = inv(post_rot) @ (frustum - post_tran)
    points = frustum[None, None] - post_trans[:, :, None, None, None, :]
    inv_post = torch.linalg.inv_ex(post_rots).inverse
    points = torch.einsum("bnij,bndhwj->bndhwi", inv_post, points)

    # cam -> ego: scale pixel coords by depth, then rots @ inv(intrins)
    points = torch.cat([points[..., :2] * points[..., 2:3], points[..., 2:3]],
                       dim=-1)
    combine = rots @ torch.linalg.inv_ex(intrins).inverse
    points = torch.einsum("bnij,bndhwj->bndhwi", combine, points)
    return points + trans[:, :, None, None, None, :]


def get_rot(h) -> np.ndarray:
    """2x2 rotation used by the augmentation homography (reference
    ``tools.py:113-117``)."""
    return np.array([
        [np.cos(h), np.sin(h)],
        [-np.sin(h), np.cos(h)],
    ], dtype=np.float32)


def ego_to_cam(points: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor,
               intrins: torch.Tensor) -> torch.Tensor:
    """Project (3, N) ego-frame points into pinhole pixels (reference
    ``tools.py:80-89``): rows (u, v, depth)."""
    points = rot.T @ (points - trans[:, None])
    points = intrins @ points
    return torch.cat([points[:2] / points[2:3], points[2:3]], dim=0)


def cam_to_ego(points: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor,
               intrins: torch.Tensor) -> torch.Tensor:
    """Lift (3, N) pixel + depth points to the ego frame (reference
    ``tools.py:92-102``)."""
    points = torch.cat([points[:2] * points[2:3], points[2:3]], dim=0)
    points = torch.linalg.inv(intrins) @ points
    return rot @ points + trans[:, None]


def get_only_in_img_mask(pts: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Mask of projected (3, N) points that fall inside an H x W image
    (reference ``tools.py:105-110``)."""
    return ((pts[2] > 0)
            & (pts[0] > 1) & (pts[0] < W - 1)
            & (pts[1] > 1) & (pts[1] < H - 1))
