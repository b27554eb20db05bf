"""Frustum and camera geometry (counterpart of ``lss_carla_tpu/ops/geometry.py``).

``gen_dx_bx`` and ``create_frustum`` are host-side numpy, copied from the
JAX package. ``get_geometry`` runs on tensors, always in f32, on whatever
device its inputs are on.

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
