"""Fixed-shape splat (voxel pooling): counterpart of ``lss_carla_tpu/ops/splat.py``.

Every frustum point is kept (static shape ``B x N*D*fH*fW``); points outside
the grid get the sentinel id ``nz*X*Y`` and are dropped by the sum. The
forward sums point features per voxel; the backward gathers the output
cotangent at each point's voxel, with 0 at the sentinel, as the reference's
``QuickCumsum.backward`` does (reference ``src/tools.py:211-219``).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the hand-written kernel (``ops/splat_cuda.py``) or raises, a CPU tensor
takes the plain version ``splat_reference``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lss_carla_torch.ops import splat_cuda

# the JAX package's method names; all of them run the same splat here
METHODS = ("scatter", "sorted", "pallas")


def voxel_indices(geom: torch.Tensor, dx, bx, nx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (..., 3) ego-frame points to flat voxel ids.

    Returns (flat_id, valid): int32 ids in [0, nz*X*Y) for in-grid points
    and the sentinel nz*X*Y for the rest, laid out as ((z*X)+x)*Y+y.
    Quantisation truncates toward zero like torch ``.long()`` (reference
    ``models.py:212``), so points marginally below the lower bound that
    truncate to 0 are kept. A NaN coordinate quantises to 0 and +-inf out
    of range, as XLA's conversion does in the JAX package; PyTorch's own
    float->int cast of NaN differs between the CPU and the GPU.
    """
    dx = torch.as_tensor(dx, dtype=geom.dtype, device=geom.device)
    bx = torch.as_tensor(bx, dtype=geom.dtype, device=geom.device)
    X, Y, Z = (int(v) for v in nx)
    q = torch.nan_to_num((geom - (bx - dx / 2.0)) / dx, nan=0.0,
                         posinf=2.0 ** 31, neginf=-2.0 ** 31)
    vox = q.clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int32)
    ix, iy, iz = vox.unbind(-1)
    valid = ((ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
             & (iz >= 0) & (iz < Z))
    flat = (iz * X + ix) * Y + iy
    sentinel = torch.full_like(flat, Z * X * Y)
    return torch.where(valid, flat, sentinel), valid


def splat_reference(pts: torch.Tensor, ids: torch.Tensor,
                    num_slots: int) -> torch.Tensor:
    """Plain version of the kernel: (B, P, C) + (B, P) ids -> (B, S, C).

    ``index_add_`` into a (B*(S+1), C) f32 buffer, with every id outside
    [0, S) sent to each item's sentinel row S, which is then dropped.
    Returns the input dtype."""
    B, P, C = pts.shape
    S = int(num_slots)
    ids = ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < S), ids, torch.full_like(ids, S))
    rows = ids + torch.arange(B, device=ids.device)[:, None] * (S + 1)
    buf = torch.zeros((B * (S + 1), C), dtype=torch.float32, device=pts.device)
    buf.index_add_(0, rows.reshape(-1), pts.reshape(B * P, C).to(torch.float32))
    return buf.view(B, S + 1, C)[:, :S].to(pts.dtype)


def _gather_cotangent(g: torch.Tensor, ids: torch.Tensor,
                      num_slots: int) -> torch.Tensor:
    """(B, S, C) cotangent -> (B, P, C): g at each point's id, 0 where the
    id is the sentinel (or otherwise outside [0, S))."""
    valid = (ids >= 0) & (ids < num_slots)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).to(torch.int64)
    C = g.shape[-1]
    d = torch.gather(g, 1, safe[..., None].expand(-1, -1, C))
    return torch.where(valid[..., None], d, torch.zeros_like(d))


class Splat(torch.autograd.Function):
    """Sum per voxel; the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor. The backward is a gather in plain torch, as the JAX
    package computes it in XLA outside its Pallas kernel."""

    @staticmethod
    def forward(ctx, pts, ids, num_slots):
        ctx.save_for_backward(ids)
        ctx.num_slots = int(num_slots)
        if pts.is_cuda:
            return splat_cuda.splat_forward(pts, ids, num_slots)
        return splat_reference(pts, ids, num_slots)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _gather_cotangent(g, ids, ctx.num_slots), None, None


def splat(pts: torch.Tensor, ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(B, P, C) points, (B, P) int32 ids -> (B, num_slots, C) sums."""
    return Splat.apply(pts, ids, num_slots)


def voxel_pooling(geom: torch.Tensor, feats: torch.Tensor, dx, bx, nx,
                  method: str = "scatter") -> torch.Tensor:
    """Splat lifted camera features onto the BEV grid.

    geom (B, N, D, fH, fW, 3) ego-frame points, feats (B, N, D, fH, fW, C).
    Returns (B, X, Y, nz*C), channels last, z-major ([z0: C][z1: C]...).
    ``method`` keeps the JAX package's names ("scatter", "sorted",
    "pallas"); every one of them runs ``splat``: the CUDA kernel on a CUDA
    tensor, ``splat_reference`` on a CPU tensor.
    """
    if method not in METHODS:
        raise ValueError(f"unknown splat method: {method}")
    B, N, D, fH, fW, C = feats.shape
    X, Y, nz = int(nx[0]), int(nx[1]), int(nx[2])
    flat, _ = voxel_indices(geom, dx, bx, nx)
    out = splat(feats.reshape(B, -1, C).contiguous(),
                flat.reshape(B, -1).contiguous(), nz * X * Y)
    out = out.view(B, nz, X, Y, C)
    # collapse Z into channels, z-major, channels-last
    return out.permute(0, 2, 3, 1, 4).reshape(B, X, Y, nz * C)
