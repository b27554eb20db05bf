"""LiftSplatShoot: the camera-to-BEV model as one ``nn.Module``.

Counterpart of ``lss_carla_tpu/models/lss.py`` (reference
``src/models.py:133-263``): CamEncode -> frustum geometry -> fixed-shape
splat -> BevEncode. The public ``forward`` takes the reference's image
layout ``(B, N, 3, H, W)`` (f32, or uint8 normalised on the device) and
returns logits ``(B, outC, X, Y)``.

``splat_method`` is kept for config parity with the JAX package. Every
method runs the same splat: the hand-written CUDA kernel on a CUDA tensor,
the plain ``splat_reference`` on a CPU tensor. ``fused_dw`` runs every
MBConv block's depthwise conv and BN moments in one pass in train mode
(``ops/mbconv.py``); it changes no parameter.

``compute_dtype`` ("float32" or "bfloat16", the JAX model's field) is the
dtype of the convolutions, BN outputs, activations, the lift and the splat;
parameters, BN running stats, the depth softmax, the BEV head and the
logits stay f32. The model casts explicitly (no autocast), so the splat and
depthwise kernels get bf16 tensors on the bf16 path, on the CPU and the
card alike.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.bevencode import BevEncode
from lss_carla_torch.models.camencode import CamEncode
from lss_carla_torch.models.layers import init_weights
from lss_carla_torch.ops.geometry import create_frustum, gen_dx_bx, get_geometry
from lss_carla_torch.ops.image import normalize_uint8
from lss_carla_torch.ops.splat import METHODS, voxel_pooling
from lss_carla_torch.utils.backend import resolve_device

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LiftSplatShoot(nn.Module):
    def __init__(self, grid_conf: GridConf, data_aug_conf: DataAugConf,
                 outC: int = 1, camC: int = 64, downsample: int = 16,
                 variant: str = "b0", splat_method: str = "scatter",
                 fused_dw: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        if splat_method not in METHODS:
            raise ValueError(f"unknown splat method: {splat_method}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: "
                             f"{' or '.join(COMPUTE_DTYPES)}")
        self.grid_conf, self.data_aug_conf = grid_conf, data_aug_conf
        self.outC, self.camC, self.downsample = outC, camC, downsample
        self.variant, self.splat_method = variant, splat_method
        self.fused_dw, self.compute_dtype = fused_dw, compute_dtype
        dtype = COMPUTE_DTYPES[compute_dtype]
        self.dx, self.bx, self.nx = gen_dx_bx(
            grid_conf.xbound, grid_conf.ybound, grid_conf.zbound)
        frustum = create_frustum(data_aug_conf.final_dim, downsample,
                                 grid_conf.dbound)
        # not in the state dict: rebuilt from the config
        self.register_buffer("frustum", torch.from_numpy(frustum.copy()),
                             persistent=False)
        self.D = frustum.shape[0]
        self.camencode = CamEncode(self.D, camC, variant, fused_dw, dtype)
        self.bevencode = BevEncode(int(self.nx[2]) * camC, outC, dtype)

    def config(self) -> dict:
        """Constructor arguments, as plain data (for artifacts)."""
        return {"grid_conf": self.grid_conf.to_dict(),
                "data_aug_conf": self.data_aug_conf.to_dict(),
                "outC": self.outC, "camC": self.camC,
                "downsample": self.downsample, "variant": self.variant,
                "splat_method": self.splat_method, "fused_dw": self.fused_dw,
                "compute_dtype": self.compute_dtype}

    def get_geometry(self, rots, trans, intrins, post_rots, post_trans):
        return get_geometry(self.frustum, rots, trans, intrins, post_rots,
                            post_trans)

    def get_cam_feats(self, x):
        """x (B, N, 3, H, W) -> (B, N, D, fH, fW, camC) lifted features.

        uint8 images are ImageNet-normalised here, in f32 on the device: 4x
        less host->device traffic than shipping f32. The trunk casts the
        images to the compute dtype."""
        B, N = x.shape[:2]
        x = x.reshape(B * N, *x.shape[2:])
        x = normalize_uint8(x) if x.dtype == torch.uint8 else x
        lifted, _ = self.camencode(x)  # (BN, D, fH, fW, camC)
        return lifted.view(B, N, *lifted.shape[1:])

    def get_voxels(self, x, rots, trans, intrins, post_rots, post_trans):
        geom = self.get_geometry(rots, trans, intrins, post_rots, post_trans)
        feats = self.get_cam_feats(x)
        return voxel_pooling(geom, feats, self.dx, self.bx, self.nx,
                             method=self.splat_method)  # (B, X, Y, nz*camC)

    def decode_bev(self, bev):
        """(B, X, Y, nz*camC) pooled BEV -> (B, outC, X, Y) logits. Kept
        apart from the lift so camera-parallel modes can sum partial BEVs
        between ``get_voxels`` and the decode."""
        return self.bevencode(bev).permute(0, 3, 1, 2)

    def forward(self, x, rots, trans, intrins, post_rots, post_trans):
        bev = self.get_voxels(x, rots, trans, intrins, post_rots, post_trans)
        return self.decode_bev(bev)


def compile_model(grid_conf, data_aug_conf, outC: int = 1, device="cuda",
                  generator: Optional[torch.Generator] = None,
                  **kwargs) -> LiftSplatShoot:
    """Reference-parity constructor (``src/models.py:262-263``).

    Accepts the dataclass configs or the reference's plain dicts. Weights
    are drawn from ``generator`` (a fresh one seeded 0 by default) on the
    CPU, then the model moves to ``device``: ``cuda`` unless the caller
    asks for ``cpu``; no GPU raises."""
    dev = resolve_device(device)
    if not isinstance(grid_conf, GridConf):
        grid_conf = GridConf.from_dict(grid_conf)
    if not isinstance(data_aug_conf, DataAugConf):
        data_aug_conf = DataAugConf.from_dict(data_aug_conf)
    model = LiftSplatShoot(grid_conf, data_aug_conf, outC=outC, **kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(dev)
