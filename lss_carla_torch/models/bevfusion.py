"""BEVFusion's camera-only BEV map segmentation (Liu et al., "BEVFusion:
Multi-Task Multi-Sensor Fusion with Unified Bird's-Eye View
Representation", ICRA 2023; github.com/mit-han-lab/bevfusion,
``configs/nuscenes/seg/camera-bev256d2.yaml``) as one ``nn.Module`` beside
``LiftSplatShoot``, with its ``forward(x, rots, trans, intrins, post_rots,
post_trans)`` and logits (B, classes, X, Y), so the port's train step, its
loader's batches and the benchmark's drivers take either.

* ``backbone``: Swin-T (``models/swin.py``), stages 1-3 out.
* ``neck``: ``GeneralizedLSSFPN``: from the coarsest level down, the level
  below upsampled (bilinear, align_corners False) to the next one's size,
  concatenated after it, a 1 x 1 and a 3 x 3 conv-BN-ReLU to 256; the
  stride-8 level is the lift's input.
* ``vtransform``: ``LSSTransform``: a 1 x 1 ``depthnet`` with bias to D + C
  (D 118 bins from 1 to 60 m by 0.5, C 80), the softmax over depth, the
  outer product, and the port's geometry (``ops/geometry.py``) and splat
  (``ops/splat.py::voxel_pooling``, the hand-written kernel on the card),
  unchanged; then its ``downsample``: three 3 x 3 conv-BN-ReLU, the second
  with stride 2.
* ``decoder``: ``GeneralizedResNet`` (BasicBlocks [[2, 128, 2], [2, 256,
  2], [2, 512, 1]]) and ``LSSFPN`` (the last level upsampled, align_corners
  True, to the first's size and concatenated before it, a 1 x 1 and a
  3 x 3 conv-BN-ReLU to 256, then a x2 upsample and a 3 x 3 conv-BN-ReLU).
* ``head``: ``BEVSegmentationHead``: ``BEVGridTransform`` (bilinear
  ``grid_sample``, align_corners False, from the decoder's grid onto the
  output grid: +-51.2 m at 0.8 m onto +-50 m at 0.5 m), two 3 x 3
  conv-BN-ReLU and a 1 x 1 conv with bias to the classes.

Its loss is BEVFusion's sigmoid focal loss (``loss``, which
``training/step.py::make_train_step`` reads). ``compute_dtype`` works as
in ``LiftSplatShoot``: the convolutions, the attention, the lift and the
splat run in it by explicit casts; the parameters, the BN statistics, the
LayerNorm statistics, the depth softmax, the attention softmax's sums, the
grid resampling (its coordinates stay exact) and the logits are f32.

The forward emits the spans ``lss.bevfusion.trunk`` (normalisation and
Swin), ``.neck``, ``.lift`` (depth net, lift, geometry and splat), ``.bev``
(downsample and decoder) and ``.head``; like every span of
``utils/trace.py`` they record only while a profiler records, and a replay
of the train step's CUDA graph runs none of them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.layers import (BasicBlock, BatchNorm2d, Conv2d,
                                           ConvBNReLU, Upsample)
from lss_carla_torch.models.lss import COMPUTE_DTYPES
from lss_carla_torch.models.swin import LayerNorm, Linear, SwinTransformer, WindowMSA
from lss_carla_torch.ops.geometry import create_frustum, gen_dx_bx, get_geometry
from lss_carla_torch.ops.image import imagenet_stats, normalize_uint8
from lss_carla_torch.ops.splat import voxel_pooling
from lss_carla_torch.utils.backend import resolve_device
from lss_carla_torch.utils.trace import span

# nuScenes map classes in BEVFusion's order
MAP_CLASSES = ("drivable_area", "ped_crossing", "walkway", "stop_line",
               "carpark_area", "divider")


class ConvModule(nn.Module):
    """mmcv's ``ConvModule``: conv without bias, BN, ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class GeneralizedLSSFPN(nn.Module):
    def __init__(self, in_channels=(192, 384, 768), out: int = 256):
        super().__init__()
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i] + (in_channels[i + 1] if i == n - 2 else out), out, 1)
            for i in range(n - 1))
        self.fpn_convs = nn.ModuleList(ConvModule(out, out, 3) for _ in range(n - 1))

    def forward(self, feats):
        x = list(feats)
        for i in range(len(x) - 2, -1, -1):
            up = F.interpolate(x[i + 1], size=x[i].shape[2:], mode="bilinear",
                               align_corners=False)
            x[i] = self.fpn_convs[i](self.lateral_convs[i](torch.cat([x[i], up], 1)))
        return x[0]


class LSSTransform(nn.Module):
    """The lift (depth net, depth softmax, outer product) and the BEV
    downsample; the geometry and the splat between them run in
    ``BEVFusionSeg.forward``."""

    def __init__(self, D: int, C: int, cin: int = 256):
        super().__init__()
        self.D, self.C = D, C
        self.depthnet = Conv2d(cin, D + C, 1)
        self.downsample = nn.Sequential(*ConvBNReLU(C, C), *ConvBNReLU(C, C, 3, 2),
                                        *ConvBNReLU(C, C))

    def lift(self, x):
        """(BN, cin, fH, fW) -> (BN, D, fH, fW, C), channels last."""
        x = self.depthnet(x)
        depth = torch.softmax(x[:, :self.D].to(torch.float32), dim=1).to(x.dtype)
        feats = x[:, self.D:self.D + self.C].permute(0, 2, 3, 1)
        return depth[..., None] * feats[:, None]


class GeneralizedResNet(nn.ModuleList):
    """Stages of BasicBlocks, [(blocks, channels, stride)]; returns every
    stage's output."""

    def __init__(self, cin: int, stages=((2, 128, 2), (2, 256, 2), (2, 512, 1))):
        super().__init__()
        for n, cout, stride in stages:
            self.append(nn.Sequential(BasicBlock(cin, cout, stride),
                                      *(BasicBlock(cout, cout) for _ in range(n - 1))))
            cin = cout

    def forward(self, x):
        outs = []
        for stage in self:
            x = stage(x)
            outs.append(x)
        return outs


class LSSFPN(nn.Module):
    """The last of the decoder's outputs (512 channels) upsampled to the
    first's (128) size, fused to 256, then upsampled by 2."""

    def __init__(self, out: int = 256):
        super().__init__()
        self.fuse = nn.Sequential(*ConvBNReLU(512 + 128, out, 1), *ConvBNReLU(out, out))
        self.upsample = nn.Sequential(Upsample(2), *ConvBNReLU(out, out))

    def forward(self, feats):
        x1, x2 = feats[-1], feats[0]
        x1 = F.interpolate(x1, size=x2.shape[-2:], mode="bilinear", align_corners=True)
        return self.upsample(self.fuse(torch.cat([x1, x2], 1)))


class Decoder(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.backbone = GeneralizedResNet(cin)
        self.neck = LSSFPN()

    def forward(self, x):
        return self.neck(self.backbone(x))


def grid_transform(input_scope, output_scope) -> torch.Tensor:
    """(1, oX, oY, 2) ``grid_sample`` coordinates of the output grid's cell
    centres in the input grid's [-1, 1] (BEVFusion's ``BEVGridTransform``):
    the last axis (y, x), as ``grid_sample`` reads (W, H)."""
    coords = []
    for (imin, imax, _), (omin, omax, ostep) in zip(input_scope, output_scope):
        v = torch.arange(omin + ostep / 2, omax, ostep, dtype=torch.float32)
        coords.append((v - imin) / (imax - imin) * 2 - 1)
    u, v = torch.meshgrid(coords, indexing="ij")
    return torch.stack([v, u], dim=-1)[None]


class BEVSegmentationHead(nn.Module):
    def __init__(self, cin: int, classes: int, input_scope, output_scope):
        super().__init__()
        self.register_buffer("grid", grid_transform(input_scope, output_scope),
                             persistent=False)
        self.classifier = nn.Sequential(*ConvBNReLU(cin, cin), *ConvBNReLU(cin, cin),
                                        nn.Conv2d(cin, classes, 1))

    def forward(self, x):
        dtype = x.dtype
        grid = self.grid.expand(x.shape[0], -1, -1, -1)
        x = F.grid_sample(x.to(torch.float32), grid, mode="bilinear",
                          align_corners=False).to(dtype)
        *body, logits = self.classifier
        for layer in body:
            x = layer(x)
        return logits(x.to(torch.float32))


class BEVFusionSeg(nn.Module):
    """Camera-only BEVFusion for BEV map segmentation. ``data_aug_conf``'s
    ``final_dim`` is the image size (256 x 704 as published);
    ``grid_conf`` the lift's grid (x, y +-51.2 m at 0.4 m, one z level,
    depth 1-60 m by 0.5); ``output_scope`` the head's ((lo, hi, step) in x
    and y; +-50 m at 0.5 m). The decoder's grid is the lift's, halved by
    the downsample, then halved twice and doubled by the decoder."""

    loss = "sigmoid_focal"

    def __init__(self, grid_conf: GridConf, data_aug_conf: DataAugConf,
                 classes: int = len(MAP_CLASSES), camC: int = 80,
                 downsample: int = 8, output_scope=((-50.0, 50.0, 0.5), (-50.0, 50.0, 0.5)),
                 drop_path_rate: float = 0.2, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: "
                             f"{' or '.join(COMPUTE_DTYPES)}")
        dtype = COMPUTE_DTYPES[compute_dtype]
        dx, bx, self.nx = gen_dx_bx(grid_conf.xbound, grid_conf.ybound, grid_conf.zbound)
        frustum = create_frustum(data_aug_conf.final_dim, downsample, grid_conf.dbound)
        # constants of the forward on the model's device, not in the state
        # dict: a forward copies nothing from the host (a CUDA graph's
        # capture refuses such a copy)
        for name, value in (("frustum", torch.from_numpy(frustum.copy())),
                            ("grid_dx", torch.from_numpy(dx.copy())),
                            ("grid_bx", torch.from_numpy(bx.copy())),
                            *zip(("img_mean", "img_std"), imagenet_stats())):
            self.register_buffer(name, value, persistent=False)
        self.backbone = SwinTransformer(drop_path_rate=drop_path_rate, compute_dtype=dtype)
        self.neck = GeneralizedLSSFPN()
        self.vtransform = LSSTransform(frustum.shape[0], camC)
        self.decoder = Decoder(int(self.nx[2]) * camC)
        # the decoder's grid: the lift's bounds at 2 x its step
        scope = [(lo, hi, 2 * step) for lo, hi, step in (grid_conf.xbound, grid_conf.ybound)]
        self.head = BEVSegmentationHead(256, classes, scope, output_scope)

    def forward(self, x, rots, trans, intrins, post_rots, post_trans):
        B, N = x.shape[:2]
        with span("lss.bevfusion.trunk"):
            x = x.reshape(B * N, *x.shape[2:])
            if x.dtype == torch.uint8:
                x = normalize_uint8(x, self.img_mean, self.img_std)
            feats = self.backbone(x)
        with span("lss.bevfusion.neck"):
            x = self.neck(feats)
        with span("lss.bevfusion.lift"):
            lifted = self.vtransform.lift(x)
            lifted = lifted.view(B, N, *lifted.shape[1:])
            geom = get_geometry(self.frustum, rots, trans, intrins, post_rots, post_trans)
            bev = voxel_pooling(geom, lifted, self.grid_dx, self.grid_bx, self.nx)
        with span("lss.bevfusion.bev"):
            x = self.decoder(self.vtransform.downsample(bev.permute(0, 3, 1, 2)))
        with span("lss.bevfusion.head"):
            return self.head(x)


def init_bevfusion_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation drawn from ``generator`` only: linear maps and
    the relative position bias tables truncated normal (std 0.02, within
    +-2) with zero biases, LayerNorm and BN scale 1 and shift 0, bias-free
    convolutions He normal over fan-out, convolutions with a bias LeCun
    normal with a zero bias (the port's ``init_weights`` rule)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                if m.bias is None:
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                            generator=generator)
                else:
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                    m.bias.zero_()
            elif isinstance(m, Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowMSA):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                      generator=generator)
            elif isinstance(m, (LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()


def compile_bevfusion(grid_conf, data_aug_conf, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      **kwargs) -> BEVFusionSeg:
    """``BEVFusionSeg`` with weights drawn from ``generator`` (a fresh one
    seeded 0 by default) on the CPU, then moved to ``device`` (``cuda``
    unless the caller asks for ``cpu``; no GPU raises), as
    ``models/lss.py::compile_model`` builds LSS."""
    dev = resolve_device(device)
    if not isinstance(grid_conf, GridConf):
        grid_conf = GridConf.from_dict(grid_conf)
    if not isinstance(data_aug_conf, DataAugConf):
        data_aug_conf = DataAugConf.from_dict(data_aug_conf)
    model = BEVFusionSeg(grid_conf, data_aug_conf, **kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_bevfusion_weights(model, generator)
    return model.to(dev)
