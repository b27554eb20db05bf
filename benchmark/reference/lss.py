"""Plain Lift-Splat-Shoot in PyTorch: the yardstick the benchmark holds the
port's outputs against.

Philion & Fidler, ECCV 2020 (github.com/nv-tlabs/lift-splat-shoot,
``src/models.py``), as retargeted to SimBEV: an EfficientNet trunk whose
stride-32 and stride-16 endpoints are fused by ``Up``, a 1x1 depth net, a
softmax over the depth bins and the outer product with the features (the
lift), a sum of every frustum point's features into its voxel (the splat,
``index_add_`` in f32), a ResNet-18 BEV encoder with an upsampling
decoder, and the weighted BCE. Every layer is written out here with plain
``torch`` operations in float32; nothing is imported from the program.

The model is a function of a flat ``{name: tensor}`` dict whose names are
the reference checkpoint's (``efficientnet_pytorch``'s module names for the
trunk), so one state dict made by the benchmark loads into both sides.
Departures from the published description, each also the program's:

* "SAME" padding as XLA computes it (the low side gets ``total // 2``) on
  the stem and every depthwise conv;
* BN running variances are biased; train-mode BN normalises with the
  biased batch variance;
* voxel ids truncate toward zero, as the reference's ``.long()``.

``quant`` rounds every tensor that the program keeps in its compute
dtype: each convolution's input, weight and output, each BN's output, each
upsampled map, the lift and the splat's output (the control runs the same
model in a lower precision through it; the depth softmax, the BN moments
and the loss stay f32, as in the program). ``stats``, a dict, collects
each train-mode BN's batch (mean, biased variance) by name. ``masks`` replaces each
dropout draw by a given mask, so a step can follow the program's own draws:
``masks["camencode.dropout"]`` (elementwise, p 0.2),
``masks["bevencode.dropout"]`` (per channel, p 0.1) and
``masks["camencode.trunk._blocks.<i>"]`` (per sample, drop-connect).
Without masks a train-mode forward drops nothing.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# (expand, kernel, stride, in, out, repeats) of EfficientNet-B0 (Tan & Le,
# ICML 2019, Table 1); other variants scale widths and depths
B0_BLOCKS = ((1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 2), (6, 5, 2, 24, 40, 2),
             (6, 3, 2, 40, 80, 3), (6, 5, 1, 80, 112, 3), (6, 5, 2, 112, 192, 4),
             (6, 3, 1, 192, 320, 1))
# (width, depth) coefficients; "slim" is a test-only narrow trunk
VARIANTS = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
            "b3": (1.2, 1.4), "b4": (1.4, 1.8), "slim": (0.1, 0.1)}
DROP_CONNECT = 0.2
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def round_filters(filters: int, width: float) -> int:
    filters *= width
    new = max(8, int(filters + 4) // 8 * 8)
    return int(new + 8 if new < 0.9 * filters else new)


def block_plan(variant: str):
    """[(expand, kernel, stride, cin, cout)] of every MBConv block."""
    width, depth = VARIANTS[variant]
    plan = []
    for expand, k, s, cin, cout, reps in B0_BLOCKS:
        cin, cout = round_filters(cin, width), round_filters(cout, width)
        for r in range(int(math.ceil(depth * reps))):
            plan.append((expand, k, s if r == 0 else 1, cin if r == 0 else cout,
                         cout))
    return plan


def same_pad(x: Tensor, k: int, s: int) -> Tensor:
    def amounts(n):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2
    return F.pad(x, (*amounts(x.shape[-1]), *amounts(x.shape[-2])))


def identity(t: Tensor) -> Tensor:
    return t


def rounded(dtype: torch.dtype) -> Callable[[Tensor], Tensor]:
    """Round to ``dtype`` and back (the forward sees the rounded values,
    the gradient passes straight through): the control's convolution
    operands in bfloat16."""
    def quant(t: Tensor) -> Tensor:
        return t + (t.to(dtype).to(t.dtype) - t).detach()
    return quant


def tf32(t: Tensor) -> Tensor:
    """Round float32 to TF32's 10 mantissa bits (to nearest, ties to
    even) and back; the gradient passes straight through: the reference in
    the precision that TF32 convolutions state, on any device."""
    bits = t.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return t + (bits.view(torch.float32).to(t.dtype) - t).detach()


def fp8_e4m3(t: Tensor) -> Tensor:
    """Round to float8 e4m3 under a per-tensor scale that maps the largest
    magnitude to 448 (the format's largest), and back; the gradient passes
    straight through: the control's convolution operands in fp8."""
    scale = 448.0 / t.detach().abs().amax().clamp_min(1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()


class full_f32:
    """TF32 off for matmuls and convolutions inside the ``with``: the
    reference runs in float32 on the card."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


class Net:
    """The forward pass over ``p`` (parameters and running stats by name).

    ``train``: BN from batch moments (and, with ``masks``, dropout as the
    masks say); else from the running stats, no dropout."""

    def __init__(self, p: Params, variant: str, train: bool,
                 masks: Optional[Dict[str, Tensor]] = None,
                 quant: Callable[[Tensor], Tensor] = identity,
                 stats: Optional[dict] = None):
        self.p, self.variant, self.train = p, variant, train
        self.masks, self.quant, self.stats = masks or {}, quant, stats

    def conv(self, x, name, stride=1, padding=0, groups=1):
        bias = self.p.get(name + ".bias")
        q = self.quant
        return q(F.conv2d(q(x), q(self.p[name + ".weight"]), bias, stride,
                          padding, 1, groups))

    def bn(self, x, name, eps):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.train:
            mean = x.mean((0, 2, 3))
            var = (x - mean[:, None, None]).square().mean((0, 2, 3))
            if self.stats is not None:
                self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        return self.quant((x - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
                          * w[:, None, None] + b[:, None, None])

    def dropout(self, x, name, p):
        mask = self.masks.get(name) if self.train else None
        return x if mask is None else x * mask.to(x.dtype) / (1.0 - p)

    def conv_bn_relu(self, x, conv, bn, stride=1):
        return F.relu(self.bn(self.conv(x, conv, stride, padding=1), bn, 1e-5))

    def up(self, x1, x2, name, scale):
        x1 = self.quant(F.interpolate(x1, scale_factor=scale, mode="bilinear",
                                      align_corners=True))
        x = torch.cat([x2, x1], 1)
        x = self.conv_bn_relu(x, name + ".conv.0", name + ".conv.1")
        return self.conv_bn_relu(x, name + ".conv.3", name + ".conv.4")

    # --- EfficientNet trunk -------------------------------------------

    def mbconv(self, x, i, expand, k, s, cin, cout, n_blocks):
        name = f"camencode.trunk._blocks.{i}"
        inputs = x
        if expand != 1:
            x = F.silu(self.bn(self.conv(x, name + "._expand_conv"), name + "._bn0", 1e-3))
        x = self.conv(same_pad(x, k, s), name + "._depthwise_conv", stride=s,
                      groups=x.shape[1])
        x = F.silu(self.bn(x, name + "._bn1", 1e-3))
        se = x.mean((2, 3), keepdim=True)
        se = self.conv(F.silu(self.conv(se, name + "._se_reduce")), name + "._se_expand")
        x = torch.sigmoid(se) * x
        x = self.bn(self.conv(x, name + "._project_conv"), name + "._bn2", 1e-3)
        if s == 1 and cin == cout:
            rate = DROP_CONNECT * i / n_blocks
            mask = self.masks.get(name) if self.train else None
            if rate > 0 and mask is not None:
                x = x / (1.0 - rate) * mask.to(x.dtype)[:, None, None, None]
            x = x + inputs
        return x

    def trunk(self, x):
        x = same_pad(x, 3, 2)
        x = F.silu(self.bn(self.conv(x, "camencode.trunk._conv_stem", stride=2),
                           "camencode.trunk._bn0", 1e-3))
        plan = block_plan(self.variant)
        ends, prev = [], x
        for i, args in enumerate(plan):
            x = self.mbconv(x, i, *args, len(plan))
            if prev.shape[2] > x.shape[2]:
                ends.append(prev)
            prev = x
        ends.append(x)
        return ends[4], ends[3]  # reduction_5, reduction_4

    # --- lift, splat, BEV -----------------------------------------------

    def lift(self, imgs, D: int, C: int):
        """(B, N, 3, H, W) images -> (B, N, D, fH, fW, C) lifted features."""
        B, N = imgs.shape[:2]
        x = imgs.reshape(B * N, *imgs.shape[2:])
        if x.dtype == torch.uint8:
            mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
            std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
            x = (x.float() / 255.0 - mean) / std
        r5, r4 = self.trunk(x)
        x = self.up(r5, r4, "camencode.up1", 2)
        x = self.conv(self.dropout(x, "camencode.dropout", 0.2), "camencode.depthnet")
        depth = torch.softmax(x[:, :D], dim=1)
        feats = x[:, D:D + C]
        lifted = self.quant(depth[:, :, None] * feats[:, None])  # (BN, D, C, fH, fW)
        return lifted.permute(0, 1, 3, 4, 2).reshape(B, N, D, *x.shape[2:], C)

    def basic_block(self, x, name, stride, has_down):
        identity_ = x
        if has_down:
            identity_ = self.bn(self.conv(x, name + ".downsample.0", stride),
                                name + ".downsample.1", 1e-5)
        y = F.relu(self.bn(self.conv(x, name + ".conv1", stride, 1), name + ".bn1", 1e-5))
        y = self.bn(self.conv(y, name + ".conv2", 1, 1), name + ".bn2", 1e-5)
        return F.relu(y + identity_)

    def bev(self, x):
        """(B, C, X, Y) pooled BEV -> (B, outC, X, Y) logits."""
        x = F.relu(self.bn(self.conv(x, "bevencode.conv1", 2, 3), "bevencode.bn1", 1e-5))
        x = self.basic_block(x, "bevencode.layer1.0", 1, False)
        x1 = self.basic_block(x, "bevencode.layer1.1", 1, False)
        x = self.basic_block(x1, "bevencode.layer2.0", 2, True)
        x = self.basic_block(x, "bevencode.layer2.1", 1, False)
        x = self.basic_block(x, "bevencode.layer3.0", 2, True)
        x = self.basic_block(x, "bevencode.layer3.1", 1, False)
        x = self.dropout(self.up(x, x1, "bevencode.up1", 4), "bevencode.dropout", 0.1)
        x = self.quant(F.interpolate(x, scale_factor=2, mode="bilinear",
                                     align_corners=True))
        x = self.conv_bn_relu(x, "bevencode.up2.1", "bevencode.up2.2")
        return self.conv(x, "bevencode.up2.4")


def frustum(final_dim, downsample: int, dbound) -> Tensor:
    """(D, fH, fW, 3) frustum of (pixel x, pixel y, depth) per cell."""
    fH, fW = final_dim[0] // downsample, final_dim[1] // downsample
    ds = torch.arange(*dbound, dtype=torch.float32)
    D = ds.shape[0]
    xs = torch.linspace(0, final_dim[1] - 1, fW).view(1, 1, fW).expand(D, fH, fW)
    ys = torch.linspace(0, final_dim[0] - 1, fH).view(1, fH, 1).expand(D, fH, fW)
    return torch.stack((xs, ys, ds.view(D, 1, 1).expand(D, fH, fW)), -1)


def geometry(frus, rots, trans, intrins, post_rots, post_trans) -> Tensor:
    """Ego-frame (x, y, z) of every frustum cell: (B, N, D, fH, fW, 3)."""
    pts = frus[None, None] - post_trans[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", torch.linalg.inv(post_rots), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    combine = rots @ torch.linalg.inv(intrins)
    return torch.einsum("bnij,bndhwj->bndhwi", combine, pts) + trans[:, :, None, None, None]


def grid_dims(grid: dict):
    """(dx, bx, nx) of the config's bounds: voxel size, first centre, counts."""
    bounds = [grid["xbound"], grid["ybound"], grid["zbound"]]
    dx = torch.tensor([b[2] for b in bounds], dtype=torch.float32)
    bx = torch.tensor([b[0] + b[2] / 2.0 for b in bounds], dtype=torch.float32)
    nx = [int((b[1] - b[0]) / b[2]) for b in bounds]
    return dx, bx, nx


def voxel_ids(geom: Tensor, grid: dict) -> Tensor:
    """(B, P) flat voxel ids, ((z*X)+x)*Y+y, and -1 outside the grid."""
    dx, bx, (X, Y, Z) = grid_dims(grid)
    dx, bx = dx.to(geom.device), bx.to(geom.device)
    v = ((geom - (bx - dx / 2.0)) / dx).to(torch.int64)     # truncates
    ix, iy, iz = v.unbind(-1)
    ok = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    return torch.where(ok, (iz * X + ix) * Y + iy, -1).reshape(geom.shape[0], -1)


def splat(feats: Tensor, ids: Tensor, num_slots: int) -> Tensor:
    """(B, P, C) features summed into (B, num_slots, C) by id (f32)."""
    B, P, C = feats.shape
    keep = ids >= 0
    flat = (ids + torch.arange(B, device=ids.device)[:, None] * num_slots)[keep]
    out = feats.new_zeros(B * num_slots, C)
    return out.index_add_(0, flat, feats[keep]).view(B, num_slots, C)


def forward(p: Params, cfg: dict, batch, train: bool = False,
            masks: Optional[Dict[str, Tensor]] = None,
            quant: Callable[[Tensor], Tensor] = identity,
            stats: Optional[dict] = None, taps: Optional[dict] = None) -> Tensor:
    """Logits (B, outC, X, Y) of the six inputs (imgs uint8 or float);
    ``taps``, a dict, gets the pooled BEV that the BEV encoder takes
    (``"bev"``, (B, Z * C, X, Y))."""
    imgs, rots, trans, intrins, post_rots, post_trans = batch[:6]
    net = Net(p, cfg["variant"], train, masks, quant, stats)
    grid = cfg["grid"]
    frus = frustum(cfg["final_dim"], cfg["downsample"], grid["dbound"]).to(rots.device)
    D, C = frus.shape[0], cfg["camC"]
    lifted = net.lift(imgs, D, C)
    geom = geometry(frus, *(t.float() for t in (rots, trans, intrins, post_rots,
                                                 post_trans)))
    _, _, (X, Y, Z) = grid_dims(grid)
    B = imgs.shape[0]
    bev = splat(lifted.reshape(B, -1, C), voxel_ids(geom, grid), Z * X * Y)
    bev = bev.view(B, Z, X, Y, C).permute(0, 1, 4, 2, 3).reshape(B, Z * C, X, Y)
    bev = quant(bev)
    if taps is not None:
        taps["bev"] = bev.detach()
    return net.bev(bev)


def bce(logits: Tensor, target: Tensor, pos_weight: float) -> Tensor:
    """Mean of ``w y softplus(-x) + (1 - y) softplus(x)`` (BCEWithLogits)."""
    return (pos_weight * target * F.softplus(-logits)
            + (1 - target) * F.softplus(logits)).mean()


def dw_shapes(cfg: dict, n_images: int):
    """[(kernel, stride, (N, C, H, W))] of the trunk's depthwise convs on
    ``n_images`` images at the config's final size."""
    H, W = -(-cfg["final_dim"][0] // 2), -(-cfg["final_dim"][1] // 2)
    out = []
    for expand, k, s, cin, _ in block_plan(cfg["variant"]):
        out.append((k, s, (n_images, cin * expand, H, W)))
        H, W = -(-H // s), -(-W // s)
    return out


def param_shapes(cfg: dict):
    """[(name, shape)] of every parameter and BN running stat, in the
    port's state-dict order, worked out from the config alone."""
    out = []

    def conv(name, cout, cin, k, bias=False):
        out.append((name + ".weight", (cout, cin, k, k)))
        if bias:
            out.append((name + ".bias", (cout,)))

    def bn(name, c):
        out.extend([(name + ".weight", (c,)), (name + ".bias", (c,)),
                    (name + ".running_mean", (c,)), (name + ".running_var", (c,)),
                    (name + ".num_batches_tracked", ())])

    width, _ = VARIANTS[cfg["variant"]]
    stem = round_filters(32, width)
    conv("camencode.trunk._conv_stem", stem, 3, 3)
    bn("camencode.trunk._bn0", stem)
    chans, prev = [], stem
    for i, (expand, k, s, cin, cout) in enumerate(block_plan(cfg["variant"])):
        name, mid = f"camencode.trunk._blocks.{i}", cin * expand
        if s > 1:
            chans.append(prev)
        if expand != 1:
            conv(name + "._expand_conv", mid, cin, 1)
            bn(name + "._bn0", mid)
        conv(name + "._depthwise_conv", mid, 1, k)
        bn(name + "._bn1", mid)
        se = max(1, int(cin * 0.25))
        conv(name + "._se_reduce", se, mid, 1, bias=True)
        conv(name + "._se_expand", mid, se, 1, bias=True)
        conv(name + "._project_conv", cout, mid, 1)
        bn(name + "._bn2", cout)
        prev = cout
    chans.append(prev)

    def up(name, cin, cout):
        conv(name + ".conv.0", cout, cin, 3)
        bn(name + ".conv.1", cout)
        conv(name + ".conv.3", cout, cout, 3)
        bn(name + ".conv.4", cout)

    D = len(np.arange(*cfg["grid"]["dbound"]))
    up("camencode.up1", chans[4] + chans[3], 512)
    conv("camencode.depthnet", D + cfg["camC"], 512, 1, bias=True)
    nz = int((cfg["grid"]["zbound"][1] - cfg["grid"]["zbound"][0]) / cfg["grid"]["zbound"][2])
    conv("bevencode.conv1", 64, nz * cfg["camC"], 7)
    bn("bevencode.bn1", 64)
    for layer, (cin, cout) in enumerate(((64, 64), (64, 128), (128, 256)), 1):
        for r in range(2):
            name = f"bevencode.layer{layer}.{r}"
            c0 = cin if r == 0 else cout
            conv(name + ".conv1", cout, c0, 3)
            bn(name + ".bn1", cout)
            conv(name + ".conv2", cout, cout, 3)
            bn(name + ".bn2", cout)
            if r == 0 and (layer > 1):
                conv(name + ".downsample.0", cout, c0, 1)
                bn(name + ".downsample.1", cout)
    up("bevencode.up1", 64 + 256, 256)
    conv("bevencode.up2.1", 128, 256, 3)
    bn("bevencode.up2.2", 128)
    conv("bevencode.up2.4", cfg["outC"], 128, 1, bias=True)
    return out
