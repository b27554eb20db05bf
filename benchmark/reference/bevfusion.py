"""Plain BEVFusion camera-only BEV map segmentation in PyTorch, with its
training step: the yardstick the benchmark holds the port's model against.

Liu et al., ICRA 2023 (github.com/mit-han-lab/bevfusion,
``configs/nuscenes/seg/camera-bev256d2.yaml``): a Swin-T trunk with
mmdetection's equations (pre-norm blocks, W-MSA and SW-MSA in 7 x 7
windows with a relative position bias, the cyclic shift's region mask, zero
padding of the token map on the right and bottom, attended; patch merging
in ``nn.Unfold``'s order; a LayerNorm on each output stage), the
``GeneralizedLSSFPN`` neck, the ``LSSTransform`` lift (a 1 x 1 depth net,
the depth softmax, the outer product), the splat as ``index_add_``, the
BEV downsample, ``GeneralizedResNet`` and ``LSSFPN``, and the segmentation
head (``grid_sample`` onto the output grid, two conv-BN-ReLU, a 1 x 1
conv). Everything is written out here with plain ``torch`` operations in
float32: attention as reshape, matmul and softmax. Nothing is imported
from the program or from the rest of the benchmark.

The model is a function of a flat ``{name: tensor}`` dict whose names are
the program's state dict's (mmdetection's module names in the trunk), so
one state dict made by the benchmark loads into both sides. Train-mode BN
normalises with the biased batch variance. ``quant`` rounds every tensor
that the program keeps in its compute dtype (each linear map's and
convolution's input, weight, bias and output, each normalisation's output,
the attention bias, each residual sum, each resampled map, the lift and the
splat's output); the LayerNorm and BN moments, the softmaxes, the grid's
coordinates, the loss and the logits stay f32. ``masks`` replaces each
stochastic-depth draw by a given per-sample mask, by the program's module
name (``backbone.stages.<i>.blocks.<j>.attn.drop`` and
``...ffn.dropout_layer``); without masks a train-mode forward drops nothing.

The loss is BEVFusion's sigmoid focal loss (gamma 2, no alpha): each
class's mean, summed over the classes. The step: the gradients averaged
over the microbatches, the global-norm clip (scaled only where the norm
reaches the limit, no epsilon), AdamW (0.9, 0.999, 1e-8; each parameter
scaled by 1 - lr x decay, then the Adam step) at the schedule's learning
rate (a linear warm-up from 0, then a cosine decay to 0).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def identity(t: Tensor) -> Tensor:
    return t


# --- geometry and splat ---------------------------------------------------

def frustum(image_size, stride: int, dbound) -> Tensor:
    """(D, fH, fW, 3) frustum of (pixel x, pixel y, depth) per cell."""
    fH, fW = image_size[0] // stride, image_size[1] // stride
    ds = torch.arange(*dbound, dtype=torch.float32)
    D = ds.shape[0]
    xs = torch.linspace(0, image_size[1] - 1, fW).view(1, 1, fW).expand(D, fH, fW)
    ys = torch.linspace(0, image_size[0] - 1, fH).view(1, fH, 1).expand(D, fH, fW)
    return torch.stack((xs, ys, ds.view(D, 1, 1).expand(D, fH, fW)), -1)


def geometry(frus, rots, trans, intrins, post_rots, post_trans) -> Tensor:
    """Ego-frame (x, y, z) of every frustum cell: (B, N, D, fH, fW, 3)."""
    pts = frus[None, None] - post_trans[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", torch.linalg.inv(post_rots), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    combine = rots @ torch.linalg.inv(intrins)
    return torch.einsum("bnij,bndhwj->bndhwi", combine, pts) + trans[:, :, None, None, None]


def grid_dims(bounds):
    """(dx, bx, nx) of [xbound, ybound, zbound]."""
    dx = torch.tensor([b[2] for b in bounds], dtype=torch.float32)
    bx = torch.tensor([b[0] + b[2] / 2.0 for b in bounds], dtype=torch.float32)
    nx = [int((b[1] - b[0]) / b[2]) for b in bounds]
    return dx, bx, nx


def voxel_ids(geom: Tensor, bounds) -> Tensor:
    """(B, P) flat voxel ids, ((z*X)+x)*Y+y, and -1 outside the grid
    (coordinates truncated toward zero)."""
    dx, bx, (X, Y, Z) = grid_dims(bounds)
    dx, bx = dx.to(geom.device), bx.to(geom.device)
    v = ((geom - (bx - dx / 2.0)) / dx).to(torch.int64)
    ix, iy, iz = v.unbind(-1)
    ok = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    return torch.where(ok, (iz * X + ix) * Y + iy, -1).reshape(geom.shape[0], -1)


def splat(feats: Tensor, ids: Tensor, num_slots: int) -> Tensor:
    """(B, P, C) features summed into (B, num_slots, C) by id."""
    B, P, C = feats.shape
    keep = ids >= 0
    flat = (ids + torch.arange(B, device=ids.device)[:, None] * num_slots)[keep]
    out = feats.new_zeros(B * num_slots, C)
    return out.index_add_(0, flat, feats[keep]).view(B, num_slots, C)


def depth_bins(cfg: dict) -> int:
    return len(torch.arange(*cfg["vtransform"]["dbound"]))


def bounds_of(cfg: dict):
    v = cfg["vtransform"]
    return [v["xbound"], v["ybound"], v["zbound"]]


# --- the network ----------------------------------------------------------

def relative_index(w: int) -> Tensor:
    """(w*w, w*w) index of each (query, key) pair into the bias table (the
    original Swin's construction)."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij"))
    coords = coords.flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


def region_mask(H: int, W: int, w: int, s: int) -> Tensor:
    """(windows, w*w, w*w): 0 within a shifted region, -100 across."""
    img = torch.zeros(H, W)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.view(H // w, w, W // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return diff.ne(0).float() * -100.0


class Net:
    """The forward pass over ``p``; ``train``: BN from batch moments and
    stochastic depth as ``masks`` say."""

    def __init__(self, p: Params, cfg: dict, train: bool,
                 masks: Optional[Dict[str, Tensor]] = None,
                 quant: Callable[[Tensor], Tensor] = identity):
        self.p, self.cfg, self.train = p, cfg, train
        self.masks, self.quant = masks or {}, quant

    def linear(self, x, name):
        q, b = self.quant, self.p.get(name + ".bias")
        return q(F.linear(q(x), q(self.p[name + ".weight"]), None if b is None else q(b)))

    def conv(self, x, name, stride=1, padding=0):
        q, b = self.quant, self.p.get(name + ".bias")
        return q(F.conv2d(q(x), q(self.p[name + ".weight"]), None if b is None else q(b),
                          stride, padding))

    def layer_norm(self, x, name):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return self.quant((x - mean) * torch.rsqrt(var + 1e-5) * w + b)

    def bn(self, x, name):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.train:
            mean = x.mean((0, 2, 3))
            var = (x - mean[:, None, None]).square().mean((0, 2, 3))
        else:
            mean, var = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        return self.quant((x - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
                          * w[:, None, None] + b[:, None, None])

    def cbr(self, x, conv, bn, stride=1, padding=1):
        return F.relu(self.bn(self.conv(x, conv, stride, padding), bn))

    def drop_path(self, x, name, rate):
        mask = self.masks.get(name) if self.train else None
        if rate == 0 or mask is None:
            return x
        return self.quant(x / (1.0 - rate) * mask.to(x.dtype).view(-1, *([1] * (x.dim() - 1))))

    # --- Swin ---------------------------------------------------------------

    def attention(self, x, name, heads, w, shift):
        """W-MSA / SW-MSA on a padded (B, Hp, Wp, C) map."""
        B, Hp, Wp, C = x.shape
        T, nW, d = w * w, (Hp // w) * (Wp // w), C // heads
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        win = x.view(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, T, C)
        qkv = self.linear(win, name + ".qkv").reshape(-1, T, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        table = self.p[name + ".relative_position_bias_table"]
        bias = table[relative_index(w).reshape(-1).to(table.device)].view(T, T, heads)
        bias = bias.permute(2, 0, 1)[None]                       # (1, heads, T, T)
        if shift:
            mask = region_mask(Hp, Wp, w, shift).to(x.device)
            bias = (bias + mask[:, None]).repeat(B, 1, 1, 1)      # (B nW, heads, T, T)
        attn = (q @ k.transpose(-2, -1)) * d ** -0.5 + self.quant(bias)
        out = self.quant(torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(-1, T, C)
        out = self.linear(out, name + ".proj")
        x = out.view(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if shift:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        return x

    def swin_block(self, x, hw, name, heads, shift, rate):
        B, L, C = x.shape
        H, W = hw
        w = self.cfg["swin"]["window_size"]
        y = self.layer_norm(x, name + ".norm1").view(B, H, W, C)
        y = F.pad(y, (0, 0, 0, (-W) % w, 0, (-H) % w))
        y = self.attention(y, name + ".attn.w_msa", heads, w, shift)
        y = y[:, :H, :W].reshape(B, L, C)
        x = self.quant(x + self.drop_path(y, name + ".attn.drop", rate))
        y = self.layer_norm(x, name + ".norm2")
        y = self.quant(F.gelu(self.linear(y, name + ".ffn.layers.0.0")))
        y = self.linear(y, name + ".ffn.layers.1")
        return self.quant(x + self.drop_path(y, name + ".ffn.dropout_layer", rate))

    def merge(self, x, hw, name):
        """mmcv's ``PatchMerging``: 2 x 2 ``nn.Unfold``, LayerNorm, linear."""
        B, L, C = x.shape
        H, W = hw
        x = x.view(B, H, W, C).permute(0, 3, 1, 2)
        x = F.pad(x, (0, W % 2, 0, H % 2))
        x = F.unfold(x, kernel_size=2, stride=2).transpose(1, 2)
        x = self.layer_norm(x, name + ".norm")
        return self.linear(x, name + ".reduction"), ((H + 1) // 2, (W + 1) // 2)

    def swin(self, x):
        s = self.cfg["swin"]
        x = F.pad(x, (0, (-x.shape[-1]) % 4, 0, (-x.shape[-2]) % 4))
        x = self.conv(x, "backbone.patch_embed.projection", stride=4)
        hw = tuple(x.shape[2:])
        x = self.layer_norm(x.flatten(2).transpose(1, 2), "backbone.patch_embed.norm")
        rates = torch.linspace(0, s["drop_path_rate"], sum(s["depths"])).tolist()
        outs, k = [], 0
        for i, depth in enumerate(s["depths"]):
            for j in range(depth):
                name = f"backbone.stages.{i}.blocks.{j}"
                shift = s["window_size"] // 2 if j % 2 else 0
                x = self.swin_block(x, hw, name, s["num_heads"][i], shift, rates[k])
                k += 1
            if i in s["out_indices"]:
                out = self.layer_norm(x, f"backbone.norm{i}")
                outs.append(out.view(x.shape[0], *hw, -1).permute(0, 3, 1, 2))
            if i < len(s["depths"]) - 1:
                x, hw = self.merge(x, hw, f"backbone.stages.{i}.downsample")
        return outs

    # --- neck, lift, BEV --------------------------------------------------

    def neck(self, feats):
        x = list(feats)
        for i in range(len(x) - 2, -1, -1):
            up = self.quant(F.interpolate(x[i + 1], size=x[i].shape[2:], mode="bilinear",
                                          align_corners=False))
            y = self.cbr(torch.cat([x[i], up], 1), f"neck.lateral_convs.{i}.conv",
                         f"neck.lateral_convs.{i}.bn", padding=0)
            x[i] = self.cbr(y, f"neck.fpn_convs.{i}.conv", f"neck.fpn_convs.{i}.bn")
        return x[0]

    def lift(self, imgs):
        """(B, N, 3, H, W) images -> (B, N, D, fH, fW, C) lifted features."""
        B, N = imgs.shape[:2]
        x = imgs.reshape(B * N, *imgs.shape[2:])
        if x.dtype == torch.uint8:
            mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
            std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
            x = (x.float() / 255.0 - mean) / std
        x = self.conv(self.neck(self.swin(x)), "vtransform.depthnet")
        D, C = depth_bins(self.cfg), self.cfg["vtransform"]["out_channels"]
        depth = torch.softmax(x[:, :D], dim=1)
        lifted = self.quant(depth[:, :, None] * x[:, None, D:D + C])   # (BN, D, C, fH, fW)
        return lifted.permute(0, 1, 3, 4, 2).reshape(B, N, D, *x.shape[2:], C)

    def basic_block(self, x, name, stride, down):
        identity_ = x
        if down:
            identity_ = self.bn(self.conv(x, name + ".downsample.0", stride),
                                name + ".downsample.1")
        y = self.cbr(x, name + ".conv1", name + ".bn1", stride)
        y = self.bn(self.conv(y, name + ".conv2", 1, 1), name + ".bn2")
        return F.relu(self.quant(y + identity_))

    def bev(self, x):
        """(B, C, X, Y) pooled BEV -> (B, classes, oX, oY) logits."""
        for a, b, s in (("0", "1", 1), ("3", "4", 2), ("6", "7", 1)):
            x = self.cbr(x, f"vtransform.downsample.{a}", f"vtransform.downsample.{b}", s)
        outs, cin = [], x.shape[1]
        for i, (n, cout, stride) in enumerate(self.cfg["decoder"]["blocks"]):
            for r in range(n):
                x = self.basic_block(x, f"decoder.backbone.{i}.{r}", stride if r == 0 else 1,
                                     r == 0 and (stride != 1 or cin != cout))
            outs.append(x)
            cin = cout
        nk = self.cfg["decoder"]["neck"]
        x1, x2 = outs[nk["in_indices"][0]], outs[nk["in_indices"][1]]
        x1 = self.quant(F.interpolate(x1, size=x2.shape[-2:], mode="bilinear",
                                      align_corners=True))
        x = self.cbr(torch.cat([x1, x2], 1), "decoder.neck.fuse.0", "decoder.neck.fuse.1",
                     padding=0)
        x = self.cbr(x, "decoder.neck.fuse.3", "decoder.neck.fuse.4")
        x = self.quant(F.interpolate(x, scale_factor=nk["scale_factor"], mode="bilinear",
                                     align_corners=True))
        x = self.cbr(x, "decoder.neck.upsample.1", "decoder.neck.upsample.2")
        return self.head(x)

    def head(self, x):
        h = self.cfg["head"]
        coords = []
        for (imin, imax, _), (omin, omax, ostep) in zip(h["input_scope"], h["output_scope"]):
            v = torch.arange(omin + ostep / 2, omax, ostep, dtype=torch.float32)
            coords.append(((v - imin) / (imax - imin) * 2 - 1).to(x.device))
        u, v = torch.meshgrid(coords, indexing="ij")
        grid = torch.stack([v, u], dim=-1)[None].expand(x.shape[0], -1, -1, -1)
        x = self.quant(F.grid_sample(x, grid, mode="bilinear", align_corners=False))
        x = self.cbr(x, "head.classifier.0", "head.classifier.1")
        x = self.cbr(x, "head.classifier.3", "head.classifier.4")
        w, b = self.p["head.classifier.6.weight"], self.p["head.classifier.6.bias"]
        return F.conv2d(x, w, b)


def forward(p: Params, cfg: dict, batch, train: bool = False,
            masks: Optional[Dict[str, Tensor]] = None,
            quant: Callable[[Tensor], Tensor] = identity,
            taps: Optional[dict] = None) -> Tensor:
    """Logits (B, classes, oX, oY) of the six inputs (imgs uint8 or
    float); ``taps``, a dict, gets the pooled BEV that the BEV downsample
    takes (``"bev"``, (B, Z * C, X, Y))."""
    imgs, rots, trans, intrins, post_rots, post_trans = batch[:6]
    net = Net(p, cfg, train, masks, quant)
    bounds = bounds_of(cfg)
    frus = frustum(cfg["image_size"], cfg["feature_stride"],
                   cfg["vtransform"]["dbound"]).to(rots.device)
    lifted = net.lift(imgs)
    C = lifted.shape[-1]
    geom = geometry(frus, *(t.float() for t in (rots, trans, intrins, post_rots, post_trans)))
    _, _, (X, Y, Z) = grid_dims(bounds)
    B = imgs.shape[0]
    bev = splat(lifted.reshape(B, -1, C), voxel_ids(geom, bounds), Z * X * Y)
    bev = quant(bev.view(B, Z, X, Y, C).permute(0, 1, 4, 2, 3).reshape(B, Z * C, X, Y))
    if taps is not None:
        taps["bev"] = bev.detach()
    return net.bev(bev)


def focal(logits: Tensor, target: Tensor, gamma: float = 2.0) -> Tensor:
    """Sigmoid focal loss: each class's mean of (1 - p_t)^gamma x BCE,
    summed over the classes."""
    p = torch.sigmoid(logits)
    ce = F.softplus(-logits) * target + F.softplus(logits) * (1 - target)
    p_t = p * target + (1 - p) * (1 - target)
    return sum((ce[:, c] * (1 - p_t[:, c]) ** gamma).mean() for c in range(logits.shape[1]))


# --- the training step ------------------------------------------------------

def lr_at(opt: dict, count: int) -> float:
    """Learning rate of update ``count`` (0 for the first): a linear
    warm-up from 0, then a cosine decay to 0 at ``decay_steps``."""
    lr, warm = opt["lr"], opt.get("warmup_steps", 0)
    if count < warm:
        return lr * count / warm
    steps = opt["decay_steps"] - warm
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count - warm, steps) / steps))


BETAS, EPS = (0.9, 0.999), 1e-8


def adamw(p: Tensor, m: Tensor, v: Tensor, g: Tensor, lr: float, t: int,
          decay: float) -> None:
    """AdamW's update ``t`` (1 for the first) of one parameter ``p`` with
    moments ``m`` and ``v``, all in place, by the gradient ``g``: the
    weight decayed apart from the moments (``p`` scaled by 1 - lr decay),
    then the bias-corrected Adam step."""
    b1, b2 = BETAS
    p.mul_(1 - lr * decay)
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(EPS)
    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def trainable(names) -> List[str]:
    return [n for n in names if not n.endswith(BUFFER_SUFFIXES)]


def gradient(p: Params, names, cfg: dict, opt: dict, micro, masks=None,
             quant=identity) -> Dict[str, object]:
    """One step's forward and backward over the microbatches ``micro``
    (each the 7-tuple (imgs, rots, trans, intrins, post_rots, post_trans,
    labels); ``masks[m]`` the stochastic-depth masks of microbatch m).
    Returns {"loss": the microbatches' mean, "grad": {name: the gradient as
    the optimizer takes it: averaged and clipped}, "logits", "dlogits" (the
    loss's gradient by the logits) and "bev" (the pooled BEV): a list of
    one a microbatch}."""
    grads = {n: torch.zeros_like(p[n]) for n in names}
    out = {"logits": [], "dlogits": [], "bev": []}
    total = 0.0
    for i, mb in enumerate(micro):
        taps = {}
        logits = forward(p, cfg, mb, train=True, masks=None if masks is None else masks[i],
                         quant=quant, taps=taps)
        loss = focal(logits, mb[6].float(), cfg["head"]["gamma"])
        g = torch.autograd.grad(loss, [logits] + [p[n] for n in names], allow_unused=True)
        out["logits"].append(logits.detach())
        out["dlogits"].append(g[0])
        out["bev"].append(taps["bev"])
        for n, gi in zip(names, g[1:]):
            if gi is not None:
                grads[n] += gi
        total += float(loss.detach())
    grads = {n: g / len(micro) for n, g in grads.items()}
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = opt["max_grad_norm"] / norm if norm >= opt["max_grad_norm"] else 1.0
    with torch.no_grad():
        out["grad"] = {n: grads[n] * scale for n in names}
    out["loss"] = total / len(micro)
    return out


def _params(weights: Params):
    names = trainable(weights)
    p = {n: t.detach().float().clone() for n, t in weights.items()}
    for n in names:
        p[n].requires_grad_(True)
    return p, names


def follow(weights: Params, cfg: dict, opt: dict, steps, masks=None,
           quant=identity) -> Dict[str, object]:
    """Run ``len(steps)`` AdamW steps (``steps[s]`` a list of
    microbatches, ``masks[s][m]`` the masks of its microbatch m). Returns
    {"loss": [per step], "first": the first step's ``gradient``,
    "grad1": {name: norm of its gradient}, "change": {name: norm}}."""
    p, names = _params(weights)
    start = {n: p[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, first = [], None
    for s, micro in enumerate(steps):
        step = gradient(p, names, cfg, opt, micro, None if masks is None else masks[s], quant)
        losses.append(step["loss"])
        if s == 0:
            first = step
        with torch.no_grad():
            for n in names:
                adamw(p[n], m[n], v[n], step["grad"][n], lr_at(opt, s), s + 1,
                      opt["weight_decay"])
    change = {n: float(torch.linalg.vector_norm(p[n].detach() - start[n])) for n in names}
    return {"loss": losses, "first": first,
            "grad1": {n: float(torch.linalg.vector_norm(g)) for n, g in first["grad"].items()},
            "change": change}


def one_step(weights: Params, cfg: dict, opt: dict, micro, masks=None,
             quant=identity) -> Dict[str, object]:
    """``gradient`` of one step from ``weights`` (a state that the program
    reached: the check of a step after the window)."""
    p, names = _params(weights)
    return gradient(p, names, cfg, opt, micro, masks, quant)


# --- shapes ----------------------------------------------------------------

def param_shapes(cfg: dict):
    """[(name, shape)] of every parameter and BN running stat, in the
    program's state-dict order, worked out from the config alone."""
    out = []

    def conv(name, cout, cin, k, bias=False):
        out.append((name + ".weight", (cout, cin, k, k)))
        if bias:
            out.append((name + ".bias", (cout,)))

    def linear(name, cout, cin, bias=True):
        out.append((name + ".weight", (cout, cin)))
        if bias:
            out.append((name + ".bias", (cout,)))

    def norm(name, c):
        out.extend([(name + ".weight", (c,)), (name + ".bias", (c,))])

    def bn(name, c):
        norm(name, c)
        out.extend([(name + ".running_mean", (c,)), (name + ".running_var", (c,)),
                    (name + ".num_batches_tracked", ())])

    s = cfg["swin"]
    dim, w = s["embed_dims"], s["window_size"]
    conv("backbone.patch_embed.projection", dim, 3, 4, bias=True)
    norm("backbone.patch_embed.norm", dim)
    for i, depth in enumerate(s["depths"]):
        for j in range(depth):
            name = f"backbone.stages.{i}.blocks.{j}"
            norm(name + ".norm1", dim)
            out.append((name + ".attn.w_msa.relative_position_bias_table",
                        ((2 * w - 1) ** 2, s["num_heads"][i])))
            linear(name + ".attn.w_msa.qkv", 3 * dim, dim)
            linear(name + ".attn.w_msa.proj", dim, dim)
            norm(name + ".norm2", dim)
            linear(name + ".ffn.layers.0.0", s["mlp_ratio"] * dim, dim)
            linear(name + ".ffn.layers.1", dim, s["mlp_ratio"] * dim)
        if i < len(s["depths"]) - 1:
            norm(f"backbone.stages.{i}.downsample.norm", 4 * dim)
            linear(f"backbone.stages.{i}.downsample.reduction", 2 * dim, 4 * dim, bias=False)
            dim *= 2
    for i in s["out_indices"]:
        norm(f"backbone.norm{i}", s["embed_dims"] * 2 ** i)
    ins, c = cfg["neck"]["in_channels"], cfg["neck"]["out_channels"]
    for i in range(len(ins) - 1):
        conv(f"neck.lateral_convs.{i}.conv", c, ins[i] + (ins[i + 1] if i == len(ins) - 2 else c), 1)
        bn(f"neck.lateral_convs.{i}.bn", c)
    for i in range(len(ins) - 1):
        conv(f"neck.fpn_convs.{i}.conv", c, c, 3)
        bn(f"neck.fpn_convs.{i}.bn", c)
    vt = cfg["vtransform"]
    C = vt["out_channels"]
    conv("vtransform.depthnet", depth_bins(cfg) + C, vt["in_channels"], 1, bias=True)
    for a, b in (("0", "1"), ("3", "4"), ("6", "7")):
        conv(f"vtransform.downsample.{a}", C, C, 3)
        bn(f"vtransform.downsample.{b}", C)
    cin = C
    for i, (n, cout, stride) in enumerate(cfg["decoder"]["blocks"]):
        for r in range(n):
            name = f"decoder.backbone.{i}.{r}"
            c0 = cin if r == 0 else cout
            conv(name + ".conv1", cout, c0, 3)
            bn(name + ".bn1", cout)
            conv(name + ".conv2", cout, cout, 3)
            bn(name + ".bn2", cout)
            if r == 0 and (stride != 1 or cin != cout):
                conv(name + ".downsample.0", cout, c0, 1)
                bn(name + ".downsample.1", cout)
        cin = cout
    nk = cfg["decoder"]["neck"]
    co = nk["out_channels"]
    conv("decoder.neck.fuse.0", co, sum(nk["in_channels"]), 1)
    bn("decoder.neck.fuse.1", co)
    conv("decoder.neck.fuse.3", co, co, 3)
    bn("decoder.neck.fuse.4", co)
    conv("decoder.neck.upsample.1", co, co, 3)
    bn("decoder.neck.upsample.2", co)
    for a, b in (("0", "1"), ("3", "4")):
        conv(f"head.classifier.{a}", co, co, 3)
        bn(f"head.classifier.{b}", co)
    conv("head.classifier.6", len(cfg["head"]["classes"]), co, 1, bias=True)
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Tensor]:
    """{name: tensor} of every parameter and BN running stat (f32; the BN
    counters int64), drawn from one ``randn`` of a generator on ``device``
    seeded with ``seed``: linear maps and the relative position bias tables
    N(0, 0.02); bias-free convolutions He normal over fan-out, with a bias
    LeCun normal; every bias 0; LayerNorm and BN scale 1, running stats 0
    and 1."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    names = {n for n, _ in shapes}
    normal, out = [], {}
    for name, shape in shapes:
        stem, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif len(shape) == 4:
            if stem + ".bias" in names:
                normal.append((name, shape, (shape[1] * shape[2] * shape[3]) ** -0.5))
            else:
                normal.append((name, shape, (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5))
        elif len(shape) == 2:
            normal.append((name, shape, 0.02))
        else:
            fill = 1.0 if leaf in ("weight", "running_var") else 0.0
            out[name] = torch.full(shape, fill, device=device)
    sizes = [torch.Size(s).numel() for _, s, _ in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for (name, shape, scale), chunk in zip(normal, flat.split(sizes)):
        out[name] = chunk.view(shape).mul(scale)
    return {n: out[n] for n, _ in shapes}
