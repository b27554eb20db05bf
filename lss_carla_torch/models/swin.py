"""Swin Transformer camera trunk (Liu et al., ICCV 2021) with the equations
of mmdetection's ``SwinTransformer`` (``mmdet/models/backbones/swin.py``),
which BEVFusion's camera encoder imports; the module names are mmdet's, so
its checkpoints' parameter names are these.

* ``PatchEmbed``: a 4 x 4 stride-4 conv with bias (the image zero-padded on
  the right and bottom to a multiple of 4), then a LayerNorm over tokens.
* ``SwinBlock``: pre-norm LayerNorm, window attention (W-MSA, or SW-MSA in
  every second block), a residual; pre-norm LayerNorm, an MLP with exact
  GELU, a residual. Each residual branch passes a ``DropPath`` of its
  block's rate (0 to ``drop_path_rate``, linearly over the blocks).
* ``ShiftWindowMSA``: the token map zero-padded on the right and bottom to
  a multiple of the window (padded tokens are attended, as in mmdet), for
  SW-MSA rolled by ``-shift`` on both axes with the mask of shifted regions
  (-100 between tokens of different regions), cut into windows, attended,
  put back, rolled back and cropped.
* ``WindowMSA``: qkv with bias, a learned relative position bias table of
  (2w - 1)^2 x heads, softmax(q k^T / sqrt(d) + bias + mask) v, a
  projection. The attention runs through ``ops/window_attention.py``.
* ``PatchMerging``: 2 x 2 neighbours concatenated as mmcv's ``nn.Unfold``
  orders them (channel-major, then row, then column), LayerNorm, a linear
  map 4C -> 2C without bias; an odd side is zero-padded first.
* A LayerNorm on each output stage (``norm1``, ``norm2``, ``norm3``).

Compute dtype: every layer computes in its input's dtype, which the trunk
casts its images to: ``Linear`` and ``LayerNorm`` cast their f32
parameters to it (LayerNorm's statistics are f32 inside the kernel on
both devices), attention takes the bias in that dtype and accumulates its
softmax in f32. Parameters stay f32. Outputs are NCHW.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lss_carla_torch.models.layers import Conv2d
from lss_carla_torch.ops.window_attention import window_attention

# Swin-T: embedding width, blocks and heads of each stage, window, MLP
# ratio, and the stages put out (192, 384 and 768 channels at strides 8,
# 16 and 32)
EMBED, DEPTHS, HEADS, WINDOW, MLP_RATIO, OUT_INDICES = 96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 4, (1, 2, 3)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype (the f32 weight and bias cast)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in its input's dtype (the f32 affine cast)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class DropPath(nn.Module):
    """Stochastic depth (mmcv's ``DropPath``): in training, each sample's
    branch is zeroed with probability ``p`` and the rest scaled by
    1 / (1 - p); the identity in eval mode or at ``p`` 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if self.p == 0.0 or not self.training:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = (keep + torch.rand(shape, device=x.device)).floor_()
        return x * (mask / keep).to(x.dtype)


def relative_position_index(w: int) -> torch.Tensor:
    """(w^2, w^2) index into the bias table of every (query, key) pair of a
    window: (dy + w - 1) (2w - 1) + dx + w - 1 (mmdet's ``double_step_seq``
    arithmetic, row-major tokens)."""
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    ys, xs = ys.flatten(), xs.flatten()
    dy = ys[:, None] - ys[None, :] + w - 1
    dx = xs[:, None] - xs[None, :] + w - 1
    return dy * (2 * w - 1) + dx


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) with H and W multiples of w -> (B, windows, w*w, C),
    windows row-major."""
    B, H, W, C = x.shape
    x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // w) * (W // w), w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    """``window_partition``'s inverse: (B, windows, w*w, C) -> (B, H, W, C)."""
    B, C = x.shape[0], x.shape[-1]
    x = x.view(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def shift_mask(H: int, W: int, w: int, s: int, device) -> torch.Tensor:
    """(windows, w*w, w*w) f32 mask of a padded H x W map rolled by -s:
    0 between tokens of one region, -100 between regions (the regions are
    the slices [0, H-w), [H-w, H-s), [H-s, H) on each axis)."""
    rows = torch.arange(H, device=device)
    cols = torch.arange(W, device=device)
    rh = (rows >= H - w).long() + (rows >= H - s).long()
    rw = (cols >= W - w).long() + (cols >= W - s).long()
    region = (rh[:, None] * 3 + rw[None, :])[None, :, :, None]
    win = window_partition(region, w)[..., 0][0]             # (windows, T)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(torch.float32)


class WindowMSA(nn.Module):
    """Multi-head self-attention inside windows with a relative position
    bias. Takes (B, windows, T, C) tokens and, for shifted windows, the
    (windows, T, T) mask."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window), persistent=False)
        self.qkv = Linear(dim, 3 * dim, bias=True)
        self.proj = Linear(dim, dim)

    def position_bias(self) -> torch.Tensor:
        """(heads, T, T) f32, contiguous: the table read at every pair's
        index. (PyTorch's fused attention kernels take a bias whose last
        axis is contiguous; on another they fall back to the plain path.)"""
        T = self.window ** 2
        idx = self.relative_position_index.reshape(-1)
        return self.relative_position_bias_table[idx].view(T, T, -1).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        B, nW, T, C = x.shape
        h = self.heads
        # (3, B, windows, heads, T, d): one layout for both kinds
        qkv = self.qkv(x).view(B, nW, T, 3, h, C // h).permute(3, 0, 1, 4, 2, 5)
        bias = self.position_bias()[None]
        if mask is None:       # the windows on the batch axis, one bias a head
            q, k, v = qkv.reshape(3, B * nW, h, T, C // h).unbind(0)
        else:                  # the windows on the heads axis, each its mask
            q, k, v = qkv.reshape(3, B, nW * h, T, C // h).unbind(0)
            bias = (bias + mask[:, None]).reshape(1, nW * h, T, T)
        out = window_attention(q, k, v, bias.to(x.dtype), B * nW, mask is not None)
        out = out.reshape(B, nW, h, T, C // h).transpose(2, 3).reshape(B, nW, T, C)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    """W-MSA (``shift`` 0) or SW-MSA over a token map, padded to whole
    windows, then the branch's ``DropPath`` (mmdet's ``ShiftWindowMSA``)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 drop_path: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.w_msa = WindowMSA(dim, heads, window)
        self.drop = DropPath(drop_path)
        self._masks = {}

    def mask(self, H: int, W: int, device) -> torch.Tensor:
        """The shift mask of a padded H x W map, made once a size and
        device (a first, eager call makes it, so a graph's capture finds
        it)."""
        key = (H, W, str(device))
        if key not in self._masks:
            self._masks[key] = shift_mask(H, W, self.window, self.shift, device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        B, L, C = x.shape
        H, W = hw
        w, s = self.window, self.shift
        x = x.view(B, H, W, C)
        pad_r, pad_b = (w - W % w) % w, (w - H % w) % w
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        if s:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        x = self.w_msa(window_partition(x, w), self.mask(Hp, Wp, x.device) if s else None)
        x = window_reverse(x, w, Hp, Wp)
        if s:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = x[:, :H, :W].reshape(B, H * W, C)
        return self.drop(x)


class FFN(nn.Module):
    """Linear -> GELU -> Linear, added to ``identity`` through a
    ``DropPath`` (mmcv's ``FFN`` with two layers and no dropout)."""

    def __init__(self, dim: int, hidden: int, drop_path: float):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(Linear(dim, hidden), nn.GELU()),
                                    Linear(hidden, dim))
        self.dropout_layer = DropPath(drop_path)

    def forward(self, x, identity):
        return identity + self.dropout_layer(self.layers(x))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, window: int,
                 shifted: bool, drop_path: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = ShiftWindowMSA(dim, heads, window, window // 2 if shifted else 0,
                                   drop_path)
        self.norm2 = LayerNorm(dim)
        self.ffn = FFN(dim, hidden, drop_path)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return self.ffn(self.norm2(x), identity=x)


class PatchMerging(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = LayerNorm(4 * cin)
        self.reduction = Linear(4 * cin, cout, bias=False)

    def forward(self, x, hw):
        B, L, C = x.shape
        H, W = hw
        x = F.pad(x.view(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        H2, W2 = (H + 1) // 2, (W + 1) // 2
        x = x.view(B, H2, 2, W2, 2, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, H2 * W2, 4 * C)
        return self.reduction(self.norm(x)), (H2, W2)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int = 4):
        super().__init__()
        self.patch = patch
        self.projection = Conv2d(3, dim, patch, stride=patch)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        p = self.patch
        x = F.pad(x, (0, -x.shape[-1] % p, 0, -x.shape[-2] % p))
        x = self.projection(x)
        hw = (x.shape[2], x.shape[3])
        return self.norm(x.flatten(2).transpose(1, 2)), hw


class SwinStage(nn.Module):
    def __init__(self, blocks: List[SwinBlock], downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin-T: (B, 3, H, W) images -> the ``OUT_INDICES`` stages'
    LayerNormed outputs, NCHW in the compute dtype."""

    def __init__(self, drop_path_rate: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(EMBED)
        rates = torch.linspace(0, drop_path_rate, sum(DEPTHS), device="cpu").tolist()
        self.stages = nn.ModuleList()
        dim, first = EMBED, 0
        for i, depth in enumerate(DEPTHS):
            blocks = [SwinBlock(dim, HEADS[i], MLP_RATIO * dim, WINDOW, j % 2 == 1,
                                rates[first + j]) for j in range(depth)]
            last = i == len(DEPTHS) - 1
            self.stages.append(SwinStage(blocks, None if last else PatchMerging(dim, 2 * dim)))
            first += depth
            dim *= 2
        for i in OUT_INDICES:
            self.add_module(f"norm{i}", LayerNorm(EMBED * 2 ** i))

    def forward(self, x) -> List[torch.Tensor]:
        x, hw = self.patch_embed(x.to(self.compute_dtype))
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x, hw)
            if i in OUT_INDICES:
                out = getattr(self, f"norm{i}")(x)
                outs.append(out.view(x.shape[0], *hw, -1).permute(0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
        return outs
