"""Post-training int8 for inference: counterpart of ``lss_carla_tpu/ops/quant.py``.

A trained model's dense convolutions run in int8 at inference, with no
retraining and no change to the model code: ``quantize_model`` swaps each
eligible ``nn.Conv2d`` of an eval-mode copy for an ``Int8Conv2d``.

* weights: per-output-channel symmetric int8, ``scale_c = max(max|W_c| /
  127, 1e-12)``, round half to even, clipped to +-127; computed once, when
  the module is swapped (the JAX package folds them to compile-time
  constants);
* activations: dynamic per-tensor symmetric int8 by the same formula, over
  the conv's whole input in f32 (a bf16 input is cast first), before any
  stride;
* the product: int32 accumulation, then ``acc * (x_scale * w_scale)`` in
  f32, the f32 bias added, and the result cast to the input's dtype.

The gate is the JAX interceptor's (``make_conv_interceptor``): a conv is
quantized only with ``groups == 1``, dilation 1 and ``min(cin, cout) >=
min_channels``. So depthwise convs, the stem (cin 3), the small SE convs
and the 1-channel BEV head stay in float. The interceptor's last rule, a
4-D input, is checked at the call: ``Int8Conv2d`` raises on any other.

On both devices a conv is an im2col of the int8 input (``Tensor.unfold``
views of the zero-padded tensor, copied once into (M, K) rows) followed by
``torch._int_mm`` (int8 x int8 -> int32; cuBLASLt on the card). ``_int_mm``
on CUDA takes M > 16 and K and N multiples of 8, so the rows, the reduction
and the output channels are padded with zeros where needed, which is exact
(``mm_shape``); the weight is stored padded. Nothing falls back to float:
an ``_int_mm`` that fails raises.

The activation scale is one per tensor over the whole device batch, so an
int8 answer depends on which samples share the batch (as in the JAX
package).

    from lss_carla_torch.ops.quant import quantize_model
    qmodel, swapped = quantize_model(model.eval(), min_channels=64)
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

QMAX = 127.0
MIN_SCALE = 1e-12
MIN_ROWS = 17   # _int_mm on CUDA: M > 16
ALIGN = 8       # _int_mm on CUDA: K and N multiples of 8


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW (or (cout, ...))
    weight: (w_i8, scale (cout,) f32). The reduction runs over every dim
    but the first, as the JAX package's runs over HWI."""
    w32 = w.detach().to(torch.float32)
    dims = tuple(range(1, w32.ndim))
    scale = torch.clamp_min(w32.abs().amax(dim=dims) / QMAX, MIN_SCALE)
    view = (-1,) + (1,) * (w32.ndim - 1)
    w_i8 = torch.clamp(torch.round(w32 / scale.view(view)), -QMAX, QMAX)
    return w_i8.to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: (x_i8, 0-d f32 scale)."""
    x32 = x.detach().to(torch.float32)
    scale = torch.clamp_min(x32.abs().amax() / QMAX, MIN_SCALE)
    x_i8 = torch.clamp(torch.round(x32 / scale), -QMAX, QMAX)
    return x_i8.to(torch.int8), scale


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def mm_shape(M: int, K: int, N: int) -> Tuple[int, int, int]:
    """The zero-padded (M, K, N) that ``torch._int_mm`` takes on CUDA."""
    return max(M, MIN_ROWS), _up(K, ALIGN), _up(N, ALIGN)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def im2col_int8(x_i8: torch.Tensor, kernel_size, stride, padding) -> torch.Tensor:
    """(B, C, H, W) int8 -> (B, Ho, Wo, C * kh * kw) int8 rows, the
    reduction in (C, kh, kw) order (an OIHW weight's flattening)."""
    (kh, kw), (sh, sw), (ph, pw) = (_pair(kernel_size), _pair(stride),
                                    _pair(padding))
    if ph or pw:
        x_i8 = F.pad(x_i8, (pw, pw, ph, ph))
    cols = x_i8.unfold(2, kh, sh).unfold(3, kw, sw)  # (B, C, Ho, Wo, kh, kw)
    B, C, Ho, Wo = cols.shape[:4]
    return cols.permute(0, 2, 3, 1, 4, 5).reshape(B, Ho, Wo, C * kh * kw)


def int_mm_padded(a: torch.Tensor, b_t: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``a @ b_t.T`` of int8 ``a`` (M, K) and ``b_t`` (Np, Kp), the
    weight already padded to ``mm_shape``: ``a`` is padded with zero rows
    and columns, and the (M, n) block of the product returned."""
    M, K = a.shape
    Mp, Kp, Np = mm_shape(M, K, b_t.shape[0])
    if (Np, Kp) != tuple(b_t.shape):
        raise ValueError(f"weight {tuple(b_t.shape)} is not padded to "
                         f"({Np}, {Kp})")
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    return torch._int_mm(a, b_t.t())[:M, :n]


def pad_weight(w_i8: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> (Np, Kp) int8 rows, zero-padded to ``mm_shape``."""
    N = w_i8.shape[0]
    w = w_i8.reshape(N, -1)
    _, Kp, Np = mm_shape(MIN_ROWS, w.shape[1], N)
    return F.pad(w, (0, Kp - w.shape[1], 0, Np - N)).contiguous()


def conv_int8_acc(x_i8, w_rows, cout: int, kernel_size, stride,
                  padding) -> torch.Tensor:
    """The int32 accumulator (B, Ho, Wo, cout) of an int8 conv: ``x_i8``
    (B, C, H, W), ``w_rows`` from ``pad_weight``."""
    cols = im2col_int8(x_i8, kernel_size, stride, padding)
    B, Ho, Wo, K = cols.shape
    acc = int_mm_padded(cols.reshape(-1, K), w_rows, cout)
    return acc.reshape(B, Ho, Wo, cout)


def _conv_int8(x, w_rows, w_scale, bias, cout: int, kernel_size, stride,
               padding) -> torch.Tensor:
    """``x`` quantized, the int32 conv, then ``acc * (x_scale * w_scale)``
    in f32 plus the f32 bias, in ``x``'s dtype, NCHW."""
    if x.dim() != 4:
        raise ValueError(f"an int8 conv takes a 4-D input, got {x.dim()}-D")
    x_i8, x_scale = quantize_activation(x)
    acc = conv_int8_acc(x_i8, w_rows, cout, kernel_size, stride, padding)
    y = acc.to(torch.float32) * (x_scale * w_scale)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.permute(0, 3, 1, 2).to(x.dtype)


def conv_int8(x, w_i8, w_scale, bias=None, stride=1, padding=0) -> torch.Tensor:
    """int8 x int8 -> int32 conv with f32 dequantisation, NCHW/OIHW:
    ``x`` (B, C, H, W) float, ``w_i8`` (cout, C, kh, kw) int8 with its
    per-channel ``w_scale``. Returns (B, cout, Ho, Wo) in ``x``'s dtype."""
    return _conv_int8(x, pad_weight(w_i8), w_scale, bias, w_i8.shape[0],
                      w_i8.shape[2:], stride, padding)


class Int8Conv2d(nn.Module):
    """An ``nn.Conv2d`` in int8 (inference only): the int8 weight rows and
    the per-channel scale are computed once, here, from the conv's f32
    weight; the bias stays f32. Same output shape and dtype as the conv."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
            raise ValueError(f"Int8Conv2d takes explicit zero padding, got "
                             f"{conv.padding!r} ({conv.padding_mode})")
        if conv.groups != 1 or tuple(conv.dilation) != (1, 1):
            raise ValueError("Int8Conv2d takes groups 1 and dilation 1")
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.kernel_size, self.stride = tuple(conv.kernel_size), tuple(conv.stride)
        self.padding = tuple(conv.padding)
        w_i8, w_scale = quantize_weight(conv.weight)
        self.register_buffer("w_rows", pad_weight(w_i8))
        self.register_buffer("w_scale", w_scale)
        self.register_buffer(
            "bias", None if conv.bias is None
            else conv.bias.detach().to(torch.float32).clone())

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size="
                f"{self.kernel_size}, stride={self.stride}, padding="
                f"{self.padding}, int8")

    def forward(self, x):
        return _conv_int8(x, self.w_rows, self.w_scale, self.bias,
                          self.out_channels, self.kernel_size, self.stride,
                          self.padding)


def eligible(conv: nn.Conv2d, min_channels: int) -> bool:
    """The JAX interceptor's gate, less the input's rank (checked at the
    call): groups 1, dilation 1, ``min(cin, cout) >= min_channels``."""
    return (conv.groups == 1 and tuple(conv.dilation) == (1, 1)
            and min(conv.in_channels, conv.out_channels) >= min_channels)


def quantize_model(model: nn.Module,
                   min_channels: int = 64) -> Tuple[nn.Module, List[str]]:
    """An int8 copy of an eval-mode ``model``: every eligible ``nn.Conv2d``
    replaced by an ``Int8Conv2d``. Returns (copy, the swapped modules'
    names in ``named_modules`` order). ``model`` is left as it was."""
    if model.training:
        raise ValueError("quantize_model takes a model in eval mode: int8 "
                         "is for inference only (call model.eval())")
    qmodel = copy.deepcopy(model)
    swapped = []
    for name, mod in list(qmodel.named_modules()):
        if isinstance(mod, nn.Conv2d) and eligible(mod, min_channels):
            parent_name, _, attr = name.rpartition(".")
            parent = qmodel.get_submodule(parent_name)
            parent._modules[attr] = Int8Conv2d(mod)
            swapped.append(name)
    return qmodel, swapped
