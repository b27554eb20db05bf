"""The chip's published peaks, the bytes each hand-written kernel's call
needs, and the model's FLOPs.

Peaks are NVIDIA's data sheet for the H100 SXM, dense, at its full 700 W:
989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s f32 outside the tensor
cores, 3.35 TB/s of HBM. A card set below 700 W (``nvidia-smi``'s
``power.limit``, which every run prints) reaches less.

``splat_bytes`` and ``dw_bytes`` are ``chip_smoke.py``'s ``splat_bound``
and ``dw_bound``, copied: every byte a call must read or write once,
whatever the kernel reads again. ``model_flops`` counts the reference
model's convolutions and matrix products with
``torch.utils.flop_counter.FlopCounterMode`` at the cell's shapes, on the
meta device (no memory, no arithmetic), so the count is the model's,
whatever kernels run it; elementwise work is not counted.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def splat_bytes(valid_points: int, total_points: int, channels: int,
                item_bytes: int, batch: int, num_slots: int) -> int:
    """Every id (int32), the features of in-grid points only, the dense
    output once."""
    return (total_points * 4 + valid_points * channels * item_bytes
            + batch * num_slots * channels * item_bytes)


def splat_seconds(valid_points, total_points, channels, item_bytes, batch,
                  num_slots) -> float:
    """The call's least time: its bytes over the memory rate, or its f32
    adds over the f32 rate where that is longer."""
    b = splat_bytes(valid_points, total_points, channels, item_bytes, batch,
                    num_slots) / HBM_BYTES_PER_S
    return max(b, valid_points * channels / F32_FLOPS)


def dw_bytes(shape, k: int, s: int, item_bytes: int) -> int:
    """x read once, y written once, the f32 weights and two moment
    vectors."""
    N, C, H, W = shape
    outs = N * C * -(-H // s) * -(-W // s)
    return (N * C * H * W + outs) * item_bytes + C * k * k * 4 + 2 * C * 4


def dw_seconds(shape, k: int, s: int, item_bytes: int) -> float:
    N, C, H, W = shape
    outs = N * C * -(-H // s) * -(-W // s)
    return max(dw_bytes(shape, k, s, item_bytes) / HBM_BYTES_PER_S,
               outs * (2 * k * k + 3) / F32_FLOPS)


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **kw) -> int:
    """The input and weight gradients of a (not transposed) convolution,
    each as many FLOPs as its forward. torch's own formula counts a grouped
    convolution's weight gradient as a dense one, ``groups`` times too
    many."""
    if transposed:
        raise NotImplementedError("no transposed convolution in the model")
    forward = 2 * grad_out_shape[0] * math.prod(grad_out_shape[2:]) * math.prod(w_shape)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def model_flops(cfg: dict, batch: int, train: bool) -> Dict[str, float]:
    """{"forward": ..., "total": ...} FLOPs of the reference model on
    ``batch`` samples; ``total`` adds the backward when ``train``. The lift
    and the BEV encoder are counted; the geometry's 3 x 3 products and the
    splat's adds are not."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import lss
    from benchmark.reference.train import BUFFER_SUFFIXES
    meta = torch.device("meta")
    p = {}
    for n, s in lss.param_shapes(cfg):
        buffer = n.endswith(BUFFER_SUFFIXES)
        p[n] = torch.empty(s, device=meta, requires_grad=not buffer,
                           dtype=torch.int64 if n.endswith("tracked") else None)
    D = len(torch.arange(*cfg["grid"]["dbound"]))
    _, _, (X, Y, Z) = lss.grid_dims(cfg["grid"])
    fH, fW = cfg["final_dim"]
    imgs = torch.empty(batch, cfg["ncams"], 3, fH, fW, device=meta)
    bev = torch.empty(batch, Z * cfg["camC"], X, Y, device=meta,
                      requires_grad=True)
    net = lss.Net(p, cfg["variant"], train)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: conv_backward_flops})
    with counter:
        out = net.lift(imgs, D, cfg["camC"]).sum() + net.bev(bev).sum()
    forward = float(counter.get_total_flops())
    if not train:
        return {"forward": forward, "total": forward}
    with counter:
        out.backward()
    return {"forward": forward, "total": forward + float(counter.get_total_flops())}
