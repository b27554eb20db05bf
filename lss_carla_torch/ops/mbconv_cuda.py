"""Build, bind and launch the CUDA depthwise-conv + BN-moments kernel
(``csrc/dw_conv_stats.cu``).

The kernel replaces ``lss_carla_tpu/ops/mbconv_pallas.py::_dw_stats_kernel``;
its source note says what bounds it and how. It is built by ``nvcc`` for
``sm_90a`` on first use (``ops/_nvcc.py``) and loaded with ``ctypes``.

Importing this module needs neither ``nvcc`` nor a GPU. ``dw_conv_stats_forward``
takes CUDA tensors only and raises on anything the kernel does not take: a
CPU tensor goes to the plain version (``ops/mbconv.py::dw_conv_stats_reference``)
in the caller, never here.

``launches`` counts the wrapper's calls that launched the kernel in this
process; ``chip_smoke.py`` sets it to 0 before it drives the main path and
reads it after.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from lss_carla_torch.ops._nvcc import NvccLibrary

launches = 0          # kernel launches in this process (plain int)

THREADS = 256         # threads a block (csrc/dw_conv_stats.cu: kThreads)
TARGET_BLOCKS = 8 * 132  # ~8 resident blocks on each of the H100's 132 SMs


def _declare(lib: ctypes.CDLL) -> None:
    lib.lss_dw_conv_stats.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.lss_dw_conv_stats.restype = ctypes.c_int


LIB = NvccLibrary("dw_conv_stats", _declare)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def same_pad_amounts(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" (low, high) padding of one axis of n for a k-tap conv at
    stride s: the output has ceil(n / s) entries, the low side gets
    ``total // 2``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def grid_slices(C: int, total: int) -> Tuple[int, int]:
    """(chunk, slices): each channel's ``total`` outputs cut into ``slices``
    contiguous runs of ``chunk`` (a multiple of THREADS), enough that the
    C x slices grid fills the card, never more than the outputs need."""
    want = max(1, min(math.ceil(TARGET_BLOCKS / C), math.ceil(total / THREADS)))
    chunk = math.ceil(math.ceil(total / want) / THREADS) * THREADS
    return chunk, math.ceil(total / chunk)


def dw_conv_stats_forward(x: torch.Tensor, w: torch.Tensor, stride: int):
    """x (N, C, H, W) f32/bf16, w (C, 1, k, k) -> (y (N, C, Ho, Wo) in x's
    dtype, sum (C,) f32, sumsq (C,) f32), SAME padding, Ho = ceil(H/s).

    The weights are rounded to x's dtype, then used in f32 (as the JAX
    package casts them). CUDA tensors only; raises on anything the kernel
    does not take."""
    global launches
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("dw_conv_stats_forward takes CUDA tensors; CPU "
                         "tensors go to ops.mbconv.dw_conv_stats_reference")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16 only")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x {tuple(x.shape)}: want a contiguous (N, C, H, W)")
    N, C, H, W = x.shape
    k = w.shape[-1]
    if tuple(w.shape) != (C, 1, k, k) or k not in (3, 5):
        raise ValueError(f"w {tuple(w.shape)}: want (C={C}, 1, k, k), k 3 or 5")
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}: 1 or 2 only")
    Ho, Wo = -(-H // stride), -(-W // stride)
    total = N * Ho * Wo
    if total >= 2 ** 31:
        raise ValueError(f"{total} outputs a channel: the kernel indexes "
                         "them with 32-bit ints")
    y = torch.empty((N, C, Ho, Wo), dtype=x.dtype, device=x.device)
    sums = torch.empty(C, dtype=torch.float32, device=x.device)
    sumsq = torch.empty(C, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, sums.zero_(), sumsq.zero_()
    wf = w.to(x.dtype).to(torch.float32).reshape(C, k * k).contiguous()
    chunk, slices = grid_slices(C, total)
    partial = torch.empty((2, C, slices), dtype=torch.float32, device=x.device)
    pad_h = same_pad_amounts(H, k, stride)[0]
    pad_w = same_pad_amounts(W, k, stride)[0]
    lib = LIB.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lss_dw_conv_stats(
            x.data_ptr(), _DTYPES[x.dtype], wf.data_ptr(), y.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), sumsq.data_ptr(), N, C, H,
            W, k, stride, Ho, Wo, pad_h, pad_w, chunk, slices, stream)
    LIB.check(rc, "dw_conv_stats kernel")
    launches += 1
    return y, sums, sumsq
