"""Build, bind and launch the CUDA depthwise-conv + BN-moments kernel
(``csrc/dw_conv_stats.cu``).

The kernel replaces ``lss_carla_tpu/ops/mbconv_pallas.py::_dw_stats_kernel``;
its source note says what bounds it and how. It is built by ``nvcc`` for
``sm_90a`` on first use (``ops/_nvcc.py``) and loaded with ``ctypes``.

Importing this module needs neither ``nvcc`` nor a GPU. ``plan_tiles`` is
plain Python: it cuts a call's outputs into the kernel's tiles, and the
CPU tests check that its tiles cover every output once.
``dw_conv_stats_forward`` takes CUDA tensors only and raises on anything
the kernel does not take: a CPU tensor goes to the plain version
(``ops/mbconv.py::dw_conv_stats_reference``) in the caller, never here.

``launches`` counts the wrapper's calls that launched the kernel in this
process, and ``launches_by_dtype`` the same calls by x's dtype;
``captured_by_dtype`` counts the calls made while a CUDA graph was being
captured on the current stream, which recorded the kernel into the graph
and launched nothing (the graph's replays launch it and count it in
``utils/graph.py::replayed``). ``chip_smoke.py`` sets
them to 0 (``reset_launches``) before it drives a path and reads them
after.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from lss_carla_torch.ops._nvcc import NvccLibrary

launches = 0          # kernel launches in this process (plain int)
launches_by_dtype = {"float32": 0, "bfloat16": 0}  # the same, by input dtype
captured_by_dtype = {"float32": 0, "bfloat16": 0}  # recorded into a graph

STRIP = 4             # outputs a thread computes side by side (kStrip)
MAX_THREADS = 256     # threads a block, at most (kMaxThreads)
MAX_STRIPS = 64       # strips across a column tile: tiles of <= 256 outputs
MAX_PASSES = 4        # strip rows a thread takes in one block, at most
TARGET_BLOCKS = 4 * 132  # ~4 blocks on each of the H100's 132 SMs
SMEM_TARGET = 48 * 1024  # staged bytes a block, where the plan allows
SMEM_LIMIT = 232448   # 227 KB, the most a block may have (kMaxSmem)


def _declare(lib: ctypes.CDLL) -> None:
    lib.lss_dw_conv_stats.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 20 + [ctypes.c_void_p])
    lib.lss_dw_conv_stats.restype = ctypes.c_int


LIB = NvccLibrary("dw_conv_stats", _declare)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_dtype`` and
    ``captured_by_dtype`` count to 0."""
    global launches
    launches = 0
    for counts in (launches_by_dtype, captured_by_dtype):
        for key in counts:
            counts[key] = 0


def _count(dtype: torch.dtype) -> None:
    """Count one call that ran the kernel: a launch, or, under a stream
    capture, a kernel recorded into the graph."""
    global launches
    key = str(dtype).removeprefix("torch.")
    if torch.cuda.is_current_stream_capturing():
        captured_by_dtype[key] += 1
    else:
        launches += 1
        launches_by_dtype[key] += 1


def same_pad_amounts(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" (low, high) padding of one axis of n for a k-tap conv at
    stride s: the output has ceil(n / s) entries, the low side gets
    ``total // 2``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class DWPlan(NamedTuple):
    """How the kernel cuts one call: block (t, c) of a (tiles, C) grid
    takes ``pb`` images x a band of ``th`` output rows x a column tile of
    ``tw`` outputs. ``threads`` = ``rg`` strip rows x ``sw`` strips of
    STRIP outputs, rounded up to a warp; a thread steps ``rg`` rows at a
    time. Shared memory (``smem_bytes``) holds, for each of the ``pb``
    images, its band of (th - 1) s + k rows of ``pitch`` f32 (at stride 2
    the even columns, then the odd ones) and, for bf16, a raw slot of
    ``rawstride`` bytes for the input rows it is widened from."""
    Ho: int
    Wo: int
    pad_h: int
    pad_w: int
    tw: int
    tiles_w: int
    sw: int
    rg: int
    threads: int
    th: int
    bands: int
    pb: int
    groups: int
    tiles: int
    pitch: int
    rawstride: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan_tiles(N: int, C: int, H: int, W: int, k: int, s: int,
               bf16: bool = False) -> DWPlan:
    """The kernel's tiles for x (N, C, H, W), a k x k kernel at stride s.

    A block takes STRIP x MAX_PASSES x rg outputs or fewer: as many passes
    as keep at least TARGET_BLOCKS blocks on the card and the staged bands
    within SMEM_TARGET. Planes shorter than a block's rows are packed
    several images to a block; taller ones are cut into bands. Raises
    ValueError where even one-row bands overflow shared memory (rows of
    ~10,000 f32 and wider)."""
    Ho, Wo = _cdiv(H, s), _cdiv(W, s)
    tw = min(Wo, STRIP * MAX_STRIPS)
    tiles_w, sw = _cdiv(Wo, tw), _cdiv(tw, STRIP)
    rg = MAX_THREADS // sw
    threads = _cdiv(rg * sw, 32) * 32
    if s == 1:  # a strip's window: (STRIP - 1) + k columns, as float4s
        pitch = (sw - 1) * STRIP + _cdiv(STRIP - 1 + k, 4) * 4
    else:       # even and odd halves, each a strip's 4 + 2 columns and more
        pitch = 2 * ((sw - 1) * STRIP + 8)

    def layout(th, pb):
        ihb = (th - 1) * s + k
        # bf16 is copied raw first: a slot for an image's input rows
        rawstride = _cdiv(ihb * W * 2 + 32, 16) * 16 if bf16 else 0
        return rawstride, pb * (ihb * pitch * 4 + rawstride)

    best = None
    for passes in range(MAX_PASSES, 0, -1):
        rows = rg * passes
        if Ho <= rows:
            th, bands = Ho, 1
            groups = _cdiv(N, min(N, threads, rows // Ho))
            pb = _cdiv(N, groups)
        else:
            bands = _cdiv(Ho, rows)
            th, pb, groups = _cdiv(Ho, bands), 1, N
        while layout(th, pb)[1] > SMEM_LIMIT and (pb > 1 or th > 1):
            if pb > 1:
                pb -= 1
                groups = _cdiv(N, pb)
            else:
                th -= 1
                bands = _cdiv(Ho, th)
        rawstride, smem = layout(th, pb)
        tiles = groups * bands * tiles_w
        best = DWPlan(Ho, Wo, same_pad_amounts(H, k, s)[0],
                      same_pad_amounts(W, k, s)[0], tw, tiles_w, sw, rg,
                      threads, th, bands, pb, groups, tiles, pitch, rawstride,
                      smem)
        if smem <= SMEM_TARGET and tiles * C >= TARGET_BLOCKS:
            break
    if best.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"x {(N, C, H, W)}: rows too wide for the kernel's "
                         "shared memory")
    return best


# per (device, stream): the kernel's scratch, grown as needed. Partials
# (2, C, tiles) f32 are written before they are read; tickets (C,) int32
# start at 0 and every call leaves them at 0, so they are zeroed only
# when the buffer is made. Calls on one stream run in order, so they may
# share one buffer. A call under a stream capture takes scratch of its own
# from the graph's pool, which its replays use and no other call can
# grow, free or share.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, C: int, tiles: int):
    key = (device.index, stream)
    capturing = torch.cuda.is_current_stream_capturing()
    partial, tickets = (None, None) if capturing else _SCRATCH.get(key, (None, None))
    if partial is None or partial.numel() < 2 * C * tiles:
        partial = torch.empty(2 * C * tiles, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < C:
        tickets = torch.zeros(C, dtype=torch.int32, device=device)
    if not capturing:
        _SCRATCH[key] = (partial, tickets)
    return partial, tickets


def dw_conv_stats_forward(x: torch.Tensor, w: torch.Tensor, stride: int):
    """x (N, C, H, W) f32/bf16, w (C, 1, k, k) -> (y (N, C, Ho, Wo) in x's
    dtype, sum (C,) f32, sumsq (C,) f32), SAME padding, Ho = ceil(H/s).

    The kernel rounds the weights to x's dtype, then uses them in f32 (as
    the JAX package casts them). One launch a call and nothing else on the
    card when w is f32 and contiguous. CUDA tensors only; raises on
    anything the kernel does not take."""
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
    if C > 65535:
        raise ValueError(f"{C} channels: the kernel's grid takes <= 65535")
    Ho, Wo = -(-H // stride), -(-W // stride)
    if N * Ho * Wo >= 2 ** 31:
        raise ValueError(f"{N * Ho * Wo} outputs a channel: the kernel "
                         "indexes them with 32-bit ints")
    y = torch.empty((N, C, Ho, Wo), dtype=x.dtype, device=x.device)
    sums = torch.empty(C, dtype=torch.float32, device=x.device)
    sumsq = torch.empty(C, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, sums.zero_(), sumsq.zero_()
    wf = w.reshape(C, k * k)
    if wf.dtype != torch.float32 or not wf.is_contiguous():
        wf = wf.to(torch.float32).contiguous()
    pl = plan_tiles(N, C, H, W, k, stride, x.dtype == torch.bfloat16)
    lib = LIB.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial, tickets = _scratch(x.device, stream, C, pl.tiles)
        rc = lib.lss_dw_conv_stats(
            x.data_ptr(), _DTYPES[x.dtype], wf.data_ptr(), y.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), sums.data_ptr(),
            sumsq.data_ptr(), N, C, H, W, k, stride, Ho, Wo, pl.pad_h,
            pl.pad_w, pl.tw, pl.tiles_w, pl.sw, pl.rg, pl.th, pl.bands,
            pl.pb, pl.pitch, pl.rawstride, pl.threads, stream)
    LIB.check(rc, "dw_conv_stats kernel")
    _count(x.dtype)
    return y, sums, sumsq
