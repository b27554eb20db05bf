"""Build, bind and launch the CUDA splat kernel (``csrc/splat.cu``).

The kernel replaces ``lss_carla_tpu/ops/splat_pallas.py::_splat_kernel``;
its source note says what bounds it and how. It is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``, on first use (``ops/_nvcc.py``).

Importing this module needs neither ``nvcc`` nor a GPU; only ``build()``
and ``splat_forward()`` do. ``splat_forward`` takes CUDA tensors only: a
CPU tensor goes to the plain version (``ops/splat.py::splat_reference``)
in the caller, never here.

The wrapper zero-fills the f32 accumulator on the stream, launches the
kernel once, and for bf16 features rounds the accumulator to bf16.

``launches`` counts the kernel launches of this process; ``chip_smoke.py``
sets it to 0 before it drives the main path and reads it after.
"""

from __future__ import annotations

import ctypes

import torch

from lss_carla_torch.ops._nvcc import NvccLibrary

launches = 0          # kernel launches in this process (plain int)

TILE = 176            # consecutive points a block sorts and reduces (kTile)


def _declare(lib: ctypes.CDLL) -> None:
    lib.lss_splat_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.lss_splat_forward.restype = ctypes.c_int


LIB = NvccLibrary("splat", _declare)
build = LIB.build


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def splat_forward(pts: torch.Tensor, ids: torch.Tensor,
                  num_slots: int) -> torch.Tensor:
    """(B, P, C) f32/bf16 points + (B, P) int32 ids -> (B, num_slots, C).

    Sums in an f32 accumulator and returns the input dtype. Ids outside
    [0, num_slots) are dropped. CUDA tensors only; raises on anything the
    kernel does not take."""
    global launches
    if not (pts.is_cuda and ids.is_cuda):
        raise ValueError("splat_forward takes CUDA tensors; CPU tensors go "
                         "to ops.splat.splat_reference")
    if pts.device != ids.device:
        raise ValueError(f"pts on {pts.device}, ids on {ids.device}")
    if pts.dtype not in _DTYPES:
        raise TypeError(f"pts dtype {pts.dtype}: float32 or bfloat16 only")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids dtype {ids.dtype}: int32 only")
    if pts.dim() != 3 or ids.shape != pts.shape[:2]:
        raise ValueError(f"pts {tuple(pts.shape)} / ids {tuple(ids.shape)}: "
                         "want (B, P, C) and (B, P)")
    if not (pts.is_contiguous() and ids.is_contiguous()):
        raise ValueError("pts and ids must be contiguous")
    num_slots = int(num_slots)
    if num_slots <= 0:
        raise ValueError(f"num_slots must be positive, got {num_slots}")
    B, P, C = pts.shape
    acc = torch.zeros((B, num_slots, C), dtype=torch.float32,
                      device=pts.device)
    if pts.numel() == 0:
        return acc.to(pts.dtype)
    lib = LIB.load()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = lib.lss_splat_forward(pts.data_ptr(), _DTYPES[pts.dtype],
                                   ids.data_ptr(), acc.data_ptr(), B, P, C,
                                   num_slots, stream)
    LIB.check(rc, "splat kernel")
    launches += 1
    return acc if pts.dtype == torch.float32 else acc.to(pts.dtype)
