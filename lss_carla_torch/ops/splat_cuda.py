"""Build, bind and launch the CUDA splat kernel (``csrc/splat.cu``).

The kernel replaces ``lss_carla_tpu/ops/splat_pallas.py::_splat_kernel``;
its source note says what bounds it and how. It is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``. The build runs on first use, from the sources in this
package only, into ``lss_carla_torch/_build/``, keyed by a hash of the
source and flags, so a fresh checkout builds it by itself.

Importing this module needs neither ``nvcc`` nor a GPU; only ``build()``
and ``splat_forward()`` do. ``splat_forward`` takes CUDA tensors only: a
CPU tensor goes to the plain version (``ops/splat.py::splat_reference``)
in the caller, never here.

``launches`` counts the kernel launches of this process; ``chip_smoke.py``
sets it to 0 before it drives the main path and reads it after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "splat.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0          # kernel launches in this process (plain int)
build_log = ""        # nvcc/ptxas output of the build this process ran

_lib = None
_lock = threading.Lock()


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "cannot build the CUDA splat kernel: nvcc not found (looked in "
        f"$CUDA_HOME/bin={cuda_home}/bin and on PATH)")


def library_path() -> Path:
    """Where the build for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsplat_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/splat.cu`` unless a build of this exact source exists.

    Raises RuntimeError when nvcc is missing or the compile fails."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: another process sees all or nothing
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lss_splat_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            lib.lss_splat_forward.restype = ctypes.c_int
            lib.lss_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lss_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


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
    lib = _load()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = lib.lss_splat_forward(pts.data_ptr(), _DTYPES[pts.dtype],
                                   ids.data_ptr(), acc.data_ptr(), B, P, C,
                                   num_slots, stream)
    if rc != 0:
        raise RuntimeError(f"splat kernel launch failed: "
                           f"{lib.lss_cuda_error_string(rc).decode()}")
    launches += 1
    return acc if pts.dtype == torch.float32 else acc.to(pts.dtype)
