"""Build a CUDA source of this package into a shared library, on first use.

Every kernel of the port is one ``csrc/*.cu`` file with a plain C
interface. ``NvccLibrary`` compiles it with ``nvcc`` for ``sm_90a`` into
``lss_carla_torch/_build/``, keyed by a hash of the source and flags, so a
fresh checkout builds it by itself and an edited source builds anew. The
compile writes a temporary file that is renamed into place, so a process
that races another sees the whole library or none. ``load()`` opens it
with ``ctypes``.

Importing this module needs neither ``nvcc`` nor a GPU; only ``build()``
and ``load()`` do. Builds of different sources may run at once (one
``nvcc`` each), as ``chip_smoke.py`` starts them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc not found (looked in "
        f"$CUDA_HOME/bin={cuda_home}/bin and on PATH)")


class NvccLibrary:
    """One ``csrc/<name>.cu`` and the library built from it.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the library's C
    functions; it runs once, when the library is first loaded.
    ``build_log`` holds nvcc's and ptxas's output of the build this
    process ran ("" when a build of this exact source already existed)."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = PKG / "csrc" / f"{name}.cu"
        self.build_log = ""
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        """Where the build for the current source and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a build of it exists. Raises
        RuntimeError when nvcc is missing or the compile fails."""
        out = self.library_path()
        if out.exists():
            return out
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                               str(self.source)],
                              capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc {self.source.name} failed "
                               f"({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, out)  # atomic: another process sees all or nothing
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                lib.lss_cuda_error_string.argtypes = [ctypes.c_int]
                lib.lss_cuda_error_string.restype = ctypes.c_char_p
                self._declare(lib)
                self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise on a non-zero ``cudaError_t`` a C launcher returned."""
        if rc != 0:
            msg = self.load().lss_cuda_error_string(rc).decode()
            raise RuntimeError(f"{what} launch failed: {msg}")
