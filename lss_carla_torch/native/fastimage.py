"""ctypes binding for the native JPEG decode + crop (+ resize + flip) +
normalize pipeline: the port's own copy of
``lss_carla_tpu/native/fastimage.py``, over its own copy of the C++ source.

``fastimage.cpp`` is host code. ``build()`` compiles it with ``g++ -O3
-march=native -shared -fPIC`` on first use into ``lss_carla_torch/_build/``,
keyed by a hash of the source, the flags, the libjpeg it links and the
host's CPU model (``-march=native`` code is not portable across CPUs, so a
checkout copied to another host builds anew). The compile writes a
temporary file per process that is renamed into place, so processes that
race (xdist workers, loader and tests) see the whole library or none.

It links the libjpeg that Pillow's wheel bundles, through the repo's copy
of the version-62 headers (``native/include``): PIL and this code then run
one IDCT, and the build needs no libjpeg headers on the host. A Pillow
without a bundled libjpeg raises at build time. ``load()`` decodes a small
JPEG and raises unless the library gives it back, so a libjpeg whose ABI
differs from the headers fails there (its ``jpeg_CreateDecompress`` checks
version and struct size).

A build that fails raises ``RuntimeError`` with g++'s output: nothing here
falls back to PIL. ``data/decode.py::NativeDecoder(use_native=False)`` is
the one way to decode with PIL instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from lss_carla_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "native" / "fastimage.cpp"
HEADERS = PKG / "native" / "include"
BUILD_DIR = PKG / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_MEAN = np.ascontiguousarray(IMAGENET_MEAN, dtype=np.float32)
_INV_STD = np.ascontiguousarray(1.0 / IMAGENET_STD, dtype=np.float32)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # g++'s output of the build this process ran


def cpu_model() -> str:
    """The host CPU's model name and feature flags, which ``-march=native``
    compiles for."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags") and key not in fields:
                    fields[key] = value.strip()
    except OSError:
        pass
    return " | ".join(fields.get(k, "") for k in ("model name", "flags")) \
        or platform.processor() or platform.machine()


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("cannot build the native JPEG decoder: g++ not "
                           "found on PATH")
    return gxx


def pillow_libjpeg() -> Optional[Path]:
    """The libjpeg bundled in Pillow's wheel (``pillow.libs/``), or None."""
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg*.so*")) if libs.is_dir() else []
    return found[0] if found else None


def jpeg_link() -> Tuple[str, ...]:
    """g++'s arguments that compile and link against Pillow's bundled
    libjpeg with the repo's headers. Raises RuntimeError when Pillow bundles
    none."""
    lib = pillow_libjpeg()
    if lib is None:
        import PIL
        raise RuntimeError(
            "cannot build the native JPEG decoder: the Pillow at "
            f"{Path(PIL.__file__).parent} bundles no libjpeg (pillow.libs/"
            "libjpeg*.so*), and the decoder links only that one")
    return (f"-I{HEADERS}", str(lib), f"-Wl,-rpath,{lib.parent}")


def library_path() -> Path:
    """Where the build for this source, these flags, this libjpeg and this
    CPU lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    for header in sorted(HEADERS.glob("*.h")):
        h.update(header.read_bytes())
    h.update(" ".join(GXX_FLAGS + jpeg_link()).encode())
    h.update(cpu_model().encode())
    return BUILD_DIR / f"libfastimage_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a build of it exists. Raises RuntimeError
    when Pillow bundles no libjpeg or g++ is missing, and with g++'s output
    when the compile fails."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    gxx = find_gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), *jpeg_link(), "-o",
                           str(tmp)], capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{build_log}")
    os.replace(tmp, out)  # atomic: another process sees all or nothing
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i, f, u8 = ctypes.c_int, ctypes.POINTER(ctypes.c_float), \
        ctypes.POINTER(ctypes.c_ubyte)
    head = [ctypes.c_char_p, ctypes.c_long]
    signatures = {
        "decode_crop_normalize": head + [i] * 6 + [f, f, f],
        "decode_crop_u8": head + [i] * 6 + [u8],
        "jpeg_dims": head + [ctypes.POINTER(i)] * 2,
        "decode_resize_crop_u8": head + [i] * 7 + [u8],
        "decode_resize_crop_normalize": head + [i] * 7 + [f, f, f],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


def _self_test(lib: ctypes.CDLL) -> None:
    """Raise unless the library reads the size of a JPEG that PIL wrote."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGB", (24, 16), (10, 200, 30)).save(buf, format="JPEG")
    data = buf.getvalue()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0 or (w.value, h.value) != (24, 16):
        raise RuntimeError(
            f"the native JPEG decoder refuses a JPEG that PIL wrote (rc {rc},"
            f" dims {(w.value, h.value)}): the libjpeg it links "
            f"({' '.join(jpeg_link())}) does not match the headers it was "
            f"built with")


def load() -> ctypes.CDLL:
    """The library, built on first use; raises as ``build`` does, or when
    the library cannot decode (``_self_test``)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _self_test(lib)
            _lib = lib
    return _lib


def build_info() -> str:
    """g++'s version and the libjpeg the built library links (ldd)."""
    path = build()
    version = subprocess.run([find_gxx(), "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    ldd = subprocess.run(["ldd", str(path)], capture_output=True, text=True)
    jpeg = [ln.strip() for ln in ldd.stdout.splitlines() if "jpeg" in ln]
    return f"{version}; links {' '.join(jpeg) or 'no libjpeg (ldd)'}"


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def jpeg_dims(data: bytes) -> Tuple[int, int]:
    """(width, height) from a JPEG header; ValueError on a bad JPEG."""
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = load().jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError("invalid JPEG")
    return w.value, h.value


def _crop_args(crop, expected_dims):
    left, top, right, bottom = crop
    ew, eh = expected_dims if expected_dims is not None else (-1, -1)
    return left, top, right - left, bottom - top, ew, eh


def decode_crop_u8(data: bytes, crop: Tuple[int, int, int, int],
                   expected_dims: Optional[Tuple[int, int]] = None
                   ) -> np.ndarray:
    """JPEG bytes + crop box (l, t, r, b) -> uint8 CHW (3, b-t, r-l), for
    normalisation on the device.

    ``expected_dims`` (w, h): the decoded image must have exactly these
    dimensions (rc 3 otherwise). The crop-only kernel is PIL's only when
    the file already has the configured size, so callers pass the
    configured dims and a mismatched file raises instead of being cropped
    unresized."""
    left, top, w, h, ew, eh = _crop_args(crop, expected_dims)
    out = np.empty((3, h, w), dtype=np.uint8)
    rc = load().decode_crop_u8(data, len(data), left, top, w, h, ew, eh,
                               _u8(out))
    if rc != 0:
        raise ValueError(f"decode_crop_u8 failed (rc={rc})")
    return out


def decode_crop_normalize(data: bytes, crop: Tuple[int, int, int, int],
                          expected_dims: Optional[Tuple[int, int]] = None
                          ) -> np.ndarray:
    """As ``decode_crop_u8``, ImageNet-normalised float32 CHW."""
    left, top, w, h, ew, eh = _crop_args(crop, expected_dims)
    out = np.empty((3, h, w), dtype=np.float32)
    rc = load().decode_crop_normalize(data, len(data), left, top, w, h, ew,
                                      eh, _f32(_MEAN), _f32(_INV_STD),
                                      _f32(out))
    if rc != 0:
        raise ValueError(f"decode_crop_normalize failed (rc={rc})")
    return out


def decode_resize_crop_u8(data: bytes, resize_dims: Tuple[int, int],
                          crop: Tuple[int, int, int, int],
                          flip: bool = False) -> np.ndarray:
    """JPEG bytes -> PIL-convention bicubic resize to ``resize_dims`` (w, h)
    -> crop (l, t, r, b in resized coordinates; an overhang is zero-padded
    as PIL's ``crop`` pads it) -> optional horizontal flip -> uint8 CHW."""
    rw, rh = resize_dims
    left, top, w, h, _, _ = _crop_args(crop, None)
    out = np.empty((3, h, w), dtype=np.uint8)
    rc = load().decode_resize_crop_u8(data, len(data), rw, rh, left, top, w,
                                      h, int(flip), _u8(out))
    if rc != 0:
        raise ValueError(f"decode_resize_crop_u8 failed (rc={rc})")
    return out


def decode_resize_crop_normalize(data: bytes, resize_dims: Tuple[int, int],
                                 crop: Tuple[int, int, int, int],
                                 flip: bool = False) -> np.ndarray:
    """As ``decode_resize_crop_u8``, ImageNet-normalised float32 CHW
    (quantised to uint8 before the normalisation, as the PIL path is)."""
    rw, rh = resize_dims
    left, top, w, h, _, _ = _crop_args(crop, None)
    out = np.empty((3, h, w), dtype=np.float32)
    rc = load().decode_resize_crop_normalize(
        data, len(data), rw, rh, left, top, w, h, int(flip), _f32(_MEAN),
        _f32(_INV_STD), _f32(out))
    if rc != 0:
        raise ValueError(f"decode_resize_crop_normalize failed (rc={rc})")
    return out
