"""The native decode path shared by the SimBEV and nuScenes datasets: the
port's counterpart of ``lss_carla_tpu/data/decode.py``.

``NativeDecoder.decode`` turns one camera file and one augmentation draw
into a CHW image, uint8 with ``device_normalize`` (normalised on the
device) or ImageNet-normalised float32:

* the crop-only C++ kernel when ``resize_dims`` equals the configured
  source size and there is no flip (PIL's own pixels where both link the
  same libjpeg IDCT);
* the fused C++ decode + resize + crop (+ flip) kernel otherwise
  (PIL-convention bicubic, within 1/255 of PIL);
* PIL (``augment.img_transform``) for what the C++ code does not cover:
  a rotation other than 0 and a file that is not a JPEG, and a JPEG the
  C++ code refuses (PIL is lenient with files libjpeg rejects);
* PIL for everything with ``use_native=False``, the one way to ask for it.

Departures from the JAX decoder (``ROADMAP.md`` §C): a library that cannot
build raises here, with g++'s output, where JAX quietly decodes with PIL;
and every decode is counted in ``stats`` by path and reason, where JAX
warns once.
"""

from __future__ import annotations

import collections
import threading
from pathlib import Path
from typing import Tuple

import numpy as np
from PIL import Image

from lss_carla_torch.data.augment import img_transform
from lss_carla_torch.ops.image import normalize_img

JPEG_SUFFIXES = (".jpg", ".jpeg")

# the datasets' and train()'s default: the C++ decoder, as in JAX. It
# stays on while chip_smoke.py phase 20 reads it at least as fast as PIL on
# the card's host (PERF.md, host decoder).
USE_NATIVE = True


class NativeDecoder:
    """Decode path of one dataset. ``src_wh`` is the configured source size
    ``(W, H)``. ``stats`` counts decodes: ``native_crop``,
    ``native_resize``, and the PIL ones by reason, ``pil_off``
    (``use_native=False``), ``pil_rotate``, ``pil_not_jpeg``,
    ``pil_size_mismatch`` (the file is not ``src_wh``) and
    ``pil_decode_error``."""

    def __init__(self, src_wh: Tuple[int, int], device_normalize: bool,
                 use_native: bool = USE_NATIVE):
        self.src_wh = tuple(src_wh)
        self.device_normalize = device_normalize
        self.use_native = use_native
        self.stats = collections.Counter()
        self._lock = threading.Lock()
        self._warned = False
        if use_native:
            from lss_carla_torch.native import fastimage
            fastimage.load()  # builds now, and raises if it cannot

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def _native(self, path: Path, resize_dims, crop, flip) -> np.ndarray:
        from lss_carla_torch.native import fastimage as fi
        raw = path.read_bytes()
        if not flip and tuple(resize_dims) == self.src_wh:
            fn = fi.decode_crop_u8 if self.device_normalize \
                else fi.decode_crop_normalize
            out = fn(raw, crop, self.src_wh)
            self._count("native_crop")
            return out
        fn = fi.decode_resize_crop_u8 if self.device_normalize \
            else fi.decode_resize_crop_normalize
        out = fn(raw, resize_dims, crop, flip)
        self._count("native_resize")
        return out

    def _pil(self, path: Path, resize, resize_dims, crop, flip,
             rotate) -> np.ndarray:
        img, _, _ = img_transform(Image.open(path), resize, resize_dims,
                                  crop, flip, rotate)
        rgb = np.asarray(img.convert("RGB"))
        chw = (rgb if self.device_normalize else normalize_img(rgb))
        return np.ascontiguousarray(chw.transpose(2, 0, 1))

    def decode(self, img_path, aug) -> np.ndarray:
        """The CHW image of ``img_path`` under ``aug`` = (resize,
        resize_dims, crop, flip, rotate); its homography is
        ``augment.post_homography(resize, crop, flip, rotate)`` on every
        path."""
        resize, resize_dims, crop, flip, rotate = aug
        path = Path(img_path)
        if not self.use_native:
            reason = "pil_off"
        elif rotate != 0.0:
            reason = "pil_rotate"
        elif path.suffix.lower() not in JPEG_SUFFIXES:
            reason = "pil_not_jpeg"
        else:
            try:
                return self._native(path, resize_dims, crop, flip)
            except ValueError as e:  # the C++ code's rc != 0
                reason = ("pil_size_mismatch" if "rc=3" in str(e)
                          else "pil_decode_error")
                if not self._warned:
                    self._warned = True
                    print(f"native decode of {path.name} refused ({e}); "
                          f"PIL decodes it (every such file is counted in "
                          f"stats[{reason!r}])")
        self._count(reason)
        return self._pil(path, resize, resize_dims, crop, flip, rotate)
