"""Config schemas: the port's own copy of ``lss_carla_tpu/configs.py``.

Frozen dataclasses carrying exactly the fields of the reference's two config
dicts (reference ``train_simbev.py:104-120``):

* ``grid_conf``: ``{xbound, ybound, zbound, dbound}``, each a
  ``[min, max, step]`` triple;
* ``data_aug_conf``: ``{resize_lim, final_dim, rot_lim, H, W, rand_flip,
  bot_pct_lim, Ncams}``.

``from_dict`` / ``to_dict`` convert to and from the reference dict schema.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


Triple = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class GridConf:
    """BEV voxel-grid bounds, each (min, max, step) in meters.

    Defaults are the SimBEV defaults (reference ``train_simbev.py:44-47``):
    100m x 100m at 0.5m, a single 20m-tall Z voxel, and 41 depth bins from
    4m to 45m at 1m.
    """

    xbound: Triple = (-50.0, 50.0, 0.5)
    ybound: Triple = (-50.0, 50.0, 0.5)
    zbound: Triple = (-10.0, 10.0, 20.0)
    dbound: Triple = (4.0, 45.0, 1.0)

    def __post_init__(self):
        for name in ("xbound", "ybound", "zbound", "dbound"):
            object.__setattr__(self, name, tuple(float(v) for v in getattr(self, name)))

    @classmethod
    def from_dict(cls, d) -> "GridConf":
        return cls(
            xbound=tuple(d["xbound"]),
            ybound=tuple(d["ybound"]),
            zbound=tuple(d["zbound"]),
            dbound=tuple(d["dbound"]),
        )

    def to_dict(self) -> dict:
        return {
            "xbound": list(self.xbound),
            "ybound": list(self.ybound),
            "zbound": list(self.zbound),
            "dbound": list(self.dbound),
        }

    @property
    def dx(self) -> np.ndarray:
        """Voxel size per axis: step of each bound (reference tools.py:175)."""
        return np.array([b[2] for b in (self.xbound, self.ybound, self.zbound)],
                        dtype=np.float32)

    @property
    def bx(self) -> np.ndarray:
        """Center of the first voxel (reference tools.py:176)."""
        return np.array([b[0] + b[2] / 2.0
                         for b in (self.xbound, self.ybound, self.zbound)],
                        dtype=np.float32)

    @property
    def nx(self) -> np.ndarray:
        """Voxel counts per axis, truncating like torch .long() (tools.py:177)."""
        return np.array([int((b[1] - b[0]) / b[2])
                         for b in (self.xbound, self.ybound, self.zbound)],
                        dtype=np.int32)

    @property
    def num_depth_bins(self) -> int:
        """D = len(arange(*dbound)) (reference models.py:161)."""
        lo, hi, step = self.dbound
        return int(np.ceil((hi - lo) / step - 1e-9))


@dataclasses.dataclass(frozen=True)
class DataAugConf:
    """Image-size / augmentation config (reference data_aug_conf).

    Defaults are the SimBEV CLI defaults (reference ``train_simbev.py:28-37``),
    which disable augmentation.
    """

    H: int = 224
    W: int = 480
    final_dim: Tuple[int, int] = (128, 352)
    resize_lim: Tuple[float, float] = (1.0, 1.0)
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    rot_lim: Tuple[float, float] = (0.0, 0.0)
    rand_flip: bool = False
    Ncams: int = 6

    def __post_init__(self):
        object.__setattr__(self, "final_dim", tuple(int(v) for v in self.final_dim))
        object.__setattr__(self, "resize_lim", tuple(float(v) for v in self.resize_lim))
        object.__setattr__(self, "bot_pct_lim", tuple(float(v) for v in self.bot_pct_lim))
        object.__setattr__(self, "rot_lim", tuple(float(v) for v in self.rot_lim))

    @classmethod
    def from_dict(cls, d) -> "DataAugConf":
        return cls(
            H=int(d["H"]),
            W=int(d["W"]),
            final_dim=tuple(d["final_dim"]),
            resize_lim=tuple(d["resize_lim"]),
            bot_pct_lim=tuple(d["bot_pct_lim"]),
            rot_lim=tuple(d["rot_lim"]),
            rand_flip=bool(d["rand_flip"]),
            Ncams=int(d["Ncams"]),
        )

    def to_dict(self) -> dict:
        return {
            "resize_lim": tuple(self.resize_lim),
            "final_dim": tuple(self.final_dim),
            "rot_lim": tuple(self.rot_lim),
            "H": self.H,
            "W": self.W,
            "rand_flip": self.rand_flip,
            "bot_pct_lim": tuple(self.bot_pct_lim),
            "Ncams": self.Ncams,
        }


# --- presets mirroring the reference configs ---

def simbev_default_grid() -> GridConf:
    """Reference train_simbev.py defaults / configs/simbev_default.sh."""
    return GridConf()


def simbev_default_aug() -> DataAugConf:
    return DataAugConf()


def nuscenes_grid() -> GridConf:
    """Original LSS nuScenes grid (reference src/train.py:33-36): identical."""
    return GridConf()


def nuscenes_aug() -> DataAugConf:
    """Original LSS nuScenes aug config (reference src/train.py:23-29)."""
    return DataAugConf(
        H=900, W=1600,
        final_dim=(128, 352),
        resize_lim=(0.193, 0.225),
        bot_pct_lim=(0.0, 0.22),
        rot_lim=(-5.4, 5.4),
        rand_flip=True,
        Ncams=5,
    )


def stretch_400_grid() -> GridConf:
    """Stretch config: 400x400 BEV at 0.25m."""
    return GridConf(xbound=(-50.0, 50.0, 0.25), ybound=(-50.0, 50.0, 0.25))
