"""SimBEV dataset: counterpart of ``lss_carla_tpu/data/simbev.py``
(reference ``src/data_simbev.py``).

* ``dataroot/SimBEV_cvt_label/scene_*/<orientation>/meta.json`` lists the
  samples; scenes are sorted and split 80/20 into train and val
  (``data_simbev.py:79-91``);
* each sample carries 6 camera image paths (relative to dataroot), 3x3
  intrinsics and 4x4 ego->cam extrinsics used as they are
  (``data_simbev.py:187-192``);
* the BEV label is ``bev_*.npz``, an (8, 200, 200) class stack; classes
  1|2|3 merge into a binary vehicle mask (``label_mode="vehicle_binary"``)
  or the ``label_classes`` channels stack (``"multiclass"``), then
  ``np.flipud`` for the SimBEV-vs-LSS Y axis (``data_simbev.py:236-242``);
* one augmentation draw a sample, shared by all its cameras; train may
  drop to a random Ncams-camera subset (``data_simbev.py:248-258``).

Items are numpy arrays in the reference layouts: imgs (N, 3, H, W), uint8
with ``device_normalize`` (normalised on the device) or ImageNet-normalised
f32. Images decode through ``data/decode.py::NativeDecoder``: the C++
kernels with ``use_native`` (the default), PIL with ``use_native=False``
or for what the kernels do not cover (a rotation, a file that is not a
JPEG); either way the homography is ``post_homography``'s.
``viewpoint_override`` ({camera name: orientation}) takes a camera's
image, intrinsics and extrinsics from another rig orientation of the same
sample token (the CVT loader's viewchange,
``cvt_simbev_dataloader.py:240-247``), or from the base sample where that
orientation lacks the token. Every random draw (camera subset,
augmentation, ``extrinsic_noise``) comes from
the dataset's ``torch.Generator``, seeded from ``seed``, one sample's draws
under one lock; with several loader threads, which sample gets which draws
depends on thread timing.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.augment import post_homography, sample_augmentation
from lss_carla_torch.data.decode import USE_NATIVE, NativeDecoder

CAMERA_ORDER = [
    'front_left', 'front', 'front_right',
    'back_left', 'back', 'back_right',
]

TRAIN_SPLIT_FRACTION = 0.8


def _rotation_noise(generator, rot_deg_std: float, trans_m_std: float):
    """A small random rotation and translation (train-time extrinsic
    noise; the hook of the CVT loader, ``cvt_simbev_dataloader.py:42-44``)."""
    angles = torch.randn(3, generator=generator, dtype=torch.float64).numpy()
    angles = angles * np.deg2rad(rot_deg_std)
    cx, cy, cz = np.cos(angles)
    sx, sy, sz = np.sin(angles)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    d_tran = torch.randn(3, generator=generator, dtype=torch.float64).numpy()
    return (Rz @ Ry @ Rx).astype(np.float32), \
        (d_tran * trans_m_std).astype(np.float32)


def scan_samples(dataroot, is_train: bool,
                 orientation: str = "yaw0pitch0") -> List[dict]:
    """Scan scene dirs, apply the sorted 80/20 scene split, read meta.json."""
    dataroot = Path(dataroot)
    labels_dir = dataroot / "SimBEV_cvt_label"
    if not labels_dir.exists():
        raise FileNotFoundError(f"Labels directory not found: {labels_dir}")
    scene_dirs = sorted(d for d in labels_dir.iterdir()
                        if d.is_dir() and d.name.startswith("scene_"))
    if not scene_dirs:
        raise FileNotFoundError(f"No scene directories found in {labels_dir}")
    train_split = int(TRAIN_SPLIT_FRACTION * len(scene_dirs))
    selected = scene_dirs[:train_split] if is_train else scene_dirs[train_split:]
    samples = []
    for scene_dir in selected:
        meta_path = scene_dir / orientation / "meta.json"
        if not meta_path.exists():
            continue
        with open(meta_path) as f:
            meta_samples = json.load(f)
        for s in meta_samples:
            s["scene_dir"] = scene_dir
            s["meta_dir"] = meta_path.parent
            samples.append(s)
    if not samples:
        split = "train" if is_train else "val"
        raise FileNotFoundError(f"No samples found for {split} split in {labels_dir}")
    return samples


class SimBEVDataset:
    """Map-style dataset over SimBEV samples (see the module docstring)."""

    def __init__(self, dataroot, is_train: bool, data_aug_conf, grid_conf,
                 orientation: str = "yaw0pitch0", extrinsic_noise=None,
                 label_mode: str = "vehicle_binary",
                 label_classes=(0, 1, 2, 3), device_normalize: bool = False,
                 use_native: bool = USE_NATIVE, viewpoint_override=None,
                 seed: int = 0):
        if label_mode not in ("vehicle_binary", "multiclass"):
            raise ValueError(f"unknown label_mode: {label_mode}")
        self.dataroot = Path(dataroot)
        self.is_train = is_train
        self.data_aug_conf = (data_aug_conf if isinstance(data_aug_conf, DataAugConf)
                              else DataAugConf.from_dict(data_aug_conf))
        self.grid_conf = (grid_conf if isinstance(grid_conf, GridConf)
                          else GridConf.from_dict(grid_conf))
        self.orientation = orientation
        self.extrinsic_noise = extrinsic_noise
        self.label_mode = label_mode
        self.label_classes = tuple(label_classes)
        self.device_normalize = device_normalize
        self.samples = scan_samples(dataroot, is_train, orientation)
        self.viewpoint_override = dict(viewpoint_override or {})
        # orientation -> {token: sample} of each override orientation
        self._override_lookup = {
            ov: {s.get("token"): s for s in scan_samples(dataroot, is_train, ov)}
            for ov in set(self.viewpoint_override.values())}
        self.decoder = NativeDecoder(
            (self.data_aug_conf.W, self.data_aug_conf.H),
            device_normalize=device_normalize, use_native=use_native)
        self.generator = torch.Generator().manual_seed(int(seed))
        self._lock = threading.Lock()
        print(self)

    def choose_cams(self) -> Sequence[int]:
        all_cams = list(range(len(CAMERA_ORDER)))
        ncams = self.data_aug_conf.Ncams
        if self.is_train and ncams < len(CAMERA_ORDER):
            pick = torch.randperm(len(all_cams), generator=self.generator)
            return sorted(pick[:ncams].tolist())
        return all_cams

    def draw(self):
        """All random choices of one sample, under the lock: (camera
        indices, augmentation, per-camera extrinsic noise or None)."""
        with self._lock:
            cams = self.choose_cams()
            aug = sample_augmentation(self.data_aug_conf, self.is_train,
                                      self.generator)
            noise = None
            if self.is_train and self.extrinsic_noise is not None:
                noise = [_rotation_noise(self.generator, *self.extrinsic_noise)
                         for _ in cams]
        return cams, aug, noise

    def get_image_data(self, sample, cam_indices, aug, noise=None):
        post_rot2, post_tran2 = post_homography(aug[0], *aug[2:])
        imgs, rots, trans, intrins, post_rots, post_trans = [], [], [], [], [], []
        for i, cam_idx in enumerate(cam_indices):
            src = sample
            ov = self.viewpoint_override.get(CAMERA_ORDER[cam_idx])
            if ov is not None:
                src = self._override_lookup[ov].get(sample.get("token"), sample)
            intrin = np.asarray(src["intrinsics"][cam_idx], dtype=np.float32)
            extrin = np.asarray(src["extrinsics"][cam_idx], dtype=np.float32)
            rot, tran = extrin[:3, :3], extrin[:3, 3]
            if noise is not None:
                d_rot, d_tran = noise[i]
                rot, tran = (d_rot @ rot).astype(np.float32), tran + d_tran
            imgs.append(self.decoder.decode(
                self.dataroot / src["images"][cam_idx], aug))
            post_rot3 = np.eye(3, dtype=np.float32)
            post_tran3 = np.zeros(3, dtype=np.float32)
            post_rot3[:2, :2] = post_rot2
            post_tran3[:2] = post_tran2
            intrins.append(intrin)
            rots.append(rot)
            trans.append(tran)
            post_rots.append(post_rot3)
            post_trans.append(post_tran3)
        return (np.stack(imgs), np.stack(rots), np.stack(trans),
                np.stack(intrins), np.stack(post_rots), np.stack(post_trans))

    def get_binimg(self, sample) -> np.ndarray:
        bev = np.load(Path(sample["meta_dir"]) / sample["bev"])["bev"]
        if self.label_mode == "vehicle_binary":
            vehicle = ((bev[1] > 0) | (bev[2] > 0)
                       | (bev[3] > 0)).astype(np.float32)
            return np.flipud(vehicle).copy()[None]
        return np.stack([np.flipud((bev[c] > 0).astype(np.float32)).copy()
                         for c in self.label_classes])

    def __len__(self):
        return len(self.samples)

    def __str__(self):
        split = "train" if self.is_train else "val"
        return f"SimBEVDataset ({split}): {len(self)} samples"


class SegmentationData(SimBEVDataset):
    """Training and validation items: the reference 7-tuple."""

    def __getitem__(self, index):
        sample = self.samples[index]
        cams, aug, noise = self.draw()
        return (*self.get_image_data(sample, cams, aug, noise),
                self.get_binimg(sample))


class VizData(SimBEVDataset):
    """Adds an empty (3, 0) lidar array (reference data_simbev.py:268-291)."""

    def __getitem__(self, index):
        sample = self.samples[index]
        cams, aug, noise = self.draw()
        return (*self.get_image_data(sample, cams, aug, noise),
                np.empty((3, 0), dtype=np.float32), self.get_binimg(sample))
