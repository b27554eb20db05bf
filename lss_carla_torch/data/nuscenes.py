"""nuScenes data path, devkit-free: counterpart of
``lss_carla_tpu/data/nuscenes.py``.

The LSS data contract straight from the published nuScenes v1.0 JSON
tables, with no devkit:

* tables read: scene, sample, sample_data, calibrated_sensor, sensor,
  ego_pose, sample_annotation, instance, category (and log, for the map
  location);
* per sample: 6 camera key frames, intrinsics from calibrated_sensor,
  extrinsics = sensor->ego (translation + wxyz quaternion), used as they
  are by the cam->ego composition, as in the original LSS;
* BEV label: ``vehicle.*`` annotations moved global->ego at the sample's
  CAM_FRONT ego pose, box footprints rasterised onto the grid with PIL in
  the loaded-label convention (dim0 = ego X, dim1 = ego Y);
* the SimBEV loader's augmentation (one draw a sample, the homography
  tracked) and decode path (``data/decode.py::NativeDecoder``), and the
  same 7-tuple items.

Every random draw (the camera subset, the augmentation) comes from the
dataset's ``torch.Generator`` seeded from ``seed``, one sample's draws
under one lock (``draw``), as in ``data/simbev.py``; the JAX package draws
from the global ``np.random``.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch
from PIL import Image, ImageDraw

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.augment import post_homography, sample_augmentation
from lss_carla_torch.data.decode import USE_NATIVE, NativeDecoder
from lss_carla_torch.ops.geometry import gen_dx_bx

NUSC_CAMERA_ORDER = [
    'CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT',
    'CAM_BACK_LEFT', 'CAM_BACK', 'CAM_BACK_RIGHT',
]


def quat_to_rot(q) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation matrix (pure numpy)."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def _load_table(table_dir: Path, name: str) -> List[dict]:
    with open(table_dir / f"{name}.json") as f:
        return json.load(f)


class NuScenesTables:
    """Indexed nuScenes v1.0 tables (the minimal devkit replacement)."""

    def __init__(self, dataroot, version: str = "v1.0-mini"):
        self.dataroot = Path(dataroot)
        table_dir = self.dataroot / version
        if not table_dir.exists():
            raise FileNotFoundError(f"nuScenes tables not found: {table_dir}")
        by_token = lambda rows: {r["token"]: r for r in rows}  # noqa: E731
        self.scene = _load_table(table_dir, "scene")
        self.sample = by_token(_load_table(table_dir, "sample"))
        self.sample_data = _load_table(table_dir, "sample_data")
        self.calibrated_sensor = by_token(
            _load_table(table_dir, "calibrated_sensor"))
        self.sensor = by_token(_load_table(table_dir, "sensor"))
        self.ego_pose = by_token(_load_table(table_dir, "ego_pose"))
        self.sample_annotation = _load_table(table_dir, "sample_annotation")
        self.instance = by_token(_load_table(table_dir, "instance"))
        self.category = by_token(_load_table(table_dir, "category"))
        # log table: scene -> map location (optional; only the map
        # underlay needs it)
        try:
            self.log = by_token(_load_table(table_dir, "log"))
        except FileNotFoundError:
            self.log = {}

        # sample_token -> {channel: sample_data record} (key frames)
        self.cam_data: Dict[str, Dict[str, dict]] = {}
        self.sample_data_by_token: Dict[str, dict] = {}
        for sd in self.sample_data:
            if "token" in sd:
                self.sample_data_by_token[sd["token"]] = sd
            if not sd.get("is_key_frame", True):
                continue
            cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
            channel = self.sensor[cs["sensor_token"]]["channel"]
            self.cam_data.setdefault(sd["sample_token"], {})[channel] = sd
        # sample_token -> [annotation]
        self.anns: Dict[str, List[dict]] = {}
        for a in self.sample_annotation:
            self.anns.setdefault(a["sample_token"], []).append(a)

    def category_name(self, ann: dict) -> str:
        inst = self.instance[ann["instance_token"]]
        return self.category[inst["category_token"]]["name"]

    def scene2map(self) -> Dict[str, str]:
        """scene name -> map location (reference ``explore.py:305-308``).
        Scenes without a resolvable log map to ``boston-seaport``, so table
        sets without the log table still draw an underlay."""
        out = {}
        for sc in self.scene:
            log = self.log.get(sc.get("log_token", ""), {})
            out[sc["name"]] = log.get("location", "boston-seaport")
        return out


def _pose_matrix(translation, rotation_quat, inverse: bool = False
                 ) -> np.ndarray:
    """4x4 homogeneous transform from translation + wxyz quaternion."""
    R = quat_to_rot(rotation_quat)
    t = np.asarray(translation, dtype=np.float64)
    m = np.eye(4)
    if inverse:
        m[:3, :3] = R.T
        m[:3, 3] = -R.T @ t
    else:
        m[:3, :3] = R
        m[:3, 3] = t
    return m


def get_lidar_data(tables: "NuScenesTables", dataroot, sample_token: str,
                   nsweeps: int = 1, min_distance: float = 2.2
                   ) -> np.ndarray:
    """At most ``nsweeps`` of LIDAR_TOP in the key frame's ego frame: the
    reference's ``get_lidar_data`` (``src/tools.py:23-77``) without the
    devkit. ``.pcd.bin`` sweeps are read directly (float32 ``x, y, z,
    intensity, ring`` records), points within ``min_distance`` in x and y
    dropped, each sweep mapped sensor -> ego(t) -> global -> ego(t_ref)
    with the table poses, and a dt row appended. Returns ``(5, N)``: x, y,
    z, reflectance, dt.
    """
    dataroot = Path(dataroot)
    ref_sd = tables.cam_data[sample_token]["LIDAR_TOP"]
    ref_pose = tables.ego_pose[ref_sd["ego_pose_token"]]
    ref_time = 1e-6 * ref_sd.get("timestamp", 0)
    car_from_global = _pose_matrix(ref_pose["translation"],
                                   ref_pose["rotation"], inverse=True)

    points = np.zeros((5, 0))
    sd = ref_sd
    for _ in range(nsweeps):
        raw = np.fromfile(dataroot / sd["filename"], dtype=np.float32)
        pc = raw.reshape(-1, 5)[:, :4].T.astype(np.float64)  # drop the ring
        close = (np.abs(pc[0]) < min_distance) & \
                (np.abs(pc[1]) < min_distance)
        pc = pc[:, ~close]

        pose = tables.ego_pose[sd["ego_pose_token"]]
        cs = tables.calibrated_sensor[sd["calibrated_sensor_token"]]
        trans = (car_from_global
                 @ _pose_matrix(pose["translation"], pose["rotation"])
                 @ _pose_matrix(cs["translation"], cs["rotation"]))
        xyz1 = np.vstack([pc[:3], np.ones((1, pc.shape[1]))])
        pc[:3] = (trans @ xyz1)[:3]

        dt = ref_time - 1e-6 * sd.get("timestamp", 0)
        points = np.concatenate(
            [points, np.vstack([pc, np.full((1, pc.shape[1]), dt)])], axis=1)

        prev = sd.get("prev", "")
        if not prev or prev not in tables.sample_data_by_token:
            break
        sd = tables.sample_data_by_token[prev]
    return points


class NuScenesDataset:
    """LSS segmentation dataset over nuScenes tables: items are the
    reference 7-tuple of ``SegmentationData``. Scenes sorted by name split
    ``train_split_fraction`` / rest into train / val. ``use_native``: the
    C++ decoder (``NativeDecoder``); ``device_normalize``: uint8 images,
    normalised on the device."""

    def __init__(self, dataroot, is_train: bool, data_aug_conf, grid_conf,
                 version: str = "v1.0-mini",
                 label_category_prefix: str = "vehicle.",
                 train_split_fraction: float = 0.8,
                 device_normalize: bool = False,
                 use_native: bool = USE_NATIVE, seed: int = 0):
        self.dataroot = Path(dataroot)
        self.is_train = is_train
        self.device_normalize = device_normalize
        self.data_aug_conf = (data_aug_conf if isinstance(data_aug_conf,
                                                          DataAugConf)
                              else DataAugConf.from_dict(data_aug_conf))
        self.grid_conf = (grid_conf if isinstance(grid_conf, GridConf)
                          else GridConf.from_dict(grid_conf))
        self.label_category_prefix = label_category_prefix
        self.t = NuScenesTables(dataroot, version)

        scenes = sorted(self.t.scene, key=lambda s: s["name"])
        split = int(train_split_fraction * len(scenes))
        selected = scenes[:split] if is_train else scenes[split:]
        self.samples: List[str] = []
        for sc in selected:
            tok = sc["first_sample_token"]
            while tok:
                self.samples.append(tok)
                tok = self.t.sample[tok]["next"]

        self.dx, self.bx, self.nx = gen_dx_bx(
            self.grid_conf.xbound, self.grid_conf.ybound,
            self.grid_conf.zbound)
        self.decoder = NativeDecoder(
            (self.data_aug_conf.W, self.data_aug_conf.H),
            device_normalize=device_normalize, use_native=use_native)
        self.generator = torch.Generator().manual_seed(int(seed))
        self._lock = threading.Lock()
        print(self)

    def choose_cams(self) -> Sequence[str]:
        ncams = self.data_aug_conf.Ncams
        if self.is_train and ncams < len(NUSC_CAMERA_ORDER):
            pick = torch.randperm(len(NUSC_CAMERA_ORDER),
                                  generator=self.generator)
            return [NUSC_CAMERA_ORDER[i] for i in sorted(pick[:ncams].tolist())]
        return list(NUSC_CAMERA_ORDER)

    def draw(self):
        """All random choices of one sample, under the lock: (camera
        names, augmentation)."""
        with self._lock:
            cams = self.choose_cams()
            aug = sample_augmentation(self.data_aug_conf, self.is_train,
                                      self.generator)
        return cams, aug

    def get_image_data(self, sample_token: str, cams: Sequence[str], aug):
        """The six image-side arrays of one sample under the augmentation
        ``aug`` (``sample_augmentation``'s tuple)."""
        post_rot2, post_tran2 = post_homography(aug[0], *aug[2:])
        post_rot3 = np.eye(3, dtype=np.float32)
        post_tran3 = np.zeros(3, dtype=np.float32)
        post_rot3[:2, :2] = post_rot2
        post_tran3[:2] = post_tran2
        imgs, rots, trans, intrins = [], [], [], []
        cam_data = self.t.cam_data[sample_token]
        for cam in cams:
            sd = cam_data[cam]
            cs = self.t.calibrated_sensor[sd["calibrated_sensor_token"]]
            imgs.append(self.decoder.decode(self.dataroot / sd["filename"],
                                            aug))
            intrins.append(np.asarray(cs["camera_intrinsic"],
                                      dtype=np.float32))
            # sensor->ego, used as it is by the cam->ego composition (the
            # original LSS convention)
            rots.append(quat_to_rot(cs["rotation"]).astype(np.float32))
            trans.append(np.asarray(cs["translation"], dtype=np.float32))
        n = len(cams)
        return (np.stack(imgs), np.stack(rots), np.stack(trans),
                np.stack(intrins), np.stack([post_rot3] * n),
                np.stack([post_tran3] * n))

    def _ego_pose_for(self, sample_token: str) -> dict:
        cam_data = self.t.cam_data[sample_token]
        sd = cam_data.get("CAM_FRONT") or next(iter(cam_data.values()))
        return self.t.ego_pose[sd["ego_pose_token"]]

    def get_binimg(self, sample_token: str) -> np.ndarray:
        """Rasterise the label category's box footprints into the (1, X, Y)
        BEV mask, loaded-label convention (dim0 = ego X, dim1 = ego Y)."""
        pose = self._ego_pose_for(sample_token)
        ego_t = np.asarray(pose["translation"])
        ego_R = quat_to_rot(pose["rotation"])
        X, Y = int(self.nx[0]), int(self.nx[1])
        canvas = Image.new("L", (Y, X), 0)  # PIL (width=Y, height=X)
        draw = ImageDraw.Draw(canvas)
        for ann in self.t.anns.get(sample_token, []):
            if not self.t.category_name(ann).startswith(
                    self.label_category_prefix):
                continue
            # global -> ego
            c = ego_R.T @ (np.asarray(ann["translation"]) - ego_t)
            R = ego_R.T @ quat_to_rot(ann["rotation"])
            w, l, _h = [float(v) for v in ann["size"]]
            # box frame: x = forward (length), y = left (width)
            corners_box = np.array([
                [l / 2, w / 2, 0], [l / 2, -w / 2, 0],
                [-l / 2, -w / 2, 0], [-l / 2, w / 2, 0]])
            corners = (R @ corners_box.T).T + c  # (4, 3) ego frame
            # ego (x, y) -> grid (i, j): i = (x - (bx - dx/2)) / dx
            gi = (corners[:, 0] - (self.bx[0] - self.dx[0] / 2)) / self.dx[0]
            gj = (corners[:, 1] - (self.bx[1] - self.dx[1] / 2)) / self.dx[1]
            # PIL polygon: (col=j, row=i)
            draw.polygon([(float(j), float(i)) for i, j in zip(gi, gj)],
                         fill=1)
        mask = np.asarray(canvas, dtype=np.float32)  # (X rows, Y cols)
        return mask[None]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        tok = self.samples[index]
        cams, aug = self.draw()
        return (*self.get_image_data(tok, cams, aug), self.get_binimg(tok))

    def __str__(self):
        split = "train" if self.is_train else "val"
        return f"NuScenesDataset ({split}): {len(self)} samples"


def compile_data_nuscenes(version, dataroot, data_aug_conf, grid_conf,
                          bsz: int, nworkers: int,
                          device_normalize: bool = False,
                          use_native: bool = USE_NATIVE, seed: int = 13,
                          shard_index: int = 0, num_shards: int = 1):
    """The nuScenes counterpart of ``loader.compile_data``: (trainloader,
    valloader). The train loader shuffles (from ``seed``, which also seeds
    the train dataset's draws) and drops the ragged tail; the val loader
    pads its last batch with a validity mask (``pad_last``).
    ``shard_index``/``num_shards`` shard both as ``compile_data`` does."""
    from lss_carla_torch.data.loader import DataLoader
    kw = dict(version=version, device_normalize=device_normalize,
              use_native=use_native)
    train_ds = NuScenesDataset(dataroot, True, data_aug_conf, grid_conf,
                               seed=seed + shard_index, **kw)
    val_ds = NuScenesDataset(dataroot, False, data_aug_conf, grid_conf, **kw)
    shards = dict(shard_index=shard_index, num_shards=num_shards)
    trainloader = DataLoader(train_ds, batch_size=bsz, shuffle=True,
                             drop_last=True, num_workers=nworkers, seed=seed,
                             **shards)
    valloader = DataLoader(val_ds, batch_size=bsz, shuffle=False,
                           pad_last=True, num_workers=nworkers, **shards)
    return trainloader, valloader
