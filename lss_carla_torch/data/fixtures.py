"""Synthetic SimBEV fixture generator: the port's own copy of
``lss_carla_tpu/data/fixtures.py`` (same arguments, same files).

The reference has no hermetic test data. This generator writes a miniature
dataset tree with the exact schema the loader expects:

    root/
      SimBEV_cvt_label/scene_0000/yaw0pitch0/{meta.json, bev_000000.npz}
      sweeps/RGB-CAM_*/*.jpg

Geometry is physically consistent: each camera is a pinhole mounted
``CAM_HEIGHT`` above the ground (like a real rig), yawed to its mount
direction, with the "ego->cam"-style extrinsics stored the way SimBEV does
(rotation/translation consumed as-is by the cam->ego composition). Vehicles
are drawn as ground-standing boxes below a sky/ground horizon split, so the
image carries the two monocular depth cues real driving data has — the
ground-contact row (v of the box bottom ~ cy + fy*CAM_HEIGHT/depth) and
apparent size — and a model trained on the fixture can genuinely
generalize its depth estimates to held-out scenes (a camera at z=0 puts
every vehicle ON the horizon line, leaving size as the only cue, which
caps validation IoU).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

from lss_carla_torch.data.simbev import CAMERA_ORDER

CAM_DIRS = {
    'front_left': 55.0, 'front': 0.0, 'front_right': -55.0,
    'back_left': 110.0, 'back': 180.0, 'back_right': -110.0,
}

CAM_HEIGHT = 1.6    # camera mount height above ground (m)
VEH_HALF_W = 1.0    # vehicle half-width for rendering (m)
VEH_HEIGHT = 1.5    # vehicle box height (m)
SKY = (100, 140, 180)
GROUND = (60, 70, 80)
VEHICLE = (200, 30, 30)


def _yaw_rot(deg: float) -> np.ndarray:
    """Rotation mapping camera axes into ego axes: camera +z (view) points
    along ego yaw direction, camera +x right, +y down."""
    t = np.deg2rad(deg)
    fwd = np.array([np.cos(t), np.sin(t), 0.0])      # ego direction of view
    right = np.array([np.sin(t), -np.cos(t), 0.0])   # ego right-of-view
    down = np.array([0.0, 0.0, -1.0])
    # columns are camera axes expressed in ego coords: [x_cam, y_cam, z_cam]
    return np.stack([right, down, fwd], axis=1)


def generate_fixture(root, num_scenes: int = 3, samples_per_scene: int = 4,
                     H: int = 224, W: int = 480, grid: int = 200,
                     seed: int = 0,
                     orientations=("yaw0pitch0",),
                     vehicle_x_range=(-35.0, 35.0)) -> Path:
    """Write a synthetic SimBEV tree under ``root`` and return it.

    ``orientations``: rig-orientation directories to emit; a name like
    "yaw30pitch0" adds a 30-degree yaw offset to every camera mount (the
    multi-orientation layout the CVT loader's viewpoint-override consumes).

    ``vehicle_x_range``: ego-X placement range for vehicles. The default is
    symmetric; pass e.g. ``(2, 35)`` for the forward-biased mass real
    driving data exhibits (used by the label-distribution validation,
    reference ``docs/COORDINATE_SYSTEM_FIX.md:66-82``).
    """
    root = Path(root)
    fx = fy = 0.5 * W  # ~90deg hfov
    cx, cy = W / 2.0, H / 2.0
    intrin = [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]

    def _yaw_of(orientation: str) -> float:
        import re
        m = re.match(r"yaw(-?\d+)pitch(-?\d+)", orientation)
        return float(m.group(1)) if m else 0.0

    for s in range(num_scenes):
        scene = f"scene_{s:04d}"
        scene_rng = np.random.default_rng(seed * 1000 + s)
        # per-sample vehicle layouts shared by all orientations
        layouts = []
        for k in range(samples_per_scene):
            n_veh = int(scene_rng.integers(1, 4))
            xs = scene_rng.uniform(*vehicle_x_range, size=(n_veh, 1))
            ys = scene_rng.uniform(-35, 35, size=(n_veh, 1))
            layouts.append((np.concatenate([xs, ys], axis=1),
                            scene_rng.integers(1, 4, size=n_veh)))
        for orientation in orientations:
            _emit_orientation(root, scene, orientation, _yaw_of(orientation),
                              layouts, intrin, fx, fy, cx, cy, W, H, grid)
    return root


def _emit_orientation(root, scene, orientation, yaw_offset, layouts, intrin,
                      fx, fy, cx, cy, W, H, grid):
    meta_dir = root / "SimBEV_cvt_label" / scene / orientation
    meta_dir.mkdir(parents=True, exist_ok=True)
    meta = []
    for k, (veh, veh_cls) in enumerate(layouts):
        token = f"{scene}_{k:06d}"

        # BEV label. The model's splat grid maps loaded[i, j] to ego
        # (x = i*cell - 50, y = j*cell - 50); the loader flipuds the
        # stored rows (SimBEV front-at-row-0 convention), so we store
        # stored[r, c] = presence at x = (grid-1-r)*cell - 50.
        bev = np.zeros((8, grid, grid), dtype=np.uint8)
        cell = 100.0 / grid
        # channel 0 (drivable area, SimBEV class order): a straight road
        # band |ego y| <= 10 m spanning all x — fixed in the ego frame so a
        # multiclass head can learn it, and non-empty so the stretch
        # config's 4-class metrics aren't dominated by a degenerate channel
        c_lo = int((-10.0 + 50.0) / cell)
        c_hi = int((10.0 + 50.0) / cell)
        bev[0, :, c_lo:c_hi] = 1
        for (vx, vy), cls in zip(veh, veh_cls):
            r = grid - 1 - int((vx + 50.0) / cell)
            c = int((vy + 50.0) / cell)
            half = max(1, int(2.0 / cell))  # ~4m boxes
            bev[int(cls), max(0, r - half):r + half,
                max(0, c - half):c + half] = 1
        bev_name = f"bev_{token}.npz"
        np.savez_compressed(meta_dir / bev_name, bev=bev)

        images = []
        T = np.array([0.0, 0.0, CAM_HEIGHT])  # camera position in ego
        for cam in CAMERA_ORDER:
            cam_dir = root / "sweeps" / f"RGB-CAM_{cam.upper()}"
            cam_dir.mkdir(parents=True, exist_ok=True)
            # sky above the horizon (level camera -> horizon at v = cy),
            # ground below: the ground plane reference the depth cue needs
            img = Image.new("RGB", (W, H), SKY)
            draw = ImageDraw.Draw(img)
            draw.rectangle([0, cy, W, H], fill=GROUND)
            R = _yaw_rot(CAM_DIRS[cam] + yaw_offset)
            # far-to-near so nearer boxes occlude farther ones
            order = np.argsort([-(R.T @ (np.append(v3, 0.0) - T))[2]
                                for v3 in veh])
            for (vx, vy) in veh[order]:
                bot = R.T @ (np.array([vx, vy, 0.0]) - T)         # ego->cam
                top = R.T @ (np.array([vx, vy, VEH_HEIGHT]) - T)
                if bot[2] < 2.0:
                    continue
                u = fx * bot[0] / bot[2] + cx
                v_bot = fy * bot[1] / bot[2] + cy   # ground-contact row
                v_top = fy * top[1] / top[2] + cy
                hw = max(2.0, fx * VEH_HALF_W / bot[2])
                draw.rectangle([u - hw, v_top, u + hw, v_bot], fill=VEHICLE)
            suffix = "" if orientation == "yaw0pitch0" else f"_{orientation}"
            rel = f"sweeps/RGB-CAM_{cam.upper()}/{token}{suffix}.jpg"
            img.save(root / rel, quality=90)
            images.append(rel)

        # extrinsics stored so that rot/tran are consumed as-is by the
        # cam->ego composition (SimBEV "ego->cam" storage convention,
        # reference data_simbev.py:187-192): rot = cam-axes-in-ego.
        extrinsics = []
        for cam in CAMERA_ORDER:
            E = np.eye(4)
            E[:3, :3] = _yaw_rot(CAM_DIRS[cam] + yaw_offset)
            E[:3, 3] = T
            extrinsics.append(E.tolist())

        meta.append({
            "token": token,
            "images": images,
            "intrinsics": [intrin] * len(CAMERA_ORDER),
            "extrinsics": extrinsics,
            "bev": bev_name,
        })
    with open(meta_dir / "meta.json", "w") as f:
        json.dump(meta, f)
