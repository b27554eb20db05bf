"""Synthetic nuScenes-schema fixture generator (mini table set, images,
lidar sweeps and a map expansion): the port's own copy of
``lss_carla_tpu/data/fixtures_nuscenes.py``, writing the same tables and
pixels at the same seed (numpy ``default_rng(seed)``, PIL's JPEG encoder
at quality 90).

Writes the v1.0 JSON tables consumed by ``lss_carla_torch.data.nuscenes``
with physically consistent geometry: cameras mounted at yawed directions
around the ego, a non-trivial global ego pose (so the global->ego
annotation transform is actually exercised), and vehicle boxes drawn into
both the camera images and the annotations.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

from lss_carla_torch.data.nuscenes import NUSC_CAMERA_ORDER, quat_to_rot

CAM_YAWS = {
    'CAM_FRONT_LEFT': 55.0, 'CAM_FRONT': 0.0, 'CAM_FRONT_RIGHT': -55.0,
    'CAM_BACK_LEFT': 110.0, 'CAM_BACK': 180.0, 'CAM_BACK_RIGHT': -110.0,
}


def _cam_rot(yaw_deg: float) -> np.ndarray:
    """sensor->ego rotation: camera +z = view direction, +x right, +y down."""
    t = np.deg2rad(yaw_deg)
    fwd = np.array([np.cos(t), np.sin(t), 0.0])
    right = np.array([np.sin(t), -np.cos(t), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    return np.stack([right, down, fwd], axis=1)


def rot_to_quat(R: np.ndarray):
    """3x3 rotation -> wxyz quaternion (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    return [float(w), float(x), float(y), float(z)]


def _yaw_quat(yaw: float):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def generate_nuscenes_fixture(root, num_scenes: int = 3,
                              samples_per_scene: int = 3,
                              H: int = 224, W: int = 480, seed: int = 0,
                              version: str = "v1.0-mini",
                              map_name: str = "boston-seaport") -> Path:
    root = Path(root)
    table_dir = root / version
    table_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    fx = fy = 0.5 * W
    cx, cy = W / 2.0, H / 2.0
    intrin = [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]

    sensors, calibs, scenes, samples, sample_datas = [], [], [], [], []
    ego_poses, annotations, instances, categories = [], [], [], []
    categories.append({"token": "cat_vehicle_car", "name": "vehicle.car"})
    categories.append({"token": "cat_human", "name": "human.pedestrian.adult"})

    for cam in NUSC_CAMERA_ORDER:
        sensors.append({"token": f"sensor_{cam}", "channel": cam,
                        "modality": "camera"})
        calibs.append({
            "token": f"calib_{cam}",
            "sensor_token": f"sensor_{cam}",
            "translation": [0.0, 0.0, 1.5],
            "rotation": rot_to_quat(_cam_rot(CAM_YAWS[cam])),
            "camera_intrinsic": intrin,
        })
    sensors.append({"token": "sensor_LIDAR_TOP", "channel": "LIDAR_TOP",
                    "modality": "lidar"})
    lidar_t = np.array([0.9, 0.0, 1.84])
    calibs.append({"token": "calib_LIDAR_TOP",
                   "sensor_token": "sensor_LIDAR_TOP",
                   "translation": lidar_t.tolist(),
                   "rotation": _yaw_quat(0.0),
                   "camera_intrinsic": []})

    def _write_sweep(path, world_pts, ego_t, ego_R):
        """World points -> this pose's sensor frame -> .pcd.bin records."""
        in_ego = (ego_R.T @ (world_pts - ego_t).T).T
        in_sensor = in_ego - lidar_t  # lidar rotation is identity
        rec = np.zeros((len(in_sensor), 5), np.float32)
        rec[:, :3] = in_sensor
        rec[:, 3] = 0.5  # intensity
        rec[:, 4] = np.arange(len(in_sensor)) % 32  # ring
        path.parent.mkdir(parents=True, exist_ok=True)
        rec.tofile(path)

    inst_counter = 0
    for s in range(num_scenes):
        scene_tok = f"scene_{s:04d}"
        sample_toks = [f"{scene_tok}_s{k}" for k in range(samples_per_scene)]
        scenes.append({"token": scene_tok, "name": scene_tok,
                       "first_sample_token": sample_toks[0],
                       "nbr_samples": samples_per_scene})
        for k, tok in enumerate(sample_toks):
            samples.append({
                "token": tok, "scene_token": scene_tok,
                "timestamp": 1_000_000 * (s * 100 + k),
                "prev": sample_toks[k - 1] if k > 0 else "",
                "next": sample_toks[k + 1] if k + 1 < samples_per_scene else "",
            })
            # non-trivial global ego pose
            ego_yaw = float(rng.uniform(-np.pi, np.pi))
            ego_t = np.array([float(rng.uniform(-200, 200)),
                              float(rng.uniform(-200, 200)), 0.0])
            ego_R = quat_to_rot(_yaw_quat(ego_yaw))
            pose_tok = f"pose_{tok}"
            ego_poses.append({"token": pose_tok,
                              "translation": ego_t.tolist(),
                              "rotation": _yaw_quat(ego_yaw),
                              "timestamp": 1_000_000 * (s * 100 + k)})

            # vehicles in the ego frame; stored globally
            n_veh = int(rng.integers(1, 4))
            veh_ego = rng.uniform(-35, 35, size=(n_veh, 2))
            for (vx, vy) in veh_ego:
                veh_yaw = float(rng.uniform(-np.pi, np.pi))
                c_global = ego_R @ np.array([vx, vy, 0.0]) + ego_t
                q_global = rot_to_quat(
                    ego_R @ quat_to_rot(_yaw_quat(veh_yaw)))
                inst_tok = f"inst_{inst_counter}"
                inst_counter += 1
                instances.append({"token": inst_tok,
                                  "category_token": "cat_vehicle_car"})
                annotations.append({
                    "token": f"ann_{inst_tok}",
                    "sample_token": tok,
                    "instance_token": inst_tok,
                    "translation": c_global.tolist(),
                    "size": [2.0, 4.5, 1.6],  # (w, l, h)
                    "rotation": q_global,
                })
            # one non-vehicle annotation (must be ignored by the label)
            instances.append({"token": f"inst_ped_{tok}",
                              "category_token": "cat_human"})
            annotations.append({
                "token": f"ann_ped_{tok}", "sample_token": tok,
                "instance_token": f"inst_ped_{tok}",
                "translation": (ego_R @ np.array([5.0, 5.0, 0.0])
                                + ego_t).tolist(),
                "size": [0.6, 0.6, 1.8], "rotation": _yaw_quat(0.0),
            })

            # camera images with the vehicles drawn
            for cam in NUSC_CAMERA_ORDER:
                img = Image.new("RGB", (W, H), (60, 70, 80))
                draw = ImageDraw.Draw(img)
                Rcam = _cam_rot(CAM_YAWS[cam])
                for (vx, vy) in veh_ego:
                    p_cam = Rcam.T @ (np.array([vx, vy, 0.0])
                                      - np.array([0.0, 0.0, 1.5]))
                    if p_cam[2] < 2.0:
                        continue
                    u = fx * p_cam[0] / p_cam[2] + cx
                    v = fy * p_cam[1] / p_cam[2] + cy
                    r_px = max(2, int(400.0 / p_cam[2]))
                    draw.rectangle([u - r_px, v - r_px, u + r_px, v + r_px],
                                   fill=(200, 30, 30))
                rel = f"samples/{cam}/{tok}.jpg"
                (root / "samples" / cam).mkdir(parents=True, exist_ok=True)
                img.save(root / rel, quality=90)
                sample_datas.append({
                    "token": f"sd_{tok}_{cam}",
                    "sample_token": tok,
                    "ego_pose_token": pose_tok,
                    "calibrated_sensor_token": f"calib_{cam}",
                    "filename": rel,
                    "fileformat": "jpg",
                    "is_key_frame": True,
                })

            # LIDAR_TOP: a key-frame sweep + one earlier sweep from a
            # shifted ego pose seeing the SAME world points (so nsweeps=2
            # aggregation must align them exactly — exercises the
            # ego-motion compensation in get_lidar_data)
            ts = 1_000_000 * (s * 100 + k)
            ring_th = np.linspace(0, 2 * np.pi, 48, endpoint=False)
            world_pts = np.stack([
                ego_t[0] + 15.0 * np.cos(ring_th),
                ego_t[1] + 15.0 * np.sin(ring_th),
                np.full_like(ring_th, 0.5)], axis=1)
            rel = f"sweeps/LIDAR_TOP/{tok}.pcd.bin"
            _write_sweep(root / rel, world_pts, ego_t, ego_R)
            prev_yaw = ego_yaw + 0.05
            prev_t = ego_t + ego_R @ np.array([-1.5, 0.2, 0.0])
            prev_R = quat_to_rot(_yaw_quat(prev_yaw))
            ego_poses.append({"token": f"pose_{tok}_sweep",
                              "translation": prev_t.tolist(),
                              "rotation": _yaw_quat(prev_yaw),
                              "timestamp": ts - 100_000})
            rel_prev = f"sweeps/LIDAR_TOP/{tok}_prev.pcd.bin"
            _write_sweep(root / rel_prev, world_pts, prev_t, prev_R)
            sample_datas.append({
                "token": f"sd_{tok}_LIDAR_prev", "sample_token": tok,
                "ego_pose_token": f"pose_{tok}_sweep",
                "calibrated_sensor_token": "calib_LIDAR_TOP",
                "filename": rel_prev, "fileformat": "pcd.bin",
                "is_key_frame": False, "timestamp": ts - 100_000,
                "prev": "",
            })
            sample_datas.append({
                "token": f"sd_{tok}_LIDAR_TOP", "sample_token": tok,
                "ego_pose_token": pose_tok,
                "calibrated_sensor_token": "calib_LIDAR_TOP",
                "filename": rel, "fileformat": "pcd.bin",
                "is_key_frame": True, "timestamp": ts,
                "prev": f"sd_{tok}_LIDAR_prev",
            })

    logs = [{"token": "log_0", "location": map_name}]
    for sc in scenes:
        sc["log_token"] = "log_0"

    tables = {
        "scene": scenes, "sample": samples, "sample_data": sample_datas,
        "calibrated_sensor": calibs, "sensor": sensors,
        "ego_pose": ego_poses, "sample_annotation": annotations,
        "instance": instances, "category": categories, "log": logs,
    }
    for name, rows in tables.items():
        with open(table_dir / f"{name}.json", "w") as f:
            json.dump(rows, f)
    write_map_fixture(root, map_name)
    return root


def write_map_fixture(root, map_name: str = "boston-seaport",
                      half: float = 260.0, road_hw: float = 8.0) -> Path:
    """Write a tiny map-expansion JSON (nodes/lines/polygons + layer tables).

    Geometry: two crossing road strips through the origin spanning
    ``±half`` (wide enough to intersect every fixture ego pose, which are
    drawn from ±200), each split into two lanes by a center road divider,
    with lane dividers at the outer lane edges. Schema matches the
    published map expansion consumed by ``data.nusc_maps``.
    """
    root = Path(root)
    nodes, lines, polygons = [], [], []
    road_segments, lanes, road_dividers, lane_dividers = [], [], [], []

    def add_nodes(pts):
        toks = []
        for (x, y) in pts:
            tok = f"node_{len(nodes)}"
            nodes.append({"token": tok, "x": float(x), "y": float(y)})
            toks.append(tok)
        return toks

    def add_polygon(pts):
        tok = f"poly_{len(polygons)}"
        polygons.append({"token": tok, "exterior_node_tokens": add_nodes(pts),
                         "holes": []})
        return tok

    def add_line(pts):
        tok = f"line_{len(lines)}"
        lines.append({"token": tok, "node_tokens": add_nodes(pts)})
        return tok

    h, w = half, road_hw
    for horiz in (True, False):
        def pt(a, b):  # (along, across) -> (x, y)
            return (a, b) if horiz else (b, a)

        road_segments.append({
            "token": f"seg_{int(horiz)}", "is_intersection": False,
            "polygon_token": add_polygon(
                [pt(-h, -w), pt(h, -w), pt(h, w), pt(-h, w)])})
        for lo, hi in ((-w, 0.0), (0.0, w)):
            lanes.append({
                "token": f"lane_{int(horiz)}_{int(hi > 0)}",
                "polygon_token": add_polygon(
                    [pt(-h, lo), pt(h, lo), pt(h, hi), pt(-h, hi)])})
        road_dividers.append({
            "token": f"rdiv_{int(horiz)}",
            "line_token": add_line([pt(-h, 0.0), pt(h, 0.0)])})
        for edge in (-w, w):
            lane_dividers.append({
                "token": f"ldiv_{int(horiz)}_{int(edge > 0)}",
                "line_token": add_line([pt(-h, edge), pt(h, edge)])})

    data = {"node": nodes, "line": lines, "polygon": polygons,
            "road_segment": road_segments, "lane": lanes,
            "road_divider": road_dividers, "lane_divider": lane_dividers}
    out_dir = root / "maps" / "expansion"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{map_name}.json"
    with open(path, "w") as f:
        json.dump(data, f)
    return path
