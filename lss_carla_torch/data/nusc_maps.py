"""nuScenes map-expansion reader + BEV underlay, devkit-free: the port's
own copy of ``lss_carla_tpu/data/nusc_maps.py`` (numpy and the standard
library; matplotlib only where ``plot_nusc_map`` draws).

The reference draws a static-map underlay on its prediction panels through
the nuscenes-devkit ``NuScenesMap`` API (``get_nusc_maps`` /
``plot_nusc_map`` / ``get_local_map``, reference ``src/tools.py:287-363``,
used at ``src/explore.py:353-358``). This module implements the same
contract by parsing the published map-expansion JSON schema directly:

* ``node``    — {token, x, y} vertices in map (world) frame;
* ``line``    — {token, node_tokens} polylines (dividers);
* ``polygon`` — {token, exterior_node_tokens, holes} areas;
* layer tables (``road_segment``, ``lane`` → ``polygon_token``;
  ``road_divider``, ``lane_divider`` → ``line_token``).

Only the exterior rings are used, matching the reference
(``polygon.exterior.xy``, ``tools.py:349``). Geometry is pre-resolved to
coordinate arrays with per-record bounding boxes so the per-frame local-map
patch query is a vectorized bbox intersect instead of an R-tree.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# the four published nuScenes map locations (reference tools.py:288-293)
NUSC_MAP_NAMES = [
    "singapore-hollandvillage",
    "singapore-queenstown",
    "boston-seaport",
    "singapore-onenorth",
]

# layers the reference underlay draws (tools.py:316-317)
POLY_LAYERS = ("road_segment", "lane")
LINE_LAYERS = ("road_divider", "lane_divider")


def _find_map_json(map_folder, map_name: str) -> Path:
    """Resolve the expansion JSON under the devkit's expected layouts."""
    map_folder = Path(map_folder)
    for rel in (f"maps/expansion/{map_name}.json",
                f"expansion/{map_name}.json",
                f"{map_name}.json"):
        p = map_folder / rel
        if p.exists():
            return p
    raise FileNotFoundError(
        f"map expansion JSON for '{map_name}' not found under {map_folder} "
        f"(looked in maps/expansion/, expansion/, and the folder root)")


class NuscMap:
    """One map location, pre-resolved to numpy geometry per layer.

    ``self.geoms[layer]`` is a list of ``(N, 2)`` float arrays in the map
    (world) frame; ``self.bboxes[layer]`` is the matching ``(M, 4)`` array
    of ``(xmin, ymin, xmax, ymax)`` extents for fast patch queries.
    """

    def __init__(self, map_folder, map_name: str,
                 poly_layers: Sequence[str] = POLY_LAYERS,
                 line_layers: Sequence[str] = LINE_LAYERS):
        self.map_name = map_name
        with open(_find_map_json(map_folder, map_name)) as f:
            data = json.load(f)

        nodes = {n["token"]: (float(n["x"]), float(n["y"]))
                 for n in data.get("node", [])}
        lines = {ln["token"]: ln.get("node_tokens", [])
                 for ln in data.get("line", [])}
        polygons = {pg["token"]: pg.get("exterior_node_tokens", [])
                    for pg in data.get("polygon", [])}

        def resolve(tokens: List[str]):
            pts = np.array([nodes[t] for t in tokens if t in nodes],
                           dtype=np.float64)
            return pts if len(pts) >= 2 else None

        self.geoms: Dict[str, List[np.ndarray]] = {}
        self.bboxes: Dict[str, np.ndarray] = {}
        for layer in poly_layers:
            geoms = []
            for rec in data.get(layer, []):
                pts = resolve(polygons.get(rec.get("polygon_token", ""), []))
                if pts is not None:
                    geoms.append(pts)
            self._set_layer(layer, geoms)
        for layer in line_layers:
            geoms = []
            for rec in data.get(layer, []):
                pts = resolve(lines.get(rec.get("line_token", ""), []))
                if pts is not None:
                    geoms.append(pts)
            self._set_layer(layer, geoms)

    def _set_layer(self, layer: str, geoms: List[np.ndarray]) -> None:
        self.geoms[layer] = geoms
        if geoms:
            self.bboxes[layer] = np.array(
                [[g[:, 0].min(), g[:, 1].min(), g[:, 0].max(), g[:, 1].max()]
                 for g in geoms])
        else:
            self.bboxes[layer] = np.zeros((0, 4))


def get_nusc_maps(map_folder,
                  names: Optional[Sequence[str]] = None) -> Dict[str, NuscMap]:
    """Load map locations present under ``map_folder``.

    Reference ``get_nusc_maps`` (tools.py:287-296) hard-requires all four
    locations; here a subset is allowed (fixtures ship one) but an empty
    folder is an error. Pass ``names`` to load only the locations a split
    actually uses — the real expansion JSONs are hundreds of MB each, so
    eager-loading all four costs minutes of startup for nothing.
    """
    maps = {}
    for name in (NUSC_MAP_NAMES if names is None else names):
        try:
            maps[name] = NuscMap(map_folder, name)
        except FileNotFoundError:
            continue
    if not maps:
        raise FileNotFoundError(
            f"no map expansion JSONs found under {map_folder}")
    return maps


def get_local_map(nmap: NuscMap, center, stretch: float,
                  poly_names: Sequence[str] = POLY_LAYERS,
                  line_names: Sequence[str] = LINE_LAYERS,
                  ) -> Dict[str, List[np.ndarray]]:
    """Crop + transform map geometry into the ego frame.

    ``center = (x, y, cos(yaw), sin(yaw))`` — the reference's packed ego
    pose (tools.py:311-313). Records whose bbox intersects the axis-aligned
    ``±stretch`` patch are kept, then every point is mapped world→ego:
    ``p_ego = R(-yaw) @ (p - center)`` — exactly the reference's
    ``(pts - center) @ get_rot(yaw).T`` row-vector form (tools.py:356-360).
    """
    cx, cy, cth, sth = [float(v) for v in center]
    lo_x, lo_y = cx - stretch, cy - stretch
    hi_x, hi_y = cx + stretch, cy + stretch
    # world->ego rotation applied to row vectors on the right
    rot = np.array([[cth, -sth], [sth, cth]])

    out: Dict[str, List[np.ndarray]] = {}
    for layer in list(poly_names) + list(line_names):
        geoms, bbox = nmap.geoms.get(layer, []), nmap.bboxes.get(layer)
        if bbox is None or len(bbox) == 0:
            out[layer] = []
            continue
        keep = ((bbox[:, 0] <= hi_x) & (bbox[:, 2] >= lo_x) &
                (bbox[:, 1] <= hi_y) & (bbox[:, 3] >= lo_y))
        out[layer] = [(geoms[i] - (cx, cy)) @ rot
                      for i in np.nonzero(keep)[0]]
    return out


def plot_nusc_map(ax, nmap: NuscMap, ego_xy, ego_yaw: float,
                  stretch: float = 50.0) -> None:
    """Draw the reference's underlay onto a metric ego-frame BEV axes.

    The axes convention is ``utils.viz``'s: plot-x = ego Y, plot-y = ego X
    (forward up). Colors/alphas match reference ``plot_nusc_map``
    (tools.py:318-325): road/lane polygons coral fill α=0.2, road dividers
    blue, lane dividers purple.
    """
    center = (float(ego_xy[0]), float(ego_xy[1]),
              float(np.cos(ego_yaw)), float(np.sin(ego_yaw)))
    lmap = get_local_map(nmap, center, stretch)
    for layer in POLY_LAYERS:
        for pts in lmap[layer]:
            ax.fill(pts[:, 1], pts[:, 0], c=(1.00, 0.50, 0.31), alpha=0.2,
                    zorder=1)
    for pts in lmap["road_divider"]:
        ax.plot(pts[:, 1], pts[:, 0], c=(0.0, 0.0, 1.0), alpha=0.5, zorder=1)
    for pts in lmap["lane_divider"]:
        ax.plot(pts[:, 1], pts[:, 0], c=(159.0 / 255.0, 0.0, 1.0), alpha=0.5,
                zorder=1)


def yaw_from_quat(q) -> float:
    """Ego heading from a wxyz quaternion — the reference reads it off the
    rotation matrix as ``arctan2(R[1,0], R[0,0])`` (tools.py:310-311)."""
    from lss_carla_torch.data.nuscenes import quat_to_rot
    R = quat_to_rot(q)
    return float(np.arctan2(R[1, 0], R[0, 0]))
