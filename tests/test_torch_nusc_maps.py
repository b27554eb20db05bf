"""The port's map-expansion reader (``data/nusc_maps.py``) and the explore
tools' nuScenes figures (the map underlay of ``viz_model_preds``,
``lidar_check``'s lidar panels) against the JAX package on the CPU.

Tolerances: map geometry and the local map 1e-6 (the same float64
arithmetic); the lidar panels' pixels and depths 1e-4 of their scale (f32
projections through a 3 x 3 inverse-free chain on both sides)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lss_carla_tpu.configs import DataAugConf as JAug
from lss_carla_tpu.configs import GridConf as JGrid
from lss_carla_tpu.data import nusc_maps as JM
from lss_carla_tpu.data import nuscenes as JN
from lss_carla_tpu.ops import geometry as JG

from lss_carla_torch import explore
from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data import fixtures_nuscenes as F
from lss_carla_torch.data import nusc_maps as M
from lss_carla_torch.data import nuscenes as N
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.utils.checkpoint import CheckpointManager

SRC = dict(H=112, W=240)
GRID = dict(xbound=(-50.0, 50.0, 6.25), ybound=(-50.0, 50.0, 6.25),
            dbound=(4.0, 36.0, 8.0))


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    return F.generate_nuscenes_fixture(tmp_path_factory.mktemp("nuscmap"),
                                       num_scenes=3, samples_per_scene=2,
                                       **SRC, seed=6)


def test_map_layers_match_jax(nusc_root):
    got, want = M.NuscMap(nusc_root, "boston-seaport"), \
        JM.NuscMap(nusc_root, "boston-seaport")
    assert set(got.geoms) == set(want.geoms) == {
        "road_segment", "lane", "road_divider", "lane_divider"}
    assert [len(got.geoms[k]) for k in M.POLY_LAYERS + M.LINE_LAYERS] == \
        [2, 4, 2, 4]
    for layer in got.geoms:
        assert len(got.geoms[layer]) == len(want.geoms[layer])
        for g, w in zip(got.geoms[layer], want.geoms[layer]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.bboxes[layer], want.bboxes[layer],
                                   rtol=0, atol=1e-6)


def test_get_nusc_maps_layouts_subsets_and_refusals(nusc_root, tmp_path):
    """The devkit's layouts (maps/expansion/, expansion/, the folder root),
    a subset of the four locations, and an empty folder raising, as
    JAX's."""
    assert set(M.get_nusc_maps(nusc_root)) == set(JM.get_nusc_maps(nusc_root)) \
        == {"boston-seaport"}
    assert set(M.get_nusc_maps(nusc_root, names=["boston-seaport"])) == \
        {"boston-seaport"}
    data = (nusc_root / "maps" / "expansion" / "boston-seaport.json").read_text()
    for rel in ("expansion/singapore-onenorth.json", "singapore-queenstown.json"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(data)
    assert set(M.get_nusc_maps(tmp_path)) == {"singapore-onenorth",
                                              "singapore-queenstown"}
    with pytest.raises(FileNotFoundError, match="no map expansion"):
        M.get_nusc_maps(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="not found"):
        M.NuscMap(tmp_path, "boston-seaport")
    json.loads(data)  # the fixture's map is plain JSON


def test_local_map_and_yaw_match_jax(nusc_root):
    got, want = M.NuscMap(nusc_root, "boston-seaport"), \
        JM.NuscMap(nusc_root, "boston-seaport")
    rng = np.random.default_rng(63)
    for _ in range(6):
        yaw = float(rng.uniform(-np.pi, np.pi))
        center = (float(rng.uniform(-220, 220)), float(rng.uniform(-220, 220)),
                  np.cos(yaw), np.sin(yaw))
        stretch = float(rng.uniform(20, 80))
        a, b = M.get_local_map(got, center, stretch), \
            JM.get_local_map(want, center, stretch)
        assert set(a) == set(b)
        for layer in a:
            assert len(a[layer]) == len(b[layer])
            for g, w in zip(a[layer], b[layer]):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        q = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
        assert abs(M.yaw_from_quat(q) - JM.yaw_from_quat(q)) <= 1e-12
        np.testing.assert_allclose(M.yaw_from_quat(q), yaw, atol=1e-9)


def test_plot_nusc_map_draws_what_jax_draws(nusc_root):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    counts = []
    for mod in (M, JM):
        fig, ax = plt.subplots()
        mod.plot_nusc_map(ax, mod.NuscMap(nusc_root, "boston-seaport"),
                          (12.0, -30.0), 0.4, stretch=50.0)
        counts.append((len(ax.patches), len(ax.lines)))
        plt.close(fig)
    assert counts[0] == counts[1] and counts[0][0] > 0 and counts[0][1] > 0


def test_map_poses_and_local_maps_of_the_val_samples(nusc_root):
    """The underlay's compute part: each val sample's map, ego position and
    yaw (from its CAM_FRONT ego pose), and its local map equal to JAX's
    get_local_map at that pose."""
    aug = DataAugConf(**SRC, final_dim=(32, 64))
    ds = N.NuScenesDataset(nusc_root, False, aug, GridConf())
    poses = explore.map_poses(ds, str(nusc_root))
    jmap = JM.NuscMap(nusc_root, "boston-seaport")
    assert len(poses) == len(ds.samples) == 2
    for tok, (nmap, xy, yaw) in zip(ds.samples, poses):
        pose = ds._ego_pose_for(tok)
        assert nmap.map_name == "boston-seaport" and list(xy) == pose["translation"][:2]
        assert yaw == JM.yaw_from_quat(pose["rotation"])
        got = M.get_local_map(nmap, (xy[0], xy[1], np.cos(yaw), np.sin(yaw)),
                              50.0)
        want = JM.get_local_map(jmap, (xy[0], xy[1], np.cos(yaw), np.sin(yaw)),
                                50.0)
        assert sum(map(len, got.values())) > 0  # the roads cross every pose
        for layer in got:
            for g, w in zip(got[layer], want[layer]):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_viz_model_preds_draws_the_map_underlay(nusc_root, tmp_path):
    """nuScenes predictions with the underlay, one PNG a val sample; the
    underlay on SimBEV raises, as in JAX."""
    model = compile_model(GridConf(**GRID), DataAugConf(**SRC, final_dim=(32, 64)),
                          variant="slim", device="cpu")
    opt = torch.optim.Adam(model.parameters())
    CheckpointManager(tmp_path / "ckpts").save_best(2, model, opt, 0, 0.1)
    kw = dict(checkpoint=str(tmp_path / "ckpts"), best=True, variant="slim",
              bsz=2, dataset="nuscenes", **SRC, final_dim=(32, 64),
              grid_conf=GridConf(**GRID), device="cpu")
    n = explore.viz_model_preds(nusc_root, outdir=str(tmp_path / "viz"),
                                map_folder=str(nusc_root), **kw)
    assert n == 2 and sorted(p.name for p in (tmp_path / "viz").iterdir()) == [
        "eval000000.png", "eval000001.png"]
    with pytest.raises(ValueError, match="needs dataset='nuscenes'"):
        explore.viz_model_preds(nusc_root, map_folder=str(nusc_root),
                                **dict(kw, dataset="simbev"))


def test_lidar_check_panels_match_jax_projections(nusc_root, tmp_path):
    """lidar_check's nuScenes compute part: the multi-sweep cloud of each
    val sample (get_lidar_data), and for each camera the pixels and depths
    of the points it sees, equal to the same chain in JAX (ego_to_cam,
    get_only_in_img_mask, the tracked homography); the PNGs written."""
    panels = explore.lidar_panels(nusc_root, **SRC, final_dim=(64, 176),
                                  max_samples=2, nsweeps=2, device="cpu")
    aug = JAug(**SRC, final_dim=(64, 176), bot_pct_lim=(0.0, 0.22))
    jds = JN.NuScenesDataset(nusc_root, False, aug, JGrid())
    assert [p["token"] for p in panels] == jds.samples
    for p in panels:
        imgs, rots, trans, intrins, post_rots, post_trans = jds.get_image_data(
            p["token"], JN.NUSC_CAMERA_ORDER)
        np.testing.assert_array_equal(p["imgs"], imgs)
        pts = JN.get_lidar_data(jds.t, nusc_root, p["token"], nsweeps=2)
        np.testing.assert_allclose(p["points"], pts, rtol=0, atol=1e-5)
        xyz = jnp.asarray(pts[:3], jnp.float32)
        for ci, seen in enumerate(p["cams"]):
            cam = np.asarray(JG.ego_to_cam(xyz, jnp.asarray(rots[ci]),
                                           jnp.asarray(trans[ci]),
                                           jnp.asarray(intrins[ci])))
            mask = np.array(JG.get_only_in_img_mask(jnp.asarray(cam), 112, 240))
            plot = post_rots[ci] @ cam + post_trans[ci][:, None]
            mask &= (plot[0] > 0) & (plot[0] < 176) & (plot[1] > 0) & (plot[1] < 64)
            want = np.stack([plot[0], plot[1], cam[2]])[:, mask]
            assert seen.shape == want.shape and seen.shape[1] > 0
            np.testing.assert_allclose(seen, want, rtol=1e-4, atol=1e-4)
    paths = explore.lidar_check(nusc_root, outdir=str(tmp_path / "lc"), **SRC,
                                final_dim=(64, 176), dataset="nuscenes",
                                max_samples=1, nsweeps=2, device="cpu")
    assert [p.split("/")[-1] for p in paths] == ["lcheck00000.png"]
