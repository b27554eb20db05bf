"""The port's reference symbol surface (``lss_carla_torch/tools.py``,
counterpart of ``lss_carla_tpu/tools.py``; its nuScenes symbols are held
in test_torch_nuscenes.py and test_torch_nusc_maps.py) and the geometry and image
helpers behind it, against the JAX package on the CPU: ``get_rot``,
``ego_to_cam``, ``cam_to_ego``, ``get_only_in_img_mask``,
``denormalize_img``, ``img_transform`` (the reference signature) and
``cumsum_trick`` forward and gradient. Inputs from each test's own seed;
f32 on both sides, so geometry is held to 1e-5 relative (a 3x3 inverse
and two products), the rest exactly or to 1e-6."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from lss_carla_tpu import tools as J
from lss_carla_tpu.ops import geometry as JG

from lss_carla_torch import tools as T

GEOM_TOL = dict(rtol=1e-5, atol=1e-5)


def test_reference_symbols_importable():
    for name in ("gen_dx_bx", "get_rot", "img_transform", "normalize_img",
                 "denormalize_img", "ego_to_cam", "cam_to_ego",
                 "get_only_in_img_mask", "SimpleLoss", "get_batch_iou",
                 "get_val_info", "add_ego", "cumsum_trick", "quick_cumsum",
                 "get_nusc_maps", "get_local_map", "plot_nusc_map",
                 "get_lidar_data"):
        assert hasattr(T, name), name
    assert T.cumsum_trick is T.quick_cumsum is T.splat_scatter_add


def test_add_ego_draws():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure()
    T.add_ego(np.array([-49.75, -49.75, 0.0]), np.array([0.5, 0.5, 20.0]))
    (patch,) = plt.gca().patches
    # the reference box in grid cells: x from (-1.542 + 49.75) / 0.5
    np.testing.assert_allclose(patch.get_xy()[:, 1].min(), (-1.542 + 49.75) / 0.5)
    plt.close(fig)


def _camera(rng):
    """A rotation, translation and pinhole intrinsics."""
    a, b, c = rng.uniform(-np.pi, np.pi, 3)
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)], [0, np.sin(c), np.cos(c)]])
    rot = (rz @ ry @ rx).astype(np.float32)
    trans = rng.normal(0, 2, 3).astype(np.float32)
    intrins = np.array([[300, 0, 176], [0, 300, 64], [0, 0, 1]], np.float32)
    return rot, trans, intrins


def test_geometry_functions_match_jax():
    rng = np.random.default_rng(60)
    rot, trans, intrins = _camera(rng)
    pts = rng.uniform(-30, 30, (3, 400)).astype(np.float32)
    for h in (0.0, 0.3, -2.1):
        np.testing.assert_array_equal(T.get_rot(h), JG.get_rot(h))
    cam = T.ego_to_cam(*map(torch.from_numpy, (pts, rot, trans, intrins)))
    jcam = np.asarray(JG.ego_to_cam(*map(jnp.asarray, (pts, rot, trans, intrins))))
    np.testing.assert_allclose(cam.numpy(), jcam, **GEOM_TOL)
    # points in front of the camera, so the round trip is defined
    front = cam[:, cam[2] > 1.0]
    assert front.shape[1] > 50
    ego = T.cam_to_ego(front, *map(torch.from_numpy, (rot, trans, intrins)))
    jego = np.asarray(JG.cam_to_ego(jnp.asarray(front.numpy()),
                                    *map(jnp.asarray, (rot, trans, intrins))))
    np.testing.assert_allclose(ego.numpy(), jego, **GEOM_TOL)
    np.testing.assert_allclose(ego.numpy(), pts[:, (cam[2] > 1.0).numpy()],
                               rtol=1e-4, atol=1e-3)
    mask = T.get_only_in_img_mask(cam, 128, 352)
    jmask = np.asarray(JG.get_only_in_img_mask(jnp.asarray(jcam), 128, 352))
    assert mask.dtype == torch.bool and 0 < int(mask.sum()) < pts.shape[1]
    np.testing.assert_array_equal(mask.numpy(), jmask)


def test_normalize_and_denormalize_match_jax():
    rng = np.random.default_rng(61)
    img = rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    x = T.normalize_img(img)
    np.testing.assert_array_equal(x, J.normalize_img(img))
    out = T.denormalize_img(x)
    np.testing.assert_array_equal(out, np.asarray(J.denormalize_img(x)))
    np.testing.assert_allclose(out, img / 255.0, atol=1e-6)
    wide = T.denormalize_img(5.0 * rng.normal(size=(2, 2, 3)))
    assert wide.min() == 0.0 and wide.max() == 1.0  # clipped


@pytest.mark.parametrize("flip,rotate", [(False, 0.0), (True, 4.5)])
def test_img_transform_reference_signature_matches_jax(flip, rotate):
    rng = np.random.default_rng(62)
    img = Image.fromarray(rng.integers(0, 256, (60, 100, 3), dtype=np.uint8))
    post_rot = np.eye(2, dtype=np.float32) * 1.5
    post_tran = np.array([3.0, -2.0], np.float32)
    args = (0.8, (80, 48), (4, 6, 68, 38), flip, rotate)
    got = T.img_transform(img, post_rot, post_tran, *args)
    want = J.img_transform(img, post_rot, post_tran, *args)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_cumsum_trick_matches_jax_splat_scatter_add():
    """Per-voxel sums of (P, C) features by id, out-of-range ids dropped;
    the gradient is the cotangent gathered at each id (0 when dropped)."""
    rng = np.random.default_rng(63)
    P, C, S = 300, 5, 40
    feats = rng.normal(size=(P, C)).astype(np.float32)
    ids = rng.integers(0, S + 8, P).astype(np.int32)  # some at or past S
    cot = rng.normal(size=(S, C)).astype(np.float32)
    t = torch.from_numpy(feats).requires_grad_()
    out = T.cumsum_trick(t, torch.from_numpy(ids), S)
    (out * torch.from_numpy(cot)).sum().backward()
    jout, vjp = jax.vjp(lambda f: J.cumsum_trick(f, jnp.asarray(ids), S),
                        jnp.asarray(feats))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))
    assert out.shape == (S, C) and (t.grad[torch.from_numpy(ids) >= S] == 0).all()


def test_loss_and_iou_match_jax():
    rng = np.random.default_rng(64)
    logits = (3 * rng.normal(size=(2, 1, 8, 8))).astype(np.float32)
    target = (rng.uniform(size=(2, 1, 8, 8)) < 0.3).astype(np.float32)
    got = T.SimpleLoss(2.13)(torch.from_numpy(logits), torch.from_numpy(target))
    want = J.SimpleLoss(2.13)(jnp.asarray(logits), jnp.asarray(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert T.get_batch_iou(torch.from_numpy(logits), torch.from_numpy(target)) == \
        J.get_batch_iou(jnp.asarray(logits), jnp.asarray(target))
