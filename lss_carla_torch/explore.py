"""Evaluation, figure and check tools: counterpart of ``lss_carla_tpu/explore.py``
(reference ``src/explore.py``), on the SimBEV or the nuScenes loader
(``dataset``; nuScenes sources default to 900 x 1600).

* ``eval_model_iou``: restore a checkpoint, run the whole val loader and
  print and return ``get_val_info``'s dict (mean loss, dataset IoU and,
  for multiclass heads, ``iou_per_class``).
* ``viz_model_preds``: the camera / GT / prediction / overlay figure of
  every non-padded val sample of the first ``max_batches`` batches, one PNG
  each; ``model_preds`` is its compute part (the predictions, no
  matplotlib). With nuScenes and a ``map_folder``, the prediction panel
  gets the static-map underlay; ``map_poses`` is its compute part.
* ``splat_check``: one batch through the model's splat (the CUDA kernel on
  a CUDA tensor) and through its plain version (``splat_reference``, with
  the gather backward), from the same lift and voxel ids; both sides go
  through the same ``decode_bev`` and weighted BCE, in eval mode, and the
  outputs, losses and ``depthnet.weight`` gradients are compared (the
  reference's ``cumsum_check``).
* ``lidar_check``: geometry figures, no model. SimBEV: each camera's
  frustum in the BEV plane (``frustum_points`` is the compute part).
  nuScenes: per sample, the multi-sweep lidar projected into every
  augmented camera image, the lidar in BEV and the GT mask
  (``lidar_panels`` is the compute part).

Checkpoints are the port's files (``utils/checkpoint.py``): a file, or a
run's ``ckpts`` directory (its newest checkpoint, or ``model_best.pt`` with
``best``); ``use_ema`` evaluates a checkpoint's ``ema_state_dict``. Every
tool takes ``device``: "cuda" unless the caller asks for the CPU; no GPU
raises. ``eval_model_iou(quantize=True)`` runs the eligible convs in int8
(``ops/quant.py``). Multiclass labels (``label_mode="multiclass"``) need
SimBEV: with nuScenes they raise ``ValueError``, as ``train()`` does (the
JAX tool drops them silently, then the shapes clash).

    python -m lss_carla_torch.explore eval_model_iou --dataroot DIR \\
        --checkpoint RUN/ckpts --best [--ema] [--quantize] [--variant resnet18]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.loader import compile_data
from lss_carla_torch.data.nusc_maps import (get_nusc_maps, plot_nusc_map,
                                            yaw_from_quat)
from lss_carla_torch.data.nuscenes import (NUSC_CAMERA_ORDER,
                                           NuScenesDataset,
                                           compile_data_nuscenes,
                                           get_lidar_data)
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops.geometry import (create_frustum, ego_to_cam,
                                          get_geometry, get_only_in_img_mask)
from lss_carla_torch.ops.quant import quantize_model
from lss_carla_torch.ops.library import gather_cotangent, splat_reference
from lss_carla_torch.ops.splat import splat, voxel_indices
from lss_carla_torch.training.loop import get_val_info
from lss_carla_torch.training.loss import bce_with_logits
from lss_carla_torch.training.step import (make_eval_step, make_predict_step,
                                           to_device)
from lss_carla_torch.utils.backend import resolve_device
from lss_carla_torch.utils.checkpoint import BEST, load_checkpoint
from lss_carla_torch.utils.convert import reference_state_dict

# each dataset's source size (H, W) when none is given, and the bottom-crop
# range whose mean places the validation crop: building the homography
# against SimBEV's size on 900 x 1600 nuScenes images would scale the
# camera geometry by ~3x, and the original nuScenes config (configs.py::
# nuscenes_aug, train_nuscenes.py) trains and validates with bot_pct_lim
# (0, 0.22). The JAX tools crop nuScenes with (0, 0) (ROADMAP.md §C).
DATASET_AUG = {"simbev": dict(H=224, W=480, bot_pct_lim=(0.0, 0.0)),
               "nuscenes": dict(H=900, W=1600, bot_pct_lim=(0.0, 0.22))}


def _aug_conf(dataset: str, H, W, final_dim, ncams: int = 6) -> DataAugConf:
    if dataset not in DATASET_AUG:
        raise ValueError(f"unknown dataset: {dataset!r}")
    d = DATASET_AUG[dataset]
    return DataAugConf(H=H or d["H"], W=W or d["W"], final_dim=tuple(final_dim),
                       bot_pct_lim=d["bot_pct_lim"], Ncams=ncams)


def load_weights(checkpoint: str, best: bool = False,
                 use_ema: bool = False) -> dict:
    """The state dict to evaluate from a port checkpoint (file or
    directory) or a reference ``.pt``: ``model_best.pt`` of a directory
    with ``best``, the ``ema_state_dict`` with ``use_ema`` (the raw weights,
    with a note, where a checkpoint has none)."""
    path = checkpoint
    if best:
        if not os.path.isdir(path):
            raise ValueError(f"best takes a checkpoint directory, got {path}")
        path = os.path.join(path, BEST)
    ckpt = load_checkpoint(path)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        print(f"restored checkpoint step={ckpt.get('counter')}"
              + (" (best)" if best else ""))
        if use_ema and "ema_state_dict" in ckpt:
            return reference_state_dict(ckpt["ema_state_dict"])
        if use_ema:
            print("checkpoint has no EMA weights; evaluating the raw ones")
        ckpt = ckpt["model_state_dict"]
    return reference_state_dict(ckpt)


def _build(dataroot, bsz=4, nworkers=4, H=None, W=None,
           final_dim=(128, 352), ncams=6, checkpoint: Optional[str] = None,
           best: bool = False, grid_conf: Optional[GridConf] = None,
           dataset: str = "simbev", version: str = "v1.0-mini",
           use_ema: bool = False, label_mode: str = "vehicle_binary",
           label_classes=(0, 1, 2, 3), device="cuda", **model_kw):
    """(model in eval mode on the device, trainloader, valloader,
    grid_conf, aug_conf). ``model_kw`` (``variant``, ``compute_dtype``,
    ...) go to ``compile_model``; the loaders ship uint8 images normalised
    on the device, as the trainer's do. ``version``: the nuScenes table
    directory; the validation crop is ``DATASET_AUG``'s."""
    dev = resolve_device(device)
    aug_conf = _aug_conf(dataset, H, W, final_dim, ncams)
    grid_conf = grid_conf or GridConf()
    if dataset == "nuscenes":
        if label_mode != "vehicle_binary":
            raise ValueError(f"dataset='nuscenes' supports only "
                             f"label_mode='vehicle_binary' (got "
                             f"{label_mode!r})")
        trainloader, valloader = compile_data_nuscenes(
            version, dataroot, aug_conf, grid_conf, bsz=bsz,
            nworkers=nworkers, device_normalize=True)
    else:
        trainloader, valloader = compile_data(
            "unused", dataroot, aug_conf, grid_conf, bsz=bsz,
            nworkers=nworkers,
            dataset_kwargs={"label_mode": label_mode,
                            "label_classes": tuple(label_classes),
                            "device_normalize": True})
    outC = len(label_classes) if label_mode == "multiclass" else 1
    model = compile_model(grid_conf, aug_conf, outC=outC, device="cpu",
                          **model_kw)
    if checkpoint:
        model.load_state_dict(load_weights(checkpoint, best, use_ema))
    return model.eval().to(dev), trainloader, valloader, grid_conf, aug_conf


def eval_model_iou(dataroot, checkpoint: str, bsz=4, nworkers=4,
                   quantize: bool = False, device="cuda", **kw) -> dict:
    """Mean val loss (BCE, pos_weight 2.13), dataset IoU and, for outC > 1,
    ``iou_per_class`` of a checkpoint over the whole val set. ``quantize``:
    the eligible convs in int8 (``quantize_model``, min_channels 64), so
    the IoU against the float eval is the quantisation's cost."""
    model, _, valloader, *_ = _build(dataroot, bsz=bsz, nworkers=nworkers,
                                     checkpoint=checkpoint, device=device,
                                     **kw)
    if quantize:
        model, swapped = quantize_model(model)
        print(f"int8: {len(swapped)} convs")
    dev = next(model.parameters()).device
    info = get_val_info(make_eval_step(model, pos_weight=2.13, device=dev),
                        None, valloader, dev)
    print(info)
    return info


def _preds(dataroot, checkpoint, max_batches, bsz, device, **kw):
    """``model_preds``'s (samples, extent) and the val dataset."""
    model, _, valloader, grid_conf, _ = _build(
        dataroot, bsz=bsz, checkpoint=checkpoint, device=device, **kw)
    predict = make_predict_step(model, device=next(model.parameters()).device)
    samples = []
    for bi, batch in enumerate(valloader):
        if bi >= max_batches:
            break
        preds = torch.sigmoid(predict(None, batch[:6]).float()).cpu().numpy()
        valid = batch[7] if len(batch) > 7 else np.ones(len(preds))
        for si in range(preds.shape[0]):
            if valid[si] == 0.0:
                continue  # a pad_last wrap-around duplicate, not a sample
            samples.append((batch[0][si], batch[6][si, 0], preds[si, 0]))
    extent = (grid_conf.ybound[0], grid_conf.ybound[1],
              grid_conf.xbound[0], grid_conf.xbound[1])
    return samples, extent, valloader.dataset


def model_preds(dataroot, checkpoint: Optional[str] = None, max_batches=2,
                bsz=4, device="cuda", **kw):
    """The compute part of ``viz_model_preds``: (samples, extent), samples
    a list of (camera images (N, 3, H, W), GT (X, Y), sigmoid prediction
    (X, Y)) of class 0, numpy, for each non-padded sample of the first
    ``max_batches`` val batches (val sample i is the i-th: the val loader
    keeps the order); extent the BEV grid's (ymin, ymax, xmin, xmax)."""
    samples, extent, _ = _preds(dataroot, checkpoint, max_batches, bsz,
                                device, **kw)
    return samples, extent


def map_poses(ds: NuScenesDataset, map_folder: str):
    """The compute part of the map underlay: for each sample of the
    nuScenes dataset ``ds``, (``NuscMap`` of its scene's location, ego (x,
    y), ego yaw), or None where ``map_folder`` lacks that location. Only
    the locations ``ds`` uses are loaded (a real expansion JSON is hundreds
    of MB)."""
    scene2map = ds.t.scene2map()
    scene_name = {sc["token"]: sc["name"] for sc in ds.t.scene}
    locs = [scene2map[scene_name[ds.t.sample[tok]["scene_token"]]]
            for tok in ds.samples]
    maps = get_nusc_maps(map_folder, names=sorted(set(locs)))
    out = []
    for tok, loc in zip(ds.samples, locs):
        pose = ds._ego_pose_for(tok)
        out.append((maps[loc], pose["translation"][:2],
                    yaw_from_quat(pose["rotation"])) if loc in maps else None)
    return out


def viz_model_preds(dataroot, checkpoint: Optional[str] = None,
                    outdir="./viz_outputs", max_batches=2, bsz=4,
                    dataset: str = "simbev",
                    map_folder: Optional[str] = None, device="cuda", **kw):
    """Render ``model_preds``'s samples to ``outdir/eval{i:06d}.png``
    (reference ``explore.py:249-363``). With ``dataset="nuscenes"`` and a
    ``map_folder`` of map-expansion JSONs, the prediction panel gets the
    reference's static-map underlay (``explore.py:353-358``). Returns the
    number of PNGs."""
    if map_folder is not None and dataset != "nuscenes":
        raise ValueError("the map underlay needs dataset='nuscenes' (SimBEV "
                         "publishes no map expansion)")
    samples, extent, ds = _preds(dataroot, checkpoint, max_batches, bsz,
                                 device, dataset=dataset, **kw)
    poses = map_poses(ds, map_folder) if map_folder is not None else None
    stretch = max(abs(float(b)) for b in extent)
    import matplotlib.pyplot as plt
    from lss_carla_torch.utils.viz import make_bev_figure
    os.makedirs(outdir, exist_ok=True)
    for count, (imgs, gt, pred) in enumerate(samples):
        pose = poses[count] if poses is not None else None
        map_draw = (None if pose is None else
                    lambda ax, p=pose: plot_nusc_map(ax, *p, stretch))
        fig = make_bev_figure(imgs, gt, pred, extent=extent,
                              map_draw=map_draw)
        path = os.path.join(outdir, f"eval{count:06d}.png")
        fig.savefig(path)
        plt.close(fig)
        print(path)
    return len(samples)


class _PlainSplat(torch.autograd.Function):
    """``splat_reference`` with the gather backward: the yardstick side of
    ``splat_check``, never the model's own path."""

    @staticmethod
    def forward(ctx, pts, ids, num_slots):
        ctx.save_for_backward(ids)
        ctx.num_slots = int(num_slots)
        return splat_reference(pts, ids, num_slots)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return gather_cotangent(g, ids, ctx.num_slots), None, None


def _synthetic_batch(bsz: int, device, **model_kw):
    """The JAX tool's tiny synthetic config and batch (no dataroot)."""
    grid_conf = GridConf(xbound=(-40.0, 40.0, 1.25),
                         ybound=(-40.0, 40.0, 1.25), dbound=(4.0, 44.0, 2.0))
    aug_conf = DataAugConf(H=64, W=128, final_dim=(32, 64))
    model = compile_model(grid_conf, aug_conf, outC=1, device=device,
                          **model_kw)
    rng = np.random.default_rng(0)
    fH, fW = aug_conf.final_dim
    nxy = int(grid_conf.nx[0])
    imgs = rng.normal(size=(bsz, 6, 3, fH, fW)).astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32), (bsz, 6, 1, 1))
    intr = eye.copy()
    intr[..., 0, 0] = intr[..., 1, 1] = 60.0
    intr[..., 0, 2], intr[..., 1, 2] = fW / 2, fH / 2
    zeros3 = np.zeros((bsz, 6, 3), np.float32)
    binimg = (rng.uniform(size=(bsz, 1, nxy, nxy)) < 0.03).astype(np.float32)
    return model.eval(), (imgs, eye, zeros3, intr, eye, zeros3, binimg)


def splat_check(dataroot=None, bsz=2, device="cuda", variant: str = "b0",
                compute_dtype: str = "float32", remat: bool = False,
                **kw) -> dict:
    """Forward and backward of one batch through the kernel and the plain
    splat (the reference ``cumsum_check`` contract, ``explore.py:166-191``).

    With a ``dataroot``: the first train batch of that data, through the
    model ``_build`` makes (``kw`` as there); without: the JAX tool's tiny
    synthetic config (``kw`` unused). ``remat`` is the model's field, which
    the tool carries as JAX's does (its eval-mode forward leaves it
    idle). Returns {"kernel": side, "plain":
    side}, each side {"out_mean", "grad_mean", "loss" (floats), "logits",
    "grad" (the depthnet weight gradient; tensors)}.

    cuDNN runs its deterministic algorithms meanwhile, so that only the
    splat's summation order differs between the sides: its default
    backward algorithms alone move the depthnet gradient from call to call
    (6.3e-6 relative L2 between two calls of one side on a trained B0 on
    an H100, against 1.3e-7 with the deterministic ones)."""
    dev = resolve_device(device)
    if dataroot is not None:
        model, trainloader, *_ = _build(dataroot, bsz=bsz, device=dev,
                                        variant=variant, remat=remat,
                                        compute_dtype=compute_dtype, **kw)
        batch = next(iter(trainloader))
    else:
        model, batch = _synthetic_batch(bsz, dev, variant=variant,
                                        compute_dtype=compute_dtype,
                                        remat=remat)
    imgs, rots, trans, intrins, post_rots, post_trans, binimgs = \
        to_device(batch[:7], dev)
    X, Y, nz = (int(n) for n in model.nx)
    with torch.no_grad():
        geom = model.get_geometry(rots, trans, intrins, post_rots, post_trans)
        ids, _ = voxel_indices(geom, model.dx, model.bx, model.nx)
        ids = ids.reshape(ids.shape[0], -1).contiguous()
    results = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, splat_fn in (("kernel", splat), ("plain", _PlainSplat.apply)):
            model.zero_grad(set_to_none=True)
            feats = model.get_cam_feats(imgs)
            B, C = feats.shape[0], feats.shape[-1]
            out = splat_fn(feats.reshape(B, -1, C).contiguous(), ids,
                           nz * X * Y)
            bev = out.view(B, nz, X, Y, C).permute(0, 2, 3, 1, 4).reshape(
                B, X, Y, nz * C)
            logits = model.decode_bev(bev)
            loss = bce_with_logits(logits, binimgs, 2.13)
            loss.backward()
            grad = model.camencode.depthnet.weight.grad.detach().clone()
            logits, loss = logits.detach(), loss.detach()
            results[name] = {"out_mean": float(logits.mean()),
                             "grad_mean": float(grad.mean()),
                             "loss": float(loss), "logits": logits,
                             "grad": grad}
            print(f"{name}: out.mean={results[name]['out_mean']:.6f} "
                  f"depthnet.grad.mean={results[name]['grad_mean']:.3e} "
                  f"loss={results[name]['loss']:.6f}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    model.zero_grad(set_to_none=True)
    a, b = results["kernel"], results["plain"]
    print(f"|Δout.mean|={abs(a['out_mean'] - b['out_mean']):.2e} "
          f"|Δgrad.mean|={abs(a['grad_mean'] - b['grad_mean']):.2e} "
          f"|Δloss|={abs(a['loss'] - b['loss']):.2e} max|Δlogit|="
          f"{float((a['logits'] - b['logits']).abs().max()):.2e}")
    return results


def frustum_points(dataroot, H=None, W=None, final_dim=(128, 352),
                   device="cuda") -> np.ndarray:
    """The compute part of ``lidar_check``'s SimBEV mode: the ego-frame
    (x, y, z) of every frustum cell of the first val sample's cameras,
    (N, D, fH, fW, 3) numpy, computed on ``device``."""
    dev = resolve_device(device)
    grid_conf = GridConf()
    aug_conf = _aug_conf("simbev", H, W, final_dim)
    _, valloader = compile_data("unused", dataroot, aug_conf, grid_conf,
                                bsz=1, nworkers=0)
    batch = to_device(next(iter(valloader))[1:6], dev)
    frustum = torch.from_numpy(create_frustum(aug_conf.final_dim, 16,
                                              grid_conf.dbound)).to(dev)
    return get_geometry(frustum, *batch)[0].cpu().numpy()


def lidar_panels(dataroot, H=None, W=None, final_dim=(128, 352),
                 version: str = "v1.0-mini", max_samples: int = 2,
                 nsweeps: int = 3, device="cuda") -> list:
    """The compute part of ``lidar_check``'s nuScenes mode, for each of the
    first ``max_samples`` val samples: {"token", "imgs" (6, 3, fH, fW)
    normalised, "points" (5, N) from ``get_lidar_data``, "cams" (for each
    of the 6 cameras, a (3, M) array of the pixel u, v in its augmented
    image and the depth of the points it sees), "binimg" (1, X, Y)}. The
    projections (``ego_to_cam``, ``get_only_in_img_mask``, the tracked
    homography) run on ``device``."""
    dev = resolve_device(device)
    aug_conf = _aug_conf("nuscenes", H, W, final_dim)
    ds = NuScenesDataset(dataroot, False, aug_conf, GridConf(),
                         version=version)
    fH, fW = aug_conf.final_dim
    panels = []
    for tok in ds.samples[:max_samples]:
        cams, aug = ds.draw()  # validation: all 6 cameras, no randomness
        imgs, *geo = ds.get_image_data(tok, cams, aug)
        rots, trans, intrins, post_rots, post_trans = (
            torch.as_tensor(a, device=dev) for a in geo)
        pts = get_lidar_data(ds.t, dataroot, tok, nsweeps=nsweeps)
        xyz = torch.as_tensor(pts[:3], dtype=torch.float32, device=dev)
        seen = []
        for ci in range(len(cams)):
            cam = ego_to_cam(xyz, rots[ci], trans[ci], intrins[ci])
            mask = get_only_in_img_mask(cam, aug_conf.H, aug_conf.W)
            # into the augmented image's pixels by the tracked homography
            plot = post_rots[ci] @ cam + post_trans[ci][:, None]
            mask &= ((plot[0] > 0) & (plot[0] < fW)
                     & (plot[1] > 0) & (plot[1] < fH))
            seen.append(torch.stack([plot[0], plot[1], cam[2]])[:, mask]
                        .cpu().numpy())
        panels.append({"token": tok, "imgs": imgs, "points": pts,
                       "cams": seen, "binimg": ds.get_binimg(tok)})
    return panels


def _render_lidar_panels(panels, outdir: str) -> list:
    """The reference's lidar_check panels (``explore.py:80-116``): six
    cameras with the depth-coloured lidar, the lidar in BEV, the GT mask,
    one PNG a sample, ``outdir/lcheck{i:05d}.png``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from lss_carla_torch.ops.image import denormalize_img
    from lss_carla_torch.utils.viz import add_ego_box
    grid_conf = GridConf()
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for i, p in enumerate(panels):
        fig = plt.figure(figsize=(18, 6))
        gs = fig.add_gridspec(2, 5, width_ratios=(1, 1, 1, 1.2, 1.2))
        for ci, cam in enumerate(NUSC_CAMERA_ORDER):
            ax = fig.add_subplot(gs[ci // 3, ci % 3])
            ax.imshow(denormalize_img(p["imgs"][ci].transpose(1, 2, 0)))
            u, v, depth = p["cams"][ci]
            ax.scatter(u, v, c=depth, s=4, alpha=0.4, cmap="jet")
            ax.set_title(cam, fontsize=8)
            ax.axis("off")
        pts = p["points"]
        ax = fig.add_subplot(gs[:, 3])
        ax.scatter(pts[1], pts[0], c=pts[2], vmin=-5, vmax=5, s=4)
        add_ego_box(ax)
        ax.set_xlim(-50, 50)
        ax.set_ylim(-50, 50)
        ax.set_aspect("equal")
        ax.set_title("lidar (ego frame)", fontsize=9)
        ax = fig.add_subplot(gs[:, 4])
        ax.imshow(p["binimg"][0], origin="lower", cmap="Greys", vmin=0,
                  vmax=1, extent=(grid_conf.ybound[0], grid_conf.ybound[1],
                                  grid_conf.xbound[0], grid_conf.xbound[1]))
        add_ego_box(ax)
        ax.set_title("GT vehicles", fontsize=9)
        path = os.path.join(outdir, f"lcheck{i:05d}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        print(path)
        paths.append(path)
    return paths


def lidar_check(dataroot, outdir="./viz_outputs", H=None, W=None,
                final_dim=(128, 352), dataset: str = "simbev",
                version: str = "v1.0-mini", max_samples: int = 2,
                nsweeps: int = 3, device="cuda", **kw):
    """Geometry sanity figures (reference ``explore.py:21-116``), no model.
    SimBEV: each camera's frustum points in the BEV plane, with the ego
    box, to ``outdir/lidar_check.png``; returns the path. nuScenes: for
    each of the first ``max_samples`` val samples, ``lidar_panels``
    rendered to ``outdir/lcheck{i:05d}.png``; returns the paths."""
    if dataset == "nuscenes":
        panels = lidar_panels(dataroot, H, W, final_dim, version,
                              max_samples, nsweeps, device)
        return _render_lidar_panels(panels, outdir)
    geom = frustum_points(dataroot, H, W, final_dim, device)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from lss_carla_torch.utils.viz import EGO_L, EGO_OFF, EGO_W
    os.makedirs(outdir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 8))
    for n in range(geom.shape[0]):
        pts = geom[n].reshape(-1, 3)
        ax.scatter(pts[:, 0], pts[:, 1], s=0.3, label=f"cam{n}")
    # ego footprint (reference tools.py:273-284); plot-x is ego X here
    xs = np.array([-EGO_L / 2, EGO_L / 2, EGO_L / 2, -EGO_L / 2]) + EGO_OFF
    ys = np.array([-EGO_W / 2, -EGO_W / 2, EGO_W / 2, EGO_W / 2])
    ax.fill(xs, ys, "#76b900", zorder=5)
    ax.set_xlabel("ego X (m)")
    ax.set_ylabel("ego Y (m)")
    ax.legend(markerscale=10)
    ax.set_title("Frustum coverage in BEV")
    path = os.path.join(outdir, "lidar_check.png")
    fig.savefig(path)
    plt.close(fig)
    print(path)
    return path


COMMANDS = ("eval_model_iou", "viz_model_preds", "splat_check", "lidar_check")


def build_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags (``lss_carla_tpu/explore.py:387-470``), plus
    ``--device`` and ``--compute_dtype``."""
    p = argparse.ArgumentParser(description="LSS eval/viz tools (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        sp = sub.add_parser(name)
        sp.add_argument("--dataroot", default=None)
        sp.add_argument("--checkpoint", default=None)
        sp.add_argument("--best", action="store_true",
                        help="restore the best-by-val-IoU checkpoint")
        sp.add_argument("--ema", action="store_true",
                        help="evaluate the checkpoint's EMA weights (runs "
                             "trained with --ema_decay)")
        sp.add_argument("--bsz", type=int, default=2)
        sp.add_argument("--variant", default="b0",
                        choices=("b0", "b1", "b2", "b3", "b4",
                                 "resnet18", "resnet34"),
                        help="camera trunk the checkpoint was trained with")
        sp.add_argument("--H", type=int, default=None,
                        help="source image height (default 224 SimBEV, "
                             "900 nuScenes)")
        sp.add_argument("--W", type=int, default=None,
                        help="source image width (default 480 SimBEV, "
                             "1600 nuScenes)")
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        sp.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="the dtype the checkpoint was trained in")
        if name in ("viz_model_preds", "eval_model_iou", "lidar_check"):
            sp.add_argument("--dataset", default="simbev",
                            choices=("simbev", "nuscenes"))
            sp.add_argument("--version", default="v1.0-mini")
        if name == "eval_model_iou":
            sp.add_argument("--quantize", action="store_true",
                            help="int8 convs where min(cin, cout) >= 64 "
                                 "(ops/quant.py)")
        if name in ("eval_model_iou", "viz_model_preds"):
            sp.add_argument("--xbound", type=float, nargs=3, default=None,
                            help="BEV grid x bounds/step the checkpoint "
                                 "was trained with (default -50 50 0.5)")
            sp.add_argument("--ybound", type=float, nargs=3, default=None)
            sp.add_argument("--label_mode", default="vehicle_binary",
                            choices=("vehicle_binary", "multiclass"))
            sp.add_argument("--label_classes", type=int, nargs="+",
                            default=[0, 1, 2, 3])
        if name == "viz_model_preds":
            sp.add_argument("--map_folder", default=None,
                            help="nuScenes map-expansion folder for the "
                                 "static-map underlay")
    return p


def main(argv=None):
    """``python -m lss_carla_torch.explore <cmd> [flags]``; returns the
    tool's result."""
    parser = build_parser()
    a = parser.parse_args(argv)
    if a.cmd == "eval_model_iou" and a.checkpoint is None:
        parser.error("eval_model_iou takes --checkpoint")
    kwargs = {"device": a.device}
    for key in ("H", "W", "dataroot"):
        if getattr(a, key) is not None:
            kwargs[key] = getattr(a, key)
    if a.cmd == "lidar_check":  # builds no model
        return lidar_check(dataset=a.dataset, version=a.version, **kwargs)
    kwargs.update(variant=a.variant, compute_dtype=a.compute_dtype)
    if a.checkpoint is not None:
        kwargs["checkpoint"] = a.checkpoint
    if a.cmd == "splat_check":  # as the JAX CLI: no --best or --ema here
        return splat_check(bsz=a.bsz, **kwargs)
    if a.checkpoint is not None:
        kwargs.update(best=a.best, use_ema=a.ema)
    if a.xbound is not None:
        kwargs["grid_conf"] = GridConf(
            xbound=tuple(a.xbound),
            ybound=tuple(a.ybound if a.ybound is not None else a.xbound))
    kwargs.update(label_mode=a.label_mode, label_classes=tuple(a.label_classes),
                  dataset=a.dataset, version=a.version)
    if a.cmd == "eval_model_iou":
        return eval_model_iou(bsz=a.bsz, quantize=a.quantize, **kwargs)
    return viz_model_preds(bsz=a.bsz, map_folder=a.map_folder, **kwargs)


if __name__ == "__main__":
    main()
