"""Evaluation, figure and check tools: counterpart of ``lss_carla_tpu/explore.py``
(reference ``src/explore.py``), on the SimBEV loader.

* ``eval_model_iou``: restore a checkpoint, run the whole val loader and
  print and return ``get_val_info``'s dict (mean loss, dataset IoU and,
  for multiclass heads, ``iou_per_class``).
* ``viz_model_preds``: the camera / GT / prediction / overlay figure of
  every non-padded val sample of the first ``max_batches`` batches, one PNG
  each; ``model_preds`` is its compute part (the predictions, no
  matplotlib).
* ``splat_check``: one batch through the model's splat (the CUDA kernel on
  a CUDA tensor) and through its plain version (``splat_reference``, with
  the gather backward), from the same lift and voxel ids; both sides go
  through the same ``decode_bev`` and weighted BCE, in eval mode, and the
  outputs, losses and ``depthnet.weight`` gradients are compared (the
  reference's ``cumsum_check``).
* ``lidar_check``: frustum geometry in the BEV plane (SimBEV mode, no
  model); ``frustum_points`` is its compute part.

Checkpoints are the port's files (``utils/checkpoint.py``): a file, or a
run's ``ckpts`` directory (its newest checkpoint, or ``model_best.pt`` with
``best``); ``use_ema`` evaluates a checkpoint's ``ema_state_dict``. Every
tool takes ``device``: "cuda" unless the caller asks for the CPU; no GPU
raises. ``eval_model_iou(quantize=True)`` runs the eligible convs in int8
(``ops/quant.py``). The nuScenes modes (``dataset="nuscenes"``,
``map_folder``) raise ``NotImplementedError`` naming their ``ROADMAP.md``
item.

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
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops.geometry import create_frustum, get_geometry
from lss_carla_torch.ops.quant import quantize_model
from lss_carla_torch.ops.splat import (_gather_cotangent, splat,
                                       splat_reference, voxel_indices)
from lss_carla_torch.training.loop import get_val_info
from lss_carla_torch.training.loss import bce_with_logits
from lss_carla_torch.training.step import (make_eval_step, make_predict_step,
                                           to_device)
from lss_carla_torch.utils.backend import resolve_device
from lss_carla_torch.utils.checkpoint import BEST, load_checkpoint
from lss_carla_torch.utils.convert import reference_state_dict

NUSCENES = "ROADMAP.md §A, nuScenes"


def _simbev_only(dataset: str, map_folder=None) -> None:
    if dataset != "simbev":
        raise NotImplementedError(f"dataset={dataset!r} is not ported to "
                                  f"lss_carla_torch yet ({NUSCENES})")
    if map_folder is not None:
        raise NotImplementedError("the nuScenes map underlay (map_folder) is "
                                  f"not ported to lss_carla_torch yet "
                                  f"({NUSCENES})")


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
           dataset: str = "simbev", use_ema: bool = False,
           label_mode: str = "vehicle_binary", label_classes=(0, 1, 2, 3),
           device="cuda", **model_kw):
    """(model in eval mode on the device, trainloader, valloader,
    grid_conf, aug_conf). ``model_kw`` (``variant``, ``compute_dtype``,
    ...) go to ``compile_model``; the loaders ship uint8 images normalised
    on the device, as the trainer's do."""
    _simbev_only(dataset)
    dev = resolve_device(device)
    grid_conf = grid_conf or GridConf()
    aug_conf = DataAugConf(H=H or 224, W=W or 480, final_dim=tuple(final_dim),
                           Ncams=ncams)
    trainloader, valloader = compile_data(
        "unused", dataroot, aug_conf, grid_conf, bsz=bsz, nworkers=nworkers,
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


def model_preds(dataroot, checkpoint: Optional[str] = None, max_batches=2,
                bsz=4, device="cuda", **kw):
    """The compute part of ``viz_model_preds``: (samples, extent), samples
    a list of (camera images (N, 3, H, W), GT (X, Y), sigmoid prediction
    (X, Y)) of class 0, numpy, for each non-padded sample of the first
    ``max_batches`` val batches; extent the BEV grid's (ymin, ymax, xmin,
    xmax)."""
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
    return samples, extent


def viz_model_preds(dataroot, checkpoint: Optional[str] = None,
                    outdir="./viz_outputs", max_batches=2, bsz=4,
                    dataset: str = "simbev",
                    map_folder: Optional[str] = None, device="cuda", **kw):
    """Render ``model_preds``'s samples to ``outdir/eval{i:06d}.png``
    (reference ``explore.py:249-363``). Returns the number of PNGs."""
    _simbev_only(dataset, map_folder)
    samples, extent = model_preds(dataroot, checkpoint, max_batches, bsz,
                                  device, **kw)
    import matplotlib.pyplot as plt
    from lss_carla_torch.utils.viz import make_bev_figure
    os.makedirs(outdir, exist_ok=True)
    for count, (imgs, gt, pred) in enumerate(samples):
        fig = make_bev_figure(imgs, gt, pred, extent=extent)
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
        return _gather_cotangent(g, ids, ctx.num_slots), None, None


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
                compute_dtype: str = "float32", **kw) -> dict:
    """Forward and backward of one batch through the kernel and the plain
    splat (the reference ``cumsum_check`` contract, ``explore.py:166-191``).

    With a ``dataroot``: the first train batch of that data, through the
    model ``_build`` makes (``kw`` as there); without: the JAX tool's tiny
    synthetic config (``kw`` unused). Returns {"kernel": side, "plain":
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
                                        variant=variant,
                                        compute_dtype=compute_dtype, **kw)
        batch = next(iter(trainloader))
    else:
        model, batch = _synthetic_batch(bsz, dev, variant=variant,
                                        compute_dtype=compute_dtype)
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
    """The compute part of ``lidar_check``: the ego-frame (x, y, z) of
    every frustum cell of the first val sample's cameras, (N, D, fH, fW, 3)
    numpy, computed on ``device``."""
    dev = resolve_device(device)
    grid_conf = GridConf()
    aug_conf = DataAugConf(H=H or 224, W=W or 480, final_dim=tuple(final_dim))
    _, valloader = compile_data("unused", dataroot, aug_conf, grid_conf,
                                bsz=1, nworkers=0)
    batch = to_device(next(iter(valloader))[1:6], dev)
    frustum = torch.from_numpy(create_frustum(aug_conf.final_dim, 16,
                                              grid_conf.dbound)).to(dev)
    return get_geometry(frustum, *batch)[0].cpu().numpy()


def lidar_check(dataroot, outdir="./viz_outputs", H=None, W=None,
                final_dim=(128, 352), dataset: str = "simbev",
                device="cuda", **kw) -> str:
    """Geometry sanity figure (reference ``explore.py:21-116``), SimBEV
    mode: each camera's frustum points in the BEV plane, with the ego box,
    to ``outdir/lidar_check.png``. Returns the path."""
    _simbev_only(dataset)
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
                        help="source image height (default 224, SimBEV)")
        sp.add_argument("--W", type=int, default=None,
                        help="source image width (default 480, SimBEV)")
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
                            help="nuScenes map-expansion folder (not ported "
                                 "yet: ROADMAP §A, nuScenes)")
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
        return lidar_check(dataset=a.dataset, **kwargs)
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
                  dataset=a.dataset)
    if a.cmd == "eval_model_iou":
        return eval_model_iou(bsz=a.bsz, quantize=a.quantize, **kwargs)
    return viz_model_preds(bsz=a.bsz, map_folder=a.map_folder, **kwargs)


if __name__ == "__main__":
    main()
