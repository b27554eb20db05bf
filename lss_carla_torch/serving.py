"""Serving: export a model to one artifact file and load it back as a callable.

Counterpart of ``lss_carla_tpu/serving.py``. The artifact is a single
``torch.save`` file holding the model config, its state dict and the input
signature (bsz, ncams, image dtype). ``load_predict`` rebuilds the model in
eval mode on ``device`` and returns ``callable(*6 inputs) -> logits``.
Loading still needs this package's model code (unlike ``jax.export``).

    from lss_carla_torch.serving import export_predict, load_predict
    export_predict(model, "/models/lss.pt", bsz=1)
    predict = load_predict("/models/lss.pt")       # device="cuda"
    logits = predict(imgs, rots, trans, intrins, post_rots, post_trans)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.utils.backend import resolve_device

FORMAT = "lss_carla_torch.predict/1"
INPUT_NAMES = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")


def input_shapes(signature: dict):
    """[(name, shape, numpy dtype name)] of the six forward inputs."""
    b, n = signature["bsz"], signature["ncams"]
    fH, fW = signature["final_dim"]
    return [("imgs", (b, n, 3, fH, fW), signature["img_dtype"]),
            ("rots", (b, n, 3, 3), "float32"),
            ("trans", (b, n, 3), "float32"),
            ("intrins", (b, n, 3, 3), "float32"),
            ("post_rots", (b, n, 3, 3), "float32"),
            ("post_trans", (b, n, 3), "float32")]


def example_args(signature: dict):
    """Numpy inputs of the artifact's signature (zero images, identity
    matrices) for warming a server up."""
    args = []
    for name, shape, dtype in input_shapes(signature):
        a = np.zeros(shape, dtype)
        if shape[-2:] == (3, 3):
            a[...] = np.eye(3, dtype=np.float32)
        args.append(a)
    return tuple(args)


def export_predict(model, path: str, bsz: int = 1, uint8_images: bool = False,
                   ncams: Optional[int] = None) -> None:
    """Write ``model`` (config + weights) and its input signature to ``path``.

    uint8_images: a uint8 image signature, normalised on the device.
    ncams: serving camera count; by default the full rig, max(Ncams, 6)
    (Ncams is the train-time camera-dropout count)."""
    if ncams is None:
        ncams = max(model.data_aug_conf.Ncams, 6)
    signature = {"bsz": int(bsz), "ncams": int(ncams),
                 "final_dim": list(model.data_aug_conf.final_dim),
                 "img_dtype": "uint8" if uint8_images else "float32"}
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"format": FORMAT, "config": model.config(),
                "state_dict": state, "signature": signature}, path)


class Predictor:
    """A loaded artifact: checks inputs against the signature, runs the
    model on its device, returns logits (B, outC, X, Y) as a tensor there."""

    def __init__(self, model, signature: dict, device: torch.device):
        self.model, self.signature, self.device = model, signature, device
        self._expected = input_shapes(signature)

    def __call__(self, *args):
        if len(args) != len(self._expected):
            raise ValueError(f"expected {len(self._expected)} inputs, "
                             f"got {len(args)}")
        tensors = []
        for a, (name, shape, dtype) in zip(args, self._expected):
            t = torch.as_tensor(a)
            if tuple(t.shape) != shape or t.dtype != getattr(torch, dtype):
                raise ValueError(
                    f"{name}: got {tuple(t.shape)} {t.dtype}, the artifact "
                    f"takes {shape} {dtype}")
            tensors.append(t.to(self.device, non_blocking=True))
        with torch.inference_mode():
            return self.model(*tensors)


def _read(path: str) -> dict:
    blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} artifact")
    return blob


def read_signature(path: str) -> dict:
    """The input signature an artifact was exported with."""
    return _read(path)["signature"]


def load_predict(path: str, device="cuda") -> Predictor:
    """Load an artifact onto ``device`` (cuda unless "cpu" is asked for)."""
    dev = resolve_device(device)
    blob = _read(path)
    model = compile_model(device="cpu", **blob["config"])
    model.load_state_dict(blob["state_dict"])
    return Predictor(model.eval().to(dev), blob["signature"], dev)


def _main(argv=None):
    """CLI: reference-format checkpoint -> serving artifact
    (``python -m lss_carla_torch.server`` serves it).

        python -m lss_carla_torch.serving --checkpoint runs/x/ckpts --best \\
            --out /models/lss.pt [--ema] [--compute_dtype bfloat16] \\
            [--uint8] [--bsz 8] [--variant b4]

    ``--checkpoint`` is a ``.pt`` file or a run's checkpoint directory (its
    newest checkpoint, or ``model_best.pt`` with ``--best``). ``--ema``
    exports the checkpoint's ``ema_state_dict`` where it has one, else the
    raw weights. ``--compute_dtype bfloat16`` serves in bf16.
    """
    import argparse
    import os

    p = argparse.ArgumentParser(
        description="Export a reference-format checkpoint as a serving artifact")
    p.add_argument("--checkpoint", required=True,
                   help="reference .pt ({'model_state_dict': ...} or a raw "
                        "state dict), or a checkpoint directory")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--best", action="store_true",
                   help="with a directory: export its model_best.pt")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA weights (runs trained with "
                        "--ema_decay); the raw weights for checkpoints "
                        "without them")
    p.add_argument("--compute_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--uint8", action="store_true",
                   help="uint8 image inputs (normalised on the device)")
    p.add_argument("--bsz", type=int, default=1)
    p.add_argument("--ncams", type=int, default=None,
                   help="serving camera count (default: full rig)")
    p.add_argument("--variant", default="b0",
                   choices=("b0", "b1", "b2", "b3", "b4"))
    p.add_argument("--outC", type=int, default=1)
    p.add_argument("--H", type=int, default=224)
    p.add_argument("--W", type=int, default=480)
    p.add_argument("--final_dim", type=int, nargs=2, default=(128, 352))
    p.add_argument("--xbound", type=float, nargs=3,
                   default=(-50.0, 50.0, 0.5), metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--ybound", type=float, nargs=3,
                   default=(-50.0, 50.0, 0.5), metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--zbound", type=float, nargs=3,
                   default=(-10.0, 10.0, 20.0), metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--dbound", type=float, nargs=3,
                   default=(4.0, 45.0, 1.0), metavar=("MIN", "MAX", "STEP"))
    args = p.parse_args(argv)

    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.utils.checkpoint import BEST, load_checkpoint
    from lss_carla_torch.utils.convert import reference_state_dict

    grid = GridConf(xbound=tuple(args.xbound), ybound=tuple(args.ybound),
                    zbound=tuple(args.zbound), dbound=tuple(args.dbound))
    aug = DataAugConf(H=args.H, W=args.W, final_dim=tuple(args.final_dim))
    model = compile_model(grid, aug, outC=args.outC, variant=args.variant,
                          compute_dtype=args.compute_dtype, device="cpu")
    path = args.checkpoint
    if args.best:
        if not os.path.isdir(path):
            raise SystemExit("--best takes a checkpoint directory")
        path = os.path.join(path, BEST)
    ckpt = load_checkpoint(path)
    weights = "raw"
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        if args.ema and "ema_state_dict" in ckpt:
            weights, ckpt = "ema", ckpt["ema_state_dict"]
        else:
            if args.ema:
                print("checkpoint has no EMA weights; exporting the raw ones")
            ckpt = ckpt["model_state_dict"]
    model.load_state_dict(reference_state_dict(ckpt))
    export_predict(model, args.out, bsz=args.bsz, uint8_images=args.uint8,
                   ncams=args.ncams)
    print(f"exported {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"bsz {args.bsz}, {args.compute_dtype}, {weights} weights"
          f"{', uint8-in' if args.uint8 else ''})")


if __name__ == "__main__":
    _main()
