"""Original-LSS nuScenes training on one GPU: the port's counterpart of
``scripts/train_nuscenes.py``, with its flags plus ``--device``.

The original config (reference ``src/train.py:23-43``, ``configs.py::
nuscenes_aug``): 900 x 1600 sources, resize 0.193-0.225, bottom crop
0-0.22, rotation +-5.4 degrees, flips, 5 of the 6 cameras in training (all
6 in validation), on nuScenes v1.0 tables through the devkit-free loader
(``data/nuscenes.py``), or on SimBEV-format data with ``--simbev_data``.

    python -m lss_carla_torch.train_nuscenes --dataroot /data/nuscenes
    python -m lss_carla_torch.train_nuscenes --dataroot /data/SimBEV --simbev_data

``--n_devices`` and ``--cam_devices`` parse and raise naming their
``ROADMAP.md`` item, as ``train()`` does.
"""

from __future__ import annotations

import argparse
import sys

from lss_carla_torch.configs import nuscenes_aug
from lss_carla_torch.training.loop import train

MODULE = "lss_carla_torch.train_nuscenes"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train LSS with the original nuScenes config "
                    "(PyTorch/CUDA)")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--nepochs", type=int, default=10000)
    p.add_argument("--bsz", type=int, default=16)
    p.add_argument("--nworkers", type=int, default=10)
    p.add_argument("--logdir", default="./runs/nuscenes_style")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-7)
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--cam_devices", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--version", default="v1.0-mini",
                   help="nuScenes table version directory")
    p.add_argument("--simbev_data", action="store_true",
                   help="run the nuScenes config against SimBEV-format data")
    p.add_argument("--host_normalize", action="store_true",
                   help="normalise images on the host instead of shipping "
                        "uint8 and normalising on the device")
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine", "linear"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--decay_steps", type=int, default=0)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--ema_bn_recal", type=int, default=16)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--val_step", type=int, default=500)
    p.add_argument("--save_step", type=int, default=1000)
    p.add_argument("--watchdog_secs", type=int, default=0,
                   help="stall detector: dump the stacks after N s without "
                        "step progress, exit 42 at 2N; 0 disables")
    p.add_argument("--resume", default=None,
                   help="checkpoint file or directory to resume from")
    p.add_argument("--supervise", type=int, default=0,
                   help="restart up to N times after a watchdog exit 42, "
                        "resuming from <logdir>/ckpts (pair with "
                        "--watchdog_secs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def train_kwargs(args) -> dict:
    """``train()``'s keywords from the parsed flags."""
    aug = nuscenes_aug()
    return dict(
        dataroot=args.dataroot, nepochs=args.nepochs, H=aug.H, W=aug.W,
        resize_lim=aug.resize_lim, final_dim=aug.final_dim,
        bot_pct_lim=aug.bot_pct_lim, rot_lim=aug.rot_lim,
        rand_flip=aug.rand_flip, ncams=aug.Ncams, bsz=args.bsz,
        nworkers=args.nworkers, lr=args.lr, weight_decay=args.weight_decay,
        logdir=args.logdir, n_devices=args.n_devices,
        cam_devices=args.cam_devices, max_steps=args.max_steps,
        dataset="simbev" if args.simbev_data else "nuscenes",
        nuscenes_version=args.version,
        device_normalize=not args.host_normalize,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, ema_decay=args.ema_decay,
        ema_bn_recal=args.ema_bn_recal, compute_dtype=args.compute_dtype,
        seed=args.seed, val_step=args.val_step, save_step=args.save_step,
        watchdog_secs=args.watchdog_secs, resume=args.resume,
        device=args.device)


def main(argv=None):
    """Parse the flags and train; with ``--supervise R``, supervise a child
    trainer instead and return its exit code."""
    args = build_parser().parse_args(argv)
    if args.supervise > 0:
        from lss_carla_torch.utils.supervise import run_supervised
        return run_supervised(args.supervise, args.logdir,
                              argv=sys.argv[1:] if argv is None else argv,
                              command=[sys.executable, "-m", MODULE])
    train(**train_kwargs(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
