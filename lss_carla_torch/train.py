"""Training CLI of the port: ``train_simbev.py``'s flags that the port
has, with the same names and defaults, plus ``--device``.

    python -m lss_carla_torch.train --dataroot /data/SimBEV --bsz 4 \\
        --nworkers 8 [--variant resnet18] [--fused_dw] [--max_steps N]

Unattended, with the stall watchdog and restarts (``--supervise R`` makes
this process a supervisor that runs the trainer as a child and runs it
again, resuming from ``<logdir>/ckpts``, after each of up to R watchdog
exits; ``utils/supervise.py``):

    python -m lss_carla_torch.train --dataroot /data/SimBEV \\
        --watchdog_secs 300 --supervise 3 --async_save

The stretch recipe (``configs/simbev_stretch.sh`` on one card: B4, a
400 x 400 grid at 0.25 m, 4-class labels, bf16, cosine with warm-up, EMA
with BN recalibration, two microbatches a step):

    python -m lss_carla_torch.train --dataroot /data/SimBEV --nepochs 30 \\
        --bsz 4 --nworkers 16 --xbound -50 50 0.25 --ybound -50 50 0.25 \\
        --label_mode multiclass --variant b4 --compute_dtype bfloat16 \\
        --fused_dw --lr_schedule cosine --warmup_steps 500 \\
        --ema_decay 0.999 --accum_steps 2 --val_step 2000 --save_step 2000

Data parallel over the GPUs of one host (the ranks are this process's
children, one a GPU; ``--bsz`` is the global batch), camera parallel on top
(``--cam_devices``: the cameras of a data row split over that many ranks),
or one rank of a multi-host run under ``torchrun`` (``--multihost``):

    python -m lss_carla_torch.train --dataroot /data/SimBEV --n_devices 8 --bsz 32
    python -m lss_carla_torch.train --dataroot /data/SimBEV --n_devices 4 \
        --cam_devices 2 --bsz 4
    torchrun --nnodes 2 --nproc_per_node 8 --rdzv_backend c10d \
        --rdzv_endpoint host0:29400 -m lss_carla_torch.train \
        --dataroot /data/SimBEV --multihost --bsz 64
    python -m lss_carla_torch.train --dataroot /data/SimBEV --n_devices 4 \
        --grid_devices 2 --bsz 8 --xbound -50 50 0.25 --ybound -50 50 0.25

From a pretrained trunk (an ``efficientnet_pytorch`` ImageNet file, a
reference or port checkpoint, or ``auto``: the torch hub cache); a
``--resume`` overrides it:

    python -m lss_carla_torch.train --dataroot /data/SimBEV \
        --pretrained_trunk ~/.cache/torch/hub/checkpoints/efficientnet-b0-355c32eb.pth
"""

from __future__ import annotations

import argparse
import sys

from lss_carla_torch.training.loop import check_pretrained_trunk, train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train LSS on SimBEV (PyTorch/CUDA)")
    p.add_argument("--dataroot", type=str, required=True,
                   help="Path to SimBEV dataset root directory")
    p.add_argument("--nepochs", type=int, default=100)
    p.add_argument("--gpuid", type=int, default=0,
                   help="CUDA device index (with --device cuda)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--bsz", type=int, default=4)
    p.add_argument("--nworkers", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-7)
    p.add_argument("--H", type=int, default=224)
    p.add_argument("--W", type=int, default=480)
    p.add_argument("--final_h", type=int, default=128)
    p.add_argument("--final_w", type=int, default=352)
    p.add_argument("--ncams", type=int, default=6)
    for name, default in (("xbound", (-50.0, 50.0, 0.5)),
                          ("ybound", (-50.0, 50.0, 0.5)),
                          ("zbound", (-10.0, 10.0, 20.0)),
                          ("dbound", (4.0, 45.0, 1.0))):
        p.add_argument(f"--{name}", type=float, nargs=3, default=default,
                       metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--logdir", type=str, default="./runs/simbev")
    p.add_argument("--val_step", type=int, default=500)
    p.add_argument("--save_step", type=int, default=1000)
    p.add_argument("--viz_step", type=int, default=100,
                   help="a train figure every N steps and a val figure "
                        "after each validation (0 = none)")
    p.add_argument("--resize_lim", type=float, nargs=2, default=(1.0, 1.0))
    p.add_argument("--bot_pct_lim", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--rot_lim", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--rand_flip", action="store_true", default=False)
    p.add_argument("--resume", type=str, default=None,
                   help="a checkpoint file, or a directory (its newest)")
    p.add_argument("--pretrained_trunk", type=str, default=None,
                   help="ImageNet-pretrained EfficientNet trunk: path to an "
                        "efficientnet_pytorch .pth, a reference LSS .pt, a "
                        "checkpoint of this port (model_*.pt or a ckpts/ "
                        "directory), or \"auto\" to search the torch hub "
                        "cache (the reference downloads these at "
                        "src/models.py:43); --resume overrides it")
    p.add_argument("--use_wandb", action="store_true", default=False)
    p.add_argument("--wandb_project", type=str, default="lift-splat-shoot")
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("--wandb_entity", type=str, default=None)
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine", "linear"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--decay_steps", type=int, default=0,
                   help="schedule horizon in steps (0 = auto)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0 (e.g. 0.999): validate, track the best IoU "
                        "and checkpoint an EMA of the model")
    p.add_argument("--ema_bn_recal", type=int, default=16,
                   help="training batches the EMA's BN stats are "
                        "recalibrated over before each validation (0 = off)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="loader batches per optimizer step (gradient "
                        "accumulation)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--splat_method", type=str, default="scatter",
                   choices=["scatter", "sorted", "pallas"],
                   help="kept for parity; every method runs the same splat")
    p.add_argument("--pos_weight", type=float, nargs="+", default=[2.13])
    p.add_argument("--label_mode", type=str, default="vehicle_binary",
                   choices=["vehicle_binary", "multiclass"])
    p.add_argument("--label_classes", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--extrinsic_noise", type=float, nargs=2, default=None,
                   metavar=("ROT_DEG_STD", "TRANS_M_STD"))
    p.add_argument("--host_normalize", action="store_true",
                   help="normalise images on the host instead of the device")
    p.add_argument("--variant", type=str, default="b0",
                   choices=["b0", "b1", "b2", "b3", "b4", "resnet18",
                            "resnet34"])
    p.add_argument("--fused_dw", action="store_true",
                   help="run each MBConv depthwise conv and its BN batch "
                        "moments in one pass (the CUDA kernel "
                        "csrc/dw_conv_stats.cu on the card)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--debug_stall_at", type=int, default=0,
                   help="testing only: hang at this step (after the first "
                        "--save_step, so a restart can --resume) to drill "
                        "the watchdog and --supervise")
    p.add_argument("--watchdog_secs", type=int, default=0,
                   help="stall detector: dump the stacks after N s without "
                        "step progress, exit 42 at 2N; 0 disables")
    p.add_argument("--async_save", action="store_true",
                   help="write periodic checkpoints in a background thread; "
                        "best, final and preemption saves stay synchronous")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run there")
    p.add_argument("--iou_log_step", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n_devices", type=int, default=None,
                   help="ranks, one process a GPU (default 1; with "
                        "--multihost the launcher's world size)")
    p.add_argument("--cam_devices", type=int, default=1,
                   help="camera-parallel ranks a data row: the cameras "
                        "split over them; n_devices / cam_devices data ranks")
    p.add_argument("--grid_devices", type=int, default=1,
                   help="BEV-grid parallel ranks a data row: the grid's X "
                        "axis splits over them; n_devices / grid_devices "
                        "data ranks (parallel/grid.py)")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a multi-host run: join the process "
                        "group of the launcher's environment (torchrun); "
                        "--bsz is the global batch")
    p.add_argument("--supervise", type=int, default=0,
                   help="restart the run up to N times after a watchdog "
                        "exit (code 42), resuming from <logdir>/ckpts once "
                        "it holds a checkpoint (pair with --watchdog_secs)")
    return p


def train_kwargs(args) -> dict:
    """``train()``'s keywords from the parsed flags."""
    device = f"cuda:{args.gpuid}" if args.device == "cuda" else "cpu"
    return dict(
        dataroot=args.dataroot, nepochs=args.nepochs, H=args.H, W=args.W,
        final_dim=(args.final_h, args.final_w), ncams=args.ncams,
        bsz=args.bsz, nworkers=args.nworkers, lr=args.lr,
        weight_decay=args.weight_decay, logdir=args.logdir,
        val_step=args.val_step, save_step=args.save_step,
        resize_lim=tuple(args.resize_lim), bot_pct_lim=tuple(args.bot_pct_lim),
        rot_lim=tuple(args.rot_lim), rand_flip=args.rand_flip,
        xbound=tuple(args.xbound), ybound=tuple(args.ybound),
        zbound=tuple(args.zbound), dbound=tuple(args.dbound),
        resume=args.resume, pretrained_trunk=args.pretrained_trunk,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
        ema_decay=args.ema_decay, ema_bn_recal=args.ema_bn_recal,
        accum_steps=args.accum_steps, compute_dtype=args.compute_dtype,
        splat_method=args.splat_method, pos_weight=tuple(args.pos_weight),
        label_mode=args.label_mode, label_classes=tuple(args.label_classes),
        extrinsic_noise=(tuple(args.extrinsic_noise)
                         if args.extrinsic_noise else None),
        device_normalize=not args.host_normalize, variant=args.variant,
        fused_dw=args.fused_dw, max_steps=args.max_steps,
        iou_log_step=args.iou_log_step, seed=args.seed, viz_step=args.viz_step,
        use_wandb=args.use_wandb, wandb_project=args.wandb_project,
        wandb_name=args.wandb_name, wandb_entity=args.wandb_entity,
        profile_dir=args.profile_dir, watchdog_secs=args.watchdog_secs,
        debug_stall_at=args.debug_stall_at, async_save=args.async_save,
        n_devices=args.n_devices, cam_devices=args.cam_devices,
        grid_devices=args.grid_devices, multihost=args.multihost,
        device=device)


def main(argv=None):
    """Parse the flags and train; with ``--supervise R``, supervise a child
    trainer instead and return its exit code."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_pretrained_trunk(args.pretrained_trunk, args.variant)
    if args.supervise > 0:
        from lss_carla_torch.utils.supervise import run_supervised
        return run_supervised(args.supervise, args.logdir,
                              argv=sys.argv[1:] if argv is None else argv)
    train(**train_kwargs(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
