"""The training loop: counterpart of ``lss_carla_tpu/training/loop.py``
(reference ``train_simbev.py:23-460``).

SimBEV or nuScenes loader (``dataset``; -> ``stack_microbatches`` with
``accum_steps`` > 1) -> ``prefetch_to_device`` (pinned host batches,
copies on the consumer thread) -> eager train step (forward, weighted
BCE, backward, optax-rule clip, Adam, EMA) -> validation over the whole
val set -> torch checkpoints in the reference's format, with best-IoU
tracking and resume. SIGTERM or SIGINT saves a resumable checkpoint and
stops. Metric syncs are batched: the loss is read every 10 steps and the
IoU and step time every ``iou_log_step`` steps. ``compute_dtype`` "bfloat16" runs the model in
bf16 (``models/lss.py``).

With ``ema_decay > 0`` validation, best-IoU tracking and ``model_best.pt``'s
``ema_state_dict`` use the averaged model, whose BN stats are first
recalibrated over the last ``ema_bn_recal`` training batches (microbatch
0 of each, ``training/bn_recal.py``); the raw model's validation is logged
beside it as ``val/loss_raw`` and ``val/iou_raw``.

Observability and unattended runs, as in the JAX trainer: figures of
sample 0 every ``viz_step`` steps and after each validation
(``utils/viz.py`` through ``MetricLogger.figure``; only the rendering and
logging are guarded, the prediction is not), wandb, a ``torch.profiler``
trace of the run (``profile_dir``), the stall watchdog (``watchdog_secs``,
``training/watchdog.py``) and background periodic checkpoints
(``async_save``).

Parallel modes (``n_devices`` > 1; ``parallel/``): one process a device.
On one host ``train`` starts its ranks itself (``torch.multiprocessing``,
spawn; rank r on ``cuda:r``, or gloo ranks on the CPU with
``device="cpu"``) and returns rank 0's result; with ``multihost`` it
spawns nothing and joins the launcher's group (``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``), the counterpart of
``jax.distributed.initialize()``. ``bsz`` is the global batch: each data
rank loads its shard (``bsz / n_data`` rows); with ``cam_devices`` > 1 the
cam ranks of a data row load the same rows and each lifts its own
cameras; with ``grid_devices`` > 1 (the BEV-grid mode, ``parallel/
grid.py``) every rank loads and lifts its own ``bsz / n_devices`` rows and
decodes its X slab of its data row's BEV, and the EMA's BN recalibration
runs through the grid forward. Rank 0 logs (the others a ``NullLogger``), profiles and writes
the checkpoints, with a barrier after each save; every rank loads the
same file on resume. A signal on any rank stops every rank at the same
step: each step ends with a MAX all-reduce of the ranks' signal flags on
a host group. Each rank has its own watchdog.

``pretrained_trunk`` starts the camera trunk from an ``efficientnet_pytorch``
ImageNet file, a reference LSS checkpoint or one of the port's
(``utils/convert.py::trunk_state_dict_from_checkpoint``), merged in place
after the weights are made and before ``resume``, which overrides it; the
EMA is re-seeded from the merged weights. Every rank loads the file itself.

Every keyword of the JAX trainer is here, and none is ignored.
"""

from __future__ import annotations

import collections
import os
import shutil
import signal
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.decode import USE_NATIVE
from lss_carla_torch.data.simbev import CAMERA_ORDER
from lss_carla_torch.data.loader import (compile_data, prefetch_to_device,
                                         stack_microbatches)
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import mbconv_cuda, splat_cuda
from lss_carla_torch.parallel import camera as pcamera
from lss_carla_torch.parallel import grid as pgrid
from lss_carla_torch.parallel import mesh as pmesh
from lss_carla_torch.parallel import step as pstep
from lss_carla_torch.training.bn_recal import recalibrate_bn
from lss_carla_torch.training.state import (create_train_state,
                                            restore_train_state)
from lss_carla_torch.training.step import (make_eval_step, make_predict_step,
                                           make_train_step, to_device)
from lss_carla_torch.training.watchdog import WATCHDOG_EXIT, StallWatchdog
from lss_carla_torch.utils.backend import resolve_device
from lss_carla_torch.utils.checkpoint import (CheckpointManager, load_checkpoint,
                                              read_best_val_iou)
from lss_carla_torch.utils.convert import (merge_trunk_state_dict,
                                           trunk_state_dict_from_checkpoint)
from lss_carla_torch.utils.logging import MetricLogger, NullLogger


def check_pretrained_trunk(pretrained_trunk, variant: str) -> None:
    """The JAX trainer's first check: a trunk checkpoint is an
    efficientnet_pytorch one, which no ResNet can take."""
    if pretrained_trunk is not None and variant.startswith("resnet"):
        raise ValueError("--pretrained_trunk imports efficientnet_pytorch "
                         "weights; no import source exists for the "
                         "resnet trunk variants")


def parallel_plan(n_devices, multihost: bool, cam_devices: int,
                  accum_steps: int, fused_dw: bool, ncams: int, bsz: int,
                  dev: torch.device, grid_devices: int = 1, nx0: int = 0):
    """The JAX trainer's checks of the parallel keywords, in meaning
    (``lss_carla_tpu/training/loop.py:213-262``): returns (ranks, data
    ranks, cam ranks, grid ranks). ``n_devices`` None means 1, or the
    launcher's world size with ``multihost``; it is clamped to the devices
    there are (GPUs on CUDA, CPU cores on the CPU, the world size under a
    launcher). ``nx0`` is the BEV grid's X size."""
    cam_devices = max(1, int(cam_devices))
    grid_devices = max(1, int(grid_devices))
    if multihost:
        count = (dist.get_world_size() if dist.is_initialized()
                 else pmesh.launcher_env()["world_size"])
    elif dist.is_initialized():
        count = dist.get_world_size()
    elif dev.type == "cuda":
        count = torch.cuda.device_count()
    else:
        count = os.cpu_count() or 1
    n = count if (n_devices is None and multihost) else (n_devices or 1)
    n = min(int(n), count)
    if cam_devices > 1 and grid_devices > 1:
        raise ValueError("cam_devices and grid_devices are alternative "
                         "model-parallel axes: use at most one")
    if accum_steps > 1 and (cam_devices > 1 or grid_devices > 1):
        raise ValueError("accum_steps > 1 is not supported together with "
                         "cam_devices/grid_devices > 1 (accumulate on the "
                         "data axis or shard the model, not both)")
    if fused_dw and (cam_devices > 1 or grid_devices > 1):
        raise ValueError("--fused_dw composes with data parallelism only; "
                         "drop it for cam_devices/grid_devices > 1")
    if cam_devices > 1:
        if n % cam_devices:
            raise ValueError(f"n_devices={n} must be divisible by "
                             f"cam_devices={cam_devices}")
        if ncams % cam_devices:
            raise ValueError(f"ncams={ncams} must be divisible by "
                             f"cam_devices={cam_devices} (cameras shard "
                             "evenly over the cam axis)")
        if ncams < len(CAMERA_ORDER):
            raise ValueError(
                f"cam_devices > 1 trains on every camera (ncams="
                f"{len(CAMERA_ORDER)}): each cam rank would draw its own "
                f"subset of {ncams}")
    if grid_devices > 1:
        pgrid.check_plan(n, grid_devices, nx0, bsz)
    n_data = n // (cam_devices * grid_devices)
    if n > 1 and bsz % n_data:
        raise ValueError(f"bsz={bsz} must be divisible by the data-rank count "
                         f"{n_data} (n_devices / cam_devices)")
    if multihost and n <= 1:
        raise ValueError("--multihost needs more than one rank "
                         "(n_devices > 1)")
    return n, n_data, cam_devices, grid_devices


def rank_device(dev: torch.device, local: int) -> torch.device:
    """A rank's device: ``cuda:<local rank>`` on the GPU, else the CPU."""
    return torch.device("cuda", local) if dev.type == "cuda" else dev


def _rank_main(rank: int, world: int, tmp: str, kwargs: dict) -> None:
    """One spawned rank of ``train``: joins the group over a FileStore in
    ``tmp``, trains, and (rank 0) writes its result there. Only rank 0
    prints."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if rank:
        sys.stdout = open(os.devnull, "w")
    dev = rank_device(torch.device(kwargs["device"]), rank)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    pmesh.init_process(rank, world, f"file://{tmp}/store", dev)
    try:
        out = train(**kwargs)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        state = out.pop("state")
        out["model_state_dict"] = {k: v.detach().cpu() for k, v in
                                   state.model.state_dict().items()}
        if state.ema_model is not None:
            out["ema_state_dict"] = {k: v.detach().cpu() for k, v in
                                     state.ema_model.state_dict().items()}
        torch.save(out, os.path.join(tmp, "result.pt"))


def _spawn(n: int, kwargs: dict) -> dict:
    """Run ``train(**kwargs)`` on ``n`` spawned ranks; return rank 0's
    result. SIGTERM and SIGINT are passed on to the ranks (which agree on
    a step and checkpoint); a rank's watchdog exit ends this process with
    the same code, as a one-process run's does."""
    tmp = tempfile.mkdtemp(prefix="lss_ranks_")
    try:
        ctx = mp.start_processes(_rank_main, args=(n, tmp, kwargs), nprocs=n,
                                 join=False, start_method="spawn")

        def forward(signum, frame):
            for proc in ctx.processes:
                if proc.is_alive():
                    os.kill(proc.pid, signum)

        prev = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, forward)
        except ValueError:  # not the main thread
            pass
        try:
            while not ctx.join():
                pass
        except mp.ProcessExitedException as e:
            if e.exit_code == WATCHDOG_EXIT:
                os._exit(WATCHDOG_EXIT)
            raise
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)
        return {**torch.load(os.path.join(tmp, "result.pt"),
                             weights_only=True), "state": None}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def decode_stats(loader) -> dict:
    """The decode counts of a loader's dataset (``NativeDecoder.stats``:
    decodes by path and reason); {} for an iterable without one."""
    decoder = getattr(getattr(loader, "dataset", None), "decoder", None)
    return {} if decoder is None else dict(decoder.stats)


def get_val_info(eval_step, state, valloader, device=None,
                 heartbeat=None) -> dict:
    """Run the whole val loader: mean loss and dataset IoU (reference
    ``src/tools.py:243-270``), plus ``iou_per_class`` for outC > 1. Sums
    stay on the device until the end; with ``heartbeat`` (the stall
    watchdog's feed) each batch is synchronised and ``heartbeat()`` called
    after it. A loader that yields no batch gives loss 0.0 and IoU 1.0,
    as the JAX package's does (and ``train()`` then treats that as any
    validation)."""
    total = None
    it = iter(valloader)
    if device is not None:
        it = prefetch_to_device(it, device)
    for batch in it:
        m = eval_step(state, batch)
        total = m if total is None else {k: total[k] + m[k] for k in m}
        if heartbeat is not None:
            float(m["batch"])  # the batch is done on the device
            heartbeat()
    if total is None:
        return {"loss": 0.0, "iou": 1.0}
    total = {k: v.detach().cpu().numpy().astype(np.float64)
             for k, v in total.items()}
    n = max(float(total["batch"]), 1.0)
    union = float(total["union"])
    info = {"loss": float(total["loss_sum"]) / n,
            "iou": float(total["intersect"]) / union if union > 0 else 1.0}
    if len(total["intersect_c"]) > 1:
        info["iou_per_class"] = [float(i / u) if u > 0 else 1.0 for i, u in
                                 zip(total["intersect_c"], total["union_c"])]
    return info


def _figure(logger, step: int, tag: str, batch, logits, title: str,
            extent) -> None:
    """Log the BEV figure of sample 0 of a device ``batch`` and its
    ``logits``. The host copies come first and raise as any device error
    does; a figure that fails to render or log is reported and training
    goes on, as in the JAX trainer."""
    imgs = batch[0][0].cpu().numpy()
    gt = batch[6][0, 0].float().cpu().numpy()
    pred = torch.sigmoid(logits[0, 0].float()).cpu().numpy()
    try:
        import matplotlib.pyplot as plt
        from lss_carla_torch.utils.viz import make_bev_figure
        fig = make_bev_figure(imgs, gt, pred, title=title, extent=extent)
        logger.figure(step, tag, fig)
        plt.close(fig)
    except Exception as e:  # a figure must never kill training
        print(f"  {tag} failed: {type(e).__name__}: {e}")


def train(
    dataroot,
    nepochs: int = 100,
    # image config (reference train_simbev.py:28-37 defaults)
    H: int = 224,
    W: int = 480,
    resize_lim=(1.0, 1.0),
    final_dim=(128, 352),
    bot_pct_lim=(0.0, 0.0),
    rot_lim=(0.0, 0.0),
    rand_flip: bool = False,
    ncams: int = 6,
    # training config
    max_grad_norm: float = 5.0,
    pos_weight=2.13,
    logdir: str = "./runs/simbev",
    # BEV grid config
    xbound=(-50.0, 50.0, 0.5),
    ybound=(-50.0, 50.0, 0.5),
    zbound=(-10.0, 10.0, 20.0),
    dbound=(4.0, 45.0, 1.0),
    # optimisation config
    bsz: int = 4,
    nworkers: int = 4,
    lr: float = 1e-3,
    weight_decay: float = 1e-7,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    decay_steps: int = 0,             # 0 = auto: nepochs * optimizer steps
                                      # an epoch
    ema_decay: float = 0.0,           # > 0 (e.g. 0.999): an EMA of the
                                      # model; validation, best-IoU, the val
                                      # figure and the checkpoints'
                                      # ema_state_dict use it
    ema_bn_recal: int = 16,           # training batches the EMA's BN stats
                                      # are recalibrated over before each
                                      # validation (0 = the EMA'd stats)
    accum_steps: int = 1,             # > 1: one optimizer step a stack of
                                      # accum_steps loader batches
    # validation and checkpoints
    val_step: int = 500,
    save_step: int = 1000,
    resume: Optional[str] = None,     # a checkpoint file, or a directory
    pretrained_trunk: Optional[str] = None,  # an ImageNet trunk file, a
                                      # reference or port checkpoint (file
                                      # or ckpts/ dir), or "auto" (the torch
                                      # hub cache); resume overrides it
    # observability
    use_wandb: bool = False,
    wandb_project: str = "lift-splat-shoot",
    wandb_name: Optional[str] = None,
    wandb_entity: Optional[str] = None,
    viz_step: int = 100,              # a train figure every viz_step steps
                                      # and a val figure after each
                                      # validation (0 = none)
    iou_log_step: int = 100,
    seed: int = 42,
    splat_method: str = "scatter",
    compute_dtype: str = "float32",   # or "bfloat16" (models/lss.py)
    variant: str = "b0",              # efficientnet b0-b4, resnet18/34
    fused_dw: bool = False,           # the depthwise conv + BN moments in
                                      # one pass (ops/mbconv.py)
    outC: int = 1,
    label_mode: str = "vehicle_binary",
    label_classes=(0, 1, 2, 3),
    extrinsic_noise=None,             # (rot_deg_std, trans_m_std) or None
    device_normalize: bool = True,    # ship uint8 images, normalise on the
                                      # device
    dataset: str = "simbev",          # or "nuscenes" (data/nuscenes.py)
    nuscenes_version: str = "v1.0-mini",
    use_native: bool = USE_NATIVE,    # the C++ JPEG decoder (False: PIL;
                                      # data/decode.py)
    max_steps: Optional[int] = None,  # stop early (smoke and bench runs)
    profile_dir: Optional[str] = None,  # a torch.profiler trace of the run
    watchdog_secs: int = 0,           # stall detector (0 = off): dumps the
                                      # stacks at N s, exits 42 at 2N
    debug_stall_at: int = 0,          # testing only: hang at this step
                                      # (unless resuming) to drill the
                                      # watchdog and --supervise
    async_save: bool = False,         # periodic checkpoints written in a
                                      # background thread; best, final and
                                      # preemption saves stay synchronous
    n_devices: Optional[int] = None,  # ranks, one process a device (None:
                                      # 1, or the launcher's world size
                                      # with multihost)
    multihost: bool = False,          # join a launcher's process group
                                      # (torchrun's environment) instead of
                                      # spawning the ranks
    cam_devices: int = 1,             # camera-parallel ranks a data row:
                                      # n_devices / cam_devices data ranks
    grid_devices: int = 1,            # BEV-grid parallel ranks a data row:
                                      # the grid's X axis split over them
                                      # (parallel/grid.py); n_devices /
                                      # grid_devices data ranks
    device="cuda",
):
    """Train LSS on SimBEV or nuScenes (``dataset``) on one device or, with
    ``n_devices`` > 1, on several ranks (the module docstring); the JAX
    trainer's keywords plus ``use_native``. With several ranks on a GPU,
    rank r runs on ``cuda:<local rank>`` whatever index ``device`` names. nuScenes takes only
    ``label_mode="vehicle_binary"`` and no ``extrinsic_noise``, as in JAX. ``device`` is "cuda"
    unless the caller asks for the CPU; no GPU raises. Weights are drawn
    from a generator seeded ``seed``, and ``torch.manual_seed(seed)`` seeds
    dropout and drop-connect. The step counter, ``max_steps``, ``val_step``
    and ``save_step`` count optimizer steps. ``train/step_time`` is the
    mean wall time of the steps since the previous IoU log, synchronised.

    Returns {"counter", "start_counter", "best_val_iou" (None without a
    validation), "state", "decode_stats" ({"train": ..., "val": ...}: the
    datasets' ``NativeDecoder.stats``, decodes by path and reason)}. A call
    that spawned its ranks returns rank 0's, with "state" None and the
    trained weights as "model_state_dict" (and "ema_state_dict" with
    EMA), on the CPU."""
    kwargs = dict(locals())
    check_pretrained_trunk(pretrained_trunk, variant)
    if dataset not in ("simbev", "nuscenes"):
        raise ValueError(f"unknown dataset: {dataset!r}")
    if dataset == "nuscenes":
        # the nuScenes loader makes binary vehicle masks only; accepting
        # these would broadcast shapes through the loss
        if label_mode != "vehicle_binary":
            raise ValueError(f"dataset='nuscenes' supports only "
                             f"label_mode='vehicle_binary' (got "
                             f"{label_mode!r})")
        if extrinsic_noise is not None:
            raise ValueError("extrinsic_noise is not implemented for the "
                             "nuScenes loader")
    dev = resolve_device(device)
    n_ranks, n_data, cam_devices, grid_devices = parallel_plan(
        n_devices, multihost, cam_devices, accum_steps, fused_dw, ncams, bsz,
        dev, grid_devices, int(round((xbound[1] - xbound[0]) / xbound[2])))
    mesh = None
    if n_ranks > 1:
        if not dist.is_initialized():
            if not multihost:
                return _spawn(n_ranks, kwargs)
            env = pmesh.launcher_env()
            pmesh.init_process(env["rank"], env["world_size"], "env://",
                               rank_device(dev, env["local_rank"]))
        if dist.get_world_size() != n_ranks:
            raise ValueError(f"n_devices={n_ranks}, the process group has "
                             f"{dist.get_world_size()} ranks")
        dev = rank_device(dev, pmesh.local_rank())
        mesh = (pmesh.make_mesh_grid(n_data, grid_devices, dev)
                if grid_devices > 1
                else pmesh.make_mesh_2d(n_data, cam_devices, dev))
        if dev.type == "cuda":
            # one nvcc a kernel: rank 0 builds, the others then load it
            if mesh.is_primary:
                splat_cuda.LIB.build()
                if fused_dw:
                    mbconv_cuda.LIB.build()
            mesh.barrier()
    is_primary = mesh is None or mesh.is_primary
    # dropout and drop-connect outside the parallel steps' own streams
    # (the EMA's recalibration forwards) differ between ranks
    torch.manual_seed(seed + (0 if mesh is None else mesh.rank))
    grid_conf = GridConf(xbound=tuple(xbound), ybound=tuple(ybound),
                         zbound=tuple(zbound), dbound=tuple(dbound))
    data_aug_conf = DataAugConf(
        H=H, W=W, final_dim=tuple(final_dim), resize_lim=tuple(resize_lim),
        bot_pct_lim=tuple(bot_pct_lim), rot_lim=tuple(rot_lim),
        rand_flip=rand_flip, Ncams=ncams)
    if label_mode == "multiclass":
        outC = len(label_classes)
    if not isinstance(pos_weight, (int, float)):
        pos_weight = tuple(float(w) for w in pos_weight)
        if len(pos_weight) == 1:
            pos_weight = pos_weight[0]
        elif len(pos_weight) != outC:
            raise ValueError(f"pos_weight takes 1 value or one per class "
                             f"(outC={outC}); got {len(pos_weight)}")

    trunk_name = variant if variant.startswith("resnet") \
        else f"efficientnet-{variant}"
    print("=" * 80)
    print("Training configuration:")
    print(f"  dataroot: {dataroot} ({dataset})")
    print(f"  logdir: {logdir}")
    print(f"  device: {dev}  batch size: {bsz} x {accum_steps} microbatches")
    if mesh is not None:
        print(f"  ranks: {mesh.size} = {mesh.n_data} data x {mesh.n_cam} "
              f"{mesh.axis} ({dist.get_backend()}); {bsz // mesh.n_data} rows "
              "a data rank" + (f", {bsz // mesh.size} lifted a rank"
                               if grid_devices > 1 else "")
              + ("; multihost" if multihost else ""))
    print(f"  lr: {lr}  epochs: {nepochs}  cams: {ncams}")
    print(f"  image: {H}x{W} -> {tuple(final_dim)}")
    print(f"  splat: {splat_method}  trunk: {trunk_name}  fused_dw: "
          f"{fused_dw}  compute: {compute_dtype}")
    print("=" * 80)

    # each data rank loads its shard of every global batch; the cam ranks
    # of a data row load the same rows; in the grid mode every rank loads
    # the rows it lifts
    if grid_devices > 1:
        shards = {"shard_index": mesh.rank, "num_shards": n_ranks,
                  "bsz": bsz // n_ranks}
    else:
        shards = {"shard_index": 0 if mesh is None else mesh.data_index,
                  "num_shards": n_data, "bsz": bsz // n_data}
    if dataset == "nuscenes":
        from lss_carla_torch.data.nuscenes import compile_data_nuscenes
        trainloader, valloader = compile_data_nuscenes(
            nuscenes_version, dataroot, data_aug_conf, grid_conf,
            nworkers=nworkers, device_normalize=device_normalize,
            use_native=use_native, seed=seed, **shards)
    else:
        trainloader, valloader = compile_data(
            "unused", dataroot, data_aug_conf, grid_conf,
            nworkers=nworkers, seed=seed, **shards,
            dataset_kwargs={"label_mode": label_mode,
                            "label_classes": tuple(label_classes),
                            "extrinsic_noise": extrinsic_noise,
                            "device_normalize": device_normalize,
                            "use_native": use_native})
    print(f"Train batches: {len(trainloader)}  Val batches: {len(valloader)}")
    if len(trainloader) == 0:
        raise ValueError(f"fewer train samples than one global batch of "
                         f"{bsz}")
    if accum_steps > len(trainloader):
        # stack_microbatches drops the ragged tail: no step would run
        raise ValueError(f"accum_steps={accum_steps} exceeds the "
                         f"{len(trainloader)} train batches an epoch")

    model = compile_model(grid_conf, data_aug_conf, outC=outC,
                          splat_method=splat_method, variant=variant,
                          fused_dw=fused_dw, compute_dtype=compute_dtype,
                          device=dev,
                          generator=torch.Generator().manual_seed(seed))
    if lr_schedule != "constant" and decay_steps <= 0:
        # optimizer steps: accum_steps loader batches make one
        decay_steps = max(nepochs * (len(trainloader) // accum_steps),
                          warmup_steps + 1)
        print(f"  lr schedule: {lr_schedule}, warmup {warmup_steps}, "
              f"decay over {decay_steps} steps (auto)")
    if ema_decay:
        print(f"  EMA on (decay {ema_decay}, warm-up ramped, "
              f"~{1.0 / max(1.0 - ema_decay, 1e-9):.0f}-step horizon): "
              "validation and best IoU use the averaged model, "
              + (f"BN stats recalibrated over {ema_bn_recal} recent batches"
                 if ema_bn_recal > 0 else "with the EMA'd BN stats"))
    state = create_train_state(model, lr=lr, weight_decay=weight_decay,
                               max_grad_norm=max_grad_norm,
                               lr_schedule=lr_schedule,
                               warmup_steps=warmup_steps,
                               decay_steps=decay_steps, ema_decay=ema_decay)
    log_lr = lr_schedule != "constant" or warmup_steps
    print(f"Number of trainable parameters: "
          f"{sum(p.numel() for p in model.parameters()):,}")
    if pretrained_trunk is not None:
        # in place: the optimizer, the EMA and the parallel steps hold the
        # model's tensors. Before (and overridden by) resume, as the
        # reference's from_pretrained at build, then the checkpoint load
        merge_trunk_state_dict(model, trunk_state_dict_from_checkpoint(
            pretrained_trunk, variant))
        if state.ema_model is not None:  # seeded from the random init
            state.ema_model.load_state_dict(model.state_dict())
        print(f"Loaded pretrained trunk from {pretrained_trunk}")
    if mesh is None:
        train_fn = make_train_step(model, pos_weight, accum_steps=accum_steps,
                                   ema_decay=ema_decay, device=dev)

        def eval_step(m):
            return make_eval_step(m, pos_weight, device=dev)

        def predict_step(m):
            return make_predict_step(m, device=dev)
    elif grid_devices > 1:
        train_fn = pgrid.make_grid_sharded_train_step(
            model, mesh, pos_weight, ema_decay=ema_decay, seed=seed)

        def eval_step(m):
            return pgrid.make_grid_sharded_eval_step(m, mesh, pos_weight)

        def predict_step(m):
            return pgrid.make_grid_sharded_predict(m, mesh)
    elif mesh.n_cam > 1:
        train_fn = pcamera.make_camera_sharded_train_step(
            model, mesh, pos_weight, ema_decay=ema_decay, seed=seed)

        def eval_step(m):
            return pcamera.make_camera_sharded_eval_step(m, mesh, pos_weight)

        def predict_step(m):
            return pcamera.make_camera_sharded_predict(m, mesh)
    else:
        train_fn = pstep.make_sharded_train_step(
            model, mesh, pos_weight, ema_decay=ema_decay,
            accum_steps=accum_steps, seed=seed)

        def eval_step(m):
            return pstep.make_sharded_eval_step(m, mesh, pos_weight)

        def predict_step(m):  # rank 0's rows only: no collective
            return make_predict_step(m, device=dev)
    eval_fn = eval_step(model)
    ema_eval_fn = eval_step(state.ema_model) if ema_decay else None
    # the last ema_bn_recal training batches (microbatch 0 of a stack), on
    # the device, for the EMA's BN recalibration before each validation;
    # with several ranks, each batch's moments are the global batch's
    recal_window = (collections.deque(maxlen=ema_bn_recal)
                    if ema_decay and ema_bn_recal > 0 else None)
    # with several ranks every BN of the recalibration takes the global
    # batch's moments; the grid mode's through its own forward
    recal_group = None if mesh is None else dist.group.WORLD
    recal_forward = (pgrid.grid_forward(state.ema_model, mesh, seed)
                     if grid_devices > 1 and ema_decay else None)
    # figures: the trained model for the train figure, the validated one
    # (the EMA with ema_decay) for the val figure, on val batch 0 fetched
    # once. Rank 0 renders them; the camera- and grid-parallel predictions
    # are collectives, which every rank runs on its own rows
    if multihost and viz_step:
        print("multihost: figures off (as in the JAX trainer)")
        viz_step = 0
    predict_fn = val_predict_fn = viz_val_batch = None
    if viz_step and (is_primary or mesh.n_cam > 1):
        predict_fn = predict_step(model)
        val_predict_fn = (predict_step(state.ema_model) if ema_decay
                          else predict_fn)
        viz_val_batch = next(iter(valloader), None)
    extent = (grid_conf.ybound[0], grid_conf.ybound[1],
              grid_conf.xbound[0], grid_conf.xbound[1])

    ckpt_dir = os.path.join(logdir, "ckpts")
    ckpt = (CheckpointManager(ckpt_dir, async_save=async_save) if is_primary
            else None)
    # None until a validation: the first one always writes model_best.pt,
    # even at IoU 0 (the JAX trainer starts at 0.0 and writes none then)
    counter, start_epoch, best_val_iou = 0, 0, None
    if resume is not None:
        restored = load_checkpoint(resume)
        restore_train_state(state, restored)
        counter = state.step
        start_epoch = int(restored["epoch"])
        # periodic checkpoints carry no val_iou: consult the best files,
        # or a resumed run would overwrite a better saved model
        resume_dir = resume if os.path.isdir(resume) else os.path.dirname(
            os.path.abspath(resume))
        candidates = [b for b in (restored.get("val_iou"),
                                  read_best_val_iou(resume_dir),
                                  read_best_val_iou(ckpt_dir))
                      if b is not None]
        best_val_iou = max(candidates, default=None)
        print(f"Resumed from step {counter}, epoch {start_epoch} "
              f"(best val IoU so far {best_val_iou})")
    start_counter = counter
    if mesh is not None:
        # every rank loaded the same weights (or made them from one seed):
        # rank 0's are broadcast and the replicas checked bit-equal
        for m in (model, state.ema_model):
            if m is not None:
                pmesh.replicate(m, mesh)

    def save(method, *args, **kw):
        """Rank 0 writes ``ckpt.<method>``; every rank then waits for it."""
        if ckpt is not None:
            getattr(ckpt, method)(counter, model, state.optimizer, *args,
                                  ema_model=state.ema_model, **kw)
        if mesh is not None:
            mesh.barrier()

    # the handler sets ``signalled``; ``preempted`` is the ranks' agreement
    # on it, read at the same step on every rank
    signalled = preempted = False

    def _on_signal(signum, frame):
        nonlocal signalled
        print(f"signal {signum} received -> checkpoint and exit")
        signalled = True

    prev_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _on_signal)
    except ValueError:  # not the main thread (e.g. under a test runner)
        prev_handlers = {}

    logger = NullLogger() if not is_primary else MetricLogger(
        logdir, use_wandb=use_wandb, wandb_kwargs={
            "project": wandb_project, "name": wandb_name,
            "entity": wandb_entity,
            "config": {"bsz": bsz, "lr": lr, "grid_conf": grid_conf.to_dict(),
                       "data_aug_conf": data_aug_conf.to_dict(),
                       "variant": variant, "compute_dtype": compute_dtype,
                       "n_devices": n_ranks, "cam_devices": cam_devices,
                       "grid_devices": grid_devices}})
    watchdog = None
    if watchdog_secs:
        watchdog = StallWatchdog(watchdog_secs,
                                 abort_after=2 * watchdog_secs).start()
        print(f"Stall watchdog armed after the first step (warn "
              f"{watchdog_secs}s, abort {2 * watchdog_secs}s)")
    heartbeat = watchdog.beat if watchdog is not None else None
    prof = None
    if profile_dir and is_primary:
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(profile_dir))
        prof.start()
    print("Starting training...")
    stop = False
    first_val_done = False  # the watchdog is paused for the first
                            # validation (one-time set-up, like step 1)
    early_stop_epoch = None
    window_start, window_steps = time.perf_counter(), 0
    try:
        for epoch in range(start_epoch, nepochs):
            # epoch e always draws shuffle order seed + e, resumed or not
            trainloader.set_epoch(epoch)
            batches = stack_microbatches(iter(trainloader), accum_steps)
            for batch in prefetch_to_device(batches, dev):
                metrics = train_fn(state, batch)
                counter += 1
                window_steps += 1
                micro0 = batch if accum_steps == 1 else tuple(x[0] for x in batch)
                if recal_window is not None:
                    recal_window.append(micro0[:6])
                if watchdog is not None and counter == start_counter + 1:
                    float(metrics["loss"])  # armed once step 1 is done
                    watchdog.beat()
                if debug_stall_at and counter == debug_stall_at \
                        and resume is None:
                    # the drill: the watchdog dumps the stacks at N s and
                    # exits 42 at 2N; --supervise restarts with --resume,
                    # which skips this
                    print(f"[debug] injected stall at step {counter}; "
                          "sleeping until the watchdog ends the process",
                          flush=True)
                    while True:
                        time.sleep(60)
                if counter % 10 == 0:
                    logger.scalars(counter, **{
                        "train/loss": float(metrics["loss"])})
                    if watchdog is not None:  # float() synchronised
                        watchdog.beat()
                if iou_log_step and counter % iou_log_step == 0:
                    union = float(metrics["union"])
                    iou = float(metrics["intersect"]) / union if union > 0 else 1.0
                    step_time = (time.perf_counter() - window_start) / window_steps
                    scalars = {"train/iou": iou, "train/epoch": epoch,
                               "train/step_time": step_time,
                               "train/samples_per_sec":
                                   bsz * accum_steps / step_time}
                    if log_lr:
                        scalars["train/lr"] = state.schedule(counter)
                    logger.scalars(counter, **scalars)
                    print(f"[{epoch}] step {counter}: "
                          f"loss={float(metrics['loss']):.4f} iou={iou:.4f} "
                          f"step_time={step_time:.3f}s")
                    window_start, window_steps = time.perf_counter(), 0

                if predict_fn is not None and counter % viz_step == 0:
                    logits = predict_fn(state, micro0[:6])
                    if is_primary:
                        union = float(metrics["union"])
                        viz_iou = (float(metrics["intersect"]) / union
                                   if union > 0 else 1.0)
                        _figure(logger, counter, "train/visualization",
                                micro0, logits, f"Training iter {counter} | "
                                f"IoU {viz_iou:.4f}", extent)
                    window_start, window_steps = time.perf_counter(), 0

                if val_step and counter % val_step == 0:
                    if watchdog is not None and not first_val_done:
                        watchdog.pause()
                    if ema_decay:
                        if recal_window:
                            recalibrate_bn(state.ema_model, recal_window,
                                           recal_group, recal_forward)
                        val_info = get_val_info(ema_eval_fn, state, valloader,
                                                dev, heartbeat)
                        raw_info = get_val_info(eval_fn, state, valloader,
                                                dev, heartbeat)
                    else:
                        val_info = get_val_info(eval_fn, state, valloader,
                                                dev, heartbeat)
                    first_val_done = True
                    val_scalars = {"val/loss": val_info["loss"],
                                   "val/iou": val_info["iou"]}
                    if ema_decay:
                        val_scalars["val/loss_raw"] = raw_info["loss"]
                        val_scalars["val/iou_raw"] = raw_info["iou"]
                    for ci, v in enumerate(val_info.get("iou_per_class", [])):
                        val_scalars[f"val/iou_c{ci}"] = v
                    logger.scalars(counter, **val_scalars)
                    print(f"  validation: loss={val_info['loss']:.4f} "
                          f"iou={val_info['iou']:.4f}"
                          + (f" raw_iou={raw_info['iou']:.4f}" if ema_decay
                             else ""))
                    if watchdog is not None:
                        watchdog.beat()
                    if viz_val_batch is not None:
                        vb = to_device(viz_val_batch[:7], dev)
                        logits = val_predict_fn(state, vb[:6])
                        if is_primary:
                            _figure(logger, counter, "val/visualization", vb,
                                    logits, f"Validation iter {counter} | "
                                    f"IoU {val_info['iou']:.4f}", extent)
                    if best_val_iou is None or val_info["iou"] > best_val_iou:
                        best_val_iou = val_info["iou"]
                        if watchdog is not None:
                            watchdog.pause()  # an abort mid-write would
                                              # lose the checkpoint
                        save("save_best", epoch, best_val_iou)
                        logger.summary(best_val_iou=best_val_iou)
                        print(f"  new best IoU {best_val_iou:.4f} (saved)")
                        if watchdog is not None:
                            watchdog.beat()
                    window_start, window_steps = time.perf_counter(), 0

                if save_step and counter % save_step == 0:
                    if watchdog is not None:
                        watchdog.pause()
                    save("save", epoch)
                    if watchdog is not None:
                        watchdog.beat()
                    window_start, window_steps = time.perf_counter(), 0
                preempted = (signalled if mesh is None
                             else mesh.any(signalled))
                if preempted:
                    if watchdog is not None:
                        watchdog.pause()
                    save("save", epoch, wait=True)
                    stop = True
                    break
                if max_steps is not None and counter >= max_steps:
                    early_stop_epoch = epoch
                    stop = True
                    break
            if stop:
                break
    finally:
        # a still-armed watchdog would hard-exit the caller up to 2N
        # seconds after an escaping exception
        if watchdog is not None:
            watchdog.stop()
        if prof is not None:
            prof.stop()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        logger.close()

    if not preempted:
        # completion records epoch=nepochs (reference semantics); an early
        # stop records the true epoch, so a resume continues
        save("save_final",
             nepochs if early_stop_epoch is None else early_stop_epoch)
    if ckpt is not None:
        ckpt.close()
    print(f"Best validation IoU: {best_val_iou}")
    return {"counter": counter, "start_counter": start_counter,
            "best_val_iou": best_val_iou, "state": state,
            "decode_stats": {"train": decode_stats(trainloader),
                             "val": decode_stats(valloader)}}
