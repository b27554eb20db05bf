"""The single-device training loop: counterpart of
``lss_carla_tpu/training/loop.py`` (reference ``train_simbev.py:23-460``).

SimBEV loader (-> ``stack_microbatches`` with ``accum_steps`` > 1) ->
``prefetch_to_device`` (pinned host batches, copies on the consumer
thread) -> eager train step (forward, weighted BCE, backward, optax-rule
clip, Adam, EMA) -> validation over the whole val set -> torch checkpoints
in the reference's format, with best-IoU tracking and resume. SIGTERM or
SIGINT saves a resumable checkpoint and stops. Metric syncs are batched:
the loss is read every 10 steps and the IoU and step time every
``iou_log_step`` steps. ``compute_dtype`` "bfloat16" runs the model in
bf16 (``models/lss.py``).

With ``ema_decay > 0`` validation, best-IoU tracking and ``model_best.pt``'s
``ema_state_dict`` use the averaged model, whose BN stats are first
recalibrated over the last ``ema_bn_recal`` training batches (microbatch
0 of each, ``training/bn_recal.py``); the raw model's validation is logged
beside it as ``val/loss_raw`` and ``val/iou_raw``.

Flags of the JAX trainer that the port does not have yet raise
``NotImplementedError`` naming their ``ROADMAP.md`` item (``UNPORTED``);
none is ignored.
"""

from __future__ import annotations

import collections
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.loader import (compile_data, prefetch_to_device,
                                         stack_microbatches)
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.training.bn_recal import recalibrate_bn
from lss_carla_torch.training.state import (create_train_state,
                                            restore_train_state)
from lss_carla_torch.training.step import make_eval_step, make_train_step
from lss_carla_torch.utils.backend import resolve_device
from lss_carla_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from lss_carla_torch.utils.logging import MetricLogger

# keyword of the JAX trainer -> (its values that mean "off", ROADMAP.md item)
UNPORTED = {
    "pretrained_trunk": ((None,), "A5, --pretrained_trunk"),
    "use_wandb": ((False,), "A5, wandb and figures"),
    "wandb_project": (("lift-splat-shoot",), "A5, wandb and figures"),
    "wandb_name": ((None,), "A5, wandb and figures"),
    "wandb_entity": ((None,), "A5, wandb and figures"),
    "viz_step": ((0,), "A5, wandb and figures"),
    "n_devices": ((None, 1), "A9, parallel modes"),
    "multihost": ((False,), "A9, parallel modes"),
    "cam_devices": ((1,), "A9, parallel modes"),
    "grid_devices": ((1,), "A9, parallel modes"),
    "dataset": (("simbev",), "A7, the nuScenes loader"),
    "nuscenes_version": (("v1.0-mini",), "A7, the nuScenes loader"),
    "profile_dir": ((None,), "A10, tools and bench"),
    "watchdog_secs": ((0,), "A5, the watchdog and --supervise"),
    "debug_stall_at": ((0,), "A5, the watchdog and --supervise"),
    "async_save": ((False,), "A5, checkpoints"),
}


def check_unported(**kwargs) -> None:
    """Raise for every keyword of ``UNPORTED`` set to anything but off."""
    unknown = sorted(set(kwargs) - set(UNPORTED))
    if unknown:
        raise TypeError(f"train() got unexpected keyword arguments {unknown}")
    on = {k: v for k, v in kwargs.items() if v not in UNPORTED[k][0]}
    if on:
        raise NotImplementedError(
            "not ported to lss_carla_torch yet: " + "; ".join(
                f"{k}={v!r} (ROADMAP.md {UNPORTED[k][1]})"
                for k, v in sorted(on.items())))


def get_val_info(eval_step, state, valloader, device=None) -> dict:
    """Run the whole val loader: mean loss and dataset IoU (reference
    ``src/tools.py:243-270``), plus ``iou_per_class`` for outC > 1. Sums
    stay on the device until the end."""
    total = None
    it = iter(valloader)
    if device is not None:
        it = prefetch_to_device(it, device)
    for batch in it:
        m = eval_step(state, batch)
        total = m if total is None else {k: total[k] + m[k] for k in m}
    if total is None:
        raise ValueError("the val loader yielded no batch")
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
                                      # model; validation, best-IoU and the
                                      # checkpoints' ema_state_dict use it
    ema_bn_recal: int = 16,           # training batches the EMA's BN stats
                                      # are recalibrated over before each
                                      # validation (0 = the EMA'd stats)
    accum_steps: int = 1,             # > 1: one optimizer step a stack of
                                      # accum_steps loader batches
    # validation and checkpoints
    val_step: int = 500,
    save_step: int = 1000,
    resume: Optional[str] = None,     # a checkpoint file, or a directory
    iou_log_step: int = 100,
    seed: int = 42,
    splat_method: str = "scatter",
    compute_dtype: str = "float32",   # or "bfloat16" (models/lss.py)
    variant: str = "b0",
    fused_dw: bool = False,           # the depthwise conv + BN moments in
                                      # one pass (ops/mbconv.py)
    outC: int = 1,
    label_mode: str = "vehicle_binary",
    label_classes=(0, 1, 2, 3),
    extrinsic_noise=None,             # (rot_deg_std, trans_m_std) or None
    device_normalize: bool = True,    # ship uint8 images, normalise on the
                                      # device
    max_steps: Optional[int] = None,  # stop early (smoke and bench runs)
    device="cuda",
    **unported,
):
    """Train LSS on SimBEV on one device; the JAX trainer's keywords, minus
    those in ``UNPORTED`` (which raise unless off). ``device`` is "cuda"
    unless the caller asks for the CPU; no GPU raises. Weights are drawn
    from a generator seeded ``seed``, and ``torch.manual_seed(seed)`` seeds
    dropout and drop-connect. The step counter, ``max_steps``, ``val_step``
    and ``save_step`` count optimizer steps. ``train/step_time`` is the
    mean wall time of the steps since the previous IoU log, synchronised.

    Returns {"counter", "start_counter", "best_val_iou" (None without a
    validation), "state"}."""
    check_unported(**unported)
    dev = resolve_device(device)
    torch.manual_seed(seed)
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

    print("=" * 80)
    print("Training configuration:")
    print(f"  dataroot: {dataroot}")
    print(f"  logdir: {logdir}")
    print(f"  device: {dev}  batch size: {bsz} x {accum_steps} microbatches")
    print(f"  lr: {lr}  epochs: {nepochs}  cams: {ncams}")
    print(f"  image: {H}x{W} -> {tuple(final_dim)}")
    print(f"  trunk: efficientnet-{variant}  fused_dw: {fused_dw}  "
          f"compute: {compute_dtype}")
    print("=" * 80)

    trainloader, valloader = compile_data(
        "unused", dataroot, data_aug_conf, grid_conf, bsz=bsz,
        nworkers=nworkers, seed=seed,
        dataset_kwargs={"label_mode": label_mode,
                        "label_classes": tuple(label_classes),
                        "extrinsic_noise": extrinsic_noise,
                        "device_normalize": device_normalize})
    print(f"Train batches: {len(trainloader)}  Val batches: {len(valloader)}")
    if len(trainloader) == 0:
        raise ValueError(f"fewer train samples than one batch of {bsz}")
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
    train_fn = make_train_step(model, pos_weight, accum_steps=accum_steps,
                               ema_decay=ema_decay, device=dev)
    eval_fn = make_eval_step(model, pos_weight, device=dev)
    ema_eval_fn = (make_eval_step(state.ema_model, pos_weight, device=dev)
                   if ema_decay else None)
    # the last ema_bn_recal training batches (microbatch 0 of a stack), on
    # the device, for the EMA's BN recalibration before each validation
    recal_window = (collections.deque(maxlen=ema_bn_recal)
                    if ema_decay and ema_bn_recal > 0 else None)

    ckpt = CheckpointManager(os.path.join(logdir, "ckpts"))
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
                                  CheckpointManager(resume_dir).best_val_iou(),
                                  ckpt.best_val_iou()) if b is not None]
        best_val_iou = max(candidates, default=None)
        print(f"Resumed from step {counter}, epoch {start_epoch} "
              f"(best val IoU so far {best_val_iou})")
    start_counter = counter

    def save(save_fn, *args):
        save_fn(counter, model, state.optimizer, *args,
                ema_model=state.ema_model)

    preempted = False

    def _on_signal(signum, frame):
        nonlocal preempted
        print(f"signal {signum} received -> checkpoint and exit")
        preempted = True

    prev_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _on_signal)
    except ValueError:  # not the main thread (e.g. under a test runner)
        prev_handlers = {}

    logger = MetricLogger(logdir)
    print("Starting training...")
    stop = False
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
                if recal_window is not None:
                    recal_window.append(batch[:6] if accum_steps == 1 else
                                        tuple(x[0] for x in batch[:6]))
                if counter % 10 == 0:
                    logger.scalars(counter, **{
                        "train/loss": float(metrics["loss"])})
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

                if val_step and counter % val_step == 0:
                    if ema_decay:
                        if recal_window:
                            recalibrate_bn(state.ema_model, recal_window)
                        val_info = get_val_info(ema_eval_fn, state, valloader, dev)
                        raw_info = get_val_info(eval_fn, state, valloader, dev)
                    else:
                        val_info = get_val_info(eval_fn, state, valloader, dev)
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
                    if best_val_iou is None or val_info["iou"] > best_val_iou:
                        best_val_iou = val_info["iou"]
                        save(ckpt.save_best, epoch, best_val_iou)
                        print(f"  new best IoU {best_val_iou:.4f} (saved)")
                    window_start, window_steps = time.perf_counter(), 0

                if save_step and counter % save_step == 0:
                    save(ckpt.save, epoch)
                    window_start, window_steps = time.perf_counter(), 0
                if preempted:
                    save(ckpt.save, epoch)
                    stop = True
                    break
                if max_steps is not None and counter >= max_steps:
                    early_stop_epoch = epoch
                    stop = True
                    break
            if stop:
                break
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        logger.close()

    if not preempted:
        # completion records epoch=nepochs (reference semantics); an early
        # stop records the true epoch, so a resume continues
        save(ckpt.save_final,
             nepochs if early_stop_epoch is None else early_stop_epoch)
    print(f"Best validation IoU: {best_val_iou}")
    return {"counter": counter, "start_counter": start_counter,
            "best_val_iou": best_val_iou, "state": state}
