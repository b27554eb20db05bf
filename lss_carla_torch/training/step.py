"""Train, eval and predict steps: counterpart of
``lss_carla_tpu/training/step.py`` (single device).

One train step is the reference hot loop: geometry -> CamEncode -> lift ->
splat -> BevEncode -> weighted BCE -> backward -> clip -> Adam, eagerly on
the model's device. Metrics come back as device scalars and are synced
only where the caller reads them. Every factory takes ``device`` ("cuda"
unless the caller asks for the CPU; no GPU raises) and moves each batch
there.

The parallel steps (``parallel/step.py``, ``parallel/camera.py``) are
these steps with two hooks: ``forward`` replaces the model's forward on
the six inputs, and ``reduce`` runs the step's collectives.
"""

from __future__ import annotations

import torch

from lss_carla_torch.training.loss import (bce_with_logits,
                                           get_batch_iou_counts,
                                           masked_eval_metrics)
from lss_carla_torch.training.state import ema_update
from lss_carla_torch.utils.backend import resolve_device


def to_device(batch, device: torch.device):
    """Each array of ``batch`` as a tensor on ``device`` (no copy where it
    is there already)."""
    return tuple(torch.as_tensor(a).to(device, non_blocking=True)
                 for a in batch)


def make_train_step(model, pos_weight=2.13, accum_steps: int = 1,
                    ema_decay: float = 0.0, device="cuda", forward=None,
                    reduce=None):
    """Returns ``train_step(state, batch) -> metrics``.

    ``batch`` is the reference 7-tuple (imgs, rots, trans, intrins,
    post_rots, post_trans, binimgs). metrics = {loss, intersect, union,
    grad_norm} as device scalars, from the logits before the update.

    ``accum_steps > 1``: gradient accumulation (the JAX ``accum_scan``).
    Each batch entry carries a leading (accum_steps, ...) microbatch axis
    (``data.loader.stack_microbatches``). The microbatches run in turn at
    the same parameters; BN running stats update in turn, as consecutive
    steps would; dropout draws afresh for each. The gradients are summed,
    divided by ``accum_steps``, clipped once and applied in one Adam
    update. loss is the microbatches' mean, intersect and union their sums.

    ``ema_decay > 0`` advances ``state.ema_model`` after the update
    (``training/state.py::ema_update``); the state must have been made with
    ``create_train_state(..., ema_decay=...)``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    dev = resolve_device(device)
    forward = forward or model

    def micro_step(micro):
        logits = forward(*micro[:6])
        binimgs = micro[6]
        loss = bce_with_logits(logits, binimgs, pos_weight)
        loss.backward()
        intersect, union = get_batch_iou_counts(logits.detach(), binimgs)
        return loss.detach(), intersect, union

    def train_step(state, batch):
        batch = to_device(batch[:7], dev)
        model.train()
        state.optimizer.zero_grad()
        if accum_steps == 1:
            loss, intersect, union = micro_step(batch)
        else:
            if batch[0].shape[0] != accum_steps:
                raise ValueError(f"batch has {batch[0].shape[0]} microbatches, "
                                 f"accum_steps is {accum_steps}")
            parts = [micro_step(tuple(x[i] for x in batch))
                     for i in range(accum_steps)]
            loss, intersect, union = (sum(p) for p in zip(*parts))
            loss = loss / accum_steps
            grads = [p.grad for p in state.optimizer.params if p.grad is not None]
            torch._foreach_div_(grads, float(accum_steps))
        metrics = {"loss": loss, "intersect": intersect, "union": union}
        if reduce is not None:
            metrics = reduce(state, metrics)
        grad_norm = state.optimizer.step(state.step)
        state.step += 1
        if ema_decay > 0:
            ema_update(state, ema_decay)
        return {**metrics, "grad_norm": grad_norm}

    return train_step


def make_eval_step(model, pos_weight=2.13, device="cuda", forward=None,
                   reduce=None):
    """Returns ``eval_step(state, batch) -> metrics`` for ``get_val_info``:
    {loss_sum, intersect, union, intersect_c, union_c, batch}. An 8th
    batch element is the val loader's (B,) validity mask (``pad_last``);
    padded samples count nowhere. ``forward`` and ``reduce(metrics) ->
    metrics`` as in ``make_train_step``."""
    dev = resolve_device(device)
    forward = forward or model

    def eval_step(state, batch):
        batch = to_device(batch, dev)
        imgs, rots, trans, intrins, post_rots, post_trans, binimgs = batch[:7]
        valid = batch[7] if len(batch) > 7 else \
            torch.ones(imgs.shape[0], device=dev)
        model.eval()
        with torch.no_grad():
            logits = forward(imgs, rots, trans, intrins, post_rots, post_trans)
        metrics = masked_eval_metrics(logits, binimgs, valid, pos_weight)
        return metrics if reduce is None else reduce(metrics)

    return eval_step


def make_predict_step(model, device="cuda", forward=None):
    """Returns ``predict(state, inputs) -> logits (B, outC, X, Y)``;
    ``forward`` as in ``make_train_step``."""
    dev = resolve_device(device)
    forward = forward or model

    def predict(state, inputs):
        model.eval()
        with torch.no_grad():
            return forward(*to_device(inputs, dev))

    return predict
