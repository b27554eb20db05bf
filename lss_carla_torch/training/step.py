"""Train, eval and predict steps: counterpart of
``lss_carla_tpu/training/step.py`` (single device).

One train step is the reference hot loop: geometry -> CamEncode -> lift ->
splat -> BevEncode -> weighted BCE -> backward -> clip -> Adam, eagerly on
the model's device. Metrics come back as device scalars and are synced
only where the caller reads them. Every factory takes ``device`` ("cuda"
unless the caller asks for the CPU; no GPU raises) and moves each batch
there.
"""

from __future__ import annotations

import torch

from lss_carla_torch.training.loss import (bce_with_logits,
                                           get_batch_iou_counts,
                                           masked_eval_metrics)
from lss_carla_torch.utils.backend import resolve_device


def to_device(batch, device: torch.device):
    """Each array of ``batch`` as a tensor on ``device`` (no copy where it
    is there already)."""
    return tuple(torch.as_tensor(a).to(device, non_blocking=True)
                 for a in batch)


def make_train_step(model, pos_weight=2.13, accum_steps: int = 1,
                    device="cuda"):
    """Returns ``train_step(state, batch) -> metrics``.

    ``batch`` is the reference 7-tuple (imgs, rots, trans, intrins,
    post_rots, post_trans, binimgs). metrics = {loss, intersect, union,
    grad_norm} as device scalars, from the logits before the update."""
    if accum_steps > 1:
        raise NotImplementedError(
            "gradient accumulation (accum_steps > 1) is not ported yet "
            "(ROADMAP.md A4, gradient accumulation)")
    dev = resolve_device(device)

    def train_step(state, batch):
        imgs, rots, trans, intrins, post_rots, post_trans, binimgs = \
            to_device(batch[:7], dev)
        model.train()
        state.optimizer.zero_grad()
        logits = model(imgs, rots, trans, intrins, post_rots, post_trans)
        loss = bce_with_logits(logits, binimgs, pos_weight)
        loss.backward()
        grad_norm = state.optimizer.step(state.step)
        state.step += 1
        intersect, union = get_batch_iou_counts(logits.detach(), binimgs)
        return {"loss": loss.detach(), "intersect": intersect,
                "union": union, "grad_norm": grad_norm}

    return train_step


def make_eval_step(model, pos_weight=2.13, device="cuda"):
    """Returns ``eval_step(state, batch) -> metrics`` for ``get_val_info``:
    {loss_sum, intersect, union, intersect_c, union_c, batch}. An 8th
    batch element is the val loader's (B,) validity mask (``pad_last``);
    padded samples count nowhere."""
    dev = resolve_device(device)

    def eval_step(state, batch):
        batch = to_device(batch, dev)
        imgs, rots, trans, intrins, post_rots, post_trans, binimgs = batch[:7]
        valid = batch[7] if len(batch) > 7 else \
            torch.ones(imgs.shape[0], device=dev)
        model.eval()
        with torch.no_grad():
            logits = model(imgs, rots, trans, intrins, post_rots, post_trans)
        return masked_eval_metrics(logits, binimgs, valid, pos_weight)

    return eval_step


def make_predict_step(model, device="cuda"):
    """Returns ``predict(state, inputs) -> logits (B, outC, X, Y)``."""
    dev = resolve_device(device)

    def predict(state, inputs):
        model.eval()
        with torch.no_grad():
            return model(*to_device(inputs, dev))

    return predict
