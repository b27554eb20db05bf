"""Loss and IoU metric: counterpart of ``lss_carla_tpu/training/loss.py``
(reference ``src/tools.py:222-270``).

``bce_with_logits`` is torch ``BCEWithLogitsLoss(pos_weight=w)``: the mean
over all elements of ``w*y*softplus(-x) + (1-y)*softplus(x)``, in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bce_elementwise(logits: torch.Tensor, targets: torch.Tensor,
                     pos_weight) -> torch.Tensor:
    """Weighted BCE per element, f32.

    ``pos_weight`` is a scalar (the reference's) or a per-class vector of
    length C broadcast over the channel axis of (B, C, ...) inputs (torch's
    ``pos_weight=torch.tensor([...])``). The one source of the formula: the
    train loss and the masked validation metrics both call it."""
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    w = torch.as_tensor(pos_weight, dtype=torch.float32, device=logits.device)
    if w.dim() == 1:
        if logits.dim() < 2 or w.numel() != logits.shape[1]:
            raise ValueError(f"pos_weight has {w.numel()} entries; the "
                             f"logits {tuple(logits.shape)} have "
                             f"{logits.shape[1] if logits.dim() > 1 else 0}"
                             " channels on axis 1")
        w = w.reshape((1, -1) + (1,) * (logits.dim() - 2))
    elif w.dim() != 0:
        raise ValueError(f"pos_weight must be a scalar or a vector, got "
                         f"shape {tuple(w.shape)}")
    return (w * targets * F.softplus(-logits)
            + (1.0 - targets) * F.softplus(logits))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight=1.0) -> torch.Tensor:
    """Elementwise-mean weighted binary cross entropy on raw logits."""
    return _bce_elementwise(logits, targets, pos_weight).mean()


class SimpleLoss:
    """Callable mirroring the reference SimpleLoss (tools.py:222-229)."""

    def __init__(self, pos_weight):
        self.pos_weight = (float(pos_weight) if torch.as_tensor(pos_weight).dim() == 0
                           else tuple(float(w) for w in pos_weight))

    def __call__(self, ypred, ytgt):
        return bce_with_logits(ypred, ytgt, self.pos_weight)


def get_batch_iou_counts(logits: torch.Tensor, targets: torch.Tensor):
    """(intersect, union) pixel counts as f32 tensors on the logits'
    device; threshold logits > 0 (reference tools.py:232-240)."""
    pred = logits > 0
    tgt = targets.to(torch.bool)
    return ((pred & tgt).sum().to(torch.float32),
            (pred | tgt).sum().to(torch.float32))


def masked_eval_metrics(logits: torch.Tensor, targets: torch.Tensor,
                        valid: torch.Tensor, pos_weight) -> dict:
    """Per-batch eval accumulators with padded samples masked out.

    ``valid`` is (B,): 1 for real samples, 0 for the val loader's padding
    (``pad_last``). Returns {loss_sum, intersect, union, intersect_c,
    union_c, batch}: loss_sum is the sum of per-sample mean BCE (the
    reference's ``loss.item() * batch_size``, tools.py:259); the IoU counts
    take valid samples only, also per class (``*_c``, shape (outC,))."""
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    valid = valid.to(device=logits.device, dtype=torch.float32)
    B, C = logits.shape[0], logits.shape[1]
    per_sample = _bce_elementwise(logits, targets, pos_weight).reshape(B, -1).mean(1)
    pred = (logits > 0).reshape(B, C, -1)
    tgt = targets.to(torch.bool).reshape(B, C, -1)
    i_bc = (pred & tgt).sum(2).to(torch.float32) * valid[:, None]
    u_bc = (pred | tgt).sum(2).to(torch.float32) * valid[:, None]
    return {"loss_sum": (per_sample * valid).sum(),
            "intersect": i_bc.sum(), "union": u_bc.sum(),
            "intersect_c": i_bc.sum(0), "union_c": u_bc.sum(0),
            "batch": valid.sum()}


def get_batch_iou(logits, targets):
    """(intersect, union, iou) as floats, with the reference's union == 0
    -> iou 1.0 convention."""
    intersect, union = (float(v) for v in get_batch_iou_counts(logits, targets))
    return intersect, union, (intersect / union) if union > 0 else 1.0
