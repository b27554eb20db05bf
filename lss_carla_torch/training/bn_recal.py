"""BN recalibration for EMA validation and serving: counterpart of
``lss_carla_tpu/training/bn_recal.py``.

Averaged weights need BN statistics of their own activations: neither the
trained model's running stats nor an exponential average of them describes
the EMA model (the JAX module's docstring has the measurements). So before
each validation the EMA model runs train-mode forwards over the last few
training batches, and its running stats become the cumulative average of
the per-batch moments, as ``torch.optim.swa_utils.update_bn`` does.

The moments are read at each ``layers.BatchNorm2d`` through its
``update_running_stats``, where every train-mode batch moment arrives: the
plain BN's from ``torch.var_mean`` and the fused MBConv ``bn1``'s from the
depthwise kernel. PyTorch knows each BN's momentum, so the JAX module's
momentum recovery (two probe forwards) is not needed. Dropout and
drop-connect are live in these forwards, as in JAX.

With several ranks each holds its own rows of every batch; JAX's
recalibration runs over the global (sharded) batch, whose every BN
normalises with the global batch's moments. ``mean_over_ranks`` makes the
forwards do that: every BN combines the ranks' moments as sync-BN does
(``models/layers.py::BatchNorm2d.sync``), so each recorded moment is the
global batch's and every rank ends with the same stats.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn

from lss_carla_torch.models.layers import BatchNorm2d


@torch.no_grad()
def recalibrate_bn(model: nn.Module, batches: Iterable,
                   mean_over_ranks: Optional[Callable] = None) -> int:
    """Set every BN's running mean and variance of ``model`` to the mean,
    over ``batches``, of its train-mode batch moments, in place.

    ``batches``: tuples whose first six entries are the forward inputs
    (imgs, rots, trans, intrins, post_rots, post_trans), on the model's
    device. Returns the number of batches; with none, the running stats
    are left as they are (the JAX trainer then validates with the EMA'd
    stats). The model is left in eval mode. ``mean_over_ranks`` (a
    callable replacing a list of tensors, in place, by their means over
    the ranks): every rank passes its rows of the same number of equal
    batches, and gets the global batches' moments."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    sums = None
    n = 0
    try:
        for bn in bns:
            bn.moments, bn.sync = [], mean_over_ranks
        model.train()
        for batch in batches:
            model(*batch[:6])
            n += 1
        if n:
            sums = [torch.stack([torch.stack(m) for m in bn.moments]).sum(0)
                    for bn in bns]
    finally:
        for bn in bns:
            bn.moments = bn.sync = None
        model.eval()
    if n:
        for bn, s in zip(bns, sums):
            bn.running_mean.copy_(s[0] / n)
            bn.running_var.copy_(s[1] / n)
    return n
