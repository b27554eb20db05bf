"""BEV-grid spatial parallelism over a 2-D ``(data, grid)`` mesh:
counterpart of ``lss_carla_tpu/parallel/grid.py``.

JAX writes this mode as one global-shape GSPMD program with two sharding
constraints and lets XLA's partitioner place the collectives. PyTorch has
no partitioner, so every collective here is written out; the program
computes what JAX's does, the unsharded single-device step:

* the lift (geometry, camera encoder, splat) runs batch-split over all
  ranks, (data x grid) jointly: rank r = d * n_grid + g lifts its
  ``bsz / n_devices`` rows, the rows the loader's shard r gives it;
* ``halo.pivot``, one all-to-all over the data row's grid group, turns
  the pooled BEV from batch-split to space-split: rank (d, g) gets every
  sample of row d, X slab g (its backward is the inverse exchange). The
  labels and the ``pad_last`` mask travel by the same exchange;
* the BEV encoder runs on the slab (``decode_slab``), its convolutions
  and upsamples through ``halo.GridAxis`` (row halos fetched from the
  neighbours);
* every BatchNorm, in the camera trunk as in the BEV encoder, normalises
  over the global batch: ``layers.SyncBatchNormFn`` over the world group,
  count-weighted (a slab may be empty), with its gradient. Every rank
  computes the same global moments, so the running stats agree without a
  reduction;
* the loss is the global mean: this rank's sum over its slab divided by
  the global element count. One packed all-reduce over the world sums the
  gradient parts, the loss and the IoU counts (``step.all_reduce_packed``),
  and the update runs on every rank on equal numbers.

Dropout: the BEV encoder's ``Dropout2d`` draws one value a (sample,
channel) from a stream keyed ``(seed, data row)``, drawn for all the row's
samples, so the grid ranks of a row apply the same mask to their slabs;
the camera encoder's dropout and the trunk's drop-connect draw from a
stream keyed by the lift rank. These are the port's own draws (JAX's
masks come from its own generator).

``fused_dw`` is refused in this mode, as JAX refuses it
(``training/loop.py::parallel_plan``), and so is ``remat``: the decode
here is not checkpointed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from lss_carla_torch.models.layers import batch_norm_group
from lss_carla_torch.parallel.halo import (GridAxis, gather_rows,
                                           gather_samples, pivot)
from lss_carla_torch.parallel.mesh import Mesh
from lss_carla_torch.parallel.step import (RngStream, all_reduce_packed,
                                           reduce_sums, stream_seed)
from lss_carla_torch.training.loss import (_bce_elementwise,
                                           get_batch_iou_counts)
from lss_carla_torch.training.state import ema_update
from lss_carla_torch.training.step import to_device


def grid_axis(mesh: Mesh) -> GridAxis:
    return GridAxis(mesh.grid_group, mesh.n_grid, mesh.grid_index)


def shard_batch_grid(mesh: Mesh, batch):
    """This rank's lift rows of a global batch: ``B / n_devices``
    consecutive rows of every entry, rank r's the r-th block (JAX's
    ``shard_batch_grid``; the loaders' shard r, ``shard_index=r,
    num_shards=n_devices``, is the process-local form)."""
    n = batch[0].shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} does not split over {mesh.size} ranks")
    k = n // mesh.size
    return tuple(x[mesh.rank * k:(mesh.rank + 1) * k] for x in batch)


def _conv(axis: GridAxis, m, x, n):
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return axis.conv2d(x, n, m.weight.to(x.dtype), bias, m.stride, m.padding)


def _block(axis: GridAxis, b, x, n):
    """``layers.BasicBlock.forward`` on a slab."""
    if b.downsample is None:
        identity = x
    else:
        identity, _ = _conv(axis, b.downsample[0], x, n)
        identity = b.downsample[1](identity)
    y, n = _conv(axis, b.conv1, x, n)
    y, n = _conv(axis, b.conv2, F.relu(b.bn1(y)), n)
    return F.relu(b.bn2(y) + identity), n


def _layer(axis: GridAxis, blocks, x, n):
    for b in blocks:
        x, n = _block(axis, b, x, n)
    return x, n


def decode_slab(enc, bev: torch.Tensor, n_rows: int, axis: GridAxis,
                training: bool) -> torch.Tensor:
    """``BevEncode.forward`` on this rank's X slab of the pooled BEV
    (B, X slab, Y, C) of an ``n_rows``-row grid -> logits (B, outC, X
    slab, Y), with the module's own parameters."""
    x = bev.permute(0, 3, 1, 2).to(enc.compute_dtype)
    x, n = _conv(axis, enc.conv1, x, n_rows)
    x = F.relu(enc.bn1(x))
    x1, n1 = _layer(axis, enc.layer1, x, n)
    x, n = _layer(axis, enc.layer3, *_layer(axis, enc.layer2, x1, n1))
    up, n = axis.upsample(x, n, enc.up1.scale)
    assert n == n1, (n, n1)  # the skip and the upsample are owned alike
    conv = enc.up1.conv
    x, n = _conv(axis, conv[0], torch.cat([x1, up], dim=1), n)
    x, n = _conv(axis, conv[3], F.relu(conv[1](x)), n)
    x = F.relu(conv[4](x))
    p = enc.dropout.p
    if training and p > 0:
        # Dropout2d: one draw a (sample, channel), whatever the slab
        keep = x.new_empty((x.shape[0], x.shape[1], 1, 1)).bernoulli_(1 - p)
        x = x * keep.div_(1 - p)
    upsample, conv, bn, _, head = enc.up2
    x, n = axis.upsample(x, n, upsample.scale)
    x, n = _conv(axis, conv, x, n)
    x, n = _conv(axis, head, F.relu(bn(x)).to(torch.float32), n)
    return x


def grid_forward(model, mesh: Mesh, seed: int = 0):
    """``forward(*inputs) -> logits``: this rank's lift rows in, this
    rank's slab (B_row, outC, X slab, Y) of its data row's logits out."""
    if getattr(model, "remat", False):
        raise ValueError("the BEV-grid mode does not rematerialise: build "
                         "the model with remat=False")
    axis = grid_axis(mesh)
    lift = RngStream(stream_seed(seed, "grid-lift", mesh.rank), mesh.device)
    decode = RngStream(stream_seed(seed, "grid-decode", mesh.data_index),
                       mesh.device)
    n_rows = int(model.nx[0])

    def forward(*inputs):
        with batch_norm_group(model, dist.group.WORLD):
            with lift:
                bev = model.get_voxels(*inputs)
            bev = pivot(axis, bev, 1)
            with decode:
                return decode_slab(model.bevencode, bev, n_rows, axis,
                                   model.training)

    return forward


def make_grid_sharded_predict(model, mesh: Mesh):
    """``predict(state, inputs) -> logits (B_row, outC, X, Y)``: this
    rank's lift rows in; the logits of its data row's samples out, the
    slabs gathered from the row's grid ranks (every rank of the row gets
    them all). At small batch the big-grid low-latency serving path: the
    decode splits spatially."""
    forward = grid_forward(model, mesh)
    axis, n_rows = grid_axis(mesh), int(model.nx[0])

    def predict(state, inputs):
        model.eval()
        with torch.no_grad():
            slab = forward(*to_device(inputs, mesh.device))
            return gather_rows(axis, slab, n_rows)

    return predict


def _targets(axis: GridAxis, binimgs: torch.Tensor) -> torch.Tensor:
    return pivot(axis, binimgs.to(torch.float32), 2)


def make_grid_sharded_train_step(model, mesh: Mesh, pos_weight=2.13,
                                 ema_decay: float = 0.0, seed: int = 0):
    """``train_step(state, batch) -> metrics``: the contract of the
    data-parallel step (``parallel/step.py``; no accumulation, as in JAX),
    ``batch`` this rank's lift rows (``shard_batch_grid``). Numerically the
    unsharded single-device step on the global batch: global-batch BN, the
    global mean loss; metrics {loss, intersect, union} global, and
    ``grad_norm`` the global gradient's."""
    forward = grid_forward(model, mesh, seed)
    axis, n_rows = grid_axis(mesh), int(model.nx[0])

    def train_step(state, batch):
        batch = to_device(batch[:7], mesh.device)
        model.train()
        state.optimizer.zero_grad()
        logits = forward(*batch[:6])
        targets = _targets(axis, batch[6])
        count = (mesh.n_data * targets.shape[0] * targets.shape[1] * n_rows
                 * targets.shape[3])
        loss = _bce_elementwise(logits, targets, pos_weight).sum() / count
        loss.backward()
        counts = torch.stack(get_batch_iou_counts(logits.detach(), targets))
        params = state.optimizer.params
        for q in params:
            if q.grad is None:  # equal packs on every rank
                q.grad = torch.zeros_like(q)
        loss = loss.detach().reshape(1)
        all_reduce_packed([[q.grad for q in params], [loss], [counts]],
                          [1.0, 1.0, 1.0], mesh.world)
        grad_norm = state.optimizer.step(state.step)
        state.step += 1
        if ema_decay > 0:
            ema_update(state, ema_decay)
        return {"loss": loss[0], "intersect": counts[0], "union": counts[1],
                "grad_norm": grad_norm}

    return train_step


def grid_eval_metrics(logits, targets, valid, pos_weight, n_rows: int,
                      count_batch: bool) -> dict:
    """``loss.masked_eval_metrics`` of one slab: every sum is this slab's
    part of the data row's (the per-sample loss divided by the sample's
    whole element count), and ``batch`` counts on one grid rank of the
    row (``count_batch``), so a sum over all ranks gives the global
    accumulators."""
    valid = valid.to(device=logits.device, dtype=torch.float32)
    B, C = logits.shape[:2]
    per = _bce_elementwise(logits, targets, pos_weight).reshape(B, -1).sum(1)
    per = per / (C * n_rows * logits.shape[3])
    pred = (logits > 0).reshape(B, C, -1)
    tgt = targets.to(torch.bool).reshape(B, C, -1)
    i_bc = (pred & tgt).sum(2).to(torch.float32) * valid[:, None]
    u_bc = (pred | tgt).sum(2).to(torch.float32) * valid[:, None]
    return {"loss_sum": (per * valid).sum(), "intersect": i_bc.sum(),
            "union": u_bc.sum(), "intersect_c": i_bc.sum(0),
            "union_c": u_bc.sum(0),
            "batch": valid.sum() * float(count_batch)}


def make_grid_sharded_eval_step(model, mesh: Mesh, pos_weight=2.13):
    """``eval_step(state, batch) -> metrics``: this rank's lift rows (with
    the ``pad_last`` validity mask as an 8th entry); the masked
    accumulators of the global batch, summed over all ranks."""
    forward = grid_forward(model, mesh)
    axis, n_rows = grid_axis(mesh), int(model.nx[0])

    def eval_step(state, batch):
        batch = to_device(batch, mesh.device)
        valid = batch[7] if len(batch) > 7 else \
            torch.ones(batch[0].shape[0], device=mesh.device)
        model.eval()
        with torch.no_grad():
            logits = forward(*batch[:6])
            targets = _targets(axis, batch[6])
            valid = gather_samples(axis, valid.to(torch.float32))
        m = grid_eval_metrics(logits, targets, valid, pos_weight, n_rows,
                              mesh.grid_index == 0)
        return reduce_sums(m, mesh.world)

    return eval_step


def check_plan(n_devices: int, grid_devices: int, nx0: int,
               bsz: int) -> None:
    """JAX's checks of the grid keywords (``lss_carla_tpu/training/
    loop.py:242-254``)."""
    if n_devices % grid_devices:
        raise ValueError(f"n_devices={n_devices} must be divisible by "
                         f"grid_devices={grid_devices}")
    if nx0 % grid_devices:
        raise ValueError(f"grid X dim {nx0} must be divisible by "
                         f"grid_devices={grid_devices} (the BEV X axis "
                         "shards evenly over the grid axis)")
    if bsz % n_devices:
        raise ValueError(f"bsz={bsz} must be divisible by "
                         f"n_devices={n_devices}: the lift stage shards "
                         "the batch over the (data x grid) mesh jointly")

