"""Data-parallel train and eval steps: counterpart of
``lss_carla_tpu/parallel/step.py``.

Each rank runs the single-device step (``training/step.py``) on its rows
of the global batch: forward and backward with BN normalising by the
rank's own batch statistics. Then ONE all-reduce over the data group
carries, packed into one f32 buffer, the gradients (summed over the
rank's microbatches first when accumulating: one collective a step, not
one a microbatch), the BN running stats the forward just updated, the
loss and the IoU counts. The gradients, stats and loss come back as means
over the ranks (JAX's ``pmean``), the counts as sums (``psum``). The
optax-rule clip, Adam and EMA then run on every rank on equal numbers, so
the replicas stay bit-equal. Equal shards make the mean of the ranks'
mean losses the global mean: the loaders drop or pad to a multiple of the
global batch.

The collectives are explicit, not ``DistributedDataParallel``: DDP's
buffer broadcast would overwrite the running stats JAX averages, and its
bucket hooks would interleave with the camera mode's backward all-reduce.

Dropout and drop-connect draw from torch's global generator; each rank
runs its forwards inside an ``RngStream`` of its own, seeded from
``(seed, rank)``, so masks differ between ranks (JAX folds the axis index
into its key, ``step.py:48``) and the global generator is left alone.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import torch
import torch.distributed as dist

from lss_carla_torch.parallel.mesh import Mesh
from lss_carla_torch.training.step import make_eval_step, make_train_step


def stream_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named ``keys`` of run ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class RngStream:
    """A random stream for torch's global generator: inside ``with
    stream:`` the CPU generator and ``device``'s draw from this stream,
    whose state is kept on exit and resumed at the next entry; outside,
    the global generator is as it was (``torch.random.fork_rng``)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=self._cuda):
            torch.manual_seed(seed)
            self._save()

    def _save(self):
        self._cpu_state = torch.get_rng_state()
        if self._cuda:
            self._cuda_state = torch.cuda.get_rng_state(self.device)

    def __enter__(self):
        self._fork = torch.random.fork_rng(devices=self._cuda)
        self._fork.__enter__()
        torch.set_rng_state(self._cpu_state)
        if self._cuda:
            torch.cuda.set_rng_state(self._cuda_state, self.device)
        return self

    def __exit__(self, *exc):
        self._save()
        return self._fork.__exit__(*exc)


def running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """Every BN's running mean and variance, in a fixed order."""
    return [b for name, b in model.named_buffers()
            if name.endswith((".running_mean", ".running_var"))]


def all_reduce_packed(parts: Sequence[Sequence[torch.Tensor]],
                      scales: Sequence[float], group) -> None:
    """One SUM all-reduce over ``group`` of every tensor in ``parts``,
    packed into one f32 buffer; each tensor of ``parts[i]`` comes back in
    place, multiplied by ``scales[i]``."""
    flat_parts = [t for part in parts for t in part]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in flat_parts])
    dist.all_reduce(flat, group=group)
    sizes = [sum(t.numel() for t in part) for part in parts]
    for chunk, scale in zip(torch.split(flat, sizes), scales):
        if scale != 1.0:
            chunk.mul_(scale)
    views = [v.view_as(t) for v, t in zip(
        torch.split(flat, [t.numel() for t in flat_parts]), flat_parts)]
    with torch.no_grad():
        torch._foreach_copy_(flat_parts, views)


def reduce_train(state, metrics: dict, group, n_mean: int,
                 n_count: int = 1) -> dict:
    """The step's one all-reduce over ``group``: gradients, BN running
    stats and the loss divided by ``n_mean`` (means), the IoU counts by
    ``n_count`` (1: sums). Returns the reduced metrics."""
    grads = [p.grad for p in state.optimizer.params if p.grad is not None]
    loss = metrics["loss"].reshape(1).to(torch.float32)
    counts = torch.stack([metrics["intersect"], metrics["union"]]).to(
        torch.float32)
    all_reduce_packed([grads, running_stats(state.model), [loss], [counts]],
                      [1.0 / n_mean] * 3 + [1.0 / n_count], group)
    return {**metrics, "loss": loss[0], "intersect": counts[0],
            "union": counts[1]}


def reduce_sums(metrics: dict, group) -> dict:
    """Every metric summed over ``group`` (the eval accumulators)."""
    out = {k: v.to(torch.float32).clone() for k, v in metrics.items()}
    all_reduce_packed([list(out.values())], [1.0], group)
    return out


def make_sharded_train_step(model, mesh: Mesh, pos_weight=2.13,
                            ema_decay: float = 0.0, accum_steps: int = 1,
                            seed: int = 0):
    """Returns ``train_step(state, batch) -> metrics`` (the single-device
    step's contract); ``batch`` is this rank's rows (``shard_batch`` of
    the global batch, or the loader's shard), with a leading
    (accum_steps, ...) axis when accumulating. metrics {loss, intersect,
    union} are global; ``grad_norm`` is the averaged gradients'."""
    stream = RngStream(stream_seed(seed, "data", mesh.rank), mesh.device)

    def forward(*inputs):
        with stream:
            return model(*inputs)

    return make_train_step(
        model, pos_weight, accum_steps=accum_steps, ema_decay=ema_decay,
        device=mesh.device, forward=forward,
        reduce=lambda state, m: reduce_train(state, m, mesh.data_group,
                                             mesh.n_data))


def make_sharded_eval_step(model, mesh: Mesh, pos_weight=2.13):
    """Returns ``eval_step(state, batch) -> metrics``: this rank's rows
    (with the ``pad_last`` validity mask as an 8th entry), the masked
    accumulators summed over the data group, so the val set's samples
    count once each (JAX ``step.py:80-109``)."""
    return make_eval_step(model, pos_weight, device=mesh.device,
                          reduce=lambda m: reduce_sums(m, mesh.data_group))
