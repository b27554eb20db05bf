"""Camera parallelism over a 2-D ``(data, cam)`` mesh: counterpart of
``lss_carla_tpu/parallel/camera.py``.

The splat is a sum over frustum points, and the points split by camera,
so the lift splits exactly: each cam rank runs ``get_geometry`` and the
camera encoder on its ``N / n_cam`` cameras and splats them into the full
(X, Y, nz * camC) grid (the splat kernel on the card sums the partial
BEV); one all-reduce over the cam group sums the partial BEVs; the decode
(``decode_bev``) runs on every cam rank, on the same BEV. Data rows
compose as in the data-parallel step.

The sum is ``AllReduceSum``, an autograd Function whose backward is an
all-reduce sum too (JAX's ``psum``, whose transpose is a ``psum``). Each
cam rank computes its own copy of the loss, so the cotangent reaching a
partial BEV is the sum of ``n_cam`` equal ones, and each cam rank's
camera-encoder gradient comes out ``n_cam`` times its cameras' part. The
mean over the cam group then gives the sum of the parts, the exact
gradient; the decode's gradients are equal on the cam ranks, where the
mean changes nothing. A mean over cam then data is a mean over the
world, so one all-reduce over all ranks carries the gradients, and with
them the BN running stats (the camera encoder's normalise over the
rank's own cameras, the decode's over its data row) and the loss
(JAX ``_reduce_grads``, ``_reduce_stats``, ``camera.py:135-155``). The
IoU counts of the replicated decode are summed over data only: their
world sum is divided by ``n_cam``, exactly for integer counts.

Dropout: the lift draws from a stream of its own for each (data, cam)
rank, the decode from one for each data row, equal on the cam ranks of
the row (a decode mask that differed between them would silently break
the replication; JAX ``camera.py:193-201``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lss_carla_torch.parallel.mesh import Mesh, local_cameras
from lss_carla_torch.parallel.step import (RngStream, reduce_sums,
                                           reduce_train, stream_seed)
from lss_carla_torch.training.step import (make_eval_step, make_predict_step,
                                           make_train_step)


class AllReduceSum(torch.autograd.Function):
    """``x`` summed over ``group``; the backward sums the cotangent over
    ``group`` too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def camera_forward(model, mesh: Mesh, seed: int = 0):
    """``forward(*inputs) -> logits``: this rank's rows with every camera
    in, this rank's cameras lifted and splatted, the partial BEVs summed
    over the cam group, the decode on the sum."""
    lift = RngStream(stream_seed(seed, "lift", mesh.data_index,
                                 mesh.cam_index), mesh.device)
    decode = RngStream(stream_seed(seed, "decode", mesh.data_index),
                       mesh.device)

    def forward(*inputs):
        with lift:
            partial = model.get_voxels(*local_cameras(mesh, inputs))
        bev = AllReduceSum.apply(partial, mesh.cam_group)
        with decode:
            return model.decode_bev(bev)

    return forward


def make_camera_sharded_predict(model, mesh: Mesh):
    """``predict(state, inputs) -> logits (B, outC, X, Y)`` for this rank's
    rows, equal on the cam ranks of a row: the low-latency serving path (at
    bsz 1 a (1, n) mesh splits the lift n ways for one BEV all-reduce)."""
    return make_predict_step(model, device=mesh.device,
                             forward=camera_forward(model, mesh))


def make_camera_sharded_train_step(model, mesh: Mesh, pos_weight=2.13,
                                   ema_decay: float = 0.0, seed: int = 0):
    """The (data, cam) train step; ``make_sharded_train_step``'s contract
    (no accumulation, as in JAX)."""
    return make_train_step(
        model, pos_weight, ema_decay=ema_decay, device=mesh.device,
        forward=camera_forward(model, mesh, seed),
        reduce=lambda state, m: reduce_train(state, m, mesh.world, mesh.size,
                                             mesh.n_cam))


def make_camera_sharded_eval_step(model, mesh: Mesh, pos_weight=2.13):
    """The (data, cam) eval step: the masked accumulators of this rank's
    rows (with the optional ``pad_last`` mask), summed over the data
    group."""
    return make_eval_step(model, pos_weight, device=mesh.device,
                          forward=camera_forward(model, mesh),
                          reduce=lambda m: reduce_sums(m, mesh.data_group))
