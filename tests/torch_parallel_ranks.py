"""The rank side of the parallel tests: workers that spawned gloo ranks
run on the CPU. JAX-free, so a rank imports torch and the port only; the
test files build the inputs (with JAX) and hand them over in a file.

Each rank joins a FileStore under the test's ``tmp_path`` (no TCP port:
the suite's workers run side by side), runs one torch thread, and writes
its result beside the store; ``run_ranks`` waits for all of them within
its own timeout, so a hung collective fails the test."""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.loader import DataLoader
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.parallel.camera import (camera_forward,
                                             make_camera_sharded_predict)
from lss_carla_torch.parallel.grid import (grid_axis,
                                           make_grid_sharded_eval_step,
                                           make_grid_sharded_predict,
                                           make_grid_sharded_train_step,
                                           shard_batch_grid)
from lss_carla_torch.parallel.mesh import (check_replicated, init_process,
                                           make_mesh, make_mesh_2d,
                                           make_mesh_grid, shard_batch,
                                           state_digest)
from lss_carla_torch.parallel.step import (make_sharded_eval_step,
                                           make_sharded_train_step,
                                           reduce_train)
from lss_carla_torch.training.bn_recal import recalibrate_bn
from lss_carla_torch.training import loop
from lss_carla_torch.training.loop import get_val_info
from lss_carla_torch.training.loss import bce_with_logits
from lss_carla_torch.training.state import create_train_state


def _entry(rank: int, n: int, tmp: str, worker: str) -> None:
    torch.set_num_threads(1)
    init_process(rank, n, f"file://{tmp}/store", "cpu")
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"),
                             weights_only=False)
        out = globals()[worker](rank, payload)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))


def run_ranks(tmp, n: int, worker: str, payload: dict,
              timeout: float = 120.0) -> list:
    """Run ``worker(rank, payload)`` on ``n`` spawned gloo ranks; returns
    their results by rank. Raises when a rank fails or the ranks take
    longer than ``timeout`` seconds."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    ctx = mp.start_processes(_entry, args=(n, tmp, worker), nprocs=n,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{worker} on {n} ranks took over {timeout} s")
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(n)]


def build(payload: dict, fused_dw: bool = False):
    """The slim model of the payload's weights, dropout off."""
    model = compile_model(GridConf.from_dict(payload["grid"]),
                          DataAugConf.from_dict(payload["aug"]),
                          variant="slim", fused_dw=fused_dw, device="cpu")
    model.load_state_dict(payload["state_dict"])
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


def tensors(batch):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in batch)


class Samples:
    """A map-style dataset over a list of sample tuples."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def data_parallel(rank: int, p: dict) -> dict:
    """One data-parallel step on this rank's half of the batch, without
    and with ``fused_dw`` (no clip, no weight decay: ``.grad`` keeps the
    averaged gradient), then the sharded validation of a ``pad_last`` set
    and the EMA's BN recalibration over this rank's rows, without and with
    ``fused_dw``."""
    mesh = make_mesh(2)
    out = {}
    for fused in (False, True):
        model = build(p, fused)
        state = create_train_state(model, weight_decay=0.0, max_grad_norm=0.0)
        step = make_sharded_train_step(model, mesh, p["pos_weight"])
        m = step(state, tensors(shard_batch(mesh, p["batch"])))
        check_replicated(model, mesh)
        out[fused] = {
            "loss": m["loss"].item(), "intersect": m["intersect"].item(),
            "union": m["union"].item(),
            "grads": {k: q.grad.clone() for k, q in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}
    loader = DataLoader(Samples(p["val"]), 1, pad_last=True, num_workers=0,
                        shard_index=mesh.data_index, num_shards=mesh.n_data)
    out["val"] = get_val_info(make_sharded_eval_step(build(p), mesh,
                                                     p["pos_weight"]),
                              None, loader)
    out["val_batches"] = len(loader)
    out["recal"] = {}
    for fused in (False, True):
        model = build(p, fused)
        recalibrate_bn(model, [tensors(shard_batch(mesh, p["batch"]))],
                       dist.group.WORLD)
        out["recal"][fused] = {
            k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}
    return out


def camera(rank: int, p: dict) -> dict:
    """The camera-parallel predict on a (data, cam) mesh; at data 1, also
    the eval-mode gradient of the loss, reduced as the train step reduces
    it (the mean over the world)."""
    mesh = make_mesh_2d(*p["mesh"])
    model = build(p)
    rows = tensors(shard_batch(mesh, p["batch"]))
    out = {"logits": make_camera_sharded_predict(model, mesh)(None, rows[:6]),
           "data_index": mesh.data_index}
    if p.get("grads"):
        model.eval()
        state = create_train_state(model)
        loss = bce_with_logits(camera_forward(model, mesh)(*rows[:6]),
                               rows[6], p["pos_weight"])
        loss.backward()
        metrics = {"loss": loss.detach(), "intersect": torch.tensor(0.0),
                   "union": torch.tensor(0.0)}
        reduce_train(state, metrics, mesh.world, mesh.size, mesh.n_cam)
        out["grads"] = {k: q.grad.clone() for k, q in model.named_parameters()}
    return out


def halo(rank: int, p: dict) -> dict:
    """The grid ops on this rank's slabs of each case's global input, on a
    (1, n) grid mesh: forward, and the backward of <out, cotangent>. Each
    case returns this rank's output slab, its input gradient and its
    weight-gradient part."""
    mesh = make_mesh_grid(1, p["n"])
    axis = grid_axis(mesh)
    out = []
    for case in p["cases"]:
        x, n = case["x"], case["x"].shape[2]
        lo, hi = axis.rows(n)
        slab = x[:, :, lo:hi].clone().requires_grad_()
        if "scale" in case:
            y, n_out = axis.upsample(slab, n, case["scale"])
            w = None
        else:
            w = case["w"].clone().requires_grad_()
            s, pad = case["stride"], case["padding"]
            y, n_out = axis.conv2d(slab, n, w, None, (s, s), (pad, pad))
        j0, j1 = axis.rows(n_out)
        (y * case["cot"][:, :, j0:j1]).sum().backward()
        out.append({"y": y.detach(), "dx": slab.grad,
                    "dw": None if w is None else w.grad})
    return out


def grid(rank: int, p: dict) -> dict:
    """The grid mode on a (data, grid) mesh, on this rank's lift rows: the
    predict, one train step (no clip, no weight decay: ``.grad`` keeps the
    summed gradient) on the batch and (``half``) one on a second batch,
    the sharded validation of a ``pad_last`` set, and (with ``dropout``)
    steps with dropout on after which the replicas are checked
    bit-equal."""
    mesh = make_mesh_grid(*p["mesh"])
    model = build(p)
    rows = tensors(shard_batch_grid(mesh, p["batch"]))
    out = {"logits": make_grid_sharded_predict(model, mesh)(None, rows[:6]),
           "data_index": mesh.data_index}
    for key, batch in (("step", p["batch"]), ("half_step", p.get("half"))):
        if batch is None:
            continue
        model = build(p)
        state = create_train_state(model, weight_decay=0.0, max_grad_norm=0.0)
        m = make_grid_sharded_train_step(model, mesh, p["pos_weight"])(
            state, tensors(shard_batch_grid(mesh, batch)))
        check_replicated(model, mesh)
        out[key] = {
            "loss": m["loss"].item(), "intersect": m["intersect"].item(),
            "union": m["union"].item(),
            "grads": {k: q.grad.clone() for k, q in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}
    loader = DataLoader(Samples(p["val"]), 1, pad_last=True, num_workers=0,
                        shard_index=mesh.rank, num_shards=mesh.size)
    out["val"] = get_val_info(make_grid_sharded_eval_step(
        build(p), mesh, p["pos_weight"]), None, loader)
    if p.get("dropout"):
        model = compile_model(GridConf.from_dict(p["grid"]),
                              DataAugConf.from_dict(p["aug"]),
                              variant="slim", device="cpu")
        state = create_train_state(model)
        step = make_grid_sharded_train_step(model, mesh, p["pos_weight"],
                                            seed=7)
        for i in range(2):
            step(state, tensors(shard_batch_grid(
                mesh, tuple(np.roll(a, i, 0) for a in p["batch"]))))
        out["digest"] = check_replicated(model, mesh)
    return out


def pretrained_train(rank: int, p: dict) -> dict:
    """``train(**p["kwargs"])`` as this rank of the group, recording the
    trunk's digest right after this rank's own merge of the file (before
    rank 0's weights are broadcast); returns it with the whole model's
    digest and the trunk's parameters at the end."""
    merged = []
    real = loop.merge_trunk_state_dict

    def merge(model, trunk_sd):
        real(model, trunk_sd)
        merged.append(state_digest(model.camencode.trunk))

    loop.merge_trunk_state_dict = merge
    model = loop.train(**p["kwargs"])["state"].model
    return {"merged": merged, "digest": state_digest(model),
            "trunk": {k: v.detach().clone()
                      for k, v in model.camencode.trunk.named_parameters()}}
