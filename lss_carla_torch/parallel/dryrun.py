"""Dry runs of the parallel modes on the CPU, with gloo ranks: the port's
counterpart of ``__graft_entry__.py::dryrun_multichip`` and
``scripts/multihost_dryrun.py``.

``dryrun_multichip(n)`` spawns ``n`` ranks on this host and runs one
train step of each flavour at tiny shapes, data parallel over all ``n``,
camera parallel over ``(n / 2, 2)`` and BEV-grid parallel over ``(n / 2,
2)``, and prints the losses.

The command line plays a multi-host launch on one machine: it starts
``--nodes x --ranks_per_node`` processes with the environment a launcher
(``torchrun``) gives each rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``GROUP_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` on localhost), ranks
numbered node by node, so the cam groups of ``--mesh camera`` and the
grid groups of ``--mesh grid`` (2 ranks, consecutive) stay inside a node and only the data all-reduce crosses
nodes, the deployment layout. Each rank loads its own rows, takes two
steps, and the parent checks that every rank ends with the same loss and
bit-equal parameters:

    python -m lss_carla_torch.parallel.dryrun --nodes 2 --ranks_per_node 2
    python -m lss_carla_torch.parallel.dryrun --mesh camera
    python -m lss_carla_torch.parallel.dryrun --mesh grid
    python -m lss_carla_torch.parallel.dryrun --accum 2
    python -m lss_carla_torch.parallel.dryrun --cli

``--cli`` drives ``train(multihost=True)`` itself on a fixture: sharded
loaders, validation, rank-0 checkpoints, a resume, and a SIGTERM sent to
rank 1 alone, after which every rank stops at the same step.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.parallel.camera import make_camera_sharded_train_step
from lss_carla_torch.parallel.grid import (make_grid_sharded_train_step,
                                           shard_batch_grid)
from lss_carla_torch.parallel.mesh import (init_process, make_mesh,
                                           make_mesh_2d, make_mesh_grid,
                                           shard_batch, state_digest)
from lss_carla_torch.parallel.step import make_sharded_train_step
from lss_carla_torch.training.state import create_train_state

FLAVOURS = ("data", "camera", "grid")


def flavour_step(flavour: str, model, world: int):
    """(mesh, train step, rows of a global batch) of one flavour over
    ``world`` ranks: data over all, camera and grid over (world / 2, 2)."""
    if flavour == "data":
        mesh = make_mesh(world)
        return mesh, make_sharded_train_step(model, mesh), \
            lambda b: shard_batch(mesh, b)
    if flavour == "camera":
        mesh = make_mesh_2d(world // 2, 2)
        return mesh, make_camera_sharded_train_step(model, mesh), \
            lambda b: shard_batch(mesh, b)
    mesh = make_mesh_grid(world // 2, 2)
    return mesh, make_grid_sharded_train_step(model, mesh), \
        lambda b: shard_batch_grid(mesh, b)


def tiny_model(variant: str = "b0", seed: int = 0):
    """JAX's dry-run shapes: 32 x 64 images, 4 depth bins, a 16 x 16 grid."""
    grid = GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                    zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 36.0, 8.0))
    aug = DataAugConf(H=64, W=128, final_dim=(32, 64))
    return compile_model(grid, aug, outC=1, variant=variant, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def example_batch(B: int, seed: int = 0, N: int = 6, fH: int = 32,
                  fW: int = 64):
    """``__graft_entry__._example_inputs`` plus sparse labels: numpy."""
    rng = np.random.default_rng(seed)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, N, 3, 3)).copy()
    intrins = eye.copy()
    intrins[..., 0, 0] = intrins[..., 1, 1] = 0.5 * fW
    intrins[..., 0, 2], intrins[..., 1, 2] = fW / 2, fH / 2
    zeros = np.zeros((B, N, 3), np.float32)
    imgs = rng.normal(size=(B, N, 3, fH, fW)).astype(np.float32)
    binimgs = (rng.uniform(size=(B, 1, 16, 16)) < 0.1).astype(np.float32)
    return (imgs, eye.copy(), zeros, intrins, eye.copy(), zeros.copy(),
            binimgs)


def _multichip_rank(rank: int, n: int, tmp: str, flavours, variant: str):
    torch.set_num_threads(1)
    init_process(rank, n, f"file://{tmp}/store", "cpu")
    losses = {}
    try:
        batch = example_batch(n)
        for flavour in flavours:
            model = tiny_model(variant)
            _, step, rows = flavour_step(flavour, model, n)
            metrics = step(create_train_state(model), rows(batch))
            losses[flavour] = float(metrics["loss"])
            if not np.isfinite(losses[flavour]):
                raise RuntimeError(f"non-finite {flavour} loss {losses}")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(losses, os.path.join(tmp, "losses.pt"))


def dryrun_multichip(n_devices: int, flavours=FLAVOURS,
                     variant: str = "b0") -> dict:
    """One train step of each flavour over ``n_devices`` gloo ranks on the
    CPU (``n_devices`` even, for the (n / 2, 2) camera and grid meshes);
    returns and prints {flavour: loss}."""
    unknown = set(flavours) - set(FLAVOURS)
    if unknown:
        raise ValueError(f"unknown flavours {sorted(unknown)}")
    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"dryrun_multichip needs an even n_devices >= 2 for "
                         f"the camera and grid meshes, got {n_devices}")
    tmp = tempfile.mkdtemp(prefix="lss_dryrun_")
    try:
        mp.start_processes(_multichip_rank,
                           args=(n_devices, tmp, tuple(flavours), variant),
                           nprocs=n_devices, start_method="spawn")
        losses = torch.load(os.path.join(tmp, "losses.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"dryrun_multichip({n_devices}): OK, " + ", ".join(
        f"{k}_mesh_loss={v:.4f}" for k, v in losses.items()), flush=True)
    return losses


# --- the multi-host launch -------------------------------------------------

def _steps_worker(mesh_kind: str, accum: int) -> None:
    """Two train steps on this rank's rows, then its loss and digest."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_process(rank, world, "env://", "cpu")
    model = tiny_model()
    state = create_train_state(model)
    if accum > 1:
        mesh = make_mesh()
        step = make_sharded_train_step(model, mesh, accum_steps=accum)
    else:
        mesh, step, rows = flavour_step(mesh_kind, model, world)
    for i in range(2):
        # every rank makes the same global batch; each keeps its rows (the
        # grid mode: one a rank)
        B = world if mesh_kind == "grid" else mesh.n_data
        micro = [example_batch(B, seed=100 * i + a) for a in range(accum)]
        batch = rows(micro[0]) if accum == 1 else shard_batch(
            mesh, tuple(np.stack(parts) for parts in zip(*micro)), axis=1)
        loss = float(step(state, batch)["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        print(f"[rank {rank}] step {i}: ranks {world} loss={loss:.6f}",
              flush=True)
    print(f"[rank {rank}] digest {state_digest(model)}", flush=True)
    dist.destroy_process_group()


def _cli_worker(dataroot: str, workdir: str) -> None:
    """``train(multihost=True)`` as one rank: train with a validation and
    checkpoints, resume, then a SIGTERM on rank 1 alone."""
    from lss_carla_torch.training.loop import train
    rank = int(os.environ["RANK"])
    kwargs = dict(multihost=True, H=64, W=128, final_dim=(32, 64),
                  xbound=(-50.0, 50.0, 6.25), ybound=(-50.0, 50.0, 6.25),
                  dbound=(4.0, 36.0, 8.0), bsz=4, nworkers=1, nepochs=1,
                  viz_step=0, iou_log_step=1, variant="slim", device="cpu")
    run = os.path.join(workdir, "run")
    out = train(dataroot, logdir=run, max_steps=2, val_step=2, save_step=2,
                **kwargs)
    assert out["counter"] == 2, out["counter"]
    out = train(dataroot, logdir=run, max_steps=4, val_step=0, save_step=0,
                resume=os.path.join(run, "ckpts"), **kwargs)
    assert out["counter"] == 4, out["counter"]
    preempt = os.path.join(workdir, "run_preempt")
    if rank == 1:
        def signal_once_training():
            log = os.path.join(preempt, "metrics.jsonl")
            while not (os.path.exists(log) and os.path.getsize(log)):
                time.sleep(0.1)
            os.kill(os.getpid(), signal.SIGTERM)
        threading.Thread(target=signal_once_training, daemon=True).start()
    out = train(dataroot, logdir=preempt, max_steps=200, val_step=0,
                save_step=0, **dict(kwargs, nepochs=50))
    print(f"[rank {rank}] preempt-synced at {out['counter']}", flush=True)
    print(f"[rank {rank}] digest {state_digest(out['state'].model)}",
          flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodes", type=int, default=2)
    p.add_argument("--ranks_per_node", type=int, default=2)
    p.add_argument("--mesh", default="data", choices=["data", "camera", "grid"])
    p.add_argument("--accum", type=int, default=1,
                   help="> 1: the data mesh's gradient-accumulation step")
    p.add_argument("--cli", action="store_true",
                   help="drive train(multihost=True) on a fixture")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds each rank may take")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    world = args.nodes * args.ranks_per_node
    if args.mesh != "data" and args.ranks_per_node % 2:
        p.error(f"--mesh {args.mesh} keeps its rank pairs inside a node: "
                "--ranks_per_node must be even")
    if args.accum > 1 and args.mesh != "data":
        p.error("--accum takes --mesh data")
    if args.worker:
        torch.set_num_threads(1)
        if args.cli:
            _cli_worker(os.path.join(args.workdir, "fixture"), args.workdir)
        else:
            _steps_worker(args.mesh, args.accum)
        return 0

    workdir = tempfile.mkdtemp(prefix="lss_multihost_")
    try:
        if args.cli:
            from lss_carla_torch.data.fixtures import generate_fixture
            generate_fixture(os.path.join(workdir, "fixture"), num_scenes=5,
                             samples_per_scene=4, H=64, W=128, grid=16)
        port = free_port()
        procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank % args.ranks_per_node),
                       LOCAL_WORLD_SIZE=str(args.ranks_per_node),
                       GROUP_RANK=str(rank // args.ranks_per_node),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            cmd = [sys.executable, "-m", "lss_carla_torch.parallel.dryrun",
                   "--worker", "--mesh", args.mesh, "--accum", str(args.accum),
                   "--nodes", str(args.nodes),
                   "--ranks_per_node", str(args.ranks_per_node),
                   "--workdir", workdir] + (["--cli"] if args.cli else [])
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outputs, failed = [], False
        deadline = time.monotonic() + args.timeout
        for proc in procs:
            try:
                out, _ = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for other in procs:
                    other.kill()
                out, _ = proc.communicate()
                failed = True
            outputs.append(out)
            failed |= proc.returncode != 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for rank, out in enumerate(outputs):
        print(f"--- rank {rank} ---\n{out[-3000:]}")
    if failed:
        print("MULTIHOST DRYRUN FAILED")
        return 1
    digests = {m for o in outputs for m in re.findall(r"digest (\w+)", o)}
    losses = {m for o in outputs for m in re.findall(r"step 1: .*loss=(\S+)", o)}
    if len(digests) != 1 or len(losses) > 1:
        print(f"MULTIHOST DRYRUN FAILED: the ranks diverged: digests "
              f"{digests}, last losses {losses}")
        return 1
    if args.cli:
        stops = {m for o in outputs
                 for m in re.findall(r"preempt-synced at (\d+)", o)}
        if "Resumed from step 2" not in outputs[0] or len(stops) != 1 \
                or "signal 15 received" not in outputs[1]:
            print(f"MULTIHOST CLI DRYRUN FAILED: stops {stops}")
            return 1
        print(f"MULTIHOST CLI DRYRUN OK: {args.nodes} nodes x "
              f"{args.ranks_per_node} ranks, train(multihost=True): sharded "
              f"loaders, validation, rank-0 checkpoints, a resume, SIGTERM on "
              f"rank 1 and every rank stopped at step {stops.pop()}, "
              f"replicas equal")
    else:
        print(f"MULTIHOST DRYRUN OK ({args.mesh} mesh"
              + (f", accum {args.accum}" if args.accum > 1 else "")
              + f"): {args.nodes} nodes x {args.ranks_per_node} ranks, "
              f"replicas equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
