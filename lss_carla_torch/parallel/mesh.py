"""Process groups for the parallel modes: counterpart of
``lss_carla_tpu/parallel/mesh.py`` (and of ``make_mesh_2d`` in
``parallel/camera.py`` and ``make_mesh_grid`` in ``parallel/grid.py``).

In JAX one process drives many devices, and a ``Mesh`` names their axes
inside one program. In PyTorch every device is a rank and every rank is a
process: a rank owns one device (``cuda:<local rank>``, or the CPU), holds
a full replica of the model, and talks to the others through
``torch.distributed`` collectives. ``Mesh`` below is that mapping: the
rank's place on a 1-D ``("data",)`` or 2-D ``("data", "cam")`` grid and
the process groups along each axis.

Ranks lie row-major on the grid, ``rank = d * n_cam + c``, as JAX reshapes
its device list (``camera.py:59-66``). The cam groups are then runs of
consecutive ranks, so when a launcher numbers the ranks host by host the
camera all-reduce stays inside a host and only the data all-reduce
crosses hosts: ``scripts/multihost_dryrun.py``'s deployment layout.

Backends: NCCL for CUDA tensors, gloo for CPU tensors (gloo also takes
CUDA tensors, through host copies: ``chip_smoke.py`` runs several gloo
ranks on one card that way, since NCCL refuses two ranks on one device).
Besides its backend's groups every mesh keeps a gloo group over all ranks
for host-side agreement (``any``, ``check_replicated``), which waits on no
device work.

The groups are made with ``new_group`` on every rank in the same order.
``init_device_mesh`` would bind the backend to the device type, and the
gloo-on-CUDA ranks above are outside that.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# every collective and barrier waits this long for its peers (as JAX's
# process_barrier does): one rank's cold nvcc build or cuDNN search may
# keep the others waiting for minutes
PROCESS_TIMEOUT = datetime.timedelta(minutes=30)


def init_process(rank: int, world_size: int, init_method: str, device,
                 backend: Optional[str] = None) -> None:
    """Join the default process group as ``rank`` of ``world_size``, bound
    to ``device`` (made current where it is a CUDA device). ``init_method``
    is ``file://<path>`` (a FileStore: no port) or ``tcp://host:port`` or
    ``env://``. ``backend`` defaults to NCCL on CUDA, gloo on the CPU."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=PROCESS_TIMEOUT,
                            **kw)


def launcher_env() -> dict:
    """The rank, world size and local rank a launcher (``torchrun``, or
    ``parallel/dryrun.py``) put in the environment: the counterpart of
    what ``jax.distributed.initialize()`` reads. Raises naming what is
    missing."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"multihost needs a launcher's environment "
                           f"(torchrun sets it); missing {missing}")
    return {"rank": int(os.environ["RANK"]),
            "world_size": int(os.environ["WORLD_SIZE"]),
            "local_rank": int(os.environ.get("LOCAL_RANK", 0))}


def local_rank() -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK``
    where a launcher set it, else the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


@dataclasses.dataclass
class Mesh:
    """This rank's place on an ``(n_data, n_cam)`` grid of ranks and the
    groups along its axes: ``data_group`` holds the ranks of this rank's
    cam column (those that differ in data rows only), ``cam_group`` those
    of its data row, ``host_group`` all ranks on gloo. A ``(data, grid)``
    mesh (``make_mesh_grid``) is the same layout with its second axis
    named ``grid``: ``n_grid``, ``grid_group`` and ``grid_index`` are
    ``n_cam``, ``cam_group`` and ``cam_index``."""
    n_data: int
    n_cam: int
    rank: int
    device: torch.device
    data_group: object
    cam_group: object
    host_group: object
    axis: str = "cam"

    world = None  # every rank: the default group

    @property
    def n_grid(self) -> int:
        return self.n_cam

    @property
    def grid_group(self):
        return self.cam_group

    @property
    def grid_index(self) -> int:
        return self.cam_index

    @property
    def size(self) -> int:
        return self.n_data * self.n_cam

    @property
    def data_index(self) -> int:
        return self.rank // self.n_cam

    @property
    def cam_index(self) -> int:
        return self.rank % self.n_cam

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank, on the host group (no device work), up to
        ``PROCESS_TIMEOUT``: JAX's ``process_barrier``."""
        dist.barrier(group=self.host_group)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a MAX
        all-reduce on the host group)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())


def make_mesh_2d(n_data: int, n_cam: int, device=None) -> Mesh:
    """The ``(data, cam)`` mesh over the ranks of the default group, which
    must number ``n_data * n_cam``; ``device`` is this rank's (default:
    the current CUDA device under NCCL, else the CPU). Every rank must
    call it, in the same order as its other group-making calls."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_cam != world:
        raise ValueError(f"a ({n_data}, {n_cam}) mesh needs {n_data * n_cam} "
                         f"ranks, the process group has {world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    data_group = cam_group = None
    for c in range(n_cam):  # every rank makes every group, in this order
        g = dist.new_group([d * n_cam + c for d in range(n_data)],
                           timeout=PROCESS_TIMEOUT)
        if rank % n_cam == c:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_cam + c for c in range(n_cam)],
                           timeout=PROCESS_TIMEOUT)
        if rank // n_cam == d:
            cam_group = g
    host_group = None if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=PROCESS_TIMEOUT)
    return Mesh(n_data, n_cam, rank, torch.device(device), data_group,
                cam_group, host_group)


def make_mesh_grid(n_data: int, n_grid: int, device=None) -> Mesh:
    """The ``(data, grid)`` mesh of the BEV-grid mode
    (``parallel/grid.py``): ``make_mesh_2d``'s layout, ranks row-major
    (``rank = d * n_grid + g``, as JAX's ``make_mesh_grid`` reshapes its
    devices), the grid group a data row's ranks."""
    return dataclasses.replace(make_mesh_2d(n_data, n_grid, device),
                               axis="grid")


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D data-parallel mesh over the default group's ranks
    (``n_devices``, where given, must be their number)."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, the process group has "
                         f"{world} ranks")
    return make_mesh_2d(world, 1, device)


# --- replication ---------------------------------------------------------

def _state_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    return list(module.parameters()) + list(module.buffers())


def _broadcast_flat(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Broadcast ``tensors`` from ``src`` in place, one collective a dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        parts = torch.split(flat, [t.numel() for t in group])
        torch._foreach_copy_(group, [p.view_as(t) for p, t in zip(parts, group)])


def state_digest(module: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes, in order."""
    h = hashlib.sha256()
    for t in _state_tensors(module):
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_replicated(module: torch.nn.Module, mesh: Mesh) -> str:
    """Raise unless every rank's parameters and buffers are bit-equal;
    returns the common digest."""
    digests = [None] * mesh.size
    dist.all_gather_object(digests, state_digest(module), group=mesh.host_group)
    if len(set(digests)) != 1:
        raise RuntimeError(f"the replicas differ: digests by rank {digests}")
    return digests[0]


def replicate(module: torch.nn.Module, mesh: Mesh) -> str:
    """Make every rank's parameters and buffers rank 0's (a broadcast),
    then check that they are bit-equal. Returns the digest."""
    with torch.no_grad():
        _broadcast_flat(_state_tensors(module))
    return check_replicated(module, mesh)


# --- batches -------------------------------------------------------------

def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """The rows of a global batch that this rank's data index owns:
    ``B / n_data`` consecutive rows along ``axis`` (1 for the
    ``(accum_steps, B, ...)`` stacks of gradient accumulation). Every
    camera stays: a camera rank takes its own in the step. The loaders'
    ``shard_index``/``num_shards`` give each rank these rows directly (the
    "process-local" form)."""
    def rows(x):
        n = x.shape[axis]
        if n % mesh.n_data:
            raise ValueError(f"batch axis {n} does not split over "
                             f"{mesh.n_data} data ranks")
        k = n // mesh.n_data
        return x.narrow(axis, mesh.data_index * k, k) if torch.is_tensor(x) \
            else x.take(range(mesh.data_index * k, (mesh.data_index + 1) * k),
                        axis=axis)
    return tuple(rows(x) for x in batch)


def local_cameras(mesh: Mesh, inputs):
    """This cam rank's ``N / n_cam`` consecutive cameras of the six
    camera-indexed inputs (axis 1 of each)."""
    n = inputs[0].shape[1]
    if n % mesh.n_cam:
        raise ValueError(f"{n} cameras do not split over {mesh.n_cam} cam "
                         "ranks")
    k = n // mesh.n_cam
    return tuple(x.narrow(1, mesh.cam_index * k, k) for x in inputs)
