"""Build, bind and launch the CUDA splat kernels (``csrc/splat.cu``).

They replace ``lss_carla_tpu/ops/splat_pallas.py::_splat_kernel``. The
source is compiled with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``, on first use
(``ops/_nvcc.py``).

``splat_forward`` routes by dtype, to the faster kernel of each on the
H100 (PERF.md, PR 10):

* bf16: the segment kernel (``segments_forward``). It writes every row of
  the (B, S, C) output once, in bf16, and keeps no accumulator in device
  memory: no zero fill, no f32 buffer, no cast, one device activity a
  call. Each slot's points are summed in f32 in point order, from 0, and
  rounded once: the plain version's arithmetic
  (``ops/library.py::splat_reference`` on the CPU), so two calls give the
  same bits, and so does the plain version on the CPU. ``plan_splat`` is
  its host-side plan (segments of ``SEG_SLOTS`` slots, tiles of 256-point
  rounds, chunks of ``CHUNK_POINTS`` points, the scratch); the wrapper
  allocates that scratch with the torch caching allocator, once per
  (device, stream), grown as needed, and once per call under a CUDA
  graph's capture, from the graph's pool.
* f32: the tile kernel (``tiles_forward``): run sums added with float4
  atomics into the output, which the wrapper zero-fills (two device
  activities a call). The atomic sums arrive in run-to-run order, so f32
  outputs can move by a few ulps of a slot's sum from call to call.

Importing this module needs neither ``nvcc`` nor a GPU; only ``build()``
and the forwards do. They take CUDA tensors only: a CPU tensor goes to
the plain version in the caller, never here.

``launches`` counts ``splat_forward``'s calls that launched a kernel (one
a call), and ``launches_by_dtype`` the same by the features' dtype;
``captured_by_dtype`` counts the calls made while a CUDA graph was being
captured on the current stream, which recorded the kernel into the graph
and launched nothing (the graph's replays launch it and count it in
``utils/graph.py::replayed``). ``chip_smoke.py`` sets
them to 0 (``reset_launches``) before it drives a path and reads them
after.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from lss_carla_torch.ops._nvcc import NvccLibrary

launches = 0          # kernel launches in this process (plain int)
launches_by_dtype = {"float32": 0, "bfloat16": 0}  # the same, by input dtype
captured_by_dtype = {"float32": 0, "bfloat16": 0}  # recorded into a graph

TILE = 176            # points a block of the f32 tile kernel sorts (kTile)
SEG_SLOTS = 256       # slots a segment, one block's output rows (kSegSlots)
CHUNK_POINTS = 512    # points a chunk of a heavy segment (kChunkPoints)
CACHE = 2048          # bucket slots and grouped points kept in shared memory (kCache)
STAGE_BYTES = 48 * 1024  # an unsplit segment's feature rows, staged (kStageBytes)
THREADS = 256         # a block; a round of the count phase, one point a thread (kThreads)
WARPS = THREADS // 32
# most (item, segment, tile) entries of the count table: above it the
# tiles grow by whole rounds (only for very large S)
TABLE_BUDGET = 1 << 22
SMEM_LIMIT = 227 * 1024  # shared memory one block may have


@dataclass(frozen=True)
class SplatPlan:
    nseg: int          # segments an item: ceil(S / SEG_SLOTS)
    rounds: int        # 256-point rounds a tile
    tiles: int         # tiles an item
    chunk_cap: int     # capacity of the queue of chunks
    work_ints: int     # int32 scratch: queue, segment starts and counts,
                       # ranks, bucket, grouped points, the bucket's slots
    table_ints: int    # int32 scratch left at 0: 4 counters + the table
    smem_bytes: int    # the segment kernel's shared memory a block


def plan_splat(B: int, P: int, S: int) -> SplatPlan:
    """The segment kernel's plan for (B, P) points on S slots, as
    ``csrc/splat.cu`` lays it out (``lss_splat_segments_forward`` checks
    the scratch sizes). Tiles are one 256-point round, or several where
    the (item, segment, tile) table would pass ``TABLE_BUDGET``."""
    nseg = -(-S // SEG_SLOTS)
    segs = B * nseg
    tiles_1 = -(-P // THREADS)  # tiles an item at one round a tile
    rounds = -(-tiles_1 // min(tiles_1, max(1, TABLE_BUDGET // segs)))
    tiles = -(-P // (rounds * THREADS))
    chunk_cap = 2 * B * P // CHUNK_POINTS + 1
    static = (4 * (2 * WARPS * 32 + WARPS + WARPS * SEG_SLOTS + 4 * SEG_SLOTS
                   + CACHE + WARPS + 4) + CACHE)
    return SplatPlan(nseg, rounds, tiles, chunk_cap,
                     2 * chunk_cap + 2 * segs + 3 * B * P + -(-B * P // 4),
                     4 + segs * tiles, static + STAGE_BYTES)


def _declare(lib: ctypes.CDLL) -> None:
    lib.lss_splat_tiles_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.lss_splat_tiles_forward.restype = ctypes.c_int
    lib.lss_splat_segments_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p]
    lib.lss_splat_segments_forward.restype = ctypes.c_int


LIB = NvccLibrary("splat", _declare)
build = LIB.build


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# per (device, stream): the work scratch (written before it is read) and
# the table (zeros when made; every call leaves it at 0). Calls on one
# stream run in order, so they may share them. A call under a stream
# capture takes scratch of its own from the graph's pool, which its
# replays use and no other call can grow, free or share.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, plan: SplatPlan):
    key = (device.index, stream)
    capturing = torch.cuda.is_current_stream_capturing()
    work, table = (None, None) if capturing else _SCRATCH.get(key, (None, None))
    if work is None or work.numel() < plan.work_ints:
        work = torch.empty(plan.work_ints, dtype=torch.int32, device=device)
    if table is None or table.numel() < plan.table_ints:
        table = torch.zeros(plan.table_ints, dtype=torch.int32, device=device)
    if not capturing:
        _SCRATCH[key] = (work, table)
    return work, table


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_dtype`` and
    ``captured_by_dtype`` count to 0."""
    global launches
    launches = 0
    for counts in (launches_by_dtype, captured_by_dtype):
        for key in counts:
            counts[key] = 0


def _count(dtype: torch.dtype) -> None:
    """Count one call that ran the kernel: a launch, or, under a stream
    capture, a kernel recorded into the graph."""
    global launches
    key = str(dtype).removeprefix("torch.")
    if torch.cuda.is_current_stream_capturing():
        captured_by_dtype[key] += 1
    else:
        launches += 1
        launches_by_dtype[key] += 1


def _check(pts: torch.Tensor, ids: torch.Tensor, num_slots: int) -> int:
    if not (pts.is_cuda and ids.is_cuda):
        raise ValueError("splat_forward takes CUDA tensors; CPU tensors go "
                         "to ops.splat.splat_reference")
    if pts.device != ids.device:
        raise ValueError(f"pts on {pts.device}, ids on {ids.device}")
    if pts.dtype not in _DTYPES:
        raise TypeError(f"pts dtype {pts.dtype}: float32 or bfloat16 only")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids dtype {ids.dtype}: int32 only")
    if pts.dim() != 3 or ids.shape != pts.shape[:2]:
        raise ValueError(f"pts {tuple(pts.shape)} / ids {tuple(ids.shape)}: "
                         "want (B, P, C) and (B, P)")
    if not (pts.is_contiguous() and ids.is_contiguous()):
        raise ValueError("pts and ids must be contiguous")
    num_slots = int(num_slots)
    if not 0 < num_slots < 2 ** 31:
        raise ValueError(f"num_slots must be in [1, 2^31), got {num_slots}")
    if pts.shape[0] * pts.shape[1] >= 2 ** 31:
        raise ValueError(f"{pts.shape[0] * pts.shape[1]} points: the kernels "
                         "number them with int32")
    return num_slots


def tiles_forward(pts: torch.Tensor, ids: torch.Tensor,
                  num_slots: int) -> torch.Tensor:
    """The f32 route: PR 3's tile kernel adding into a zero-filled f32
    output (two device activities: the fill and the kernel). f32 only."""
    num_slots = _check(pts, ids, num_slots)
    if pts.dtype != torch.float32:
        raise TypeError(f"tiles_forward takes float32, got {pts.dtype}")
    B, P, C = pts.shape
    out = torch.zeros((B, num_slots, C), dtype=pts.dtype, device=pts.device)
    if pts.numel() == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = lib.lss_splat_tiles_forward(pts.data_ptr(), ids.data_ptr(),
                                         out.data_ptr(), B, P, C, num_slots,
                                         stream)
    LIB.check(rc, "splat tile kernel")
    return out


def segments_forward(pts: torch.Tensor, ids: torch.Tensor,
                     num_slots: int) -> torch.Tensor:
    """The bf16 route, and the segment kernel in either dtype: every output
    row written once, each slot summed in f32 in point order (one device
    activity)."""
    num_slots = _check(pts, ids, num_slots)
    B, P, C = pts.shape
    if pts.numel() == 0:
        return torch.zeros((B, num_slots, C), dtype=pts.dtype, device=pts.device)
    out = torch.empty((B, num_slots, C), dtype=pts.dtype, device=pts.device)
    plan = plan_splat(B, P, num_slots)
    lib = LIB.load()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        work, table = _scratch(pts.device, stream, plan)
        rc = lib.lss_splat_segments_forward(
            pts.data_ptr(), _DTYPES[pts.dtype], ids.data_ptr(), out.data_ptr(),
            B, P, C, num_slots, plan.rounds, work.data_ptr(), work.numel(),
            table.data_ptr(), table.numel(), stream)
    LIB.check(rc, "splat segment kernel")
    return out


def splat_forward(pts: torch.Tensor, ids: torch.Tensor,
                  num_slots: int) -> torch.Tensor:
    """(B, P, C) f32/bf16 points + (B, P) int32 ids -> (B, num_slots, C) in
    the input dtype. Ids outside [0, num_slots) are dropped. f32 takes the
    tile kernel, bf16 the segment kernel (the faster of the two in each
    dtype on the H100, PERF.md). CUDA tensors only; raises on anything the
    kernels do not take. One count a call (``_count``)."""
    _check(pts, ids, num_slots)
    route = tiles_forward if pts.dtype == torch.float32 else segments_forward
    out = route(pts, ids, num_slots)
    if pts.numel() == 0:
        return out
    _count(pts.dtype)
    return out
