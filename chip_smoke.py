#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lss_carla_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing a line of its own; every check raises, so any failure
exits non-zero without the final result line:

1. card and build: the card's name and power limit (nvidia-smi), the nvcc
   builds of both kernels and the g++ build of the JPEG decoder from the
   sources in this checkout, all at once;
2. the splat kernel against its plain version (``splat_reference``) on the
   card, on seeded inputs with ~7 % of ids at the sentinel and NaN features
   at those points: (B 8, P 43,296, C 64, S 40,000) in f32 and in bf16, and
   S 160,000 in f32; at B0's bf16 bsz-8 shape on the bench's served ids
   (``lss_carla_torch.bench.build``'s model and inputs); then on the main
   path's own inputs (the model's lift and geometry at bsz 8) and its
   first 2 and 1 items (a grid-mode rank's rows). At every shape the
   segment kernel (bf16's route, also run on the f32 inputs beside the
   tile kernel) gives the same bits in two calls and the same bits as the
   plain version on the CPU; a call puts at most 2 activities on the
   card. The wrapper
   (queued on the device), the plain version and the library call (a
   zeroed buffer and ``index_add_`` in the input dtype: the same function
   in one PyTorch call, timed here only) are timed beside the byte bound,
   with the kernel's device time, its work items and the in-grid points a
   segment;
3. serving at full width: the B0 LSS model at the default config (6 x
   128 x 352 cameras, 41 depth bins, 200 x 200 grid) with seeded weights,
   exported with ``export_predict`` and served over HTTP by ``serve()``,
   once plain (bsz 1, f32 images) and once coalescing (bsz 8, uint8
   images, concurrent requests); responses are held against a direct
   ``load_predict`` call on the card, and the kernel's launch counter,
   zeroed just before, must have risen;
4. card against CPU at bsz 1 with TF32 off;
5. forward latency at bsz 1 and ms per sample at bsz 8, with the card's
   name and power limit;
6. where the device time goes at bsz 8 and bsz 1, TF32 off and on
   (torch.profiler): a reading for PERF.md, not a check;
7. the depthwise-conv + BN-moments kernel against its plain version
   (``dw_conv_stats_reference``) at the 16 depthwise shapes of the B0
   trunk at N 24 (bsz 4 x 6 cameras) in f32, and block 0 in bf16 (phase
   11 holds bf16 at B4's shapes): y, sum and sum of squares within a
   summation-order bound, and dx, dw through the autograd Function
   against the plain version's autograd.
   The kernel's device time (torch.profiler) stands beside the byte
   bound; the device time of the kernel, the plain version, cuDNN's
   depthwise conv alone (the nearest library call) and cuDNN's conv plus a
   ``var_mean`` pass, each queued back to back behind a sleep kernel, and
   the wrapper's back-to-back call time (CUDA events) beside them; each
   call must put exactly one activity on the card;
8. training at full width through the port's own ``train()``: B0 at the
   default config on a synthetic SimBEV fixture (224 x 480 sources), bsz 4,
   ``fused_dw``, 20 steps with a validation and a checkpoint every 10; the
   kernels' launch counters, zeroed just before, with what the train
   step's CUDA graph replayed (``issued``), must show 16 depthwise
   launches per train-mode forward and the splat; every logged loss is
   finite; the checkpoints exist, a resume from step 10 continues at 10,
   and ``model_best.pt`` is exported and answers one HTTP request;
9. one train step on the card (``fused_dw``: the kernel) against the same
   step on the CPU (the plain version), B0 at bsz 2, dropout and
   drop-connect 0, TF32 off: loss, gradients, the parameters after Adam
   and every BN's running stats; beside it, as a reading, the same step
   on the card through the kernels' plain versions;
10. train-step times (``train_step_ms_bsz8`` and bsz 4, ``fused_dw`` off
    and on, cuDNN TF32 off and on), the device idle share of phase 8's
    loop, and a torch.profiler breakdown of one bsz-4 train step with
    ``fused_dw`` off and on;
11. both kernels in bf16 at the stretch recipe's shapes
    (``configs/simbev_stretch.sh``: B4, a 400 x 400 grid at 0.25 m): the
    splat on the B4 model's own lift and ids at bsz 4 (S 160,000), and the
    depthwise kernel at each distinct shape of B4's 32 depthwise convs at
    N 24 (y, sum, sum of squares; dx, dw through the autograd Function),
    each against its plain version and timed beside its bound and the
    library call;
12. the stretch recipe through ``train()``: B4, 400 x 400, 4 classes,
    bf16, ``fused_dw``, cosine with warm-up, EMA 0.999 with BN
    recalibration, two microbatches of bsz 4 a step, on a synthetic
    fixture with 400 x 400 labels: the kernels' launch counters by dtype,
    zeroed just before, with the step graph's replays, show only bf16
    launches, 32 depthwise launches a
    train-mode forward (the recalibration's included) and the splat;
    losses finite, ``val/iou`` and ``val/iou_raw`` logged, checkpoints
    carry ``ema_state_dict``, a resume continues at the saved counter, and
    ``model_best.pt`` exported with ``--ema --compute_dtype bfloat16``
    answers one HTTP request with finite f32 logits;
13. bf16 against f32 on the card: the stretch model's bsz-1 logits in
    bf16 against the same weights in f32 (TF32 off) over several seeds,
    held to a limit fixed from those readings; bsz-1 forward latency;
    the bsz-4 B4 stretch step and the bsz-4 B0 default step in bf16,
    timed in turns against f32 with cuDNN TF32; the device idle share of
    phase 12's loop and a profile of the recipe's bf16 step (two
    microbatches), with the BEV ``up2`` conv's device time and launches;
14. the ResNet-18 trunk at full width (the flagship config): a bsz-8 uint8
    artifact served over HTTP against a direct ``load_predict`` call, card
    against CPU at bsz 1 (TF32 off), ms per sample at bsz 8; ``train()``
    20 steps at bsz 4 in f32 on phase 8's fixture with one train and one
    validation figure (their predictions, where matplotlib is absent),
    checkpoints, a resume, splat launches and no depthwise launch; the
    bsz-4 step (f32 + cuDNN TF32) in turns with B0's, each profiled
    (device activities a step, busy, idle share); ResNet-34 at bsz 1, card
    against CPU;
15. the explore tools on the card: ``eval_model_iou`` on phase 14's
    ``model_best.pt`` and on phase 12's (``--best --ema``, B4 bf16 at 400 x
    400, 4 classes) reproduces the ``val/loss`` and ``val/iou`` that
    ``train()`` logged at that step; ``splat_check`` on a fixture batch at
    full width (phase 8's B0 ``model_best.pt``, bsz 2), kernel against plain
    version; the predictions
    of ``viz_model_preds`` and the frustum points of ``lidar_check``, with
    their PNGs where matplotlib imports;
16. the watchdog and ``--supervise`` as a subprocess at reduced size (B0,
    32 x 64 images, a 16 x 16 grid): ``python -m lss_carla_torch.train
    --supervise 1 --watchdog_secs 5 --debug_stall_at 3 --save_step 2
    --max_steps 6``: the first child stalls at step 3, dumps its stacks
    and exits 42 about 10 s later; the second resumes from step 2 and
    ends at 6; the supervisor returns 0;
17. int8 serving (``ops/quant.py``): which shapes ``torch._int_mm`` takes
    on the card; the B0 model's int8 convs (their number equal to the
    gate's count from the block plan); a bsz-8 uint8 artifact exported
    with ``quantize`` served over HTTP against the live int8 model, with
    the splat kernel's launches; every int8 conv's int32 accumulator on
    the card equal to the CPU's bit for bit; card int8 against CPU int8 at
    bsz 1 over six seeds, B0 and B4 at 400 x 400 (whose SE convs take the
    padded rows); int8 against float on the card within JAX's bounds on
    the B0 model at its BN init (as JAX's test), with the randomised and
    phase 8's trained B0 as readings; B0 ms per sample at bsz 8 in f32,
    bf16 and int8, and the stretch B4 at bsz 4 in bf16 and int8, in turns;
18. ``python -m lss_carla_torch.bench --mode all --iters 5 --warmup 2`` as
    a child process: its lines relayed, three metrics under bench.py's
    names with finite positive values, the f32 step at bsz 8;
19. nuScenes at full width: a fixture from the port's generator (3 scenes
    x 6 samples x 6 cameras at 900 x 1600, lidar sweeps, a map), the
    original config (``configs.py::nuscenes_aug``: 5 of 6 cameras at 128 x
    352, resize 0.193-0.225, bottom crop 0-0.22, rotation +-5.4, flips)
    through ``train(dataset="nuscenes")``: B0, bsz 4, ``fused_dw``, cuDNN
    TF32, 20 steps, a validation and checkpoints; the kernels' counters,
    zeroed just before, show 16 depthwise launches a train forward and
    the splat; the median step; the decoder's counts (validation decodes
    natively only, no decode error anywhere); ``eval_model_iou`` on
    ``model_best.pt`` reproduces the logged validation; the predictions of
    ``viz_model_preds``, the map underlay's and ``lidar_check``'s compute
    parts; the splat against its plain version on the lift and ids of a
    5-camera train batch and a 6-camera val batch, and the depthwise
    kernel at the 16 B0 shapes at N 20 (phase 7's limits); one train step
    with ``fused_dw``, its launches counted;
20. the JPEG decoder on the card's host: its build (g++, the libjpeg it
    links) and the host CPU; the decoder against PIL on 32 fixture JPEGs
    (crop-only path exact, since both run Pillow's libjpeg; resize + flip
    path within one level); ``input_pipeline_images_per_sec`` with 8 threads,
    native and PIL in turns, on ``bench.py``'s default augmentation
    (crop-only) and the fast recipe's ``resize_lim 0.70 0.85`` (resize);
    the fast recipe's ``train()`` loop (B0 bsz 8, bf16, 4 loader threads,
    60 steps, 8 steps an epoch), native and PIL in four turns, each run's
    mean step over steps 21-60, and each side's idle share against the
    device busy time of a profile of the step alone;
21. the parallel modes (``lss_carla_torch/parallel``) at full width, B0
    default: NCCL refuses two ranks on one device, so (a) gloo ranks share
    cuda:0 and drive the parallel steps directly: 2 data-parallel ranks x
    bsz 2 (``fused_dw``, f32, TF32 off, dropout 0) against the step
    emulated in this process (each half's train-mode forward and backward
    in turn, gradients and running stats averaged) to phase 9's limits,
    then 3 steps with dropout on after which the replicas are bit-equal,
    and the EMA's BN recalibration across the 2 ranks (``fused_dw``: the
    depthwise kernel's sums summed over the ranks) against one process's
    over the whole batch, to phase 9's running-stats limit; the
    camera-parallel predict at (data 1, cam 2) and (1, 3) against the
    unsharded forward (``SERVE_TOL``), each rank's splat launches counted,
    and one (1, 2) train step against its emulation (each camera half
    lifted in train mode apart, the BEVs summed, one decode); (b) a
    one-rank NCCL group: the all-reduce leaves f32 and bf16 tensors bit
    for bit, inside the data-parallel step too, whose f32 result is held
    to the single-device step's by phase 9's limits (bf16 a reading).
    Gloo's step time is a reading only: it copies through the host.
22. the BEV-grid mode (``parallel/grid.py``, ``parallel/halo.py``) on gloo
    ranks that share cuda:0, as in phase 21: B0 at 200 x 200, f32, TF32
    off, bsz 4; the predict at (data, grid) (1, 2), (1, 4) and (2, 2)
    against the unsharded forward (``SERVE_TOL``); one train step (dropout
    0) at (1, 2) and (2, 2) against the single-device step on the whole
    batch, to phase 9's limits (no emulation: the grid step is that step);
    3 steps at (2, 2) with dropout on, after which the replicas are
    bit-equal; each rank's splat launches counted; the stretch model (B4,
    400 x 400, 4 classes, f32) through the grid predict at (1, 2) against
    its unsharded forward, each rank's peak memory beside the
    single-device forward's (a reading);
23. activation rematerialisation (``compile_model(remat=True)``): one B0
    step at bsz 4 (``fused_dw``, f32, TF32 off, dropout 0) with remat
    against the same step without, to phase 9's limits, every running
    stat updated once, 32 depthwise launches and 1 splat launch a step
    (16 and 1 without); the stretch step (B4 bf16, 400 x 400, bsz 4,
    ``fused_dw``) with remat off and on in turns: peak memory and step ms
    (readings);
24. the serving artifact as a ``torch.export`` program (``serving.py``,
    the kernels as ``lss::`` operators, ``ops/library.py``): B0 exported in
    f32 with the uint8 signature and in int8, both loaded and run in one
    fresh interpreter that imports no module of ``lss_carla_torch.models``
    (the splat launches counted there), its logits against the live model
    (``SERVE_TOL``); the f32 artifact served once over HTTP;
25. the pretrained trunk (``train(pretrained_trunk=...)``) on phase 8's
    fixture: a seeded ``efficientnet_pytorch``-named B0 ImageNet file
    with its head merged into the full-width B0 on the card (the trunk
    bit-equal to the file, every other tensor untouched), served card
    against CPU on uint8 images at phase 4's limit; ``train()`` from the
    file with
    ``fused_dw``, bsz 4, lr 0 and EMA for one step (trunk bit-equal to
    the file, the EMA within 1e-6 relative, 16 depthwise launches and the
    splat), then 3 steps at the default lr (finite losses); a resume from
    phase 8's step-10 checkpoint with the file, whose trunk is the
    checkpoint's;
26. BEVFusion's camera-only map segmentation at the ``bevfusion-seg-train``
    cell's widths (``compile_bevfusion``: Swin-T over 6 x 256 x 704, D 118
    at stride 8, a 256 x 256 lift grid, 200 x 200 x 6 out, bf16, bsz 4)
    through ``create_train_state`` (AdamW 2e-4, decay 0.01, clip 35) and
    ``make_train_step`` (the focal loss), 4 steps on the cell's batches
    (the rig at 900 x 1600 resized by 0.48 and cropped at (32, 176)): the
    first eager and captured, three replays. The launch counters, zeroed
    just before, with the graph's replays, show one bf16 splat launch a
    forward and no depthwise launch; the attention windows, 12 calls an
    eager forward, the capture's windows on each replay; losses finite.
    Then the splat on a train forward's own lifted features and voxel ids
    (7.97 M points, 80 channels, 65,536 slots) against its plain version,
    as phase 2 holds it (``check_splat``), and the replayed step profiled:
    12 ``fmha_cutlassF`` and 12 ``fmha_cutlassB`` launches a step, every
    block on SDPA's fused kernels.

The last three lines are the card's name and power limit (``card: ...``),
the kernels' JSON (name, route, source, TPU kernel replaced, launches on
the main paths, error, times, bound) and ``{"ok": true, "device":
{...}}``. Without a GPU, or without the package beside it, the script
fails before printing any of them.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
from PIL import Image

from kernel_compare import queued_ms
from lss_carla_torch import explore
from lss_carla_torch.bench import input_images_per_sec
from lss_carla_torch.configs import DataAugConf, GridConf, nuscenes_aug
from lss_carla_torch.data.augment import img_transform, sample_augmentation
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.data.fixtures_nuscenes import generate_nuscenes_fixture
from lss_carla_torch.data.loader import compile_data
from lss_carla_torch.data.nusc_maps import get_local_map
from lss_carla_torch.data.nuscenes import NuScenesDataset, compile_data_nuscenes
from lss_carla_torch.models import bevfusion as bevfusion_model
from lss_carla_torch.models.efficientnet import MBConvBlock, block_plan
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.native import fastimage
from lss_carla_torch.ops import mbconv_cuda, quant, splat_cuda, window_attention
from lss_carla_torch.ops.mbconv import (dw_conv_stats, dw_conv_stats_reference,
                                        same_pad)
from lss_carla_torch.ops.splat import splat_reference, voxel_indices
from lss_carla_torch.parallel import camera as pcamera
from lss_carla_torch.parallel import grid as pgrid
from lss_carla_torch.parallel import mesh as pmesh
from lss_carla_torch.parallel import step as pstep
from lss_carla_torch.server import serve
from lss_carla_torch.serving import INPUT_NAMES, export_predict, load_predict
from lss_carla_torch.serving import _main as export_cli
from lss_carla_torch.training import loop
from lss_carla_torch.training.bn_recal import recalibrate_bn
from lss_carla_torch.training.loop import train
from lss_carla_torch.training.loss import bce_with_logits
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils.backend import card_line
from lss_carla_torch.utils.convert import (imagenet_trunk_state_dict,
                                           merge_trunk_state_dict,
                                           reference_state_dict,
                                           synthetic_imagenet_state_dict,
                                           trunk_state_dict_from_checkpoint)
from lss_carla_torch.utils import graph as graph_counts

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores

# card vs card through the served path, f32 with TF32 off: the splat's
# atomic f32 sums arrive in another order on every run (a few ulps), and
# that difference propagates through the BEV encoder. (With cuDNN's TF32 it
# would flip 10-bit roundings and reach ~1e-2; the checks run without.)
SERVE_TOL = 1e-4           # x max(1, max |logit|), absolute
# card vs CPU, both f32 with TF32 off: conv algorithms and the splat sum in
# different orders over a 16-block trunk and an 11-conv BEV encoder
CPU_TOL = 1e-3             # x max(1, max |logit|), absolute


def reset_launches() -> None:
    splat_cuda.reset_launches()
    mbconv_cuda.reset_launches()
    graph_counts.reset_replayed()


def issued_by_dtype(kernel: str) -> dict:
    """{dtype: ``kernel``'s ("splat" or "dw_conv_stats") kernels issued on
    the card since ``reset_launches``}: what its wrapper launched and what
    CUDA graph replays (the train step's, a served artifact's) launched
    (each what its capture recorded, ``utils/graph.py::replayed``; the
    card tests hold those to the profiler's device activities)."""
    wrapper = {"splat": splat_cuda, "dw_conv_stats": mbconv_cuda}[kernel]
    return {k: v + graph_counts.replayed[kernel][k]
            for k, v in wrapper.launches_by_dtype.items()}


def issued(kernel: str) -> int:
    return sum(issued_by_dtype(kernel).values())


def replayed(kernel: str) -> int:
    return sum(graph_counts.replayed[kernel].values())


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The profile's device activity (kernels, copies, fills), without the
    device-side spans of user annotations (e.g. ``Optimizer.step``), which
    overlap the kernels inside them."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


# Kineto keeps only the device records whose timestamps fall inside the
# profiling window. On the H100 host these readings were taken on, a
# window's device timestamps, mapped onto the host clock, once strayed 125
# ms before the host events that launched them (PERF.md, PR 3), and
# unpadded windows of short calls came back without device time. Host
# sleeps at both ends keep the calls PROFILE_PAD_S from the edges. Records
# are still lost inside padded windows, from another cause, so
# device_profile retries and averages over the records kept. WINDOWS
# keeps, for each window, the first device record's start less the first
# host event's (launch latency plus any stray) and whether its records
# were whole, for the lines that phase 7 and the run end print.
PROFILE_PAD_S = 0.5
WINDOWS = []  # (offset ms or None when the window saw no device record, whole)


def profile_window(fn, n: int, **kw):
    """torch.profiler over n calls of ``fn``, padded as above."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return prof


def clock_offset_ms(prof):
    cuda = torch.autograd.DeviceType.CUDA
    starts = {True: [], False: []}
    for e in prof.events():
        if not getattr(e, "is_user_annotation", False):
            starts[e.device_type == cuda].append(e.time_range.start)
    if starts[True] and starts[False]:
        return (min(starts[True]) - min(starts[False])) / 1e3
    return None


def device_profile(fn, n: int = 20, windows: int = 5):
    """{device activity name: (device ms per call, activities per call)}
    of everything ``fn`` puts on the card (torch.profiler, over n calls
    after a warm-up). Unlike ``cuda_ms`` it leaves out the host's time to
    issue each call, which bounds a back-to-back loop of calls shorter than
    ~0.1 ms. A window with some of its activity records lost (a count that
    is not a multiple of n) or none is profiled again, up to ``windows`` in
    all. Where records were lost in all of them, the last window's mean
    time a record stands for each lost one; LOST_RECORDS counts such
    calls. None where no window saw device time (seen on that host after
    the phase-10 profiles): the caller's CUDA-event reading stands in and
    LOST_RECORDS counts it."""
    LOST_RECORDS[1] += 1
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = None
    for _ in range(windows):
        prof = profile_window(fn, n)
        events = [e for e in device_events(prof) if e.count > 0]
        if sum(e.self_device_time_total for e in events) <= 0:
            WINDOWS.append((None, False))
            continue
        per_call = {e.key: max(1, round(e.count / n)) for e in events}
        out = {e.key: (e.self_device_time_total / e.count / 1e3 * per_call[e.key],
                       per_call[e.key]) for e in events}
        whole = all(e.count == per_call[e.key] * n for e in events)
        WINDOWS.append((clock_offset_ms(prof), whole))
        if whole:
            return out
    LOST_RECORDS[0 if out is not None else 2] += 1
    return out


# device_profile calls: with records lost in all windows, in all, with no
# device time in any window
LOST_RECORDS = [0, 0, 0]


def profiler_note() -> str:
    """What torch.profiler kept in device_profile's windows so far."""
    off = sorted(o for o, _ in WINDOWS if o is not None) or [float("nan")]
    return (f"torch.profiler: {len(WINDOWS)} windows, "
            f"{sum(w for _, w in WINDOWS)} with whole records, "
            f"{sum(o is None for o, _ in WINDOWS)} without device time; records "
            f"lost in every window of {LOST_RECORDS[0]} of {LOST_RECORDS[1]} "
            f"profiled functions (their times take the mean a record), no "
            f"device time in any window of {LOST_RECORDS[2]} (CUDA events "
            f"stand in); first "
            f"device record less first host event: min {off[0]:.3f}, median "
            f"{off[len(off) // 2]:.3f}, max {off[-1]:.3f} ms (windows padded by "
            f"{PROFILE_PAD_S} s of host time at both ends)")


def splat_bound(pts, ids, num_slots):
    """(ms, bound_by): bytes this input needs -- every id, the features of
    in-grid points only, the dense output once -- over the memory rate,
    against its f32 adds over the f32 rate."""
    valid = int(((ids >= 0) & (ids < num_slots)).sum())
    C, item = pts.shape[-1], pts.element_size()
    nbytes = ids.numel() * 4 + valid * C * item + ids.shape[0] * num_slots * C * item
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = valid * C / F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def segment_points(ids, num_slots):
    """(most and mean in-grid points an (item, segment), work items): the
    splat kernel's segments of SEG_SLOTS slots, a segment of n > K points
    cut into ceil(n / K) chunks (ops/splat_cuda.py)."""
    B = ids.shape[0]
    R, K = splat_cuda.SEG_SLOTS, splat_cuda.CHUNK_POINTS
    nseg = -(-num_slots // R)
    valid = (ids >= 0) & (ids < num_slots)
    key = (torch.arange(B, device=ids.device)[:, None] * nseg + ids.long() // R)[valid]
    n = torch.bincount(key, minlength=B * nseg)
    chunks = torch.where(n > K, (n + K - 1) // K, torch.ones_like(n))
    return int(n.max()), float(n.float().mean()), int(chunks.sum())


def bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def check_splat(name, pts, ids, num_slots):
    """The dtype's route (``splat_forward``: the tile kernel in f32, the
    segment kernel in bf16) vs its plain version on the card; returns
    (max_abs_err, times).

    Tolerance against the plain version on the card: both sum each slot's
    n points in f32, in some order, so each is within (n-1) u sum|x| of
    the exact sum (u = 2^-24); they may differ by twice that. bf16 outputs
    round that f32 sum once more: plus one bf16 ulp (2^-8 relative).
    Sentinel points carry NaN features, so any that leaked into a slot
    would show. The segment kernel (on f32 inputs too, where it is timed
    beside the route) must give the same bits in two calls, and the same
    bits as the plain version on the CPU (index_add_ there adds in point
    order, the segment kernel's order). A call puts at most 2 activities
    on the card."""
    S, (B, P, C) = int(num_slots), pts.shape
    got = splat_cuda.splat_forward(pts, ids, S)
    again = splat_cuda.splat_forward(pts, ids, S)
    bf16 = pts.dtype == torch.bfloat16
    seg = got if bf16 else splat_cuda.segments_forward(pts, ids, S)
    seg_again = again if bf16 else splat_cuda.segments_forward(pts, ids, S)
    ref = splat_reference(pts, ids, S)
    torch.cuda.synchronize()
    ones = torch.ones_like(pts[..., :1], dtype=torch.float32)
    count = splat_reference(ones, ids, S)
    abs_sum = splat_reference(torch.nan_to_num(pts.float()).abs(), ids, S)
    bound = 2 * count.clamp(min=1) * 2.0 ** -24 * abs_sum + 1e-7
    if bf16:
        bound = bound + 2.0 ** -8 * ref.float().abs()
    for kernel, out in (("route", got), ("segment kernel", seg)):
        assert out.shape == ref.shape == (B, S, C)
        assert out.dtype == pts.dtype, (out.dtype, pts.dtype)
        assert torch.isfinite(out).all(), f"{name}: {kernel}: non-finite output"
        excess = ((out.float() - ref.float()).abs() - bound).max().item()
        assert excess <= 0, f"{name}: {kernel} vs plain exceeds the bound by {excess}"
    max_err = (got.float() - ref.float()).abs().max().item()
    repeat = (got.float() - again.float()).abs().max().item()
    assert torch.equal(bits(seg), bits(seg_again)), f"{name}: two calls differ"
    on_cpu = splat_reference(pts.cpu(), ids.cpu(), S)
    cpu_err = (seg.cpu().float() - on_cpu.float()).abs().max().item()
    assert torch.equal(bits(seg.cpu()), bits(on_cpu)), \
        f"{name}: segment kernel vs the plain version on the CPU: {cpu_err:.3e}"

    rows = torch.where((ids >= 0) & (ids < S), ids.long(), S)
    rows = (rows + torch.arange(B, device=ids.device)[:, None] * (S + 1)).reshape(-1)
    src = pts.reshape(-1, C)

    def library():  # the same function in one call: a zeroed buffer in
        # the input dtype, index_add_ in the input dtype
        return torch.zeros((B * (S + 1), C), dtype=pts.dtype,
                           device=pts.device).index_add_(0, rows, src)

    wrapper = lambda: splat_cuda.splat_forward(pts, ids, S)  # noqa: E731
    times = {
        "ms": queued_ms(wrapper),
        "plain_ms": cuda_ms(lambda: splat_reference(pts, ids, S)),
        "library_ms": cuda_ms(library),
    }
    times["bound_ms"], times["bound_by"] = splat_bound(pts, ids, S)
    if not bf16:  # the segment kernel on the same f32 inputs
        times["segments_ms"] = queued_ms(lambda: splat_cuda.segments_forward(pts, ids, S))
    events_ms = cuda_ms(wrapper)
    dev = device_profile(wrapper) or {}
    kernel_dev = sum(ms for key, (ms, _) in dev.items() if "splat_kernel" in key)
    activities = sum(c for _, c in dev.values())
    assert not dev or activities <= 2, f"{name}: {activities} device activities a call"
    most, mean, chunks = segment_points(ids, S)
    route = "segment kernel" if bf16 else "tile kernel"
    print(f"splat {name}: route {route}, max_abs_err {max_err:.3e} (within the "
          f"summation-order bound), two calls differ by {repeat:.3e}; segment "
          f"kernel: two calls bit-equal, vs the plain version on the CPU "
          f"{cpu_err:.3e} (bit-equal)"
          + ("" if bf16 else f", {times['segments_ms']:.4f} ms queued")
          + f"; wrapper {times['ms']:.4f} ms queued on the device "
          f"({events_ms:.4f} ms back to back by CUDA events, host issue "
          f"included), plain {times['plain_ms']:.4f} ms, library (zeros + "
          f"index_add_ in {str(pts.dtype)[6:]}) {times['library_ms']:.4f} ms, "
          f"{times['bound_by']} bound {times['bound_ms']:.4f} ms; kernel "
          + (f"{kernel_dev:.4f} ms device time (profiler), {activities:.0f} "
             f"device activities a call"
             if dev else "device time not measured (no profiler window saw "
             "a device record)")
          + f"; in-grid points a segment of {splat_cuda.SEG_SLOTS} slots: "
          f"max {most}, mean {mean:.1f}; {chunks} segment-kernel work items "
          f"(segments, those over {splat_cuda.CHUNK_POINTS} points cut into "
          f"chunks) of {B * -(-S // splat_cuda.SEG_SLOTS)} segments", flush=True)
    return max_err, times


def random_splat_inputs(gen, B, P, C, S, dtype, sentinel_share=0.07):
    pts = torch.randn(B, P, C, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(0, S, (B, P), generator=gen, device="cuda", dtype=torch.int32)
    at_sentinel = torch.rand(B, P, generator=gen, device="cuda") < sentinel_share
    ids[at_sentinel] = S
    pts[at_sentinel] = float("nan")
    return pts, ids


def rig(rng, B, ncams, final_dim):
    """A 6-camera surround rig at 1.5 m (yaw 0, +-55, +-110, 180 degrees),
    optical axes level, 70-degree horizontal field of view."""
    fH, fW = final_dim
    yaw = np.deg2rad([0, 55, 110, 180, -110, -55][:ncams])
    cam_to_ego = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rz = np.zeros((ncams, 3, 3), np.float32)
    rz[:, 0, 0], rz[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    rz[:, 1, 0], rz[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    rz[:, 2, 2] = 1
    rots = np.broadcast_to(rz @ cam_to_ego, (B, ncams, 3, 3)).copy()
    trans = rng.normal(0, 0.2, size=(B, ncams, 3)).astype(np.float32)
    trans[..., 2] += 1.5
    f = fW / 2 / np.tan(np.deg2rad(35))
    intrins = np.tile(np.eye(3, dtype=np.float32), (B, ncams, 1, 1))
    intrins[..., 0, 0] = intrins[..., 1, 1] = f
    intrins[..., 0, 2], intrins[..., 1, 2] = fW / 2, fH / 2
    post_rots = np.tile(np.eye(3, dtype=np.float32), (B, ncams, 1, 1))
    post_trans = np.zeros((B, ncams, 3), np.float32)
    return rots, trans, intrins, post_rots, post_trans


def inputs(rng, B, uint8, final_dim=(128, 352), ncams=6):
    """The six forward inputs as numpy: random images, the rig above."""
    fH, fW = final_dim
    imgs = (rng.integers(0, 256, size=(B, ncams, 3, fH, fW), dtype=np.uint8) if uint8
            else rng.normal(size=(B, ncams, 3, fH, fW)).astype(np.float32))
    return (imgs, *rig(rng, B, ncams, final_dim))


def randomize_bn(model, gen):
    """Non-trivial BN statistics and affine parameters, drawn from ``gen``,
    so eval mode is a real test of every normalisation."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.3 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))


def _npz(args) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **dict(zip(INPUT_NAMES, args)))
    return buf.getvalue()


def post(base, args) -> np.ndarray:
    req = urllib.request.Request(base + "/predict", data=_npz(args), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200, r.status
        return np.load(io.BytesIO(r.read()))["logits"]


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.read()


def assert_close(name, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{name}: non-finite logits"
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max |diff| {err} > {tol} x {scale}"
    return err, scale


class Running:
    """An HTTP server on an ephemeral port, in a thread, shut down on exit."""

    def __init__(self, httpd):
        self.httpd = httpd
        self.thread = threading.Thread(target=httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        close = getattr(self.httpd.service, "close", None)
        if close is not None:
            close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive(), "server thread did not stop"


def phase_serving(tmp, model, rng, device="cuda"):
    """Phase 3. Returns (bsz-1 artifact, bsz-8 artifact, kernel launches
    while serving, the bsz-8 inputs)."""
    path1, path8 = f"{tmp}/lss_bsz1.pt", f"{tmp}/lss_bsz8_u8.pt"
    export_predict(model, path1, bsz=1)
    export_predict(model, path8, bsz=8, uint8_images=True)
    fd = model.data_aug_conf.final_dim
    out_shape = (1, model.outC, *(int(n) for n in model.nx[:2]))
    single = [inputs(rng, 1, False, fd) for _ in range(3)]
    many = inputs(rng, 8, True, fd)
    multi = inputs(rng, 3, True, fd)
    responses = {}

    reset_launches()  # the main path starts here
    with Running(serve(path1, port=0, warmup_args=single[0], device=device)) as base:
        assert get(base, "/healthz")[0] == 200
        responses["single"] = [post(base, a) for a in single]
        stats1 = json.loads(get(base, "/stats")[1])
    httpd8 = serve(path8, port=0, warmup_args=many, coalesce=True,
                   flush_ms=50.0, device=device)
    with Running(httpd8) as base:
        assert get(base, "/healthz")[0] == 200
        results, errors = {}, []
        barrier = threading.Barrier(8)

        def client(i):
            try:
                barrier.wait(timeout=120)
                results[i] = post(base, tuple(a[i:i + 1] for a in many))
            except Exception as e:  # surfaced by the assert below
                errors.append((i, repr(e)))

        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        assert not errors and len(results) == 8, errors
        responses["multi"] = post(base, multi)
        stats8 = json.loads(get(base, "/stats")[1])
    launches = issued("splat")  # the main path ends here

    assert stats1["requests"] == 3, stats1
    assert stats8["requests"] == 9 and stats8["batches"] < 9, stats8
    assert launches > 0, "the served path never launched the splat kernel"

    predict1 = load_predict(path1, device=device)
    errs = []
    for a, got in zip(single, responses["single"]):
        assert got.shape == out_shape, got.shape
        errs.append(assert_close("single", got, predict1(*a).cpu().numpy(), SERVE_TOL))
    predict8 = load_predict(path8, device=device)
    want8 = predict8(*many).cpu().numpy()
    for i in range(8):
        assert results[i].shape == out_shape, results[i].shape
        errs.append(assert_close(f"coalesced {i}", results[i][0], want8[i], SERVE_TOL))
    pad = tuple(np.concatenate([a, np.repeat(a[-1:], 5, axis=0)]) for a in multi)
    want3 = predict8(*pad).cpu().numpy()[:3]
    assert responses["multi"].shape == (3, *out_shape[1:])
    errs.append(assert_close("3-sample", responses["multi"], want3, SERVE_TOL))
    worst = max(errs)
    print(f"serving: 3 plain requests (bsz 1, f32) + 8 concurrent and one "
          f"3-sample request coalesced (bsz 8, uint8) in {stats8['batches']} "
          f"batches; all finite; max |served - direct| "
          f"{worst[0]:.3e} (tolerance {SERVE_TOL} x {worst[1]:.3f}); logits "
          f"{out_shape[1:]}; "
          f"/healthz 200; /stats {stats1['requests']} + {stats8['requests']} "
          f"requests; splat kernel launches while serving: {launches}", flush=True)
    return path1, path8, launches, many


def _profile(fn, n: int, inference: bool):
    """(host wall ms per call with the profiler off, profiler over n
    calls, device busy ms per call, kernels sorted by device time)."""
    fn()  # warm: a changed TF32 setting picks new algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with torch.inference_mode() if inference else torch.enable_grad():
        prof = profile_window(fn, n, record_shapes=True)
    kernels = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    return wall_ms, prof, busy_ms, kernels


def _share(kernels, needle, n, busy_ms) -> str:
    ms = sum(e.self_device_time_total for e in kernels if needle in e.key) / 1e3 / n
    return f"{ms:.4f} ms ({100 * ms / busy_ms:.2f}% of busy)"


def _top(prof, kernels, n, k=6) -> str:
    cuda = torch.autograd.DeviceType.CUDA
    top_k = " | ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                       f" x{e.count // n}" for e in kernels[:k])
    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type != cuda and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    top_o = " | ".join(f"{e.key} {str(e.input_shapes)[:80]} "
                       f"{e.self_device_time_total / 1e3 / n:.3f} ms x{e.count // n}"
                       for e in ops[:k])
    return f"top kernels: {top_k}; top ops: {top_o}"


def profile_forward(fn, n: int = 5) -> str:
    """Per-forward wall time (host clock, profiler off), device busy time
    and idle share, the splat kernel's share, the kernels that take the
    most device time, and the aten ops (with input shapes) that launch
    them, over ``n`` calls."""
    try:
        wall_ms, prof, busy_ms, kernels = _profile(fn, n, inference=True)
        if busy_ms <= 0:
            return "not measured (the profiler saw no device time)"
        return (f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
                f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, splat kernel "
                f"{_share(kernels, 'splat_kernel', n, busy_ms)}; "
                f"{_top(prof, kernels, n)}")
    except Exception as e:  # the profiler is a reading, not a check
        return f"not measured ({type(e).__name__}: {e})"


def profile_train_step(fn, n: int, up2_shape) -> tuple:
    """(device busy ms per step or None, reading): as profile_forward, for
    a train step, with the depthwise kernel's share and the device time of
    the ``convolution_backward`` calls on the BEV ``up2`` conv's input
    ``up2_shape``."""
    try:
        wall_ms, prof, busy_ms, kernels = _profile(fn, n, inference=False)
        if busy_ms <= 0:
            return None, "not measured (the profiler saw no device time)"
        by_shape = prof.key_averages(group_by_input_shape=True)

        def on_up2(key):
            return [e for e in by_shape if e.key == key and list(up2_shape)
                    in [list(s) for s in e.input_shapes if s]]
        up2 = on_up2("aten::convolution_backward")
        up2_ms = sum(e.device_time_total for e in up2) / 1e3 / n
        fwd = on_up2("aten::cudnn_convolution")
        fwd_ms = sum(e.device_time_total for e in fwd) / 1e3 / n
        return busy_ms, (
            f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
            f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, device activities (kernels, "
            f"copies, fills) {sum(e.count for e in kernels) / n:.0f} a step, "
            f"dw_conv_stats kernel "
            f"{_share(kernels, 'dw_conv_stats_kernel', n, busy_ms)}, splat "
            f"kernel {_share(kernels, 'splat_kernel', n, busy_ms)}, BEV up2 "
            f"conv backward (input {tuple(up2_shape)}) {up2_ms:.3f} ms "
            f"({100 * up2_ms / busy_ms:.2f}% of busy, {sum(e.count for e in up2) // n}"
            f" calls), forward {fwd_ms:.3f} ms ({sum(e.count for e in fwd) // n} "
            f"calls); {_top(prof, kernels, n, k=8)}")
    except Exception as e:  # the profiler is a reading, not a check
        return None, f"not measured ({type(e).__name__}: {e})"


# --- phase 7: the depthwise conv + BN moments kernel -------------------

def dw_shapes(N: int = 24, H: int = 64, W: int = 176):
    """(block, k, s, (N, C, H, W)) of the B0 trunk's 16 depthwise convs,
    from the stem's output (6 cameras at 128 x 352 -> 64 x 176)."""
    out = []
    for i, a in enumerate(block_plan("b0")):
        out.append((i, a["kernel"], a["stride"],
                     (N, a["cin"] * a["expand"], H, W)))
        H, W = -(-H // a["stride"]), -(-W // a["stride"])
    return out


def dw_bound(x, k, s):
    """(ms, bound_by): x read once, y written once, the weights and the
    two moment vectors, over the memory rate, against 2 k^2 + 3 f32
    operations an output over the f32 rate."""
    N, C, H, W = x.shape
    outs = N * C * -(-H // s) * -(-W // s)
    nbytes = (x.numel() + outs) * x.element_size() + C * k * k * 4 + 2 * C * 4
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = outs * (2 * k * k + 3) / F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_dw(name, x, w, s, grads: bool):
    """The kernel vs its plain version on the card; returns (max |dy|,
    times).

    Tolerances: both sum each output's k^2 taps in f32 in some order, so
    they differ by at most 2 k^2 u sum|x w| (u = 2^-24); a bf16 y rounds
    once more (plus one bf16 ulp, 2^-8 relative). The moments sum the
    n = N Ho Wo f32 values (squares) in other orders: 2 n u sum|y| (sum
    y^2). The backward runs the same cuDNN transposes on both sides and
    differs only through y in the 2 y dsumsq term: 1e-4 of the largest
    entry of dx and of dw. In bf16 both sides run the Function's bf16
    backward, one after the kernel's forward and one after the plain
    version's (``plain_versions``); a y one bf16 ulp apart can flip the
    bf16 rounding of dy + 2 y dsumsq: 2^-7 of the largest entry."""
    k, C = w.shape[-1], x.shape[1]
    y, s1, s2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    ry, r1, r2 = dw_conv_stats_reference(x, w, s)
    y32 = F.conv2d(same_pad(x.float(), k, s), w.to(x.dtype).float(),
                   stride=s, groups=C)
    absconv = F.conv2d(same_pad(x.float().abs(), k, s),
                       w.to(x.dtype).float().abs(), stride=s, groups=C)
    torch.cuda.synchronize()
    assert y.shape == ry.shape and y.dtype == x.dtype, (name, y.shape, y.dtype)
    assert torch.isfinite(y).all() and torch.isfinite(s1).all() \
        and torch.isfinite(s2).all(), f"{name}: non-finite output"
    u = 2.0 ** -24
    bound = 2 * k * k * u * absconv + 1e-6
    if x.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * ry.float().abs()
    err = (y.float() - ry.float()).abs()
    assert (err <= bound).all(), f"{name}: y exceeds the bound by {(err - bound).max().item()}"
    n = y32.numel() // C
    e1 = ((s1 - r1).abs() - (2 * n * u * y32.abs().sum((0, 2, 3)) + 1e-6)).max().item()
    e2 = ((s2 - r2).abs() - (2 * n * u * r2 + 1e-6)).max().item()
    assert e1 <= 0 and e2 <= 0, f"{name}: moments exceed the bound ({e1}, {e2})"
    y2, t1, t2 = mbconv_cuda.dw_conv_stats_forward(x, w, s)
    assert torch.equal(y, y2) and torch.equal(s1, t1) and torch.equal(s2, t2), \
        f"{name}: not bit-reproducible"
    rel_s = ((s1 - r1).abs() / r1.abs().clamp(min=1e-6)).max().item()
    note = f"sum rel err {rel_s:.2e}"
    if grads:
        f32 = x.dtype == torch.float32
        r = torch.randn(y.shape, device=x.device, dtype=torch.float32)
        got, want = [], []
        for plain, out in ((False, got), (True, want)):
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            fn = dw_conv_stats_reference if plain and f32 else dw_conv_stats
            with plain_versions(plain and not f32):
                ya, sa, ssa = fn(xa, wa, s)
                ((ya.float() * r).sum() + 0.3 * sa.sum() + 1e-3 * ssa.sum()).backward()
            out += [xa.grad, wa.grad]
        for g, ref, what in zip(got, want, ("dx", "dw")):
            assert g.dtype == ref.dtype, (what, g.dtype, ref.dtype)
            gerr = (g.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            limit = 1e-4 if f32 else 2.0 ** -7
            assert gerr <= limit * scale, f"{name}: {what} off by {gerr} (scale {scale})"
            note += f", {what} {gerr / scale:.1e} of max"
    xp, wc = same_pad(x, k, s), w.to(x.dtype)
    kernel = lambda: mbconv_cuda.dw_conv_stats_forward(x, w, s)  # noqa: E731
    dev = device_profile(kernel)
    if dev is not None:
        activities = sum(c for _, c in dev.values())
        assert activities == 1, f"{name}: {dev} device activities a call, want 1"
    plan = mbconv_cuda.plan_tiles(*x.shape, k, s)
    times = {
        "plain_ms": queued_ms(lambda: dw_conv_stats_reference(x, w, s)),
        "library_ms": queued_ms(lambda: F.conv2d(xp, wc, stride=s, groups=C)),
        "conv_var_mean_ms": queued_ms(lambda: torch.var_mean(
            F.conv2d(xp, wc, stride=s, groups=C).float(), dim=(0, 2, 3))),
        "call_ms": cuda_ms(kernel),
        "queued_ms": queued_ms(kernel),
    }
    times["ms"] = (sum(ms for ms, _ in dev.values()) if dev is not None
                   else times["queued_ms"])
    times["bound_ms"], times["bound_by"] = dw_bound(x, k, s)
    max_err = err.max().item()
    print(f"dw_conv_stats {name}: max |dy| {max_err:.3e} (within the "
          f"summation-order bound), {note}; tiles {plan.tiles} a channel (th "
          f"{plan.th}, pb {plan.pb}, {plan.threads} threads, "
          f"{plan.smem_bytes} B staged); "
          + ("1 device activity a call; device ms: kernel "
             f"{times['ms']:.4f} (profiler; " if dev is not None else
             "no profiler window saw a device record; device ms: kernel "
             f"{times['ms']:.4f} (queued, CUDA events; ")
          + f"{100 * times['bound_ms'] / times['ms']:.1f}% of the "
          f"{times['bound_by']} bound {times['bound_ms']:.4f}); queued back to "
          f"back (CUDA events): kernel {times['queued_ms']:.4f}, plain "
          f"{times['plain_ms']:.4f}, cuDNN conv {times['library_ms']:.4f}, "
          f"cuDNN conv + var_mean {times['conv_var_mean_ms']:.4f}; wrapper "
          f"calls back to back {times['call_ms']:.4f} ms (CUDA events)", flush=True)
    return max_err, times


def phase_dw(gen, N: int = 24, what: str = "one bsz-4 train forward"):
    """Phase 7 (and phase 19 at N 20). Returns (max |dy| over the f32
    shapes, the f32 shapes' summed device times and bound: one train
    forward's 16 launches at N = bsz x cameras). Block 0 is checked in
    bf16 too at phase 7's N."""
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "conv_var_mean_ms": 0.0, "call_ms": 0.0, "queued_ms": 0.0,
             "bound_ms": 0.0}
    max_err, by = 0.0, {}
    for block, k, s, shape in dw_shapes(N):
        for dtype in ((torch.float32, torch.bfloat16)
                      if block == 0 and N == 24 else (torch.float32,)):
            x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            w = 0.3 * torch.randn(shape[1], 1, k, k, generator=gen, device="cuda")
            name = (f"block {block} k{k} s{s} {tuple(shape)} "
                    f"{'f32' if dtype == torch.float32 else 'bf16'}")
            err, t = check_dw(name, x, w, s, grads=dtype == torch.float32)
            if dtype == torch.float32:
                max_err = max(max_err, err)
                for key in total:
                    total[key] += t[key]
                by[t["bound_by"]] = by.get(t["bound_by"], 0) + 1
    bound_by = max(by, key=by.get)
    print(f"dw_conv_stats, the 16 f32 launches of {what} (N {N}), "
          f"device ms: kernel {total['ms']:.4f} (profiler), bound "
          f"{total['bound_ms']:.4f} ({bound_by}; the kernel at "
          f"{100 * total['bound_ms'] / total['ms']:.1f}% of it); queued back to "
          f"back (CUDA events): kernel {total['queued_ms']:.4f}, plain "
          f"{total['plain_ms']:.4f}, cuDNN conv {total['library_ms']:.4f}, cuDNN "
          f"conv + var_mean {total['conv_var_mean_ms']:.4f}; wrapper calls back "
          f"to back {total['call_ms']:.4f} ms; {profiler_note()}",
          flush=True)
    for key in ("conv_var_mean_ms", "call_ms", "queued_ms"):
        total.pop(key)
    return max_err, {**total, "bound_by": bound_by}


# --- phases 8-10: training ---------------------------------------------

TRAIN_STEPS = 20
DW_PER_FORWARD = len(block_plan("b0"))  # one depthwise launch a block: 16


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_training(tmp, seed):
    """Phase 8. Returns (fixture root, dw launches, splat launches, loop
    wall ms per step over steps 11-20, the run's logdir)."""
    t0 = time.perf_counter()
    root = generate_fixture(f"{tmp}/simbev", num_scenes=20, samples_per_scene=4,
                            H=224, W=480, seed=seed)
    print(f"fixture: 20 scenes x 4 samples at 224 x 480 (16 train scenes, 4 "
          f"val) in {time.perf_counter() - t0:.1f} s", flush=True)
    run = f"{tmp}/run"
    kw = dict(dataroot=str(root), nepochs=2, bsz=4, nworkers=6, fused_dw=True,
              val_step=10, save_step=10, iou_log_step=10, seed=seed,
              device="cuda")
    reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    result = train(**kw, max_steps=TRAIN_STEPS, logdir=run)
    dw_launches, splat_launches = issued("dw_conv_stats"), issued("splat")
    dw_replayed, splat_replayed = replayed("dw_conv_stats"), replayed("splat")
    train_s = time.perf_counter() - t0  # the main path ends here
    assert result["counter"] == TRAIN_STEPS, result["counter"]
    assert dw_launches == DW_PER_FORWARD * TRAIN_STEPS, (
        f"{dw_launches} depthwise launches for {TRAIN_STEPS} train forwards "
        f"(want {DW_PER_FORWARD} each)")
    assert splat_launches > 0, "the training path never launched the splat kernel"
    recs = read_metrics(f"{run}/metrics.jsonl")
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    vals = [r for r in recs if "val/iou" in r]
    assert len(losses) == TRAIN_STEPS // 10 and all(map(math.isfinite, losses)), losses
    assert len(vals) == TRAIN_STEPS // 10, vals
    ckpts = set(os.listdir(f"{run}/ckpts"))
    for name in ("model_000010.pt", "model_000020.pt", "model_best.pt",
                 "model_final.pt"):
        assert name in ckpts, (name, sorted(ckpts))
    step_ms = [1e3 * r["train/step_time"] for r in recs if "train/step_time" in r]

    resumed = train(**kw, max_steps=12, logdir=f"{tmp}/resumed",
                    resume=f"{run}/ckpts/model_000010.pt")
    assert resumed["start_counter"] == 10 and resumed["counter"] == 12, resumed

    ck = torch.load(f"{run}/ckpts/model_best.pt", map_location="cpu",
                    weights_only=True)
    best = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                         device="cpu")
    best.load_state_dict(reference_state_dict(ck["model_state_dict"]))
    art = f"{tmp}/best.pt"
    export_predict(best.eval(), art, bsz=1, uint8_images=True)
    one = inputs(np.random.default_rng(seed), 1, uint8=True)
    with Running(serve(art, port=0, device="cuda")) as base:
        got = post(base, one)
    want = load_predict(art, device="cuda")(*one).cpu().numpy()
    err, _ = assert_close("model_best.pt served", got, want, SERVE_TOL)
    loss_txt = ", ".join(f"{v:.4f}" for v in losses)
    val_txt = ", ".join("loss {:.4f} iou {:.4f}".format(r["val/loss"], r["val/iou"])
                        for r in vals)
    step_txt = ", ".join(f"{v:.1f}" for v in step_ms)
    print(f"training: train() B0 bsz 4 fused_dw, {TRAIN_STEPS} steps in "
          f"{train_s:.1f} s (fixture loader, 6 threads; validations and "
          f"checkpoints included); losses {loss_txt}; val {val_txt}; "
          f"launches: dw_conv_stats {dw_launches} (= {DW_PER_FORWARD} x "
          f"{TRAIN_STEPS} train forwards), splat {splat_launches} ({TRAIN_STEPS} train + "
          f"{splat_launches - TRAIN_STEPS} validation and val-figure forwards), of "
          f"them replayed by the step's graph: dw_conv_stats {dw_replayed}, splat "
          f"{splat_replayed}; checkpoints "
          f"{sorted(ckpts)}; resume from model_000010.pt continued at "
          f"{resumed['start_counter']} to {resumed['counter']}; model_best.pt "
          f"(step {ck['counter']}, val IoU {ck['val_iou']:.4f}) exported and "
          f"served one request (max |served - direct| {err:.3e}); loop wall "
          f"ms per step {step_txt} (per 10-step window)", flush=True)
    return root, dw_launches, splat_launches, step_ms[-1], run


def zero_dropout(model):
    """Dropout probabilities and drop-connect rates to 0 (phase 9 only)."""
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
        elif isinstance(m, MBConvBlock):
            m.drop_connect_rate = 0.0


# card vs CPU, one B0 train step in f32, TF32 off. The loss and gradients
# go through 16 depthwise kernels, cuDNN's and the CPU's conv algorithms
# and the splat's atomic sums: LOSS_TOL relative for the loss, GRAD_TOL
# relative (L2) for the global norm and for the gradients of the
# parameters after the model's last train-mode BN (the BEV head's 1x1
# conv), BN_GRAD_TOL for every other parameter's; a gradient that is 0 up
# to rounding (a bias ahead of a train-mode BN) is held instead to GRAD_ABS
# of the global norm. Those other gradients come back through train-mode
# BNs, whose backward subtracts the batch means of dy and dy * xhat: the
# cancellation magnifies f32 rounding. Over the twelve seeds of
# card_cpu_spread.py (PERF.md, PR 3), such a gradient moves by up to
# 1.71e-2 relative when the CPU step alone has its depthwise moments
# nudged by one ulp, and misses the CPU by up to 1.33e-2 on the card
# through the kernels' plain versions, which launch no kernel;
# BN_GRAD_TOL is fixed above both. One seed's batch sits on a flip, where
# a one-ulp nudge moves the CPU step by 8.2e-2 (1.2e-3 in the global
# norm): no fixed limit on one step holds on such a batch, and phase 9's
# batch is not one (it prints its readings beside the check). Adam's
# first step moves each parameter by lr * g / (|g| + eps), g its gradient
# (clipped, plus weight decay): the two updates may differ by
# lr |g_card - g_cpu| / (min |g| + eps), plus rounding (1e-6 of |p|).
# Running stats: STATS_TOL relative plus 1e-6 absolute (means near 0).
LOSS_TOL, GRAD_TOL, BN_GRAD_TOL, GRAD_ABS, STATS_TOL = 1e-4, 1e-3, 2e-2, 1e-6, 1e-4
AFTER_LAST_BN = "bevencode.up2.4."


class plain_versions:
    """Within ``with plain_versions(True):`` the two kernels' wrappers run
    their plain versions on the card (phase 9's reading only)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        if self.on:
            self.saved = splat_cuda.splat_forward, mbconv_cuda.dw_conv_stats_forward
            splat_cuda.splat_forward = splat_reference
            mbconv_cuda.dw_conv_stats_forward = dw_conv_stats_reference

    def __exit__(self, *exc):
        if self.on:
            splat_cuda.splat_forward, mbconv_cuda.dw_conv_stats_forward = self.saved


def card_cpu_steps(root, seed):
    """One B0 train step (bsz 2, fused_dw, dropout 0, seeded weights) on
    the first validation batch of the fixture at ``root``, three times:
    on the CPU (the plain versions), on the card (the kernels) and on the
    card with the kernels' plain versions. Returns ({path: model}, {path:
    step metrics}, the parameters before the step, the batch)."""
    cpu = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                        fused_dw=True, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    zero_dropout(cpu)
    models = {"cpu": cpu, "card": copy.deepcopy(cpu).cuda(),
              "card, plain versions": copy.deepcopy(cpu).cuda()}
    _, valloader = compile_data("unused", root, DataAugConf(), GridConf(), bsz=2,
                                nworkers=2, dataset_kwargs={"device_normalize": True})
    batch = next(iter(valloader))[:7]
    before = {k: v.detach().clone() for k, v in cpu.named_parameters()}
    metrics = {}
    for name, model in models.items():
        dev = "cpu" if name == "cpu" else "cuda"
        plain = name.endswith("plain versions")
        launches = mbconv_cuda.launches, splat_cuda.launches
        with plain_versions(plain):
            metrics[name] = make_train_step(model, 2.13, device=dev)(
                create_train_state(model), batch)
        torch.cuda.synchronize()
        ran = mbconv_cuda.launches - launches[0], splat_cuda.launches - launches[1]
        if name == "card":
            assert ran == (DW_PER_FORWARD, 1), f"the card's step launched {ran}"
        elif plain:
            assert ran == (0, 0), f"the plain-versions step launched {ran}"
    return models, metrics, before, batch


def step_result(model, metrics) -> dict:
    """One train step's outcome on the CPU, for ``check_step``: loss,
    gradients' global norm, each parameter's gradient and value after the
    update, every BN's running stats."""
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()},
            "params": {k: p.detach().cpu() for k, p in model.named_parameters()},
            "stats": {k: b.detach().cpu() for k, b in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))}}


def grad_misses(got, ref) -> dict:
    """{parameter: (|g_got - g_ref|, |g_ref|)} (L2) of two step_results."""
    return {k: ((got["grads"][k] - g).norm().item(), g.norm().item())
            for k, g in ref["grads"].items()}


def grad_limit(name: str) -> float:
    """The relative L2 limit of a parameter's gradient, card vs CPU."""
    return GRAD_TOL if name.startswith(AFTER_LAST_BN) else BN_GRAD_TOL


def check_step(got, ref, before) -> str:
    """Hold one train step's step_result ``got`` against ``ref`` (the same
    step elsewhere) to phase 9's limits, from the parameters ``before``
    it; returns the readings."""
    lc, lg = ref["loss"], got["loss"]
    assert math.isfinite(lg) and abs(lg - lc) <= LOSS_TOL * max(1.0, abs(lc)), (lg, lc)
    nc, ng = ref["grad_norm"], got["grad_norm"]
    assert abs(ng - nc) <= GRAD_TOL * nc, (ng, nc)
    lr, wd, eps = 1e-3, 1e-7, 1e-8
    worst_p = 0.0
    worst_g = {GRAD_TOL: (0.0, ""), BN_GRAD_TOL: (0.0, "")}
    n_abs = n_bn_tol = flipped = 0
    misses = grad_misses(got, ref)
    for k, gc in ref["grads"].items():
        gg, pg, pc = got["grads"][k], got["params"][k], ref["params"][k]
        diff, norm = misses[k]
        tol = grad_limit(k)
        if diff <= tol * norm:
            worst_g[tol] = max(worst_g[tol], (diff / norm if norm else 0.0, k))
            n_bn_tol += int(diff > GRAD_TOL * norm)
        else:
            assert diff <= GRAD_ABS * nc, (k, diff, norm, tol)
            n_abs += 1
        p0 = before[k]
        ec, eg = gc + wd * p0, gg + wd * p0
        allowed = (lr * (eg - ec).abs() / (torch.minimum(ec.abs(), eg.abs()) + eps)
                   + 1e-6 * p0.abs() + 1e-9)
        used = ((pg - pc).abs() / allowed).max().item()
        assert used <= 1.0, (k, used)
        worst_p = max(worst_p, used)
        flipped += int(((pg - p0) * (pc - p0) < 0).sum())
    worst_s = 0.0
    for k, bc in ref["stats"].items():
        used = ((got["stats"][k] - bc).abs() / (STATS_TOL * bc.abs() + 1e-6)).max().item()
        assert used <= 1.0, (k, used)
        worst_s = max(worst_s, used)
    n_par = len(ref["grads"])
    return (f"loss {lg:.6f} vs {lc:.6f}, grad global norm {ng:.6f} vs "
            f"{nc:.6f} (relative {abs(ng - nc) / nc:.2e}; clipped at 5.0); "
            f"parameter gradients: {n_par - n_abs} of {n_par} within their "
            f"relative L2 limit ({GRAD_TOL} after the last BN, worst "
            f"{worst_g[GRAD_TOL][0]:.2e} at {worst_g[GRAD_TOL][1]}; "
            f"{BN_GRAD_TOL} through BN, worst {worst_g[BN_GRAD_TOL][0]:.2e} at "
            f"{worst_g[BN_GRAD_TOL][1]}, {n_bn_tol} above {GRAD_TOL}), {n_abs} "
            f"zero up to rounding, within {GRAD_ABS} of the global norm; "
            f"parameters after Adam within the stated bound (at most "
            f"{worst_p:.2f} of it; {flipped} entries moved in opposite "
            f"directions, as the bound allows near g = 0); "
            f"{len(ref['stats'])} BN running stats within {STATS_TOL} "
            f"relative + 1e-6 (at most {worst_s:.2f} of it)")


def phase_card_vs_cpu(root, seed):
    """Phase 9."""
    models, metrics, before, _ = card_cpu_steps(root, seed)
    res = {name: step_result(models[name], metrics[name]) for name in models}
    nc = res["cpu"]["grad_norm"]
    misses = {name: grad_misses(res[name], res["cpu"])
              for name in ("card", "card, plain versions")}
    print("card vs CPU, parameters whose gradient misses GRAD_TOL relative "
          "and GRAD_ABS of the global norm (name: |g_card - g_cpu| / |g_cpu|): "
          + "; ".join(f"{name}: " + (", ".join(
              f"{k} {d / r:.2e}" for k, (d, r) in sorted(m.items())
              if d > GRAD_TOL * r and d > GRAD_ABS * nc) or "none")
              for name, m in misses.items()), flush=True)
    print(f"card vs CPU, one B0 train step at bsz 2 (fused_dw: the kernel on "
          f"the card, the plain version on the CPU; dropout 0; f32, TF32 off): "
          f"{check_step(res['card'], res['cpu'], before)}", flush=True)


def random_batch(rng, B, grid: int = 200, outC: int = 1):
    """A train batch on the card: uint8 images, the rig, sparse labels."""
    args = inputs(rng, B, uint8=True)
    binimg = (rng.uniform(size=(B, outC, grid, grid)) < 0.02).astype(np.float32)
    return tuple(torch.as_tensor(a).cuda() for a in (*args, binimg))


def train_step_fn(fused: bool, seed: int, batch, accum_steps: int = 1,
                  grid_conf=None, **model_kw):
    """One train step of a fresh model (seeded weights; B0 at the default
    config unless ``model_kw`` and ``grid_conf`` say otherwise) on
    ``batch``."""
    model_kw = {"outC": 1, "variant": "b0", **model_kw}
    model = compile_model(grid_conf or GridConf(), DataAugConf(),
                          fused_dw=fused, device="cuda",
                          generator=torch.Generator().manual_seed(seed),
                          **model_kw)
    state = create_train_state(model)
    step = make_train_step(model, 2.13, accum_steps=accum_steps, device="cuda")
    return lambda: step(state, batch)


def device_allocs() -> int:
    """cudaMalloc calls of the caching allocator so far (each one may
    synchronise the host with the device)."""
    return torch.cuda.memory_stats().get("num_device_alloc", 0)


def phase_train_times(card, rng, seed, loop_step_ms):
    """Phase 10. The two models (fused_dw off and on) are timed in turns,
    off, on, on, off, for each TF32 setting, so drift on the card or the
    host falls on both alike."""
    for B in (8, 4):
        batch = random_batch(rng, B)
        steps = {fused: train_step_fn(fused, seed, batch) for fused in (False, True)}
        name = "train_step_ms_bsz8" if B == 8 else "train_step_ms_bsz4"
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            windows, allocs = {False: [], True: []}, {False: 0, True: 0}
            for fused in (False, True, True, False):
                before = device_allocs()
                # TF32 off, a bsz-4 step is ~0.4-0.6 s: windows of 5
                n = 10 if tf32 or B == 8 else 5
                windows[fused].append(cuda_ms(steps[fused], iters=n, warmup=2))
                allocs[fused] += device_allocs() - before
            for fused in (False, True):
                w = windows[fused]
                print(f"times on {card}: {name} {sum(w) / len(w):.3f} (fused_dw "
                      f"{'on' if fused else 'off'}, cudnn TF32 "
                      f"{'on' if tf32 else 'off'}; CUDA events, two windows of "
                      f"{n} steps after 2, timed in turns off/on/on/off: "
                      f"{w[0]:.3f}, {w[1]:.3f}; {allocs[fused]} cudaMalloc calls "
                      f"in them; inputs on the card)", flush=True)
        if B == 4:
            # fused_dw off and on with TF32 (where the host sets the step
            # time); TF32 off for the fused step only, as phase 8 ran it
            for fused, tf32 in ((False, True), (True, False), (True, True)):
                torch.backends.cudnn.allow_tf32 = tf32
                # TF32 off: one step of ~36,000 device activities is enough
                # (the profiler's post-processing grows with them)
                busy, text = profile_train_step(steps[fused], 3 if tf32 else 1,
                                                (B, 256, 200, 200))
                print(f"profile bsz-4 train step, fused_dw "
                      f"{'on' if fused else 'off'}, cudnn TF32 "
                      f"{'on' if tf32 else 'off'}: {text}", flush=True)
                if not tf32:
                    idle = ("not measured" if busy is None else
                            f"{max(0.0, 1 - busy / loop_step_ms):.3f}")
                    print(f"train() loop device idle share (phase 8, steps "
                          f"11-20, TF32 off): {idle} (device busy "
                          f"{busy if busy is None else round(busy, 3)} ms a step "
                          f"from this profile over loop wall "
                          f"{loop_step_ms:.1f} ms a step)", flush=True)
        del steps
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False


# --- phases 11-13: the stretch recipe in bf16 ---------------------------

# configs/simbev_stretch.sh on one card: B4, a 400 x 400 grid at 0.25 m,
# 4 classes (drivable + 3 vehicle classes), bf16
STRETCH_GRID = GridConf(xbound=(-50.0, 50.0, 0.25), ybound=(-50.0, 50.0, 0.25))
STRETCH_S = 400 * 400
STRETCH_CLASSES = 4
DW_B4 = len(block_plan("b4"))  # one depthwise launch a block: 32


def stretch_model(seed: int, compute_dtype: str = "bfloat16",
                  fused_dw: bool = True, state_dict=None):
    """The stretch LSS on the card: seeded weights and BN statistics, or
    ``state_dict``'s."""
    gen = torch.Generator().manual_seed(seed)
    model = compile_model(STRETCH_GRID, DataAugConf(), outC=STRETCH_CLASSES,
                          variant="b4", fused_dw=fused_dw,
                          compute_dtype=compute_dtype, device="cpu",
                          generator=gen)
    if state_dict is None:
        randomize_bn(model, gen)
    else:
        model.load_state_dict(state_dict)
    return model.cuda()


def b4_dw_shapes(N: int = 24, H: int = 64, W: int = 176):
    """[(k, s, (N, C, H, W), blocks)] of the B4 trunk's depthwise convs,
    one entry a distinct shape, from the stem's output (6 cameras at
    128 x 352 -> 64 x 176)."""
    shapes = {}
    for i, a in enumerate(block_plan("b4")):
        key = (a["kernel"], a["stride"], (N, a["cin"] * a["expand"], H, W))
        shapes.setdefault(key, []).append(i)
        H, W = -(-H // a["stride"]), -(-W // a["stride"])
    return [(*key, blocks) for key, blocks in shapes.items()]


def phase_stretch_kernels(gen, seed):
    """Phase 11. Returns {kernel name: (max error, times)}, the depthwise
    times summed over one bsz-4 train forward's 32 launches."""
    model = stretch_model(seed).eval()
    many = inputs(np.random.default_rng(seed), 4, uint8=True)
    with torch.inference_mode():
        t = [torch.as_tensor(a).cuda() for a in many]
        geom = model.get_geometry(*t[1:])
        feats = model.get_cam_feats(t[0])
        ids, _ = voxel_indices(geom, model.dx, model.bx, model.nx)
        pts = feats.reshape(4, -1, model.camC).contiguous()
        ids = ids.reshape(4, -1).contiguous()
    del model
    assert pts.dtype == torch.bfloat16 and pts.shape == (4, 6 * 41 * 8 * 22, 64)
    print(f"stretch splat inputs (B4 bf16 lift, bsz 4): "
          f"{float((ids == STRETCH_S).float().mean()):.3f} of points at the "
          f"sentinel", flush=True)
    out = {"splat": check_splat("stretch bf16 S=160000 bsz 4", pts, ids,
                                STRETCH_S)}
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_err, by = 0.0, {}
    for k, s, shape, blocks in b4_dw_shapes():
        x = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = 0.3 * torch.randn(shape[1], 1, k, k, generator=gen, device="cuda")
        err, t = check_dw(f"B4 blocks {blocks[0]}-{blocks[-1]} k{k} s{s} "
                          f"{tuple(shape)} bf16", x, w, s, grads=True)
        max_err = max(max_err, err)
        for key in total:
            total[key] += len(blocks) * t[key]
        by[t["bound_by"]] = by.get(t["bound_by"], 0) + len(blocks)
    bound_by = max(by, key=by.get)
    print(f"dw_conv_stats, the {DW_B4} bf16 launches of one bsz-4 B4 train "
          f"forward ({len(b4_dw_shapes())} shapes), device ms: kernel "
          f"{total['ms']:.4f} (profiler), bound {total['bound_ms']:.4f} "
          f"({bound_by}; the kernel at {100 * total['bound_ms'] / total['ms']:.1f}% "
          f"of it); queued (CUDA events): plain {total['plain_ms']:.4f}, cuDNN "
          f"conv {total['library_ms']:.4f}", flush=True)
    out["dw_conv_stats"] = (max_err, {**total, "bound_by": bound_by})
    return out


STRETCH_STEPS, STRETCH_VAL, STRETCH_RECAL, STRETCH_ACCUM = 10, 5, 2, 2


def phase_stretch_training(tmp, seed):
    """Phase 12. Returns ({kernel: bf16 launches}, loop wall ms a step over
    the last 5 steps, the fixture root, the run's logdir)."""
    t0 = time.perf_counter()
    root = generate_fixture(f"{tmp}/simbev400", num_scenes=10, samples_per_scene=4,
                            H=224, W=480, grid=400, seed=seed)
    print(f"stretch fixture: 10 scenes x 4 samples at 224 x 480, 400 x 400 "
          f"labels (8 train scenes, 2 val) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    run = f"{tmp}/stretch"
    kw = dict(dataroot=str(root), nepochs=10, bsz=4, nworkers=6,
              xbound=STRETCH_GRID.xbound, ybound=STRETCH_GRID.ybound,
              variant="b4", label_mode="multiclass", compute_dtype="bfloat16",
              fused_dw=True, lr_schedule="cosine", warmup_steps=2,
              ema_decay=0.999, ema_bn_recal=STRETCH_RECAL,
              accum_steps=STRETCH_ACCUM, iou_log_step=STRETCH_VAL, seed=seed,
              device="cuda")
    reset_launches()  # the stretch path starts here
    t0 = time.perf_counter()
    result = train(**kw, max_steps=STRETCH_STEPS, val_step=STRETCH_VAL,
                   save_step=STRETCH_VAL, logdir=run)
    train_s = time.perf_counter() - t0
    assert result["counter"] == STRETCH_STEPS, result["counter"]
    recs = read_metrics(f"{run}/metrics.jsonl")
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    vals = [r for r in recs if "val/iou" in r]
    assert losses and all(map(math.isfinite, losses)), losses
    assert len(vals) == STRETCH_STEPS // STRETCH_VAL, vals
    for r in vals:
        assert {"val/iou_raw", "val/loss_raw", "val/iou_c3"} <= set(r), r
        assert all(math.isfinite(r[k]) for k in r if k.startswith("val/")), r
    for name in ("model_000005.pt", "model_000010.pt", "model_best.pt",
                 "model_final.pt"):
        ck = torch.load(f"{run}/ckpts/{name}", map_location="cpu",
                        weights_only=True, mmap=True)
        assert "ema_state_dict" in ck, (name, sorted(ck))
    resumed = train(**kw, max_steps=7, val_step=0, save_step=0,
                    logdir=f"{tmp}/stretch_resumed",
                    resume=f"{run}/ckpts/model_000005.pt")
    assert resumed["start_counter"] == 5 and resumed["counter"] == 7, resumed
    art = f"{tmp}/stretch_best.pt"
    export_cli(["--checkpoint", f"{run}/ckpts", "--best", "--ema",
                "--compute_dtype", "bfloat16", "--variant", "b4",
                "--outC", str(STRETCH_CLASSES), "--uint8", "--out", art,
                "--xbound", *map(str, STRETCH_GRID.xbound),
                "--ybound", *map(str, STRETCH_GRID.ybound)])
    one = inputs(np.random.default_rng(seed), 1, uint8=True)
    with Running(serve(art, port=0, device="cuda")) as base:
        got = post(base, one)
    launches = {k: issued_by_dtype(k) for k in ("dw_conv_stats", "splat")}
    graph = {k: replayed(k) for k in launches}
    # the stretch path ends here
    assert got.dtype == np.float32 and got.shape == (1, STRETCH_CLASSES, 400, 400)
    assert np.isfinite(got).all(), "non-finite served logits"
    want = load_predict(art, device="cuda")(*one).cpu().numpy()
    served_gap = float(np.abs(got - want).max())
    # train-mode forwards: two microbatches a step, and STRETCH_RECAL
    # recalibration forwards before each validation; the resume's 2 steps
    forwards = (STRETCH_ACCUM * STRETCH_STEPS
                + STRETCH_RECAL * (STRETCH_STEPS // STRETCH_VAL)
                + STRETCH_ACCUM * 2)
    assert launches["dw_conv_stats"] == {"float32": 0, "bfloat16": DW_B4 * forwards}, (
        launches, forwards)
    assert launches["splat"]["float32"] == 0 and launches["splat"]["bfloat16"] > 0, launches
    step_ms = [1e3 * r["train/step_time"] for r in recs if "train/step_time" in r]
    print(f"stretch training: train() B4 400 x 400 bf16 fused_dw, bsz 4 x "
          f"{STRETCH_ACCUM} microbatches, cosine (warm-up 2), EMA 0.999 with BN "
          f"recalibration over {STRETCH_RECAL} batches, {STRETCH_STEPS} steps in "
          f"{train_s:.1f} s (validations and checkpoints included); losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; val "
          + "; ".join("EMA loss {:.4f} iou {:.4f}, raw loss {:.4f} iou {:.4f}".format(
              r["val/loss"], r["val/iou"], r["val/loss_raw"], r["val/iou_raw"])
              for r in vals)
          + f"; launches by dtype: dw_conv_stats {launches['dw_conv_stats']} (= "
          f"{DW_B4} x {forwards} train-mode forwards), splat {launches['splat']}, "
          f"of them replayed by the step's graph {graph}; every checkpoint carries ema_state_dict; resume from step 5 "
          f"continued to {resumed['counter']}; model_best.pt exported --ema "
          f"--compute_dtype bfloat16 and served one request: f32 logits "
          f"{got.shape[1:]}, finite, max |served - direct| {served_gap:.3e}; "
          f"loop wall ms a step {', '.join(f'{v:.1f}' for v in step_ms)} (per "
          f"{STRETCH_VAL}-step window)", flush=True)
    counts = {k: v["bfloat16"] for k, v in launches.items()}
    return counts, step_ms[-1], root, run


# bf16 against f32 on the card, the stretch model at bsz 1 in eval mode
# with seeded weights and BN statistics (cuDNN TF32 off for f32): max
# |logit_bf16 - logit_f32| over max(1, max |logit_f32|). Seeds 0-5 read
# 1.84e-2, 2.33e-2, 3.06e-2, 1.88e-2, 2.57e-2 and 1.71e-2 on an H100
# (PERF.md §6); the limit is twice the largest.
BF16_SEEDS = 4
BF16_TOL = 6e-2


def phase_bf16(card, seed, loop_step_ms):
    """Phase 13."""
    gaps = []
    for s in range(seed, seed + BF16_SEEDS):
        f32 = stretch_model(s, "float32").eval()
        bf16 = stretch_model(s, "bfloat16", state_dict={
            k: v.cpu() for k, v in f32.state_dict().items()}).eval()
        x = [torch.as_tensor(a).cuda() for a in
             inputs(np.random.default_rng(s), 1, uint8=True)]
        with torch.inference_mode():
            a, b = f32(*x), bf16(*x)
        assert a.dtype == b.dtype == torch.float32 and torch.isfinite(b).all()
        scale = max(1.0, a.abs().max().item())
        gaps.append(((b - a).abs().max().item() / scale, scale,
                     ((b - a).abs().mean() / a.abs().mean()).item()))
        if s == seed:
            lat = {}
            torch.backends.cudnn.allow_tf32 = True
            with torch.inference_mode():
                for name, m in (("f32, TF32", f32), ("bf16", bf16)):
                    lat[name] = cuda_ms(lambda: m(*x), iters=10)
            torch.backends.cudnn.allow_tf32 = False
        del f32, bf16
    print(f"bf16 vs f32 (TF32 off), the stretch model at bsz 1, seeds "
          f"{seed}-{seed + BF16_SEEDS - 1}: max |diff| / max(1, max|f32|) "
          + ", ".join(f"{g:.3e} (scale {sc:.2f}, mean |diff| / mean |f32| {m:.3e})"
                      for g, sc, m in gaps)
          + f"; limit {BF16_TOL}; bsz-1 forward on {card}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in lat.items())
          + " (CUDA events, 10 after 3)", flush=True)
    assert max(g for g, _, _ in gaps) <= BF16_TOL, gaps
    torch.cuda.empty_cache()

    # train-step times, bf16 against f32 with cuDNN TF32, in turns
    rng = np.random.default_rng(seed)
    torch.backends.cudnn.allow_tf32 = True
    cases = (("B4 stretch bsz 4, fused_dw", True,
              random_batch(rng, 4, 400, STRETCH_CLASSES),
              dict(grid_conf=STRETCH_GRID, variant="b4", outC=STRETCH_CLASSES)),
             ("B0 default bsz 4", False, random_batch(rng, 4), {}))
    for name, fused, batch, kw in cases:
        steps = {dt: train_step_fn(fused, seed, batch, compute_dtype=dt, **kw)
                 for dt in ("float32", "bfloat16")}
        windows = {dt: [] for dt in steps}
        for dt in ("float32", "bfloat16", "bfloat16", "float32"):
            windows[dt].append(cuda_ms(steps[dt], iters=10, warmup=3))
        print(f"times on {card}: {name} train step, " + "; ".join(
            f"{'bf16' if dt == 'bfloat16' else 'f32 (cuDNN TF32)'} "
            f"{sum(w) / len(w):.3f} ms ({w[0]:.3f}, {w[1]:.3f})"
            for dt, w in windows.items())
            + " (CUDA events, two windows of 10 steps after 3, in turns "
            "f32/bf16/bf16/f32; inputs on the card)", flush=True)
        del steps
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False

    # the recipe's optimizer step: two bf16 microbatches of bsz 4
    stacked = tuple(torch.stack(pair) for pair in zip(
        random_batch(rng, 4, 400, STRETCH_CLASSES),
        random_batch(rng, 4, 400, STRETCH_CLASSES)))
    step = train_step_fn(True, seed, stacked, accum_steps=STRETCH_ACCUM,
                         grid_conf=STRETCH_GRID, variant="b4",
                         outC=STRETCH_CLASSES, compute_dtype="bfloat16")
    busy, text = profile_train_step(step, 2, (4, 256, 400, 400))
    print(f"profile B4 stretch optimizer step (bf16, 2 microbatches of bsz 4, "
          f"fused_dw): {text}", flush=True)
    idle = ("not measured" if busy is None else
            f"{max(0.0, 1 - busy / loop_step_ms):.3f}")
    print(f"stretch train() loop device idle share (phase 12, steps 6-10): "
          f"{idle} (device busy {busy if busy is None else round(busy, 3)} ms "
          f"a step from this profile over loop wall {loop_step_ms:.1f} ms a "
          f"step)", flush=True)
    del step
    torch.cuda.empty_cache()


# --- phases 14-16: the ResNet trunk, the explore tools, the watchdog ---

RESNET_STEPS = 20
# eval_model_iou against the val/loss and val/iou train() logged for the
# same checkpoint on the same val set: only the order of the splat's
# atomic sums differs (f32 TF32 off; the stretch model's bf16 rounds its
# splat output once from an f32 sum in another order)
EVAL_LOSS_RTOL, EVAL_IOU_ATOL = 1e-4, 1e-3
# splat_check, kernel against plain splat on one batch in eval mode, f32
# TF32 off: logits SERVE_TOL x max(1, max |logit|), as served logits; the
# depthnet gradient SPLAT_GRAD_RTOL relative L2; the loss SPLAT_LOSS_RTOL
SPLAT_GRAD_RTOL, SPLAT_LOSS_RTOL = 1e-3, 1e-5
WATCHDOG_SECS = 5


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


class FigureCalls:
    """Within ``with FigureCalls() as f:`` every figure ``train()`` makes
    is recorded in ``f.calls`` as (step, tag, logits shape, logits finite)
    once its prediction is made, whether or not it renders (matplotlib
    may be absent)."""

    def __enter__(self):
        self.calls, self.saved = [], loop._figure

        def record(logger, step, tag, batch, logits, title, extent):
            self.calls.append((step, tag, tuple(logits.shape),
                               bool(torch.isfinite(logits).all())))
            return self.saved(logger, step, tag, batch, logits, title, extent)
        loop._figure = record
        return self

    def __exit__(self, *exc):
        loop._figure = self.saved


def resnet_model(variant: str, seed: int):
    """A ResNet LSS at the flagship config on the CPU, eval mode, with
    seeded weights and BN statistics."""
    gen = torch.Generator().manual_seed(seed)
    model = compile_model(GridConf(), DataAugConf(), outC=1, variant=variant,
                          device="cpu", generator=gen)
    randomize_bn(model, gen)
    return model.eval()


def card_vs_cpu(name, path, rng):
    """Card against CPU at bsz 1 through the artifact at ``path`` (f32,
    TF32 off). Returns (max |diff|, scale)."""
    one = inputs(rng, 1, uint8=True)
    x = (one[0].astype(np.float32),) + one[1:]
    return assert_close(name, load_predict(path, device="cuda")(*x).cpu().numpy(),
                        load_predict(path, device="cpu")(*x).numpy(), CPU_TOL)


def phase_resnet(tmp, root, rng, seed, card):
    """Phase 14. Returns (splat launches of its main paths: serving and
    train(), the train run's logdir)."""
    # (a) serving at full width
    model = resnet_model("resnet18", seed).cuda()
    path1, path8 = f"{tmp}/r18_bsz1.pt", f"{tmp}/r18_bsz8_u8.pt"
    export_predict(model, path1, bsz=1)
    export_predict(model, path8, bsz=8, uint8_images=True)
    many = inputs(rng, 8, uint8=True)
    reset_launches()  # the ResNet serving path starts here
    with Running(serve(path8, port=0, warmup_args=many, device="cuda")) as base:
        got = post(base, many)
    serve_launches, dw = issued("splat"), issued("dw_conv_stats")  # ends
    assert serve_launches > 0 and dw == 0, (serve_launches, dw)
    want = load_predict(path8, device="cuda")(*many).cpu().numpy()
    err8, scale8 = assert_close("resnet18 served", got, want, SERVE_TOL)
    errc, scalec = card_vs_cpu("resnet18 card vs cpu", path1, rng)
    dev8 = [torch.as_tensor(a).cuda() for a in many]
    ms8 = {}
    with torch.inference_mode():
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            ms8[tf32] = cuda_ms(lambda: model(*dev8), iters=20)
    torch.backends.cudnn.allow_tf32 = False
    n_params = sum(p.numel() for p in model.parameters())
    print(f"resnet18 serving: {n_params:,} parameters; one bsz-8 uint8 request "
          f"over HTTP, logits {got.shape}, finite, max |served - direct| "
          f"{err8:.3e} (tolerance {SERVE_TOL} x {scale8:.3f}); splat launches "
          f"{serve_launches}, dw_conv_stats 0; card vs CPU (bsz 1, f32, TF32 "
          f"off): max |diff| {errc:.3e} (tolerance {CPU_TOL} x {scalec:.3f}); "
          f"times on {card}: inference_ms_per_sample_bsz8 {ms8[False] / 8:.4f} "
          f"(cudnn TF32 off), {ms8[True] / 8:.4f} (TF32 on) (CUDA events, 20 "
          f"bsz-8 forwards after 3, uint8 inputs on the card)", flush=True)
    del model, dev8
    torch.cuda.empty_cache()

    # (b) train() at bsz 4, one train and one validation figure at step 20
    run = f"{tmp}/r18run"
    kw = dict(dataroot=str(root), nepochs=2, bsz=4, nworkers=6,
              variant="resnet18", val_step=RESNET_STEPS, save_step=10,
              iou_log_step=10, viz_step=RESNET_STEPS, seed=seed, device="cuda")
    n_val = len(compile_data("unused", root, DataAugConf(), GridConf(), bsz=4,
                             nworkers=0)[1])
    reset_launches()  # the ResNet training path starts here
    t0 = time.perf_counter()
    with FigureCalls() as figs:
        result = train(**kw, max_steps=RESNET_STEPS, logdir=run)
    train_launches, dw = issued("splat"), issued("dw_conv_stats")
    train_s = time.perf_counter() - t0  # and ends here
    assert result["counter"] == RESNET_STEPS, result["counter"]
    assert dw == 0, f"a ResNet model launched dw_conv_stats {dw} times"
    # a forward a step, one a val batch, one a figure
    assert train_launches == RESNET_STEPS + n_val + 2, (train_launches, n_val)
    assert figs.calls == [(RESNET_STEPS, "train/visualization", (4, 1, 200, 200), True),
                          (RESNET_STEPS, "val/visualization", (4, 1, 200, 200), True)
                          ], figs.calls
    recs = read_metrics(f"{run}/metrics.jsonl")
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    vals = [r for r in recs if "val/iou" in r]
    assert len(losses) == RESNET_STEPS // 10 and all(map(math.isfinite, losses)), losses
    assert len(vals) == 1 and all(map(math.isfinite, vals[0].values())), vals
    ckpts = set(os.listdir(f"{run}/ckpts"))
    for name in ("model_000010.pt", "model_000020.pt", "model_best.pt",
                 "model_final.pt"):
        assert name in ckpts, (name, sorted(ckpts))
    resumed = train(**kw, max_steps=12, logdir=f"{tmp}/r18resumed",
                    resume=f"{run}/ckpts/model_000010.pt")
    assert resumed["start_counter"] == 10 and resumed["counter"] == 12, resumed
    step_ms = [1e3 * r["train/step_time"] for r in recs if "train/step_time" in r]
    print(f"resnet18 training: train() bsz 4 f32 (TF32 off), {RESNET_STEPS} "
          f"steps in {train_s:.1f} s (validation, figures and checkpoints "
          f"included); losses {', '.join(f'{v:.4f}' for v in losses)}; val "
          f"loss {vals[0]['val/loss']:.4f} iou {vals[0]['val/iou']:.4f}; "
          f"launches: splat {train_launches} ({RESNET_STEPS} train + {n_val} "
          f"validation + 2 figure forwards), dw_conv_stats 0; figures at step "
          f"{RESNET_STEPS}: {[c[1] for c in figs.calls]}, "
          + ("rendered (matplotlib)" if have_matplotlib() else
             "predictions computed, not rendered (no matplotlib here)")
          + f"; checkpoints {sorted(ckpts)}; resume from model_000010.pt "
          f"continued to {resumed['counter']}; loop wall ms a step "
          f"{', '.join(f'{v:.1f}' for v in step_ms)} (per 10-step window)",
          flush=True)

    # (c) the bsz-4 step against B0's, f32 + cuDNN TF32, in turns
    torch.backends.cudnn.allow_tf32 = True
    batch = random_batch(rng, 4)
    steps = {v: train_step_fn(False, seed, batch, variant=v)
             for v in ("resnet18", "b0")}
    windows = {v: [] for v in steps}
    for v in ("resnet18", "b0", "b0", "resnet18"):
        windows[v].append(cuda_ms(steps[v], iters=10, warmup=2))
    print(f"times on {card}: bsz-4 train step, f32 + cuDNN TF32: " + "; ".join(
        f"{v} {sum(w) / len(w):.3f} ms ({w[0]:.3f}, {w[1]:.3f})"
        for v, w in windows.items())
        + " (CUDA events, two windows of 10 steps after 2, in turns "
        "resnet18/b0/b0/resnet18; inputs on the card)", flush=True)
    for v in steps:
        _, text = profile_train_step(steps[v], 3, (4, 256, 200, 200))
        print(f"profile bsz-4 train step, {v}, f32 + cuDNN TF32: {text}",
              flush=True)
    torch.backends.cudnn.allow_tf32 = False
    del steps, batch
    torch.cuda.empty_cache()

    # (d) ResNet-34 at bsz 1, card against CPU
    model = resnet_model("resnet34", seed + 1)
    path34 = f"{tmp}/r34_bsz1.pt"
    export_predict(model, path34, bsz=1)
    err34, scale34 = card_vs_cpu("resnet34 card vs cpu", path34, rng)
    print(f"resnet34: {sum(p.numel() for p in model.parameters()):,} "
          f"parameters; card vs CPU (bsz 1, f32, TF32 off): max |diff| "
          f"{err34:.3e} (tolerance {CPU_TOL} x {scale34:.3f})", flush=True)
    torch.cuda.empty_cache()
    return serve_launches + train_launches, run


def logged_best(run):
    """(step, metrics record) of the validation that wrote the run's
    model_best.pt."""
    ck = torch.load(f"{run}/ckpts/model_best.pt", map_location="cpu",
                    weights_only=True, mmap=True)
    step = int(ck["counter"])
    recs = [r for r in read_metrics(f"{run}/metrics.jsonl")
            if r["step"] == step and "val/iou" in r]
    assert len(recs) == 1, (step, recs)
    return step, recs[0]


def check_eval(name, run, info) -> str:
    """eval_model_iou's ``info`` against the logged validation of the
    step that wrote ``run``'s model_best.pt."""
    step, rec = logged_best(run)
    dloss = abs(info["loss"] - rec["val/loss"])
    diou = abs(info["iou"] - rec["val/iou"])
    assert math.isfinite(info["loss"]) and dloss <= EVAL_LOSS_RTOL * abs(rec["val/loss"]), (
        name, info, rec)
    assert diou <= EVAL_IOU_ATOL, (name, info, rec)
    per_class = info.get("iou_per_class")
    logged_c = [rec[k] for k in sorted(rec) if k.startswith("val/iou_c")]
    return (f"{name} (model_best.pt, step {step}): loss {info['loss']:.6f} vs "
            f"logged {rec['val/loss']:.6f} (|diff| {dloss:.3e}, limit "
            f"{EVAL_LOSS_RTOL} relative), iou {info['iou']:.6f} vs logged "
            f"{rec['val/iou']:.6f} (|diff| {diou:.3e}, limit {EVAL_IOU_ATOL})"
            + (f", iou_per_class {[round(v, 6) for v in per_class]} vs logged "
               f"{[round(v, 6) for v in logged_c]}" if per_class else ""))


def phase_explore(tmp, root, b0_run, r18_run, root400, stretch_run):
    """Phase 15. Returns the splat launches of the tools' main path
    (eval_model_iou and the predictions of viz_model_preds)."""
    reset_launches()  # the explore path starts here
    info18 = explore.eval_model_iou(str(root), f"{r18_run}/ckpts", best=True,
                                    variant="resnet18", bsz=4, nworkers=6,
                                    device="cuda")
    info_st = explore.eval_model_iou(
        str(root400), f"{stretch_run}/ckpts", best=True, use_ema=True,
        variant="b4", grid_conf=STRETCH_GRID, label_mode="multiclass",
        compute_dtype="bfloat16", bsz=4, nworkers=6, device="cuda")
    samples, _ = explore.model_preds(str(root), f"{r18_run}/ckpts", best=True,
                                     max_batches=2, bsz=4, variant="resnet18",
                                     device="cuda")
    launches, dw = splat_cuda.launches, mbconv_cuda.launches  # it ends here
    assert launches > 0 and dw == 0, (launches, dw)
    print("eval_model_iou on the card: " + check_eval("resnet18", r18_run, info18)
          + "; " + check_eval("stretch B4 bf16 --best --ema", stretch_run, info_st)
          + f"; splat launches {launches}", flush=True)

    assert len(samples) == 8, len(samples)  # 2 batches of 4, none padded
    for imgs, gt, pred in samples:
        assert imgs.shape == (6, 3, 128, 352) and gt.shape == pred.shape == (200, 200)
        assert np.isfinite(pred).all() and 0.0 <= pred.min() <= pred.max() <= 1.0
    geom = explore.frustum_points(str(root), device="cuda")
    assert geom.shape == (6, 41, 8, 22, 3) and np.isfinite(geom).all(), geom.shape
    if have_matplotlib():
        n = explore.viz_model_preds(str(root), f"{r18_run}/ckpts", best=True,
                                    outdir=f"{tmp}/viz", max_batches=2, bsz=4,
                                    variant="resnet18", device="cuda")
        path = explore.lidar_check(str(root), outdir=f"{tmp}/viz", device="cuda")
        pngs = sorted(os.listdir(f"{tmp}/viz"))
        assert n == 8 and len(pngs) == 9 and os.path.getsize(path) > 0, pngs
        rendered = f"rendered {len(pngs)} PNGs (8 eval + lidar_check)"
    else:
        rendered = ("not rendered: no matplotlib here (the compute parts "
                    "model_preds and frustum_points ran)")
    print(f"viz_model_preds: {len(samples)} predictions (2 val batches of 4, "
          f"none padded), finite, in [0, 1]; lidar_check: frustum points "
          f"{geom.shape}, finite, x in [{geom[..., 0].min():.1f}, "
          f"{geom[..., 0].max():.1f}] m; {rendered}", flush=True)

    # phase 8's trained B0 (model_best.pt): a fresh model's head gives
    # logits of ~1e-16, against which the logit limit would test nothing
    before = splat_cuda.launches
    res = explore.splat_check(str(root), bsz=2, variant="b0",
                              checkpoint=f"{b0_run}/ckpts", best=True,
                              device="cuda")
    assert splat_cuda.launches - before == 1, "splat_check's kernel side"
    a, b = res["kernel"], res["plain"]
    max_logit = float(b["logits"].abs().max())
    assert max_logit > 1e-3, f"logits of ~0 ({max_logit}) test nothing"
    scale = max(1.0, max_logit)
    dlogit = float((a["logits"] - b["logits"]).abs().max())
    dgrad = float((a["grad"] - b["grad"]).norm() / b["grad"].norm())
    dloss = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    assert dlogit <= SERVE_TOL * scale, (dlogit, scale)
    assert dgrad <= SPLAT_GRAD_RTOL and dloss <= SPLAT_LOSS_RTOL, (dgrad, dloss)
    print(f"splat_check (phase 8's B0 model_best.pt at full width, a fixture "
          f"batch at bsz 2, eval mode, f32 TF32 off; max |logit| "
          f"{max_logit:.3f}): kernel out.mean {a['out_mean']:.6f} grad.mean "
          f"{a['grad_mean']:.6e} loss {a['loss']:.6f}; plain out.mean "
          f"{b['out_mean']:.6f} grad.mean {b['grad_mean']:.6e} loss "
          f"{b['loss']:.6f}; max |dlogit| {dlogit:.3e} (limit {SERVE_TOL} x "
          f"{scale:.3f}), depthnet gradient relative L2 {dgrad:.3e} (limit "
          f"{SPLAT_GRAD_RTOL}), |dloss| / loss {dloss:.3e} (limit "
          f"{SPLAT_LOSS_RTOL}); the kernel side launched the kernel once, the "
          f"plain side never", flush=True)
    return launches


def phase_supervise(tmp, seed):
    """Phase 16: the stall drill through the training CLI, as a subprocess
    in a session of its own (killed whole on a timeout)."""
    import signal
    root = generate_fixture(f"{tmp}/simbev16", num_scenes=5, samples_per_scene=2,
                            H=64, W=128, grid=16, seed=seed)
    logdir = f"{tmp}/drill"
    cmd = [sys.executable, "-m", "lss_carla_torch.train", "--dataroot", str(root),
           "--H", "64", "--W", "128", "--final_h", "32", "--final_w", "64",
           "--xbound", "-50", "50", "6.25", "--ybound", "-50", "50", "6.25",
           "--bsz", "2", "--nworkers", "2", "--nepochs", "3", "--val_step", "0",
           "--viz_step", "0", "--iou_log_step", "1", "--seed", str(seed),
           "--logdir", logdir, "--supervise", "1", "--watchdog_secs",
           str(WATCHDOG_SECS), "--debug_stall_at", "3", "--save_step", "2",
           "--max_steps", "6"]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    timer = threading.Timer(300, lambda: os.killpg(proc.pid, signal.SIGKILL))
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.monotonic() - t0, line.rstrip()))
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    text = "\n".join(ln for _, ln in lines)
    tail = "\n".join(ln for _, ln in lines[-40:])

    def first(needle):
        hits = [t for t, ln in lines if needle in ln]
        assert hits, f"no line with {needle!r}:\n{tail}"
        return hits[0]
    assert rc == 0, f"supervisor exit code {rc}:\n{tail}"
    t_stall, t_warn = first("injected stall at step 3"), first("no step progress")
    t_exit = first("child exited rc=42")
    assert "Current thread" in text or "Thread 0x" in text, "no stacks dumped"
    # the last beat (after the step-2 save) came just before the stall
    assert t_exit - t_stall >= 2 * WATCHDOG_SECS - 0.5, (t_stall, t_exit)
    attempts = [ln for _, ln in lines if ln.startswith("[supervise] attempt")]
    assert len(attempts) == 2 and "--resume" not in attempts[0], attempts
    assert attempts[1].endswith(f"--resume {logdir}/ckpts"), attempts[1]
    first("Resumed from step 2")
    first("child exited rc=0")
    final = torch.load(f"{logdir}/ckpts/model_final.pt", map_location="cpu",
                       weights_only=True)
    assert int(final["counter"]) == 6, final["counter"]
    print(f"watchdog and --supervise (subprocess, B0 at 32 x 64, 16 x 16 grid, "
          f"--watchdog_secs {WATCHDOG_SECS}): stall at step 3 at "
          f"{t_stall:.1f} s, stacks dumped at {t_warn:.1f} s, first child "
          f"exited 42 at {t_exit:.1f} s ({t_exit - t_stall:.1f} s after the "
          f"stall); the second started with --resume {logdir}/ckpts, resumed "
          f"from step 2 and ended at step {int(final['counter'])}; supervisor "
          f"exit code {rc}; {t_exit:.1f} + {lines[-1][0] - t_exit:.1f} s",
          flush=True)


# --- phase 17: int8 serving ---------------------------------------------

INT8_SEEDS = range(6)
# card int8 against CPU int8 at bsz 1 (f32, TF32 off), x max(1, max |logit|):
# a float difference upstream (a few ulps: conv algorithms, the splat's
# atomic order) moves an activation across a rounding edge and flips one
# quantum, and the flips compound over the int8 convs until the two sides
# differ about as much as int8 and float do. Twice the largest of these
# six seeds' readings (PERF.md, the int8 findings: B0 0.15932, B4
# 0.16429). Each conv's int32 accumulator is held exactly
# (int8_accumulators_exact)
INT8_CPU_TOL = {"b0": 0.32, "b4": 0.33}
# JAX's own int8-against-float bounds (tests/test_quant.py:82-105), held
# where JAX holds them: B0 at the tests' tiny config, BN at its init
JAX_INT8_REL, JAX_INT8_AGREE = 0.1, 0.97
TINY_GRID = GridConf(xbound=(-40.0, 40.0, 5.0), ybound=(-40.0, 40.0, 5.0),
                     dbound=(4.0, 36.0, 8.0))
TINY_AUG = DataAugConf(H=64, W=128, final_dim=(32, 64))


def b0_int8_gate_count(min_channels: int = 64) -> int:
    """The convs of the B0 LSS model that the gate (groups 1, dilation 1,
    min(cin, cout) >= min_channels) quantizes, counted from the block plan
    and the encoders' widths, not from the model."""
    convs = []
    for b in block_plan("b0"):
        mid, se = b["cin"] * b["expand"], max(1, int(b["cin"] * 0.25))
        if b["expand"] != 1:
            convs.append((b["cin"], mid))
        convs += [(mid, se), (se, mid), (mid, b["cout"])]  # SE; project
    convs += [(320 + 112, 512), (512, 512), (512, 41 + 64)]  # up1; depthnet
    convs += [(64, 64)] + [(64, 64)] * 4  # BEV conv1, layer1
    for cin, cout in ((64, 128), (128, 256)):  # layer2, layer3
        convs += [(cin, cout), (cout, cout), (cin, cout), (cout, cout),
                  (cout, cout)]  # conv1, conv2, downsample, block 2
    convs += [(64 + 256, 256), (256, 256), (256, 128), (128, 1)]  # up1; up2
    return sum(min(c) >= min_channels for c in convs)


def turns_ms(fns: dict, iters: int = 10) -> dict:
    """Device ms per call of each of ``fns``, timed in turns (A B C C B
    A): {name: [first, second]}."""
    names = list(fns)
    out = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            with torch.inference_mode():
                out[k].append(cuda_ms(fns[k], iters=iters))
    return out


def int8_accumulators_exact(qmodel, args) -> int:
    """Every int8 conv of ``qmodel`` (on the card) on the input it sees in
    a forward of ``args``: the int32 accumulators of the card (cuBLASLt
    ``_int_mm``) equal the CPU's bit for bit. Returns the convs checked."""
    seen = []

    def hook(mod, inp, out):
        seen.append((mod, inp[0].detach()))

    hooks = [m.register_forward_hook(hook) for m in qmodel.modules()
             if isinstance(m, quant.Int8Conv2d)]
    try:
        with torch.inference_mode():
            qmodel(*[torch.as_tensor(a).cuda() for a in args])
    finally:
        for h in hooks:
            h.remove()
    for mod, x in seen:
        x_i8, _ = quant.quantize_activation(x)
        acc = quant.conv_int8_acc(x_i8, mod.w_rows, mod.out_channels,
                                  mod.kernel_size, mod.stride, mod.padding)
        want = quant.conv_int8_acc(x_i8.cpu(), mod.w_rows.cpu(),
                                   mod.out_channels, mod.kernel_size,
                                   mod.stride, mod.padding)
        assert torch.equal(acc.cpu(), want), f"int32 accumulator differs: {mod}"
    return len(seen)


def int_mm_limits() -> str:
    """Which (M, K, N) shapes ``torch._int_mm`` takes on this card (a
    reading; ``quant.mm_shape`` pads to M > 16 and K, N multiples of 8)."""
    notes = []
    for M, K, N in ((16, 64, 64), (17, 64, 64), (32, 60, 64), (32, 64, 105),
                    (17, 8, 8)):
        a = torch.ones(M, K, dtype=torch.int8, device="cuda")
        b = torch.ones(N, K, dtype=torch.int8, device="cuda")
        try:
            ok = int(torch._int_mm(a, b.t())[0, 0]) == K
            notes.append(f"({M}, {K}, {N}) {'ok' if ok else 'WRONG'}")
        except RuntimeError as e:
            notes.append(f"({M}, {K}, {N}) refused: {str(e).splitlines()[0]}")
    return "; ".join(notes)


def b0_model(seed: int, randomized: bool = True, compute_dtype="float32",
             grid_conf=None, aug_conf=None):
    """The B0 LSS (the flagship config unless told otherwise) on the CPU,
    eval mode: seeded weights and, with ``randomized``, seeded BN
    statistics (else BN at its init, as JAX's int8 test has it)."""
    gen = torch.Generator().manual_seed(seed)
    model = compile_model(grid_conf or GridConf(), aug_conf or DataAugConf(),
                          outC=1, variant="b0", compute_dtype=compute_dtype,
                          device="cpu", generator=gen)
    if randomized:
        randomize_bn(model, gen)
    return model.eval()


def _logits(model, args):
    dev = next(model.buffers()).device
    with torch.inference_mode():
        return model(*[torch.as_tensor(a).to(dev) for a in args]).float().cpu()


def int8_vs_float(name, model, args, check: bool) -> str:
    """int8 against float on the card; with ``check`` held to JAX's bounds."""
    qmodel, _ = quant.quantize_model(model)
    ref, got = _logits(model, args), _logits(qmodel, args)
    assert torch.isfinite(got).all(), f"{name}: non-finite int8 logits"
    rel = float((got - ref).abs().max() / ref.abs().max())
    agree = float(((got > 0) == (ref > 0)).float().mean())
    if check:
        assert rel < JAX_INT8_REL and agree > JAX_INT8_AGREE, (name, rel, agree)
    return f"{name} max|Δ| {rel:.4f} of max|logit|, signs agree {agree:.5f}"


def phase_int8(tmp, rng, seed, b0_run):
    """Phase 17. Returns the splat kernel's launches while serving int8."""
    print(f"_int_mm on this card: {int_mm_limits()}", flush=True)
    # (a) the gate on B0, and the int8 artifact served over HTTP
    model = b0_model(seed)
    qmodel, swapped = quant.quantize_model(model)
    want_n = b0_int8_gate_count()
    assert len(swapped) == want_n, (len(swapped), want_n)
    print(f"int8 convs of B0 ({len(swapped)}, the gate's count from the "
          f"block plan {want_n}): {', '.join(swapped)}", flush=True)
    path8 = f"{tmp}/lss_bsz8_u8_int8.pt"
    export_predict(model, path8, bsz=8, uint8_images=True, quantize=True)
    many = inputs(rng, 8, True)
    reset_launches()  # the main path starts here
    with Running(serve(path8, port=0, warmup_args=many, device="cuda")) as base:
        assert get(base, "/healthz")[0] == 200
        served = post(base, many)
    launches = issued("splat")  # the main path ends here
    assert launches > 0, "int8 serving never launched the splat kernel"
    qcard = copy.deepcopy(qmodel).cuda()
    err, scale = assert_close("int8 served", served, _logits(qcard, many).numpy(),
                              SERVE_TOL)
    n_exact = int8_accumulators_exact(qcard, many)
    print(f"int8 artifact (bsz 8, uint8, the int8 program exported on the "
          f"CPU and moved to the card) served "
          f"over HTTP: max |served - live int8| {err:.3e} (tolerance "
          f"{SERVE_TOL} x {scale:.3f}); splat kernel launches {launches}; "
          f"int32 accumulators of all {n_exact} int8 convs, card = CPU bit "
          f"for bit on the served batch", flush=True)
    # (b) card int8 against CPU int8 at bsz 1, B0 and B4 at 400 x 400
    for name in ("b0", "b4"):
        readings = []
        for s in INT8_SEEDS:
            one = inputs(np.random.default_rng(1000 + s), 1, uint8=True)
            x = (one[0].astype(np.float32),) + one[1:]
            cpu = (b0_model(seed + s) if name == "b0" else stretch_model(
                seed + s, "float32", fused_dw=False).cpu().eval())
            qcpu, _ = quant.quantize_model(cpu)
            want = _logits(qcpu, x).numpy()
            got = _logits(copy.deepcopy(qcpu).cuda(), x).numpy()
            readings.append(assert_close(f"{name} int8 card vs CPU", got, want,
                                         INT8_CPU_TOL[name]))
        worst = max(e / sc for e, sc in readings)
        print(f"int8 card vs CPU, {name} bsz 1 f32 TF32 off, seeds "
              f"{seed}-{seed + len(readings) - 1}: max |diff| / max(1, "
              f"max|logit|) {[round(e / sc, 5) for e, sc in readings]} "
              f"(limit {INT8_CPU_TOL[name]}; largest {worst:.5f})", flush=True)
    # (c) int8 against float on the card: JAX's bounds at JAX's test's
    # size (tests/test_quant.py: the tests' tiny config, BN at init, bsz
    # 2, random images, focal length 60; here on this script's rig), then
    # full width as readings
    trng = np.random.default_rng(seed)
    tiny = (trng.normal(size=(2, 6, 3, 32, 64)).astype(np.float32),
            *inputs(trng, 2, False, (32, 64))[1:])
    tiny[3][..., 0, 0] = tiny[3][..., 1, 1] = 60.0
    notes = [int8_vs_float("tiny B0 at BN init, bsz 2 (JAX's test)", b0_model(
        seed, False, grid_conf=TINY_GRID, aug_conf=TINY_AUG).cuda(), tiny,
        check=True)]
    notes.append(int8_vs_float("full width, bsz 8: B0 at BN init", b0_model(
        seed, randomized=False).cuda(), many, False))
    notes.append(int8_vs_float("B0 randomised BN", model.cuda(), many, False))
    trained = b0_model(seed, randomized=False)
    trained.load_state_dict(reference_state_dict(torch.load(
        f"{b0_run}/ckpts/model_best.pt", map_location="cpu",
        weights_only=True)["model_state_dict"]))
    notes.append(int8_vs_float("phase 8's trained B0", trained.cuda(), many,
                               False))
    print("int8 vs float on the card (limits: JAX's test only): "
          + "; ".join(notes), flush=True)
    # (d) times: B0 bsz 8 (f32, bf16, int8 of the bf16 model, as the
    # bench's --quantize), the stretch B4 bsz 4 (bf16, int8), cuDNN TF32 on
    torch.backends.cudnn.allow_tf32 = True
    dev8 = [torch.as_tensor(a).cuda() for a in many]
    bf16 = b0_model(seed, compute_dtype="bfloat16").cuda()
    models = {"f32": model, "bf16": bf16, "int8": quant.quantize_model(bf16)[0]}
    t8 = turns_ms({k: (lambda m=m: m(*dev8)) for k, m in models.items()})
    del models, bf16
    sb = stretch_model(seed, "bfloat16", fused_dw=False).eval()
    dev4 = [torch.as_tensor(a).cuda() for a in inputs(rng, 4, True)]
    s4 = {"bf16": sb, "int8": quant.quantize_model(sb)[0]}
    t4 = turns_ms({k: (lambda m=m: m(*dev4)) for k, m in s4.items()})
    torch.backends.cudnn.allow_tf32 = False
    del s4, sb
    fmt = lambda t, b: ", ".join(f"{k} {v[0] / b:.4f} / {v[1] / b:.4f}"
                                 for k, v in t.items())
    print(f"int8 times (ms per sample, CUDA events, two turns, cuDNN TF32 on, "
          f"uint8 inputs on the card): B0 inference_ms_per_sample_bsz8 "
          f"{fmt(t8, 8)}; stretch B4 400 x 400 bf16 bsz 4 {fmt(t4, 4)}",
          flush=True)
    torch.cuda.empty_cache()
    return launches


# --- phase 18: the bench ------------------------------------------------

BENCH_METRICS = ("train_step_ms_bsz8", "inference_ms_per_sample_bsz8",
                 "train_step_ms_bsz8_bfloat16")


def phase_bench():
    """Phase 18: ``python -m lss_carla_torch.bench --mode all`` as a child
    process; its lines relayed and checked."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "lss_carla_torch.bench", "--mode", "all",
         "--iters", "5", "--warmup", "2"], cwd=os.path.dirname(
            os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    for line in out.stdout.splitlines():
        print(f"  | {line}", flush=True)
    assert out.returncode == 0, out.stderr[-4000:]
    metrics = [json.loads(ln) for ln in out.stdout.splitlines()
               if ln.startswith("{")]
    assert [m["metric"] for m in metrics] == list(BENCH_METRICS), metrics
    for m in metrics:
        assert set(m) == {"metric", "value", "unit", "vs_baseline"}, m
        assert m["unit"] == "ms" and math.isfinite(m["value"]) and m["value"] > 0, m
    steps = [ln for ln in out.stdout.splitlines()
             if ln.startswith("bench: train step")]
    assert "imgs (8, 6, 3, 128, 352) float32" in steps[0] and \
        "binimgs (8, 1, 200, 200), float32," in steps[0], steps
    print(f"bench: three lines under bench.py's names, the f32 step at bsz 8, "
          f"in {time.perf_counter() - t0:.1f} s (a child process)", flush=True)
    return {m["metric"]: m["value"] for m in metrics}


# --- phase 19: nuScenes at full width ------------------------------------

# the original LSS nuScenes config (configs.py::nuscenes_aug): 900 x 1600
# sources, 5 of 6 cameras in training and all 6 in validation
NUSC_STEPS, NUSC_BSZ = 20, 4
NUSC_SCENES, NUSC_SAMPLES = 3, 6  # 2 train scenes (12 samples), 1 val (6)


def lift_and_ids(model, batch):
    """The lift (B, P, C) and voxel ids (B, P) that ``model`` gives the
    splat on a host loader ``batch``."""
    with torch.inference_mode():
        t = [torch.as_tensor(a).cuda() for a in batch[:6]]
        geom = model.get_geometry(*t[1:])
        feats = model.get_cam_feats(t[0])
        ids, _ = voxel_indices(geom, model.dx, model.bx, model.nx)
    B = t[0].shape[0]
    return (feats.reshape(B, -1, model.camC).contiguous(),
            ids.reshape(B, -1).contiguous())


def median_step_ms(run, first: int = 2) -> float:
    """Median of the run's logged ``train/step_time`` from step ``first``
    on (the first steps pick cuDNN's algorithms), in ms."""
    ms = [1e3 * r["train/step_time"] for r in read_metrics(f"{run}/metrics.jsonl")
          if "train/step_time" in r and r["step"] >= first]
    return float(np.median(ms))


def phase_nuscenes(tmp, seed, gen):
    """Phase 19. Returns ({"splat": n, "dw_conv_stats": n} main-path
    launches, the kernels' rows at the nuScenes shapes)."""
    aug = nuscenes_aug()
    t0 = time.perf_counter()
    root = generate_nuscenes_fixture(
        f"{tmp}/nusc", num_scenes=NUSC_SCENES, samples_per_scene=NUSC_SAMPLES,
        H=aug.H, W=aug.W, seed=seed)
    print(f"nuScenes fixture: {NUSC_SCENES} scenes x {NUSC_SAMPLES} samples x "
          f"6 cameras at {aug.H} x {aug.W}, lidar sweeps and a map, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    run = f"{tmp}/nusc_run"
    torch.backends.cudnn.allow_tf32 = True
    reset_launches()  # the nuScenes path starts here
    t0 = time.perf_counter()
    result = train(
        dataroot=str(root), nepochs=10, H=aug.H, W=aug.W,
        resize_lim=aug.resize_lim, final_dim=aug.final_dim,
        bot_pct_lim=aug.bot_pct_lim, rot_lim=aug.rot_lim,
        rand_flip=aug.rand_flip, ncams=aug.Ncams, bsz=NUSC_BSZ, nworkers=6,
        fused_dw=True, max_steps=NUSC_STEPS, val_step=NUSC_STEPS,
        save_step=NUSC_STEPS, iou_log_step=1, viz_step=0, seed=seed,
        dataset="nuscenes", logdir=run, device="cuda")
    train_s = time.perf_counter() - t0
    dw_train, splat_train = issued("dw_conv_stats"), issued("splat")
    info = explore.eval_model_iou(str(root), f"{run}/ckpts", best=True,
                                  dataset="nuscenes", bsz=NUSC_BSZ,
                                  nworkers=6, device="cuda")
    samples, extent = explore.model_preds(
        str(root), f"{run}/ckpts", best=True, dataset="nuscenes",
        max_batches=2, bsz=NUSC_BSZ, device="cuda")
    launches = {"splat": issued("splat"),
                "dw_conv_stats": issued("dw_conv_stats")}  # the path ends here
    assert result["counter"] == NUSC_STEPS, result["counter"]
    assert dw_train == DW_PER_FORWARD * NUSC_STEPS, dw_train
    assert splat_train > NUSC_STEPS, splat_train  # train + val forwards
    assert launches["dw_conv_stats"] == dw_train, launches  # eval: none
    recs = read_metrics(f"{run}/metrics.jsonl")
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    assert losses and all(map(math.isfinite, losses)), losses
    stats = result["decode_stats"]
    assert set(stats["val"]) == {"native_resize"}, stats  # rotation 0
    bad = {k for split in stats.values() for k in split
           if k in ("pil_decode_error", "pil_size_mismatch", "pil_not_jpeg")}
    assert not bad, stats
    print(f"nuScenes train(): B0 at full width (5 of 6 cameras at 128 x 352 "
          f"from 900 x 1600, D 41, 200 x 200 at 0.5 m, outC 1, pos_weight "
          f"2.13), bsz {NUSC_BSZ}, fused_dw, cuDNN TF32, {NUSC_STEPS} steps in "
          f"{train_s:.1f} s (6 loader threads; a validation and checkpoints "
          f"included); losses {', '.join(f'{v:.4f}' for v in losses)}; median "
          f"step {median_step_ms(run):.1f} ms (train/step_time, steps 2-"
          f"{NUSC_STEPS}, synchronised every step); launches: splat "
          f"{splat_train} ({NUSC_STEPS} train + {splat_train - NUSC_STEPS} "
          f"validation forwards), dw_conv_stats {dw_train} (= "
          f"{DW_PER_FORWARD} x {NUSC_STEPS}); decodes {stats}", flush=True)
    print("eval_model_iou on the card, nuScenes, cuDNN TF32: "
          + check_eval("nuScenes B0", run, info)
          + f"; with viz_model_preds' predictions, splat launches "
          f"{launches['splat'] - splat_train}", flush=True)
    assert len(samples) == NUSC_SAMPLES, len(samples)  # 2 of 8 were padding
    for imgs, gt, pred in samples:
        assert imgs.shape == (6, 3, 128, 352) and gt.shape == pred.shape == (200, 200)
        assert np.isfinite(pred).all() and 0.0 <= pred.min() <= pred.max() <= 1.0
    torch.backends.cudnn.allow_tf32 = False

    # the compute parts of the map underlay and of lidar_check
    val_ds = NuScenesDataset(root, False, aug, GridConf())
    poses = explore.map_poses(val_ds, str(root))
    nmap, (x, y), yaw = poses[0]
    lmap = get_local_map(nmap, (x, y, np.cos(yaw), np.sin(yaw)),
                         max(abs(b) for b in extent))
    assert all(p is not None for p in poses), poses
    assert all(np.isfinite(g).all() for gs in lmap.values() for g in gs)
    panels = explore.lidar_panels(str(root), max_samples=1, nsweeps=2,
                                  device="cuda")
    seen = [c.shape[1] for c in panels[0]["cams"]]
    assert panels[0]["points"].shape == (5, 96) and sum(seen) > 0, seen
    assert all(np.isfinite(c).all() for c in panels[0]["cams"])
    if have_matplotlib():
        explore.viz_model_preds(str(root), f"{run}/ckpts", best=True,
                                dataset="nuscenes", map_folder=str(root),
                                outdir=f"{tmp}/nusc_viz", max_batches=1,
                                bsz=NUSC_BSZ, device="cuda")
        explore.lidar_check(str(root), outdir=f"{tmp}/nusc_viz",
                            dataset="nuscenes", max_samples=1, nsweeps=2,
                            device="cuda")
        rendered = f"rendered {sorted(os.listdir(f'{tmp}/nusc_viz'))}"
    else:
        rendered = "not rendered: no matplotlib here"
    print(f"nuScenes map underlay: {len(poses)} val samples, each on its "
          f"scene's map; sample 0's local map {[(k, len(v)) for k, v in lmap.items()]}"
          f" (layer, geometries); lidar_check compute parts: {panels[0]['points'].shape[1]}"
          f" points of 2 sweeps, seen per camera {seen}; {rendered}", flush=True)

    # both kernels at this path's shapes, against their plain versions
    model = result["state"].model.eval()
    trainloader, valloader = compile_data_nuscenes(
        "v1.0-mini", root, aug, GridConf(), bsz=NUSC_BSZ, nworkers=0,
        device_normalize=True, seed=seed)
    S = int(np.prod(model.nx))
    rows = {}
    for name, batch in (("5-camera train batch", next(iter(trainloader))),
                        ("6-camera val batch", next(iter(valloader)))):
        pts, ids = lift_and_ids(model, batch)
        n = batch[0].shape[1]
        assert pts.shape == (NUSC_BSZ, n * 41 * 8 * 22, 64), pts.shape
        print(f"nuScenes splat inputs, {name}: P {pts.shape[1]}, "
              f"{float((ids == S).float().mean()):.3f} of points at the "
              f"sentinel", flush=True)
        rows[name] = check_splat(f"nuScenes {name} f32 S=40000", pts, ids, S)
    dw_err, dw_times = phase_dw(gen, NUSC_BSZ * aug.Ncams,
                                "one nuScenes bsz-4 train forward")

    # one train step with fused_dw on, on the 5-camera batch
    step_model = compile_model(GridConf(), aug, outC=1, variant="b0",
                               fused_dw=True, device="cuda",
                               generator=torch.Generator().manual_seed(seed))
    step = make_train_step(step_model, 2.13, device="cuda")
    batch = tuple(torch.as_tensor(a).cuda() for a in next(iter(trainloader)))
    before = (splat_cuda.launches, mbconv_cuda.launches)
    out = step(create_train_state(step_model), batch)
    torch.cuda.synchronize()
    one = (splat_cuda.launches - before[0], mbconv_cuda.launches - before[1])
    assert one == (1, DW_PER_FORWARD), one
    print(f"one nuScenes train step (bsz 4 x 5 cameras, fused_dw): loss "
          f"{float(out['loss']):.4f}, launches splat {one[0]}, dw_conv_stats "
          f"{one[1]}", flush=True)

    def row(err, t, n):
        return {"launches": n, "max_abs_err": err,
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "segments_ms") if k in t}}
    err, t = rows["5-camera train batch"]
    return launches, {"splat": row(err, t, launches["splat"]),
                      "dw_conv_stats": row(dw_err, dw_times,
                                           launches["dw_conv_stats"])}


# --- phase 20: the decoder on the card's host ----------------------------

FAST_AUG = DataAugConf(resize_lim=(0.70, 0.85))  # recipes/simbev_fast.sh
RECIPE_STEPS = 60  # each run reads the 10-step windows of steps 21-60
RECIPE_TURNS = (True, False, False, True)  # native or PIL


def host_cpu() -> str:
    """The host CPU as the decoder's rates need it named."""
    name = fastimage.cpu_model().split(" | ")[0]
    flags = set(fastimage.cpu_model().split(" | ")[-1].split())
    return (f"{name or 'model not reported'}, {os.cpu_count()} CPUs, "
            + ", ".join(f"{f} {'yes' if f in flags else 'no'}"
                        for f in ("avx2", "avx512f")))


def decoder_vs_pil(files, seed):
    """(max |native - PIL| on the crop-only path, on the resize + flip
    path), uint8 levels, over ``files`` with seeded augmentation draws."""
    gen = torch.Generator().manual_seed(seed)
    crop_aug = DataAugConf()
    resize_aug = DataAugConf(resize_lim=(0.70, 0.85), rand_flip=True)
    worst = [0, 0]
    for i, path in enumerate(files):
        raw = path.read_bytes()
        for j, conf in enumerate((crop_aug, resize_aug)):
            resize, dims, crop, flip, rotate = sample_augmentation(
                conf, True, gen)
            if j == 1 and i % 2:
                flip = True  # half the resize cases flipped, whatever the draw
            img, _, _ = img_transform(Image.open(path), resize, dims, crop,
                                      flip, rotate)
            want = np.asarray(img.convert("RGB")).transpose(2, 0, 1)
            got = (fastimage.decode_crop_u8(raw, crop, (conf.W, conf.H))
                   if j == 0 else
                   fastimage.decode_resize_crop_u8(raw, dims, crop, flip))
            assert j == 1 or (dims == (conf.W, conf.H) and not flip)
            worst[j] = max(worst[j], int(np.abs(got.astype(int) - want).max()))
    return worst


def phase_decoder(tmp, root, seed, card):
    """Phase 20. ``root``: phase 8's SimBEV fixture (224 x 480)."""
    print(f"decoder: built by {fastimage.build_info()}; host CPU {host_cpu()}",
          flush=True)
    bench_root = generate_fixture(f"{tmp}/bench_input", num_scenes=2,
                                  samples_per_scene=16, H=224, W=480, seed=seed)
    files = sorted(bench_root.rglob("*.jpg"))[:32]
    crop_d, resize_d = decoder_vs_pil(files, seed)
    assert resize_d <= 1, resize_d
    assert crop_d == 0, crop_d  # the libjpeg PIL uses: one IDCT, bit-exact
    print(f"decoder against PIL on {len(files)} fixture JPEGs (224 x 480): "
          f"crop-only path max |diff| {crop_d} levels of 255 "
          f"(the same libjpeg as PIL, limit 0), resize + flip path "
          f"(resize 0.70-0.85, every other one flipped) "
          f"max |diff| {resize_d} (limit 1)", flush=True)

    # images a second through the loader, 8 threads, in turns
    for name, conf in (("bench.py's default aug (crop-only path)", DataAugConf()),
                       ("the fast recipe's resize_lim 0.70 0.85 (resize path)",
                        FAST_AUG)):
        rates, stats = {True: [], False: []}, {}
        for native in (True, False, False, True):
            rate, stats[native] = input_images_per_sec(
                bench_root, conf, bsz=8, iters=10, num_workers=8,
                use_native=native)
            rates[native].append(rate)
        want = "native_crop" if conf is not FAST_AUG else "native_resize"
        assert set(stats[True]) == {want} and set(stats[False]) == {"pil_off"}, stats
        print(f"input_pipeline_images_per_sec on {card}, host {host_cpu()}, "
              f"{name}: native {np.mean(rates[True]):.1f} "
              f"({', '.join(f'{r:.1f}' for r in rates[True])}), PIL "
              f"{np.mean(rates[False]):.1f} ({', '.join(f'{r:.1f}' for r in rates[False])})"
              f" (8 threads, bsz 8, 10 epochs of 96 images after one, in turns "
              f"native/PIL/PIL/native); decodes {stats}", flush=True)

    # the fast recipe's train() loop, native and PIL in turns
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as the recipe runs
    kw = dict(dataroot=str(root), nepochs=20, bsz=8, nworkers=4,
              compute_dtype="bfloat16", resize_lim=FAST_AUG.resize_lim,
              lr_schedule="cosine", warmup_steps=500, decay_steps=4000,
              max_steps=RECIPE_STEPS, val_step=0, save_step=0, viz_step=0,
              iou_log_step=10, seed=seed, device="cuda")
    loop_ms, turns, decodes = {True: [], False: []}, [], {}
    for i, native in enumerate(RECIPE_TURNS):
        run = f"{tmp}/recipe_{i}"
        result = train(**kw, use_native=native, logdir=run)
        windows = [1e3 * r["train/step_time"]
                   for r in read_metrics(f"{run}/metrics.jsonl")
                   if "train/step_time" in r and r["step"] > 20]
        assert len(windows) == (RECIPE_STEPS - 20) // 10, windows
        loop_ms[native].append(float(np.mean(windows)))
        turns.append(f"{'native' if native else 'PIL'} {loop_ms[native][-1]:.1f}"
                     f" (windows {min(windows):.1f}-{max(windows):.1f})")
        decodes[native] = result["decode_stats"]["train"]
    step = train_step_fn(False, seed, random_batch(np.random.default_rng(seed), 8),
                         compute_dtype="bfloat16")
    busy, text = profile_train_step(step, 3, (8, 256, 200, 200))
    del step
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    parts = []
    for native in (True, False):
        ms = float(np.mean(loop_ms[native]))
        idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / ms):.3f}"
        parts.append(f"{'native' if native else 'PIL'} mean {ms:.1f} ms a step "
                     f"(runs {min(loop_ms[native]):.1f}-{max(loop_ms[native]):.1f}"
                     f"), idle share {idle}")
    ratios = [n / p for n, p in zip(loop_ms[True], loop_ms[False])]
    assert "pil_decode_error" not in decodes[True], decodes
    print(f"fast recipe train() loop on {card} (B0 bsz 8, bf16, cuDNN TF32, "
          f"resize_lim 0.70 0.85, 4 loader threads, {RECIPE_STEPS} steps on "
          f"phase 8's fixture; each run the mean of train/step_time's 10-step "
          f"windows of steps 21-{RECIPE_STEPS}); runs in turns: "
          f"{'; '.join(turns)}; {'; '.join(parts)}; native / PIL in the "
          f"{len(ratios)} pairs of turns {min(ratios):.3f}-{max(ratios):.3f}; "
          f"idle share = 1 - device busy / loop ms, with device busy "
          f"{busy if busy is None else round(busy, 3)} ms a step from a "
          f"profile of the same bf16 step alone on random batches ({text}); "
          f"decodes {decodes}", flush=True)


# --- phase 21: the parallel modes on one card -----------------------------
#
# NCCL refuses two ranks on one device and this machine has one card, so
# the parallel steps run on gloo ranks that share cuda:0 (gloo all-reduces
# CUDA tensors through host copies), held against an emulation of the
# same step in this process on the same card; then NCCL itself, on a
# one-rank group. Each rank sets its kernels' counters to 0 just before a
# path and reads them just after.

PARALLEL_STEPS = 3   # data-parallel steps with dropout on, then the digests


def b0_for(seed: int, train: bool, fused_dw: bool = False,
           compute_dtype: str = "float32"):
    """The B0 default model of ``seed`` on the card: for training with
    dropout and drop-connect 0, or for eval with randomised BN."""
    gen = torch.Generator().manual_seed(seed)
    model = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                          fused_dw=fused_dw, compute_dtype=compute_dtype,
                          device="cpu", generator=gen)
    if train:
        zero_dropout(model)
    else:
        randomize_bn(model, gen)
    return model.cuda().train(train)


def parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of phase 21 on cuda:0 (spawned): its results to
    ``tmp/rank<r>-of-<world>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pmesh.init_process(rank, world, f"file://{tmp}/store{world}", dev,
                       backend="gloo")
    p = torch.load(f"{tmp}/payload.pt", weights_only=False)
    seed = p["seed"]
    batch = tuple(torch.as_tensor(a).to(dev) for a in p["batch"])
    rows = tuple(x[:2] for x in batch)
    out = {}

    def launched(key, fn):
        """Run ``fn`` as a counted path: out[key + "_launches"]."""
        reset_launches()
        result = fn()
        torch.cuda.synchronize()
        out[key + "_launches"] = {"splat": splat_cuda.launches,
                                  "dw_conv_stats": mbconv_cuda.launches}
        return result

    try:
        if world == 2:
            mesh = pmesh.make_mesh(2, dev)
            model = b0_for(seed, True, fused_dw=True)
            step = pstep.make_sharded_train_step(model, mesh, 2.13, seed=seed)
            m = launched("dp", lambda: step(create_train_state(model),
                                            pmesh.shard_batch(mesh, batch)))
            out["dp"] = step_result(model, m)
            pmesh.check_replicated(model, mesh)
            # the EMA's BN recalibration across the ranks, as the trainer
            # runs it: every BN takes the ranks' batches' moments, the fused
            # bn1 from the depthwise kernel's sums summed over the ranks
            model = b0_for(seed, True, fused_dw=True)
            launched("dp_recal", lambda: recalibrate_bn(
                model, [pmesh.shard_batch(mesh, batch)], dist.group.WORLD))
            out["dp_recal"] = running_stats_of(model)
            # PARALLEL_STEPS steps with dropout on: the masks differ by
            # rank, the replicas must not
            model = compile_model(GridConf(), DataAugConf(), outC=1,
                                  variant="b0", fused_dw=True, device="cuda",
                                  generator=torch.Generator().manual_seed(seed))
            state = create_train_state(model)
            step = pstep.make_sharded_train_step(model, mesh, 2.13, seed=seed)
            ms = []

            def steps():
                for i in range(PARALLEL_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(state, pmesh.shard_batch(
                        mesh, tuple(np.roll(a, i, 0) for a in p["batch"])))
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
            launched("dp_dropout", steps)
            out["dp_digest"] = pmesh.check_replicated(model, mesh)
            out["dp_ms"] = ms
            mesh = pmesh.make_mesh_2d(1, 2, dev)
        else:
            mesh = pmesh.make_mesh_2d(1, 3, dev)
        model = b0_for(seed, False)
        predict = pcamera.make_camera_sharded_predict(model, mesh)
        out["cam_logits"] = launched(
            "cam", lambda: predict(None, rows[:6])).cpu()
        if world == 2:
            model = b0_for(seed, True)
            step = pcamera.make_camera_sharded_train_step(model, mesh, 2.13,
                                                          seed=seed)
            m = launched("cam_train",
                         lambda: step(create_train_state(model), rows))
            out["cam_train"] = step_result(model, m)
            pmesh.check_replicated(model, mesh)
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}-of-{world}.pt")


def running_stats_of(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def run_parallel_ranks(tmp: str, world: int) -> list:
    t0 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(world, tmp), nprocs=world,
                       start_method="spawn")
    outs = [torch.load(f"{tmp}/rank{r}-of-{world}.pt", weights_only=False)
            for r in range(world)]
    print(f"parallel: {world} gloo ranks on cuda:0 ran in "
          f"{time.perf_counter() - t0:.1f} s (spawn, build, steps)", flush=True)
    return outs


def emulate_dp(seed: int, batch):
    """The data-parallel step over 2 ranks in one process: each half's
    train-mode forward and backward in turn from the same running stats,
    the gradients and the stats averaged, one clip and Adam. Returns
    (step_result, the parameters before)."""
    model = b0_for(seed, True, fused_dw=True)
    before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    state = create_train_state(model)
    stats = pstep.running_stats(model)
    start = [t.clone() for t in stats]
    ends, losses = [], []
    for half in (slice(0, 2), slice(2, 4)):
        torch._foreach_copy_(stats, start)
        part = tuple(x[half] for x in batch)
        loss = bce_with_logits(model(*part[:6]), part[6], 2.13)
        loss.backward()
        losses.append(loss.detach())
        ends.append([t.clone() for t in stats])
    with torch.no_grad():
        torch._foreach_copy_(stats, [(a + b) * 0.5 for a, b in zip(*ends)])
        grads = [q.grad for q in state.optimizer.params if q.grad is not None]
        torch._foreach_mul_(grads, 0.5)
    norm = state.optimizer.step(0)
    return step_result(model, {"loss": (losses[0] + losses[1]) * 0.5,
                               "grad_norm": norm}), before


def emulate_camera(seed: int, rows):
    """The (1, 2) camera step in one process: each camera half lifted in
    train mode from the same running stats, the partial BEVs summed, one
    decode; the camera encoder's stats averaged over the halves."""
    model = b0_for(seed, True)
    before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    state = create_train_state(model)
    stats = pstep.running_stats(model)
    start = [t.clone() for t in stats]
    ends, partial = [], []
    for cams in (slice(0, 3), slice(3, 6)):
        torch._foreach_copy_(stats, start)
        partial.append(model.get_voxels(*(x[:, cams] for x in rows[:6])))
        ends.append([t.clone() for t in stats])
    with torch.no_grad():
        torch._foreach_copy_(stats, [(a + b) * 0.5 for a, b in zip(*ends)])
    loss = bce_with_logits(model.decode_bev(partial[0] + partial[1]), rows[6],
                           2.13)
    loss.backward()
    norm = state.optimizer.step(0)
    return step_result(model, {"loss": loss.detach(), "grad_norm": norm}), before


class exact_reduction:
    """Within ``with exact_reduction() as seen:``, the data-parallel step's
    all-reduce is checked to leave every gradient, running stat and the
    loss bit for bit (a one-rank mean); ``seen`` counts the calls."""

    def __enter__(self):
        self.saved, self.calls = pstep.reduce_train, []

        def checked(state, metrics, group, n_mean, n_count=1):
            tensors = ([q.grad for q in state.optimizer.params
                        if q.grad is not None]
                       + pstep.running_stats(state.model) + [metrics["loss"]])
            copies = [t.clone() for t in tensors]
            out = self.saved(state, metrics, group, n_mean, n_count)
            assert all(torch.equal(a, b) for a, b in zip(copies, tensors)), \
                "a one-rank all-reduce changed the step"
            self.calls.append(n_mean)
            return out
        pstep.reduce_train = checked
        return self.calls

    def __exit__(self, *exc):
        pstep.reduce_train = self.saved


def phase_parallel_nccl(tmp: str, seed: int, rows) -> tuple:
    """Phase 21 (b): NCCL on a one-rank group. Returns (launches, readings)."""
    dev = torch.device("cuda", 0)
    pmesh.init_process(0, 1, f"file://{tmp}/nccl-store", dev)
    launches = {"splat": 0, "dw_conv_stats": 0}
    notes = []
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = pmesh.make_mesh(1, dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(1 << 20, device=dev).to(dtype)
            y = x.clone()
            dist.all_reduce(y)
            assert torch.equal(x, y), f"a one-rank {dtype} all-reduce moved"
        for compute in ("float32", "bfloat16"):
            single = b0_for(seed, True, fused_dw=True, compute_dtype=compute)
            before = {k: v.detach().cpu().clone()
                      for k, v in single.named_parameters()}
            want = step_result(single, make_train_step(single, 2.13, device=dev)(
                create_train_state(single), rows))
            model = b0_for(seed, True, fused_dw=True, compute_dtype=compute)
            step = pstep.make_sharded_train_step(model, mesh, 2.13, seed=seed)
            reset_launches()
            with exact_reduction() as calls:
                got = step_result(model, step(create_train_state(model), rows))
            torch.cuda.synchronize()
            launches["splat"] += splat_cuda.launches
            launches["dw_conv_stats"] += mbconv_cuda.launches
            assert calls == [1] and (splat_cuda.launches, mbconv_cuda.launches) \
                == (1, DW_PER_FORWARD), (calls, splat_cuda.launches,
                                         mbconv_cuda.launches)
            if compute == "float32":
                notes.append(f"f32 against the single-device step (phase 9's "
                             f"limits): {check_step(got, want, before)}")
            else:
                rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
                gn = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
                assert math.isfinite(got["loss"]) and math.isfinite(got["grad_norm"])
                notes.append(f"bf16: loss {got['loss']:.6f} vs {want['loss']:.6f} "
                             f"(relative {rel:.2e}), grad norm relative {gn:.2e} "
                             f"(a reading: only the splat's atomic order differs)")
    finally:
        dist.destroy_process_group()
    return launches, "; ".join(notes)


def phase_parallel(tmp: str, seed: int, card: str) -> dict:
    """Phase 21. Returns the parallel paths' launches, by path and kernel."""
    t_phase = time.perf_counter()
    tmp = f"{tmp}/parallel"
    os.makedirs(tmp)
    rng = np.random.default_rng(seed + 21)
    batch = (*inputs(rng, 4, uint8=True),
             (rng.uniform(size=(4, 1, 200, 200)) < 0.02).astype(np.float32))
    torch.save({"seed": seed, "batch": batch}, f"{tmp}/payload.pt")
    two, three = run_parallel_ranks(tmp, 2), run_parallel_ranks(tmp, 3)
    dev_batch = tuple(torch.as_tensor(a).cuda() for a in batch)
    rows = tuple(x[:2] for x in dev_batch)

    # (a) data parallel: one step against the emulation, replicas equal
    for r, out in enumerate(two):
        assert out["dp_launches"] == {"splat": 1, "dw_conv_stats": DW_PER_FORWARD}, \
            (r, out["dp_launches"])
        assert out["dp_dropout_launches"] == {
            "splat": PARALLEL_STEPS,
            "dw_conv_stats": DW_PER_FORWARD * PARALLEL_STEPS}, out
    want, before = emulate_dp(seed, dev_batch)
    dp_text = check_step(two[0]["dp"], want, before)
    for k, v in two[0]["dp"]["params"].items():
        assert torch.equal(v, two[1]["dp"]["params"][k]), k
    assert two[0]["dp_digest"] == two[1]["dp_digest"]
    # the recalibration across the ranks against one process's over the
    # whole batch (the same kernels), to phase 9's running-stats limit
    for r, out in enumerate(two):
        assert out["dp_recal_launches"] == {
            "splat": 1, "dw_conv_stats": DW_PER_FORWARD}, (r, out)
    model = b0_for(seed, True, fused_dw=True)
    recalibrate_bn(model, [dev_batch])
    worst_recal = 0.0
    for k, v in running_stats_of(model).items():
        got = two[0]["dp_recal"][k]
        used = ((got - v).abs() / (STATS_TOL * v.abs() + 1e-6)).max().item()
        assert used <= 1.0, (k, used)
        assert torch.equal(got, two[1]["dp_recal"][k]), k
        worst_recal = max(worst_recal, used)
    ms = two[0]["dp_ms"]
    print(f"parallel, data: 2 gloo ranks x bsz 2 on cuda:0 (B0 full width, "
          f"fused_dw, f32, TF32 off, dropout 0) against the step emulated in "
          f"one process (each half's forward and backward, gradients and "
          f"running stats averaged, one clip and Adam): {dp_text}; the ranks' "
          f"parameters bit-equal; {PARALLEL_STEPS} steps with dropout on: "
          f"replicas bit-equal (sha256 {two[0]['dp_digest'][:16]}); launches "
          f"a rank a step: splat 1, dw_conv_stats {DW_PER_FORWARD}; the EMA's BN "
          f"recalibration across the 2 ranks (fused_dw, one launch of each "
          f"kernel a rank and forward) against one process's over the whole "
          f"batch: {len(two[0]['dp_recal'])} running stats within {STATS_TOL} "
          f"relative + 1e-6 (at most {worst_recal:.2f} of it), bit-equal on "
          f"the ranks; gloo step "
          f"ms on {card} (rank 0, host clock, a reading only: gloo copies "
          f"through the host) {', '.join(f'{v:.1f}' for v in ms)}", flush=True)

    # (a) camera parallel: the predict at (1, 2) and (1, 3), one (1, 2) step
    model = b0_for(seed, False)
    with torch.no_grad():
        ref = model(*rows[:6]).cpu().numpy()
    errs = []
    for outs in (two, three):
        for r, out in enumerate(outs):
            assert out["cam_launches"] == {"splat": 1, "dw_conv_stats": 0}, \
                (len(outs), r, out["cam_launches"])
            err, scale = assert_close(f"camera predict (1, {len(outs)}) rank {r}",
                                      out["cam_logits"].numpy(), ref, SERVE_TOL)
            errs.append(err)
    want, before = emulate_camera(seed, rows)
    cam_text = check_step(two[0]["cam_train"], want, before)
    for k, v in two[0]["cam_train"]["params"].items():
        assert torch.equal(v, two[1]["cam_train"]["params"][k]), k
    for out in two:
        assert out["cam_train_launches"] == {"splat": 1, "dw_conv_stats": 0}, out
    points = 2 * 3 * 41 * 8 * 22
    print(f"parallel, camera: the sharded predict at (data 1, cam 2) and (1, "
          f"3), bsz 2, eval, against the unsharded forward on the card: max "
          f"|diff| {max(errs):.3e} (limit {SERVE_TOL} x {scale:.3f}); each "
          f"rank launched the splat once, on its {points} points at (1, 2) "
          f"(of {2 * points}); one (1, 2) train step (dropout 0, f32) against "
          f"the emulation (each camera half lifted in train mode, BEVs summed, "
          f"one decode): {cam_text}; the ranks' parameters bit-equal",
          flush=True)

    # (b) NCCL, one rank
    nccl_launches, nccl_text = phase_parallel_nccl(tmp, seed, rows)
    print(f"parallel, NCCL on a one-rank group (cuda:0): a one-rank "
          f"all-reduce leaves f32 and bf16 tensors bit for bit, and inside the "
          f"data-parallel step every gradient, running stat and the loss; "
          f"{nccl_text}", flush=True)
    launches = {
        "data": {k: sum(o["dp_launches"][k] + o["dp_dropout_launches"][k]
                        + o["dp_recal_launches"][k] for o in two)
                 for k in ("splat", "dw_conv_stats")},
        "camera": {k: sum(o["cam_launches"][k] for o in two + three)
                   + sum(o["cam_train_launches"][k] for o in two)
                   for k in ("splat", "dw_conv_stats")},
        "nccl": nccl_launches}
    print(f"parallel launches (all ranks): {launches}; phase 21 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --- phase 22: the BEV-grid mode on gloo ranks ---------------------------
# As phase 21: gloo ranks share cuda:0, their exchanges staged through the
# host (parallel/halo.py). The grid step is the single-device step on the
# whole batch (global-batch BN, the global mean loss), so it is held to
# that step itself, to phase 9's limits.

GRID_STEPS = 3   # grid steps with dropout on, then the digests
GRID_BSZ = 4


def grid_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of phase 22 on cuda:0 (spawned): the grid predict at
    (1, 2) or at (1, 4) and (2, 2), one train step at (1, 2) and (2, 2),
    GRID_STEPS steps with dropout on at (2, 2), the stretch predict at (1,
    2); its results to ``tmp/grid<r>-of-<world>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pmesh.init_process(rank, world, f"file://{tmp}/grid-store{world}", dev,
                       backend="gloo")
    p = torch.load(f"{tmp}/grid-payload.pt", weights_only=False)
    seed, out = p["seed"], {}
    batch = tuple(torch.as_tensor(a).to(dev) for a in p["batch"])

    def launched(key, fn):
        reset_launches()
        result = fn()
        torch.cuda.synchronize()
        out[key + "_launches"] = {"splat": splat_cuda.launches,
                                  "dw_conv_stats": mbconv_cuda.launches}
        return result

    try:
        for shape in ([(1, 2)] if world == 2 else [(1, 4), (2, 2)]):
            mesh = pmesh.make_mesh_grid(*shape, dev)
            rows = pgrid.shard_batch_grid(mesh, batch)
            predict = pgrid.make_grid_sharded_predict(b0_for(seed, False), mesh)
            out[f"predict{shape}"] = launched(
                f"predict{shape}", lambda: predict(None, rows[:6])).cpu()
            out["data_index", shape] = mesh.data_index
            if shape != (1, 4):
                model = b0_for(seed, True)
                step = pgrid.make_grid_sharded_train_step(model, mesh, 2.13,
                                                          seed=seed)
                m = launched(f"train{shape}",
                             lambda: step(create_train_state(model), rows))
                out[f"train{shape}"] = step_result(model, m)
                pmesh.check_replicated(model, mesh)
            if shape == (2, 2):
                model = compile_model(
                    GridConf(), DataAugConf(), outC=1, variant="b0",
                    device="cuda",
                    generator=torch.Generator().manual_seed(seed))
                state = create_train_state(model)
                step = pgrid.make_grid_sharded_train_step(model, mesh, 2.13,
                                                          seed=seed)
                ms = []

                def steps():
                    for i in range(GRID_STEPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        step(state, pgrid.shard_batch_grid(mesh, tuple(
                            np.roll(a, i, 0) for a in p["batch"])))
                        torch.cuda.synchronize()
                        ms.append(1e3 * (time.perf_counter() - t0))
                launched("dropout", steps)
                out["digest"] = pmesh.check_replicated(model, mesh)
                out["ms"] = ms
            if shape == (1, 2):
                model = stretch_model(seed, "float32", fused_dw=False).eval()
                srows = pgrid.shard_batch_grid(mesh, tuple(
                    torch.as_tensor(a).to(dev) for a in p["stretch"]))
                predict = pgrid.make_grid_sharded_predict(model, mesh)
                del model
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                out["stretch"] = launched(
                    "stretch", lambda: predict(None, srows[:6])).cpu()
                out["stretch_peak"] = torch.cuda.max_memory_allocated() - before
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{tmp}/grid{rank}-of-{world}.pt")


def phase_grid(tmp: str, seed: int, card: str) -> dict:
    """Phase 22. Returns the grid paths' launches, by kernel (all ranks)."""
    t_phase = time.perf_counter()
    tmp = f"{tmp}/grid"
    os.makedirs(tmp)
    rng = np.random.default_rng(seed + 22)
    batch = (*inputs(rng, GRID_BSZ, uint8=True),
             (rng.uniform(size=(GRID_BSZ, 1, 200, 200)) < 0.02).astype(np.float32))
    stretch = inputs(rng, 2, uint8=True)
    torch.save({"seed": seed, "batch": batch, "stretch": stretch},
               f"{tmp}/grid-payload.pt")
    outs = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        mp.start_processes(grid_rank, args=(world, tmp), nprocs=world,
                           start_method="spawn")
        outs[world] = [torch.load(f"{tmp}/grid{r}-of-{world}.pt",
                                  weights_only=False) for r in range(world)]
        print(f"grid: {world} gloo ranks on cuda:0 ran in "
              f"{time.perf_counter() - t0:.1f} s (spawn, steps)", flush=True)
    dev_batch = tuple(torch.as_tensor(a).cuda() for a in batch)

    # the predict against the unsharded forward; each rank's splat launches
    model = b0_for(seed, False)
    with torch.no_grad():
        ref = model(*dev_batch[:6]).cpu().numpy()
    errs, notes = [], []
    for world, shape in ((2, (1, 2)), (4, (1, 4)), (4, (2, 2))):
        rows = GRID_BSZ // shape[0]
        for r, out in enumerate(outs[world]):
            assert out[f"predict{shape}_launches"] == {
                "splat": 1, "dw_conv_stats": 0}, (shape, r, out)
            d = out["data_index", shape]
            err, scale = assert_close(f"grid predict {shape} rank {r}",
                                      out[f"predict{shape}"].numpy(),
                                      ref[d * rows:(d + 1) * rows], SERVE_TOL)
            errs.append(err)
    # one train step against the single-device step on the whole batch
    single = b0_for(seed, True)
    before = {k: v.detach().cpu().clone() for k, v in single.named_parameters()}
    want = step_result(single, make_train_step(single, 2.13, device="cuda")(
        create_train_state(single), dev_batch))
    for world, shape in ((2, (1, 2)), (4, (2, 2))):
        notes.append(f"{shape}: " + check_step(outs[world][0][f"train{shape}"],
                                               want, before))
        for r, out in enumerate(outs[world]):
            assert out[f"train{shape}_launches"] == {
                "splat": 1, "dw_conv_stats": 0}, (shape, r, out)
            for k, v in outs[world][0][f"train{shape}"]["params"].items():
                assert torch.equal(v, out[f"train{shape}"]["params"][k]), k
    digests = {out["digest"] for out in outs[4]}
    assert len(digests) == 1, digests
    for out in outs[4]:
        assert out["dropout_launches"] == {"splat": GRID_STEPS,
                                           "dw_conv_stats": 0}, out
    # the stretch model's grid predict against its unsharded forward, and
    # the peak memory of each against one process's forward
    model = stretch_model(seed, "float32", fused_dw=False).eval()
    dev_stretch = [torch.as_tensor(a).cuda() for a in stretch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        sref = model(*dev_stretch).cpu().numpy()
    single_peak = torch.cuda.max_memory_allocated() - before
    del model
    torch.cuda.empty_cache()
    serrs = []
    for r, out in enumerate(outs[2]):
        assert out["stretch_launches"] == {"splat": 1, "dw_conv_stats": 0}, out
        serrs.append(assert_close(f"grid stretch predict rank {r}",
                                  out["stretch"].numpy(), sref, SERVE_TOL))
    gib = 2.0 ** 30
    print(f"grid: the predict at (data, grid) (1, 2), (1, 4) and (2, 2), B0 "
          f"bsz {GRID_BSZ} eval (randomised BN, f32, TF32 off), against the "
          f"unsharded forward on the card: max |diff| {max(errs):.3e} (limit "
          f"{SERVE_TOL} x {scale:.3f}); each rank launched the splat once, on "
          f"its {GRID_BSZ // 2} or 1 lift rows; one train step (dropout 0) at "
          f"(1, 2) and (2, 2) against the single-device step on the whole "
          f"batch (phase 9's limits), each rank's parameters bit-equal: "
          f"{'; '.join(notes)}; {GRID_STEPS} steps at (2, 2) with dropout on: "
          f"replicas bit-equal (sha256 {digests.pop()[:16]}), gloo step ms on "
          f"{card} (rank 0, host clock, a reading only: every exchange goes "
          f"through the host) {', '.join(f'{v:.1f}' for v in outs[4][0]['ms'])}"
          f"; the stretch model (B4, 400 x 400, 4 classes, f32) bsz 2 at (1, "
          f"2) against its unsharded forward: max |diff| "
          f"{max(e for e, _ in serrs):.3e} (limit {SERVE_TOL} x "
          f"{serrs[0][1]:.3f}); the forward's peak device memory above what "
          f"was allocated before it, a rank "
          f"{', '.join(f'{o['stretch_peak'] / gib:.3f}' for o in outs[2])} GiB "
          f"against the single-device forward's {single_peak / gib:.3f} GiB "
          f"(max_memory_allocated, a reading)", flush=True)
    launches = {k: sum(n[k] for o in outs[2] + outs[4] for key, n in o.items()
                       if isinstance(key, str) and key.endswith("_launches"))
                for k in ("splat", "dw_conv_stats")}
    print(f"grid launches (all ranks): {launches}; phase 22 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --- phase 23: activation rematerialisation -----------------------------

REMAT_TURNS = (False, True, True, False)
REMAT_STEPS = 3


def remat_step(seed, remat, batch):
    """One B0 train step (fused_dw, dropout 0, f32) with or without remat:
    (step_result, launches, parameters before)."""
    model = b0_for(seed, True, fused_dw=True)
    model.remat = remat
    before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    state = create_train_state(model)
    step = make_train_step(model, 2.13, device="cuda")
    reset_launches()
    m = step(state, batch)
    torch.cuda.synchronize()
    launches = {"splat": splat_cuda.launches,
                "dw_conv_stats": mbconv_cuda.launches}
    counts = {b.item() for k, b in model.named_buffers()
              if k.endswith("num_batches_tracked")}
    assert counts == {1}, (remat, counts)  # every running stat updated once
    return step_result(model, m), launches, before


def phase_remat(seed: int, card: str) -> dict:
    """Phase 23. Returns the remat path's launches, by kernel."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 23)
    batch = tuple(torch.as_tensor(a).cuda() for a in (
        *inputs(rng, 4, uint8=True),
        (rng.uniform(size=(4, 1, 200, 200)) < 0.02).astype(np.float32)))
    plain, plain_launches, before = remat_step(seed, False, batch)
    got, launches, _ = remat_step(seed, True, batch)
    assert plain_launches == {"splat": 1, "dw_conv_stats": DW_PER_FORWARD}, \
        plain_launches
    assert launches == {"splat": 1, "dw_conv_stats": 2 * DW_PER_FORWARD}, \
        launches
    text = check_step(got, plain, before)
    # the stretch step, remat off and on in turns: peak memory and step ms
    srng = np.random.default_rng(seed + 230)
    sbatch = tuple(torch.as_tensor(a).cuda() for a in (
        *inputs(srng, 4, uint8=True),
        (srng.uniform(size=(4, STRETCH_CLASSES, 400, 400)) < 0.02).astype(
            np.float32)))
    models = {}
    for remat in (False, True):
        model = stretch_model(seed, "bfloat16", fused_dw=True).train()
        model.remat = remat
        models[remat] = (model, create_train_state(model),
                         make_train_step(model, 2.13, device="cuda"))
        models[remat][2](models[remat][1], sbatch)  # warm-up
    readings = {False: [], True: []}
    for remat in REMAT_TURNS:
        model, state, step = models[remat]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(REMAT_STEPS):
            step(state, sbatch)
        torch.cuda.synchronize()
        readings[remat].append((
            (time.perf_counter() - t0) * 1e3 / REMAT_STEPS,
            (torch.cuda.max_memory_allocated() - before) / 2.0 ** 30))
    del models
    torch.cuda.empty_cache()
    fmt = lambda r: ", ".join(f"{ms:.1f} ms / {gb:.3f} GiB" for ms, gb in r)  # noqa: E731
    print(f"remat: one B0 train step at bsz 4 (fused_dw, dropout 0, f32, TF32 "
          f"off) with remat against the same step without (phase 9's "
          f"limits): {text}; every BN's running stats updated once "
          f"(num_batches_tracked 1); launches a step with remat: splat "
          f"{launches['splat']}, dw_conv_stats {launches['dw_conv_stats']} "
          f"(without: {plain_launches['dw_conv_stats']}); the stretch step "
          f"(B4 bf16, 400 x 400, 4 classes, fused_dw, bsz 4) on {card}, "
          f"mean of {REMAT_STEPS} steps and their peak memory above what was "
          f"allocated before them (max_memory_allocated) in turns "
          f"{REMAT_TURNS}: remat off {fmt(readings[False])}; remat on "
          f"{fmt(readings[True])} (readings; host clock, synchronised); phase "
          f"23 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --- phase 24: the exported program, loaded without the model code ------

LOAD_ALONE = """
import json, sys
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from lss_carla_torch.ops import splat_cuda
from lss_carla_torch.serving import load_predict
from lss_carla_torch.utils import graph
inputs, pairs = sys.argv[1], sys.argv[2:]
args = tuple(np.load(inputs)[f"a{i}"] for i in range(6))
info = {}
for path, out in zip(pairs[::2], pairs[1::2]):
    predict = load_predict(path, device="cuda")
    predict(*args)  # warm-up: the graph's capture
    splat_cuda.reset_launches()
    graph.reset_replayed()
    np.save(out, predict(*args).cpu().numpy())
    info[path] = {"splat": splat_cuda.launches + sum(graph.replayed["splat"].values()),
                  "replays": predict.replays, "moved_from": predict.moved_from}
models = [m for m in sys.modules if m.startswith("lss_carla_torch.models")]
assert not models, models
print(json.dumps(info))
"""


def phase_export(tmp: str, seed: int) -> dict:
    """Phase 24. Returns the splat launches of the exported programs'
    loads, by artifact."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 24)
    args = inputs(rng, 2, uint8=True)
    np.savez(f"{tmp}/export-inputs.npz", **{f"a{i}": a for i, a in enumerate(args)})
    model = b0_for(seed, False)
    lives = {"f32": model, "int8": quant.quantize_model(model)[0]}
    paths = {name: f"{tmp}/export-{name}.pt2" for name in lives}
    exported = {}
    for name, path in paths.items():
        t0 = time.perf_counter()
        export_predict(model, path, bsz=2, uint8_images=True,
                       quantize=name == "int8")
        exported[name] = (time.perf_counter() - t0, os.path.getsize(path) / 1e6)
    # both programs loaded and run by one fresh interpreter
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_ALONE, f"{tmp}/export-inputs.npz",
         *[x for name, path in paths.items()
           for x in (path, f"{tmp}/export-{name}.npy")]],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    t_load = time.perf_counter() - t0
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    notes, launches = [], {}
    for name, path in paths.items():
        assert info[path] == {"splat": 1, "replays": 1, "moved_from": None}, info
        launches[name] = info[path]["splat"]
        err, scale = assert_close(f"exported {name} vs live",
                                  np.load(f"{tmp}/export-{name}.npy"),
                                  _logits(lives[name], args).numpy(), SERVE_TOL)
        notes.append(f"{name}: max |diff| {err:.3e} (limit {SERVE_TOL} x "
                     f"{scale:.3f}), export {exported[name][0]:.1f} s, "
                     f"{exported[name][1]:.1f} MB")
    reset_launches()
    with Running(serve(paths["f32"], port=0, warmup_args=args,
                       device="cuda")) as base:
        served = post(base, args)
    launches["http"] = issued("splat")
    err, _ = assert_close("exported f32 over HTTP", served,
                          np.load(f"{tmp}/export-f32.npy"), SERVE_TOL)
    print(f"export: B0 (randomised BN, f32, TF32 off, bsz 2, uint8 "
          f"signature) as a torch.export program, f32 and int8 (ops/quant.py "
          f"baked in), both loaded in one fresh interpreter that imports no "
          f"module of lss_carla_torch.models and launched the splat kernel "
          f"once a forward of each (lss::splat in the graph), against the "
          f"live model on the card: {'; '.join(notes)}; the interpreter "
          f"(start, two loads, four forwards) {t_load:.1f} s; the f32 "
          f"artifact served once over HTTP by server.py: max |diff| "
          f"{err:.3e} against the subprocess's logits, {launches['http']} "
          f"splat launches (warm-up and request); phase 24 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --- phase 25: the pretrained trunk ------------------------------------
# The file is a seeded efficientnet_pytorch-named B0 ImageNet state dict
# with the classifier head (``convert.synthetic_imagenet_state_dict``:
# He-scaled convs, positive BN variances), so an eval forward stays finite
# and card against CPU compares numbers, not NaNs.

# the EMA re-seeded from the merged trunk, after one EMA step of equal
# tensors at lr 0: |ema - file| <= EMA_RTOL x max |file|, per tensor
EMA_RTOL = 1e-6
TRUNK = "camencode.trunk."


class StepLosses:
    """Keeps the loss of every step of the single-device train step that
    ``train()`` builds while in use (``loop.make_train_step`` wrapped)."""

    def __enter__(self):
        self.saved, self.losses = loop.make_train_step, []

        def make(*args, **kw):
            step = self.saved(*args, **kw)

            def recorded(state, batch):
                metrics = step(state, batch)
                self.losses.append(metrics["loss"].detach())
                return metrics
            return recorded
        loop.make_train_step = make
        return self

    def __exit__(self, *exc):
        loop.make_train_step = self.saved


def trunk_params(model) -> dict:
    return {k: v.detach().cpu()
            for k, v in model.camencode.trunk.named_parameters()}


def phase_pretrained(tmp: str, root, b0_run: str, seed: int) -> dict:
    """Phase 25 on phase 8's fixture (``root``) and run (``b0_run``).
    Returns its launches by kernel: the served forward and three train()
    runs, counted from 0 just before the first and read after the last."""
    t_phase = time.perf_counter()
    path = f"{tmp}/efficientnet-b0-synthetic.pth"
    sd = synthetic_imagenet_state_dict("b0", seed)
    torch.save(sd, path)
    want = imagenet_trunk_state_dict(sd, "b0")

    # (a) the merge at full width on the card: the trunk is the file's bit
    # for bit, every other tensor (num_batches_tracked too) as it was
    model = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                          device="cpu",
                          generator=torch.Generator().manual_seed(seed)).cuda()
    before = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    merge_trunk_state_dict(model, trunk_state_dict_from_checkpoint(path, "b0"))
    merged = 0
    for k, v in model.state_dict().items():
        name = k[len(TRUNK):]
        if k.startswith(TRUNK) and name in want:
            assert torch.equal(v.cpu(), want[name]), k
            merged += 1
        else:
            assert torch.equal(v.cpu(), before[k]), k
    assert merged == len(want), (merged, len(want))

    # (b) the merged model served on the card against the CPU (phase 4's
    # limit, bsz 1, f32, TF32 off) on uint8 images, normalised in the
    # program as served. (Phase 4 feeds 0-255 floats to a float program;
    # through this trunk that runs every BN far outside its statistics)
    art = f"{tmp}/pretrained-b0.pt2"
    export_predict(copy.deepcopy(model).cpu().eval(), art, bsz=1,
                   uint8_images=True)
    del model
    one = inputs(np.random.default_rng(seed + 25), 1, uint8=True)
    reset_launches()  # phase 25's path starts here
    cpu_logits = load_predict(art, device="cpu")(*one).numpy()
    err, scale = assert_close(
        "pretrained B0, card vs CPU",
        load_predict(art, device="cuda")(*one).cpu().numpy(), cpu_logits,
        CPU_TOL)
    logit_max = float(np.abs(cpu_logits).max())

    # (c) train() from the file: one step at lr 0 with EMA (the trunk stays
    # the file's, the EMA re-seeded from it), then 3 steps at the default lr
    kw = dict(dataroot=str(root), nepochs=2, bsz=4, nworkers=6, fused_dw=True,
              val_step=0, save_step=0, viz_step=0, iou_log_step=10,
              seed=seed, device="cuda", pretrained_trunk=path)
    dw0, splat0 = issued("dw_conv_stats"), issued("splat")
    state = train(**kw, lr=0.0, weight_decay=0.0, ema_decay=0.999,
                  max_steps=1, logdir=f"{tmp}/pretrained-lr0")["state"]
    dw1, splat1 = issued("dw_conv_stats") - dw0, issued("splat") - splat0
    assert dw1 == DW_PER_FORWARD, (
        f"{dw1} depthwise launches for one train forward (want "
        f"{DW_PER_FORWARD})")
    assert splat1 >= 1, "train(pretrained_trunk=...) never launched the splat"
    for k, v in trunk_params(state.model).items():
        assert torch.equal(v, want[k]), f"trunk {k} moved at lr 0"
    ema_worst = 0.0
    for k, v in trunk_params(state.ema_model).items():
        ema_worst = max(ema_worst, float((v - want[k]).abs().max())
                        / max(float(want[k].abs().max()), 1e-30))
    assert ema_worst <= EMA_RTOL, f"EMA trunk {ema_worst:.3e} from the file"
    del state
    with StepLosses() as rec:
        train(**kw, max_steps=3, logdir=f"{tmp}/pretrained-steps")
    losses = [float(v) for v in rec.losses]
    assert len(losses) == 3 and all(map(math.isfinite, losses)), losses

    # (d) resume overrides the file: phase 8's step-10 checkpoint, one step
    # at lr 0, and the trunk is the checkpoint's
    ckpt_path = f"{b0_run}/ckpts/model_000010.pt"
    ck = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    out = train(**kw, lr=0.0, weight_decay=0.0, max_steps=11,
                resume=ckpt_path, logdir=f"{tmp}/pretrained-resumed")
    assert (out["start_counter"], out["counter"]) == (10, 11), out
    resumed = trunk_params(out["state"].model)
    for k, v in resumed.items():
        assert torch.equal(v, ck["model_state_dict"][TRUNK + k]), k
        assert not torch.equal(v, want[k]), f"{k} is the file's"
    launches = {"splat": issued("splat"),
                "dw_conv_stats": issued("dw_conv_stats")}  # the path ends here
    print(f"pretrained trunk: a seeded efficientnet_pytorch B0 file "
          f"({len(sd)} tensors, {len(sd) - len(want)} of them head and "
          f"num_batches_tracked, skipped) merged into the full-width B0 on "
          f"the card: {merged} trunk tensors bit-equal to the file, every "
          f"other tensor untouched; served card vs CPU (bsz 1, uint8 "
          f"images, f32, TF32 off): max |diff| {err:.3e}, tolerance "
          f"{CPU_TOL} x {scale:.3f} (max(1, max |logit|)), max |logit| "
          f"{logit_max:.4f}; "
          f"train(pretrained_trunk=..., fused_dw, bsz 4, lr 0, EMA 0.999) "
          f"one step: trunk parameters bit-equal to the file, the EMA's "
          f"within {ema_worst:.3e} of it (limit {EMA_RTOL}), launches "
          f"dw_conv_stats {dw1}, splat {splat1}; 3 steps at lr 1e-3: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; resume from phase 8's "
          f"model_000010.pt with the file: continued at 10 to 11, the trunk "
          f"the checkpoint's ({len(resumed)} parameters bit-equal, none the "
          f"file's); launches over the phase: splat {launches['splat']}, "
          f"dw_conv_stats {launches['dw_conv_stats']}; phase 25 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the bevfusion-seg-train cell (benchmark/configs/bevfusion-cam-seg.json,
# benchmark/traffic/staged-map6.json)
BEV_GRID = GridConf(xbound=(-51.2, 51.2, 0.4), ybound=(-51.2, 51.2, 0.4),
                    zbound=(-10.0, 10.0, 20.0), dbound=(1.0, 60.0, 0.5))
BEV_AUG = DataAugConf(H=256, W=704, final_dim=(256, 704))
BEV_S = 256 * 256
BEV_BSZ, BEV_STEPS = 4, 4
BEV_OCCUPANCY = (0.40, 0.03, 0.10, 0.01, 0.05, 0.03)  # MAP_CLASSES' order
SWIN_BLOCKS = 12   # Swin-T's depths 2 + 2 + 6 + 2: one attention call each


def bevfusion_batch(rng, gen):
    """A batch of the cell's: uint8 images at 256 x 704, the rig at 900 x
    1600 resized by 0.48 and cropped at (32, 176), and 200 x 200 labels of
    the six classes at the cell's occupancies, on the card."""
    cams = rig(rng, BEV_BSZ, 6, (900, 1600))
    cams[3][..., :2, :2] *= 0.48
    cams[4][..., 0], cams[4][..., 1] = -32.0, -176.0
    imgs = torch.randint(0, 256, (BEV_BSZ, 6, 3, 256, 704), generator=gen,
                         device="cuda", dtype=torch.uint8)
    occ = torch.tensor(BEV_OCCUPANCY, device="cuda")
    labels = (torch.rand((BEV_BSZ, len(occ), 200, 200), generator=gen, device="cuda")
              < occ[:, None, None]).float()
    return (imgs, *(torch.from_numpy(a).cuda() for a in cams), labels)


def phase_bevfusion(seed: int, gen) -> tuple:
    """Phase 26. Returns ({kernel: launches on the path}, check_splat's
    (max error, times) at the cell's points)."""
    t_phase = time.perf_counter()
    model = bevfusion_model.compile_bevfusion(
        BEV_GRID, BEV_AUG, device="cuda", compute_dtype="bfloat16",
        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, lr=2e-4, weight_decay=0.01, max_grad_norm=35.0,
                               lr_schedule="cosine", warmup_steps=500,
                               decay_steps=17580, optimizer="adamw")
    step = make_train_step(model, device="cuda")
    assert step.loss == "sigmoid_focal" and step.graph is not None
    rng = np.random.default_rng(seed)
    batches = [bevfusion_batch(rng, gen) for _ in range(2)]
    reset_launches()  # the BEVFusion path starts here
    window_attention.reset_windows()
    losses = []
    for i in range(BEV_STEPS):
        losses.append(float(step(state, batches[i % 2])["loss"]))
        if i == 0:
            per_forward = dict(window_attention.computed())
    launches = {"splat": issued_by_dtype("splat"),
                "dw_conv_stats": issued("dw_conv_stats")}  # the path ends here
    graph = step.graph
    assert (graph.captures, graph.replays) == (1, BEV_STEPS - 1), \
        (graph.captures, graph.replays)
    assert launches["splat"].get("bfloat16", 0) == BEV_STEPS == \
        sum(launches["splat"].values()), f"splat launches {launches['splat']}"
    assert launches["dw_conv_stats"] == 0, launches
    assert all(math.isfinite(x) for x in losses), losses
    assert window_attention.calls == {"plain": SWIN_BLOCKS // 2, "shifted": SWIN_BLOCKS // 2}, \
        window_attention.calls
    assert graph.graph.windows == per_forward and window_attention.computed() == {
        k: BEV_STEPS * v for k, v in per_forward.items()}, (graph.graph.windows, per_forward)
    print(f"BEVFusion step (Swin-T, 6 x 256 x 704, D 118, 256 x 256, bf16, bsz "
          f"{BEV_BSZ}, AdamW): {BEV_STEPS} steps, {graph.captures} capture and "
          f"{graph.replays} replays, losses {[round(x, 4) for x in losses]}; "
          f"splat launches {sum(launches['splat'].values())} (bf16, one a "
          f"forward), dw_conv_stats 0; attention windows a forward {per_forward}, "
          f"12 calls an eager forward", flush=True)

    # the splat on a train forward's own lift and ids
    taken = {}
    pooling = bevfusion_model.voxel_pooling

    def keep(geom, feats, *args, **kw):
        taken["geom"], taken["feats"] = geom, feats
        return pooling(geom, feats, *args, **kw)

    bevfusion_model.voxel_pooling = keep
    try:
        with torch.no_grad():
            model.train()(*batches[0][:6])
    finally:
        bevfusion_model.voxel_pooling = pooling
    ids, _ = voxel_indices(taken["geom"], model.grid_dx, model.grid_bx, model.nx)
    C = taken["feats"].shape[-1]
    pts = taken["feats"].reshape(BEV_BSZ, -1, C).contiguous()
    ids = ids.reshape(BEV_BSZ, -1).contiguous()
    del taken
    assert pts.dtype == torch.bfloat16 and pts.shape == (BEV_BSZ, 6 * 118 * 32 * 88, 80)
    print(f"BEVFusion splat inputs (a train forward's lift, bsz {BEV_BSZ}, "
          f"{pts.shape[0] * pts.shape[1]:,} points): "
          f"{float((ids == BEV_S).float().mean()):.3f} of points at the sentinel; "
          f"plan {splat_cuda.plan_splat(BEV_BSZ, pts.shape[1], BEV_S)}", flush=True)
    splat_row = check_splat(f"BEVFusion bf16 S={BEV_S} bsz {BEV_BSZ}", pts, ids, BEV_S)
    del pts, ids

    # the backend of every block's attention, in a replayed step
    dev = device_profile(lambda: step(state, batches[1]), n=2, windows=3)
    if dev is None:
        print("BEVFusion attention kernels: not measured (no profiler window saw "
              "a device record)", flush=True)
    else:
        fused = {name: sum(c for key, (_, c) in dev.items() if name in key)
                 for name in ("fmha_cutlassF", "fmha_cutlassB")}
        assert all(c == SWIN_BLOCKS for c in fused.values()), \
            f"fused attention launches a step {fused}: a block left SDPA's fused kernels"
        busy = sum(ms for ms, _ in dev.values())
        attn = sum(ms for key, (ms, _) in dev.items() if "fmha_cutlass" in key)
        print(f"BEVFusion replayed step: {busy:.3f} ms of device time, "
              f"{sum(c for _, c in dev.values())} device activities; "
              f"attention kernels {fused} a step, {attn:.3f} ms "
              f"({100 * attn / busy:.2f} %); phase 26 took "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, state, step, batches
    torch.cuda.empty_cache()
    return {"splat": BEV_STEPS, "dw_conv_stats": 0}, splat_row


def main_path_splat(model, many):
    """Phase 2 on the main path's own inputs: the lift and geometry the
    bsz-8 served batch ``many`` gives the splat, then its first 2 and 1
    items (a grid-mode rank's rows). Returns check_splat's at bsz 8."""
    with torch.inference_mode():
        t = [torch.as_tensor(a).cuda() for a in many]
        geom = model.get_geometry(*t[1:])
        feats = model.get_cam_feats(t[0])
        ids, _ = voxel_indices(geom, model.dx, model.bx, model.nx)
        pts = feats.reshape(8, -1, model.camC).contiguous()
        ids = ids.reshape(8, -1).contiguous()
    S = int(np.prod(model.nx))
    assert pts.shape == (8, 6 * 41 * 8 * 22, 64), pts.shape
    print(f"main-path splat inputs: {float((ids == S).float().mean()):.3f} of "
          f"points at the sentinel", flush=True)
    out = check_splat("main path f32 S=40000", pts, ids, S)
    for b in (2, 1):  # a grid-mode rank's lift rows at bsz 4 on 2 and 4 ranks
        check_splat(f"grid-mode rank f32 bsz {b} S=40000", pts[:b].contiguous(),
                    ids[:b].contiguous(), S)
    return out


def bench_splat():
    """Phase 2 at the bench's served shape: B0 in bf16 at bsz 8, on the
    lift and ids of ``lss_carla_torch.bench.build``'s seeded model and
    inputs (what ``inference_ms_per_sample_bsz8`` serves). Returns
    check_splat's."""
    from lss_carla_torch import bench
    _, state, batch = bench.build(8, dtype="bfloat16")
    model = state.model.eval()
    with torch.inference_mode():
        geom = model.get_geometry(*batch[1:6])
        feats = model.get_cam_feats(batch[0])
        ids, _ = voxel_indices(geom, model.dx, model.bx, model.nx)
    pts = feats.reshape(8, -1, model.camC).contiguous()
    ids = ids.reshape(8, -1).contiguous()
    S = int(np.prod(model.nx))
    del state, model
    assert pts.dtype == torch.bfloat16 and pts.shape == (8, 6 * 41 * 8 * 22, 64)
    print(f"bench splat inputs (B0 bf16 lift, bsz 8): "
          f"{float((ids == S).float().mean()):.3f} of points at the sentinel",
          flush=True)
    return check_splat("B0 bf16 bsz 8 (the bench's served ids) S=40000", pts,
                       ids, S)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    # full f32 for every check, as the JAX package's f32 path computes;
    # phases 5 and 10 also time cuDNN's default TF32 convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    started = time.perf_counter()

    def at(phase: int) -> None:
        print(f"phase {phase} starts at {time.perf_counter() - started:.1f} s",
              flush=True)

    # 1. card and build
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    libs = (splat_cuda.LIB, mbconv_cuda.LIB)
    # one nvcc a source and the decoder's g++, all at once
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        decoder = pool.submit(fastimage.load)
        built = list(pool.map(lambda lib: lib.build(), libs))
        decoder.result()
    for lib, path in zip(libs, built):
        ptxas = [ln.strip().replace("ptxas info    : ", "")
                 for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill stores" in ln]
        print(f"build: {lib.source.name} -> {path.name}; "
              f"{' | '.join(ptxas) or 'cached'}", flush=True)
    print(f"build: {fastimage.SOURCE.name} -> {fastimage.library_path().name} "
          f"(g++, host code: the JPEG decoder)", flush=True)
    print(f"build: both kernels and the decoder in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 2. the kernel against its plain version
    at(2)
    B, P, C, S = 8, 6 * 41 * 8 * 22, 64, 200 * 200
    for name, dtype, slots in (("f32 S=40000", torch.float32, S),
                               ("bf16 S=40000", torch.bfloat16, S),
                               ("f32 S=160000", torch.float32, 4 * S)):
        check_splat(name, *random_splat_inputs(gen, B, P, C, slots, dtype), slots)
    b0_bf16 = bench_splat()

    # 3. serving at full width
    at(3)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    model = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                          splat_method="pallas", device="cpu", generator=cpu_gen)
    randomize_bn(model, cpu_gen)
    model = model.eval().cuda()
    with tempfile.TemporaryDirectory() as tmp:
        path1, path8, launches, many = phase_serving(tmp, model, rng)
        max_err, times = main_path_splat(model, many)

        # 4. card against CPU, TF32 off
        at(4)
        one = inputs(rng, 1, uint8=True)
        on_card = load_predict(path1, device="cuda")
        x = (one[0].astype(np.float32),) + one[1:]
        gpu_logits = on_card(*x).cpu().numpy()
        cpu_logits = load_predict(path1, device="cpu")(*x).numpy()
        err, scale = assert_close("card vs cpu", gpu_logits, cpu_logits, CPU_TOL)
        print(f"card vs CPU (bsz 1, f32, TF32 off, plain splat on the CPU): max "
              f"|diff| {err:.3e}, tolerance {CPU_TOL} x {scale:.3f}", flush=True)

        # 5. times, in full f32 and with cuDNN's TF32 default
        at(5)
        dev8 = [torch.as_tensor(a).cuda() for a in many]
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            host_ms = []
            for _ in range(23):
                t0 = time.perf_counter()
                on_card(*x)
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
            lat1 = float(np.median(host_ms[3:]))
            with torch.inference_mode():
                ms8 = cuda_ms(lambda: model(*dev8), iters=20)
            print(f"times on {card}, cudnn TF32 {'on' if tf32 else 'off'} "
                  f"(matmul TF32 off): forward latency bsz 1 {lat1:.3f} ms (host "
                  f"clock, numpy f32 in, synchronised; median of 20); "
                  f"inference_ms_per_sample_bsz8 {ms8 / 8:.4f} ({ms8:.3f} ms per "
                  f"bsz-8 forward, CUDA events, uint8 inputs on the card)", flush=True)
        torch.backends.cudnn.allow_tf32 = False

        # 6. where the device time goes (a reading, not a check)
        at(6)
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            for name, fn in (("bsz 8", lambda: model(*dev8)),
                             ("bsz 1", lambda: on_card(*x))):
                print(f"profile {name}, cudnn TF32 {'on' if tf32 else 'off'}: "
                      f"{profile_forward(fn)}", flush=True)
        torch.backends.cudnn.allow_tf32 = False

        # 7. the depthwise conv + BN moments kernel against its plain version
        at(7)
        dw_err, dw_times = phase_dw(gen)

        # 8. training at full width through train(); 9. card vs CPU
        at(8)
        root, dw_launches, splat_train, loop_step_ms, b0_run = phase_training(
            tmp, args.seed)
        at(9)
        phase_card_vs_cpu(root, args.seed)

        # 10. train-step times and where the device time goes
        at(10)
        phase_train_times(card, rng, args.seed, loop_step_ms)

        # 11. both kernels in bf16 at the stretch shapes; 12. the stretch
        # recipe through train(); 13. bf16 against f32, and times
        at(11)
        stretch = phase_stretch_kernels(gen, args.seed)
        at(12)
        stretch_launches, stretch_step_ms, root400, stretch_run = \
            phase_stretch_training(tmp, args.seed)
        at(13)
        phase_bf16(card, args.seed, stretch_step_ms)

        # 14. the ResNet trunk; 15. the explore tools; 16. the watchdog
        at(14)
        resnet_launches, r18_run = phase_resnet(tmp, root, rng, args.seed, card)
        at(15)
        explore_launches = phase_explore(tmp, root, b0_run, r18_run, root400,
                                         stretch_run)
        at(16)
        phase_supervise(tmp, args.seed)

        # 17. int8 serving; 18. the bench as a child process
        at(17)
        int8_launches = phase_int8(tmp, rng, args.seed, b0_run)
        at(18)
        phase_bench()

        # 19. nuScenes at full width; 20. the decoder on the card's host
        at(19)
        nusc_launches, nusc_rows = phase_nuscenes(tmp, args.seed, gen)
        at(20)
        phase_decoder(tmp, root, args.seed, card)

        # 21. the parallel modes: gloo ranks on the card, NCCL on one rank
        at(21)
        par_launches = phase_parallel(tmp, args.seed, card)

        # 22. the BEV-grid mode; 23. remat; 24. the exported program
        at(22)
        grid_launches = phase_grid(tmp, args.seed, card)
        at(23)
        remat_launches = phase_remat(args.seed, card)
        at(24)
        export_launches = phase_export(tmp, args.seed)

        # 25. the pretrained trunk: merged, served, trained from, resumed
        at(25)
        pre_launches = phase_pretrained(tmp, root, b0_run, args.seed)

        # 26. BEVFusion's step at the bevfusion-seg-train cell's widths
        at(26)
        bev_launches, bev_splat = phase_bevfusion(args.seed, gen)
        print(f"phases 1-26 took {time.perf_counter() - started:.1f} s",
              flush=True)

    print(f"main-path launches: splat {launches} serving + {splat_train} "
          f"training + {stretch_launches['splat']} stretch (bf16) + "
          f"{resnet_launches} ResNet-18 serving and training + "
          f"{explore_launches} explore tools + {int8_launches} int8 serving + "
          f"{nusc_launches['splat']} nuScenes; "
          f"dw_conv_stats {dw_launches} "
          f"training + {stretch_launches['dw_conv_stats']} stretch (bf16) + 0 "
          f"ResNet + 0 explore + 0 int8 (eval mode) + "
          f"{nusc_launches['dw_conv_stats']} nuScenes; parallel paths (every "
          f"rank): {par_launches}; grid (every rank): {grid_launches}; remat: "
          f"{remat_launches}; exported programs (splat): {export_launches}; "
          f"pretrained trunk: {pre_launches}; BEVFusion: {bev_launches}",
          flush=True)
    print(f"over the run: {profiler_note()}", flush=True)

    def parallel_row(name):
        return {path: n[name] for path, n in par_launches.items()}

    def parallel_total(name):
        return sum(parallel_row(name).values())

    def stretch_row(name):
        err, t = stretch[name]
        return {"launches": stretch_launches[name], "max_abs_err": err,
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    kernels = [{"name": "splat", "route": "cuda",
                "source": "lss_carla_torch/csrc/splat.cu",
                "replaces": "lss_carla_tpu/ops/splat_pallas.py:79",
                "launches": (launches + splat_train + stretch_launches["splat"]
                             + resnet_launches + explore_launches
                             + int8_launches + nusc_launches["splat"]
                             + parallel_total("splat") + grid_launches["splat"]
                             + remat_launches["splat"]
                             + sum(export_launches.values())
                             + pre_launches["splat"] + bev_launches["splat"]),
                "max_abs_err": max_err, **times,
                "stretch_bf16": stretch_row("splat"),
                "b0_bf16": {"max_abs_err": b0_bf16[0], **b0_bf16[1]},
                "nuscenes": nusc_rows["splat"],
                "parallel_launches": parallel_row("splat"),
                "grid_launches": grid_launches["splat"],
                "remat_launches": remat_launches["splat"],
                "export_launches": export_launches,
                "pretrained_launches": pre_launches["splat"],
                "bevfusion_bf16": {"launches": bev_launches["splat"],
                                   "max_abs_err": bev_splat[0], **bev_splat[1]}},
               {"name": "dw_conv_stats", "route": "cuda",
                "source": "lss_carla_torch/csrc/dw_conv_stats.cu",
                "replaces": "lss_carla_tpu/ops/mbconv_pallas.py:145",
                "launches": (dw_launches + stretch_launches["dw_conv_stats"]
                             + nusc_launches["dw_conv_stats"]
                             + parallel_total("dw_conv_stats")
                             + grid_launches["dw_conv_stats"]
                             + remat_launches["dw_conv_stats"]
                             + pre_launches["dw_conv_stats"]),
                "max_abs_err": dw_err, **dw_times,
                "stretch_bf16": stretch_row("dw_conv_stats"),
                "nuscenes": nusc_rows["dw_conv_stats"],
                "parallel_launches": parallel_row("dw_conv_stats"),
                "grid_launches": grid_launches["dw_conv_stats"],
                "remat_launches": remat_launches["dw_conv_stats"],
                "export_launches": 0,
                "pretrained_launches": pre_launches["dw_conv_stats"]}]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
