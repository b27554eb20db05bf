#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lss_carla_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing a line of its own; every check raises, so any failure
exits non-zero without the final result line:

1. card and build: the card's name and power limit (nvidia-smi), and the
   nvcc build of the splat kernel from the sources in this checkout;
2. the splat kernel against its plain version (``splat_reference``) on the
   card, on seeded inputs with ~7 % of ids at the sentinel and NaN features
   at those points: (B 8, P 43,296, C 64, S 40,000) in f32 and in bf16, and
   S 160,000 in f32; then on the main path's own inputs (the model's lift
   and geometry at bsz 8). The wrapper (zero fill, kernel and, for bf16,
   the cast), plain version and ``index_add_`` (the one PyTorch call
   computing the same function, timed here only) are timed beside the byte
   bound, and the zero fill, the cast and the kernel's device time alone;
   with the in-grid points a tile folds into one run of its sort-and-reduce;
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
   trunk at N 24 (bsz 4 x 6 cameras) in f32, and blocks 0, 1 and 11 in
   bf16: y, sum and sum of squares within a summation-order bound, and dx,
   dw through the autograd Function against the plain version's autograd.
   The kernel's device time (torch.profiler) stands beside the byte
   bound; the device time of the kernel, the plain version, cuDNN's
   depthwise conv alone (the nearest library call) and cuDNN's conv plus a
   ``var_mean`` pass, each queued back to back behind a sleep kernel, and
   the wrapper's back-to-back call time (CUDA events) beside them; each
   call must put exactly one activity on the card;
8. training at full width through the port's own ``train()``: B0 at the
   default config on a synthetic SimBEV fixture (224 x 480 sources), bsz 4,
   ``fused_dw``, 20 steps with a validation and a checkpoint every 10; the
   kernels' launch counters, zeroed just before, must show 16 depthwise
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
    ``fused_dw`` off and on.

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
import torch.nn.functional as F

from kernel_compare import queued_ms
from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.data.loader import compile_data
from lss_carla_torch.models.efficientnet import MBConvBlock, block_plan
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import mbconv_cuda, splat_cuda
from lss_carla_torch.ops.mbconv import (dw_conv_stats, dw_conv_stats_reference,
                                        same_pad)
from lss_carla_torch.ops.splat import splat_reference, voxel_indices
from lss_carla_torch.server import serve
from lss_carla_torch.serving import INPUT_NAMES, export_predict, load_predict
from lss_carla_torch.training.loop import train
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils.convert import reference_state_dict

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def device_profile(fn, n: int = 20, windows: int = 5) -> dict:
    """{device activity name: (device ms per call, activities per call)}
    of everything ``fn`` puts on the card (torch.profiler, over n calls
    after a warm-up). Unlike ``cuda_ms`` it leaves out the host's time to
    issue each call, which bounds a back-to-back loop of calls shorter than
    ~0.1 ms. A window with some of its activity records lost (a count that
    is not a multiple of n) or none is profiled again, up to ``windows`` in
    all. Where records were lost in all of them, the last window's mean
    time a record stands for each lost one; LOST_RECORDS counts such
    calls."""
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
    if out is None:
        raise RuntimeError(f"the profiler saw no device time in {windows} windows")
    LOST_RECORDS[0] += 1
    return out


LOST_RECORDS = [0, 0]  # device_profile calls: with records lost in all windows, in all


def profiler_note() -> str:
    """What torch.profiler kept in device_profile's windows so far."""
    off = sorted(o for o, _ in WINDOWS if o is not None) or [float("nan")]
    return (f"torch.profiler: {len(WINDOWS)} windows, "
            f"{sum(w for _, w in WINDOWS)} with whole records, "
            f"{sum(o is None for o, _ in WINDOWS)} without device time; records "
            f"lost in every window of {LOST_RECORDS[0]} of {LOST_RECORDS[1]} "
            f"profiled functions (their times take the mean a record); first "
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


def points_per_run(ids, num_slots, tile=splat_cuda.TILE):
    """In-grid points per distinct (tile, id) pair: how many points the
    kernel's sort-and-reduce folds into one vector atomic, on average."""
    B, P = ids.shape
    valid = (ids >= 0) & (ids < num_slots)
    tiles = torch.arange(P, device=ids.device) // tile
    key = ((torch.arange(B, device=ids.device)[:, None] * -(-P // tile) + tiles)
           * num_slots + ids.long())
    n_valid = int(valid.sum())
    return n_valid, torch.unique(key[valid]).numel()


def check_splat(name, pts, ids, num_slots):
    """Kernel vs plain version on the card; returns (max_abs_err, times).

    Tolerance: both sum each slot's n points in f32 in some order, so each
    is within (n-1) u sum|x| of the exact sum (u = 2^-24); they may differ
    by twice that. bf16 outputs round that f32 sum once more: plus one bf16
    ulp (2^-8 relative). Sentinel points carry NaN features, so any that
    leaked into a slot would show."""
    got = splat_cuda.splat_forward(pts, ids, num_slots)
    ref = splat_reference(pts, ids, num_slots)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (ids.shape[0], num_slots, pts.shape[-1])
    assert got.dtype == pts.dtype, (got.dtype, pts.dtype)
    assert torch.isfinite(got).all(), f"{name}: non-finite output (sentinel leak?)"
    ones = torch.ones_like(pts[..., :1], dtype=torch.float32)
    count = splat_reference(ones, ids, num_slots)
    abs_sum = splat_reference(torch.nan_to_num(pts.float()).abs(), ids, num_slots)
    bound = 2 * count.clamp(min=1) * 2.0 ** -24 * abs_sum + 1e-7
    if pts.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * ref.float().abs()
    err = (got.float() - ref.float()).abs()
    excess = (err - bound).max().item()
    assert excess <= 0, f"{name}: kernel vs plain exceeds the bound by {excess}"
    max_err = err.max().item()

    S = int(num_slots)
    rows = torch.where((ids >= 0) & (ids < S), ids.long(), S)
    rows = (rows + torch.arange(ids.shape[0], device=ids.device)[:, None] * (S + 1)).reshape(-1)
    src = pts.reshape(-1, pts.shape[-1]).float()
    buf = torch.zeros((ids.shape[0] * (S + 1), pts.shape[-1]), device=pts.device)
    acc_shape = (ids.shape[0], S, pts.shape[-1])
    wrapper = lambda: splat_cuda.splat_forward(pts, ids, num_slots)  # noqa: E731
    times = {
        "ms": cuda_ms(wrapper),
        "plain_ms": cuda_ms(lambda: splat_reference(pts, ids, num_slots)),
        "library_ms": cuda_ms(lambda: buf.index_add_(0, rows, src)),
    }
    times["bound_ms"], times["bound_by"] = splat_bound(pts, ids, num_slots)
    fill_ms = cuda_ms(lambda: torch.zeros(acc_shape, device=pts.device))
    extra = ""
    if pts.dtype == torch.bfloat16:
        acc = torch.zeros(acc_shape, device=pts.device)
        extra = f", f32 -> bf16 cast {cuda_ms(lambda: acc.to(pts.dtype)):.4f} ms"
    dev = device_profile(wrapper)
    kernel_dev = sum(ms for key, (ms, _) in dev.items() if "splat_kernel" in key)
    queued = queued_ms(wrapper)
    n_valid, n_runs = points_per_run(ids, S)
    print(f"splat {name}: max_abs_err {max_err:.3e} (within the summation-order "
          f"bound), wrapper {times['ms']:.4f} ms (zero fill + kernel"
          f"{' + cast' if extra else ''}, CUDA events), plain "
          f"{times['plain_ms']:.4f} ms, index_add_ {times['library_ms']:.4f} ms, "
          f"{times['bound_by']} bound {times['bound_ms']:.4f} ms; alone: zero "
          f"fill {fill_ms:.4f} ms{extra} (CUDA events), kernel "
          f"{kernel_dev:.4f} ms device time (profiler; "
          f"{sum(c for _, c in dev.values()):.0f} device activities a call), "
          f"wrapper queued on the device {queued:.4f} ms; "
          f"{n_valid} in-grid points in {n_runs} (tile, id) runs at tile "
          f"{splat_cuda.TILE}: {n_valid / max(n_runs, 1):.2f} points a run, "
          f"{n_runs * -(-pts.shape[-1] // 4)} vector atomics against "
          f"{n_valid * pts.shape[-1]} scalar ones", flush=True)
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

    splat_cuda.launches = 0  # the main path starts here
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
    launches = splat_cuda.launches  # the main path ends here

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
        up2 = [e for e in prof.key_averages(group_by_input_shape=True)
               if e.key == "aten::convolution_backward"
               and list(up2_shape) in [list(s) for s in e.input_shapes if s]]
        up2_ms = sum(e.device_time_total for e in up2) / 1e3 / n
        return busy_ms, (
            f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
            f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, device activities (kernels, "
            f"copies, fills) {sum(e.count for e in kernels) / n:.0f} a step, "
            f"dw_conv_stats kernel "
            f"{_share(kernels, 'dw_conv_stats_kernel', n, busy_ms)}, splat "
            f"kernel {_share(kernels, 'splat_kernel', n, busy_ms)}, BEV up2 "
            f"conv backward (input {tuple(up2_shape)}) {up2_ms:.3f} ms "
            f"({100 * up2_ms / busy_ms:.2f}% of busy, {sum(e.count for e in up2) // n}"
            f" calls); {_top(prof, kernels, n, k=8)}")
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
    entry of dx and of dw."""
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
        r = torch.randn(y.shape, device=x.device, dtype=torch.float32)
        got, want = [], []
        for fn, out in ((dw_conv_stats, got), (dw_conv_stats_reference, want)):
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            ya, sa, ssa = fn(xa, wa, s)
            ((ya.float() * r).sum() + 0.3 * sa.sum() + 1e-3 * ssa.sum()).backward()
            out += [xa.grad, wa.grad]
        for g, ref, what in zip(got, want, ("dx", "dw")):
            gerr = (g - ref).abs().max().item()
            scale = ref.abs().max().item()
            assert gerr <= 1e-4 * scale, f"{name}: {what} off by {gerr} (scale {scale})"
            note += f", {what} {gerr / scale:.1e} of max"
    xp, wc = same_pad(x, k, s), w.to(x.dtype)
    kernel = lambda: mbconv_cuda.dw_conv_stats_forward(x, w, s)  # noqa: E731
    dev = device_profile(kernel)
    activities = sum(c for _, c in dev.values())
    assert activities == 1, f"{name}: {dev} device activities a call, want 1"
    plan = mbconv_cuda.plan_tiles(*x.shape, k, s)
    times = {
        "ms": sum(ms for ms, _ in dev.values()),
        "plain_ms": queued_ms(lambda: dw_conv_stats_reference(x, w, s)),
        "library_ms": queued_ms(lambda: F.conv2d(xp, wc, stride=s, groups=C)),
        "conv_var_mean_ms": queued_ms(lambda: torch.var_mean(
            F.conv2d(xp, wc, stride=s, groups=C).float(), dim=(0, 2, 3))),
        "call_ms": cuda_ms(kernel),
        "queued_ms": queued_ms(kernel),
    }
    times["bound_ms"], times["bound_by"] = dw_bound(x, k, s)
    max_err = err.max().item()
    print(f"dw_conv_stats {name}: max |dy| {max_err:.3e} (within the "
          f"summation-order bound), {note}; tiles {plan.tiles} a channel (th "
          f"{plan.th}, pb {plan.pb}, {plan.threads} threads, "
          f"{plan.smem_bytes} B staged); {activities:.0f} device activity a "
          f"call; device ms: kernel {times['ms']:.4f} (profiler; "
          f"{100 * times['bound_ms'] / times['ms']:.1f}% of the "
          f"{times['bound_by']} bound {times['bound_ms']:.4f}); queued back to "
          f"back (CUDA events): kernel {times['queued_ms']:.4f}, plain "
          f"{times['plain_ms']:.4f}, cuDNN conv {times['library_ms']:.4f}, "
          f"cuDNN conv + var_mean {times['conv_var_mean_ms']:.4f}; wrapper "
          f"calls back to back {times['call_ms']:.4f} ms (CUDA events)", flush=True)
    return max_err, times


def phase_dw(gen):
    """Phase 7. Returns (max |dy| over the f32 shapes, the f32 shapes'
    summed device times and bound: one train forward's 16 launches)."""
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "conv_var_mean_ms": 0.0, "call_ms": 0.0, "queued_ms": 0.0,
             "bound_ms": 0.0}
    max_err, by = 0.0, {}
    for block, k, s, shape in dw_shapes():
        for dtype in ((torch.float32, torch.bfloat16) if block in (0, 1, 11)
                      else (torch.float32,)):
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
    print(f"dw_conv_stats, the 16 f32 launches of one bsz-4 train forward, "
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
    wall ms per step over steps 11-20)."""
    t0 = time.perf_counter()
    root = generate_fixture(f"{tmp}/simbev", num_scenes=20, samples_per_scene=4,
                            H=224, W=480, seed=seed)
    print(f"fixture: 20 scenes x 4 samples at 224 x 480 (16 train scenes, 4 "
          f"val) in {time.perf_counter() - t0:.1f} s", flush=True)
    run = f"{tmp}/run"
    kw = dict(dataroot=str(root), nepochs=2, bsz=4, nworkers=6, fused_dw=True,
              val_step=10, save_step=10, iou_log_step=10, seed=seed,
              device="cuda")
    mbconv_cuda.launches = splat_cuda.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    result = train(**kw, max_steps=TRAIN_STEPS, logdir=run)
    dw_launches, splat_launches = mbconv_cuda.launches, splat_cuda.launches
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
          f"{splat_launches - TRAIN_STEPS} validation forwards); checkpoints "
          f"{sorted(ckpts)}; resume from model_000010.pt continued at "
          f"{resumed['start_counter']} to {resumed['counter']}; model_best.pt "
          f"(step {ck['counter']}, val IoU {ck['val_iou']:.4f}) exported and "
          f"served one request (max |served - direct| {err:.3e}); loop wall "
          f"ms per step {step_txt} (per 10-step window)", flush=True)
    return root, dw_launches, splat_launches, step_ms[-1]


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


def grad_misses(card, cpu) -> dict:
    """{parameter: (|g_card - g_cpu|, |g_cpu|)} (L2)."""
    cards = dict(card.named_parameters())
    return {k: ((cards[k].grad.cpu() - p.grad).norm().item(), p.grad.norm().item())
            for k, p in cpu.named_parameters()}


def grad_limit(name: str) -> float:
    """The relative L2 limit of a parameter's gradient, card vs CPU."""
    return GRAD_TOL if name.startswith(AFTER_LAST_BN) else BN_GRAD_TOL


def phase_card_vs_cpu(root, seed):
    """Phase 9."""
    models, metrics, before, _ = card_cpu_steps(root, seed)
    cpu, card = models["cpu"], models["card"]
    nc = float(metrics["cpu"]["grad_norm"])
    misses = {name: grad_misses(models[name], cpu)
              for name in ("card", "card, plain versions")}
    print("card vs CPU, parameters whose gradient misses GRAD_TOL relative "
          "and GRAD_ABS of the global norm (name: |g_card - g_cpu| / |g_cpu|): "
          + "; ".join(f"{name}: " + (", ".join(
              f"{k} {d / r:.2e}" for k, (d, r) in sorted(m.items())
              if d > GRAD_TOL * r and d > GRAD_ABS * nc) or "none")
              for name, m in misses.items()), flush=True)
    lc, lg = float(metrics["cpu"]["loss"]), float(metrics["card"]["loss"])
    assert math.isfinite(lg) and abs(lg - lc) <= LOSS_TOL * max(1.0, abs(lc)), (lg, lc)
    ng = float(metrics["card"]["grad_norm"])
    assert abs(ng - nc) <= GRAD_TOL * nc, (ng, nc)
    lr, wd, eps = 1e-3, 1e-7, 1e-8
    worst_p = 0.0
    worst_g = {GRAD_TOL: (0.0, ""), BN_GRAD_TOL: (0.0, "")}
    n_abs = n_bn_tol = flipped = 0
    gpu_params = dict(card.named_parameters())
    for k, pc in cpu.named_parameters():
        pg = gpu_params[k].detach().cpu()
        gc, gg = pc.grad, gpu_params[k].grad.cpu()
        diff, ref = misses["card"][k]
        tol = grad_limit(k)
        if diff <= tol * ref:
            worst_g[tol] = max(worst_g[tol], (diff / ref if ref else 0.0, k))
            n_bn_tol += int(diff > GRAD_TOL * ref)
        else:
            assert diff <= GRAD_ABS * nc, (k, diff, ref, tol)
            n_abs += 1
        p0 = before[k]
        ec, eg = gc + wd * p0, gg + wd * p0
        allowed = (lr * (eg - ec).abs() / (torch.minimum(ec.abs(), eg.abs()) + eps)
                   + 1e-6 * p0.abs() + 1e-9)
        used = ((pg - pc.detach()).abs() / allowed).max().item()
        assert used <= 1.0, (k, used)
        worst_p = max(worst_p, used)
        flipped += int(((pg - p0) * (pc.detach() - p0) < 0).sum())
    gpu_buffers = dict(card.named_buffers())
    worst_s, n_bn = 0.0, 0
    for k, bc in cpu.named_buffers():
        if not k.endswith(("running_mean", "running_var")):
            continue
        n_bn += 1
        used = ((gpu_buffers[k].cpu() - bc).abs() / (STATS_TOL * bc.abs() + 1e-6)).max().item()
        assert used <= 1.0, (k, used)
        worst_s = max(worst_s, used)
    n_par = len(gpu_params)
    print(f"card vs CPU, one B0 train step at bsz 2 (fused_dw: the kernel on "
          f"the card, the plain version on the CPU; dropout 0; f32, TF32 off): "
          f"loss {lg:.6f} vs {lc:.6f}, grad global norm {ng:.6f} vs {nc:.6f} "
          f"(relative {abs(ng - nc) / nc:.2e}; clipped at 5.0); parameter "
          f"gradients: {n_par - n_abs} of {n_par} within their relative L2 "
          f"limit ({GRAD_TOL} after the last BN, worst "
          f"{worst_g[GRAD_TOL][0]:.2e} at {worst_g[GRAD_TOL][1]}; "
          f"{BN_GRAD_TOL} through BN, worst {worst_g[BN_GRAD_TOL][0]:.2e} at "
          f"{worst_g[BN_GRAD_TOL][1]}, {n_bn_tol} above {GRAD_TOL}), {n_abs} "
          f"zero up to rounding, within {GRAD_ABS} of the global norm; "
          f"parameters after Adam within the "
          f"stated bound (at most {worst_p:.2f} of it; {flipped} entries moved "
          f"in opposite directions, as the bound allows near g = 0); {n_bn} BN "
          f"running "
          f"stats within {STATS_TOL} relative + 1e-6 (at most {worst_s:.2f} of "
          f"it)", flush=True)


def random_batch(rng, B):
    """A train batch on the card: uint8 images, the rig, sparse labels."""
    args = inputs(rng, B, uint8=True)
    binimg = (rng.uniform(size=(B, 1, 200, 200)) < 0.02).astype(np.float32)
    return tuple(torch.as_tensor(a).cuda() for a in (*args, binimg))


def train_step_fn(fused: bool, seed: int, batch):
    """One train step of a fresh B0 model (seeded weights) on ``batch``."""
    model = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                          fused_dw=fused, device="cuda",
                          generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model)
    step = make_train_step(model, 2.13, device="cuda")
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
                windows[fused].append(cuda_ms(steps[fused], iters=10, warmup=3))
                allocs[fused] += device_allocs() - before
            for fused in (False, True):
                w = windows[fused]
                print(f"times on {card}: {name} {sum(w) / len(w):.3f} (fused_dw "
                      f"{'on' if fused else 'off'}, cudnn TF32 "
                      f"{'on' if tf32 else 'off'}; CUDA events, two windows of "
                      f"10 steps after 3, timed in turns off/on/on/off: "
                      f"{w[0]:.3f}, {w[1]:.3f}; {allocs[fused]} cudaMalloc calls "
                      f"in them; inputs on the card)", flush=True)
        if B == 4:
            # fused_dw off and on with TF32 (where the host sets the step
            # time); TF32 off for the fused step only, as phase 8 ran it
            for fused, tf32 in ((False, True), (True, False), (True, True)):
                torch.backends.cudnn.allow_tf32 = tf32
                busy, text = profile_train_step(steps[fused], 3, (B, 256, 200, 200))
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


def main_path_splat(model, many):
    """Phase 2 on the main path's own inputs: the lift and geometry the
    bsz-8 served batch ``many`` gives the splat. Returns check_splat's."""
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
    return check_splat("main path f32 S=40000", pts, ids, S)


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

    # 1. card and build
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    libs = (splat_cuda.LIB, mbconv_cuda.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc a source, at once
        built = list(pool.map(lambda lib: lib.build(), libs))
    for lib, path in zip(libs, built):
        ptxas = [ln.strip().replace("ptxas info    : ", "")
                 for ln in lib.build_log.splitlines()
                 if "registers" in ln or "spill stores" in ln]
        print(f"build: {lib.source.name} -> {path.name}; "
              f"{' | '.join(ptxas) or 'cached'}", flush=True)
    print(f"build: both kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. the kernel against its plain version
    B, P, C, S = 8, 6 * 41 * 8 * 22, 64, 200 * 200
    for name, dtype, slots in (("f32 S=40000", torch.float32, S),
                               ("bf16 S=40000", torch.bfloat16, S),
                               ("f32 S=160000", torch.float32, 4 * S)):
        check_splat(name, *random_splat_inputs(gen, B, P, C, slots, dtype), slots)

    # 3. serving at full width
    cpu_gen = torch.Generator().manual_seed(args.seed)
    model = compile_model(GridConf(), DataAugConf(), outC=1, variant="b0",
                          splat_method="pallas", device="cpu", generator=cpu_gen)
    randomize_bn(model, cpu_gen)
    model = model.eval().cuda()
    with tempfile.TemporaryDirectory() as tmp:
        path1, path8, launches, many = phase_serving(tmp, model, rng)
        max_err, times = main_path_splat(model, many)

        # 4. card against CPU, TF32 off
        one = inputs(rng, 1, uint8=True)
        on_card = load_predict(path1, device="cuda")
        x = (one[0].astype(np.float32),) + one[1:]
        gpu_logits = on_card(*x).cpu().numpy()
        cpu_logits = load_predict(path1, device="cpu")(*x).numpy()
        err, scale = assert_close("card vs cpu", gpu_logits, cpu_logits, CPU_TOL)
        print(f"card vs CPU (bsz 1, f32, TF32 off, plain splat on the CPU): max "
              f"|diff| {err:.3e}, tolerance {CPU_TOL} x {scale:.3f}", flush=True)

        # 5. times, in full f32 and with cuDNN's TF32 default
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
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            for name, fn in (("bsz 8", lambda: model(*dev8)),
                             ("bsz 1", lambda: on_card(*x))):
                print(f"profile {name}, cudnn TF32 {'on' if tf32 else 'off'}: "
                      f"{profile_forward(fn)}", flush=True)
        torch.backends.cudnn.allow_tf32 = False

        # 7. the depthwise conv + BN moments kernel against its plain version
        dw_err, dw_times = phase_dw(gen)

        # 8. training at full width through train(); 9. card vs CPU
        root, dw_launches, splat_train, loop_step_ms = phase_training(tmp, args.seed)
        phase_card_vs_cpu(root, args.seed)

        # 10. train-step times and where the device time goes
        phase_train_times(card, rng, args.seed, loop_step_ms)

    print(f"main-path launches: splat {launches} serving + {splat_train} "
          f"training; dw_conv_stats {dw_launches} training", flush=True)
    print(f"over the run: {profiler_note()}", flush=True)
    kernels = [{"name": "splat", "route": "cuda",
                "source": "lss_carla_torch/csrc/splat.cu",
                "replaces": "lss_carla_tpu/ops/splat_pallas.py:79",
                "launches": launches + splat_train, "max_abs_err": max_err,
                **times},
               {"name": "dw_conv_stats", "route": "cuda",
                "source": "lss_carla_torch/csrc/dw_conv_stats.cu",
                "replaces": "lss_carla_tpu/ops/mbconv_pallas.py:145",
                "launches": dw_launches, "max_abs_err": dw_err, **dw_times}]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
