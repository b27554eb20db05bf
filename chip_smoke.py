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
   and geometry at bsz 8). Kernel, plain version and ``index_add_`` (the
   one PyTorch call computing the same function, timed here only) are timed
   beside the byte bound;
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
   (torch.profiler): a reading for PERF.md, not a check.

The line before the last is the kernels' JSON (name, route, source, TPU
kernel replaced, launches on the main path, error, times, bound); the last
line is ``{"ok": true, "device": {...}}``. Without a GPU, or without the
package beside it, the script fails before printing either.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops import splat_cuda
from lss_carla_torch.ops.splat import splat_reference, voxel_indices
from lss_carla_torch.server import serve
from lss_carla_torch.serving import INPUT_NAMES, export_predict, load_predict

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
    times = {
        "ms": cuda_ms(lambda: splat_cuda.splat_forward(pts, ids, num_slots)),
        "plain_ms": cuda_ms(lambda: splat_reference(pts, ids, num_slots)),
        "library_ms": cuda_ms(lambda: buf.index_add_(0, rows, src)),
    }
    times["bound_ms"], times["bound_by"] = splat_bound(pts, ids, num_slots)
    print(f"splat {name}: max_abs_err {max_err:.3e} (within the summation-order "
          f"bound), kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, "
          f"index_add_ {times['library_ms']:.4f} ms, {times['bound_by']} bound "
          f"{times['bound_ms']:.4f} ms", flush=True)
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


def profile_forward(fn, n: int = 5) -> str:
    """Per-forward wall time (host clock, profiler off), device busy time
    and idle share, the splat kernel's share, the kernels that take the
    most device time, and the aten ops (with input shapes) that launch
    them, over ``n`` calls."""
    try:
        from torch.profiler import ProfilerActivity, profile
        fn()  # warm: a changed TF32 setting picks new algorithms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        rows = prof.key_averages()
        kernels = sorted((e for e in rows if e.device_type == cuda),
                         key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        if busy_ms <= 0:
            return "not measured (the profiler saw no device time)"
        splat_ms = sum(e.self_device_time_total for e in kernels
                       if "splat_kernel" in e.key) / 1e3 / n
        top_k = " | ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                           f" x{e.count // n}" for e in kernels[:6])
        ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                      if e.device_type != cuda and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        top_o = " | ".join(f"{e.key} {str(e.input_shapes)[:80]} "
                           f"{e.self_device_time_total / 1e3 / n:.3f} ms x{e.count // n}"
                           for e in ops[:6])
        return (f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
                f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, splat kernel "
                f"{splat_ms:.4f} ms ({100 * splat_ms / busy_ms:.2f}% of busy); "
                f"top kernels: {top_k}; top ops: {top_o}")
    except Exception as e:  # the profiler is a reading, not a check
        return f"not measured ({type(e).__name__}: {e})"


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
    # phase 5 also times cuDNN's default TF32 convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. card and build
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    splat_cuda.build()
    ptxas = [ln.strip() for ln in splat_cuda.build_log.splitlines() if "registers" in ln]
    print(f"build: splat.cu -> {splat_cuda.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s; {' | '.join(ptxas) or 'cached'}",
          flush=True)

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

        # the kernel on the main path's own inputs: the lift and geometry
        # the bsz-8 served batch gives it
        with torch.inference_mode():
            t = [torch.as_tensor(a).cuda() for a in many]
            geom = model.get_geometry(*t[1:])
            feats = model.get_cam_feats(t[0])
            ids, _ = voxel_indices(geom, model.dx, model.bx, model.nx)
            pts = feats.reshape(8, -1, model.camC).contiguous()
            ids = ids.reshape(8, -1).contiguous()
        assert pts.shape == (B, P, C), pts.shape
        print(f"main-path splat inputs: {float((ids == S).float().mean()):.3f} of "
              f"points at the sentinel", flush=True)
        max_err, times = check_splat("main path f32 S=40000", pts, ids, S)

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

    kernels = [{"name": "splat", "route": "cuda",
                "source": "lss_carla_torch/csrc/splat.cu",
                "replaces": "lss_carla_tpu/ops/splat_pallas.py:79",
                "launches": launches, "max_abs_err": max_err, **times}]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
