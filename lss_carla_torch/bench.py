"""Benchmark of the port: ``bench.py``'s metrics, names, units and rounding,
on one GPU.

    python -m lss_carla_torch.bench [--mode all|step|infer|input] [--bsz 8]

The flagship config at full width (EfficientNet-B0, 6 cameras at 128 x
352, 41 depth bins, a 200 x 200 grid, ``pos_weight`` 2.13), seeded
weights and inputs on the card. ``--mode all`` prints three JSON lines, as
``bench.py`` does:

    {"metric": "train_step_ms_bsz8", "value": <ms>, "unit": "ms",
     "vs_baseline": <800 / ms>}                       f32 train step
    {"metric": "inference_ms_per_sample_bsz8", ...}   bf16 forward
    {"metric": "train_step_ms_bsz8_bfloat16", ...}    bf16 train step, last

``--mode step`` and ``--mode infer`` take ``--dtype`` and ``--variant``
(suffixes ``_bfloat16``, ``_resnet18``, ...), ``--mode step`` also
``--accum`` (``_accum{N}``, ms per optimizer step) and ``--fused_dw``
(``_fused_dw``), ``--mode infer`` also ``--quantize`` (int8 convs,
``ops/quant.py``; ``_int8``). ``--mode input`` times the threaded
loader through the native JPEG decoder (``input_pipeline_images_per_sec``,
``data/decode.py``). The train step is the port's
``make_train_step`` (forward, weighted BCE, backward, clip, Adam).

Timing: JAX chains the iterations inside one jit, which eager PyTorch
cannot. Here ``--warmup`` calls run first, then three windows of
``--iters`` back-to-back calls are timed with CUDA events, and the median
window over ``iters`` is reported. A line before the metrics states the
settings: cuDNN and matmul TF32 as torch's defaults leave them, torch and
CUDA versions, the card's name and power limit; each measurement also
prints its batch shapes and the three windows.

``--remat`` rematerialises the two encoders in the train step
(``compile_model(remat=True)``, ``models/lss.py``); as in ``bench.py`` it
keeps the metric's name. Left out: ``--compiler_option`` (XLA options; no
counterpart). ``--device cpu`` times on the host clock (tests only).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model
from lss_carla_torch.ops.quant import quantize_model
from lss_carla_torch.ops.splat import METHODS
from lss_carla_torch.training.state import create_train_state
from lss_carla_torch.training.step import make_train_step
from lss_carla_torch.utils.backend import card_line, resolve_device

BASELINE_STEP_MS = 800.0  # 8 samples x ~100 ms/sample (bench.py's docstring)


def build(bsz, splat_method="scatter", dtype="float32", variant="b0",
          fused_dw=False, device="cuda", accum=1, remat=False):
    """(train_step, state, batch): bench.py's seeded model and inputs, the
    batch on ``device``; ``accum > 1`` stacks ``accum`` copies of it as
    microbatches of one step."""
    dev = resolve_device(device)
    model = compile_model(GridConf(), DataAugConf(), outC=1,
                          splat_method=splat_method, compute_dtype=dtype,
                          variant=variant, fused_dw=fused_dw, remat=remat,
                          device=dev,
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    B, N, fH, fW = bsz, 6, 128, 352
    imgs = rng.normal(size=(B, N, 3, fH, fW)).astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    trans = rng.normal(size=(B, N, 3)).astype(np.float32)
    intrins = eye.copy()
    intrins[..., 0, 0] = intrins[..., 1, 1] = 200.0
    intrins[..., 0, 2], intrins[..., 1, 2] = fW / 2, fH / 2
    post_trans = np.zeros((B, N, 3), np.float32)
    binimgs = (rng.uniform(size=(B, 1, 200, 200)) < 0.03).astype(np.float32)
    batch = tuple(torch.from_numpy(a).to(dev) for a in
                  (imgs, eye, trans, intrins, eye.copy(), post_trans, binimgs))
    if accum > 1:
        batch = tuple(x.expand(accum, *x.shape) for x in batch)
    state = create_train_state(model)
    step = make_train_step(model, pos_weight=2.13, accum_steps=accum,
                           device=dev)
    return step, state, batch


def time_windows(fn, iters: int, warmup: int, device) -> list:
    """ms of three windows of ``iters`` back-to-back ``fn()`` calls after
    ``warmup`` calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    windows = []
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            windows.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            windows.append((time.perf_counter() - t0) * 1e3)
    return windows


def _shapes(batch) -> str:
    return (f"imgs {tuple(batch[0].shape)} {str(batch[0].dtype)[6:]} binimgs "
            f"{tuple(batch[6].shape)}")


def bench_step(bsz, iters, splat_method, dtype, variant="b0", warmup=1,
               accum=1, fused_dw=False, device="cuda", remat=False):
    """Train-step time; prints its JSON line. ``accum > 1``: ``accum``
    stacked microbatches of ``bsz`` per optimizer step, ms per step;
    ``remat``: the encoders rematerialised."""
    step, state, batch = build(bsz, splat_method, dtype, variant, fused_dw,
                               device, accum, remat)
    windows = time_windows(lambda: step(state, batch), iters, max(1, warmup),
                           device)
    ms = sorted(windows)[1] / iters
    suffix = "" if dtype == "float32" else f"_{dtype}"
    if variant != "b0":
        suffix += f"_{variant}"
    if accum > 1:
        suffix += f"_accum{accum}"
    if fused_dw:
        suffix += "_fused_dw"
    print(f"bench: train step, {_shapes(batch)}, {dtype}"
          f"{', remat' if remat else ''}, windows of "
          f"{iters} (ms) {[round(w, 3) for w in windows]}", flush=True)
    # vs_baseline scales the 800 ms bsz-8 floor by the effective batch
    print(json.dumps({
        "metric": f"train_step_ms_bsz{bsz}{suffix}",
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_STEP_MS * accum / ms, 3),
    }), flush=True)


def bench_infer(bsz, iters, dtype, quantize=False, quant_min_channels=64,
                variant="b0", warmup=1, device="cuda"):
    """Forward time per sample (reference: ~100 ms/sample on one GPU);
    ``quantize``: the eligible convs in int8."""
    _, state, batch = build(bsz, "scatter", dtype, variant, device=device)
    model = state.model.eval()
    if quantize:
        model, _ = quantize_model(model, quant_min_channels)

    def forward():
        with torch.inference_mode():
            return model(*batch[:6])

    windows = time_windows(forward, iters, max(1, warmup), device)
    ms_per_sample = sorted(windows)[1] / iters / bsz
    suffix = "_int8" if quantize else ""
    if variant != "b0":
        suffix += f"_{variant}"
    print(f"bench: forward, {_shapes(batch)}, {dtype}"
          f"{', int8 convs' if quantize else ''}, windows of {iters} (ms) "
          f"{[round(w, 3) for w in windows]}", flush=True)
    print(json.dumps({
        "metric": f"inference_ms_per_sample_bsz{bsz}{suffix}",
        "value": round(ms_per_sample, 3),
        "unit": "ms",
        "vs_baseline": round(100.0 / ms_per_sample, 3),
    }), flush=True)


def input_images_per_sec(root, aug, bsz: int, iters: int,
                         num_workers: int = 8, use_native: bool = True):
    """Images a second through the threaded train loader over the SimBEV
    fixture ``root`` (one warm-up epoch, then ``iters`` epochs), and the
    dataset's decode counts (``NativeDecoder.stats``)."""
    from lss_carla_torch.data.loader import DataLoader
    from lss_carla_torch.data.simbev import SegmentationData

    ds = SegmentationData(root, is_train=True, data_aug_conf=aug,
                          grid_conf=GridConf(), use_native=use_native)
    dl = DataLoader(ds, batch_size=bsz, shuffle=True, drop_last=True,
                    num_workers=num_workers)
    for _ in dl:  # warmup epoch
        pass
    t0 = time.perf_counter()
    n_img = 0
    for _ in range(iters):
        for b in dl:
            n_img += b[0].shape[0] * b[0].shape[1]
    return n_img / (time.perf_counter() - t0), dict(ds.decoder.stats)


def bench_input(bsz: int, iters: int):
    """Host input-pipeline throughput: images/sec through the threaded
    loader (the native decoder, 8 threads) on a fixture of 2 scenes x 16
    samples at bench.py's default augmentation (the crop-only path)."""
    from lss_carla_torch.data.fixtures import generate_fixture

    with tempfile.TemporaryDirectory(prefix="bench_input_") as tmp:
        root = generate_fixture(tmp, num_scenes=2, samples_per_scene=16,
                                H=224, W=480)
        rate, _ = input_images_per_sec(root, DataAugConf(), bsz, iters)
    print(json.dumps({
        "metric": "input_pipeline_images_per_sec",
        "value": round(rate, 1),
        "unit": "img/s",
        "vs_baseline": None,
    }), flush=True)


def settings(device) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "card": card_line() if cuda else "cpu"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bsz", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--splat_method", default="scatter", choices=METHODS,
                   help="kept for parity; every method runs the same splat")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--mode", default="all",
                   choices=["all", "step", "input", "infer"])
    p.add_argument("--remat", action="store_true",
                   help="rematerialise the encoders in the train steps "
                        "(compile_model(remat=True))")
    p.add_argument("--variant", default="b0",
                   choices=["b0", "b1", "b2", "b3", "b4",
                            "resnet18", "resnet34"],
                   help="camera trunk; --mode step/infer only — the flagship "
                        "metrics stay b0")
    p.add_argument("--accum", type=int, default=1,
                   help=">1: gradient accumulation, N stacked microbatches "
                        "per optimizer step (--mode step only)")
    p.add_argument("--quantize", action="store_true",
                   help="int8 convs (ops/quant.py); --mode infer only")
    p.add_argument("--quant_min_channels", type=int, default=64,
                   help="quantize only convs with min(cin,cout) >= this")
    p.add_argument("--fused_dw", action="store_true",
                   help="the depthwise conv + BN moments kernel in the "
                        "EfficientNet train path; --mode step only")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.mode == "all" and args.dtype is not None:
        p.error("--mode all always emits both dtypes; use --mode step or "
                "--mode infer with --dtype for a single-dtype timing")
    if args.variant != "b0" and args.mode not in ("step", "infer"):
        p.error("--variant only applies to --mode step/infer (flagship "
                "metrics are measured on the b0 reference config)")
    if args.quantize and args.mode != "infer":
        p.error("--quantize only applies to --mode infer (training stays "
                "in float)")
    if args.accum > 1 and args.mode != "step":
        p.error("--accum only applies to --mode step")
    if args.fused_dw and args.mode != "step":
        p.error("--fused_dw only applies to --mode step (the fusion is a "
                "train-path rewrite; eval/infer use the standard convs)")
    dtype = args.dtype or "bfloat16"
    device = str(resolve_device(args.device))
    print("bench settings: " + json.dumps(settings(device)), flush=True)

    if args.mode == "input":
        bench_input(args.bsz, max(1, args.iters // 5))
    elif args.mode == "infer":
        bench_infer(args.bsz, args.iters, dtype, args.quantize,
                    args.quant_min_channels, args.variant, args.warmup, device)
    elif args.mode == "step":
        bench_step(args.bsz, args.iters, args.splat_method, dtype,
                   args.variant, args.warmup, args.accum, args.fused_dw,
                   device, args.remat)
    else:  # all: the f32 step, inference, and the headline bf16 step last
        bench_step(args.bsz, args.iters, args.splat_method, "float32",
                   warmup=args.warmup, device=device, remat=args.remat)
        bench_infer(args.bsz, args.iters, "bfloat16", warmup=args.warmup,
                    device=device)
        bench_step(args.bsz, args.iters, args.splat_method, "bfloat16",
                   warmup=args.warmup, device=device, remat=args.remat)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
