"""Serving: export a model's eval forward to one artifact file and load it
back as a callable, without the model code.

Counterpart of ``lss_carla_tpu/serving.py``, whose ``jax.export`` artifact
is StableHLO with the parameters baked in. Here the artifact is a
``torch.export`` ``ExportedProgram`` (``torch.export.save``): the eval
forward as an ATen graph, weights baked in, with the input signature
(bsz, ncams, image dtype) and the export settings in a JSON file inside
the same archive (``lss_predict.json``). ``--quantize`` and the compute
dtype are applied before the export, so the program holds the int8 convs
(``ops/quant.py``) or the bf16 casts itself.

The two kernels appear in the graph as the ``lss::splat`` and
``lss::dw_conv_stats`` operators (``ops/library.py``). ``load_predict``
imports that module and nothing of ``models/``: a process that loads an
artifact runs the kernel (or, on the CPU, its plain version) without the
model's code.

The program is traced on the device the model is on, as JAX's export is
platform-checked (``lss_carla_tpu/serving.py:6-8``). An artifact loaded
on another device is moved there with
``torch.export.passes.move_to_device_pass``; ``Predictor.moved_from``
records the device it was exported on, ``None`` when it was not moved.

On a CUDA device a ``Predictor`` runs the program as one CUDA graph: its
first call captures it, every later call replays it (``Predictor``).

    from lss_carla_torch.serving import export_predict, load_predict
    export_predict(model, "/models/lss.pt2", bsz=1)
    predict = load_predict("/models/lss.pt2")       # device="cuda"
    logits = predict(imgs, rots, trans, intrins, post_rots, post_trans)
"""

from __future__ import annotations

import json
import threading
import zipfile
from typing import Optional

import numpy as np
import torch

from lss_carla_torch.ops import library  # noqa: F401  (registers lss::*)
from lss_carla_torch.utils.backend import resolve_device
from lss_carla_torch.utils.graph import capture
from lss_carla_torch.utils.trace import span

FORMAT = "lss_carla_torch.predict/2"
META = "lss_predict.json"  # the archive's extra file
INPUT_NAMES = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans")


def input_shapes(signature: dict):
    """[(name, shape, numpy dtype name)] of the six forward inputs."""
    b, n = signature["bsz"], signature["ncams"]
    fH, fW = signature["final_dim"]
    return [("imgs", (b, n, 3, fH, fW), signature["img_dtype"]),
            ("rots", (b, n, 3, 3), "float32"),
            ("trans", (b, n, 3), "float32"),
            ("intrins", (b, n, 3, 3), "float32"),
            ("post_rots", (b, n, 3, 3), "float32"),
            ("post_trans", (b, n, 3), "float32")]


def example_args(signature: dict):
    """Numpy inputs of the artifact's signature (zero images, identity
    matrices) for warming a server up."""
    args = []
    for name, shape, dtype in input_shapes(signature):
        a = np.zeros(shape, dtype)
        if shape[-2:] == (3, 3):
            a[...] = np.eye(3, dtype=np.float32)
        args.append(a)
    return tuple(args)


def export_predict(model, path: str, bsz: int = 1, uint8_images: bool = False,
                   ncams: Optional[int] = None, quantize: bool = False,
                   quant_min_channels: int = 64) -> None:
    """Trace ``model``'s eval forward on its device and write the program,
    weights baked in, with its input signature to ``path``.

    uint8_images: a uint8 image signature, normalised on the device.
    ncams: serving camera count; by default the full rig, max(Ncams, 6)
    (Ncams is the train-time camera-dropout count). quantize: the program
    runs the convs that ``quantize_model(min_channels=quant_min_channels)``
    swaps in int8 (``ops/quant.py``). ``model`` is left as it was."""
    from lss_carla_torch.ops.quant import quantize_model
    if ncams is None:
        ncams = max(model.data_aug_conf.Ncams, 6)
    signature = {"bsz": int(bsz), "ncams": int(ncams),
                 "final_dim": list(model.data_aug_conf.final_dim),
                 "img_dtype": "uint8" if uint8_images else "float32"}
    dev = next(model.parameters()).device
    training = model.training
    model.eval()
    try:
        net = quantize_model(model, quant_min_channels)[0] if quantize \
            else model
        args = tuple(torch.as_tensor(a, device=dev)
                     for a in example_args(signature))
        with torch.no_grad():
            program = torch.export.export(net, args, strict=False)
    finally:
        model.train(training)
    meta = {"format": FORMAT, "signature": signature, "device": str(dev),
            "config": model.config(), "quantize": bool(quantize),
            "quant_min_channels": int(quant_min_channels)}
    torch.export.save(program, path, extra_files={META: json.dumps(meta)})


class Predictor:
    """A loaded artifact: checks inputs against the signature, runs the
    program on its device, returns logits (B, outC, X, Y) as a tensor
    there. ``meta`` is the artifact's settings; ``moved_from`` the device
    it was exported on where that is not ``device``, else None.

    On a CUDA device the program runs as one CUDA graph, since every call
    has the signature's static shapes. The first call copies its inputs
    into static device buffers, runs the program eagerly from them on a
    stream of its own (which makes cuDNN's and cuBLAS's workspaces before
    a capture needs them), captures one call of it from the same buffers
    (``utils/graph.py``), and returns the eager answer. Every later call
    copies its inputs into the buffers, replays the graph on the caller's
    stream and returns a clone of the graph's output, so an answer that a
    caller keeps is never overwritten by a later replay. The buffers serve
    one call at a time: callers on other threads wait their turn. Where
    the capture fails, the object stays eager for good, and
    ``graph_error`` says why. On the CPU every call runs the program
    eagerly.

    ``captures`` (0 or 1), ``fallbacks`` (0 or 1), ``replays`` and
    ``eager_calls`` count this object's calls (the capturing call is an
    eager one); each call that passes the signature check runs inside one
    span of ``utils/trace.py``, ``lss.serve.replay`` or
    ``lss.serve.eager``."""

    # eager calls on the capture's stream before it: the first makes the
    # workspaces, the second runs on what the first made
    WARMUP_CALLS = 2

    def __init__(self, program, signature: dict, device: torch.device,
                 meta: Optional[dict] = None,
                 moved_from: Optional[str] = None):
        self.program, self.signature, self.device = program, signature, device
        self.meta, self.moved_from = meta or {}, moved_from
        self._expected = input_shapes(signature)
        self.replays = self.eager_calls = 0
        self.graph_error: Optional[str] = None
        self._graph = self._inputs = None
        self._lock = threading.Lock()

    @property
    def captures(self) -> int:
        return int(self._graph is not None)

    @property
    def fallbacks(self) -> int:
        return int(self.graph_error is not None)

    def _check(self, args) -> list:
        """The inputs as tensors where they are; ValueError where the
        count or any input is off the signature, before any is copied."""
        if len(args) != len(self._expected):
            raise ValueError(f"expected {len(self._expected)} inputs, "
                             f"got {len(args)}")
        tensors = []
        for a, (name, shape, dtype) in zip(args, self._expected):
            t = torch.as_tensor(a)
            if tuple(t.shape) != shape or t.dtype != getattr(torch, dtype):
                raise ValueError(
                    f"{name}: got {tuple(t.shape)} {t.dtype}, the artifact "
                    f"takes {shape} {dtype}")
            tensors.append(t)
        return tensors

    def __call__(self, *args):
        tensors = self._check(args)
        if self.device.type != "cuda":
            with span("lss.serve.eager"):
                self.eager_calls += 1
                return self._run(tensors)
        with self._lock:
            if self._graph is not None:
                with span("lss.serve.replay"):
                    return self._replay(tensors)
            with span("lss.serve.eager"):
                self.eager_calls += 1
                if self.graph_error is None:
                    return self._capture(tensors)
                return self._run(tensors)

    def _run(self, tensors):
        """The program, eagerly, on its device."""
        tensors = [t.to(self.device, non_blocking=True) for t in tensors]
        with torch.inference_mode():
            return self.program(*tensors)

    def _capture(self, tensors):
        """The first CUDA call: the eager program on a stream of its own
        from the static buffers, then one call captured from them. Returns
        the eager answer; a capture that fails leaves the object eager."""
        caller = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                      for t in tensors]
            for buf, t in zip(inputs, tensors):
                buf.copy_(t, non_blocking=True)
            for _ in range(self.WARMUP_CALLS):
                answer = self._run(inputs)
            try:
                self._graph = capture(lambda: self._run(inputs), stream)
                self._inputs = inputs
            except Exception as e:   # whatever ends the capture: stay eager
                self.graph_error = f"{type(e).__name__}: {e}"
        caller.wait_stream(stream)
        answer.record_stream(caller)
        return answer

    def _replay(self, tensors):
        for buf, t in zip(self._inputs, tensors):
            buf.copy_(t, non_blocking=True)
        self._graph.replay()
        self.replays += 1
        with torch.inference_mode():
            return self._graph.out.clone()


def read_meta(path: str) -> dict:
    """An artifact's settings (format, signature, device, config, int8),
    read from its archive without loading the program."""
    try:
        with zipfile.ZipFile(path) as z:
            names = [n for n in z.namelist()
                     if n.endswith(f"/extra/{META}")]
            meta = json.loads(z.read(names[0])) if names else None
    except zipfile.BadZipFile:
        meta = None
    if not isinstance(meta, dict) or meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} artifact")
    return meta


def read_signature(path: str) -> dict:
    """The input signature an artifact was exported with."""
    return read_meta(path)["signature"]


def load_predict(path: str, device="cuda") -> Predictor:
    """Load an artifact onto ``device`` (cuda unless "cpu" is asked for):
    the exported program, moved there if it was exported on another
    device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    meta = read_meta(path)
    program = torch.export.load(path)
    moved_from = None
    if torch.device(meta["device"]) != dev:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
        moved_from = meta["device"]
    return Predictor(program.module(), meta["signature"], dev, meta,
                     moved_from)


def _main(argv=None):
    """CLI: reference-format checkpoint -> serving artifact
    (``python -m lss_carla_torch.server`` serves it).

        python -m lss_carla_torch.serving --checkpoint runs/x/ckpts --best \\
            --out /models/lss.pt2 [--device cpu] [--ema] [--compute_dtype bfloat16] \\
            [--quantize] [--uint8] [--bsz 8] [--variant b4|resnet18]

    ``--checkpoint`` is a ``.pt`` file or a run's checkpoint directory (its
    newest checkpoint, or ``model_best.pt`` with ``--best``). ``--ema``
    exports the checkpoint's ``ema_state_dict`` where it has one, else the
    raw weights. ``--compute_dtype bfloat16`` serves in bf16. ``--quantize``
    serves the eligible convs in int8 (``ops/quant.py``). ``--device``
    (cuda unless cpu is asked for) is where the program is traced.
    """
    import argparse
    import os

    p = argparse.ArgumentParser(
        description="Export a reference-format checkpoint as a serving artifact")
    p.add_argument("--checkpoint", required=True,
                   help="reference .pt ({'model_state_dict': ...} or a raw "
                        "state dict), or a checkpoint directory")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--best", action="store_true",
                   help="with a directory: export its model_best.pt")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA weights (runs trained with "
                        "--ema_decay); the raw weights for checkpoints "
                        "without them")
    p.add_argument("--compute_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--quantize", action="store_true",
                   help="int8 convs where min(cin, cout) >= 64 "
                        "(ops/quant.py), baked into the program")
    p.add_argument("--uint8", action="store_true",
                   help="uint8 image inputs (normalised on the device)")
    p.add_argument("--bsz", type=int, default=1)
    p.add_argument("--ncams", type=int, default=None,
                   help="serving camera count (default: full rig)")
    p.add_argument("--variant", default="b0",
                   choices=("b0", "b1", "b2", "b3", "b4",
                            "resnet18", "resnet34"))
    p.add_argument("--outC", type=int, default=1)
    p.add_argument("--H", type=int, default=224)
    p.add_argument("--W", type=int, default=480)
    p.add_argument("--final_dim", type=int, nargs=2, default=(128, 352))
    p.add_argument("--xbound", type=float, nargs=3,
                   default=(-50.0, 50.0, 0.5), metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--ybound", type=float, nargs=3,
                   default=(-50.0, 50.0, 0.5), metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--zbound", type=float, nargs=3,
                   default=(-10.0, 10.0, 20.0), metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--dbound", type=float, nargs=3,
                   default=(4.0, 45.0, 1.0), metavar=("MIN", "MAX", "STEP"))
    p.add_argument("--device", default="cuda",
                   help="the device the program is traced on and serves "
                        "on without a move (cuda, or cpu)")
    args = p.parse_args(argv)

    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.models.lss import compile_model
    from lss_carla_torch.utils.checkpoint import BEST, load_checkpoint
    from lss_carla_torch.utils.convert import reference_state_dict

    grid = GridConf(xbound=tuple(args.xbound), ybound=tuple(args.ybound),
                    zbound=tuple(args.zbound), dbound=tuple(args.dbound))
    aug = DataAugConf(H=args.H, W=args.W, final_dim=tuple(args.final_dim))
    model = compile_model(grid, aug, outC=args.outC, variant=args.variant,
                          compute_dtype=args.compute_dtype, device=args.device)
    path = args.checkpoint
    if args.best:
        if not os.path.isdir(path):
            raise SystemExit("--best takes a checkpoint directory")
        path = os.path.join(path, BEST)
    ckpt = load_checkpoint(path)
    weights = "raw"
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        if args.ema and "ema_state_dict" in ckpt:
            weights, ckpt = "ema", ckpt["ema_state_dict"]
        else:
            if args.ema:
                print("checkpoint has no EMA weights; exporting the raw ones")
            ckpt = ckpt["model_state_dict"]
    model.load_state_dict(reference_state_dict(ckpt))
    export_predict(model, args.out, bsz=args.bsz, uint8_images=args.uint8,
                   ncams=args.ncams, quantize=args.quantize)
    print(f"exported {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"bsz {args.bsz}, {args.compute_dtype}, {weights} weights"
          f"{', int8' if args.quantize else ''}"
          f"{', uint8-in' if args.uint8 else ''})")


if __name__ == "__main__":
    _main()
