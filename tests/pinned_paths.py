"""The operator sequences of the benchmark's existing paths, recorded at a
reduced grid on the CPU: the B0 serving artifact's program
(``serving.py::export_predict``, uint8 images, f32), the B0 train forward
in bf16 (the fast recipe's), the B4 train forward in bf16 with
``fused_dw`` (the stretch recipe's) and the B0 train step with
``make_train_step``'s default loss (forward, loss, backward, clip, Adam).
``tests/test_torch_paths_pinned.py`` holds them to the sequences this
module wrote at the commit before the BEVFusion model came in
(``tests/pinned_paths.json``):

    python tests/pinned_paths.py tests/pinned_paths.json

A sequence is the aten (and ``lss::``) operators each path dispatches, in
order, as ``TorchDispatchMode`` sees them; the program's is the
``call_function`` targets of its graph. The file keeps each as indices
into one table of the names (``pack``). Imports no JAX."""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.models.lss import compile_model

GRID = GridConf(xbound=(-16.0, 16.0, 1.0), ybound=(-16.0, 16.0, 1.0),
                zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 12.0, 2.0))
AUG = DataAugConf(H=64, W=128, final_dim=(64, 128))


class Ops(TorchDispatchMode):
    """Records the name of every operator dispatched inside the ``with``."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def model(variant, **kw):
    torch.manual_seed(0)
    return compile_model(GRID, AUG, device="cpu", variant=variant,
                         generator=torch.Generator().manual_seed(0), **kw)


def batch(B=2, N=6, outC=1):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, N, 3, 64, 128), dtype=np.uint8))
    rots = torch.eye(3).expand(B, N, 3, 3).clone()
    trans = torch.zeros(B, N, 3)
    intrins = torch.tensor([[60.0, 0, 64], [0, 60.0, 32], [0, 0, 1]]).expand(B, N, 3, 3).clone()
    post_rots = torch.eye(3).expand(B, N, 3, 3).clone()
    post_trans = torch.zeros(B, N, 3)
    labels = (torch.from_numpy(rng.uniform(size=(B, outC, 32, 32))) < 0.1).float()
    return imgs, rots, trans, intrins, post_rots, post_trans, labels


def train_forward(variant, **kw) -> list:
    m = model(variant, compute_dtype="bfloat16", **kw).train()
    with Ops() as ops:
        m(*batch(outC=m.outC)[:6])
    return ops.names


def default_step() -> list:
    from lss_carla_torch.training.state import create_train_state
    from lss_carla_torch.training.step import make_train_step
    m = model("b0", compute_dtype="bfloat16")
    state = create_train_state(m, lr=1e-3, lr_schedule="cosine", warmup_steps=2,
                               decay_steps=10)
    step = make_train_step(m, 2.13, device="cpu")
    b = batch()
    step(state, b)                       # Adam's state made
    with Ops() as ops:
        step(state, b)
    return ops.names


def export_program() -> list:
    from lss_carla_torch.serving import export_predict
    m = model("b0")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "b0.pt2")
        export_predict(m, path, bsz=1, uint8_images=True)
        program = torch.export.load(path)
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


PATHS = {"b0_export": export_program,
         "b0_train_forward": lambda: train_forward("b0"),
         "b4_train_forward": lambda: train_forward("b4", outC=4, fused_dw=True),
         "b0_default_step": default_step}


def pack(paths: dict) -> dict:
    """{"names": [every name once], path: "i j k ..." indices}."""
    names = sorted({n for seq in paths.values() for n in seq})
    at = {n: i for i, n in enumerate(names)}
    return {"names": names, **{k: " ".join(str(at[n]) for n in seq)
                               for k, seq in paths.items()}}


def unpack(packed: dict, path: str) -> list:
    return [packed["names"][int(i)] for i in packed[path].split()]


if __name__ == "__main__":
    out = {name: fn() for name, fn in PATHS.items()}
    with open(sys.argv[1], "w") as f:
        json.dump(pack(out), f, indent=0)
        f.write("\n")
    print({k: len(v) for k, v in out.items()})
