"""Checkpoints as torch files in the reference's contract: counterpart of
``lss_carla_tpu/utils/checkpoint.py`` (reference ``train_simbev.py:417-453``).

Each file is ``torch.save`` of ``{model_state_dict, optimizer_state_dict,
counter, epoch[, val_iou][, ema_state_dict]}``: ``model_{counter:06d}.pt``
periodically and on preemption, ``model_best.pt`` at a new best validation
IoU, and ``model_final.pt`` at the end. ``model_state_dict`` holds the
reference names, so ``model_best.pt`` loads through ``serving.py
--checkpoint`` and reference tools; a run with EMA adds the averaged
model's state dict, in the same names, as ``ema_state_dict`` (the JAX
checkpoint's ``ema_params`` and ``ema_batch_stats``).
Writes go to a temporary file renamed into place: a file is whole or
absent. ``load_checkpoint`` resumes from a file or from the newest file of
a directory.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

BEST, FINAL = "model_best.pt", "model_final.pt"
_NUMBERED = re.compile(r"model_(\d+)\.pt$")


def _read(path, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def _cpu_state(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


class CheckpointManager:
    """Writes the checkpoint files of one run into ``directory``."""

    def __init__(self, directory):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _write(self, name: str, counter: int, model, optimizer, epoch: int,
               val_iou: Optional[float] = None, ema_model=None) -> Path:
        blob = {"model_state_dict": _cpu_state(model),
                "optimizer_state_dict": optimizer.state_dict(),
                "counter": int(counter), "epoch": int(epoch)}
        if val_iou is not None:
            blob["val_iou"] = float(val_iou)
        if ema_model is not None:
            blob["ema_state_dict"] = _cpu_state(ema_model)
        path = self.directory / name
        tmp = path.with_name(f".{name}.{os.getpid()}.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, path)
        return path

    def save(self, counter: int, model, optimizer, epoch: int,
             ema_model=None) -> Path:
        return self._write(f"model_{int(counter):06d}.pt", counter, model,
                           optimizer, epoch, ema_model=ema_model)

    def save_best(self, counter: int, model, optimizer, epoch: int,
                  val_iou: float, ema_model=None) -> Path:
        return self._write(BEST, counter, model, optimizer, epoch, val_iou,
                           ema_model)

    def save_final(self, counter: int, model, optimizer, epoch: int,
                   ema_model=None) -> Path:
        return self._write(FINAL, counter, model, optimizer, epoch,
                           ema_model=ema_model)

    def best_val_iou(self) -> Optional[float]:
        """The val IoU ``model_best.pt`` records (None without one)."""
        path = self.directory / BEST
        if not path.exists():
            return None
        return float(torch.load(path, map_location="cpu", weights_only=True,
                                mmap=True).get("val_iou", 0.0))


def latest_checkpoint(directory) -> Optional[Path]:
    """The numbered or final checkpoint of ``directory`` with the highest
    counter (a numbered one on a tie), or None."""
    best = None
    for path in Path(directory).iterdir():
        m = _NUMBERED.match(path.name)
        if m:
            key = (int(m.group(1)), 1)
        elif path.name == FINAL:
            key = (int(torch.load(path, map_location="cpu", weights_only=True,
                                  mmap=True)["counter"]), 0)
        else:
            continue
        if best is None or key > best[0]:
            best = (key, path)
    return None if best is None else best[1]


def load_checkpoint(path) -> dict:
    """A checkpoint dict from a file, or from the newest checkpoint of a
    directory; raises FileNotFoundError when there is none."""
    path = Path(path)
    if path.is_dir():
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = found
    return _read(path)
