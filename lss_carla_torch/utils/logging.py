"""Metric logging: counterpart of ``lss_carla_tpu/utils/logging.py``.

``MetricLogger`` appends one JSON line a call to ``<logdir>/metrics.jsonl``
and, where ``tensorboardX`` is importable, writes tensorboard scalars under
the same names the JAX trainer uses (``train/loss``, ``train/iou``,
``train/step_time``, ``train/samples_per_sec``, ``val/loss``,
``val/iou``, ...) and its figures (``train/visualization``,
``val/visualization``). With ``use_wandb`` it also logs both to wandb
where wandb is installed, and says so and goes on where it is not, as the
JAX logger does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, logdir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir=logdir)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("wandb requested but not installed; skipping")
            else:
                wandb.init(dir=logdir, **(wandb_kwargs or {}))
                self._wandb = wandb

    def scalars(self, step: int, **kv):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in kv.items()})
        if self._tb is not None:
            for k, v in kv.items():
                self._tb.add_scalar(k, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({**kv, "iteration": step})

    def figure(self, step: int, tag: str, fig):
        """A matplotlib figure to wandb and tensorboard (where they are)."""
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Image(fig), "iteration": step})
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)

    def summary(self, **kv):
        """Run-level values (``best_val_iou``): wandb's run summary."""
        if self._wandb is not None:
            for k, v in kv.items():
                self._wandb.run.summary[k] = v

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The MetricLogger interface, writing nothing."""

    def scalars(self, step: int, **kv):
        pass

    def figure(self, step: int, tag: str, fig):
        pass

    def summary(self, **kv):
        pass

    def close(self):
        pass
