"""Metric logging: counterpart of ``lss_carla_tpu/utils/logging.py``.

``MetricLogger`` appends one JSON line a call to ``<logdir>/metrics.jsonl``
and, where ``tensorboardX`` is importable, writes tensorboard scalars under
the same names the JAX trainer uses (``train/loss``, ``train/iou``,
``train/step_time``, ``train/samples_per_sec``, ``val/loss``,
``val/iou``, ...). wandb and figures are not ported yet.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir=logdir)

    def scalars(self, step: int, **kv):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in kv.items()})
        if self._tb is not None:
            for k, v in kv.items():
                self._tb.add_scalar(k, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """The MetricLogger interface, writing nothing."""

    def scalars(self, step: int, **kv):
        pass

    def close(self):
        pass
