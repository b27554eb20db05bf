"""Stall watchdog: the port's own copy of ``lss_carla_tpu/training/watchdog.py``.

A training run can hang with the process alive: a step that never
completes on the device, a loader thread that never delivers. Recovery is
to kill the run and ``--resume`` from the last checkpoint; what is missing
without a watchdog is the detection, so an unattended run can sit hung for
hours.

``StallWatchdog`` is a daemon thread fed a heartbeat (``beat()``) after
completed steps. If no beat arrives for ``timeout_s`` it dumps every
thread's stack (``faulthandler``) and warns; if ``abort_after`` is set and
the stall lasts that long, it hard-exits the process (``os._exit``) with
code 42 so a supervisor (``--supervise``, a shell loop, k8s, slurm)
restarts the run with ``--resume``. A graceful exit is not attempted: a
checkpoint save would need the same wedged device, so the last saved
checkpoint is the recovery point.

The trainer arms it with ``watchdog_secs`` (0 = off) after the first step
completes, since the first step includes one-time set-up (cuDNN algorithm
search, the kernels' first build).
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

WATCHDOG_EXIT = 42


class StallWatchdog:
    """Daemon thread that trips when ``beat()`` stops arriving."""

    def __init__(self, timeout_s: float,
                 abort_after: Optional[float] = None,
                 abort_fn: Callable[[int], None] = os._exit,
                 warn_fn: Callable[[str], None] = None):
        if abort_after is not None and abort_after < timeout_s:
            raise ValueError("abort_after must be >= timeout_s")
        self.timeout_s = float(timeout_s)
        self.abort_after = abort_after
        self._abort_fn = abort_fn
        self._warn_fn = warn_fn or (lambda msg: print(msg, file=sys.stderr,
                                                      flush=True))
        self._last_beat = None          # None until armed
        self._warned = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        """Record progress; the first beat arms the watchdog."""
        self._last_beat = time.monotonic()
        self._warned = False

    def pause(self):
        """Disarm during legitimately slow phases (a checkpoint write; an
        abort mid-write would abandon the write recovery depends on).
        Re-arm with ``beat()``.

        With ``async_save`` a periodic write continues in a background
        thread after ``beat()`` re-arms, so a later hard exit can land
        mid-write. That is safe: each file is written to a temporary name
        and renamed into place (``utils/checkpoint.py``), so the older
        checkpoints survive whole; only the newest save may be lost."""
        self._last_beat = None

    def stop(self):
        self._stop.set()

    # internal -----------------------------------------------------------
    def _run(self):
        poll = max(min(self.timeout_s / 4.0, 30.0), 0.05)
        while not self._stop.wait(poll):
            last = self._last_beat
            if last is None:     # not armed yet, or paused
                continue
            stalled = time.monotonic() - last
            if stalled >= self.timeout_s and not self._warned:
                self._warned = True
                self._warn_fn(
                    f"[watchdog] no step progress for {stalled:.0f}s "
                    f"(timeout {self.timeout_s:.0f}s). Thread stacks "
                    f"follow; recovery: kill this process and restart with "
                    f"--resume.")
                try:
                    faulthandler.dump_traceback(file=sys.stderr)
                except (OSError, ValueError) as e:  # a stderr without a file
                    # descriptor; the abort below must still come
                    self._warn_fn(f"[watchdog] could not dump stacks: {e}")
            if (self.abort_after is not None
                    and stalled >= self.abort_after):
                self._warn_fn(
                    f"[watchdog] stall exceeded {self.abort_after:.0f}s: "
                    f"hard-exiting (code {WATCHDOG_EXIT}) for a supervisor "
                    f"restart; a graceful checkpoint would hang on the same "
                    f"stall.")
                self._abort_fn(WATCHDOG_EXIT)
                return   # reachable only with an injected abort_fn (tests)
