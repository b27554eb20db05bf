"""Restart a stalled training run: the port's counterpart of
``lss_carla_tpu/utils/supervise.py``.

The stall watchdog (``training/watchdog.py``, ``--watchdog_secs N``)
hard-exits with code 42 after 2N seconds without step progress.
``--supervise R`` makes the training CLI a small supervisor that runs the
trainer as a child, ``python -m lss_carla_torch.train`` with the same
arguments less ``--supervise``, and runs it again up to R times after an
exit 42, with ``--resume <logdir>/ckpts`` once that directory holds a
checkpoint ``--resume`` can restore (``model_{counter:06d}.pt`` or
``model_final.pt``), so a hung run resumes from its last save with its
best-IoU tracking intact.

Two departures from the JAX supervisor, by design: its checkpoints are
Orbax step directories, so it looks for a numeric directory (or ``best``);
the port's are files. And the child is the trainer module run with ``-m``,
not ``sys.argv[0]``: under ``-m`` that is the module's file, and running
it as a script breaks the package's imports. ``model_best.pt`` alone does
not count: ``--resume`` on a directory reads its numbered and final files.

Only exit code 42 restarts: a crash (traceback), a SIGTERM preemption
(checkpoint and exit) or a clean finish does not loop. SIGTERM and SIGINT
sent to the supervisor (``timeout``, slurm, k8s) are forwarded to the
child, which checkpoints and exits, and no restart follows, so no child is
left holding the GPU.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys

from lss_carla_torch.training.watchdog import WATCHDOG_EXIT

TRAIN_MODULE = "lss_carla_torch.train"
_RESUMABLE = re.compile(r"model_(\d+|final)\.pt$")


def strip_flag(argv, flag, has_value=True):
    """argv without ``flag`` (and its value: either '--f V' or '--f=V')."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = has_value
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def has_checkpoint(ckpt_dir) -> bool:
    """Whether ``--resume ckpt_dir`` has a checkpoint to restore."""
    return os.path.isdir(ckpt_dir) and any(
        _RESUMABLE.match(e) for e in os.listdir(ckpt_dir))


def child_argv(argv, attempt, ckpt_dir):
    """The child's arguments for restart ``attempt`` (0 = the first run).

    Retries point ``--resume`` at ``ckpt_dir`` when it holds a checkpoint;
    before any save the child starts afresh (resuming an empty directory
    would fail)."""
    out = strip_flag(argv, "--supervise")
    if attempt == 0 or not has_checkpoint(ckpt_dir):
        return out
    return strip_flag(out, "--resume") + ["--resume", ckpt_dir]


def run_supervised(retries: int, logdir: str, argv=None,
                   command=None) -> int:
    """Run ``command + argv`` as a child (``command`` defaults to
    ``[sys.executable, "-m", "lss_carla_torch.train"]``), restarting on
    exit 42 up to ``retries`` times. Returns the last child's exit code."""
    argv = sys.argv[1:] if argv is None else argv
    command = ([sys.executable, "-m", TRAIN_MODULE] if command is None
               else list(command))
    ckpt_dir = os.path.join(logdir, "ckpts")

    # Forward termination signals to the live child (it checkpoints and
    # exits) and stop retrying once one arrived, even if the child's exit
    # races the signal and still reads 42.
    child = None
    terminated = False

    def _forward(signum, _frame):
        nonlocal terminated
        terminated = True
        if child is not None and child.poll() is None:
            print(f"[supervise] forwarding signal {signum} to child "
                  f"pid {child.pid}", flush=True)
            try:
                child.send_signal(signum)
            except OSError:  # the child exited in between
                pass

    prev = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, _forward)
    except ValueError:
        prev = {}  # not in the main thread (test runners)

    rc = WATCHDOG_EXIT
    try:
        for attempt in range(retries + 1):
            if terminated:  # a signal came between two attempts
                print("[supervise] termination signal received; not "
                      "restarting", flush=True)
                return rc
            cmd = command + child_argv(argv, attempt, ckpt_dir)
            print(f"[supervise] attempt {attempt + 1}/{retries + 1}: "
                  + " ".join(cmd), flush=True)
            child = subprocess.Popen(cmd)
            rc = child.wait()
            print(f"[supervise] child exited rc={rc}", flush=True)
            if terminated:
                print("[supervise] termination signal received; not "
                      "restarting", flush=True)
                return rc
            if rc != WATCHDOG_EXIT:
                return rc
        print(f"[supervise] giving up after {retries + 1} watchdog exits",
              flush=True)
        return rc
    finally:
        for sig, h in prev.items():
            if h is not None:  # None: a handler not installed from Python
                signal.signal(sig, h)
