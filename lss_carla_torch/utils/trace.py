"""Spans of the port's own phases, kept only while a profiler records.

``span(name)`` marks one phase of the work. While any ``torch.profiler``
records (``torch.autograd.profiler._is_profiler_enabled``, a process-wide
flag, true in every thread), it enters ``record_function(name)``, so a
profile that records the thread holds the span on the kernels' clock, and
it adds the span's host duration and a count of one to a process-wide table
under ``name``. Otherwise it returns one shared no-op context after that
single flag read: no ``record_function``, no allocation, no lock.

The table is process-wide by design: the HTTP handler threads, the batcher,
the loader's pool and its producer all write to it, and a reader that holds
none of those objects reads it after the profiled part through ``table()``.
It holds durations and counts only; where a span lies in time is the
profiler's own events, on one clock. Every span name of the port starts
with ``lss.``.

The flag drops only once the profiler's stop has returned, and the stop
holds the GIL while it gathers the trace, so a span in flight on another
thread than the one that stops the profiler takes in that stall, and no
check at its exit can tell (the stalled thread runs again before the flag
drops). The table is exact for the spans of the thread that starts and
stops the profiler; the spans of other threads are exact only as profile
events, cut to the part of the profile one wants.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Tuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_table: Dict[str, list] = {}        # name -> [count, nanoseconds]


def _add(name: str, ns: int) -> None:
    with _lock:
        entry = _table.get(name)
        if entry is None:
            _table[name] = [1, ns]
        else:
            entry[0] += 1
            entry[1] += ns


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        _add(self.name, ns)
        return False


def span(name: str):
    """A context that records the phase ``name`` while a profiler records,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def table() -> Dict[str, Tuple[int, float]]:
    """A copy of the table: {name: (count, host seconds)}."""
    with _lock:
        return {name: (n, ns / 1e9) for name, (n, ns) in _table.items()}


def reset() -> None:
    """Clear the table."""
    with _lock:
        _table.clear()


def all_threads_config():
    """A profiler ``experimental_config`` that records every thread's
    spans, where the installed torch has the option; else None."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:            # a torch without the option
        return None
