"""The traced run: torch.profiler over a part of the run, and what the
per-layer metrics read from it.

A traced run (``--trace 1``) measures its window as an untraced run does,
then profiles ``TRACE_S`` more seconds of the same traffic: the
profiler's own cost stays out of the window, and reading the profile after
the traced part leaves the traffic alone. The traced part is padded with
host sleeps of ``PAD_S`` at both ends, as ``chip_smoke.py::profile_window``
does: on the H100 host a window's device timestamps, mapped onto the host
clock, once strayed 125 ms before the host events that launched them, and
unpadded windows of short calls came back without device time.

``busy_s`` is the union of every device activity's interval (kernels,
copies, fills; not the device-side spans of user annotations), so
overlapping activities count once and the busy time can never exceed the
wall time. Every device reading is cut to the traced part's span, and
``window_s`` is its host-clock length. The idle gaps between device
activities are named by what the host was doing at their middle: the
innermost span of the benchmark's own (``record_function``), or else the
outermost operator then running, or else "host".
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PAD_S = 0.5
# a traced run's traced part, after its measured window: reading a longer
# profile takes longer than a run may (a second of the stretch step holds
# some 40,000 device activities, and reading 5 s of them takes some 45 s)
TRACE_S = 5.0
TRACED_SPAN = "bench.traced"
# the spans the benchmark's own files put around their calls into each layer
SPANS = ("loader.next", "train_step", "service.warmup", TRACED_SPAN)


class Summary:
    """Device intervals and host spans of one traced part."""

    def __init__(self, device: List[Tuple[float, float, str]],
                 host: List[Tuple[float, float, str, bool]],
                 window: Tuple[float, float], window_s: float):
        lo, hi = self.window = window             # the window span, us
        # (start us, end us, name), cut to the window
        self.device = sorted((max(s, lo), min(e, hi), n) for s, e, n in device
                             if e > lo and s < hi)
        self.host = host                          # (start, end, name, span)
        self.window_s = window_s
        self.busy_s = union_s([(s, e) for s, e, _ in self.device])

    def kernel(self, needle: str) -> Tuple[float, int]:
        """(seconds, launches) of the device activities whose name holds
        ``needle``."""
        hits = [(e - s) for s, e, n in self.device if needle in n]
        return sum(hits) / 1e6, len(hits)

    def device_s(self) -> float:
        """Summed device activity time (overlaps counted twice)."""
        return sum(e - s for s, e, _ in self.device) / 1e6

    def gaps(self) -> Dict[str, float]:
        """Idle seconds inside the window by what the host was doing."""
        lo, hi = self.window
        merged = merge([(s, e) for s, e, _ in self.device])
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        mids = [(a + b) / 2 for a, b in gaps]
        spans = active([(s, e, n, e - s) for s, e, n, sp in self.host
                        if sp and n != TRACED_SPAN], mids)
        ops = active([(s, e, n, s) for s, e, n, sp in self.host if not sp], mids)
        out = defaultdict(float)
        for (a, b), sp, op in zip(gaps, spans, ops):
            out[sp or op or "host"] += (b - a) / 1e6
        return dict(out)

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for s, e, n in self.device:
            by_name[n[:120]] += (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def active(items, points) -> List[Optional[str]]:
    """For each of the sorted ``points``, the name of the item (start,
    end, name, rank) covering it with the least rank, or None."""
    items, out, live, i = sorted(items), [], [], 0
    for t in points:
        while i < len(items) and items[i][0] <= t:
            live.append(items[i])
            i += 1
        live = [it for it in live if it[1] >= t]
        out.append(min(live, key=lambda it: it[3])[2] if live else None)
    return out


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_s(intervals) -> float:
    return sum(e - s for s, e in merge(intervals)) / 1e6


def span(name: str):
    """A host span of the benchmark's own (a no-op outside a profile)."""
    from torch.profiler import record_function
    return record_function(name)


class Profiled:
    """``with Profiled() as p:`` around a traced part: torch.profiler over
    it, padded by host sleeps at both ends; the caller synchronises the
    device before the ``with`` ends. After it, ``p.summary`` holds the
    reading, with the traced part's host-clock seconds as its window."""

    def __init__(self):
        self.summary: Optional[Summary] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(PAD_S)
        self._span = span(TRACED_SPAN)
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        seconds = self.elapsed()
        self._span.__exit__(None, None, None)
        time.sleep(PAD_S)
        self.prof.__exit__(None, None, None)
        if exc[0] is None:
            self.summary = summarise(self.prof, seconds)
        return False


def summarise(prof, window_s: float) -> Summary:
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                device.append((s, t, e.name))
        elif e.name == TRACED_SPAN:
            window = (s, t)
        elif e.name in SPANS:
            host.append((s, t, e.name, True))
        elif e.cpu_parent is None:
            host.append((s, t, e.name, False))
    if window is None:
        raise RuntimeError("the profile holds no window span")
    return Summary(device, host, window, window_s)
