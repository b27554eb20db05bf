"""One call captured into a CUDA graph, and what its replays launch.

``capture(fn, stream)`` records ``fn()`` on ``stream`` into a CUDA graph
with its own memory pool and returns a ``Graph``: the graph, ``fn``'s
output (tensors of the pool, which every replay rewrites), and what the
capture's calls of the hand-written kernels recorded. Python's cyclic
collection is off during the capture, since a collection there that frees
another graph (its pool's memory) ends the capture; the capture's error
mode is ``thread_local``, so other threads of the process (a server's
handlers) may call CUDA meanwhile. A capture that fails raises, and
leaves the process able to draw random numbers and capture again
(``capture``). The train step (``training/step.py``) and a served
artifact (``serving.py``) capture through here.

A replay calls no kernel wrapper, so the wrappers' own counters
(``launches_by_dtype``) count only what they launched. Each
``Graph.replay`` adds what its capture recorded (``held``: {kernel:
{dtype: kernels}}, from the wrappers' ``captured_by_dtype``) to
``replayed`` here, and its attention windows (``windows``) to
``ops/window_attention.py``'s ``replayed``.
"""

from __future__ import annotations

import gc

import torch

from lss_carla_torch.ops import mbconv_cuda, splat_cuda, window_attention

# the kernel wrappers whose calls a capture records, by kernel
_COUNTED = {"splat": splat_cuda, "dw_conv_stats": mbconv_cuda}

# launches of the hand-written kernels that graph replays issued in this
# process, by kernel and input dtype
replayed = {name: {"float32": 0, "bfloat16": 0} for name in _COUNTED}

# graphs whose capture failed: the caching allocator keeps the filter
# that sent each one's allocations to its pool, and the filter reads the
# graph, so they are kept for the life of the process
_failed = []


def reset_replayed() -> None:
    """Set every ``replayed`` count to 0."""
    for counts in replayed.values():
        for key in counts:
            counts[key] = 0


def _captured() -> dict:
    """{kernel: {dtype: calls its wrapper recorded into a graph}}."""
    return {name: dict(m.captured_by_dtype) for name, m in _COUNTED.items()}


def _count_replay(held: dict) -> None:
    """Add a replay's launches, what its capture recorded, to ``replayed``."""
    for name, by in held.items():
        for k, v in by.items():
            replayed[name][k] += v


class Graph:
    """A captured call. ``replay()`` runs it again on the current stream,
    rewriting ``out``, and counts what it launches."""

    def __init__(self, graph, out, held: dict, windows: dict):
        self.graph, self.out, self.held, self.windows = graph, out, held, windows

    def replay(self) -> None:
        self.graph.replay()
        _count_replay(self.held)
        window_attention.add_replayed(self.windows)


def capture(fn, stream: torch.cuda.Stream) -> Graph:
    """``fn()`` recorded on ``stream``; whatever ends the capture raises.

    PyTorch does not undo a capture that fails: the device's default CUDA
    generator stays marked as capturing, so every later random draw there
    would raise, and the caching allocator keeps the graph's pool open.
    So on a failure the generator takes a clone of its own state (the
    same seed and offset, not marked), and the graph is kept in
    ``_failed``. A graph captured before the failure keeps drawing from
    the old state's offsets, apart from the eager draws."""
    before = _captured()
    windows = dict(window_attention.captured)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
    except BaseException:
        gen = torch.cuda.default_generators[stream.device.index]
        gen.graphsafe_set_state(gen.clone_state())
        _failed.append(graph)
        raise
    finally:
        if collecting:
            gc.enable()
    held = {name: {k: v - before[name][k] for k, v in by.items()}
            for name, by in _captured().items()}
    windows = {k: v - windows[k] for k, v in window_attention.captured.items()}
    return Graph(graph, out, held, windows)
