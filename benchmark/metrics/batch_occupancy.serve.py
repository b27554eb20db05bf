"""Samples a device batch held over the window: the coalescing service's
own counters (``batches``, ``batched_samples``), differenced."""


def read(run):
    return run["batched_samples"] / run["batches"] if run.get("batches") else None
