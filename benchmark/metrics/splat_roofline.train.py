"""The splat kernel's share of its roofline over the traced window: the
least time of every call (the bytes each call needs, over the memory rate:
``roofline.splat_seconds`` on the voxel ids of the call's own batch) over
the device time of the activities named ``splat_kernel``. Nothing where
the trace lost some of those activities (their count is not a multiple
of the calls)."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("forwards"):
        return None
    seconds, launches = trace.kernel("splat_kernel")
    if launches == 0 or launches % run["forwards"] or seconds <= 0:
        return None
    return 100.0 * run["splat_bound_s"] / seconds
