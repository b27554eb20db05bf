"""The depthwise conv + BN moments kernel's share of its roofline over the
traced window: the summed least time of its launches
(``roofline.dw_seconds`` of each of the trunk's depthwise shapes, once a
train-mode forward) over the device time of the activities named
``dw_conv_stats_kernel``. Nothing where the step does not launch it or the
trace lost some launches."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("dw_bound_s_per_forward"):
        return None
    seconds, launches = trace.kernel("dw_conv_stats_kernel")
    expected = run["forwards"] * run["dw_launches_per_forward"]
    if launches != expected or seconds <= 0:
        return None
    return 100.0 * run["dw_bound_s_per_forward"] * run["forwards"] / seconds
