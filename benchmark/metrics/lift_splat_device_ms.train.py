"""Device time of the splat a training step: the activities named
``splat_kernel`` (the port's hand-written kernel, one launch a forward)
over the traced part, over its steps. The splat's alone: the lift's outer
product is an elementwise product that PyTorch's kernels of that name
also run elsewhere in the step, so it cannot be named apart. Nothing where
the trace lost some launches (their count not a multiple of the
forwards)."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("forwards") or not run.get("traced_steps"):
        return None
    seconds, launches = trace.kernel("splat_kernel")
    if launches == 0 or launches % run["forwards"] or seconds <= 0:
        return None
    return 1e3 * seconds / run["traced_steps"]
