"""Device time a batch forward over the traced part of the window: every
device activity's time there, over the batches the service ran in it."""


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("traced_batches") or trace.device_s() <= 0:
        return None
    return 1e3 * trace.device_s() / run["traced_batches"]
