"""Share of the traced window in which no device activity ran: 1 - the
union of the device intervals over the window's host-clock length."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
