"""Host time in ``next()`` on the port's device iterator (the loader, its
prefetch thread and the copy), a step, averaged over the window's steps;
the benchmark times its own call."""


def read(run):
    if run.get("loader_wait_s") is None or not run.get("steps"):
        return None
    return 1e3 * run["loader_wait_s"] / run["steps"]
