"""The model's FLOPs a sample (the reference's, counted once at the
cell's shapes) times the samples answered in the window, over the window
and the published dense peak of the cell's precision."""


def read(run):
    if not run.get("flops_per_sample") or not run.get("answered"):
        return None
    return (100.0 * run["flops_per_sample"] * run["answered"]
            / run["window_s"] / run["peak_flops"])
