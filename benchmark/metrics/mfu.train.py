"""The model's FLOPs a step (forward and backward, the reference's,
counted once at the cell's shapes; no recomputation, optimizer or EMA)
times the steps of the window, over the window and the published dense
peak of the cell's precision."""


def read(run):
    if not run.get("flops_per_step") or not run.get("steps"):
        return None
    return (100.0 * run["flops_per_step"] * run["steps"]
            / run["window_s"] / run["peak_flops"])
