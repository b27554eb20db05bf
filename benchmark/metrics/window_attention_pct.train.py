"""Share of the traced part's device time in the window attention: 100 x
the device time of the kernels that ``torch.nn.functional.
scaled_dot_product_attention`` launched for the Swin trunk's windows (on
the H100 with torch 2.11, its memory-efficient kernels, named
``fmha_cutlassF`` forward and ``fmha_cutlassB`` backward) over the traced
part's busy time. Nothing where the trace holds none, lost some, or shows
some blocks on another backend: each of the two kernels must have run
exactly once a ``window_attention`` call of an eager forward (one a Swin
block) a traced forward, so a block fallen to SDPA's math path reads as
nothing, and the attention windows that the port's counter saw computed
over the traced steps (replays counted as their capture recorded) must be
those forwards' windows."""

KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("forwards") or trace.busy_s <= 0:
        return None
    per, seen = run.get("windows_per_forward") or {}, run.get("windows") or {}
    if not per or any(seen.get(k) != run["forwards"] * v for k, v in per.items()):
        return None
    calls = run.get("attention_calls_per_forward")
    if not calls:
        return None
    seconds = 0.0
    for name in KERNELS:
        s, n = trace.kernel(name)
        if n != run["forwards"] * calls:
            return None
        seconds += s
    return 100.0 * seconds / trace.busy_s
