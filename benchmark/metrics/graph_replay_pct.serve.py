"""Share of the traced part's calls of the served artifact that replayed
its CUDA graph: 100 x the count of the port's ``lss.serve.replay`` span
over the counts of ``lss.serve.replay`` and ``lss.serve.eager`` together
(every call of the artifact enters exactly one of the two), from the
port's span table (``lss_carla_torch.utils.trace``), which fills only
while a profiler records. The batcher thread's spans are counted exactly,
though their durations are not. Nothing where the port has no such table
or neither span (a port whose artifact has no graph)."""


def read(run):
    try:
        from lss_carla_torch.utils.trace import table
    except ImportError:
        return None
    t = table()
    replays = t.get("lss.serve.replay", (0, 0.0))[0]
    eager = t.get("lss.serve.eager", (0, 0.0))[0]
    return 100.0 * replays / (replays + eager) if replays + eager else None
