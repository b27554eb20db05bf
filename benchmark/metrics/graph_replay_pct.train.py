"""Share of the traced part's training steps that replayed the step's CUDA
graph: 100 x the count of the port's ``lss.step.replay`` span over the
count of ``lss.step``, from the port's span table
(``lss_carla_torch.utils.trace``), which fills only while a profiler
records. Nothing where the port has no such table, ran no step under the
profiler, or has no replay span (a port without the graph)."""


def read(run):
    try:
        from lss_carla_torch.utils.trace import table
    except ImportError:
        return None
    t = table()
    steps = t.get("lss.step", (0, 0.0))[0]
    replays = t.get("lss.step.replay", (0, 0.0))[0]
    return 100.0 * replays / steps if steps and replays else None
