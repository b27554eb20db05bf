"""Host time a training step spends in the model's forward, every
microbatch's (the port's ``lss.step.forward`` span): the span's seconds
over the count of ``lss.step``, from the port's span table
(``lss_carla_torch.utils.trace``), which fills only while a profiler
records; nothing where the port has no such table. So it is the host time
of a profiled step: the profiler records every operator the phase runs,
and a change that runs fewer (a graph replay) also sheds that cost, which
an untraced step does not pay."""


def read(run):
    try:
        from lss_carla_torch.utils.trace import table
    except ImportError:
        return None
    t = table()
    steps = t.get("lss.step", (0, 0.0))[0]
    return 1e3 * t.get("lss.step.forward", (0, 0.0))[1] / steps if steps else None
