"""The per-layer metrics that read the port's span table
(``lss_carla_torch.utils.trace.table()``): their arithmetic on a filled
table, nothing on an empty one or where the port has no table (a parent
without it), and real readings after a profiled step on the CPU."""

import sys

import numpy as np
import pytest
import torch

from benchmark.harness import ROOT, load_reader, read_json

M = read_json(ROOT / "BENCHMARK.json")
SPAN_METRICS = [m["name"] for m in M["per_layer"] if m["source"] == "program_span"]

# {name: (count, seconds)}: 5 steps of 2 microbatches, and spans of other
# threads that no metric reads
TABLE = {"lss.step": (5, 1.0), "lss.step.forward": (10, 0.3),
         "lss.step.backward": (10, 0.4), "lss.step.update": (5, 0.1),
         "lss.serve.predict": (4, 0.080), "lss.loader.pin": (5, 0.15)}
WANT = {"forward_host_ms.train": 60.0, "backward_host_ms.train": 80.0,
        "update_host_ms.train": 20.0}
# each metric's divisor left out: the spans it sums without the count
NO_DIVISOR = {"forward_host_ms.train": "lss.step", "backward_host_ms.train": "lss.step",
              "update_host_ms.train": "lss.step"}


def port_trace():
    """The port's tracer; these benchmark files also run over a checkout
    of a port that has none, where the readers give nothing."""
    return pytest.importorskip("lss_carla_torch.utils.trace",
                               reason="the port has no span table")


def test_the_three_are_all_the_span_metrics():
    assert sorted(SPAN_METRICS) == sorted(WANT)


@pytest.fixture
def with_table(monkeypatch):
    trace = port_trace()

    def use(t):
        monkeypatch.setattr(trace, "table", lambda: dict(t))
    return use


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_filled_table(with_table, name):
    with_table(TABLE)
    assert load_reader(name)({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_an_empty_table_or_without_its_count(with_table, name):
    with_table({})
    assert load_reader(name)({}) is None
    with_table({k: v for k, v in TABLE.items() if k != NO_DIVISOR[name]})
    assert load_reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_table_in_the_port(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "lss_carla_torch.utils.trace", None)
    assert load_reader(name)({}) is None


def test_readings_after_a_profiled_step_and_loader_pass():
    """The readers after a real step and loader pass of the port under the
    profiler: each non-null, and the step's three phases within its own
    time a step."""
    from torch.profiler import ProfilerActivity, profile

    from lss_carla_torch.configs import DataAugConf, GridConf
    from lss_carla_torch.data.loader import DataLoader, prefetch_to_device
    from lss_carla_torch.models.lss import compile_model
    from lss_carla_torch.training.state import create_train_state
    from lss_carla_torch.training.step import make_train_step

    trace = port_trace()
    grid = GridConf(xbound=(-16.0, 16.0, 2.0), ybound=(-16.0, 16.0, 2.0),
                    zbound=(-10.0, 10.0, 20.0), dbound=(4.0, 12.0, 4.0))
    aug = DataAugConf(H=64, W=128, final_dim=(32, 64))
    model = compile_model(grid, aug, variant="slim", device="cpu",
                          generator=torch.Generator().manual_seed(1))
    state = create_train_state(model)
    step = make_train_step(model, device="cpu")
    eye = np.tile(np.eye(3, dtype=np.float32), (6, 1, 1))
    intrins = eye.copy()
    intrins[:, 0, 0] = intrins[:, 1, 1] = 50.0
    intrins[:, 0, 2], intrins[:, 1, 2] = 32.0, 16.0

    class Samples:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return (np.random.default_rng(i).integers(0, 256, (6, 3, 32, 64), dtype=np.uint8), eye,
                    np.zeros((6, 3), np.float32), intrins, eye,
                    np.zeros((6, 3), np.float32), np.zeros((1, 16, 16), np.float32))

    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for batch in prefetch_to_device(iter(DataLoader(Samples(), 2, num_workers=2)),
                                            "cpu"):
                step(state, batch)
        got = {n: load_reader(n)({}) for n in WANT}
        step_ms = 1e3 * trace.table()["lss.step"][1] / 2
    finally:
        trace.reset()
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["forward_host_ms.train"] + got["backward_host_ms.train"] \
        + got["update_host_ms.train"] <= step_ms
