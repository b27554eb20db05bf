"""``graph_replay_pct.train``'s reader over the port's span table: nothing
without the table, without a step under the profiler or without a replay
span, and the replays' share of the steps where there are both."""

import sys

import pytest

from benchmark.harness import load_reader

NAME = "graph_replay_pct.train"


@pytest.fixture
def with_table(monkeypatch):
    trace = pytest.importorskip("lss_carla_torch.utils.trace",
                                reason="the port has no span table")

    def use(t):
        monkeypatch.setattr(trace, "table", lambda: dict(t))
    return use


def test_without_the_table_in_the_port(monkeypatch):
    monkeypatch.setitem(sys.modules, "lss_carla_torch.utils.trace", None)
    assert load_reader(NAME)({}) is None


@pytest.mark.parametrize("table", [
    {},                                                     # no step profiled
    {"lss.step.replay": (4, 0.01), "lss.loader.pin": (5, 0.1)},  # no lss.step count
    {"lss.step": (5, 1.0), "lss.step.forward": (5, 0.5)},   # steps, no replay span
], ids=["empty", "no_step_count", "no_replay_span"])
def test_nothing_to_read(with_table, table):
    with_table(table)
    assert load_reader(NAME)({}) is None


@pytest.mark.parametrize("table,want", [
    ({"lss.step": (5, 1.0), "lss.step.capture": (1, 0.9),
      "lss.step.replay": (4, 0.01), "lss.step.forward": (1, 0.2)}, 80.0),
    ({"lss.step": (24, 1.0), "lss.step.replay": (24, 0.02)}, 100.0),
], ids=["mixed", "all_replayed"])
def test_replays_over_steps(with_table, table, want):
    with_table(table)
    assert load_reader(NAME)({}) == pytest.approx(want)
