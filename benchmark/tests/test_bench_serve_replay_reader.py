"""``graph_replay_pct.serve``'s reader over the port's span table: nothing
without the table or without either of the artifact's two spans, and the
replays' share of the artifact's calls where there are any, never above
100."""

import sys

import pytest

from benchmark.harness import load_reader

NAME = "graph_replay_pct.serve"


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
    {},                                                     # nothing profiled
    {"lss.serve.predict": (40, 1.8), "lss.serve.fill": (40, 0.01)},  # a port without the graph
    {"lss.step": (5, 1.0), "lss.step.replay": (5, 0.01)},   # the step's, not the artifact's
], ids=["empty", "no_artifact_span", "step_spans_only"])
def test_nothing_to_read(with_table, table):
    with_table(table)
    assert load_reader(NAME)({}) is None


@pytest.mark.parametrize("table,want", [
    ({"lss.serve.predict": (3, 0.2), "lss.serve.eager": (3, 0.15)}, 0.0),
    ({"lss.serve.predict": (96, 2.1), "lss.serve.replay": (96, 0.4)}, 100.0),
    ({"lss.serve.replay": (9, 0.04), "lss.serve.eager": (1, 0.3),
      "lss.step.replay": (50, 0.1)}, 90.0),
], ids=["only_eager", "only_replays", "mixed"])
def test_replays_over_calls(with_table, table, want):
    with_table(table)
    assert load_reader(NAME)({}) == pytest.approx(want)


@pytest.mark.parametrize("replays,eager", [(1, 0), (10**6, 0), (10**6, 1), (0, 7)])
def test_never_above_100(with_table, replays, eager):
    t = {"lss.serve.replay": (replays, 0.1), "lss.serve.eager": (eager, 0.1)}
    with_table({k: v for k, v in t.items() if v[0]})
    assert 0.0 <= load_reader(NAME)({}) <= 100.0
