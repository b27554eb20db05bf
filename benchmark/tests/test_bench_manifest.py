"""BENCHMARK.json and every file it names: the contract's shapes, names,
units and limits, and that a cell, a configuration, a traffic mix and a
metric are found by name, so adding one needs only new files."""

import json
import re
import shutil

import pytest

from benchmark.drivers import serve, train
from benchmark.harness import (BENCH, ROOT, cell_metrics, load_cell, load_driver,
                               load_reader, read_json, valid_name, valid_unit)

M = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in M["workloads"]]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|"
                   r"head|expansion|experts_per_token|camC|width")


# the numbers every training cell compares: of the first step, of the
# three steps' parameter norms and of the step after the window
TRAIN_LIMITS = {"dlogits_gap", "bev_gap", "grad1_gap", "change_gap", "after_dlogits_gap"}


def line(text, most=200):
    return isinstance(text, str) and 0 < len(text) <= most and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert M["paths"] == ["benchmark"] and M["command"][1:] == ["benchmark/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    # a full check of 24 cells fits in the driver's 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_valid(kind):
    names = [e["name"] for e in M[kind]]
    assert len(set(names)) == len(names)
    assert all(valid_name(n) for n in names), names


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if metric in M["end_to_end"] else {"layer", "moves", "workloads"}
    assert set(metric) - {"workloads"} == keys - {"workloads"}
    assert "workloads" in metric or "bound" in metric   # a per-layer metric lists its cells
    assert valid_unit(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
        assert callable(load_reader(metric["name"]))
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", [m for m in M["end_to_end"] + M["per_layer"]
                                    if "workloads" in m], ids=lambda m: m["name"])
def test_metric_workloads_list_exactly_the_cells_that_report_it(metric):
    """Each listed cell's driver reports the end-to-end metric (or, for a
    per-layer one, the metric it moves), and every cell whose driver
    reports an end-to-end metric and that should is listed."""
    moved = metric.get("moves", metric["name"])
    assert set(metric["workloads"]) <= set(CELLS)
    for cell in metric["workloads"]:
        e2e, layer = cell_metrics(M, cell)
        assert moved in {m["name"] for m in e2e}
        driver = read_json(BENCH / "workloads" / f"{cell}.json")["driver"]
        assert moved in load_driver(driver).METRICS
    if "moves" not in metric:
        assert set(metric["workloads"]) == {c for c in CELLS if metric in cell_metrics(M, c)[0]}


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_reports(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and line(cell["why"])
    assert valid_name(cell["config"]) and valid_name(cell["traffic"])
    c = load_cell(cell["name"], seed=1, seconds=1.0, trace=False)
    assert c.work["driver"] in ("train", "serve")
    e2e, layer = cell_metrics(M, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    assert set(c.work["limits"]) >= (TRAIN_LIMITS if c.work["driver"] == "train"
                                     else {"rel_l2_vs_tf32", "unanswered"})
    assert sum(1 for w in M["workloads"] if (w["config"], w["traffic"]) ==
               (cell["config"], cell["traffic"])) == 1


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert line(config["source"]) and line(config["why"])
    assert config["file"].startswith("benchmark/configs/")
    assert config["name"] in {w["config"] for w in M["workloads"]}
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert valid_name(key) and not WIDTH.search(key), key
    body = read_json(ROOT / config["file"])
    for key in config["reduced"]:
        assert key in body and key in body.get("published", {}), key
    assert [c["file"] for c in M["configs"]].count(config["file"]) == 1


def test_drivers_declare_their_metrics():
    assert set(train.METRICS) == {"train_samples_per_s", "setup_s"}
    assert set(serve.METRICS) == {"serve_p95_ms", "serve_samples_per_s", "setup_s"}


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files and entries; the harness finds each
    by name and edits nothing."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    manifest = json.loads(json.dumps(M))
    b = tmp_path / "benchmark"
    (b / "configs" / "b0-wide.json").write_text(
        json.dumps(dict(read_json(BENCH / "configs" / "b0-simbev.json"), outC=2)))
    (b / "traffic" / "poisson-slow.json").write_text(
        json.dumps(dict(read_json(BENCH / "traffic" / "poisson-overload.json"), rate_per_s=5)))
    (b / "workloads" / "b0-wide-serve.json").write_text(
        (BENCH / "workloads" / "b0-serve-overload.json").read_text())
    (b / "metrics" / "answered.serve.py").write_text(
        "def read(run):\n    return run.get('answered')\n")
    manifest["configs"].append({"name": "b0-wide", "source": "https://example.org/x",
                                "file": "benchmark/configs/b0-wide.json",
                                "reduced": [], "why": "two classes"})
    manifest["workloads"].append({"name": "b0-wide-serve", "config": "b0-wide",
                                  "traffic": "poisson-slow", "chips": 1, "why": "slow"})
    manifest["per_layer"].append({"name": "answered.serve", "unit": "samples",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "HTTP + batcher", "moves": "serve_samples_per_s",
                                  "workloads": ["b0-wide-serve"]})
    for m in manifest["end_to_end"]:
        if m["name"] == "serve_samples_per_s":
            m["workloads"].append("b0-wide-serve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = load_cell("b0-wide-serve", root=tmp_path, seed=3, seconds=1.0, trace=True)
    assert cell.config["outC"] == 2 and cell.traffic["rate_per_s"] == 5
    e2e, layer = cell_metrics(manifest, "b0-wide-serve")
    assert {m["name"] for m in e2e} == {"serve_samples_per_s", "setup_s"}
    assert [m["name"] for m in layer] == ["answered.serve"]
    assert load_reader("answered.serve", tmp_path)({"answered": 12}) == 12
