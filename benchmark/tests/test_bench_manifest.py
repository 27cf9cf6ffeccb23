"""BENCHMARK.json against the contract's shape: every cell, configuration,
traffic mix and metric resolves to its file by name; names and units use
the allowed characters; every per-layer metric names one end-to-end metric
that each of its cells reports."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
M = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(M["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in M["command"])
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in M["configs"]] + [w["name"] for w in M["workloads"]]
    names += [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    names += [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]
    names += [k for c in M["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    metrics = M["end_to_end"] + M["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for text in [c["source"] for c in M["configs"]] + [w["why"] for w in M["workloads"]] + [
            m["layer"] for m in M["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_resolve(cell):
    w = next(x for x in M["workloads"] if x["name"] == cell)
    assert w["chips"] in (1, 4)
    assert os.path.isfile(os.path.join(BENCH, "workloads", f"{cell}.json"))
    assert os.path.isfile(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    conf = next(c for c in M["configs"] if c["name"] == w["config"])
    assert os.path.isfile(os.path.join(ROOT, conf["file"]))
    assert os.path.isfile(os.path.join(BENCH, "reference", f"{w['config']}.py"))
    spec = json.load(open(os.path.join(BENCH, "workloads", f"{cell}.json")))
    assert os.path.isfile(os.path.join(BENCH, "drivers", f"{spec['driver']}.py"))
    assert spec["limits"], "a cell compares at least one number"


def test_configs():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in body and not re.search(r"(_dim|_rank|width|hidden|units)$", k.lower()), k


def reported(cell, kind):
    return {m["name"] for m in M[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = reported(cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reported(cell, "per_layer")


def test_metrics_resolve_and_move_what_their_cells_report():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert os.path.isfile(os.path.join(BENCH, "endtoend", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells
    setup = next(m for m in M["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in reported(cell, "end_to_end"), (m["name"], cell)
    assert any("mfu" in m["name"] for m in M["per_layer"])
