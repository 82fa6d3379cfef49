"""Every configuration, traffic mix, metric and limits file that
BENCHMARK.json names is found by its name, and BENCHMARK.json keeps the
keys, names and units its format allows."""
import json
import os
import re

import pytest

from slambench import cells, check, traffic

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"] and BENCH["command"][1].startswith("slambench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"slambench/configs/{cfg['name']}.json"
    data = cells.load_config(cfg["name"])
    assert data["source"] and len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    assert sorted(cfg["reduced"]) == sorted(data["reduced"])
    assert all(NAME.match(k) and k in data for k in cfg["reduced"])
    assert {k for k in data if k.startswith("System.")} <= set(cells.MODE)
    for key in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy", "Camera.width",
                "Camera.height", "Camera.fps", "ORBextractor.nFeatures", "Map.max_keyframes"):
        assert key in data


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    cells.load_config(cell["config"])
    mix = traffic.load(cell["traffic"])
    assert set(mix["trajectory"]) <= set(traffic.CHANNELS) | {"length"}
    assert 0 <= mix["pretrack"] < mix["frames"]
    limits = check.load_limits(cell["name"])
    assert set(limits) == set(check.NUMBERS)
    assert all(metric in METRICS_BY_NAME for metric in ("frames_per_s", "setup_s"))


METRICS_BY_NAME = {m["name"]: m for m in METRICS}


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_found_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    mod = cells.load_metric(m["name"])
    assert callable(mod.read)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"], m["source"])
    if m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        cell_names = {c["name"] for c in BENCH["workloads"]}
        assert set(m.get("workloads", [])) <= cell_names
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25


def test_every_cell_reports_enough():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in cells.metrics_of(BENCH, cell, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.metrics_of(BENCH, cell, trace=True)


def test_files_under_paths_are_named_from_name_characters():
    for root, _, files in os.walk(os.path.join(cells.ROOT, "slambench")):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), cells.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_every_metric_has_a_reader():
    files = {f[:-3] for f in os.listdir(os.path.join(cells.HERE, "metrics")) if f.endswith(".py")}
    assert {m["name"] for m in METRICS} <= files
    assert json.dumps(BENCH)  # plain JSON
