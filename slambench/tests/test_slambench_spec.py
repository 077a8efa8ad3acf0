"""BENCHMARK.json against the benchmark's contract, and every name it holds
against the files the harness finds by it."""

import json
import os
import re

import pytest

from slambench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["slambench"]
    assert bench["command"] == ["python3", "slambench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(bench):
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert "assumed" in body and "sensor" in body
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "slambench", "traffic", w["traffic"] + ".json"))
        spec = harness.load_cell(w["name"])
        # the mix names the generator that reads it and the frame driver
        gen = harness.traffic_module("generators", spec.traffic["generator"])
        driver = harness.traffic_module("drivers", spec.traffic["driver"])
        assert callable(gen.make) and callable(driver.run) and callable(driver.frames_needed)
        for key in ("warm_frames", "max_fps", "ate_frames", "trace", "sample", "limits"):
            assert key in spec.cell, (w["name"], key)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics_have_readers_and_cover_every_cell(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(harness.metric_reader(m["name"]))
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        assert callable(harness.metric_reader(m["name"]))
    for w in bench["workloads"]:
        spec = harness.load_cell(w["name"])
        got = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert spec.per_layer
        for m in spec.per_layer:
            assert m["moves"] in got


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, "slambench")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if f.endswith(".pyc"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


@pytest.mark.parametrize("name", ["../harness", "lidar_scene.py", "", "a b"])
def test_a_traffic_module_is_found_by_a_plain_name_only(name):
    with pytest.raises(SystemExit):
        harness.traffic_module("generators", name)


def test_cells_change_the_profile_only_through_the_configuration():
    # a cell's file sets no configuration or sensor key: only the
    # configuration's file (and its ``reduced`` list) sets the profile
    for name in os.listdir(os.path.join(ROOT, "slambench", "cells")):
        with open(os.path.join(ROOT, "slambench", "cells", name)) as f:
            cell = json.load(f)
        assert set(cell) <= {"warm_frames", "max_fps", "ate_frames", "trace", "sample",
                             "closures_expected", "limits"}, (name, sorted(cell))
