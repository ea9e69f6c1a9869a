"""BENCHMARK.json against the contract's shape, and every configuration,
cell, driver and metric reader found by name."""
import json
import re

import pytest

from zkbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "zkbench/run.py"]
    assert BENCH["paths"] == ["zkbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(set(names)) == len(names)
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.load_cell(cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"] and wl["why"] == entry["why"]
    assert wl["chips"] == entry["chips"] == 1
    assert (harness.BENCH_DIR / "drivers" / f"{wl['driver']}.py").is_file()
    assert hasattr(harness.load_module("drivers", wl["driver"]), "run")
    reported = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                        "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_found_by_name(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"zkbench/configs/{name}.json"
    cfg = harness.load_config(name)
    assert cfg["name"] == name
    assert sorted(cfg["reduced"]) == entry["reduced"]
    for key, (published, run) in cfg["reduced"].items():
        assert cfg[key] == run and cfg["published"][key] == published
    assert any(w["config"] == name for w in BENCH["workloads"])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    reader = harness.load_module("metrics", name)
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert entry["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert reader.read({"cycles": [], "trace": None,
                        "geometry": None}) is None


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
