"""BENCHMARK.json against the contract's form, and every cell,
configuration, driver and per-layer metric found by name."""

import json
import math
import re

import pytest

from portbench.harness import HERE, layers_for, load_json, load_module

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
        assert "\n" not in entry["why"] and "\t" not in entry["why"]
    assert len(set(c["name"] for c in BENCH["configs"])) == len(
        BENCH["configs"])
    assert len(set(w["name"] for w in BENCH["workloads"])) == len(
        BENCH["workloads"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        reported = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reported & cells
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
        assert any(w in m.get("workloads", cells) for m in BENCH["end_to_end"]
                   if m["name"] != "setup_s")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    traffic = load_json("traffic", w["traffic"])
    assert traffic["name"] == cell and traffic["config"] == w["config"]
    assert traffic["chips"] == w["chips"]
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cfg_entry["file"] == f"portbench/configs/{w['config']}.json"
    config = load_json("configs", w["config"])
    assert config["name"] == w["config"]
    assert config["reduced"] == cfg_entry["reduced"]
    driver = load_module("drivers", traffic["driver"])
    assert callable(driver.make) and callable(driver.bound_inputs)
    limits = traffic["limits"]
    assert set(limits) == set(driver.NAMES)
    assert all(isinstance(v, float) and math.isfinite(v) and v >= 0
               for v in limits.values())
    metrics = {m["name"] for m in BENCH["per_layer"]
               if cell in m["workloads"]}
    assert {m.NAME for m in layers_for(cell)} == metrics


@pytest.mark.parametrize("path", sorted((HERE / "layers").glob("*.py")),
                         ids=lambda p: p.stem)
def test_layer_files_match_benchmark(path):
    mod = load_module("layers", path.stem)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == path.stem)
    assert mod.NAME == entry["name"] and mod.UNIT == entry["unit"]
    assert mod.MOVES == entry["moves"] and mod.LAYER == entry["layer"]
    assert tuple(mod.WORKLOADS) == tuple(entry["workloads"])
    assert callable(mod.read)
