"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds it by."""

import json
import os
import re

import pytest

from portbench.harness.manifest import BENCH_DIR, ROOT, cell_spec, load_manifest, metric_reader, scene_json
from portbench.harness.traffic import load_driver

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = load_manifest()
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert M["paths"] == ["portbench"] and M["command"] == ["python3", "portbench/run.py"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_and_keys(entry):
    assert NAME.match(entry["name"])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len({e["name"] for e in M["configs"] + M["workloads"] + METRICS}) == \
        len(M["configs"]) + len(M["workloads"]) + len(METRICS)


def test_every_configuration_has_a_cell_and_pairs_are_unique():
    assert {c["name"] for c in M["configs"]} == {w["config"] for w in M["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_setup_s_is_reported_by_every_cell_with_another_end_to_end_metric():
    for w in M["workloads"]:
        spec = cell_spec(w["name"], M)
        names = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_layers_are_named_alike():
    for m in M["per_layer"]:
        quantity = m["name"].split(".", 1)[0]
        same = {x["layer"] for x in M["per_layer"] if x["name"].split(".", 1)[0] == quantity}
        assert len(same) == 1
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and quantity.endswith("_roofline")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(metric_reader(metric["name"]).read)


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(cell):
    spec = cell_spec(cell["name"], M)
    assert {"requests", "pixels", "rel_tol", "limit_pct"} <= set(spec["check"])
    assert spec["config"]["name"] == cell["config"]
    assert spec["config"]["reduced"] == spec["config_entry"]["reduced"]
    assert callable(load_driver(spec["traffic"]["driver"]).serve)
    assert spec["traffic"]["renderer"]["mode"] == "PATH"  # the mode the plain reference renders
    assert spec["config"]["scene"]["files"].startswith("portbench/")
    assert os.path.exists(scene_json(spec["config"]))


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _dirs, files in os.walk(BENCH_DIR):
        if "cache" in dirpath.split(os.sep) or "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_manifest_is_json_without_duplicate_keys():
    def no_dupes(pairs):
        keys = [k for k, _ in pairs]
        assert len(keys) == len(set(keys))
        return dict(pairs)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        json.load(f, object_pairs_hook=no_dupes)
