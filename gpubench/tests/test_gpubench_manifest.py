"""BENCHMARK.json against the rules it is checked by, and the files it names."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|ffn|head|expansion|d_model)"
                   r"|(_dim|_rank)$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51 and int(manifest["run_seconds"]) == \
        manifest["run_seconds"]
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_per_layer_metric_reports_with_its_moved_metric(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)), m["name"]
        assert m["layer"] and "\n" not in m["layer"]
    for cell in cells:
        reported = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m["workloads"] for m in manifest["per_layer"])


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        if m["name"] == "setup_s":
            assert m["bound"] <= 0.25


def test_files_and_names_exist(manifest):
    bench = os.path.join(ROOT, "gpubench")
    assert manifest["paths"] == ["gpubench"]
    for c in manifest["configs"]:
        assert c["file"].startswith("gpubench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert os.path.exists(os.path.join(bench, "reference", cfg["reference"] + ".py"))
    for w in manifest["workloads"]:
        with open(os.path.join(bench, "workloads", w["name"] + ".json")) as f:
            cell = json.load(f)
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert cell["limits"]
        with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert os.path.exists(os.path.join(bench, "loops", mix["loop"] + ".py"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics", m["name"] + ".py")), m["name"]


def test_check_fits_the_budget(manifest):
    """A full check of 24 cells at this run length fits the loop's time."""
    s = manifest["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
