"""BENCHMARK.json against the contract's shape, and every name in it leading
to its file: each configuration's, each cell's traffic and driver, each
per-layer metric's reader."""

import json
import os
import re

import pytest

from conftest import ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = load("BENCHMARK.json")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "-m", "benchmark.run"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_entries_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names))
        for e in MAN[section]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_report_what_the_contract_asks():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    configs = {c["name"] for c in MAN["configs"]}
    used = set()
    for w in MAN["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        used.add(w["config"])
        mine = [m for m in MAN["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layer = [m for m in MAN["per_layer"] if w["name"] in m["workloads"]]
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in mine}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_layers_are_named_alike():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["source"])
    assert len(by_layer) >= 4


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    from benchmark.core import manifest as mf
    man = mf.Manifest(ROOT)
    config = man.config(w["config"])
    traffic = mf.traffic(w["traffic"])
    driver = mf.driver(traffic["driver"])
    for fn in ("setup", "window", "end_to_end", "traced", "judge"):
        assert callable(getattr(driver, fn))
    assert "limits" in traffic
    assert man.per_layer(w["name"])
    assert config["source"].startswith("https://")


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_each_metric_finds_its_reader(m):
    from benchmark.core import manifest as mf
    assert callable(mf.reader(m["name"]))


def test_config_files_state_their_cuts():
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/")
        body = load(c["file"])
        assert body["reduced"] == c["reduced"]
        assert "precision" in body
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not (k.endswith("_dim") or k.endswith("_rank"))


def test_harness_core_names_no_cell_or_metric():
    names = [w["name"] for w in MAN["workloads"]] \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]
           if m["name"] != "setup_s"] \
        + [c["name"] for c in MAN["configs"]] \
        + [w["traffic"] for w in MAN["workloads"]]
    core = os.path.join(ROOT, "benchmark", "core")
    files = [os.path.join(core, f) for f in os.listdir(core)
             if f.endswith(".py")] + [os.path.join(ROOT, "benchmark",
                                                   "run.py")]
    for path in files:
        with open(path) as f:
            text = f.read()
        for n in names:
            assert n not in text, (path, n)


def test_file_names_are_names():
    bench = os.path.join(ROOT, "benchmark")
    ok = re.compile(r"^[A-Za-z0-9_/.-]+$")
    for dirpath, dirnames, files in os.walk(bench):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert ok.match(rel) and len(rel) <= 200, rel


def test_manifest_is_json_with_no_tabs():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    json.loads(text)
    assert "\t" not in text
