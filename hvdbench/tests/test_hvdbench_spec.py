"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
configuration, mix, limits and per-layer readers are found by name."""

import importlib.util
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51


def test_paths_and_command(spec):
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    for word in spec["command"]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in spec["paths"])


def test_names_and_units(spec):
    names = {k: [e["name"] for e in spec[k]]
             for k in ("configs", "workloads", "end_to_end", "per_layer")}
    for group in names.values():
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    metrics = names["end_to_end"] + names["per_layer"]
    assert len(metrics) == len(set(metrics))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in spec["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in spec["per_layer"]:
        assert _line(m["layer"])


def test_entry_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_end_to_end(spec):
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_four_chip_cells(spec):
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)


def _reports(spec, cell):
    return [m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def test_every_cell_reports(spec):
    for w in spec["workloads"]:
        e2e = _reports(spec, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in spec["per_layer"])


def test_per_layer_moves_what_its_cells_report(spec):
    for m in spec["per_layer"]:
        for cell in m.get("workloads", [w["name"]
                                        for w in spec["workloads"]]):
            assert m["moves"] in _reports(spec, cell), (m["name"], cell)


def test_configs_are_used_and_found(spec):
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]


def test_cells_found_by_name(spec):
    from hvdbench import cell, check, run

    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        c = run.load_cell(w["name"])
        assert c["mix"]["ranks"] == w["chips"]
        cell.family(c["config"])
        cell.ref_family(c["config"])
        assert c["limits"] and set(c["limits"]) <= set(check.NUMBERS)


def test_readers_found_by_name(spec):
    for m in spec["per_layer"]:
        path = os.path.join(ROOT, "hvdbench", "metrics", f"{m['name']}.py")
        s = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        assert callable(mod.read)
