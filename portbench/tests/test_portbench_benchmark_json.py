"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and that every name finds its file."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(bench["command"]) <= 32 and all(_line(w)
                                               for w in bench["command"])
    assert bench["command"][1].startswith(bench["paths"][0] + "/")
    assert isinstance(bench["run_seconds"], int) and \
        1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and \
            len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and PATH.match(c["file"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m["name"] for m in bench["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per


def test_every_name_finds_its_file(bench):
    pb = os.path.join(ROOT, "portbench")
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert os.path.exists(os.path.join(pb, "models", cfg["kind"] + ".py"))
        assert _line(cfg["source"]) and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and cfg["limits"]
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(pb, "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["end_to_end"]:
        assert os.path.exists(os.path.join(pb, "e2e", m["name"] + ".py"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(pb, "metrics", m["name"] + ".py"))
    for dirpath, _, files in os.walk(pb):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            if "__pycache__" not in rel:
                assert PATH.match(rel), rel
