"""BENCHMARK.json against the contract's forms, and every cell's files
found by name."""

import os
import re

import pytest

from benchmark.lib import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
M = common.manifest()


def _names():
    out = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [e["name"] for e in M[key]]
    out += [w["config"] for w in M["workloads"]]
    out += [w["traffic"] for w in M["workloads"]]
    out += [k for c in M["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_forms(metric):
    assert UNIT.match(metric["unit"]) and len(metric["unit"]) <= 16
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
        allowed.add("bound")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        allowed |= {"layer", "moves"}
        assert metric["moves"] in [m["name"] for m in M["end_to_end"]]
        assert 1 <= len(metric["layer"]) <= 200
    assert set(metric) <= allowed
    cells = {w["name"] for w in M["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_top_level_forms():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    assert len(M["command"]) <= 32
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert "setup_s" in [m["name"] for m in M["end_to_end"]]
    setup = next(m for m in M["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_its_files(w):
    cell = common.cell(w["name"])
    assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
    assert os.path.exists(os.path.join(common.BENCH_DIR, "entries",
                                       f"{cell['entry']}.py"))
    assert os.path.exists(os.path.join(common.BENCH_DIR, "counts",
                                       f"{w['config']}.py"))
    e2e = [m for m in M["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    layer = [m for m in M["per_layer"]
             if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert os.path.exists(os.path.join(common.BENCH_DIR, "metrics",
                                           f"{m['name']}.py")), m["name"]
    assert cell["limits"], "a cell without limits can never read correct"
    assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    path = os.path.join(common.ROOT, c["file"])
    assert c["file"].startswith(M["paths"][0] + "/") and os.path.exists(path)
    cfg = common.read_json("configs", f"{c['name']}.json")
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in M["workloads"])
