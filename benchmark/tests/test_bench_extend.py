"""A later change adds a cell, a configuration or a metric by adding files:
the harness finds them by name."""

import json
import os
import time

import torch

from benchmark import run
from benchmark.lib import common
from benchmark.tests import tiny


def test_a_new_cell_file_is_found_by_name(tmp_path):
    name = "zz_throwaway_cell"
    path = os.path.join(common.BENCH_DIR, "workloads", f"{name}.json")
    src = common.read_json("workloads", "e2e_serve_ci.json")
    src["traffic"]["kinds"] = [{"share": 1.0, "range": [16, 16]}]
    with open(path, "w") as f:
        json.dump(src, f)
    try:
        cell = common.cell(name)
        assert cell["entry"] == "serve" and cell["model"]["kind"] == "e2e"
        t = tiny.cell("e2e_serve_ci")
        t["name"], t["traffic"]["kinds"] = name, [{"share": 1.0,
                                                   "range": [4, 4]}]
        manifest = common.manifest()
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "e2e_serve_ci" in m.get("workloads", []):
                m["workloads"].append(name)
        result, _, _ = run.measure(t, manifest, 5, 1.0, False,
                                   torch.device("cpu"), time.perf_counter())
        assert result["correct"]
        got = set(result["metrics"])
        assert {"serve_functions_per_s", "setup_s"} <= got <= {
            "serve_functions_per_s", "serve_request_p95_ms", "setup_s"}
    finally:
        os.remove(path)


def test_metric_readers_are_found_by_name():
    manifest = common.manifest()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        mod = common.load_module(os.path.join(common.BENCH_DIR, "metrics",
                                              f"{m['name']}.py"))
        assert callable(mod.read)


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = {"raw": {"kind": "serve", "trace": None, "window_s": 1.0},
           "work": {"flops": 0.0}, "traced_work": None, "notes": []}
    for name in ("attn_roofline.serve", "mlp_roofline.serve",
                 "device_idle_share.serve", "mfu.train",
                 "host_step_ms.train"):
        mod = common.load_module(os.path.join(common.BENCH_DIR, "metrics",
                                              f"{name}.py"))
        assert mod.read(ctx) is None, name
