"""``BENCHMARK.json`` against the benchmark's contract, its entries against
their files, and a whole run on the CPU of cells, a configuration, a
traffic mix and a per-layer metric that exist only as new files and new
entries (no file of the harness edited)."""

import importlib.util
import json
import os
import re
import time
import types

import pytest

from conftest import (REPO, bench_with_unlisted, make_root, tiny_fpn_model,
                      tiny_model)
from portbench.harness import main

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
# with the cells held back from it, whose files must stay whole too
ALL = bench_with_unlisted()


def _metric_module(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cells_and_configs():
    confs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in confs
        assert os.path.exists(os.path.join(
            REPO, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            REPO, "portbench", "limits", w["name"] + ".json"))
    for c in confs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["listed", "all"])
def test_metrics_have_readers(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        mod = _metric_module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["unit"], m["layer"], m["moves"])
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    for w in cells:
        assert any(w in m["workloads"] for m in bench["per_layer"])
        assert any(m["name"] != "setup_s" and w in m.get("workloads", [w])
                   for m in bench["end_to_end"])


def _args(workload, trace):
    return types.SimpleNamespace(workload=workload, seed=2 ** 33 + 17,
                                 seconds=0.3, trace=trace)


def test_new_cell_config_traffic_and_metric_as_files(tmp_path):
    """A configuration (``tinyfpn``), a traffic mix and a per-layer metric
    added as files and entries alone run through the harness."""
    extra = {"name": "pfn_share.predict", "unit": "%", "better": "lower",
             "source": "device_trace", "layer": "predict",
             "moves": "clouds_per_s", "workloads": ["tinyfpn.predict"]}
    root = make_root(tmp_path, {"tiny.predict": (tiny_model(), "predict"),
                                "tinyfpn.predict": (tiny_fpn_model(),
                                                    "predict"),
                                "tiny.train": (tiny_model(), "train")},
                     extra_metrics=[extra])
    with open(os.path.join(root, "portbench", "metrics",
                           "pfn_share.predict.py"), "w") as f:
        f.write("UNIT = '%'\nLAYER = 'predict'\nMOVES = 'clouds_per_s'\n\n\n"
                "def read(rec):\n"
                "    return 100.0 * rec.flops['pfn'] / rec.flops['total']\n")
    for cell in ("tiny.predict", "tinyfpn.predict", "tiny.train"):
        out = main.run(_args(cell, 0), root, time.perf_counter(), "cpu")
        assert out["correct"], out
        assert list(out) == ["correct", "attempted", "failed", "metrics",
                             "device", "compared"]
        assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    out = main.run(_args("tinyfpn.predict", 1), root, time.perf_counter(),
                   "cpu")
    assert out["correct"] and "pfn_share.predict" in out["metrics"]
    assert list(out)[-1] == "compared"
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", [w["name"] for w in ALL["workloads"]])
def test_limits_are_set(workload):
    with open(os.path.join(REPO, "portbench", "limits",
                           workload + ".json")) as f:
        lim = json.load(f)["limits"]
    assert lim and all(v > 0 for v in lim.values())
