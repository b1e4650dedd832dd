"""Card tests of the benchmark (``python3 -m pytest portbench/tests -m
cuda`` on the card machine; they skip elsewhere): each cell once at a
short window with ``--trace 0`` and ``--trace 1``, the result line's keys
and metrics; and the control of ``correct`` at each cell's own size,
which the cell's limits must refuse."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _declared(cell, trace):
    group = BENCH["per_layer"] if trace else BENCH["end_to_end"]
    return {m["name"] for m in group
            if cell in m.get("workloads", [cell])}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_result_line(cuda, cell, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 32 + 7 + trace), "--seconds", "3", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expect = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(out) == expect
    assert out["correct"] is True, proc.stderr[-4000:]
    assert set(out["metrics"]) == _declared(cell, trace)
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cuda, cell):
    """The control, the reference computed in float8, put in the
    program's place, reads beyond the cell's limits."""
    from portbench.harness import calibrate, cells, main

    _, conf, traffic = main.cell_spec(BENCH, REPO, cell)
    driver = cells.make(traffic["kind"], conf, traffic, 2 ** 31 + 99, REPO)
    driver.setup()
    driver.window(1.0)
    driver.free()
    nums, _ = calibrate._numbers(driver, traffic["kind"], driver.arch.fp8)
    correct, compared = main.judge(REPO, cell, nums)
    assert not correct, compared
