"""The benchmark's driver: reads ``BENCHMARK.json``, builds the cell's
configuration and traffic from their files, runs set-up, the measured
window and the output check, and prints the result line."""

import argparse
import json
import math
import os
import sys
import time

# top-level module names that must not be loaded by the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "objectdetection_3d_tpu")


class Fail(Exception):
    """A run that cannot give a result: the message goes to stderr and the
    process exits with ``code``."""

    def __init__(self, msg, code=2):
        super().__init__(msg)
        self.code = code


def load_bench(root):
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Fail(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        return json.load(f)


def cell_spec(bench, root, name):
    """(workload entry, configuration file as a dict, traffic file as a
    dict) of the cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Fail(f"unknown workload {name!r}; BENCHMARK.json has "
                   f"{sorted(cells)}")
    cell = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, confs[cell["config"]]["file"])) as f:
        conf = json.load(f)
    path = os.path.join(root, "portbench", "traffic",
                        cell["traffic"] + ".json")
    with open(path) as f:
        traffic = json.load(f)
    return cell, conf, traffic


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def judge(root, workload, numbers):
    """(whether every number is within its limit, {name: {"value",
    "limit"}}) against ``portbench/limits/<workload>.json``; a number
    without a limit, or a limit without a number, is not correct."""
    path = os.path.join(root, "portbench", "limits", workload + ".json")
    limits = {}
    if os.path.exists(path):
        with open(path) as f:
            limits = json.load(f)["limits"]
    for name, value in numbers.items():
        if name not in limits:
            print(f"reading {name}: {value!r}", file=sys.stderr)
    compared = {name: {"value": numbers.get(name), "limit": lim}
                for name, lim in limits.items()}
    correct = bool(limits) and all(
        _finite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    return correct, compared


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_device(chips):
    import torch

    if not torch.cuda.is_available():
        raise Fail("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Fail(f"the cell needs {chips} CUDA devices, "
                   f"{torch.cuda.device_count()} present")


def device_info(chips, device):
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(chips),
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


def run(args, root, t_start, device="cuda"):
    """One run of the cell ``args.workload``; ``device`` other than
    ``cuda`` (the tests, on the CPU) skips the look for a card."""
    bench = load_bench(root)
    cell, conf, traffic = cell_spec(bench, root, args.workload)
    if device == "cuda":
        check_device(int(cell["chips"]))
    from portbench.harness import cells, plugins

    driver = cells.make(traffic["kind"], conf, traffic, args.seed, root,
                        device)
    print(f"set-up: imports {time.perf_counter() - t_start:.2f} s",
          file=sys.stderr)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    attempted, failed, e2e = driver.window(float(args.seconds),
                                           traced=bool(args.trace))
    e2e["setup_s"] = setup_s
    out = {"correct": False, "attempted": attempted, "failed": failed}
    metrics = {}
    breakdown = None
    if args.trace:
        record = driver.profile()
        metrics_of = [m for m in bench["per_layer"]
                      if applies(m, args.workload)]
        for m in metrics_of:
            value = plugins.load(root, "metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        breakdown = record.breakdown
    else:
        for m in bench["end_to_end"]:
            if applies(m, args.workload) and m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    info = device_info(int(cell["chips"]), device)
    if args.trace:
        info["busy_s"] = record.busy_s
        info["window_s"] = record.window_s
    # the output check runs once the peak is read: its reference may
    # allocate more than the program did
    correct, compared = judge(root, args.workload, driver.check())
    found = forbidden_modules()
    if found:
        raise Fail(f"the measured process loaded {found}", code=3)
    correct = bool(correct) and failed == 0 and all(
        _finite(m["value"]) for m in metrics.values())
    out.update(correct=correct, metrics=metrics, device=info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return out


def main(argv, root, t_start):
    ap = argparse.ArgumentParser(description="the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run(args, root, t_start)
    except Fail as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    sys.stdout.flush()
    print(json.dumps(out))
    return 0
