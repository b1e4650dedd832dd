"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a
bounded number of calls, and what the benchmark reads from its trace.

The trace is written to ``TMPDIR``, read back and deleted; only the
reductions below leave this module.
"""

import json
import os
import tempfile
import time

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
# entries of each breakdown list
TOP = 10


def profiled(call, n_calls):
    """Run ``call(i)`` for i < ``n_calls`` under ``torch.profiler`` (CPU
    and CUDA activity).  Returns (the Chrome trace as a dict, the host
    seconds from the first call to the device's end of the last)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_calls):
            call(i)
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return trace, window


def device_events(trace):
    return [e for e in trace["traceEvents"]
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def union(intervals):
    """Disjoint, sorted (start, end) runs covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(trace):
    """Seconds in which a kernel, copy or fill ran on the device: the
    length of the union of their intervals."""
    runs = union((e["ts"], e["ts"] + e["dur"]) for e in device_events(trace))
    return sum(e - s for s, e in runs) / 1e6


def top_device_ops(trace):
    """The ``TOP`` device operations by summed seconds: [[name, s]]."""
    sums = {}
    for e in device_events(trace):
        sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"] / 1e6
    return [[name[:160], s] for name, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(trace):
    """The ``TOP`` host activities by the device idle time they span:
    each gap between device work is named by the innermost host operation
    of the launching thread that holds the gap's midpoint ("host idle"
    where none does).  Returns [[name, s]]."""
    events = trace["traceEvents"]
    runs = union((e["ts"], e["ts"] + e["dur"]) for e in device_events(trace))
    launch_tids = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            launch_tids[e.get("tid")] = launch_tids.get(e.get("tid"), 0) + 1
    tid = max(launch_tids, key=launch_tids.get) if launch_tids else None
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("tid") == tid
            and "dur" in e]
    starts = np.asarray([h[0] for h in host], np.float64)
    ends = np.asarray([h[1] for h in host], np.float64)
    gaps = [(a, b) for (_, a), (b, _) in zip(runs, runs[1:])]
    sums = {}
    for lo in range(0, len(gaps), 256):
        chunk = gaps[lo:lo + 256]
        mid = np.asarray([(a + b) / 2 for a, b in chunk])[:, None]
        inside = (starts[None] <= mid) & (ends[None] >= mid)
        width = np.where(inside, (ends - starts)[None], np.inf)
        best = width.argmin(axis=1) if len(host) else None
        for row, (a, b) in enumerate(chunk):
            name = ("host idle" if best is None
                    or not np.isfinite(width[row, best[row]])
                    else host[best[row]][2])
            sums[name] = sums.get(name, 0.0) + (b - a) / 1e6
    return [[name[:160], s] for name, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def phase_device_ms(trace, phases):
    """{phase: device ms} over the trace, each kernel, copy and fill
    charged to the innermost of the ``phases`` ranges (``record_function``
    names) whose host interval holds the runtime call that launched it,
    from any thread (autograd launches the backward from a thread of its
    own).  Work launched outside every range goes to ``other``.  The rule
    of the port's ``profile_train._charged``, copied."""
    events = trace["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in phases)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    out = dict.fromkeys((*phases, "other"), 0.0)
    for e in device_events(trace):
        ts = launched.get(e.get("args", {}).get("correlation"))
        name = "other"
        if ts is not None:
            for start, end, phase in ranges:
                if start > ts:
                    break
                if ts <= end:
                    name = phase
        out[name] += e["dur"] / 1e3
    return out


class Record:
    """What the per-layer readers (``portbench/metrics/<name>.py``) read:

    * ``kind``: the traffic's kind (``predict``, ``train``, ``plot``);
    * ``model``: the configuration's model dict;
    * ``flops``: forward FLOPs of one cloud by stage, ``encoder_bytes``
      the encoder's least bytes: the architecture's ``forward_flops`` and
      ``encoder_bytes``, or the mean of its ``call_work`` over the
      profiled calls' clouds where it has one;
    * ``calls``: the calls in the profiled window, ``clouds_per_call`` the
      clouds each forwarded (a plot's tiles);
    * ``window_s``, ``busy_s``: the profiled window's host seconds and the
      seconds the device was busy in it;
    * ``stages``: {name: [ms per call]} from CUDA events over the measured
      window (per-call stage spans; ``outside_predict`` in ms per plot);
    * ``phases``: {phase: device ms summed over the profiled calls};
    * ``breakdown``: the result line's ``breakdown``.
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


def record(kind, model, flops_by_stage, encoder_bytes, trace, window_s,
           calls, clouds_per_call, stages, phases=()):
    return Record(
        kind=kind, model=model, flops=flops_by_stage,
        encoder_bytes=encoder_bytes, calls=calls,
        clouds_per_call=clouds_per_call, window_s=window_s,
        busy_s=busy_seconds(trace), stages=stages,
        phases=phase_device_ms(trace, phases) if phases else {},
        breakdown={"device_ops": top_device_ops(trace),
                   "idle_gaps": idle_gaps(trace)})
