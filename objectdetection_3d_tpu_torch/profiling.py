"""Tracing and profiling helpers.

* :func:`span`: a named ``torch.profiler.record_function`` range, entered
  only while a profiler records; :func:`count` and :func:`counters`, the
  in-memory counters with the same gate.
* :func:`span_device_ms`, :func:`span_idle_ms`, :func:`span_host_ms`,
  :func:`span_count`, :func:`device_busy_ms`: what a ``torch.profiler``
  Chrome trace says of the spans (``profile_predict`` prints them).
* :class:`StepTimer`: wall-clock step statistics of the training loop,
  logged every ``log_every`` steps.
* :func:`trace`: a ``torch.profiler`` run written as a Chrome trace into
  a directory (``chrome://tracing`` or ui.perfetto.dev read it).
* :class:`TensorBoardLogger`: optional TensorBoard scalars.

The program's spans and counters, each where its work happens:

* ``predict``: ``PointPillars.predict``, one per call;
* ``predict.voxelize``: the upload and the voxelizer;
* ``predict.pfn_grid``: the PFN and the grid build;
* ``predict.encoder``: the vertical encoder, and inside it
  ``encoder.norm``: each mask multiply, masked BN, ReLU and mask pooling
  after a conv of a stage that K8 does not run whole;
* counter ``encoder.norm_fused``: those norms that ran as one pass (K11,
  eval mode), 10 a flagship predict under the default knobs;
* ``predict.rpn_head``: the sparse RPN (or the backbone and neck), then
  the head;
* ``predict.decode_nms``: decode, NMS and the output top-k, and inside it
  ``predict.nms``, each item's ``multiclass_nms``;
* counter ``nms.rounds``: evaluations of the NMS fixpoint's condition; in
  eager mode each is one host read of a device flag;
* ``plot``: ``TiledInference.__call__``, one per scene, and inside it
  ``plot.sort`` (the upload and the sort of the scene), ``plot.crop``
  (each chunk's crop), the tiles' ``predict`` and ``plot.merge`` (the
  packed readback, the shift and the global merge);
* ``forward``, ``assignment``, ``loss+backward``, ``optimizer``: the
  train step's phases, which ``profile_train`` reads.

The network's spans also mark the forward of a train step and of an eval.
Spans nest on the calling thread, so a call's outermost span is its
identifier in a trace of one caller.
"""

import bisect
import collections
import contextlib
import logging
import os
import time

import torch

log = logging.getLogger(__name__)

_NULL = contextlib.nullcontext()
_COUNTS = collections.Counter()


def span(name):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records; otherwise a null context, so an untraced call, a
    ``torch.export`` trace and training pay one flag check."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        _COUNTS[name] += n


def counters():
    """{name: count} since the last call; the counts start afresh."""
    out = dict(_COUNTS)
    _COUNTS.clear()
    return out


# ---- reading a trace ---------------------------------------------------
# a torch.profiler Chrome trace (a dict): the spans are its
# "user_annotation" events, the device work its kernels, copies and fills,
# each tied by its correlation id to the runtime call that launched it
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union(pairs):
    """Disjoint, sorted [start, end] runs covering ``pairs``."""
    out = []
    for s, e in sorted(pairs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _holds(runs, t):
    i = bisect.bisect_right(runs, [t, float("inf")]) - 1
    return i >= 0 and t <= runs[i][1]


def _spans(trace, names=None):
    if isinstance(names, str):
        names = (names,)
    return [e for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"
            and (names is None or e.get("name") in names)]


def _busy_runs(trace):
    return _union((e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                  if e.get("cat") in _DEVICE_CATS and "dur" in e)


def _span_runs(trace, names):
    """The host intervals (trace microseconds) of the spans named in
    ``names`` (a name or a tuple of names), merged into disjoint sorted
    runs."""
    return _union((e["ts"], e["ts"] + e["dur"]) for e in _spans(trace, names))


def span_count(trace, name):
    """The number of spans named ``name``."""
    return len(_spans(trace, name))


def span_host_ms(trace, name):
    """Host ms of the spans named ``name``, summed."""
    return sum(e["dur"] for e in _spans(trace, name)) / 1e3


def device_busy_ms(trace):
    """Ms in which a kernel, copy or fill ran: the union of their
    intervals."""
    return sum(e - s for s, e in _busy_runs(trace)) / 1e3


def span_device_ms(trace, names):
    """Device ms of every kernel, copy and fill whose launching runtime
    call, from any thread, lies inside a span named in ``names``, its child
    spans included."""
    inside = _span_runs(trace, names)
    launched = {e["args"]["correlation"]: e["ts"]
                for e in trace["traceEvents"]
                if e.get("cat") in _LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    total = 0.0
    for e in trace["traceEvents"]:
        if e.get("cat") in _DEVICE_CATS and "dur" in e:
            ts = launched.get(e.get("args", {}).get("correlation"))
            if ts is not None and _holds(inside, ts):
                total += e["dur"]
    return total / 1e3


def span_idle_ms(trace, names, outside=()):
    """Device idle ms whose gap's midpoint lies inside a span named in
    ``names`` and outside every span named in ``outside``.  The gaps are
    those between the device's busy runs, and before the first and after
    the last as far as the trace's spans reach."""
    marks = _spans(trace)
    if not marks:
        return 0.0
    inside = _span_runs(trace, names)
    holes = _span_runs(trace, outside)
    edges = ([min(e["ts"] for e in marks)]
             + [t for run in _busy_runs(trace) for t in run]
             + [max(e["ts"] + e["dur"] for e in marks)])
    total = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        mid = (a + b) / 2
        if b > a and _holds(inside, mid) and not _holds(holes, mid):
            total += b - a
    return total / 1e3


class StepTimer:
    """Rolling step-time statistics, logged every ``log_every`` steps.

    Call :meth:`step` once the step's results are on the host, so that
    each logged rate ends at a finished step."""

    def __init__(self, log_every=50, name="train"):
        self.log_every = int(log_every)
        self.name = name
        self.reset()

    def reset(self):
        self._count = 0
        self._window_start = time.perf_counter()
        self.last_rate = None

    def step(self):
        """Record one step; returns steps/sec when a window closes."""
        self._count += 1
        if self._count % self.log_every == 0:
            now = time.perf_counter()
            rate = self.log_every / (now - self._window_start)
            self._window_start = now
            self.last_rate = rate
            log.info("%s: %.2f steps/s (%.1f ms/step)", self.name, rate,
                     1000.0 / rate)
            return rate
        return None


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Profile the body with ``torch.profiler`` (CPU, and CUDA where
    available) and write a Chrome trace ``trace_<ns>.json`` into
    ``log_dir``."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(str(log_dir), f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


class TensorBoardLogger:
    """Optional TensorBoard scalar stream next to the csv/yaml artifacts.

    Disabled (all no-ops) unless ``enabled`` and ``torch.utils.tensorboard``
    imports cleanly; a failed import logs a warning and never raises.
    """

    def __init__(self, enabled, log_dir):
        self._w = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(os.path.join(str(log_dir), "tb"))
            log.info("TensorBoard scalars in %s/tb", log_dir)
        except Exception as e:  # noqa: BLE001 (optional dependency)
            log.warning("tensorboard requested but unavailable (%s); "
                        "scalar stream disabled", e)

    def scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def scalars(self, prefix, values, step):
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def close(self):
        if self._w is not None:
            self._w.flush()
            self._w.close()
            self._w = None
