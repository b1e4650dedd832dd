"""Tracing and profiling helpers of the training loop.

* :class:`StepTimer`: wall-clock step statistics, logged every
  ``log_every`` steps.
* :func:`trace`: a ``torch.profiler`` run written as a Chrome trace into
  a directory (``chrome://tracing`` or ui.perfetto.dev read it).
* :func:`device_memory_stats`: ``torch.cuda.memory_stats`` of a device.
* :func:`annotate`: a named profiler range (``record_function``).
* :class:`TensorBoardLogger`: optional TensorBoard scalars.
"""

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger(__name__)


class StepTimer:
    """Rolling step-time statistics, logged every ``log_every`` steps."""

    def __init__(self, log_every=50, name="train"):
        self.log_every = int(log_every)
        self.name = name
        self.reset()

    def reset(self):
        self._count = 0
        self._window_start = time.time()
        self.last_rate = None

    def step(self):
        """Record one step; returns steps/sec when a window closes."""
        self._count += 1
        if self._count % self.log_every == 0:
            now = time.time()
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


def device_memory_stats(device=None):
    """``torch.cuda.memory_stats`` of ``device`` as a dict ({} for the
    CPU or without CUDA)."""
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))


def annotate(name):
    """Named profiler range for host-side phases."""
    return torch.profiler.record_function(name)


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
