"""Arithmetic shared by the per-layer metric readers
(``portbench/metrics/<name>.py``).  Each returns None where the record
holds nothing to read, and the harness then leaves the metric out."""

import numpy as np

from portbench.harness.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def stage_median(rec, stage):
    """Median ms of one stage span over the measured window's calls."""
    vals = rec.stages.get(stage)
    return float(np.median(vals)) if vals else None


def idle_percent(rec, kind):
    """Share of the profiled window in which no kernel, copy or fill ran
    on the device."""
    if rec.kind != kind or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)


def mfu_percent(rec, kind, passes=1):
    """Counted forward FLOPs (``passes`` times: 3 for a train step) of the
    clouds in the profiled window over the window's seconds at the card's
    bf16 peak."""
    if rec.kind != kind or not rec.clouds_per_call:
        return None
    work = passes * rec.flops["total"] * rec.calls * rec.clouds_per_call
    return 100.0 * work / (rec.window_s * PEAK_BF16_FLOPS)


def phase_ms(rec, phase):
    """Device ms a call charged to one of the train step's ranges."""
    if phase not in rec.phases or not rec.calls:
        return None
    return rec.phases[phase] / rec.calls


def roofline_percent(least_s, measured_ms):
    if measured_ms is None or measured_ms <= 0:
        return None
    return 100.0 * least_s * 1e3 / measured_ms


def least_seconds(flops_count, bytes_count):
    """The least time: the larger of the operations over the bf16 peak and
    the bytes over the HBM bandwidth."""
    return max(flops_count / PEAK_BF16_FLOPS, bytes_count / PEAK_HBM_BYTES)
