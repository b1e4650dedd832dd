"""Device ms a cloud of the vertical encoder (CUDA events at its forward
pre-hook and hook), the median over the measured window's clouds."""

from portbench.harness import readers

UNIT = "ms"
LAYER = "predict: vertical encoder"
MOVES = "clouds_per_s"


def read(rec):
    return readers.stage_median(rec, "encoder")
