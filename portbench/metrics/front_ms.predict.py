"""Device ms a cloud from the predict call to the vertical encoder's start
(CUDA events at the call and at the encoder's forward pre-hook), the
median over the measured window's clouds."""

from portbench.harness import readers

UNIT = "ms"
LAYER = "predict: voxelize, PFN, grid build"
MOVES = "clouds_per_s"


def read(rec):
    return readers.stage_median(rec, "front")
