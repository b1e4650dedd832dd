"""A plot's host wall ms less the device ms between the CUDA events that
the benchmark's predict wrapper records around each tile's predict: the
tiled call's own sort, crop, merge and readback, and the gaps between
predicts; the median over the measured window's plots."""

from portbench.harness import readers

UNIT = "ms"
LAYER = "tiled inference: sort, crop, merge, readback"
MOVES = "plot_mpts_per_s"


def read(rec):
    return readers.stage_median(rec, "outside_predict")
