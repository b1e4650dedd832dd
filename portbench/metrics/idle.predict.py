"""Share of the profiled predicts' window in which the device ran no
kernel, copy or fill."""

from portbench.harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "clouds_per_s"


def read(rec):
    return readers.idle_percent(rec, "predict")
