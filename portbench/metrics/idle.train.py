"""Share of the profiled steps' window in which the device ran no kernel,
copy or fill."""

from portbench.harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "train_clouds_per_s"


def read(rec):
    return readers.idle_percent(rec, "train")
