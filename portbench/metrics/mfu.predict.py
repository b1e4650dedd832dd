"""The configuration's counted forward FLOPs a cloud times the profiled
clouds, over the profiled window's seconds at the card's bf16 peak."""

from portbench.harness import readers

UNIT = "%"
LAYER = "predict"
MOVES = "clouds_per_s"


def read(rec):
    return readers.mfu_percent(rec, "predict")
