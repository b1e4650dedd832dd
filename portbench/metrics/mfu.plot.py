"""The counted forward FLOPs of a tile times the tiles predicted in the
profiled plots, over the profiled window's seconds at the card's bf16
peak."""

from portbench.harness import readers

UNIT = "%"
LAYER = "tiled inference"
MOVES = "plot_mpts_per_s"


def read(rec):
    return readers.mfu_percent(rec, "plot")
