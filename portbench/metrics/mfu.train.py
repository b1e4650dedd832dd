"""Three times the counted forward FLOPs a cloud (forward and backward;
the remat recompute is not useful work) times the profiled steps, over
the profiled window's seconds at the card's bf16 peak."""

from portbench.harness import readers

UNIT = "%"
LAYER = "train step"
MOVES = "train_clouds_per_s"


def read(rec):
    return readers.mfu_percent(rec, "train", passes=3)
