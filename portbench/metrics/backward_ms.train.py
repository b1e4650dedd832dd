"""Device ms a step charged to the step's ``loss+backward`` range (the
backward with the remat recompute; the assignment inside it is charged
to its own range)."""

from portbench.harness import readers

UNIT = "ms"
LAYER = "train step: loss and backward"
MOVES = "train_clouds_per_s"


def read(rec):
    return readers.phase_ms(rec, "loss+backward")
