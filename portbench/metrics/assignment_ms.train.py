"""Device ms a step charged to the step's ``assignment`` range: each
kernel, copy and fill to the innermost range whose host interval holds
the runtime call that launched it."""

from portbench.harness import readers

UNIT = "ms"
LAYER = "train step: assignment"
MOVES = "train_clouds_per_s"


def read(rec):
    return readers.phase_ms(rec, "assignment")
