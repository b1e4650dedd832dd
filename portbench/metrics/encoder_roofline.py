"""The vertical encoder's share of its roofline on the card: its least
time, the larger of its counted FLOPs over the bf16 peak and its least
bytes (the grid read once, the pseudo-image written once, the weights)
over the HBM bandwidth, over its measured device ms
(``encoder_ms.predict``).  The count comes from the configuration's
shapes, so it reads the same work whatever implements the encoder; at
the flagship's sizes the operations bound it."""

from portbench.harness import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "clouds_per_s"


def read(rec):
    least = readers.least_seconds(rec.flops["encoder"], rec.encoder_bytes)
    return readers.roofline_percent(least,
                                    readers.stage_median(rec, "encoder"))
