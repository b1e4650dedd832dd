"""Device ms a cloud from the head's end to the end of predict (decode, the
NMS rounds with their host syncs, the output's top-k), the median over
the measured window's clouds; it follows the detection count."""

from portbench.harness import readers

UNIT = "ms"
LAYER = "predict: decode and NMS"
MOVES = "predict_p95_ms"


def read(rec):
    return readers.stage_median(rec, "decode_nms")
