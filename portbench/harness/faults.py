"""Faults planted under the program's timed path, to show that the output
check refuses them (``portbench/tests/test_portbench_faults.py`` on the
CPU; ``calibrate.py --fault`` on the card, where the readings set the
limits' upper ends).  Each is a context manager that patches the port
and restores it."""

import contextlib


@contextlib.contextmanager
def altered_answer():
    """predict moves its best detection of each cloud by one metre in x
    (tiled inference's predicts too)."""
    from objectdetection_3d_tpu_torch.models import detector

    real = detector.PointPillars.predict

    def predict(self, batch, anchors=None):
        out = dict(real(self, batch, anchors))
        out["bbox"] = out["bbox"].clone()
        out["bbox"][:, 0, 0] += 1.0
        return out

    detector.PointPillars.predict = predict
    try:
        yield
    finally:
        detector.PointPillars.predict = real


@contextlib.contextmanager
def dropped_detections():
    """predict keeps only the first half of each cloud's valid detections
    (tiled inference's predicts too); what it keeps is unchanged."""
    from objectdetection_3d_tpu_torch.models import detector

    real = detector.PointPillars.predict

    def predict(self, batch, anchors=None):
        out = dict(real(self, batch, anchors))
        valid = out["valid"]
        half = (valid.sum(-1, keepdim=True) + 1) // 2
        out["valid"] = valid & (valid.cumsum(-1) <= half)
        return out

    detector.PointPillars.predict = predict
    try:
        yield
    finally:
        detector.PointPillars.predict = real


@contextlib.contextmanager
def altered_loss():
    """The train step reports its classification loss 10% high."""
    from objectdetection_3d_tpu_torch.models import detector

    real = detector.PointPillars.make_train_step

    def make(self, tx, microbatch=None, shard=None):
        step = real(self, tx, microbatch, shard)

        def altered(batch):
            out = step(batch)
            out["loss_cls"] = out["loss_cls"] * 1.1
            return out

        return altered

    detector.PointPillars.make_train_step = make
    try:
        yield
    finally:
        detector.PointPillars.make_train_step = real


@contextlib.contextmanager
def unchanged_state():
    """The optimizer's step leaves the parameters and its state as they
    were."""
    from objectdetection_3d_tpu_torch.models import detector

    real = detector.ClippedAdamW.step
    detector.ClippedAdamW.step = lambda self, closure=None: None
    try:
        yield
    finally:
        detector.ClippedAdamW.step = real


@contextlib.contextmanager
def stale_after_warmup(steps=3):
    """The optimizer's steps after its first ``steps`` leave the
    parameters and its state as they were: a fault of the steady state
    alone, which the first steps cannot show."""
    from objectdetection_3d_tpu_torch.models import detector

    real = detector.ClippedAdamW.step

    def step(self, closure=None):
        self._steps_taken = getattr(self, "_steps_taken", 0) + 1
        if self._steps_taken <= steps:
            return real(self, closure)
        return None

    detector.ClippedAdamW.step = step
    try:
        yield
    finally:
        detector.ClippedAdamW.step = real


FAULTS = {"altered_answer": altered_answer,
          "dropped_detections": dropped_detections,
          "altered_loss": altered_loss, "unchanged_state": unchanged_state,
          "stale_after_warmup": stale_after_warmup}
