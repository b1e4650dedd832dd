"""Each fault that a cell can have, planted under the timed path of a
whole run (on the CPU, at tiny sizes, the look for a card skipped), must
turn ``correct`` false under that cell's own limits: an answer altered
where it is produced (predict, plot, train's losses), detections
dropped (predict, plot), and a step that returns its state unchanged
(train: from the first step, or only after the first steps).  The cells run one cloud on one
card, so no batch is halved and no exchange between cards exists."""

import time
import types

import pytest
import torch

from conftest import make_root, tiny_model
from portbench.harness import faults, main


def _run(tmp_path, cell, kind, limits_of, seed=2 ** 35 + 1):
    root = make_root(tmp_path, {cell: (tiny_model(), kind)},
                     limits={cell: limits_of})
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=0.3,
                                 trace=0)
    return main.run(args, root, time.perf_counter(), "cpu")


def _limits(name):
    import json
    import os

    from conftest import REPO

    with open(os.path.join(REPO, "portbench", "limits",
                           name + ".json")) as f:
        return json.load(f)["limits"]


PREDICT_CELLS = ["flagship.predict", "fpn.predict"]


@pytest.mark.parametrize("cell", PREDICT_CELLS)
def test_sound_predict_passes(tmp_path, cell):
    assert _run(tmp_path, "t.predict", "predict", _limits(cell))["correct"]


@pytest.mark.parametrize("cell", PREDICT_CELLS)
def test_altered_answer_fails_predict(tmp_path, cell):
    with faults.altered_answer():
        out = _run(tmp_path, "t.predict", "predict", _limits(cell))
    assert not out["correct"]


@pytest.mark.parametrize("cell", PREDICT_CELLS)
def test_dropped_detections_fail_predict(tmp_path, cell):
    """Half the detections dropped, the rest exact: only the count
    refuses it."""
    with faults.dropped_detections():
        out = _run(tmp_path, "t.predict", "predict", _limits(cell))
    assert not out["correct"]
    assert out["compared"]["count_gap"]["value"] > _limits(cell)["count_gap"]
    assert out["compared"]["box_gap"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["altered_answer", "dropped_detections"])
def test_fault_fails_plot(tmp_path, fault):
    with faults.FAULTS[fault]():
        out = _run(tmp_path, "t.plot", "plot", _limits("flagship.plot"))
    assert not out["correct"]


def test_sound_plot_passes(tmp_path):
    assert _run(tmp_path, "t.plot", "plot",
                _limits("flagship.plot"))["correct"]


def test_sound_train_passes(tmp_path):
    assert _run(tmp_path, "t.train", "train",
                _limits("flagship.train"))["correct"]


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_loss",
                                   "stale_after_warmup"])
def test_fault_fails_train(tmp_path, fault):
    with faults.FAULTS[fault]():
        out = _run(tmp_path, "t.train", "train", _limits("flagship.train"))
    assert not out["correct"]


def test_fp8_state_is_the_controls(tmp_path):
    """The control's rounding is real: fp8 moves a float32 tensor by more
    than bfloat16 does."""
    from portbench.reference.model import fp8

    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    assert (fp8(x) - x).abs().max() > 4 * (x.bfloat16().float() - x).abs(
    ).max()
