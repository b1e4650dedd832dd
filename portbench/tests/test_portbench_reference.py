"""The plain reference against the port at tiny sizes on the CPU (float32,
the port's plain kernel versions), and the FLOP count against a hand
count of the published shapes."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import REPO, TRAFFIC, tiny_fpn_model, tiny_model
from portbench.harness import cells, compare, flops


def _conf(model):
    return {"name": "tiny", "model": model, "lowering_from_program": [],
            "weights": {}}


@pytest.mark.parametrize("make_model", [tiny_model, tiny_fpn_model],
                         ids=["rpn", "fpn"])
def test_predict_matches_port(make_model):
    c = cells.make("predict", _conf(make_model()), TRAFFIC["predict"],
                   2 ** 40 + 3, REPO, device="cpu")
    c.setup()
    c.window(0.2)
    ref = c.reference_outputs()
    assert set(ref) == {0, 1, 2}
    for k in ref:
        assert ref[k]["valid"].sum() > 0
        got = {key: v[0] for key, v in c.outputs[k].items()}
        np.testing.assert_array_equal(got["valid"], ref[k]["valid"].numpy())
        np.testing.assert_allclose(got["score"], ref[k]["score"].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(got["bbox"], ref[k]["bbox"].numpy(),
                                   atol=1e-4, rtol=1e-4)
    nums = compare.predict_numbers(c.outputs, ref)
    assert nums["box_gap"] < 1e-4 and nums["score_gap"] < 1e-5
    assert nums["count_gap"] == 0 and nums["rank_gap"] == 0
    assert nums["kept"] == nums["detections"] > 0


def test_train_steps_match_port():
    c = cells.make("train", _conf(tiny_model()), TRAFFIC["train"], 5, REPO,
                   device="cpu")
    c.setup()
    losses, first, change = c.reference_steps()
    for a, b in zip(c.set_up_losses, losses):
        assert a["num_pos"] == b["num_pos"] > 0
        for k in ("loss_cls", "loss_bbox", "loss_dir_x", "loss_dir_y",
                  "loss_dir_z"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7)
    for k in first:
        assert c.first_grad[k] == pytest.approx(first[k], rel=1e-4,
                                                abs=1e-9)
        assert c.change[k] == pytest.approx(change[k], rel=1e-4, abs=1e-9)
    nums = compare.train_numbers((c.set_up_losses, c.first_grad, c.change),
                                 (losses, first, change))
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap_median"] < 1e-4
    assert nums["change_gap_median"] < 1e-4
    # the window's last step, from the state it started from
    c.window(0.2)
    c.free()
    assert c.last["t"] == len(c.losses) - 1 >= 3
    r_loss, r_grad, r_change = c.reference_last_step()
    for k in compare.LOSS_KEYS:
        assert c.last["losses"][k] == pytest.approx(r_loss[k], rel=1e-5,
                                                    abs=1e-7)
    for k in r_change:
        assert c.last["change"][k] == pytest.approx(r_change[k], rel=1e-4,
                                                    abs=1e-9)
    last = compare.last_step_numbers(c.last["change"], (r_grad, r_change))
    assert last["last_change_gap"] < 1e-4


def test_plot_matches_port():
    c = cells.make("plot", _conf(tiny_model()), TRAFFIC["plot"], 11, REPO,
                   device="cpu")
    c.setup()
    c.window(0.1)
    (k, ref), = c.reference_outputs().items()
    assert len(ref["score"]) > 0
    nums = compare.plot_numbers(c.outputs[k], ref)
    assert nums["count_gap"] == 0 and nums["score_gap"] < 1e-5
    assert nums["box_gap"] < 1e-4 and nums["rank_gap"] == 0


def _model(name):
    with open(os.path.join(REPO, "portbench", "configs",
                           name + ".json")) as f:
        return json.load(f)["model"]


def test_flop_count_by_hand():
    f = flops.forward_flops(_model("flagship"))
    # five stages over 400 x 400: 3x3x3 subm convs at depth 100, 49, 24,
    # 11, 5 and (3,1,1) down convs to 49, 24, 11, 5, 2; channels 20, 32,
    # 64, 128, 196 from 20
    hw = 400 * 400
    enc = sum(2 * hw * (d * ci * 27 * co + dn * co * 3 * co)
              for d, dn, ci, co in ((100, 49, 20, 20), (49, 24, 20, 32),
                                    (24, 11, 32, 64), (11, 5, 64, 128),
                                    (5, 2, 128, 196)))
    assert f["encoder"] == enc
    assert round(enc / 1e9, 1) == 3141.7
    rpn = 2 * hw * 9 * (392 * 196 + 196 * 196 + 196 * 128 + 3 * 128 * 128)
    assert f["rpn"] == rpn and round(rpn / 1e9, 1) == 545.7
    assert f["head"] == 2 * hw * 128 * 12 * 16
    g = flops.forward_flops(_model("fpn"))
    bb = 2 * 9 * (200 * 200 * (392 * 196 + 196 * 196)
                  + 100 * 100 * (196 * 128 + 128 * 128)
                  + 50 * 50 * (128 * 128 + 128 * 128))
    neck = 2 * 256 * (200 * 200 * 196 + 100 * 100 * 128 * 4
                      + 50 * 50 * 128 * 16)
    assert g["backbone_neck"] == bb + neck
    assert round(bb / 1e9, 1) == 91.9 and round(neck / 1e9, 1) == 9.3
    assert g["head"] == 2 * 200 * 200 * 768 * 12 * 16
    # the grid read once and the pseudo-image written once in bf16, the
    # float32 weights once
    assert flops.encoder_bytes(_model("flagship")) > 2 * (
        100 * hw * 20 + 392 * hw)


def test_fp8_control_moves_outputs():
    """The control (fp8 operands) lands much farther from the reference
    than the float32 program does, at the tiny size too."""
    from portbench.reference import model as ref_model

    c = cells.make("predict", _conf(tiny_model()), TRAFFIC["predict"], 9,
                   REPO, device="cpu")
    c.setup()
    c.window(0.2)
    ref = c.reference_outputs()
    ctl = {k: {key: v.numpy() for key, v in d.items()
               if key in ("bbox", "score", "valid")}
           for k, d in c.reference_outputs(ref_model.fp8).items()}
    prog_gap = compare.predict_numbers(c.outputs, ref)["box_gap"]
    ctl_gap = compare.predict_numbers(ctl, ref)["box_gap"]
    assert ctl_gap > 3 * prog_gap and ctl_gap > 1e-3
    with torch.no_grad():
        x = torch.linspace(-3, 3, 101)
        # e4m3 keeps 3 mantissa bits: 1/16 of the value at most
        assert 0 < (ref_model.fp8(x) - x).abs().max() <= 3 / 16
