"""The whole flagship against the JAX package at its full width, float32
on the CPU.

``configs.flagship_cfg`` against ``__graft_entry__._flagship_cfg``, both
with ``compute_dtype: float32`` and the flagship's other knobs
(``zfold_convs``, ``remat: true``), both from ``artifacts/
overfit_ckpt.npz`` with its ``score_thr``.  The input is a 9.6 x 9.6 m
window of the flagship's range: a 96 x 96 x 100 grid and 110,592 anchors,
so the grid is small but no channel width is cut (the 392-channel
pseudo-image, the 196/128/128 RPN, 12 anchors per cell, the 9-parameter
decode).  The cloud is ``scene.tree_scene(0, extent=9.6, n_trees=4,
n_points=24_576)``, with point and voxel budgets of 24,576.

* the stages: the voxel encoder, the pseudo-image, the RPN and the
  cls / reg / dir heads, each within 1e-4 of its largest element
  (``test_torch_port_model.py::test_stages_match_jax``'s gate);
* predict: ``valid`` and labels exact, scores 1e-5, boxes 1e-4 of
  max(|value|, 1 m) (``chip_smoke.py``'s box gate); the default, and the
  port under ``pallas_subm_conv`` + ``zfold_pallas`` and under
  ``fused_stages`` (K10, K9 and K8 take the flagship's stages there, by
  their plain versions on the CPU), each against the JAX package's
  default predict: the knobs change the lowering, not the function;
* one train step from the same weights with ``chip_smoke.py`` phase 9's
  AdamW (the flagship assignment, K = 512, through the plain versions of
  K3, K4, K6 and K7): losses 1e-4, ``num_pos`` exact, the gradients the
  update takes, before its clip, within 1e-4 of each leaf's largest
  element, the running statistics after the step rtol 1e-4 / atol 1e-5;
* ``tests/jax_reference/flagship_predict.npz`` (the reference of
  ``chip_smoke.py`` phase 22) against a fresh JAX predict of its cloud 0:
  ``valid`` and labels exact, scores and boxes within 1e-6 of max(|value|,
  1) (XLA's CPU convolutions may round apart across hosts).
"""

import numpy as np
import pytest
import torch

import jax
import optax

import make_jax_flagship_reference as ref
import rank_cases as rr
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.weights import (
    _port_to_leaf,
    load_npz,
)
from objectdetection_3d_tpu_torch.scene import make_batch, tree_scene
from test_torch_port_model import _leaves

torch.set_num_threads(1)

EXTENT = 9.6
BUDGET = 24_576
OPT = dict(lr=1e-3, betas=[0.95, 0.99], weight_decay=0.01)
CLIP = 2.0
STAGES = ("voxel_encoder", "pseudoimage_generator", "sparse_rpn",
          "bbox_head")
KNOBS = {"pallas_subm_conv+zfold_pallas": {"pallas_subm_conv": True,
                                           "zfold_pallas": True},
         "fused_stages": {"fused_stages": True}}


def _window(cfg):
    return rr.window_cfg(cfg, EXTENT, BUDGET)


def _batch():
    return make_batch(tree_scene(0, extent=EXTENT, n_trees=4,
                                 n_points=BUDGET), BUDGET)


def _points(batch):
    return {"points": batch["points"], "num_points": batch["num_points"]}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's stages, predict and train step on the window."""
    cfg = _window(ref.flagship_cfg())
    jm, variables = ref.jax_model(cfg)
    batch = _batch()
    vox = jm.voxel_layer.points_batch(batch["points"], batch["num_points"])
    _, inter = jax.jit(lambda v, vx: jm.net.apply(
        v, None, vx["num_points_per_voxel"], vx["coords"],
        vx["voxel_mask"], train=False, points=vx["points"],
        pt_voxel=vx["pt_voxel"], pt_valid=vx["pt_valid"],
        max_slots=jm.voxel_layer.max_voxel_points,
        capture_intermediates=True, mutable=["intermediates"]))(
            variables, vox)
    stages = {k: jax.tree.map(np.asarray,
                              inter["intermediates"][k]["__call__"][0])
              for k in STAGES}
    preds = jax.tree.map(np.asarray,
                         jm.make_predict_fn()(variables, _points(batch)))

    # the JAX package's train step (``train_step_fn``), which also
    # returns the gradients the update receives
    tx = jm.get_optimizer(OPT, grad_clip_value=CLIP)

    def step(params, batch_stats, anchors, anchor_aabb):
        def total(params):
            outs, new_bs = jm.apply({"params": params,
                                     "batch_stats": batch_stats}, batch,
                                    train=True)
            losses, num_pos = jm.loss(outs, batch, anchors, anchor_aabb,
                                      with_num_pos=True)
            return sum(losses.values()), (losses, num_pos, new_bs)

        grads, (losses, num_pos, new_bs) = jax.grad(
            total, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return (grads, losses, num_pos, new_bs,
                optax.apply_updates(params, updates))

    grads, losses, num_pos, new_bs, _ = jax.tree.map(
        np.asarray, jax.jit(step)(variables["params"],
                                  variables["batch_stats"], jm.anchors,
                                  jm.anchor_aabb))
    return {"stages": stages, "preds": preds, "grads": dict(_leaves(grads)),
            "losses": {k: float(v) for k, v in losses.items()},
            "num_pos": int(num_pos), "batch_stats": dict(_leaves(new_bs))}


def _port_model(tpu=None):
    cfg = _window(configs.flagship_cfg({"compute_dtype": "float32",
                                        **(tpu or {})}))
    model = PointPillars(cfg, device="cpu")
    load_npz(model.net, ref.NPZ)
    model.head_cfg["score_thr"] = ref.read_checkpoint()[1]
    return model


@pytest.fixture(scope="module")
def port_side():
    """The port's stages, predicts (the default and each knob set) and
    train step on the window."""
    batch = _batch()
    model = _port_model()
    stages = {}
    hooks = [getattr(model.net, name).register_forward_hook(
        lambda mod, args, out, name=name: stages.__setitem__(name, out))
        for name in STAGES]
    try:
        model.apply(_points(batch))
    finally:
        for hk in hooks:
            hk.remove()
    preds = {"default": model.make_predict_fn()(_points(batch))}
    for name, knobs in KNOBS.items():
        preds[name] = _port_model(knobs).make_predict_fn()(_points(batch))

    tx = model.get_optimizer(OPT, grad_clip_value=CLIP)
    grads = {}
    update = tx.step

    def step_recording_grads(closure=None):
        # the gradients as the update receives them, before its clip
        for name, p in model.net.named_parameters():
            _, path, arr = _port_to_leaf(name, p.grad.numpy().copy())
            grads[path] = arr
        return update(closure)

    tx.step = step_recording_grads
    out = model.make_train_step(tx)(batch)
    stats = {}
    for name, buf in model.net.named_buffers():
        _, path, arr = _port_to_leaf(name, buf.numpy())
        stats[path] = arr
    return {"stages": stages, "preds": preds, "grads": grads,
            "losses": {k: float(v) for k, v in out.items()},
            "batch_stats": stats}


def _assert_predict(got, want):
    """``valid`` and labels exact; where valid, scores within 1e-5 and
    boxes within 1e-4 of max(|value|, 1 m)."""
    got = {k: np.asarray(v) for k, v in got.items()}
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.sum() >= 1
    np.testing.assert_array_equal(got["label"][valid], want["label"][valid])
    np.testing.assert_allclose(got["score"][valid], want["score"][valid],
                               rtol=0, atol=1e-5)
    box = want["bbox"][valid]
    assert np.all(np.abs(got["bbox"][valid] - box)
                  <= 1e-4 * np.maximum(np.abs(box), 1.0))


def _within_largest(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("stage", STAGES)
def test_stages_match_jax_at_full_width(jax_side, port_side, stage):
    got, want = port_side["stages"][stage], jax_side["stages"][stage]
    if stage == "voxel_encoder":
        _within_largest(got.numpy(), want)
    elif stage == "pseudoimage_generator":
        assert got.shape[1] == 392          # the flagship's pseudo-image
        _within_largest(got.permute(0, 2, 3, 1).numpy(), want[0])
    elif stage == "sparse_rpn":
        _within_largest(got.permute(0, 2, 3, 1).numpy(), want)
    else:
        assert [g.shape[-1] for g in got] == [12, 12 * 9, 12 * 6]
        for g, w in zip(got, want):
            _within_largest(g.numpy(), w)


@pytest.mark.parametrize("path", ["default", *KNOBS])
def test_predict_matches_jax_at_full_width(jax_side, port_side, path):
    _assert_predict(port_side["preds"][path], jax_side["preds"])


def test_train_step_matches_jax_at_full_width(jax_side, port_side):
    got, want = port_side, jax_side
    assert got["losses"]["num_pos"] == want["num_pos"] > 0
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert set(got["grads"]) == set(want["grads"])
    for path, arr in want["grads"].items():
        _within_largest(got["grads"][path], arr)
    assert set(got["batch_stats"]) == set(want["batch_stats"])
    for path, arr in want["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][path], arr, rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


def test_reference_file_matches_a_fresh_jax_predict():
    with np.load(ref.OUT) as z:
        stored = {k: z[k] for k in z.files}
    assert stored["bbox"].shape == (len(ref.SEEDS), 256, 9)
    assert str(stored["provenance"]).startswith("jax ")
    fresh = ref.predict_clouds([0])
    valid = fresh["valid"][0]
    assert valid.sum() >= 1
    np.testing.assert_array_equal(stored["valid"][0], valid)
    np.testing.assert_array_equal(stored["label"][0][valid],
                                  fresh["label"][0][valid])
    for k in ("score", "bbox"):
        want = fresh[k][0][valid]
        assert np.all(np.abs(stored[k][0][valid] - want)
                      <= 1e-6 * np.maximum(np.abs(want), 1.0)), k
