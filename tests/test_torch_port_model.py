"""The port's network, predict path and weight bridge against the JAX
package on the tiny configuration, float32 on the CPU.

Tolerances: head outputs rtol = atol = 1e-4 (float32 conv sums taken in
another order); predict boxes atol 1e-4, scores atol 1e-5, labels and
valid masks exact.  Rows with ``valid == False`` are not compared: among
equal below-threshold logits the two top-k's tie orders differ by design
(``models/detector.py`` of the port).
"""

import os

import numpy as np
import pytest
import torch

import jax

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.layers import fixed_point_segment_sum
from objectdetection_3d_tpu_torch.models.weights import (
    from_jax_variables,
    load_npz,
    to_jax_variables,
)
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "overfit_ckpt.npz")
TOL = dict(rtol=1e-4, atol=1e-4)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _random_variables(variables, seed=0):
    """JAX init variables with batch-norm statistics and affines drawn at
    random (init has mean 0 / var 1 / scale 1 / bias 0, which would hide a
    layout error) and a class head strong enough to give detections."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.array(a, np.float32), variables)
    for path, arr in _leaves(out["batch_stats"]):
        new = (rng.uniform(0.5, 2.0, arr.shape) if path[-1] == "var"
               else rng.normal(0, 0.3, arr.shape))
        arr[...] = new
    for path, arr in _leaves(out["params"]):
        if path[-1] == "scale":
            arr[...] = rng.uniform(0.5, 1.5, arr.shape)
        elif path[-1] == "bias" and path[-2] != "conv_cls":
            arr[...] = rng.normal(0, 0.2, arr.shape)
    head = out["params"]["bbox_head"]["conv_cls"]
    head["kernel"][...] = rng.normal(0, 4.0, head["kernel"].shape)
    head["bias"][...] = -2.0
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxPointPillars(**tiny_model_cfg())
    variables = _random_variables(jm.init_variables(jax.random.PRNGKey(0)))
    tm = PointPillars(configs.tiny_model_cfg(), device="cpu")
    from_jax_variables(tm.net, variables)
    return jm, variables, tm


def test_stages_match_jax(models):
    """PFN, vertical encoder, RPN and head outputs, stage by stage."""
    jm, variables, tm = models
    batch = tiny_batch()
    vox = jm.voxel_layer.points_batch(batch["points"], batch["num_points"])
    _, inter = jm.net.apply(
        variables, None, vox["num_points_per_voxel"], vox["coords"],
        vox["voxel_mask"], train=False, points=vox["points"],
        pt_voxel=vox["pt_voxel"], pt_valid=vox["pt_valid"],
        max_slots=jm.voxel_layer.max_voxel_points,
        capture_intermediates=True, mutable=["intermediates"])
    want = {k: inter["intermediates"][k]["__call__"][0]
            for k in ("voxel_encoder", "pseudoimage_generator", "sparse_rpn",
                      "bbox_head")}

    got = {}
    hooks = [getattr(tm.net, name).register_forward_hook(
        lambda mod, args, out, name=name: got.__setitem__(name, out))
        for name in want]
    try:
        tm.apply(batch)
    finally:
        for hk in hooks:
            hk.remove()

    np.testing.assert_allclose(got["voxel_encoder"].numpy(),
                               np.asarray(want["voxel_encoder"]), **TOL)
    pseudo = np.asarray(want["pseudoimage_generator"][0])
    assert np.count_nonzero(pseudo) > 0
    np.testing.assert_allclose(
        got["pseudoimage_generator"].permute(0, 2, 3, 1).numpy(), pseudo,
        **TOL)
    np.testing.assert_allclose(
        got["sparse_rpn"].permute(0, 2, 3, 1).numpy(),
        np.asarray(want["sparse_rpn"]), **TOL)
    for g, w in zip(got["bbox_head"], want["bbox_head"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_head_outputs_match_jax(models):
    jm, variables, tm = models
    batch = tiny_batch(seed=3)
    want, _ = jm.apply(variables, batch)
    got = tm.apply(batch)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_matches_jax(models, seed):
    jm, variables, tm = models
    batch = tiny_batch(seed=seed)
    want = jax.tree.map(np.asarray, jm.make_predict_fn()(variables, batch))
    got = {k: v.numpy() for k, v in tm.make_predict_fn()(batch).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.sum() >= 2
    np.testing.assert_allclose(got["bbox"][valid], want["bbox"][valid],
                               atol=1e-4)
    np.testing.assert_allclose(got["score"][valid], want["score"][valid],
                               atol=1e-5)
    np.testing.assert_array_equal(got["label"][valid], want["label"][valid])


def test_bridge_round_trip(models):
    _, variables, tm = models
    back = to_jax_variables(tm.net)
    want = dict(_leaves(variables))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))


def test_load_npz_loads_every_weight():
    model = PointPillars(configs.flagship_cfg(), device="cpu")
    with np.load(NPZ) as z:
        files = {k: z[k] for k in z.files}
    weights = {k for k in files if k.split("/")[0] in ("params",
                                                       "batch_stats")}
    assert len(files) == 93
    assert set(files) - weights == {"provenance", "score_thr"}
    assert load_npz(model.net, NPZ) == len(weights) == len(
        model.net.state_dict())
    back = dict(_leaves(to_jax_variables(model.net)))
    for key in weights:
        np.testing.assert_array_equal(back[tuple(key.split("/"))],
                                      files[key], err_msg=key)
    # a 392-channel pseudo-image and 12 anchors per cell, as in the JAX
    # package's flagship
    assert model.net.sparse_rpn.conv_0.weight.shape == (196, 392, 3, 3)
    assert model.net.bbox_head.conv_dir.weight.shape == (72, 128, 1, 1)
    assert model.anchors.shape == (400 * 400 * 12, 9)


def test_device_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the fallback rule needs none")
    cfg = configs.tiny_model_cfg()
    assert cfg["device"] == "cpu"      # the config's key does not choose
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PointPillars(cfg)


@pytest.mark.parametrize("key,value", [("use_dense_backbone", True),
                                       ("tpu", {"sparse_middle": True})])
def test_unported_paths_raise(key, value):
    cfg = configs.tiny_model_cfg()
    if key == "tpu":
        cfg["tpu"] = dict(cfg["tpu"], **value)
    else:
        cfg[key] = value
    with pytest.raises(NotImplementedError):
        PointPillars(cfg, device="cpu")


def test_centroid_sum_is_exact_and_order_free():
    """C8: the PFN's centroid sum is integer arithmetic, so no order of
    its atomics on the card changes a bit: here, a permutation of the
    rows.  Each value is within 2^-frac_bits of float64's sum."""
    rng = np.random.default_rng(0)
    seg = torch.as_tensor(np.sort(rng.integers(0, 300, 5000)))
    vals = torch.as_tensor(rng.uniform(0, 40, (5000, 3)).astype(np.float32))
    net = PointPillars(configs.flagship_cfg(), device="cpu").net
    bits = net.voxel_encoder.frac_bits
    assert bits == 50
    got = fixed_point_segment_sum(vals, seg, 301, bits)
    want = torch.zeros((301, 3), dtype=torch.float64).index_add_(
        0, seg, vals.double())
    counts = torch.bincount(seg, minlength=301)[:, None].double()
    assert bool(((got - want).abs() <= counts * 2.0 ** -bits).all())
    perm = torch.as_tensor(rng.permutation(5000))
    assert torch.equal(fixed_point_segment_sum(vals[perm], seg[perm], 301,
                                               bits), got)
    cfg = configs.tiny_model_cfg()
    cfg["point_cloud_range"] = [0.0, 0.0, 0.0, 8.0, 8.0, 4.0e12]
    with pytest.raises(ValueError, match="fraction bits"):
        PointPillars(cfg, device="cpu")
