"""The port's importer of the reference detector's ``.pth`` checkpoints
(``models/torch_import.py``) against the JAX package's, on the CPU.

* a synthetic reference state dict for ``tiny_model_cfg``, built as the
  JAX package's ``tests/test_torch_import.py`` builds it (spconv KRSC
  convs, the RPN's ``blocks.{3k}`` naming, three direction convs), and
  ``scene.reference_state_dict``, which ``chip_smoke.py`` draws at the
  flagship widths, have the same names and shapes;
* ``load_reference_pth`` writes exactly the state dict that
  ``from_jax_variables(net, JAX pointpillars_variables_from_torch(sd))``
  writes, at one and at two encoder stages;
* predict with the imported weights equals the JAX package's predict with
  its own import (valid counts and labels exact, boxes atol 1e-4, scores
  atol 1e-5);
* a ``.pth`` round trip through ``torch.save``, bare and in the
  reference's ``{epoch, model_state_dict, optimizer_state_dict}``
  envelope; a missing weight raises a ``KeyError`` naming it, a wrong
  width a ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu.models.torch_import import (
    pointpillars_variables_from_torch as jax_variables_from_torch,
)
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.torch_import import (
    layer_counts,
    load_reference_pth,
    load_torch_state_dict,
)
from objectdetection_3d_tpu_torch.models.weights import from_jax_variables
from objectdetection_3d_tpu_torch.scene import reference_state_dict
from test_torch_import import _rand_bn
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)


def two_stage_cfg():
    """``tiny_model_cfg`` with two vertical-encoder stages (8 z cells)."""
    cfg = tiny_model_cfg()
    cfg["vertical_encoder"] = dict(in_channels=16, out_channels=[8, 16])
    cfg["point_cloud_range"] = [0.0, 0.0, 0.0, 8.0, 8.0, 8.0]
    cfg["head"]["ranges"] = [[0.0, 0.0, 0.0, 8.0, 8.0, 8.0]]
    return cfg


CFGS = {"tiny": tiny_model_cfg, "two_stage": two_stage_cfg}


def tiny_reference_sd(seed=4):
    """The JAX package's synthetic reference state dict for
    ``tiny_model_cfg`` (pfn 9 -> 15; one 16-channel stage; four 16-channel
    RPN convs; 4 anchors, 1 class), with a class head strong enough to
    give detections."""
    rng = np.random.default_rng(seed)
    sd = {"voxel_encoder.pfn_layers.0.linear.weight":
          rng.normal(0, 0.5, (15, 9)).astype(np.float32)}
    sd.update(_rand_bn(rng, 15, "voxel_encoder.pfn_layers.0.norm"))
    sd["pseudoimage_generator.middle_conv.0.weight"] = rng.normal(
        0, 0.3, (16, 3, 3, 3, 16)).astype(np.float32)
    sd.update(_rand_bn(rng, 16, "pseudoimage_generator.middle_conv.1"))
    sd["pseudoimage_generator.middle_conv.3.weight"] = rng.normal(
        0, 0.3, (16, 3, 1, 1, 16)).astype(np.float32)
    sd.update(_rand_bn(rng, 16, "pseudoimage_generator.middle_conv.4"))
    for k in range(4):
        sd[f"sparse_rpn.blocks.{3 * k}.weight"] = rng.normal(
            0, 0.3, (16, 3, 3, 16)).astype(np.float32)
        sd.update(_rand_bn(rng, 16, f"sparse_rpn.blocks.{3 * k + 1}"))
    for name, out in (("conv_cls", 4), ("conv_reg", 36)):
        sd[f"bbox_head.{name}.weight"] = rng.normal(
            0, 0.1, (out, 16, 1, 1)).astype(np.float32)
        sd[f"bbox_head.{name}.bias"] = rng.normal(
            0, 0.1, out).astype(np.float32)
    for ax in "xyz":
        sd[f"bbox_head.conv_dir_cls_{ax}.weight"] = rng.normal(
            0, 0.1, (8, 16, 1, 1)).astype(np.float32)
        sd[f"bbox_head.conv_dir_cls_{ax}.bias"] = rng.normal(
            0, 0.1, 8).astype(np.float32)
    sd["bbox_head.conv_cls.weight"] = rng.normal(
        0, 4.0, (4, 16, 1, 1)).astype(np.float32)
    sd["bbox_head.conv_cls.bias"] = np.full((4,), -2.0, np.float32)
    return sd


def port_model(cfg_name="tiny"):
    return PointPillars(CFGS[cfg_name](), device="cpu")


def test_scene_dict_has_the_reference_layout():
    net = port_model().net
    want = tiny_reference_sd()
    got = reference_state_dict(net, seed=1)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_import_equals_the_jax_route(cfg_name):
    net = port_model(cfg_name).net
    sd = (tiny_reference_sd() if cfg_name == "tiny"
          else reference_state_dict(net, seed=2))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    load_reference_pth(net, sd)
    got = net.state_dict()
    other = port_model(cfg_name).net
    from_jax_variables(other, jax_variables_from_torch(
        sd, *layer_counts(other)))
    want = other.state_dict()
    assert set(got) == set(want) == set(before)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert not torch.equal(got[k], before[k]), k


def test_layer_counts():
    assert layer_counts(port_model("tiny").net) == (1, 1, 4)
    assert layer_counts(port_model("two_stage").net) == (1, 2, 4)


def test_predict_with_imported_weights_matches_jax():
    """At 1 / fan-in weight variance (``scene.reference_state_dict``; the
    JAX-style dict's wider draws give boxes of 1e24 m) and a class head
    strong enough to give detections."""
    model = port_model()
    sd = reference_state_dict(model.net, seed=3)
    rng = np.random.default_rng(3)
    sd["bbox_head.conv_cls.weight"] = rng.normal(
        0, 4.0, (4, 16, 1, 1)).astype(np.float32)
    sd["bbox_head.conv_cls.bias"] = np.full((4,), -2.0, np.float32)
    load_reference_pth(model.net, sd)
    jm = JaxPointPillars(**tiny_model_cfg())
    jv = jax_variables_from_torch(sd, 1, 1, 4)
    batch = tiny_batch(batch_size=2, seed=5)
    want = jm.make_predict_fn()(
        jax.tree.map(jnp.asarray, jv),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = model.predict(batch)
    for i in range(2):
        wv = np.asarray(want["valid"][i])
        gv = got["valid"][i].numpy()
        assert gv.sum() == wv.sum() > 0
        np.testing.assert_array_equal(got["label"][i].numpy()[gv],
                                      np.asarray(want["label"][i])[wv])
        np.testing.assert_allclose(got["bbox"][i].numpy()[gv],
                                   np.asarray(want["bbox"][i])[wv],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["score"][i].numpy()[gv],
                                   np.asarray(want["score"][i])[wv],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("envelope", [False, True])
def test_pth_round_trip(tmp_path, envelope):
    sd = tiny_reference_sd()
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    payload = ({"epoch": 7, "model_state_dict": tensors,
                "optimizer_state_dict": {"state": {}, "param_groups": []}}
               if envelope else tensors)
    path = tmp_path / "ckpt.pth"
    torch.save(payload, path)
    loaded = load_torch_state_dict(str(path))
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k], v)
    from_file, from_dict = port_model().net, port_model().net
    load_reference_pth(from_file, path)
    load_reference_pth(from_dict, sd)
    for k, v in from_dict.state_dict().items():
        assert torch.equal(from_file.state_dict()[k], v), k


@pytest.mark.parametrize("key", [
    "voxel_encoder.pfn_layers.0.linear.weight",
    "pseudoimage_generator.middle_conv.4.running_var",
    "sparse_rpn.blocks.9.weight",
    "bbox_head.conv_dir_cls_z.bias"])
def test_missing_key_raises_naming_it(key):
    sd = tiny_reference_sd()
    del sd[key]
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        load_reference_pth(port_model().net, sd)


def test_wrong_width_raises():
    sd = tiny_reference_sd()
    sd["bbox_head.conv_reg.weight"] = sd["bbox_head.conv_reg.weight"][:27]
    sd["bbox_head.conv_reg.bias"] = sd["bbox_head.conv_reg.bias"][:27]
    with pytest.raises(ValueError, match="conv_reg"):
        load_reference_pth(port_model().net, sd)
