"""The port's on-device augmentation (``augment/device_ops.py``) against
the JAX package's ``augment_batch``, float32 on the CPU.

* ``parse_device_augment_cfg``: the same tuples.
* ``apply_params`` fed the JAX package's own draws (``jax.random`` on the
  keys of ``_split_per_item``): points and boxes within 1e-5 m of
  ``augment_batch`` on yaw-only boxes, for each transform and all at
  once.
* Tilted boxes (C10): ``flip_x`` is the true mirror in the port (``rz ->
  pi - rz``, ``rx -> -rx``) and keeps every box's interior points (but
  those within 1e-4 m of a face); the JAX package's (``ry -> -ry``) loses
  them.  With every transform on, the port differs from the JAX package
  only in rx and ry of the items flipped in x.
* ``draw_params``: the draws' shapes, ranges and reproducibility.
* The train step with ``device_augment`` equals the step without it on
  the batch that ``augment_batch`` gives under the same generator state:
  the monolithic step, and the accumulation step (one draw per chunk);
  losses and parameters exact.
* The generator's state travels in the ``.pth`` checkpoint; the
  pipeline seeds it from its RNG and a resumed run restores it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_3d_tpu.augment.device_ops import (
    _split_per_item,
)
from objectdetection_3d_tpu.augment.device_ops import (
    augment_batch as jax_augment_batch,
)
from objectdetection_3d_tpu.augment.device_ops import (
    parse_device_augment_cfg as jax_parse,
)
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.augment.device_ops import (
    apply_params,
    augment_batch,
    draw_params,
    parse_device_augment_cfg,
)
from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.ops.boxes import box_axes, points_in_boxes
from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io
from tiny import tiny_batch

torch.set_num_threads(1)

ALL = {"rotate": {"min": 0.0, "max": 6.283}, "scale": {},
       "flip_x": True, "flip_y": True, "translate": {"std": 0.5},
       "noise": {"std": 0.01}}
FACE_MARGIN = 1e-4


def _rot(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def _batch(tilted, seed=0, b=2, p=512, g=3):
    """Points inside their boxes (and 40 clutter points per item), the
    last ``p // 8`` rows of item 1 padding, box 2 of item 1 masked."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, g, 9), np.float32)
    points = np.zeros((b, p, 4), np.float32)
    per = (p - 40) // g
    for i in range(b):
        for j in range(g):
            c = rng.uniform(2, 6, 2)
            tilt = rng.uniform(-0.15, 0.15, 2) if tilted else (0.0, 0.0)
            boxes[i, j] = [c[0], c[1], rng.uniform(0, 0.5), 0.9, 0.9, 2.0,
                           tilt[0], tilt[1], rng.uniform(-3, 3)]
            local = rng.uniform([-0.4, -0.4, 0.05], [0.4, 0.4, 1.95],
                                (per, 3))
            pts = local @ _rot(*boxes[i, j, 6:]).T + boxes[i, j, :3]
            points[i, j * per:(j + 1) * per, :3] = pts
        points[i, g * per:, :3] = rng.uniform([0, 0, 0], [8, 8, 3],
                                              (p - g * per, 3))
        points[i, :, 3] = rng.uniform(0, 1, p)
    num = np.full((b,), p, np.int32)
    num[1] = p - p // 8
    points[1, num[1]:] = 0
    gt_mask = np.ones((b, g), bool)
    gt_mask[1, 2] = False
    boxes[1, 2] = 0
    return {"points": points, "num_points": num, "bboxes": boxes,
            "labels": np.zeros((b, g), np.int32), "gt_mask": gt_mask}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_draws(key, batch, cfg):
    """The draws ``augment_batch`` makes from ``key``, as the port's
    ``params`` list."""
    b, p = batch["points"].shape[:2]
    keys = _split_per_item(key, b, max(len(cfg), 1))
    out = []
    for i, entry in enumerate(cfg):
        k = keys[:, i][0]
        name = entry[0]
        if name in ("rotate", "scale"):
            shape = (b,) if name == "rotate" else (b, 1)
            val = jax.random.uniform(k, shape, minval=entry[1],
                                     maxval=entry[2])
            out.append(torch.as_tensor(np.asarray(val).reshape(b)))
        elif name in ("flip_x", "flip_y"):
            val = jax.random.bernoulli(k, 0.5, (b, 1))
            out.append(torch.as_tensor(np.asarray(val).reshape(b)))
        elif name == "translate":
            val = jax.random.normal(k, (b, 1, 3)) * entry[1]
            out.append(torch.as_tensor(np.asarray(val).reshape(b, 3)))
        else:
            val = jax.random.normal(k, (b, p, 3)) * entry[1]
            out.append(torch.as_tensor(np.asarray(val)))
    return out


def _both(batch, cfg_dict, key):
    cfg = parse_device_augment_cfg(cfg_dict)
    want = jax_augment_batch({k: jnp.asarray(v) for k, v in batch.items()},
                             key, jax_parse(cfg_dict))
    draws = _jax_draws(key, batch, cfg)
    got = apply_params(_torch(batch), draws, cfg)
    return got, {k: np.asarray(v) for k, v in want.items()}, draws


def _inside(points, boxes):
    """(P, G) membership, and the points within FACE_MARGIN of a face."""
    pts = torch.as_tensor(points[:, :3], dtype=torch.float64)
    bx = torch.as_tensor(boxes, dtype=torch.float64)
    rot, mid = box_axes(bx)
    proj = torch.einsum("pnk,nkj->pnj", pts[:, None] - mid[None], rot)
    gap = (proj.abs() * 2 - bx[None, :, 3:6]).abs().amin(-1) / 2
    return (points_in_boxes(torch.as_tensor(points), torch.as_tensor(boxes))
            .numpy(), (gap < FACE_MARGIN).numpy())


def _kept(before, after, valid_boxes):
    """True when every valid box holds the same points before and after,
    but points near a face in either."""
    in0, near0 = _inside(*before)
    in1, near1 = _inside(*after)
    ok = (in0 == in1) | near0 | near1
    return bool(ok[:, valid_boxes].all()), int(in0[:, valid_boxes].sum()), \
        int(in1[:, valid_boxes].sum())


def test_parse_matches_jax():
    for cfg in ({}, ALL, {"rotate": None, "flip_y": True},
                {"scale": {"min": 0.9, "max": 1.1}, "flip_x": False}):
        assert parse_device_augment_cfg(cfg) == jax_parse(cfg)


@pytest.mark.parametrize("name", list(ALL) + ["all"])
def test_apply_params_matches_jax_on_yaw_only_boxes(name):
    cfg = ALL if name == "all" else {name: ALL[name]}
    batch = _batch(tilted=False, seed=1)
    got, want, _ = _both(batch, cfg, jax.random.PRNGKey(3))
    np.testing.assert_allclose(got["points"].numpy(), want["points"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["bboxes"].numpy(), want["bboxes"],
                               atol=1e-5, rtol=0)
    for key in ("num_points", "labels", "gt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), batch[key])
    # padding rows and masked boxes stay zero
    assert not got["points"][1, batch["num_points"][1]:].any()
    assert not got["bboxes"][1, 2].any()


def _all_flipped_key(batch, cfg_dict):
    """A key whose flip_x draws flip every item."""
    cfg = parse_device_augment_cfg(cfg_dict)
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, batch, cfg)
        if bool(draws[[e[0] for e in cfg].index("flip_x")].all()):
            return key
    raise AssertionError("no key flips every item")


def test_flip_x_is_the_true_mirror_of_tilted_boxes():
    """C10: the port's flip_x keeps each tilted box's interior points;
    the JAX package's (ry -> -ry, rx kept) does not."""
    batch = _batch(tilted=True, seed=2)
    cfg = {"flip_x": True}
    got, want, _ = _both(batch, cfg, _all_flipped_key(batch, cfg))
    np.testing.assert_allclose(got["points"].numpy(), want["points"],
                               atol=1e-5, rtol=0)
    gb, wb, b0 = got["bboxes"].numpy(), want["bboxes"], batch["bboxes"]
    cols = [0, 1, 2, 3, 4, 5, 8]
    np.testing.assert_allclose(gb[..., cols], wb[..., cols], atol=1e-5)
    np.testing.assert_array_equal(gb[..., 6], -b0[..., 6])  # rx -> -rx
    np.testing.assert_array_equal(gb[..., 7], b0[..., 7])   # ry kept
    np.testing.assert_array_equal(wb[..., 7], -b0[..., 7])  # JAX: ry -> -ry
    for i in range(2):
        valid = batch["gt_mask"][i]
        n = batch["num_points"][i]
        before = (batch["points"][i, :n], b0[i])
        ok, n0, n1 = _kept(before, (got["points"][i, :n].numpy(), gb[i]),
                           valid)
        assert ok and n0 == n1 > 0
        _, _, n_jax = _kept(before, (want["points"][i, :n], wb[i]), valid)
        assert n_jax < n0, (n_jax, n0)


def test_all_transforms_on_tilted_boxes_differ_from_jax_only_in_flip_x():
    batch = _batch(tilted=True, seed=4)
    cfg = dict(ALL)
    cfg.pop("noise")
    got, want, draws = _both(batch, cfg, jax.random.PRNGKey(7))
    np.testing.assert_allclose(got["points"].numpy(), want["points"],
                               atol=1e-5, rtol=0)
    gb, wb = got["bboxes"].numpy(), want["bboxes"]
    np.testing.assert_allclose(gb[..., [0, 1, 2, 3, 4, 5, 8]],
                               wb[..., [0, 1, 2, 3, 4, 5, 8]], atol=1e-5)
    flipped = draws[[e[0] for e in parse_device_augment_cfg(cfg)]
                    .index("flip_x")].numpy()
    assert flipped.any()
    for i in range(2):
        sign = -1.0 if flipped[i] else 1.0
        np.testing.assert_allclose(gb[i, :, 6:8], sign * wb[i, :, 6:8],
                                   atol=1e-6)
        n = batch["num_points"][i]
        ok, n0, n1 = _kept((batch["points"][i, :n], batch["bboxes"][i]),
                           (got["points"][i, :n].numpy(), gb[i]),
                           batch["gt_mask"][i])
        assert ok and n0 == n1 > 0


def test_draw_params_shapes_ranges_and_reproducibility():
    batch = _torch(_batch(tilted=False))
    cfg = parse_device_augment_cfg(dict(ALL, rotate={"min": 1.0,
                                                     "max": 2.0}))
    draws = draw_params(batch["points"], cfg,
                        torch.Generator().manual_seed(5))
    again = draw_params(batch["points"], cfg,
                        torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    shapes = [tuple(d.shape) for d in draws]
    assert shapes == [(2,), (2,), (2,), (2,), (2, 3), (2, 512, 3)]
    assert bool(((draws[0] >= 1.0) & (draws[0] < 2.0)).all())
    assert bool(((draws[1] >= 0.95) & (draws[1] < 1.05)).all())
    assert draws[2].dtype == torch.bool
    with pytest.raises(ValueError, match="Unknown device augmentation"):
        draw_params(batch["points"], (("shear", 1.0),), torch.Generator())


def _models(microbatch):
    cfg = configs.tiny_model_cfg()
    aug = dict(cfg, device_augment=dict(ALL))
    with_aug = PointPillars(aug, device="cpu")
    plain = PointPillars(cfg, device="cpu")
    plain.net.load_state_dict(with_aug.net.state_dict())
    steps = []
    for model in (with_aug, plain):
        tx = model.get_optimizer(dict(lr=1e-3), grad_clip_value=2.0)
        steps.append(model.make_train_step(tx, microbatch=microbatch))
    return with_aug, plain, steps


@pytest.mark.parametrize("microbatch", [None, 1])
def test_train_step_with_device_augment_is_the_step_on_the_augmented_batch(
        microbatch):
    with_aug, plain, (step_aug, step_plain) = _models(microbatch)
    batch = tiny_batch(batch_size=2, num_gt=3, seed=5)
    gen = torch.Generator().manual_seed(123)
    with_aug.augment_generator.manual_seed(123)
    tb = _torch(batch)
    cfg = with_aug.device_augment
    if microbatch is None:
        augmented = augment_batch(tb, cfg, gen)
    else:   # one draw per chunk, in chunk order
        chunks = [augment_batch({k: v[i:i + 1] for k, v in tb.items()},
                                cfg, gen) for i in range(2)]
        augmented = {k: torch.cat([c[k] for c in chunks]) for k in tb}
    assert not torch.equal(augmented["bboxes"], tb["bboxes"])
    got = step_aug(batch)
    want = step_plain(augmented)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert float(got["num_pos"]) > 0
    for (name, a), b in zip(with_aug.net.state_dict().items(),
                            plain.net.state_dict().values()):
        assert torch.equal(a, b), name
    # the generator moved on: the next step draws anew
    assert not torch.equal(with_aug.augment_generator.get_state(),
                           torch.Generator().manual_seed(123).get_state())


def test_generator_state_travels_in_the_checkpoint(tmp_path):
    model = PointPillars(dict(configs.tiny_model_cfg(),
                              device_augment={"flip_x": True}),
                         device="cpu")
    gen = model.augment_generator
    gen.manual_seed(9)
    torch.rand(3, generator=gen)
    path = str(tmp_path / "ckpt.pth")
    ckpt_io.save_ckpt(path, 0, model.net, None, gen)
    want = torch.rand(4, generator=gen)
    payload = ckpt_io.load_ckpt(path)
    restored = torch.Generator()
    restored.set_state(payload["augment_rng_state"])
    assert torch.equal(torch.rand(4, generator=restored), want)
    assert "augment_rng_state" not in ckpt_io.snapshot(0, model.net)
    assert math.isfinite(float(want.sum()))


def test_pipeline_seeds_and_restores_the_augment_generator(tmp_path):
    """The pipeline seeds ``augment_generator`` from its RNG after the
    weights (as the JAX pipeline draws ``state["rng"]``), and a resumed
    run restores the generator's state from the checkpoint."""
    from test_pipeline import write_scene
    from test_torch_port_pipeline import build, port_cfg, version_of

    for split in ("training", "validation", "testing"):
        d = tmp_path / "data" / split
        d.mkdir(parents=True)
        write_scene(d, f"{split}_0", seed=len(split))

    def cfg(**pipeline):
        c = port_cfg(tmp_path, **pipeline).dump()
        c["model"]["device_augment"] = {"flip_x": True}
        return Config(c)

    first = build(cfg())
    rng = np.random.default_rng(123)
    first.rng = np.random.default_rng(123)
    first._init_state()
    rng.integers(np.iinfo(np.int32).max)           # the weights' draw
    want = torch.Generator().manual_seed(
        int(rng.integers(np.iinfo(np.int32).max))).get_state()
    assert torch.equal(first.model.augment_generator.get_state(), want)
    torch.rand(5, generator=first.model.augment_generator)
    saved = first.model.augment_generator.get_state()
    first.save_ckpt(0)
    first.wait_for_ckpts()

    resumed = build(cfg(is_resume=True, resume_from=version_of(first)))
    assert not torch.equal(resumed.model.augment_generator.get_state(),
                           saved)
    assert resumed.load_ckpt()[0] == 1
    assert torch.equal(resumed.model.augment_generator.get_state(), saved)
