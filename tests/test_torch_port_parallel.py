"""The port's data and spatial parallelism (``objectdetection_3d_tpu_torch/
parallel``) on the CPU: ranks started by ``parallel.launch.spawn`` over
gloo (the rendezvous file in ``tmp_path``, one thread per rank), each
held against the one-device port on the global batch at the JAX tests'
tolerances (``tests/test_parallel.py``, ``test_pipeline_parallel.py``;
``rank_cases.check_step`` and ``check_preds``):

* losses rtol 2e-4, atol 1e-5; the gradients the update took within
  1e-4 of each parameter's largest gradient element; parameters and
  running statistics rtol 2e-4, atol 2e-5, but within 2 lr where the
  gradient lies within its tolerance of 0 (AdamW's first step is lr * g
  / (|g| + 1e-8)): the data-parallel step at world 2 (the replicas
  bitwise equal after it),
  with ``device_augment`` (the generators equal after it), under
  gradient accumulation, and the spatial steps 1 x 2 and 2 x 2;
* detections score 1e-4, labels exact, boxes 1e-3: the sharded eval
  (losses as above) and predict, and the spatial predict at 1 x 2 and
  2 x 2, also against the JAX package's ``make_spatial_predict_fn`` on
  its 8-device CPU mesh from the same weights;
* the halo exchange (forward and the input's gradient) against the
  unsplit conv, and the global masked-BN statistics against one
  device's: 1e-5 and 2e-5; bfloat16 and float16 slabs gathered back
  bit for bit;
* the gather encoder (``tpu.sparse_middle``) and the dense backbone
  (``use_dense_backbone``) on the spatial path: their predict at 1 x 2
  and 2 x 2 against one device and the JAX package's spatial predict
  (boxes 1e-4, scores 1e-5, labels and valid exact), their step at
  1 x 2 against one device as above, the gather encoder's batch norms
  summed over the data group, and the ``ValueError`` of a slab that the
  backbone's strides do not divide (ROADMAP C14);
* the spatial step under ``tpu.remat`` bitwise the step without (the
  recompute repeats the batch-norm sums and halo exchanges);
* ROADMAP C16: the dense backbone at the flagship's widths (phase 19c's
  weights: the npz's PFN and encoder, a seeded backbone, neck and head)
  on a 6.4 x 6.4 m window (a 64 x 64 x 100 grid), its spatial 1 x 2 step
  against one device per leaf: in float32 at 1e-4 of each leaf's
  largest gradient element, and through the float64 instrument
  (``rank_cases.to_float64``) at 1e-6; the instrument changes no float32
  or bfloat16 result by a bit (the tiny step and predict against the
  batch norms, the PFN's max and the head as they were before it);
* a mesh of another size than the world raises ``ValueError``;
* the pipeline at ``data_parallel: 2`` against one device at batch 2,
  step by step (rtol 3e-4, atol 1e-5), with only rank 0 writing files,
  and under ``ckpt_backend: orbax`` rank 0 writing DCP directories alone
  (no hang, within the spawn's time limit);
  ``data_parallel: 2`` x ``spatial_parallel: 2`` trains to finite
  losses;
* ``TiledInference`` with the sharded predict as its ``predict_fn``
  against the one-device one.

Two spawns (worlds of 2 and 4 ranks) serve every test.  The ranks run
``tests/rank_cases.py`` and import torch and the port only.
"""

import os
import types

import numpy as np
import pytest
import torch

from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models import layers
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.parallel import (
    make_sharded_train_step,
    spawn,
)
from objectdetection_3d_tpu_torch.parallel.launch import default_backend
from objectdetection_3d_tpu_torch.scene import make_batch, tree_scene
import rank_cases as rr
from test_torch_port_parked import (
    _assert_predict,
    _dense_backbone_cfg,
    _sparse_cfg,
)
from tiny import tiny_batch

torch.set_num_threads(1)

NPZ = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "overfit_ckpt.npz")

OPT = dict(lr=3e-3, betas=[0.95, 0.99], weight_decay=0.01)
AUGMENT = {"rotate": {"min": 0.0, "max": 6.28}, "flip_x": True,
           "translate": {"std": 0.2}}


def _state(cfg, seed=0):
    """A model state with every batch-norm statistic and affine drawn at
    random (init's would hide a layout error)."""
    model = PointPillars(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.net.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.5)
            elif name.endswith(("running_mean", "bias")) and "bn" in name:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.2)
    model.augment_generator.manual_seed(42)
    return rr.model_state(model)


def _case(kind, mesh, cfg=None, **kw):
    cfg = cfg or configs.tiny_model_cfg()
    return dict(kind=kind, mesh=mesh, device="cpu", cfg=cfg,
                opt=OPT, clip=2.0, **kw)


def _jax_spatial_case(cfg=None, mesh_shape=(2, 4)):
    """Weights drawn by the JAX package, the port's state from them, and
    the JAX package's spatial predict of a batch on its ``mesh_shape``
    mesh (the tiny configuration, or the dict ``cfg`` for both
    packages)."""
    import jax
    from jax.sharding import Mesh

    from objectdetection_3d_tpu.models import PointPillars as JaxPP
    from objectdetection_3d_tpu.parallel import make_spatial_predict_fn
    from objectdetection_3d_tpu_torch.models.weights import (
        from_jax_variables,
    )
    from test_torch_port_model import _random_variables
    from tiny import tiny_model_cfg

    jm = JaxPP(**(cfg or tiny_model_cfg()))
    variables = _random_variables(jm.init_variables(jax.random.PRNGKey(0)))
    batch = tiny_batch(batch_size=2, seed=9)
    n = int(np.prod(mesh_shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape),
                ("data", "space"))
    want = make_spatial_predict_fn(jm, mesh)(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]},
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    model = PointPillars(cfg or configs.tiny_model_cfg(), device="cpu")
    from_jax_variables(model.net, variables)
    return (rr.model_state(model), batch,
            {k: np.asarray(v) for k, v in want.items()})


@pytest.fixture(scope="module")
def jax_spatial():
    return _jax_spatial_case()


# the networks the spatial path runs besides the default one: the gather
# encoder and the dense backbone and neck (tests/test_torch_port_parked.py)
NETWORKS = {"sparse_middle": _sparse_cfg,
            "dense_backbone": _dense_backbone_cfg}


@pytest.fixture(scope="module")
def jax_networks():
    """Each network's weights, batch and JAX spatial predict on a 1 x 2
    mesh."""
    return {name: _jax_spatial_case(cfg(), (1, 2))
            for name, cfg in NETWORKS.items()}


def _pipeline_cfg(root, **pipeline):
    from test_pipeline import make_cfg

    d = make_cfg(root).dump()
    # no TensorBoard: its writer imports TensorFlow, and TensorFlow imports
    # JAX where JAX is installed
    d["pipeline"].update({"max_epoch": 0, "training_batch_size": 1,
                          "validation_batch_size": 1, "tensorboard": False,
                          **pipeline})
    return d


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from test_pipeline import write_scene

    root = tmp_path_factory.mktemp("parallel_ws")
    for split in ("training", "validation", "testing"):
        d = root / "data" / split
        d.mkdir(parents=True)
        for i in range(2):
            write_scene(d, f"{split}_{i}", seed=11 * len(split) + i)
    return root


def _network_cases(mesh, jax_networks, train=False):
    """Each network's spatial predict (and step) on ``mesh``."""
    cases = {}
    for name, cfg in NETWORKS.items():
        state, batch, _ = jax_networks[name]
        cases[f"spatial_predict_{name}"] = _case(
            "predict", mesh, cfg=cfg(), state=state, fn="spatial_predict",
            batch=batch)
        if train:
            cases[f"spatial_train_{name}"] = _case(
                "train", mesh, cfg=cfg(), state=state, spatial=True,
                batch=tiny_batch(batch_size=2, seed=5))
    return cases


def _flagship_dense_backbone_cases():
    """ROADMAP C16's spatial steps: the dense backbone at the flagship's
    widths on a 6.4 x 6.4 m window (H / 2 = 32 keeps its strides, C14),
    16,000 points of three trunks, float32 and float64."""
    cfg = rr.window_cfg(rr.dense_backbone_cfg(configs.flagship_cfg(
        {"compute_dtype": "float32"})), 6.4, 16_384)
    case = _case("train", (1, 2), cfg=cfg, spatial=True,
                 state=rr.dense_backbone_state(cfg, NPZ),
                 batch=make_batch(tree_scene(1, extent=6.4, n_trees=3,
                                             n_points=16_000), 16_384))
    return {"flagship_dense_backbone_float32": case,
            "flagship_dense_backbone_float64": dict(case, float64=True)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, workspace, jax_spatial, jax_networks):
    cfg = configs.tiny_model_cfg()
    state = _state(cfg)
    no_remat = configs.tiny_model_cfg()
    no_remat["tpu"] = dict(no_remat["tpu"], remat=False)
    aug_cfg = dict(configs.tiny_model_cfg(), device_augment=AUGMENT)
    aug_state = _state(aug_cfg)
    j_state, j_batch, _ = jax_spatial
    b4 = tiny_batch(batch_size=4, seed=3)
    scene = np.concatenate([b4["points"][i, :b4["num_points"][i]]
                            + [8.0 * (i % 2), 8.0 * (i // 2), 0, 0]
                            for i in range(4)])
    cases = {
        "train": _case("train", (2, 1), state=state, batch=b4),
        "augment": _case("train", (2, 1), cfg=aug_cfg, state=aug_state,
                         batch=tiny_batch(batch_size=4, seed=7)),
        "accum": _case("train", (2, 1), state=state, microbatch=2,
                       batch=tiny_batch(batch_size=4, seed=11)),
        "eval": _case("predict", (2, 1), state=state, fn="eval",
                      batch=tiny_batch(batch_size=4, seed=22)),
        "predict": _case("predict", (2, 1), state=state, fn="predict",
                         batch=tiny_batch(batch_size=3, seed=21)),
        "spatial_predict": _case("predict", (1, 2), state=j_state,
                                 fn="spatial_predict", batch=j_batch),
        "spatial_train": _case("train", (1, 2), state=state, spatial=True,
                               batch=tiny_batch(batch_size=2, seed=5)),
        "spatial_train_no_remat": _case(
            "train", (1, 2), cfg=no_remat, state=state, spatial=True,
            batch=tiny_batch(batch_size=2, seed=5)),
        **_network_cases((1, 2), jax_networks, train=True),
        **_flagship_dense_backbone_cases(),
        "stat_groups": dict(kind="stat_groups", mesh=(1, 2),
                            device="cpu", cfg=cfg),
        "stat_groups_sparse_middle": dict(
            kind="stat_groups", mesh=(1, 2), device="cpu",
            cfg=_sparse_cfg()),
        "halo": dict(kind="halo", mesh=(1, 2), device="cpu", h=8),
        "batch_norm": dict(kind="batch_norm", mesh=(2, 1), device="cpu"),
        "mismatch": dict(kind="mesh_mismatch", device="cpu"),
        "tiled": _case("tiled", (2, 1), state=j_state, scene=scene,
                       batch_tiles=2),
        "pipeline": dict(
            kind="pipeline", cfg=_pipeline_cfg(workspace, data_parallel=2),
            outputs=[str(workspace / f"dp2_rank{r}") + "/"
                     for r in range(2)]),
        "pipeline_dcp": dict(
            kind="pipeline",
            cfg=_pipeline_cfg(workspace, data_parallel=2, max_epoch=1,
                              ckpt_backend="orbax"),
            outputs=[str(workspace / f"dp2_dcp_rank{r}") + "/"
                     for r in range(2)]),
        "imported": dict(kind="imported"),
    }
    results = spawn(rr.run_cases, 2, tmp_path_factory.mktemp("world2"),
                    args=(list(cases.values()),))
    return {name: ([r[i] for r in results], case)
            for i, (name, case) in enumerate(cases.items())}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, workspace, jax_spatial, jax_networks):
    cfg = configs.tiny_model_cfg()
    j_state, j_batch, _ = jax_spatial
    cases = {
        "spatial_predict": _case("predict", (2, 2), state=j_state,
                                 fn="spatial_predict", batch=j_batch),
        **_network_cases((2, 2), jax_networks),
        "spatial_train": _case("train", (2, 2), state=_state(cfg, seed=1),
                               spatial=True,
                               batch=tiny_batch(batch_size=2, seed=15)),
        "stat_groups": dict(kind="stat_groups", mesh=(2, 2),
                            device="cpu", cfg=cfg),
        "pipeline": dict(
            kind="pipeline",
            cfg=_pipeline_cfg(workspace, data_parallel=2,
                              spatial_parallel=2),
            outputs=[str(workspace / f"dp2sp2_rank{r}") + "/"
                     for r in range(4)]),
    }
    results = spawn(rr.run_cases, 4, tmp_path_factory.mktemp("world4"),
                    args=(list(cases.values()),))
    return {name: ([r[i] for r in results], case)
            for i, (name, case) in enumerate(cases.items())}


def _check_step(ranks, case):
    want = rr.train({k: v for k, v in case.items() if k != "spatial"})
    rr.check_step(ranks, want, OPT["lr"])
    return want


_check_preds = rr.check_preds


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def test_data_parallel_step_matches_one_device(world2):
    ranks, case = world2["train"]
    want = _check_step(ranks, case)
    assert want["losses"]["num_pos"] > 0


def test_data_parallel_step_draws_device_augment_as_one_device(world2):
    ranks, case = world2["augment"]
    want = _check_step(ranks, case)
    assert torch.equal(ranks[0]["state"]["augment"],
                       want["state"]["augment"])
    assert not torch.equal(want["state"]["augment"],
                           case["state"]["augment"])


def test_accumulation_matches_one_device_accumulation(world2):
    _check_step(*world2["accum"])


def test_indivisible_microbatch_raises():
    model = PointPillars(configs.tiny_model_cfg(), device="cpu")
    tx = model.get_optimizer(OPT, grad_clip_value=2.0)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_train_step(model, tx, types.SimpleNamespace(n_data=2),
                                microbatch=3)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_spatial_step_matches_one_device(world, request):
    ranks, case = request.getfixturevalue(world)["spatial_train"]
    _check_step(ranks, case)


def test_spatial_step_with_remat_is_bitwise_the_step_without(world2):
    """``tpu.remat`` recomputes the encoder and the RPN in the backward,
    their batch-norm sums and halo exchanges included: every rank's
    collectives pair up (the spawn's time limit holds a hang), and the
    step is bitwise the one without."""
    with_remat, _ = world2["spatial_train"]
    without, case = world2["spatial_train_no_remat"]
    assert case["cfg"]["tpu"]["remat"] is False
    for got, want in zip(with_remat, without):
        assert got["losses"] == want["losses"]
        for part in ("grads", "state"):
            src = want[part]["net"] if part == "state" else want[part]
            dst = got[part]["net"] if part == "state" else got[part]
            assert list(dst) == list(src)
            for k, v in src.items():
                assert torch.equal(dst[k], v), (part, k)


@pytest.mark.parametrize("network", NETWORKS)
def test_spatial_step_of_other_networks_matches_one_device(world2, network):
    _check_step(*world2[f"spatial_train_{network}"])


@pytest.mark.parametrize("precision, rtol", [("float32", rr.GRAD_RTOL),
                                             ("float64", 1e-6)])
def test_flagship_width_dense_backbone_split_step_per_leaf(world2,
                                                           precision, rtol):
    """ROADMAP C16: the dense backbone's spatial step at the flagship's
    widths against one device, each gradient within ``rtol`` of its
    leaf's largest element; through the float64 instrument the split
    does one device's arithmetic to 1e-6 of every leaf."""
    ranks, case = world2[f"flagship_dense_backbone_{precision}"]
    want = rr.train({k: v for k, v in case.items() if k != "spatial"})
    assert want["losses"]["num_pos"] > 0
    dtype = getattr(torch, precision)
    assert all(g.dtype == dtype for g in want["grads"].values())
    rr.check_step(ranks, want, OPT["lr"],
                  grad_tol=rr.leaf_tol(want, rtol))


# the batch norms' statistics, the PFN's max and the head's output type
# as they were before the float64 instrument (float32 fixed)
def _stats_before(self, x, mask):
    if not self.training:
        return self.running_mean, self.running_var
    m = mask.to(torch.float32)
    xf = x.float()
    dims = [d for d in range(x.dim()) if d != 1]
    if self.stats_sum is None:
        count = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(dim=dims) / count
        var = (((xf - layers._bcast(mean, x.dim(), torch.float32)) ** 2)
               * m).sum(dim=dims) / count
    else:
        tot = self.stats_sum(torch.cat([(xf * m).sum(dim=dims),
                                        m.sum()[None]]))
        count = torch.clamp(tot[-1], min=1.0)
        mean = tot[:-1] / count
        var = self.stats_sum(
            (((xf - layers._bcast(mean, x.dim(), torch.float32)) ** 2)
             * m).sum(dim=dims)) / count
    if self._moves_running():
        self._update_running(mean.detach(), var.detach(), count)
    return mean, var


def _point_bn_before(self, x, pt_valid, total_slots):
    m = pt_valid.to(torch.float32)[:, None]
    if self.training:
        xf = x.float()
        if self.stats_sum is None:
            count = torch.clamp(total_slots.to(torch.float32), min=1.0)
            mean = (xf * m).sum(dim=0) / count
            n_real = m.sum()
            centred = (((xf - mean) ** 2) * m).sum(dim=0)
        else:
            tot = self.stats_sum(torch.cat([
                (xf * m).sum(dim=0), total_slots.to(torch.float32)[None],
                m.sum()[None]]))
            count = torch.clamp(tot[-2], min=1.0)
            mean = tot[:-2] / count
            n_real = tot[-1]
            centred = self.stats_sum((((xf - mean) ** 2) * m).sum(dim=0))
        var = (centred + (count - n_real) * mean ** 2) / count
        if self._moves_running():
            self._update_running(mean.detach(), var.detach(), count)
    else:
        mean, var = self.running_mean, self.running_var
    dt = x.dtype
    mean_t = mean.to(dt)
    inv = torch.rsqrt(var + self.eps).to(dt)
    scale, bias = self.weight.to(dt), self.bias.to(dt)
    y = (x - mean_t) * inv
    y = y * scale + bias
    pad_y = (torch.zeros_like(mean_t) - mean_t) * inv * scale + bias
    return y * m.to(dt), pad_y


def _pfn_before(self, x, seg, pt_valid, counts, total_slots):
    y = torch.nn.functional.linear(x.to(self.dtype),
                                   self.linear.weight.to(self.dtype))
    y, pad_y = self.norm(y, pt_valid, total_slots)
    y = torch.relu(y)
    floor = torch.relu(pad_y)
    units = y.shape[1]
    vals = torch.where(pt_valid[:, None], y.float(),
                       torch.full_like(y, float("-inf"),
                                       dtype=torch.float32))
    pooled = torch.full((counts.shape[0], units), float("-inf"),
                        dtype=torch.float32, device=y.device)
    pooled = pooled.scatter_reduce_(
        0, seg.long()[:, None].expand(-1, units), vals, "amax")
    pooled = pooled.to(y.dtype)
    return torch.where(counts[:, None] < self.max_slots,
                       torch.maximum(pooled, floor[None, :]), pooled)


def _head_before(self, x):
    dt = self.dtype
    x = x.to(dt)
    outs = []
    for conv in (self.conv_cls, self.conv_reg, self.conv_dir):
        y = torch.nn.functional.conv2d(x, conv.weight.to(dt),
                                       conv.bias.to(dt))
        outs.append(y.float().permute(0, 2, 3, 1))
    return tuple(outs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("network", ["default", "dense_backbone"])
def test_float64_instrument_changes_no_float32_or_bf16_bit(
        monkeypatch, network, dtype):
    """The tiny step (losses, gradients, parameters, running statistics)
    and predict, bitwise equal to the same runs with the code the float64
    instrument replaced."""
    cfg = (_dense_backbone_cfg() if network == "dense_backbone"
           else configs.tiny_model_cfg())
    cfg["tpu"] = dict(cfg["tpu"], compute_dtype=dtype)
    step = _case("train", None, cfg=cfg, state=_state(cfg),
                 batch=tiny_batch(batch_size=2, seed=5))
    pred = dict(step, kind="predict", fn="predict")

    def runs():
        return rr.train(step), rr.predict(pred)["preds"]

    after = runs()
    for cls, name, fn in (
            (layers.MaskedBatchNorm, "_stats", _stats_before),
            (layers.PointMaskedBN, "forward", _point_bn_before),
            (layers.PFNLayerPoints, "forward", _pfn_before),
            (layers.Anchor3DHead, "forward", _head_before)):
        monkeypatch.setattr(cls, name, fn)
    before = runs()
    assert after[0]["losses"] == before[0]["losses"]
    for part in ("grads", "state"):
        src = before[0][part] if part == "grads" else before[0][part]["net"]
        dst = after[0][part] if part == "grads" else after[0][part]["net"]
        assert list(dst) == list(src)
        for k, v in src.items():
            assert dst[k].dtype == v.dtype and torch.equal(dst[k], v), k
    for k, v in before[1].items():
        assert torch.equal(after[1][k], v), k


def test_dense_backbone_needs_slabs_its_strides_keep():
    """H = 16 over 4 space ranks gives slabs of 4 rows, and the tiny
    backbone's strides multiply to 8 (ROADMAP C14)."""
    model = PointPillars(_dense_backbone_cfg(), device="cpu")
    tx = model.get_optimizer(OPT, grad_clip_value=2.0)
    mesh = types.SimpleNamespace(n_data=1, n_space=4, world_group=None,
                                 data_group=None)
    with pytest.raises(ValueError, match="prod\\(layer_strides\\) = 8"):
        make_sharded_train_step(model, tx, mesh, space_axis="space")


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_spatial_step_counts_each_pfn_point_once(world, request):
    """The PFN runs on the same points on every space rank: its batch
    norm sums over the data group only (over data x space it would count
    each point n_space times), the encoder's and the RPN's over every
    rank (each holds its own slab)."""
    ranks, case = request.getfixturevalue(world)["stat_groups"]
    n_data, n_space = case["mesh"]
    for got in ranks:
        assert got["voxel_encoder.pfn_0.norm"] == n_data
        others = [v for k, v in got.items() if "voxel_encoder" not in k]
        assert others and set(others) == {n_data * n_space}


def test_spatial_gather_encoder_sums_over_the_data_group(world2):
    """The gather encoder runs whole on every space rank, as the PFN
    does: its batch norms sum over the data group, the RPN's over every
    rank."""
    for got in world2["stat_groups_sparse_middle"][0]:
        for k, v in got.items():
            whole = "voxel_encoder" in k or "pseudoimage_generator" in k
            assert v == (1 if whole else 2), k


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_spatial_step_assigns_over_every_anchor(world, request):
    """A GT's best anchor is a maximum over all of H: each rank assigns
    over the whole anchor grid and keeps its slab's rows, so the
    positive count is one device's exactly."""
    ranks, case = request.getfixturevalue(world)["spatial_train"]
    want = rr.train(case)["losses"]["num_pos"]
    assert want > 0
    assert [got["losses"]["num_pos"] for got in ranks] == [want] * len(
        ranks)


# ---------------------------------------------------------------------------
# eval and predict
# ---------------------------------------------------------------------------
def test_sharded_eval_matches_one_device(world2):
    ranks, case = world2["eval"]
    want = rr.predict(case)
    for got in ranks:
        for k in want["losses"]:
            np.testing.assert_allclose(got["losses"][k], want["losses"][k],
                                       err_msg=k, **rr.LOSS_TOL)
        _check_preds(got["preds"], want["preds"])


def test_sharded_predict_matches_one_device(world2):
    ranks, case = world2["predict"]
    want = rr.predict(case)["preds"]
    for got in ranks:
        assert got["preds"]["bbox"].shape[0] == 3   # padded to 4, cut
        _check_preds(got["preds"], want)
        assert torch.equal(got["preds"]["valid"], want["valid"])


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_spatial_predict_matches_one_device_and_jax(world, request,
                                                    jax_spatial):
    ranks, case = request.getfixturevalue(world)["spatial_predict"]
    want = rr.predict(case)["preds"]
    assert want["valid"].any()
    for got in ranks:
        _check_preds(got["preds"], want)
        _check_preds(got["preds"], jax_spatial[2])


@pytest.mark.parametrize("network", NETWORKS)
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_spatial_predict_of_other_networks_matches_one_device_and_jax(
        world, network, request, jax_networks):
    """The gather encoder and the dense backbone on 1 x 2 and 2 x 2
    meshes against one device and the JAX package's spatial predict:
    boxes 1e-4, scores 1e-5, labels and valid exact."""
    ranks, case = request.getfixturevalue(world)[
        f"spatial_predict_{network}"]
    want = rr.predict(case)["preds"]
    for got in ranks:
        _assert_predict(got["preds"], want)
        _assert_predict(got["preds"], jax_networks[network][2])


def test_tiled_inference_with_the_sharded_predict(world2):
    ranks, case = world2["tiled"]
    want = rr.tiled(case)
    assert len(want["bbox"]) > 0
    for got in ranks:
        _check_preds(got, want)


# ---------------------------------------------------------------------------
# the collectives, the mesh
# ---------------------------------------------------------------------------
def test_halo_exchange_matches_the_unsplit_conv(world2):
    for got in world2["halo"][0]:
        for k, v in got.items():
            assert v <= (0.0 if k.startswith("gather") else 1e-5), (k, v)


def test_global_batch_norm_statistics(world2):
    for got in world2["batch_norm"][0]:
        for k, v in got.items():
            assert v <= 2e-5, (k, v)


def test_ranks_import_nothing_of_jax(world2):
    assert world2["imported"][0] == [[], []]


@pytest.mark.parametrize("device, local_ranks, cards, want", [
    ("cpu", 1, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 1, "gloo")])
def test_default_backend(monkeypatch, device, local_ranks, cards, want):
    """nccl on the cards; gloo on the CPU and where the host's ranks
    outnumber its cards."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_ranks))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert default_backend(device) == want


def test_mesh_of_another_size_than_the_world_raises(world2):
    for got in world2["mismatch"][0]:
        assert got is not None and "world has 2" in got


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def _files(roots):
    """The files under each rank's output path (the config step makes
    the path itself on every rank)."""
    return [[f for _, _, fs in os.walk(r) for f in fs] for r in roots]


def test_pipeline_data_parallel_matches_one_device(world2, workspace):
    from objectdetection_3d_tpu_torch.config import Config
    from objectdetection_3d_tpu_torch.entry import build_pipeline

    ranks, case = world2["pipeline"]
    cfg = _pipeline_cfg(workspace, training_batch_size=2,
                        validation_batch_size=2)
    cfg["global_args"]["output_path"] = str(workspace / "dp1") + "/"
    single, _ = build_pipeline(cfg=Config(cfg))
    single.run_training()
    assert [r["is_main"] for r in ranks] == [True, False]
    assert ranks[0]["mesh"] == {"data": 2, "space": 1}
    for got in ranks:
        assert set(got["losses"]) == set(single.losses)
        for k, v in single.losses.items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=3e-4,
                                       atol=1e-5, err_msg=k)
    written = _files(case["outputs"])
    assert "training_record.csv" in written[0]
    assert any(f.endswith(".pth") for f in written[0])
    assert written[1] == []


def test_pipeline_data_parallel_writes_dcp_checkpoints(world2):
    """``ckpt_backend: orbax``: rank 0 writes each DCP directory alone
    (no collective, so the other rank cannot hang in one; the spawn's
    time limit holds a hang), and they load back."""
    from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io

    ranks, case = world2["pipeline_dcp"]
    assert [r["is_main"] for r in ranks] == [True, False]
    dirs = [os.path.join(d, sub) for d, subs, _ in
            os.walk(case["outputs"][0]) for sub in subs
            if sub.endswith(".dcp")]
    assert {"ckpt_00000.dcp", "ckpt_00001.dcp"} <= {
        os.path.basename(d) for d in dirs}
    for d in dirs:
        payload = ckpt_io.load_ckpt(d)
        assert payload["optimizer_state_dict"]["state"]
    assert _files(case["outputs"][1:]) == [[]]


def test_pipeline_data_and_spatial_parallel_trains(world4):
    ranks, case = world4["pipeline"]
    assert ranks[0]["mesh"] == {"data": 2, "space": 2}
    for got in ranks:
        for vals in got["losses"].values():
            assert len(vals) > 0 and np.all(np.isfinite(vals))
    written = _files(case["outputs"])
    assert "training_record.csv" in written[0]
    assert written[1:] == [[], [], []]
