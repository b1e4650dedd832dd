"""The port's training path against the JAX package, float32 on the CPU.

* Training-mode batch norms and their running statistics against flax:
  1e-5 (float32 sums in another order).
* The PFN's segment max and ReLU floor with tied maxima: gradients against
  ``jax.grad``, 1e-5.  Both split a gradient equally among tied maxima.
* K2's autograd against autograd through its plain version: exact.
* ``loss`` on the same head outputs and batch: 1e-5.
* ``ClippedAdamW`` against ``optax.chain(clip, adamw)``: 1e-6.
* One whole train step from the same variables and a fresh optimizer:
  losses 1e-4; the gradients the update receives, before its clip,
  against ``jax.grad`` of the JAX step's loss, leaf by leaf at rtol 1e-4
  of the leaf's largest element; updated parameters and running
  statistics rtol 1e-4, with atol 1e-5, 1% of the learning rate.  Adam's
  first step moves each element by lr * g / (|g| + 1e-8): about +-lr for
  every gradient well above 1e-8, so the updated parameters see only the
  gradients' signs, and the gradient check sees their sizes.
* The step's profiler phase ranges, and how ``profile_train`` charges
  device time to them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu.models.layers import (
    MaskedBatchNorm as JaxMaskedBatchNorm,
)
from objectdetection_3d_tpu.models.layers import (
    PFNLayerPoints as JaxPFNLayerPoints,
)
from objectdetection_3d_tpu.models.layers import PointMaskedBN as JaxPointBN
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models.detector import (
    ClippedAdamW,
    PointPillars,
)
from objectdetection_3d_tpu_torch.models.layers import (
    MaskedBatchNorm,
    PFNLayerPoints,
    PointMaskedBN,
)
from objectdetection_3d_tpu_torch.models.weights import (
    _port_to_leaf,
    from_jax_variables,
    to_jax_variables,
)
from objectdetection_3d_tpu_torch.ops.grid_scatter import (
    scatter_to_grid,
    scatter_to_grid_plain,
)
from objectdetection_3d_tpu_torch.profile_train import (
    PHASES,
    phase_device_ms,
    phase_kernel_ms,
)
from test_torch_port_model import _leaves, _random_variables
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

BN_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4


def _bn_vars(rng, c):
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.2, c).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                            "var": rng.uniform(0.5, 2, c).astype(np.float32)}}


def _load_bn(bn, v):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))


def _assert_stats(bn, stats):
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **BN_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), **BN_TOL)


@pytest.mark.parametrize("eps,momentum", [(1e-5, 0.1), (1e-3, 0.01)])
def test_masked_batch_norm_train_matches_flax(eps, momentum):
    rng = np.random.default_rng(0)
    c = 6
    x = rng.normal(1.0, 2.0, (2, 5, 7, 9, c)).astype(np.float32)
    mask = (rng.uniform(size=(2, 5, 7, 9, 1)) > 0.6).astype(np.float32)
    x = x * mask
    v = _bn_vars(rng, c)
    want, mut = JaxMaskedBatchNorm(eps=eps, momentum=momentum).apply(
        v, jnp.asarray(x), jnp.asarray(mask), True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(c, eps=eps, momentum=momentum)
    _load_bn(bn, v)
    bn.train()
    # the port is channels-first: NDHWC -> NCDHW
    got = bn(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
             torch.from_numpy(mask).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(want), **BN_TOL)
    _assert_stats(bn, mut["batch_stats"])


def test_point_masked_bn_train_matches_flax():
    rng = np.random.default_rng(1)
    c = 5
    x = rng.normal(0.5, 1.5, (40, c)).astype(np.float32)
    valid = rng.uniform(size=40) > 0.3
    x = x * valid[:, None]
    total = np.int32(64)     # 8 valid voxels x 8 slots > 27 valid points
    v = _bn_vars(rng, c)
    (want, want_pad), mut = JaxPointBN(eps=1e-3, momentum=0.01).apply(
        v, jnp.asarray(x), jnp.asarray(valid), jnp.asarray(total), True,
        mutable=["batch_stats"])
    bn = PointMaskedBN(c, eps=1e-3, momentum=0.01)
    _load_bn(bn, v)
    bn.train()
    got, got_pad = bn(torch.from_numpy(x), torch.from_numpy(valid),
                      torch.tensor(total))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **BN_TOL)
    np.testing.assert_allclose(got_pad.detach().numpy(),
                               np.asarray(want_pad), **BN_TOL)
    _assert_stats(bn, mut["batch_stats"])


def test_pfn_tied_maxima_split_gradients_like_jax():
    """Voxels whose pooled value ties between points (duplicate points)
    and with the padding-slot floor (all-zero point features give exactly
    ``pad_y``): the gradient is split among the tied maxima as
    ``jax.grad`` splits it."""
    rng = np.random.default_rng(2)
    cin, units, slots = 4, 6, 4
    counts = np.array([3, 4, 2, 1, 0], np.int32)
    seg = np.repeat(np.arange(5), counts).astype(np.int32)
    n = len(seg)
    x = rng.normal(0, 1, (n, cin)).astype(np.float32)
    x[1] = x[0]                  # a duplicate point in voxel 0
    x[3:5] = x[5]                # three identical points in voxel 1
    x[7] = 0.0                   # voxel 2: a point at the floor value
    valid = np.ones(n, bool)
    total = np.int32(4 * slots)
    v = {"params": {"linear": {"kernel": rng.normal(
        0, 1, (cin, units)).astype(np.float32)}, "norm": _bn_vars(
            rng, units)["params"]},
         "batch_stats": {"norm": _bn_vars(rng, units)["batch_stats"]}}
    cot = rng.normal(0, 1, (5, units)).astype(np.float32)
    jmod = JaxPFNLayerPoints(units=units, max_slots=slots)

    def jloss(params, xs):
        out, _ = jmod.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xs,
                            jnp.asarray(seg), jnp.asarray(valid),
                            jnp.asarray(counts), jnp.asarray(total), 5, True,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(v["params"],
                                                     jnp.asarray(x))
    layer = PFNLayerPoints(cin, units, slots)
    with torch.no_grad():
        layer.linear.weight.copy_(torch.from_numpy(
            v["params"]["linear"]["kernel"].T))
    _load_bn(layer.norm, {"params": v["params"]["norm"],
                          "batch_stats": v["batch_stats"]["norm"]})
    layer.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt, torch.from_numpy(seg), torch.from_numpy(valid),
                torch.from_numpy(counts), torch.tensor(total))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               **BN_TOL)
    np.testing.assert_allclose(layer.linear.weight.grad.numpy().T,
                               np.asarray(want_p["linear"]["kernel"]),
                               **BN_TOL)
    np.testing.assert_allclose(layer.norm.weight.grad.numpy(),
                               np.asarray(want_p["norm"]["scale"]), **BN_TOL)
    np.testing.assert_allclose(layer.norm.bias.grad.numpy(),
                               np.asarray(want_p["norm"]["bias"]), **BN_TOL)
    # the duplicates share their voxel's gradient equally
    np.testing.assert_array_equal(xt.grad[3].numpy(), xt.grad[4].numpy())


def test_grid_scatter_gradient_matches_plain_autograd():
    rng = np.random.default_rng(3)
    b, v, c, grid = 2, 30, 4, (3, 5, 6)
    n = 90
    ids = np.full((b, v), n, np.int32)
    for i, na in enumerate((21, 0)):
        ids[i, :na] = np.sort(rng.choice(n, na, replace=False))
    feats = rng.normal(0, 1, (b, v, c)).astype(np.float32)
    cot = torch.from_numpy(rng.normal(0, 1, (b, *grid, c)).astype(np.float32))
    f1 = torch.from_numpy(feats).requires_grad_(True)
    f2 = torch.from_numpy(feats).requires_grad_(True)
    ids_t = torch.from_numpy(ids)
    g1 = scatter_to_grid(f1, ids_t, grid)
    g2 = scatter_to_grid_plain(f2, ids_t, grid)
    assert torch.equal(g1, g2)
    (g1 * cot).sum().backward()
    (g2 * cot).sum().backward()
    assert torch.equal(f1.grad, f2.grad)
    assert (f1.grad[0, 21:] == 0).all() and (f1.grad[1] == 0).all()
    one = torch.from_numpy(feats[0]).requires_grad_(True)
    (scatter_to_grid(one, ids_t[0], grid) * cot[0]).sum().backward()
    assert torch.equal(one.grad, f1.grad[0])


def test_clipped_adamw_matches_optax():
    rng = np.random.default_rng(4)
    p0 = rng.normal(0, 1, 16).astype(np.float32)
    grads = [rng.normal(0, 3, 16).astype(np.float32) for _ in range(3)]
    tx = optax.chain(optax.clip(2.0), optax.adamw(
        1e-2, b1=0.95, b2=0.99, eps=1e-8, weight_decay=0.01))
    params = jnp.asarray(p0)
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ClippedAdamW([p], grad_clip_value=2.0, lr=1e-2, betas=(0.95, 0.99),
                       eps=1e-8, weight_decay=0.01)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jm = JaxPointPillars(**tiny_model_cfg())
    variables = _random_variables(jm.init_variables(jax.random.PRNGKey(0)))
    tm = PointPillars(configs.tiny_model_cfg(), device="cpu")
    from_jax_variables(tm.net, variables)
    return jm, variables, tm


def test_loss_matches_jax(models):
    jm, _, tm = models
    rng = np.random.default_rng(5)
    batch = tiny_batch(batch_size=2, seed=2)
    batch["item_valid"] = np.array([True, True])
    h, w = tm.featmap
    a = tm.num_anchors
    outs = [rng.normal(0, 1, (2, h, w, a * k)).astype(np.float32)
            for k in (1, 9, 6)]
    outs[1] *= 0.1
    want = jm.loss(tuple(jnp.asarray(o) for o in outs), batch)
    got = tm.loss(tuple(torch.from_numpy(o) for o in outs), batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(want["loss_bbox"]) > 0


def test_one_train_step_matches_jax(models):
    jm, variables, _ = models
    tm = PointPillars(configs.tiny_model_cfg(), device="cpu")
    from_jax_variables(tm.net, variables)
    batch = tiny_batch(batch_size=2, seed=1)
    opt_cfg = dict(lr=1e-3, betas=[0.95, 0.99], weight_decay=0.01)
    tx = jm.get_optimizer(opt_cfg, grad_clip_value=2.0)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"])}
    new_state, want = jm.make_train_step(tx, donate=False)(state, batch)

    def jax_total(params):
        outs, _ = jm.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, batch,
                           train=True)
        return sum(jm.loss(outs, batch, jm.anchors,
                           jm.anchor_aabb).values())

    want_g = dict(_leaves(jax.tree.map(np.asarray, jax.jit(jax.grad(
        jax_total))(variables["params"]))))

    tx = tm.get_optimizer(opt_cfg, grad_clip_value=2.0)
    got_g = {}
    update = tx.step

    def step_recording_grads(closure=None):
        # the gradients as the update receives them, before its clip
        for name, p in tm.net.named_parameters():
            _, path, arr = _port_to_leaf(name, p.grad.numpy().copy())
            got_g[path] = arr
        return update(closure)

    tx.step = step_recording_grads
    step = tm.make_train_step(tx)
    got = step(batch)
    assert set(got_g) == set(want_g)
    for path, arr in want_g.items():
        scale = float(np.abs(arr).max())
        np.testing.assert_allclose(got_g[path], arr, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=str(path))
    assert set(got) == set(want) | {"num_pos"}
    assert int(got["num_pos"]) == int(tm.assign(batch)["num_pos"].sum()) > 0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    back = to_jax_variables(tm.net)
    for coll in ("params", "batch_stats"):
        before = dict(_leaves(variables[coll]))
        want_c = dict(_leaves(jax.tree.map(np.asarray, new_state[coll])))
        got_c = dict(_leaves(back[coll]))
        assert set(got_c) == set(want_c)
        for path, arr in want_c.items():
            assert not np.array_equal(arr, before[path]), path
            np.testing.assert_allclose(got_c[path], arr, rtol=1e-4,
                                       atol=1e-5, err_msg=str(path))

    # the train step leaves predict (eval mode, running statistics) intact
    preds = tm.make_predict_fn()(batch)
    assert bool(torch.isfinite(preds["bbox"]).all())
    assert not tm.net.training
    outs, stats = tm.apply(batch, train=True)
    assert tm.net.training and outs[0].requires_grad
    assert stats["sparse_rpn.bn_0.running_var"] is (
        tm.net.sparse_rpn.bn_0.running_var)


def test_train_step_marks_its_phases(models, tmp_path):
    _, variables, _ = models
    tm = PointPillars(configs.tiny_model_cfg(), device="cpu")
    from_jax_variables(tm.net, variables)
    step = tm.make_train_step(tm.get_optimizer({}, grad_clip_value=2.0))
    batch = tiny_batch(batch_size=1, seed=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(batch)
    names = {e.key for e in prof.key_averages()}
    assert set(PHASES) <= names


def _toy_trace():
    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    return {"traceEvents": [
        ev("user_annotation", "forward", 0, 10),
        ev("user_annotation", "loss+backward", 10, 30),
        ev("user_annotation", "assignment", 12, 5),
        ev("user_annotation", "optimizer", 40, 5),
        ev("gpu_user_annotation", "forward", 3, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=2),
        # launched by the backward's own thread while the caller waits
        ev("cuda_driver", "cuLaunchKernel", 25, 1, corr=3),
        ev("cuda_runtime", "cudaMemsetAsync", 41, 1, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=5),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=6),
        ev("kernel", "k_fwd", 20, 2000, corr=1),
        ev("kernel", "k_assign", 30, 500, corr=2),
        ev("kernel", "k_bwd", 60, 3000, corr=3),
        ev("gpu_memset", "zero", 70, 250, corr=4),
        ev("kernel", "k_after", 80, 1000, corr=5),
        ev("kernel", "k_bwd", 90, 1500, corr=6),
    ]}


def test_phase_device_ms_charges_the_innermost_range_of_each_launch():
    got = phase_device_ms(_toy_trace())
    assert got == {"forward": 2.0, "assignment": 0.5, "loss+backward": 4.5,
                   "optimizer": 0.25, "other": 1.0}


def test_phase_kernel_ms_splits_a_phase_by_kernel():
    trace = _toy_trace()
    assert phase_kernel_ms(trace, "loss+backward") == {"k_bwd": 4.5}
    assert phase_kernel_ms(trace, "optimizer") == {"zero": 0.25}
    assert phase_kernel_ms(trace, "other") == {"k_after": 1.0}
