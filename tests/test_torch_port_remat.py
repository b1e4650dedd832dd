"""``tpu.remat`` in the port: the JAX package's rematerialisation of the
dense vertical encoder and the RPN (``models/network.py``, ``nn.remat``),
as ``torch.utils.checkpoint`` regions, float32 on the CPU.

* The value is checked as the JAX package checks it
  (``tests/test_model.py:297``).
* Every value against ``False``, bitwise: two train steps' losses,
  gradients, parameters and running statistics (the recompute moves no
  running statistic a second time; ``tests/test_model.py:261`` holds the
  JAX variants to 1e-6), the recompute seen to run, the state-dict keys
  unchanged; the accumulation step likewise.
* Every value against the JAX package's step under the same value:
  losses 1e-4, the gradients the update receives within 1e-4 of each
  leaf's largest element, the running statistics after the first step
  and after a second step from the same state at rtol 1e-4, atol 1e-5
  (``tests/test_torch_port_train.py``'s tolerances).
* Eval and predict never checkpoint.

The sharded step with remat is held against the one without in
``tests/test_torch_port_parallel.py`` (gloo, world 2).
"""

import numpy as np
import pytest
import torch

import jax

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models import network
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.weights import (
    _port_to_leaf,
    from_jax_variables,
    to_jax_variables,
)
from test_torch_port_model import _leaves, _random_variables
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

VALUES = [False, True, "all", "middle", "rpn"]
OPT = dict(lr=1e-3, betas=[0.95, 0.99], weight_decay=0.01)
GRAD_RTOL = 1e-4
STAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfg(remat):
    cfg = configs.tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], remat=remat)
    return cfg


def _steps(remat, microbatch=None, n=2):
    """``n`` train steps of a fresh tiny model under ``remat``: each
    step's losses, gradients and state dict, and how often the first
    batch norm of each region ran its forward."""
    model = PointPillars(_cfg(remat), device="cpu")
    calls = {"middle": 0, "rpn": 0}
    for region, mod in (("middle", model.net.pseudoimage_generator.subm_bn_0),
                        ("rpn", model.net.sparse_rpn.bn_0)):
        mod.register_forward_hook(
            lambda *_, r=region: calls.__setitem__(r, calls[r] + 1))
    step = model.make_train_step(
        model.get_optimizer(OPT, grad_clip_value=2.0), microbatch=microbatch)
    out = []
    for s in range(n):
        losses = step(tiny_batch(batch_size=2, seed=s))
        out.append({
            "losses": {k: v.clone() for k, v in losses.items()},
            "grads": {k: p.grad.clone()
                      for k, p in model.net.named_parameters()},
            "state": {k: v.clone()
                      for k, v in model.net.state_dict().items()}})
    return out, calls


@pytest.fixture(scope="module")
def no_remat():
    return {mb: _steps(False, microbatch=mb)[0] for mb in (None, 1)}


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        for part in ("losses", "grads", "state"):
            assert list(g[part]) == list(w[part]), part
            for k, v in w[part].items():
                assert torch.equal(g[part][k], v), (part, k)


def test_invalid_remat_raises():
    cfg = _cfg("encoder")   # not a region's name
    with pytest.raises(ValueError, match="remat"):
        PointPillars(cfg, device="cpu")


@pytest.mark.parametrize("remat", VALUES[1:])
def test_remat_step_is_bitwise_the_step_without(remat, no_remat):
    got, calls = _steps(remat)
    _assert_bitwise(got, no_remat[None])
    regions = network.REMAT_REGIONS[remat]
    # two steps: one forward each, and one recompute in each recomputed
    # region
    for region in ("middle", "rpn"):
        assert calls[region] == (4 if region in regions else 2), region


@pytest.mark.parametrize("remat", [True, "rpn"])
def test_remat_accumulation_step_is_bitwise_the_step_without(remat,
                                                             no_remat):
    _assert_bitwise(_steps(remat, microbatch=1)[0], no_remat[1])


def test_remat_keeps_the_state_dict_keys():
    keys = list(PointPillars(_cfg(False), device="cpu").net.state_dict())
    assert list(PointPillars(_cfg(True), device="cpu").net.state_dict()) \
        == keys
    assert not any("checkpoint" in k for k in keys)


def test_eval_and_predict_never_checkpoint(monkeypatch):
    model = PointPillars(_cfg(True), device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("checkpointed outside training")

    monkeypatch.setattr(network, "checkpoint", refuse)
    batch = tiny_batch(batch_size=1, seed=4)
    model.predict(batch)
    model.make_eval_fn()(batch)
    with torch.no_grad():
        model.apply(batch, train=True)


def _jax_step_fn(jm):
    """(params, stats, batch) -> ((total, (losses, updated batch_stats)),
    gradients) of the JAX package's train-mode forward, jitted."""
    def total(params, stats, batch):
        outs, new = jm.apply({"params": params, "batch_stats": stats},
                             batch, train=True)
        losses = jm.loss(outs, batch, jm.anchors, jm.anchor_aabb)
        return sum(losses.values()), (losses, new)

    return jax.jit(jax.value_and_grad(total, has_aux=True))


def _port_grads(model, tx):
    """Records the gradients the update receives, before its clip, as
    {JAX leaf path: array}."""
    got = {}
    update = tx.step

    def step(closure=None):
        for name, p in model.net.named_parameters():
            _, path, arr = _port_to_leaf(name, p.grad.numpy().copy())
            got[path] = arr
        return update(closure)

    tx.step = step
    return got


@pytest.mark.parametrize("remat", VALUES)
def test_remat_step_matches_jax(remat):
    cfg = tiny_model_cfg()
    cfg["tpu"]["remat"] = remat
    jm = JaxPointPillars(**cfg)
    variables = _random_variables(jm.init_variables(jax.random.PRNGKey(0)))
    tm = PointPillars(_cfg(remat), device="cpu")
    from_jax_variables(tm.net, variables)
    tx = tm.get_optimizer(OPT, grad_clip_value=2.0)
    got_g = _port_grads(tm, tx)
    step = tm.make_train_step(tx)
    params, stats = variables["params"], variables["batch_stats"]
    jax_step = _jax_step_fn(jm)
    for s in range(2):
        batch = tiny_batch(batch_size=2, seed=s + 1)
        (_, (want, new_stats)), want_g = jax_step(params, stats, batch)
        got = step(batch)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        for path, arr in _leaves(jax.tree.map(np.asarray, want_g)):
            scale = float(np.abs(arr).max())
            np.testing.assert_allclose(got_g[path], arr, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * scale,
                                       err_msg=str(path))
        back = to_jax_variables(tm.net)
        got_stats = dict(_leaves(back["batch_stats"]))
        for path, arr in _leaves(jax.tree.map(np.asarray,
                                              new_stats)):
            np.testing.assert_allclose(got_stats[path], arr, **STAT_TOL,
                                       err_msg=str(path))
        # the second step starts from the port's state on both sides
        # (copied: the arrays share the port's memory, which its next step
        # updates in place while JAX may still read them)
        back = jax.tree.map(np.array, back)
        params, stats = back["params"], back["batch_stats"]
