"""The port's gradient-accumulation step and eval step against the JAX
package, float32 on the CPU.

The accumulation cases are those of ``tests/test_train_accum.py``, held
against the JAX package's own steps and its sequential oracle
(``oracle_accum_step``) from the same variables and a fresh optimizer:

* one chunk (``microbatch == B``) against the JAX monolithic step;
* two chunks against the oracle;
* two chunks, the second with no GT box (zero positives): the pooled
  normalization, not a mean of the chunks' means;
* a batch that ``microbatch`` does not divide raises ``ValueError``.

Tolerances, as for one monolithic step (``test_torch_port_train.py``):
losses 1e-4; the pooled gradient the update receives, before its clip,
rtol 1e-4 of each leaf's largest element; running statistics, and every
parameter whose gradient lies above that gradient tolerance, rtol 1e-4
with atol 1e-5.  AdamW's first step moves an element by lr * g / (|g| +
1e-8), so where |g| lies below the gradient tolerance (float32 sums in
another order set its size, e.g. 1.1e-7 against 1.3e-6 in a leaf whose
largest element is 9.5) the two updates differ by up to 2 lr: those
elements are held within 2 lr.

The eval step (one eval forward: losses and decoded detections): losses
1e-4; detections as the predict parity (``test_torch_port_model.py``):
valid masks and labels exact, boxes atol 1e-4, scores atol 1e-5.
``inference_end`` unpads them as the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.weights import (
    _port_to_leaf,
    from_jax_variables,
    to_jax_variables,
)
from test_torch_port_model import _leaves, _random_variables
from test_train_accum import fresh_state, make_tx, oracle_accum_step
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4
OPT = dict(lr=3e-3, betas=[0.95, 0.99], weight_decay=0.01)


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxPointPillars(**tiny_model_cfg())
    return jm, _random_variables(jm.init_variables(jax.random.PRNGKey(0)))


def _port(variables):
    tm = PointPillars(configs.tiny_model_cfg(), device="cpu")
    from_jax_variables(tm.net, variables)
    return tm


def _recording_tx(tm, store):
    """The port's optimizer, recording the gradients its step receives
    (before its clip) as flax leaves into ``store``."""
    tx = tm.get_optimizer(OPT, grad_clip_value=2.0)
    update = tx.step

    def step(closure=None):
        for name, p in tm.net.named_parameters():
            _, path, arr = _port_to_leaf(name, p.grad.numpy().copy())
            store[path] = arr
        return update(closure)

    tx.step = step
    return tx


def _jax_pooled_grads(jm, variables, batch, microbatch):
    """The pooled gradient of the oracle: chunk gradients times
    max(n_i, 1), summed, over max(sum n_i, 1)."""
    bs = variables["batch_stats"]
    acc, n_total = None, 0.0
    for s in range(0, batch["points"].shape[0], microbatch):
        mb = {k: v[s:s + microbatch] for k, v in batch.items()}

        def closure(params, bs=bs, mb=mb):
            outs, new_bs = jm.apply({"params": params, "batch_stats": bs},
                                    mb, train=True)
            losses, n_pos = jm.loss(outs, mb, with_num_pos=True)
            return sum(losses.values()), (n_pos, new_bs)

        g, (n_pos, bs) = jax.jit(jax.grad(closure, has_aux=True))(
            variables["params"])
        avg = jnp.maximum(n_pos, 1.0)
        g = jax.tree.map(lambda x: x * avg, g)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        n_total = n_total + n_pos
    af = jnp.maximum(n_total, 1.0)
    return dict(_leaves(jax.tree.map(lambda x: np.asarray(x / af), acc)))


def _check_step(tm, got, got_g, want_state, want_losses, want_g, before):
    assert set(got) == set(want_losses) | {"num_pos"}
    for k in want_losses:
        np.testing.assert_allclose(float(got[k]), float(want_losses[k]),
                                   err_msg=k, **LOSS_TOL)
    assert set(got_g) == set(want_g)
    for path, arr in want_g.items():
        scale = float(np.abs(arr).max())
        np.testing.assert_allclose(got_g[path], arr, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=str(path))
    back = to_jax_variables(tm.net)
    for coll in ("params", "batch_stats"):
        want_c = dict(_leaves(jax.tree.map(np.asarray, want_state[coll])))
        got_c = dict(_leaves(back[coll]))
        old = dict(_leaves(before[coll]))
        assert set(got_c) == set(want_c)
        for path, arr in want_c.items():
            assert not np.array_equal(arr, old[path]), path
            if coll == "params":
                g = np.abs(want_g[path])
                sure = g > GRAD_RTOL * float(g.max())
                assert sure.mean() > 0.5, path
                np.testing.assert_array_less(
                    np.abs(got_c[path] - arr)[~sure], 2 * OPT["lr"] + 1e-5)
                got_c[path], arr = got_c[path][sure], arr[sure]
            np.testing.assert_allclose(got_c[path], arr, err_msg=str(path),
                                       **PARAM_TOL)


def test_single_chunk_matches_monolithic_step(jax_model):
    jm, variables = jax_model
    batch = tiny_batch(batch_size=4, seed=3)
    tx = make_tx(jm)
    want_state, want = jm.make_train_step(tx, donate=False)(
        fresh_state(jm, variables, tx), batch)
    want_g = _jax_pooled_grads(jm, variables, batch, 4)

    tm = _port(variables)
    got_g = {}
    got = tm.make_train_step(_recording_tx(tm, got_g), microbatch=4)(batch)
    assert int(got["num_pos"]) == int(tm.assign(batch)["num_pos"].sum()) > 0
    _check_step(tm, got, got_g, want_state, want, want_g, variables)


@pytest.mark.parametrize("zero_gt_chunk", [False, True],
                         ids=["two-chunks", "zero-gt-chunk"])
def test_chunks_match_sequential_oracle(jax_model, zero_gt_chunk):
    """Two chunks of 2; with ``zero_gt_chunk`` the second holds no GT box,
    where a mean of the chunks' means would divide its classification sum
    by 1 instead of the pooled count."""
    jm, variables = jax_model
    batch = tiny_batch(batch_size=4, seed=9 if zero_gt_chunk else 5)
    if zero_gt_chunk:
        batch["gt_mask"][2:] = False
        batch["bboxes"][2:] = 0.0
    tx = make_tx(jm)
    want_state, want = oracle_accum_step(
        jm, tx, fresh_state(jm, variables, tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, microbatch=2)
    want_g = _jax_pooled_grads(jm, variables, batch, 2)

    tm = _port(variables)
    got_g = {}
    got = tm.make_train_step(_recording_tx(tm, got_g), microbatch=2)(batch)
    for k, v in got.items():
        assert np.isfinite(float(v)), k
    if zero_gt_chunk:
        half = {k: v[2:] for k, v in batch.items()}
        assert int(tm.assign(half)["num_pos"].sum()) == 0
    _check_step(tm, got, got_g, want_state, want, want_g, variables)


def test_indivisible_batch_rejected(jax_model):
    _, variables = jax_model
    tm = _port(variables)
    step = tm.make_train_step(tm.get_optimizer(OPT, 2.0), microbatch=3)
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    with pytest.raises(ValueError, match="not divisible"):
        step(tiny_batch(batch_size=4, seed=1))
    after = tm.net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_accumulation_keeps_the_phase_ranges(jax_model):
    _, variables = jax_model
    tm = _port(variables)
    step = tm.make_train_step(tm.get_optimizer(OPT, 2.0), microbatch=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(tiny_batch(batch_size=2, seed=3))
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["forward"] == counts["loss+backward"] == 2
    assert counts["assignment"] == 2 and counts["optimizer"] == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_step_matches_jax(jax_model, seed):
    jm, variables = jax_model
    batch = tiny_batch(batch_size=2, seed=seed)
    batch["item_valid"] = np.array([True, False])
    want_l, want_p = jax.tree.map(
        np.asarray, jm.make_eval_fn()(variables, batch))
    tm = _port(variables)
    got_l, got_p = tm.make_eval_fn()(batch)
    assert not tm.net.training
    assert set(got_l) == set(want_l)
    for k in want_l:
        assert not got_l[k].requires_grad
        np.testing.assert_allclose(float(got_l[k]), float(want_l[k]),
                                   err_msg=k, **LOSS_TOL)
    got_p = {k: v.numpy() for k, v in got_p.items()}
    assert set(got_p) == set(want_p)
    valid = want_p["valid"]
    np.testing.assert_array_equal(got_p["valid"], valid)
    assert valid.sum() >= 2
    np.testing.assert_allclose(got_p["bbox"][valid], want_p["bbox"][valid],
                               atol=1e-4)
    np.testing.assert_allclose(got_p["score"][valid],
                               want_p["score"][valid], atol=1e-5)
    np.testing.assert_array_equal(got_p["label"][valid],
                                  want_p["label"][valid])
    # the eval step decodes as predict does
    pred = tm.predict(batch)
    for k in pred:
        assert torch.equal(pred[k], torch.from_numpy(got_p[k])), k

    want_end = jm.inference_end(want_p)
    got_end = tm.inference_end(got_p)
    got_end_t = tm.inference_end(tm.predict(batch))
    assert [len(c) for c in got_end] == [len(c) for c in want_end] == [
        int(v) for v in valid.sum(axis=1)]
    for cg, cw, ct in zip(got_end, want_end, got_end_t):
        for g, w, t in zip(cg, cw, ct):
            assert g["label"] == w["label"] == t["label"]
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-4)
            np.testing.assert_allclose(g["score"], w["score"], atol=1e-5)
            np.testing.assert_array_equal(g["bbox"], t["bbox"])
