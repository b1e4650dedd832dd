"""The vertical encoder's kernel lowerings (K8, K9, K10) and the aligned
clipper (K5) against the JAX package, float32 on the CPU.

On the CPU the port's wrappers run their plain versions and the JAX
package's kernel gates (TPU only) fall through to its XLA lowerings, so
each test holds the port's routing and plain arithmetic against the JAX
program of the same knobs.

* ``SparseMiddleExtractor`` at the flagship widths (20 -> 20 -> 32 -> 64)
  on a 24x16x16 grid, which gives every stage the flagship's z blocks,
  under each knob set, eval and train (outputs, running statistics and
  gradients): 1e-4 of the largest element.
* The tiny model's predict under each knob set: as
  ``test_torch_port_model.py`` (boxes 1e-4, scores 1e-5, labels and
  valid masks exact).
* One train step with ``zfold_pallas`` against ``jax.grad`` of the JAX
  step with ``zfold_convs``: gradients rtol 1e-4 of each leaf's largest
  element, losses 1e-4.
* K9's custom backward against autograd of ``F.conv2d``: 1e-5.
* K5's plain version against the Pallas kernel's body
  (``_clip_volumes``), run eagerly as ``tests/test_pallas_iou3d.py`` runs
  it: interpret mode jits its ~8k-op graph, whose CPU compile takes
  minutes.  1e-5 of the volume scale, on random pairs, on flagship
  anchors against cloud 0's trees (K5's drive) and on flagship anchors
  against jittered copies of themselves (dense).  The dense pairs are the
  grid's first anchors, within 4 m of its origin: the fan sums signed
  volumes against the origin, so a last-bit difference between XLA's and
  PyTorch's CPU sin/cos (a few of these angles) grows with the squared
  distance, past the gate at 40 m.  The card holds the kernel to the
  plain version over the whole plot.  Farther out both float32 bodies
  are held against a float64 evaluation of the port's body on dense
  pairs 30-56 m from the origin: within 1e-3 of the volume scale, and
  within 2.5e-4 of each other, twice the largest readings over ten seeds
  (4.7e-4 and 1.1e-4; ``python tests/test_torch_port_encoder_kernels.py``
  prints them by distance band).
* Which stages take which kernel, at the flagship's depth, and that no
  knob changes a parameter name.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu.models.layers import (
    SparseMiddleExtractor as JaxExtractor,
)
from objectdetection_3d_tpu.ops.pallas_iou3d import _clip_volumes
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.models import layers
from objectdetection_3d_tpu_torch.models.anchors import Anchor3DRangeGenerator
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.layers import SparseMiddleExtractor
from objectdetection_3d_tpu_torch.models.weights import (
    _port_to_leaf,
    from_jax_variables,
    to_jax_variables,
)
from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
    intersection_volume_aligned,
)
from objectdetection_3d_tpu_torch.ops.iou3d import _clip_chunk
from objectdetection_3d_tpu_torch.ops.zfold_conv import (
    conv2d_3x3,
    conv2d_3x3_plain,
)
from objectdetection_3d_tpu_torch.scene import jittered, tree_scene
from test_torch_port_cuda import _random_pairs
from test_torch_port_model import _leaves, _random_variables
from tiny import tiny_batch, tiny_model_cfg

torch.set_num_threads(1)

WIDTHS = (20, 32, 64)
GRID = (1, 24, 16, 16, 20)          # B, D, H, W, C
REL = 1e-4

# tpu-section knobs, as the detectors read them
KNOBS = {
    "default": {},
    "fused_stages": {"fused_stages": True},
    "pallas_subm_conv": {"pallas_subm_conv": True},
    "zfold_convs": {"zfold_convs": True},
    "zfold_pallas": {"zfold_convs": True, "zfold_pallas": True},
    "all": {"pallas_subm_conv": True, "zfold_convs": True,
            "zfold_pallas": True, "fused_stages": True},
    "decompose_2": {"decompose_convs": 2, "zfold_convs": True,
                    "zfold_pallas": True, "fused_stages": True},
}


def _module_knobs(tpu):
    """tpu-section knobs -> SparseMiddleExtractor fields (both packages)."""
    return dict(decompose_convs=tpu.get("decompose_convs", False),
                pallas_subm=tpu.get("pallas_subm_conv", False),
                zfold_convs=tpu.get("zfold_convs", False),
                zfold_pallas=tpu.get("zfold_pallas", False),
                fused_stages=tpu.get("fused_stages", False))


def _assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, err_msg
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * scale, err_msg=err_msg)


@pytest.fixture(scope="module")
def encoder():
    rng = np.random.default_rng(0)
    b, d, h, w, c = GRID
    mask = (rng.uniform(size=(b, d, h, w)) < 0.3).astype(np.float32)
    grid = rng.normal(0, 1, GRID).astype(np.float32) * mask[..., None]
    jm = JaxExtractor(in_channels=c, out_channels=WIDTHS)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(grid),
                        jnp.asarray(mask), False)
    variables = jax.tree.map(lambda a: np.array(a, np.float32),
                             dict(variables))
    for path, arr in _leaves(variables["batch_stats"]):
        arr[...] = (rng.uniform(0.5, 2.0, arr.shape) if path[-1] == "var"
                    else rng.normal(0, 0.3, arr.shape))
    for path, arr in _leaves(variables["params"]):
        if path[-1] == "scale":
            arr[...] = rng.uniform(0.5, 1.5, arr.shape)
        elif path[-1] == "bias":
            arr[...] = rng.normal(0, 0.2, arr.shape)
    return grid, mask, variables


def _port_encoder(variables, tpu):
    tm = SparseMiddleExtractor(GRID[-1], WIDTHS, **_module_knobs(tpu))
    from_jax_variables(tm, variables)
    return tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_encoder_matches_jax(encoder, knobs, train):
    grid, mask, variables = encoder
    tpu = KNOBS[knobs]
    jm = JaxExtractor(in_channels=GRID[-1], out_channels=WIDTHS,
                      **_module_knobs(tpu))
    rng = np.random.default_rng(7)
    b, d, h, w, _ = GRID
    d_out = SparseMiddleExtractor.out_depth(d, len(WIDTHS))
    cot = rng.normal(0, 1, (b, h, w, WIDTHS[-1] * d_out)).astype(np.float32)

    def jax_out(params):
        return jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        jnp.asarray(grid), jnp.asarray(mask), train,
                        mutable=["batch_stats"] if train else False)

    tm = _port_encoder(variables, tpu).train(train)
    x = torch.from_numpy(grid).permute(0, 4, 1, 2, 3)
    got = tm(x, torch.from_numpy(mask)[:, None]).permute(0, 2, 3, 1)
    if not train:
        (want, _) = jax_out(variables["params"])
        _assert_close(got.detach().numpy(), want)
        return
    (want, _), stats = jax_out(variables["params"])
    _assert_close(got.detach().numpy(), want)
    back = dict(_leaves(to_jax_variables(tm)["batch_stats"]))
    for path, arr in _leaves(jax.tree.map(np.asarray,
                                          stats["batch_stats"])):
        _assert_close(back[path], arr, str(path))

    def loss(params):
        (out, _), _ = jax_out(params)
        return jnp.sum(out * cot)

    want_g = dict(_leaves(jax.tree.map(np.asarray, jax.grad(loss)(
        variables["params"]))))
    (got * torch.from_numpy(cot)).sum().backward()
    for name, p in tm.named_parameters():
        _, path, arr = _port_to_leaf(name, p.grad.numpy())
        _assert_close(arr, want_g[path], name)


# (stage index lists) where the flagship's widths and depth send each
# kernel, by the JAX package's gates
ROUTES = {
    ("fused_stages", False): {"fused_stage": [0, 1, 2]},
    ("fused_stages", True): {},
    ("pallas_subm_conv", False): {"subm_conv3d": [0, 1]},
    ("pallas_subm_conv", True): {},
    ("zfold_convs", False): {},
    ("zfold_pallas", False): {"conv2d_3x3": [0, 1, 2]},
    ("zfold_pallas", True): {"conv2d_3x3": [0, 1, 2]},
    ("all", False): {"fused_stage": [0, 1, 2]},
    ("all", True): {"conv2d_3x3": [0, 1, 2]},
    ("decompose_2", False): {"fused_stage": [2]},
    ("decompose_2", True): {"conv2d_3x3": [2]},
}


@pytest.mark.parametrize("knobs,train", list(ROUTES))
def test_stages_take_the_jax_kernels(monkeypatch, knobs, train):
    """At the flagship's 20 -> 20 -> 32 -> 64 -> 128 -> 196 over D = 100
    (on a 8x8 image): K8 on stages 0-2 in eval, K9 on stages 0-2, K10
    on stages 0-1 in eval, K10 checked before the z-fold."""
    calls = {"fused_stage": [], "subm_conv3d": [], "conv2d_3x3": []}
    depth = {}
    for name in calls:
        real = getattr(layers, name)

        def spy(x, *args, real=real, name=name):
            calls[name].append(x.shape)
            return real(x, *args)

        monkeypatch.setattr(layers, name, spy)
    tm = SparseMiddleExtractor(20, (20, 32, 64, 128, 196),
                               **_module_knobs(KNOBS[knobs])).train(train)
    d = 100
    for i in range(5):
        depth[d] = i
        d = (d - 3) // 2 + 1
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(
        (rng.uniform(size=(1, 1, 100, 8, 8)) < 0.3).astype(np.float32))
    grid = torch.from_numpy(rng.normal(0, 1, (1, 20, 100, 8, 8)).astype(
        np.float32)) * mask
    with torch.no_grad():
        out = tm(grid, mask)
    assert tuple(out.shape) == (1, 392, 8, 8)
    stages = {}
    for name, shapes in calls.items():
        if name == "conv2d_3x3":
            # folded (N, H, W, (zb+2)C): N = ceil(D / zb) per stage
            ids = {(25, 120): 0, (13, 120): 1, (12, 128): 2}
            got = [ids[(s[0], s[-1])] for s in shapes]
        else:
            got = [depth[s[1]] for s in shapes]
        if got:
            stages[name] = got
    assert stages == ROUTES[(knobs, train)]


def test_knobs_change_no_parameter_name():
    def shapes(tpu):
        cfg = configs.tiny_model_cfg()
        cfg["tpu"] = dict(cfg["tpu"], **tpu)
        net = PointPillars(cfg, device="cpu").net
        return {k: tuple(v.shape) for k, v in net.state_dict().items()}

    want = shapes({})
    for name, tpu in KNOBS.items():
        assert shapes(tpu) == want, name


@pytest.fixture(scope="module")
def tiny_variables():
    jm = JaxPointPillars(**tiny_model_cfg())
    return _random_variables(jm.init_variables(jax.random.PRNGKey(0)))


def _models(variables, tpu_jax, tpu_port):
    cfg = tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], **tpu_jax)
    jm = JaxPointPillars(**cfg)
    cfg = configs.tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], **tpu_port)
    tm = PointPillars(cfg, device="cpu")
    from_jax_variables(tm.net, variables)
    return jm, tm


@pytest.mark.parametrize("knobs", ["fused_stages", "pallas_subm_conv",
                                   "zfold_pallas", "all"])
def test_tiny_predict_matches_jax_under_knobs(tiny_variables, knobs):
    jm, tm = _models(tiny_variables, KNOBS[knobs], KNOBS[knobs])
    batch = tiny_batch(seed=0)
    want = jax.tree.map(np.asarray,
                        jm.make_predict_fn()(tiny_variables, batch))
    got = {k: v.numpy() for k, v in tm.make_predict_fn()(batch).items()}
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.sum() >= 2
    np.testing.assert_allclose(got["bbox"][valid], want["bbox"][valid],
                               atol=1e-4)
    np.testing.assert_allclose(got["score"][valid], want["score"][valid],
                               atol=1e-5)
    np.testing.assert_array_equal(got["label"][valid], want["label"][valid])


def test_zfold_pallas_train_step_gradients_match_jax(tiny_variables,
                                                     monkeypatch):
    variables = tiny_variables
    jm, tm = _models(variables, {"zfold_convs": True},
                     KNOBS["zfold_pallas"])
    batch = tiny_batch(batch_size=2, seed=1)

    def jax_total(params):
        outs, _ = jm.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, batch,
                           train=True)
        losses = jm.loss(outs, batch, jm.anchors, jm.anchor_aabb)
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        variables["params"])
    want_g = dict(_leaves(jax.tree.map(np.asarray, grads)))

    folds = []
    real = layers.conv2d_3x3
    monkeypatch.setattr(layers, "conv2d_3x3",
                        lambda x, w: folds.append(x.shape) or real(x, w))
    tx = tm.get_optimizer(dict(lr=1e-3), grad_clip_value=2.0)
    got_g = {}
    update = tx.step

    def step_recording_grads(closure=None):
        for name, p in tm.net.named_parameters():
            _, path, arr = _port_to_leaf(name, p.grad.numpy().copy())
            got_g[path] = arr
        return update(closure)

    tx.step = step_recording_grads
    got = tm.make_train_step(tx)(batch)
    assert len(folds) == 1          # the tiny encoder's one stage, folded
    assert set(got_g) == set(want_g)
    for path, arr in want_g.items():
        scale = float(np.abs(arr).max())
        np.testing.assert_allclose(got_g[path], arr, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("shape", [(2, 9, 11, 5, 7), (1, 8, 8, 24, 16)])
def test_conv2d_3x3_gradients_match_autograd_of_conv2d(shape):
    n, h, w, c, co = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 0.2, (3, 3, c, co)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (n, h, w, co)).astype(np.float32))
    xa, ka = x.clone().requires_grad_(), k.clone().requires_grad_()
    ya = conv2d_3x3(xa, ka)
    (ya * g).sum().backward()
    xb, kb = x.clone().requires_grad_(), k.clone().requires_grad_()
    yb = F.conv2d(xb.permute(0, 3, 1, 2), kb.permute(3, 2, 0, 1),
                  padding=1).permute(0, 2, 3, 1)
    (yb * g).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ya.detach().numpy(), yb.detach().numpy(),
                               **tol)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), **tol)
    np.testing.assert_allclose(ka.grad.numpy(), kb.grad.numpy(), **tol)
    np.testing.assert_allclose(conv2d_3x3_plain(x, k).numpy(),
                               yb.detach().numpy(), **tol)


def _flagship_anchors():
    head = configs.flagship_cfg()["head"]
    return Anchor3DRangeGenerator(head["ranges"], head["sizes"],
                                  head["rotations"]).flat_anchors(
                                      (400, 400)).numpy()


def _anchor_pairs(kind):
    """(boxes1, boxes2): 512 pairs of flagship anchors.  ``drive``: box 1
    a tree of ``tree_scene(0)`` (the nearest one in even rows, a random
    one in odd rows), box 2 an anchor within 1 m of a trunk; ``dense``:
    the grid's first anchors against copies shifted by up to 0.4 of their
    size on each axis and turned by up to 0.3 rad about each axis."""
    anchors = _flagship_anchors()
    rng = np.random.default_rng(1)
    if kind == "dense":
        return anchors[:512], jittered(anchors[:512], rng)
    trees = tree_scene(0)[1]
    dist = np.linalg.norm(anchors[:, None, :2] - trees[None, :, :2], axis=-1)
    near = rng.choice(np.nonzero(dist.min(axis=1) < 1.0)[0], 512,
                      replace=False)
    tree = np.where(np.arange(512) % 2 == 0, dist[near].argmin(axis=1),
                    rng.integers(0, len(trees), 512))
    return trees[tree], anchors[near]


@pytest.mark.parametrize("kind", ["random", "drive", "dense"])
def test_aligned_volume_plain_matches_pallas_body(kind):
    if kind == "random":
        rng = np.random.default_rng(3)
        b1, b2 = _random_pairs(rng, 512)
    else:
        b1, b2 = _anchor_pairs(kind)
    with jax.disable_jit():
        want = np.asarray(_clip_volumes(
            [jnp.asarray(b1[:, i]) for i in range(9)],
            [jnp.asarray(b2[:, i]) for i in range(9)]))
    got = intersection_volume_aligned(torch.from_numpy(b1),
                                      torch.from_numpy(b2))
    assert got.dtype == torch.float32 and got.shape == (512,)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    assert (want > 1e-3).sum() > {"random": 100, "drive": 200,
                                  "dense": 400}[kind]


def _dense_errors(lo, hi, seed):
    """Errors of K5's plain version and of the Pallas body (both float32)
    on 512 dense pairs of flagship anchors ``lo``-``hi`` m from the origin
    (numpy ``default_rng(seed)``): {name: max error / volume scale}
    against the port's body in float64 and between the two."""
    anchors = _flagship_anchors()
    dist = np.linalg.norm(anchors[:, :2], axis=1)
    rng = np.random.default_rng(seed)
    b1 = anchors[rng.choice(np.nonzero((dist >= lo) & (dist < hi))[0], 512,
                            replace=False)]
    b2 = jittered(b1, rng)
    with jax.disable_jit():
        pallas = np.asarray(_clip_volumes(
            [jnp.asarray(b1[:, i]) for i in range(9)],
            [jnp.asarray(b2[:, i]) for i in range(9)]))
    plain = intersection_volume_aligned(torch.from_numpy(b1),
                                        torch.from_numpy(b2)).numpy()
    exact = _clip_chunk(torch.from_numpy(b1).double(),
                        torch.from_numpy(b2).double()).numpy()
    assert (exact > 1e-3).sum() > 350
    scale = float(np.abs(exact).max())
    return {"plain": float(np.abs(plain - exact).max()) / scale,
            "pallas": float(np.abs(pallas - exact).max()) / scale,
            "plain_vs_pallas": float(np.abs(plain - pallas).max()) / scale}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_aligned_volume_far_field_against_float64(seed):
    err = _dense_errors(30.0, 60.0, seed)
    assert err["plain"] <= 1e-3 and err["pallas"] <= 1e-3
    assert err["plain_vs_pallas"] <= 2.5e-4


if __name__ == "__main__":
    # the far-field readings: the largest error per distance band over
    # seeds 1-10
    import json

    for lo, hi in ((0.0, 4.0), (10.0, 20.0), (20.0, 30.0), (30.0, 40.0),
                   (40.0, 60.0), (30.0, 60.0)):
        runs = [_dense_errors(lo, hi, seed) for seed in range(1, 11)]
        print(json.dumps({"band_m": [lo, hi], **{
            k: max(r[k] for r in runs) for k in runs[0]}}))
