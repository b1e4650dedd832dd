"""What each rank runs when the port's sharded paths are held against
one device: ``parallel.launch.spawn(run_cases, world, dir, args=(cases,))``
runs a list of cases on every rank and returns each rank's results.  The
ranks import this module by name, so its directory must be on
``sys.path`` (``spawn`` hands the parent's to the ranks); it imports
torch and the port only.

A case is a dict: ``kind`` (a key of :data:`CASES`), ``mesh`` (n_data,
n_space), ``device``, and what the kind reads (``cfg``, ``state`` from
:func:`model_state`, ``batch``, ...).  :func:`train` and :func:`predict`
with ``mesh=None`` are the one-device runs the sharded ones are held
against.  Results come back on the host.  ``tests/test_torch_port_
parallel.py``, ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``
phase 19 use these cases and the checks at the end.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.models.layers import (
    MaskedBatchNorm,
    PointMaskedBN,
)
from objectdetection_3d_tpu_torch.ops.assign_geometry import (
    chunk_geometry,
    containment_rescue,
)
from objectdetection_3d_tpu_torch.ops.fused_stage import fused_stage
from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
    intersection_volume_aligned,
    iou_gathered,
    iou_gathered_pair,
)
from objectdetection_3d_tpu_torch.ops.grid_scatter import scatter_to_grid
from objectdetection_3d_tpu_torch.ops.pallas_conv import subm_conv3d
from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan
from objectdetection_3d_tpu_torch.ops.zfold_conv import conv2d_3x3
from objectdetection_3d_tpu_torch.parallel import collectives
from objectdetection_3d_tpu_torch.parallel.data_parallel import (
    make_mesh,
    make_mesh_2d,
    make_sharded_eval_fn,
    make_sharded_predict_fn,
    make_sharded_train_step,
    make_spatial_predict_fn,
    world_size,
)

KERNELS = (postsort_scan, scatter_to_grid, chunk_geometry,
           containment_rescue, intersection_volume_aligned, iou_gathered,
           iou_gathered_pair, fused_stage, conv2d_3x3, subm_conv3d)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0
    conv2d_3x3.dx_launches = 0


def launches():
    """{kernel wrapper name: launches since :func:`reset_launches`}, K9's
    dx launches counted with its forward ones."""
    out = {fn.__name__: fn.launches for fn in KERNELS}
    out["conv2d_3x3"] += conv2d_3x3.dx_launches
    return out


def host(x):
    """Tensors (in dicts, lists and tuples) moved to the CPU."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    return x


def model_state(model):
    """The net's parameters and running statistics, and the device
    augmentation generator's state, on the host."""
    return {"net": host(model.net.state_dict()),
            "augment": model.augment_generator.get_state()}


def load_model(cfg, device, state):
    model = PointPillars(cfg, device=device)
    model.net.load_state_dict(state["net"])
    model.augment_generator.set_state(state["augment"])
    return model


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train(case, mesh=None):
    """One train step (``case["microbatch"]``, ``case["spatial"]``) from
    ``case["state"]`` on ``case["batch"]``, AdamW from ``case["opt"]`` with
    ``case["clip"]``.  Returns the losses, the state after the step, the
    gradients the update took (after the clip), the kernel launches of
    the step and its wall ms (the model's first step)."""
    model = load_model(case["cfg"], case["device"], case["state"])
    tx = model.get_optimizer(case["opt"], grad_clip_value=case.get("clip"))
    microbatch = case.get("microbatch")
    if mesh is None:
        step = model.make_train_step(tx, microbatch=microbatch)
    else:
        step = make_sharded_train_step(
            model, tx, mesh, microbatch=microbatch,
            space_axis="space" if case.get("spatial") else None)
    reset_launches()
    t = time.perf_counter()
    losses = step(case["batch"])
    _sync(case["device"])
    ms = (time.perf_counter() - t) * 1e3
    return {"losses": {k: float(v) for k, v in losses.items()},
            "state": model_state(model), "launches": launches(), "ms": ms,
            "grads": {k: host(p.grad) for k, p in
                      model.net.named_parameters() if p.grad is not None}}


def predict(case, mesh=None):
    """``case["fn"]`` (``predict``, ``eval`` or ``spatial_predict``) of
    ``case["batch"]``: the detections (and for ``eval`` the losses) of the
    whole batch, with the kernel launches."""
    model = load_model(case["cfg"], case["device"], case["state"])
    fn = case["fn"]
    if mesh is None:
        run = model.make_eval_fn() if fn == "eval" else model.predict
    elif fn == "eval":
        run = make_sharded_eval_fn(model, mesh)
    elif fn == "spatial_predict":
        run = make_spatial_predict_fn(model, mesh)
    else:
        run = make_sharded_predict_fn(model, mesh)
    reset_launches()
    out = run(case["batch"])
    _sync(case["device"])
    if fn == "eval":
        losses, preds = out
        out = {"losses": {k: float(v) for k, v in losses.items()},
               "preds": host(preds)}
    else:
        out = {"preds": host(out)}
    out["launches"] = launches()
    return out


def tiled(case, mesh=None):
    """``TiledInference`` over ``case["scene"]`` (``batch_tiles``
    ``case["batch_tiles"]``), with the sharded predict on a mesh: the
    scene's detections as ``bbox`` (n, 9), ``label`` (n,) and ``score``
    (n,) arrays."""
    from objectdetection_3d_tpu_torch.pipeline.tiled_inference import (
        TiledInference,
    )

    model = load_model(case["cfg"], case["device"], case["state"])
    fn = None if mesh is None else make_sharded_predict_fn(model, mesh)
    ti = TiledInference(model, overlap=case.get("overlap", 1.0),
                        batch_tiles=case["batch_tiles"], predict_fn=fn)
    dets = ti(case["scene"])
    return {"bbox": np.array([d["bbox"] for d in dets],
                             np.float32).reshape(-1, 9),
            "label": np.array([d["label"] for d in dets], np.int64),
            "score": np.array([d["score"] for d in dets], np.float32)}


def stat_groups(case, mesh):
    """How many ranks each masked batch norm of a spatial step sums its
    statistics over: {module name: ranks}."""
    from objectdetection_3d_tpu_torch.parallel.data_parallel import Shard

    model = PointPillars(case["cfg"], device=case["device"])
    one = torch.ones((1,), device=model.device)
    with Shard(mesh, model, spatial=True).context(model.net):
        return {name: float(m.stats_sum(one))
                for name, m in model.net.named_modules()
                if isinstance(m, MaskedBatchNorm)}


def mesh_mismatch(case, mesh=None):
    """The ``ValueError`` of a mesh one rank larger than the world."""
    try:
        make_mesh(world_size() + 1, device=case["device"])
    except ValueError as e:
        return str(e)
    return None


def halo(case, mesh):
    """The halo exchange on the space group against the unsplit conv: a
    3x3x3 SAME conv of an NCDHW tensor split along H (dim 3) and a 3x3
    conv of an NCHW one (dim 2), forward and the input's gradient, as the
    rows of this rank's slab; and the slabs of a bfloat16 and a float16
    tensor gathered back whole.  Returns the largest differences."""
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    h = case["h"]
    lo, hi = mesh.rows(h, "space")
    out = {}
    for dim, shape, wshape in ((3, (2, 3, 4, h, 5), (4, 3, 3, 3, 3)),
                               (2, (2, 3, h, 5), (4, 3, 3, 3))):
        x = torch.randn(shape, generator=gen)
        w = torch.randn(wshape, generator=gen)
        conv = F.conv3d if dim == 3 else F.conv2d
        pad = (1, 0, 1) if dim == 3 else (0, 1)
        xf = x.clone().requires_grad_()
        yf = conv(xf, w, padding=1)
        ct = torch.randn(yf.shape, generator=gen)
        (yf * ct).sum().backward()
        xs = x.narrow(dim, lo, hi - lo).clone().requires_grad_()
        ys = conv(collectives.halo_rows(xs, dim, mesh.space_group,
                                        mesh.space_index, mesh.n_space),
                  w, padding=pad)
        (ys * ct.narrow(dim, lo, hi - lo)).sum().backward()
        out[f"forward_{dim}d"] = float(
            (ys.detach() - yf.detach().narrow(dim, lo, hi - lo)).abs().max())
        out[f"grad_{dim}d"] = float(
            (xs.grad - xf.grad.narrow(dim, lo, hi - lo)).abs().max())
    # 16-bit floats: every rank's rows gathered bit for bit
    y = torch.randn((2, 3, 4, h, 5), generator=gen)
    for dtype in (torch.bfloat16, torch.float16):
        rows = y.narrow(3, lo, hi - lo).to(dtype)
        got = collectives.all_gather_cat(rows, mesh.space_group, dim=3)
        out[f"gather_{str(dtype)[6:]}"] = max_diff(got.float(),
                                                   y.to(dtype).float())
    return out


def batch_norm(case, mesh):
    """Masked batch norms with their statistics summed over the data
    group against one device's on the whole batch: outputs, the input's
    gradient (this rank's rows), the parameters' gradients (summed over
    the ranks) and the running statistics.  Returns the largest
    differences."""
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    b, c, pts = 4, 6, 20     # items; channels; point rows per item
    lo, hi = mesh.rows(b, "data")
    group = mesh.data_group
    x = torch.randn((b, c, 3, 5, 5), generator=gen) * 2 + 1
    mask = (torch.rand((b, 1, 3, 5, 5), generator=gen) < 0.4).float()
    xp = torch.randn((b * pts, c), generator=gen) * 2 + 1
    valid = torch.rand((b * pts,), generator=gen) < 0.7

    def masked(bn, xx, r):
        return bn(xx * mask[r], mask[r])

    def point(bn, xx, r):
        # each item's points fill 3 voxels of 8 slots
        rows = slice(r.start * pts, r.stop * pts)
        y, pad = bn(xx, valid[rows], torch.tensor((r.stop - r.start) * 24))
        return y + pad

    out = {}
    for tag, make, run, full, per in (
            ("masked", MaskedBatchNorm, masked, x, 1),
            ("point", PointMaskedBN, point, xp, pts)):
        ref, mine = make(c), make(c)
        ref.train()
        mine.train()
        mine.stats_sum = lambda t: collectives.all_reduce_sum(t, group)
        xf = full.clone().requires_grad_()
        yf = run(ref, xf, slice(0, b))
        ct = torch.randn(yf.shape, generator=gen)
        (yf * ct).sum().backward()
        mine_rows = slice(lo * per, hi * per)
        xs = full[mine_rows].clone().requires_grad_()
        ys = run(mine, xs, slice(lo, hi))
        (ys * ct[mine_rows]).sum().backward()
        out[f"{tag}_y"] = max_diff(ys.detach(), yf.detach()[mine_rows])
        out[f"{tag}_dx"] = max_diff(xs.grad, xf.grad[mine_rows])
        for name in ("weight", "bias"):
            g = collectives.sum_(getattr(mine, name).grad.clone(), group)
            out[f"{tag}_d{name}"] = max_diff(g, getattr(ref, name).grad)
        for name in ("running_mean", "running_var"):
            out[f"{tag}_{name}"] = max_diff(getattr(mine, name),
                                            getattr(ref, name))
    return out


def pipeline(case, mesh=None):
    """``run_training`` of the pipeline config ``case["cfg"]`` (a dict in
    the JAX schema; ``case["outputs"][rank]`` is this rank's
    ``output_path``).  Returns the per-step losses and whether this rank
    is the one that writes."""
    import torch.distributed as dist

    from objectdetection_3d_tpu_torch.config import Config
    from objectdetection_3d_tpu_torch.entry import build_pipeline

    cfg = Config(case["cfg"])
    cfg.global_args["output_path"] = case["outputs"][dist.get_rank()]
    pipe, _ = build_pipeline(cfg=cfg)
    record = pipe.run_training()
    return {"losses": {k: list(v) for k, v in pipe.losses.items()},
            "record": record, "is_main": pipe.is_main,
            "mesh": None if pipe.mesh is None else pipe.mesh.shape}


def gloo_probe(case, mesh=None):
    """Which collectives this rank's backend takes for tensors on
    ``case["device"]`` (float32, and ``all_gather`` / ``all_reduce`` in
    other dtypes): {name: "ok" or the error's first line}, and the
    backend's name under ``backend``."""
    import torch.distributed as dist

    dev = torch.device(case["device"])
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank + 1), device=dev)
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // world, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "reduce": lambda: dist.reduce(x.clone(), 0),
        "barrier": lambda: dist.barrier(),
    }
    for dtype in (torch.bfloat16, torch.float16, torch.int16, torch.int32,
                  torch.uint8, torch.bool):
        y = x.to(dtype)
        probes[f"all_gather_{str(dtype)[6:]}"] = (
            lambda y=y: dist.all_gather(
                [torch.empty_like(y) for _ in range(world)], y))
        probes[f"all_reduce_{str(dtype)[6:]}"] = (
            lambda y=y: dist.all_reduce(y.clone()))
    out = {"backend": dist.get_backend()}
    for name, fn in probes.items():
        try:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:  # what the backend refuses, reported
            out[name] = str(e).splitlines()[0][:160]
        dist.barrier()
    return out


def imported(case, mesh=None):
    """The modules of JAX or of the JAX package this rank has imported."""
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                         "objectdetection_3d_tpu"))


CASES = {"train": train, "predict": predict, "tiled": tiled,
         "mesh_mismatch": mesh_mismatch, "halo": halo,
         "batch_norm": batch_norm, "pipeline": pipeline,
         "imported": imported, "gloo_probe": gloo_probe,
         "stat_groups": stat_groups}
NO_MESH = ("mesh_mismatch", "pipeline", "imported", "gloo_probe")


def run_cases(rank, cases):
    """Every case of ``cases`` on this rank, in order; each builds its own
    mesh (``case["mesh"]`` = (n_data, n_space)) on ``case["device"]``
    (``case["exact_fp32"]``: TF32 off from then on)."""
    results = []
    for case in cases:
        if case.get("exact_fp32"):
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        mesh = None
        if case["kind"] not in NO_MESH:
            mesh = make_mesh_2d(*case["mesh"], device=case["device"])
        results.append(CASES[case["kind"]](case, mesh))
        if torch.device(case.get("device", "cpu")).type == "cuda":
            torch.cuda.empty_cache()
    return results


def max_diff(a, b):
    """The largest absolute difference of two equal-shaped arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


# the JAX package's tolerances for sharded against one-device training
# (tests/test_parallel.py), and the gradients' of the port's step tests
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_RTOL = 1e-4     # of each parameter's largest gradient element
# a bf16 step against a bf16 step: its gradients and batch statistics are
# sums of bf16 products rounded to bf16; the one-device whole and each
# rank's part round apart, and the parts' sum once more
BF16_ULPS = 4


def bf16_ulp(x):
    """bfloat16's unit in the last place at the magnitude ``x`` (8
    significant bits: 2^(floor(log2 x) - 7)); 0 at 0."""
    x = np.abs(np.asarray(x, np.float64))
    with np.errstate(divide="ignore"):
        return np.where(x > 0, 2.0 ** (np.floor(np.log2(x)) - 7), 0.0)


def check_step(ranks, want, lr, bf16_start=None, grad_scale="leaf"):
    """Hold every rank's :func:`train` result against the one-device
    ``want``: losses at ``LOSS_TOL``; each gradient the update took
    within ``GRAD_RTOL`` of its parameter's largest gradient element
    (``grad_scale="step"``: of the step's largest gradient element, for
    a float32 step whose small leaves are sums that nearly cancel);
    parameters and running statistics at ``PARAM_TOL``, but within 2 lr
    (and the values' float32 rounding) where the gradient lies within its
    tolerance of 0 (AdamW's first step moves an element by lr * g / (|g|
    + 1e-8), so there it follows the summation order's rounding); every
    rank's state bitwise equal.

    With ``bf16_start`` (the state before a bf16 step) what the step
    computes in bf16 is held to ``BF16_ULPS`` bf16 ulps instead: each
    loss of its own value, each gradient of its leaf's largest element,
    each running statistic of its leaf's largest move in the step.

    Raises ``AssertionError``; returns the largest loss, gradient and
    parameter differences, the largest share of its tolerance that any
    loss, gradient, parameter (with a live gradient, and near 0) and
    running statistic took (``used``), and whether the ranks' parameters
    are bitwise equal to ``want``'s."""
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0,
             "used": {"loss": 0.0, "grad": 0.0, "param": 0.0,
                      "param_near_0": 0.0, "stat": 0.0}}

    def hold(kind, got, ref, tol, what):
        """|got - ref| <= tol elementwise."""
        d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
        tol = np.broadcast_to(np.asarray(tol, np.float64), d.shape)
        if not d.size:
            return
        share = np.where(tol > 0, d / np.where(tol > 0, tol, 1.0),
                         np.where(d > 0, np.inf, 0.0))
        used = float(share.max()) if not np.isnan(share).any() else np.nan
        worst["used"][kind] = max(worst["used"][kind], used)
        if kind in ("loss", "grad"):
            worst[kind] = max(worst[kind], float(d.max()))
        elif kind.startswith("param"):
            worst["param"] = max(worst["param"], float(d.max()))
        assert used <= 1.0, (f"{what}: {kind} difference {float(d.max())} "
                             f"at {used:.3g} times its tolerance")

    def rel(v, tol):
        return tol["atol"] + tol["rtol"] * np.abs(v)

    step_max = max(float(np.abs(g.numpy()).max(initial=0.0))
                   for g in want["grads"].values())
    for got in ranks:
        assert set(got["losses"]) == set(want["losses"])
        for k, v in want["losses"].items():
            tol = (BF16_ULPS * bf16_ulp(v) if bf16_start is not None
                   else rel(v, LOSS_TOL))
            hold("loss", got["losses"][k], v, tol, k)
        assert set(got["grads"]) == set(want["grads"])
        for k, v in want["state"]["net"].items():
            got_v, v = got["state"]["net"][k].numpy(), v.numpy()
            if k not in want["grads"]:   # running statistics
                if bf16_start is None:
                    tol = rel(v, PARAM_TOL)
                else:
                    move = np.abs(v - bf16_start["net"][k].numpy())
                    tol = BF16_ULPS * bf16_ulp(move.max(initial=0.0))
                hold("stat", got_v, v, tol, k)
                continue
            g, g_want = got["grads"][k].numpy(), want["grads"][k].numpy()
            g_max = (step_max if grad_scale == "step"
                     else np.abs(g_want).max(initial=0.0))
            tol = (BF16_ULPS * bf16_ulp(g_max) if bf16_start is not None
                   else GRAD_RTOL * g_max)
            hold("grad", g, g_want, tol, k)
            live = np.abs(g_want) > tol
            hold("param", got_v[live], v[live], rel(v[live], PARAM_TOL), k)
            # the largest first-step move apart, and each value's rounding
            hold("param_near_0", got_v[~live], v[~live],
                 2 * lr + 2 * np.spacing(np.abs(v[~live])), k)
    first = ranks[0]["state"]
    for other in ranks[1:]:
        for k, v in first["net"].items():
            assert torch.equal(other["state"]["net"][k], v), k
        assert torch.equal(other["state"]["augment"], first["augment"])
    worst["bitwise"] = all(torch.equal(first["net"][k], v)
                           for k, v in want["state"]["net"].items())
    return worst


def check_preds(got, want):
    """Detections against detections: scores within 1e-4, labels exact,
    boxes within 1e-3 (the JAX package's spatial predict test).  Returns
    the largest box and score differences."""
    np.testing.assert_allclose(np.asarray(got["score"]),
                               np.asarray(want["score"]), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got["label"]),
                                  np.asarray(want["label"]))
    np.testing.assert_allclose(np.asarray(got["bbox"]),
                               np.asarray(want["bbox"]), atol=1e-3)
    return {"bbox": max_diff(got["bbox"], want["bbox"]),
            "score": max_diff(got["score"], want["score"])}
