"""PointPillars detector: voxelizer, anchors, network, losses, target
assignment, the training and eval steps, decode, NMS and the host-side
preprocessing.

Port of the JAX package's ``models/detector.py``: the constructor,
``apply`` (point or buffer PFN path, eval and train), ``loss``,
``get_optimizer``, ``make_train_step`` (one device, with or without
gradient accumulation), ``make_eval_fn``, ``_predict_single``,
``predict``, ``make_predict_fn``, ``inference_end``, ``preprocess`` and
``transform``.
Weights and running statistics live in the ``net`` module; load trained
or JAX-initialised ones with ``models/weights.py``, or draw fresh ones
with ``network.init_parameters``.  The training state is the
module and its optimizer, updated in place by each step (the JAX package
threads a ``{"params", "batch_stats", "opt_state"}`` tree).

Tie order of the candidate top-k: among exactly equal logits the port
takes the lowest anchor index first (:func:`topk_lowest_index`).  The JAX
package's ``_blockwise_topk`` orders exact ties by the rank of their
128-anchor block instead.  Inactive pixels all carry the head bias, so
such ties are common among anchors below ``score_thr``; the two orders
then pick different below-threshold candidates, which NMS never keeps.
"""

import contextlib
import logging
import math

import numpy as np
import torch

from objectdetection_3d_tpu_torch import native
from objectdetection_3d_tpu_torch.augment import (
    ObjdetAugmentation,
    global_outlier_check,
)
from objectdetection_3d_tpu_torch.augment.device_ops import (
    apply_params,
    augment_batch,
    draw_params,
    parse_device_augment_cfg,
)
from objectdetection_3d_tpu_torch.configs import DEFAULT_TPU_CFG
from objectdetection_3d_tpu_torch.losses.losses import (
    CrossEntropyLoss,
    FocalLoss,
    SmoothL1Loss,
)
from objectdetection_3d_tpu_torch.models.anchors import (
    Anchor3DRangeGenerator,
    BBoxCoder,
)
from objectdetection_3d_tpu_torch.models.assign import (
    aabb_and_volume,
    assign_targets,
    make_anchor_layout,
    packed_order_key,
)
from objectdetection_3d_tpu_torch.models.base import BaseModel
from objectdetection_3d_tpu_torch.models.network import (
    PointPillarsNet,
    parse_remat,
)
from objectdetection_3d_tpu_torch.ops.assign_geometry import combo_table
from objectdetection_3d_tpu_torch.ops.boxes import limit_period
from objectdetection_3d_tpu_torch.ops.nms import multiclass_nms
from objectdetection_3d_tpu_torch.ops.voxelize import Voxelizer


log = logging.getLogger(__name__)

# the switches from the JAX package's kernels to its XLA forms (K1, K2,
# K3/K4) and its block prefilter's block (C3): the port always runs its
# kernels, which are bit-exact with those forms, and its one exact top-K;
# the switches warned about so far
_switches_warned = set()


def warn_kernel_switches(tpu_cfg):
    """Warn once for each of the JAX package's kernel switches that
    ``tpu_cfg`` turns off (or sets, for ``assign_prefilter_block``):
    they change nothing in the port (ROADMAP C15)."""
    used = [k for k in ("pallas_voxel_scan", "pallas_grid_scatter")
            if k in tpu_cfg and not bool(tpu_cfg[k])]
    if str(tpu_cfg.get("assign_geometry", "auto")) not in (
            "auto", "pallas", "pallas_interpret"):
        used.append("assign_geometry")
    if "assign_prefilter_block" in tpu_cfg:
        used.append("assign_prefilter_block")
    new = [k for k in used if k not in _switches_warned]
    if new:
        _switches_warned.update(new)
        log.warning("tpu: %s select the JAX package's XLA forms of its "
                    "kernels (or its block prefilter); the port always "
                    "runs its CUDA kernels, bit-exact with those forms, "
                    "and its exact top-K, so they change nothing here "
                    "(ROADMAP C15)", ", ".join(new))


def resolve_device(device="cuda"):
    """The ``torch.device`` to run on: CUDA unless the caller asks for the
    CPU.  Asking for CUDA where none is present raises; the port never
    drops quietly to the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev


def _sharded(shard, net):
    """``shard.context(net)``, or nothing to enter on one device."""
    return contextlib.nullcontext() if shard is None else shard.context(net)


def topk_lowest_index(x, k):
    """Exact top-k of a 1-D tensor, ties broken by the lowest index.

    Returns the k indices ordered by value descending, then index
    ascending: the order of the packed keys (``models/assign.py``), whose
    values are distinct.
    """
    return torch.topk(packed_order_key(x), k).indices


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips every gradient element to
    ``[-grad_clip_value, grad_clip_value]`` (the JAX package's
    ``optax.chain(optax.clip(v), optax.adamw(...))``)."""

    def __init__(self, params, grad_clip_value=None, **kwargs):
        super().__init__(params, **kwargs)
        self.grad_clip_value = grad_clip_value

    def step(self, closure=None):
        if self.grad_clip_value:
            grads = [p for group in self.param_groups
                     for p in group["params"] if p.grad is not None]
            torch.nn.utils.clip_grad_value_(grads, self.grad_clip_value)
        return super().step(closure)


class PointPillars(BaseModel):
    """PointPillars with 9-parameter fully rotated boxes.

    Args:
        cfg: the model configuration dict (``configs.flagship_cfg()`` and
            friends, or the ``model`` section of a ``Config``; the JAX
            package's keyword arguments as one dict).  ``seed`` seeds the
            model's host RNG (``self.rng``), its first weights and
            ``augment_generator``; ``augment`` configures the host
            augmentation of :meth:`preprocess` (its ``ObjectSample`` box
            tests run on ``device``); ``device_augment`` the train steps'
            augmentation of each batch on the device
            (``augment/device_ops.py``), drawn from
            ``augment_generator``.
        device: where the model runs; CUDA unless the caller asks for the
            CPU.  The config's own ``device`` key is not read (the
            pipeline maps it through ``utils.convert_device_name``).
    """

    def __init__(self, cfg, device="cuda"):
        cfg = dict(cfg)
        super().__init__(cfg)
        self.device = resolve_device(device)
        self.point_cloud_range = [float(v) for v in cfg["point_cloud_range"]]
        self.classes = list(cfg.get("classes", ()))
        self.name2lbl = {n: i for i, n in enumerate(self.classes)}
        self.lbl2name = {i: n for i, n in enumerate(self.classes)}
        self.classes_ids = list(range(len(self.classes)))
        self.num_classes = len(self.classes)
        self.input_features = list(cfg.get("input_features", ())) or [0, 1,
                                                                      2, 3]

        self.tpu_cfg = dict(DEFAULT_TPU_CFG)
        self.tpu_cfg.update(dict(cfg.get("tpu") or {}))
        warn_kernel_switches(self.tpu_cfg)
        self.compute_dtype = (
            torch.bfloat16
            if str(self.tpu_cfg["compute_dtype"]) in ("bfloat16", "bf16")
            else torch.float32)

        voxelize = dict(cfg["voxelize"])
        head = dict(cfg["head"])
        self.head_cfg = head
        self.box_params_num = int(head.get("box_params_num", 9))
        self.nms_dim = int(head.get("nms_dim", 3))

        pcr = np.asarray(self.point_cloud_range, np.float64)
        vsize = np.asarray(voxelize["voxel_size"], np.float64)
        gx, gy, gz = np.round((pcr[3:] - pcr[:3]) / vsize).astype(int)
        self.grid_size = (int(gx), int(gy), int(gz))
        self.grid_dhw = (int(gz), int(gy), int(gx))

        max_voxels = min(int(voxelize.get("max_voxels", 10 ** 9)),
                         int(self.tpu_cfg["max_voxels_static"]))
        self.voxel_layer = Voxelizer(
            voxel_size=voxelize["voxel_size"],
            point_cloud_range=self.point_cloud_range,
            max_voxel_points=int(voxelize["max_voxel_points"]),
            max_voxels=max_voxels,
            reflectance_sampling=True,
        )

        self.device_augment = parse_device_augment_cfg(
            cfg.get("device_augment"))
        self.augment_generator = torch.Generator(
            device=self.device).manual_seed(int(cfg.get("seed", 0) or 0))
        self.augmentor = ObjdetAugmentation(dict(cfg.get("augment") or {}),
                                            seed=self.rng,
                                            device=self.device)
        self.anchor_generator = Anchor3DRangeGenerator(
            ranges=head["ranges"], sizes=head["sizes"],
            rotations=head["rotations"], box_params_num=self.box_params_num)
        self.num_anchors = self.anchor_generator.num_base_anchors
        backbone = dict(cfg["backbone"])
        neck = dict(cfg.get("neck") or {})
        self.use_dense_backbone = bool(cfg.get("use_dense_backbone", False))
        _, h, w = self.grid_dhw
        if self.use_dense_backbone:
            # the backbone downsamples by its stage strides and the neck
            # upsamples every scale to one resolution
            strides = [int(v) for v in backbone.get("layer_strides",
                                                    [2, 2, 2])]
            ups = [int(v) for v in neck.get("upsample_strides", [1, 2, 4])]
            factor = int(np.prod(strides)) // ups[-1]
            self.featmap = (h // factor, w // factor)
        else:
            self.featmap = (h, w)
        self.anchors = self.anchor_generator.flat_anchors(self.featmap,
                                                          self.device)
        self.bbox_coder = BBoxCoder()
        # (cells x combos) factorization of the anchor grid, which the
        # assignment's containment and exact anchor tiers need; a grid
        # that does not factor takes the layout-free assignment, over the
        # anchors' axis-aligned boxes
        self.anchor_aabb = None
        try:
            self.anchor_layout = make_anchor_layout(self.anchors,
                                                    self.num_anchors)
            self.combo_tab = combo_table(self.anchor_layout)
        except ValueError:
            self.anchor_layout = self.combo_tab = None
            self.anchor_aabb = aabb_and_volume(self.anchors)

        loss = dict(cfg.get("loss") or {})
        self.loss_cls = FocalLoss(**dict(loss.get("focal", {})))
        self.loss_bbox = SmoothL1Loss(**dict(loss.get("smooth_l1", {})))
        self.loss_dir = CrossEntropyLoss(**dict(loss.get("cross_entropy",
                                                         {})))
        iou_thr = head.get("iou_thr", [[0.08, 0.2]])
        if len(iou_thr) != max(self.num_classes, 1):
            if len(iou_thr) != 1:
                raise ValueError("head.iou_thr needs one pair per class or "
                                 "a single pair")
            iou_thr = iou_thr * max(self.num_classes, 1)
        thr = torch.tensor(iou_thr, dtype=torch.float32).reshape(-1, 2)
        self._neg_thr = thr[:, 0].to(self.device)
        self._pos_thr = thr[:, 1].to(self.device)

        ve_cfg = dict(cfg["voxel_encoder"])
        vertical = dict(cfg["vertical_encoder"])
        sparse_middle = bool(self.tpu_cfg.get("sparse_middle", False))
        # point-granularity PFN: no (V, M, C) buffers (single-layer PFN
        # stacks under the dense encoder, the flagship's shape)
        self.use_point_pfn = (bool(self.tpu_cfg.get("point_pfn", True))
                              and len(ve_cfg["feat_channels"]) == 1
                              and not sparse_middle)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(cfg.get("seed", 0)))
            net = PointPillarsNet(
                grid=self.grid_dhw,
                in_channels=len(self.input_features),
                pfn_channels=tuple(ve_cfg["feat_channels"]),
                voxel_size=tuple(float(v) for v in ve_cfg["voxel_size"]),
                point_cloud_range=tuple(self.point_cloud_range),
                max_slots=self.voxel_layer.max_voxel_points,
                middle_channels=tuple(vertical["out_channels"]),
                middle_in_channels=int(vertical["in_channels"]),
                rpn_channels=tuple(backbone["out_channels"]),
                rpn_layer_nums=tuple(backbone["layer_nums"]),
                num_classes=self.num_classes,
                num_anchors=self.num_anchors,
                box_params_num=self.box_params_num,
                dtype=self.compute_dtype,
                point_pfn=self.use_point_pfn,
                use_dense_backbone=self.use_dense_backbone,
                backbone_strides=tuple(
                    int(v) for v in backbone.get("layer_strides",
                                                 [2, 2, 2])),
                neck_channels=tuple(
                    int(v) for v in neck.get("out_channels", [])),
                neck_upsample_strides=tuple(
                    int(v) for v in neck.get("upsample_strides", [])),
                sparse_middle=sparse_middle,
                sparse_budget=int(self.tpu_cfg.get("sparse_budget", 0)),
                # the vertical encoder's lowering knobs; bool = all
                # stages, int n = the first n stages only
                decompose_convs=self.tpu_cfg.get("decompose_convs", False),
                pallas_subm=bool(self.tpu_cfg.get("pallas_subm_conv", False)),
                zfold_convs=bool(self.tpu_cfg.get("zfold_convs", False)),
                zfold_pallas=bool(self.tpu_cfg.get("zfold_pallas", False)),
                fused_stages=bool(self.tpu_cfg.get("fused_stages", False)),
                # False | True/"all" | "middle" | "rpn": the regions
                # recomputed in the backward
                remat=parse_remat(self.tpu_cfg.get("remat", False)),
            )
        self.net = net.to(self.device).eval()

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _batch_tensors(self, batch):
        points = torch.as_tensor(batch["points"], device=self.device)
        num_points = torch.as_tensor(batch["num_points"], device=self.device)
        return points.to(torch.float32), num_points

    def apply(self, batch, train=False):
        """Full forward: voxelize -> network.

        Args:
            batch: dict with ``points`` (B, P, 4) and ``num_points`` (B,),
                numpy arrays or tensors.
            train: training mode: batch statistics in every batch norm,
                running statistics updated in place, autograd on.
        Returns:
            eval: (cls, reg, dirs), (B, H, W, A*C / A*9 / A*6) float32,
            NHWC; train: ((cls, reg, dirs), the net's updated running
            statistics as {buffer name: tensor}).
        """
        if not train:
            with torch.inference_mode():
                self.net.eval()
                return self._forward(batch)
        self.net.train()
        outs = self._forward(batch)
        return outs, dict(self.net.named_buffers())

    def _forward(self, batch):
        points, num_points = self._batch_tensors(batch)
        if self.use_point_pfn:
            vox = self.voxel_layer.points_batch(points, num_points)
            return self.net(vox["num_points_per_voxel"], vox["coords"],
                            vox["voxel_mask"], vox["points"],
                            vox["pt_voxel"], vox["pt_valid"])
        vox = self.voxel_layer(points, num_points)
        return self.net(vox["num_points_per_voxel"], vox["coords"],
                        vox["voxel_mask"], voxels=vox["voxels"])

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    @torch.no_grad()
    def assign(self, inputs, plain=False):
        """Target assignment of every item of a batch against the model's
        anchors, stacked.

        ``plain`` runs the plain PyTorch versions of the assignment's
        kernels (see ``models/assign.assign_targets``).
        """
        boxes = torch.as_tensor(inputs["bboxes"], device=self.device)
        labels = torch.as_tensor(inputs["labels"], device=self.device)
        mask = torch.as_tensor(inputs["gt_mask"], device=self.device)
        with torch.profiler.record_function("assignment"):
            outs = [assign_targets(
                self.anchors, boxes[i], labels[i], mask[i], self._pos_thr,
                self._neg_thr, self.anchor_layout,
                candidates_per_gt=int(
                    self.tpu_cfg["assign_candidates_per_gt"]),
                num_classes=self.num_classes, combo_tab=self.combo_tab,
                exact_anchor_tier=bool(self.tpu_cfg.get(
                    "assign_exact_anchor_tier", True)),
                anchor_aabb=self.anchor_aabb, plain=plain)
                for i in range(boxes.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def loss(self, results, inputs, with_num_pos=False, shard=None):
        """Training losses.

        Args:
            results: (cls, reg, dirs) head outputs.
            inputs: batch dict with ``bboxes`` (B, G, 9), ``labels``
                (B, G), ``gt_mask`` (B, G) and optionally ``item_valid``
                (B,): padded repeat items carry zero weight.
            with_num_pos: also return the positive count (the
                ``avg_factor`` before its clamp).
            shard: this rank's part of a sharded step
                (``parallel/data_parallel.py``): ``num_pos`` is summed
                over the data group first (``shard.num_pos_sum``), and
                where the head outputs are a slab of H the targets,
                assigned over every anchor, are cut to the slab's
                ``shard.anchor_rows``.
        Returns:
            dict of scalar losses ``loss_cls``, ``loss_bbox`` and
            ``loss_dir_x|y|z``, each normalized by ``max(num_pos, 1)``;
            or ``(losses, num_pos)`` with ``with_num_pos``.
        """
        cls, reg, dirs = results
        b = cls.shape[0]
        c = max(self.num_classes, 1)
        assign = self.assign(inputs)
        rows = None if shard is None else shard.anchor_rows
        if rows is not None:
            n = self.anchors.shape[0]
            assign = {k: v[:, rows[0]:rows[1]]
                      if v.dim() > 1 and v.shape[1] == n else v
                      for k, v in assign.items()}

        item_valid = inputs.get("item_valid")
        if item_valid is None:
            item_valid = torch.ones((b,), dtype=torch.float32,
                                    device=self.device)
        else:
            item_valid = torch.as_tensor(item_valid, device=self.device)
            item_valid = item_valid.to(torch.float32)

        pos_w = assign["pos_mask"].to(torch.float32) * item_valid[:, None]
        pos_f = pos_w.reshape(-1)
        neg_f = (assign["neg_mask"].to(torch.float32)
                 * item_valid[:, None]).reshape(-1)
        num_pos = (assign["num_pos"].to(torch.float32) * item_valid).sum()
        if shard is not None:
            num_pos = shard.num_pos_sum(num_pos)
        # avg_factor = total positive count; 1 when there is none
        avg = torch.clamp(num_pos, min=1.0)

        cls_flat = cls.reshape(-1, c)
        target_labels = assign["target_labels"].reshape(-1)
        wmask = (pos_f + neg_f)[:, None]
        loss_cls = self.loss_cls(cls_flat, target_labels, weight=wmask,
                                 avg_factor=avg)

        reg_flat = reg.reshape(-1, self.box_params_num)
        tgt = assign["target_deltas"].reshape(-1, self.box_params_num)
        # sin-difference rotation encoding
        pred_r = reg_flat[:, -3:]
        tgt_r = tgt[:, -3:]
        pred_sin = torch.cat(
            [reg_flat[:, :-3], torch.sin(pred_r) * torch.cos(tgt_r)], dim=-1)
        tgt_sin = torch.cat(
            [tgt[:, :-3], torch.cos(pred_r) * torch.sin(tgt_r)], dim=-1)
        loss_bbox = self.loss_bbox(pred_sin, tgt_sin, weight=pos_f[:, None],
                                   avg_factor=avg)

        # direction CE in the head's native (..., A*6) layout: a pairwise
        # log-softmax over the two bins of each (anchor, axis), whose
        # channel order matches dir_targets' flat (h, w, anchor, axis)
        d0 = dirs[..., 0::2]
        d1 = dirs[..., 1::2]
        lse = torch.logaddexp(d0, d1)
        dir_tgt = assign["dir_targets"].reshape(d0.shape)
        logp_sel = torch.where(dir_tgt == 1, d1, d0) - lse
        pos_w3 = torch.repeat_interleave(
            pos_w.reshape(d0.shape[:-1] + (d0.shape[-1] // 3,)), 3, dim=-1)
        dir_ce = -logp_sel * pos_w3 * self.loss_dir.loss_weight
        loss_dir = {ax: dir_ce[..., i::3].sum() / avg
                    for i, ax in enumerate("xyz")}

        losses = {
            "loss_cls": loss_cls,
            "loss_bbox": loss_bbox,
            "loss_dir_x": loss_dir["x"],
            "loss_dir_y": loss_dir["y"],
            "loss_dir_z": loss_dir["z"],
        }
        if with_num_pos:
            return losses, num_pos
        return losses

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def get_optimizer(self, cfg, grad_clip_value=None):
        """AdamW (eps 1e-8, weight decay on every parameter) over the
        net's parameters, with gradients clipped by value first when
        ``grad_clip_value`` is positive."""
        cfg = dict(cfg or {})
        betas = cfg.get("betas", (0.9, 0.999))
        clip = (float(grad_clip_value)
                if grad_clip_value is not None and grad_clip_value > 0
                else None)
        return ClippedAdamW(
            self.net.parameters(), grad_clip_value=clip,
            lr=float(cfg.get("lr", 1e-3)),
            betas=(float(betas[0]), float(betas[1])), eps=1e-8,
            weight_decay=float(cfg.get("weight_decay", 1e-2)))

    def augment(self, batch, rows=None):
        """The batch with ``device_augment``'s transforms applied on the
        model's device, drawn from ``augment_generator`` (the batch as it
        is when ``device_augment`` is empty).

        ``rows`` (lo, hi): the draws are those of the whole batch, and only
        its rows lo..hi-1 are transformed and returned (a rank's part of
        a sharded batch, drawn as one device draws it).
        """
        if not self.device_augment:
            return batch if rows is None else {
                k: v[rows[0]:rows[1]] for k, v in batch.items()}
        batch = dict(batch)
        for key in ("points", "num_points", "bboxes", "gt_mask"):
            batch[key] = torch.as_tensor(batch[key], device=self.device)
        batch["points"] = batch["points"].to(torch.float32)
        batch["bboxes"] = batch["bboxes"].to(torch.float32)
        if rows is None:
            return augment_batch(batch, self.device_augment,
                                 self.augment_generator)
        params = draw_params(batch["points"], self.device_augment,
                             self.augment_generator)
        lo, hi = rows
        return apply_params({k: v[lo:hi] for k, v in batch.items()},
                            [p[lo:hi] for p in params], self.device_augment)

    def make_train_step(self, tx, microbatch=None, shard=None):
        """The training step on one device, or one rank's part of a
        sharded step.

        Args:
            tx: the optimizer over ``self.net``'s parameters
                (:meth:`get_optimizer`).
            microbatch: ``None``: one forward and backward over the whole
                batch.  ``m``: gradient accumulation over ``B / m``
                chunks of ``m`` items (``ValueError`` when ``m`` does not
                divide ``B``), then one update; peak memory is that of
                one chunk.
        Returns:
            step(batch) -> {name: detached scalar} of the five losses and
            ``num_pos``, the batch's positive count: ``device_augment``
            (:meth:`augment`; once per chunk under accumulation), forward
            in train mode, assignment, losses, backward, clip and update;
            the net's parameters and running statistics and the
            optimizer's state change in place.  The phases are
            ``torch.profiler`` ranges (``forward``, ``assignment`` inside
            ``loss+backward``, ``optimizer``; per chunk under
            accumulation), which ``profile_train`` reads from a trace.

        ``shard`` (``parallel/data_parallel.py``; use its
        ``make_sharded_train_step``): the step takes the global batch (or
        chunk), augments it as one device does and keeps this rank's rows
        (``shard.batch_rows``), runs the forward under ``shard.context``
        (statistics over the ranks, a slab of H), normalizes by the global
        positive count, sums the gradients over the ranks before the
        update (``shard.sum_grads``) and returns the global losses
        (``shard.sum_losses``).
        """
        if microbatch is not None:
            return self._accum_step(tx, int(microbatch), shard)
        record = torch.profiler.record_function
        params = [p for group in tx.param_groups for p in group["params"]]

        def step(batch):
            batch = self.augment(batch, None if shard is None
                                 else shard.batch_rows(len(batch["points"])))
            with record("forward"), _sharded(shard, self.net):
                outs, _ = self.apply(batch, train=True)
            with record("loss+backward"):
                losses, num_pos = self.loss(outs, batch, with_num_pos=True,
                                            shard=shard)
                total = sum(losses.values())
                tx.zero_grad(set_to_none=True)
                total.backward()
            with record("optimizer"):
                if shard is not None:
                    shard.sum_grads(params)
                tx.step()
            out = {k: v.detach() for k, v in losses.items()}
            if shard is not None:
                out = shard.sum_losses(out)
            out["num_pos"] = num_pos
            return out

        return step

    def _accum_step(self, tx, microbatch, shard=None):
        """Gradient accumulation with the pooled normalization of the
        whole batch (the JAX package's ``train_step_accum_fn``).

        Chunk i's losses are its sums over ``max(n_i, 1)``, its positive
        count clamped.  Its gradients, taken with respect to the same
        parameters, are multiplied by ``max(n_i, 1)`` after its backward,
        which recovers the gradient of the sums, and added into a float32
        buffer per parameter; the total is divided once by
        ``max(sum n_i, 1)``, the normalization of the whole batch, and the
        optimizer (clip, then AdamW) steps once.  Each chunk's graph is
        freed by its own backward.  Train-mode batch norm takes its
        statistics per chunk and updates the running statistics chunk
        after chunk, as training at the chunk's batch size would.

        Under ``shard`` each chunk of ``microbatch`` items is a global
        chunk: its count ``n_i`` and statistics are those of every rank's
        rows of it, and the summed gradients are summed over the ranks
        before the update.
        """
        record = torch.profiler.record_function
        params = [p for group in tx.param_groups for p in group["params"]]

        def step(batch):
            b = batch["points"].shape[0]
            if b % microbatch:
                raise ValueError(
                    f"batch {b} not divisible by microbatch {microbatch}")
            sums = [None] * len(params)
            loss_sums = {}
            n_total = torch.zeros((), device=self.device)
            for start in range(0, b, microbatch):
                mb = self.augment(
                    {k: v[start:start + microbatch]
                     for k, v in batch.items()},
                    None if shard is None else shard.batch_rows(microbatch))
                with record("forward"), _sharded(shard, self.net):
                    outs, _ = self.apply(mb, train=True)
                with record("loss+backward"):
                    losses, n_i = self.loss(outs, mb, with_num_pos=True,
                                            shard=shard)
                    grads = torch.autograd.grad(sum(losses.values()),
                                                params, allow_unused=True)
                    avg_i = torch.clamp(n_i, min=1.0)
                    for j, g in enumerate(grads):
                        if g is None:
                            continue
                        g = g.float() * avg_i
                        sums[j] = g if sums[j] is None else sums[j] + g
                    for k, v in losses.items():
                        loss_sums[k] = loss_sums.get(k, 0.0) + (
                            v.detach() * avg_i)
                    n_total = n_total + n_i
                    # the chunk's head outputs go before the next forward
                    del outs, grads
            with record("optimizer"):
                total_pos = torch.clamp(n_total, min=1.0)
                for p, g in zip(params, sums):
                    p.grad = (None if g is None
                              else (g / total_pos).to(p.dtype))
                if shard is not None:
                    shard.sum_grads(params)
                tx.step()
            out = {k: v / total_pos for k, v in loss_sums.items()}
            if shard is not None:
                out = shard.sum_losses(out)
            out["num_pos"] = n_total
            return out

        return step

    def make_eval_fn(self):
        """``run(batch) -> (losses, preds)``: one eval-mode forward without
        autograd, the batch's losses (:meth:`loss`) and its detections
        (as :meth:`predict` decodes them)."""

        @torch.no_grad()
        def run(batch):
            self.net.eval()
            outs = self._forward(batch)
            losses = self.loss(outs, batch)
            return losses, self._decode(outs, self.anchors)

        return run

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _predict_single(self, cls, reg, dirs, anchors):
        """Decode + NMS for one item, fixed output size."""
        c = max(self.num_classes, 1)
        n_a = anchors.shape[0]
        nms_pre = min(int(self.head_cfg.get("nms_pre", 100)), n_a)
        score_thr = float(self.head_cfg.get("score_thr", 0.1))
        nms_thresh = float(self.head_cfg.get("nms_thresh", 0.7))
        dir_offset = float(self.head_cfg.get("dir_offset", 0.0))
        max_det = min(int(self.tpu_cfg["max_detections"]), nms_pre * c)

        # top-k on raw logits (sigmoid is monotone); everything else runs
        # on the nms_pre survivors only
        logits = cls.reshape(-1, c)
        row = logits.amax(dim=-1)
        top_idx = topk_lowest_index(row, nms_pre)
        anchors_sel = anchors[top_idx]
        deltas_sel = reg.reshape(-1, self.box_params_num)[top_idx]
        boxes = self.bbox_coder.decode(anchors_sel, deltas_sel)
        scores_sel = torch.sigmoid(logits[top_idx])
        dirs_sel = dirs.reshape(-1, 6)[top_idx]
        bins_sel = dirs_sel.reshape(-1, 3, 2).argmax(dim=-1)

        keep = multiclass_nms(boxes, scores_sel, score_thr, nms_thresh,
                              nms_dim=self.nms_dim)

        # direction recovery per rotation axis
        rot = boxes[:, -3:]
        rot = (limit_period(rot - dir_offset, 1.0, math.pi) + dir_offset
               + math.pi * bins_sel.to(boxes.dtype))
        boxes = torch.cat([boxes[:, :-3], rot], dim=-1)

        flat_scores = torch.where(keep, scores_sel,
                                  torch.full_like(scores_sel, -1.0))
        flat_scores = flat_scores.reshape(-1)
        flat_idx = topk_lowest_index(flat_scores, max_det)
        sel_scores = flat_scores[flat_idx]
        box_idx = flat_idx // c
        labels = flat_idx % c
        return {
            "bbox": boxes[box_idx],
            "label": labels.to(torch.int32),
            "score": sel_scores,
            "valid": sel_scores > 0,
        }

    @torch.inference_mode()
    def predict(self, batch, anchors=None):
        """Batched inference: forward + decode + NMS, one item at a time.

        Returns:
            dict of ``bbox`` (B, K, 9), ``label`` (B, K) int32, ``score``
            (B, K) and ``valid`` (B, K) bool, K = max detections.
        """
        return self.predict_traceable(batch, anchors)

    def predict_traceable(self, batch, anchors=None):
        """:meth:`predict` without its inference mode, which
        ``torch.export`` cannot trace (``serving.export_predict`` runs it
        under ``torch.no_grad()``).  Every shape in it is static: the
        top-k, the NMS fixpoint and the kernels' operators depend on
        nothing but the input's shape."""
        if anchors is None:
            anchors = self.anchors
        self.net.eval()
        return self._decode(self._forward(batch), anchors)

    def _decode(self, outs, anchors):
        """Head outputs -> stacked per-item detections."""
        cls, reg, dirs = outs
        items = [self._predict_single(cls[i], reg[i], dirs[i], anchors)
                 for i in range(cls.shape[0])]
        return {k: torch.stack([o[k] for o in items]) for k in items[0]}

    def make_predict_fn(self):
        """``run(batch) -> predict(batch)`` with the model's anchors."""

        def run(batch):
            return self.predict(batch, self.anchors)

        return run

    def inference_end(self, results):
        """Unpad predictions into per-cloud lists of detection dicts
        ``{"bbox": (9,), "label": int, "score": float}``."""
        def host(x):
            return (x.detach().cpu().numpy() if torch.is_tensor(x)
                    else np.asarray(x))

        bbox, label, score, valid = (host(results[k]) for k in
                                     ("bbox", "label", "score", "valid"))
        out = []
        for i in range(bbox.shape[0]):
            out.append([{"bbox": bbox[i, j], "label": int(label[i, j]),
                         "score": float(score[i, j])}
                        for j in range(bbox.shape[1]) if valid[i, j]])
        return out

    # ------------------------------------------------------------------
    # host-side preprocessing
    # ------------------------------------------------------------------
    def preprocess(self, data, attr, rng=None):
        """Per-cloud host preprocessing: 5-sigma outlier rejection, range
        cropping of points and of box centres (xy), input-feature
        selection, then train-time augmentation (not for the test and
        validation splits)."""
        rng = rng if rng is not None else self.rng

        bboxes = np.array(data["bboxes"], dtype=np.float32).reshape(-1, 9)
        min_val = np.array(self.point_cloud_range[:3])
        max_val = np.array(self.point_cloud_range[3:])

        points = self._preprocess_points(np.asarray(data["point"]))

        bboxes = bboxes[np.where(
            np.all(np.logical_and(bboxes[:, :2] >= min_val[:2],
                                  bboxes[:, :2] < max_val[:2]), axis=-1))]

        if points.shape[0] == 0:
            print("There are no points in defined range. Range is defined "
                  "wrongly or this particular point cloud is affected with "
                  "outliers: {}".format(attr.get("name")))
        data = dict(data)
        data["point"] = points
        data["bboxes"] = bboxes

        if attr.get("split") not in ("test", "testing", "val", "validation"):
            data = self.augmentor.augment(data, attr, seed=rng)

        return {"point": data["point"], "labels": data["labels"],
                "bboxes": data["bboxes"]}

    def _preprocess_points(self, points):
        """Outlier rejection, range crop and column selection: the fused
        C++ pass (``native.preprocess_cloud``) for a non-empty 2-D cloud,
        numpy otherwise (the same semantics)."""
        pts32 = np.asarray(points, np.float32)
        if pts32.ndim == 2 and pts32.shape[0] > 0:
            return native.preprocess_cloud(pts32, self.input_features,
                                           self.point_cloud_range)
        return self._preprocess_points_numpy(pts32)

    def _preprocess_points_numpy(self, points):
        """The numpy version of :meth:`_preprocess_points`."""
        filtered = global_outlier_check(np.asarray(points, np.float32))
        min_val = np.array(self.point_cloud_range[:3])
        max_val = np.array(self.point_cloud_range[3:])
        filtered = filtered[np.where(
            np.all(np.logical_and(filtered[:, :3] >= min_val,
                                  filtered[:, :3] < max_val), axis=-1))]
        return filtered[:, self.input_features]

    def transform(self, data, attr):
        """Identity hook after :meth:`preprocess`."""
        return data
