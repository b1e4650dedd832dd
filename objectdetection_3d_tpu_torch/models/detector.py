"""PointPillars detector: voxelizer, anchors, network, decode and NMS.

Port of the inference path of the JAX package's ``models/detector.py``:
the constructor's grid / voxelizer / anchors / network set-up, ``apply``
(point path, eval), ``_predict_single``, ``predict`` and
``make_predict_fn``.  Weights live in the ``net`` module; load trained or
JAX-initialised ones with ``models/weights.py``.

Tie order of the candidate top-k: among exactly equal logits the port
takes the lowest anchor index first (:func:`topk_lowest_index`).  The JAX
package's ``_blockwise_topk`` orders exact ties by the rank of their
128-anchor block instead.  Inactive pixels all carry the head bias, so
such ties are common among anchors below ``score_thr``; the two orders
then pick different below-threshold candidates, which NMS never keeps.
"""

import math

import numpy as np
import torch

from objectdetection_3d_tpu_torch.configs import DEFAULT_TPU_CFG
from objectdetection_3d_tpu_torch.models.anchors import (
    Anchor3DRangeGenerator,
    BBoxCoder,
)
from objectdetection_3d_tpu_torch.models.network import PointPillarsNet
from objectdetection_3d_tpu_torch.ops.boxes import limit_period
from objectdetection_3d_tpu_torch.ops.nms import multiclass_nms
from objectdetection_3d_tpu_torch.ops.voxelize import Voxelizer


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


def topk_lowest_index(x, k):
    """Exact top-k of a 1-D tensor, ties broken by the lowest index.

    Returns the k indices ordered by value descending, then index
    ascending.  ``torch.topk`` leaves the order of equal values free, so
    it only finds the k-th value; the indices are then taken in a fixed
    order.
    """
    kth = torch.topk(x, k, sorted=True).values[-1]
    above = torch.nonzero(x > kth).squeeze(1)
    ties = torch.nonzero(x == kth).squeeze(1)[:k - above.numel()]
    idx = torch.cat([above, ties])
    order = torch.sort(x[idx], descending=True, stable=True).indices
    return idx[order]


class PointPillars:
    """PointPillars with 9-parameter fully rotated boxes.

    Args:
        cfg: the model configuration dict (``configs.flagship_cfg()`` and
            friends; the JAX package's keyword arguments as one dict).
        device: where the model runs; CUDA unless the caller asks for the
            CPU.  The config's own ``device`` key is not read.
    """

    def __init__(self, cfg, device="cuda"):
        cfg = dict(cfg)
        self.device = resolve_device(device)
        self.point_cloud_range = [float(v) for v in cfg["point_cloud_range"]]
        self.classes = list(cfg.get("classes", ()))
        self.num_classes = len(self.classes)
        self.input_features = list(cfg.get("input_features", ())) or [0, 1,
                                                                      2, 3]

        self.tpu_cfg = dict(DEFAULT_TPU_CFG)
        self.tpu_cfg.update(dict(cfg.get("tpu") or {}))
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

        if cfg.get("use_dense_backbone", False):
            raise NotImplementedError(
                "use_dense_backbone is not ported yet")
        self.anchor_generator = Anchor3DRangeGenerator(
            ranges=head["ranges"], sizes=head["sizes"],
            rotations=head["rotations"], box_params_num=self.box_params_num)
        self.num_anchors = self.anchor_generator.num_base_anchors
        _, h, w = self.grid_dhw
        self.featmap = (h, w)
        self.anchors = self.anchor_generator.flat_anchors(self.featmap,
                                                          self.device)
        self.bbox_coder = BBoxCoder()

        ve_cfg = dict(cfg["voxel_encoder"])
        vertical = dict(cfg["vertical_encoder"])
        backbone = dict(cfg["backbone"])
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
                sparse_middle=bool(self.tpu_cfg.get("sparse_middle", False)),
            )
        self.net = net.to(self.device).eval()

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _batch_tensors(self, batch):
        points = torch.as_tensor(batch["points"], device=self.device)
        num_points = torch.as_tensor(batch["num_points"], device=self.device)
        return points.to(torch.float32), num_points

    @torch.inference_mode()
    def apply(self, batch):
        """Full forward: voxelize -> network.

        Args:
            batch: dict with ``points`` (B, P, 4) and ``num_points`` (B,),
                numpy arrays or tensors.
        Returns:
            (cls, reg, dirs): (B, H, W, A*C / A*9 / A*6) float32, NHWC.
        """
        points, num_points = self._batch_tensors(batch)
        vox = self.voxel_layer.points_batch(points, num_points)
        return self.net(vox["num_points_per_voxel"], vox["coords"],
                        vox["voxel_mask"], vox["points"], vox["pt_voxel"],
                        vox["pt_valid"])

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
        if anchors is None:
            anchors = self.anchors
        cls, reg, dirs = self.apply(batch)
        outs = [self._predict_single(cls[i], reg[i], dirs[i], anchors)
                for i in range(cls.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def make_predict_fn(self):
        """``run(batch) -> predict(batch)`` with the model's anchors."""

        def run(batch):
            return self.predict(batch, self.anchors)

        return run
