"""Train-time augmentation of a padded batch on its device.

Port of the JAX package's ``augment/device_ops.py``.  The geometric
augmentations run inside the train step on the padded batch, and the
ground-truth boxes move with the points.  Every transform is per item
(its own draws per cloud) and keeps the scene's range by rotating and
flipping about the centre of the item's xy extent.

``augment_batch`` is split in two: :func:`draw_params` makes the random
draws from an explicit ``torch.Generator`` (the JAX package's
distributions, not its bits), and :func:`apply_params` is the
deterministic transform, so a test can feed it the JAX package's own
draws.

One documented difference (ROADMAP C10): ``flip_x`` maps ``rz -> pi -
rz`` and ``rx -> -rx`` and keeps ``ry``, the mirror of a 9-parameter box
about a plane of constant x.  The JAX package maps ``ry -> -ry`` and keeps
``rx``, which is the mirror only where ``rx = ry = 0``: a tilted trunk
loses most of its interior points.  ``flip_y`` (``rz -> -rz``, ``rx ->
-rx``) and the other transforms are the JAX package's.
"""

import math

import torch


def parse_device_augment_cfg(cfg_dict):
    """Config dict -> hashable cfg tuple of ``(name, *params)`` entries.

    Accepted keys: rotate {min,max} (radians), scale {min,max},
    flip_x / flip_y (bool), translate {std}, noise {std}.
    """
    out = []
    cfg_dict = dict(cfg_dict or {})
    if "rotate" in cfg_dict:
        r = cfg_dict["rotate"] or {}
        out.append(("rotate", float(r.get("min", 0.0)),
                    float(r.get("max", 2 * 3.14159265))))
    if "scale" in cfg_dict:
        s = cfg_dict["scale"] or {}
        out.append(("scale", float(s.get("min", 0.95)),
                    float(s.get("max", 1.05))))
    if cfg_dict.get("flip_x"):
        out.append(("flip_x",))
    if cfg_dict.get("flip_y"):
        out.append(("flip_y",))
    if "translate" in cfg_dict:
        t = cfg_dict["translate"] or {}
        out.append(("translate", float(t.get("std", 0.5))))
    if "noise" in cfg_dict:
        n = cfg_dict["noise"] or {}
        out.append(("noise", float(n.get("std", 0.001))))
    return tuple(out)


def draw_params(points, cfg, generator):
    """The random draws of one batch, one tensor per ``cfg`` entry.

    Args:
        points: (B, P, C) tensor (its shape and device).
        cfg: tuple from :func:`parse_device_augment_cfg`.
        generator: ``torch.Generator`` on ``points``' device.
    Returns:
        list aligned with ``cfg``: rotate (B,) angle ~ U(min, max); scale
        (B,) ~ U(min, max); flip_x / flip_y (B,) bool, each True with
        probability 1/2; translate (B, 3) ~ N(0, std^2); noise (B, P, 3)
        ~ N(0, std^2).
    """
    b, p = points.shape[:2]
    kw = dict(generator=generator, device=points.device,
              dtype=torch.float32)
    params = []
    for entry in cfg:
        name = entry[0]
        if name in ("rotate", "scale"):
            lo, hi = entry[1], entry[2]
            params.append(lo + (hi - lo) * torch.rand((b,), **kw))
        elif name in ("flip_x", "flip_y"):
            params.append(torch.rand((b,), **kw) < 0.5)
        elif name == "translate":
            params.append(torch.randn((b, 3), **kw) * entry[1])
        elif name == "noise":
            params.append(torch.randn((b, p, 3), **kw) * entry[1])
        else:
            raise ValueError(f"Unknown device augmentation: {name}")
    return params


def apply_params(batch, params, cfg):
    """Apply ``cfg``'s transforms with the draws ``params`` to a padded
    batch.

    Args:
        batch: dict with 'points' (B, P, C), 'num_points' (B,), 'bboxes'
            (B, G, 9), 'gt_mask' (B, G) tensors on one device, ...
        params: list aligned with ``cfg`` (:func:`draw_params`).
        cfg: tuple from :func:`parse_device_augment_cfg`.
    Returns:
        a new batch dict, the same shapes, with 'points' and 'bboxes'
        transformed and their padding rows zero.
    """
    points = batch["points"].clone()
    boxes = batch["bboxes"].clone()
    center = (points[..., :2].amax(dim=1, keepdim=True)
              + points[..., :2].amin(dim=1, keepdim=True)) / 2  # (B, 1, 2)
    cx, cy = center[..., 0], center[..., 1]                      # (B, 1)

    for entry, prm in zip(cfg, params):
        name = entry[0]
        if name == "rotate":
            cos, sin = torch.cos(prm)[:, None], torch.sin(prm)[:, None]
            for t in (points, boxes):
                px = t[..., 0] - cx
                py = t[..., 1] - cy
                t[..., 0] = cos * px - sin * py + cx
                t[..., 1] = sin * px + cos * py + cy
            boxes[..., 8] += prm[:, None]
        elif name == "scale":
            points[..., :3] *= prm[:, None, None]
            boxes[..., :6] *= prm[:, None, None]
        elif name == "flip_x":
            do = prm[:, None]
            points[..., 0] = torch.where(do, 2 * cx - points[..., 0],
                                         points[..., 0])
            boxes[..., 0] = torch.where(do, 2 * cx - boxes[..., 0],
                                        boxes[..., 0])
            # the mirror about x: rz -> pi - rz, rx -> -rx (C10)
            boxes[..., 8] = torch.where(do, math.pi - boxes[..., 8],
                                        boxes[..., 8])
            boxes[..., 6] = torch.where(do, -boxes[..., 6], boxes[..., 6])
        elif name == "flip_y":
            do = prm[:, None]
            points[..., 1] = torch.where(do, 2 * cy - points[..., 1],
                                         points[..., 1])
            boxes[..., 1] = torch.where(do, 2 * cy - boxes[..., 1],
                                        boxes[..., 1])
            # the mirror about y: rz -> -rz, rx -> -rx
            boxes[..., 8] = torch.where(do, -boxes[..., 8], boxes[..., 8])
            boxes[..., 6] = torch.where(do, -boxes[..., 6], boxes[..., 6])
        elif name == "translate":
            points[..., :3] += prm[:, None]
            boxes[..., :3] += prm[:, None]
        elif name == "noise":
            points[..., :3] += prm
        else:
            raise ValueError(f"Unknown device augmentation: {name}")

    # zero the padding rows again (the transforms moved them)
    p_mask = (torch.arange(points.shape[1], device=points.device)[None, :]
              < batch["num_points"][:, None])
    points = points * p_mask[..., None].to(points.dtype)
    boxes = boxes * batch["gt_mask"][..., None].to(boxes.dtype)
    out = dict(batch)
    out["points"] = points
    out["bboxes"] = boxes
    return out


def augment_batch(batch, cfg, generator):
    """:func:`apply_params` with draws from ``generator``
    (:func:`draw_params`)."""
    return apply_params(batch, draw_params(batch["points"], cfg, generator),
                        cfg)
