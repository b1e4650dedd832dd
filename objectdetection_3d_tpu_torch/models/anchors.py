"""Anchor generation and box decoding.

Port of the JAX package's ``models/anchors.py``.  The anchor grid is built
once, on the model's device: only the per-axis center vectors (a few
hundred floats, computed in float64 and rounded to float32 exactly as the
JAX package's numpy ``linspace`` does) cross from the host.
"""

import numpy as np
import torch


class Anchor3DRangeGenerator:
    """Range-based 3D anchor grid.

    For an (H, W) feature map the grid is (z=1, y=H, x=W) with centers from
    endpoint-inclusive linspaces over the range, crossed with S sizes and
    R rotation triples -> (H, W, S, R, box_params) and flat index
    ``((y * W + x) * S + s) * R + r``.
    """

    def __init__(self, ranges, sizes, rotations, box_params_num=9):
        self.ranges = [list(map(float, r)) for r in ranges]
        self.sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
        self.rotations = np.asarray(rotations, np.float32).reshape(-1, 3)
        self.box_params_num = int(box_params_num)

    @property
    def num_base_anchors(self):
        """Anchors per feature-map cell (sizes x rotations)."""
        return self.sizes.shape[0] * self.rotations.shape[0]

    def grid_anchors(self, featmap_size, device="cpu"):
        """(H, W, S, R, box_params) float32 anchor grid on ``device``."""
        h, w = featmap_size
        s = self.sizes.shape[0]
        r = self.rotations.shape[0]
        size = torch.from_numpy(self.sizes).to(device)
        rot = torch.from_numpy(self.rotations).to(device)
        outs = []
        for rng in self.ranges:
            z0 = float(np.linspace(rng[2], rng[5], 1, dtype=np.float32)[0])
            yc = torch.from_numpy(
                np.linspace(rng[1], rng[4], h, dtype=np.float32)).to(device)
            xc = torch.from_numpy(
                np.linspace(rng[0], rng[3], w, dtype=np.float32)).to(device)
            yy, xx = torch.meshgrid(yc, xc, indexing="ij")
            cent = torch.stack([xx, yy, torch.full_like(xx, z0)], dim=-1)
            outs.append(torch.cat([
                cent[:, :, None, None, :].expand(h, w, s, r, 3),
                size[None, None, :, None, :].expand(h, w, s, r, 3),
                rot[None, None, None, :, :].expand(h, w, s, r, 3),
            ], dim=-1))
        return torch.cat(outs, dim=2)

    def flat_anchors(self, featmap_size, device="cpu"):
        """(H*W*S*R, box_params) in the head's flat anchor order."""
        return self.grid_anchors(featmap_size, device).reshape(
            -1, self.box_params_num)


class BBoxCoder:
    """Delta coding of 9-param boxes against anchors: xy by the anchor BEV
    diagonal, z by anchor height with both z's shifted from bottom to
    center, log-size ratios, raw angle deltas."""

    @staticmethod
    def encode(src_boxes, dst_boxes):
        xa, ya, za = src_boxes[..., 0], src_boxes[..., 1], src_boxes[..., 2]
        dxa, dya, dza = (src_boxes[..., 3], src_boxes[..., 4],
                         src_boxes[..., 5])
        xg, yg, zg = dst_boxes[..., 0], dst_boxes[..., 1], dst_boxes[..., 2]
        dxg, dyg, dzg = (dst_boxes[..., 3], dst_boxes[..., 4],
                         dst_boxes[..., 5])

        zg = zg + dzg / 2
        za = za + dza / 2
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)

        out = [
            (xg - xa) / diagonal,
            (yg - ya) / diagonal,
            (zg - za) / dza,
            torch.log(dxg / dxa),
            torch.log(dyg / dya),
            torch.log(dzg / dza),
            dst_boxes[..., 6] - src_boxes[..., 6],
            dst_boxes[..., 7] - src_boxes[..., 7],
            dst_boxes[..., 8] - src_boxes[..., 8],
        ]
        return torch.stack(out, dim=-1)

    @staticmethod
    def decode(anchors, deltas):
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]

        za = za + dza / 2
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)

        out = [
            deltas[..., 0] * diagonal + xa,
            deltas[..., 1] * diagonal + ya,
            deltas[..., 2] * dza + za,
            torch.exp(deltas[..., 3]) * dxa,
            torch.exp(deltas[..., 4]) * dya,
            torch.exp(deltas[..., 5]) * dza,
            deltas[..., 6] + anchors[..., 6],
            deltas[..., 7] + anchors[..., 7],
            deltas[..., 8] + anchors[..., 8],
        ]
        return torch.stack(out, dim=-1)
