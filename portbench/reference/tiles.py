"""Plain reference of tiled inference over a plot larger than the model's
window: the tile grid, each tile's points, the reference predict of each
tile, and the greedy NMS merge of every tile's detections in the plot's
frame.

Which points a tile holds is part of the configuration's semantics (a
40 m window keeps at most the point budget of its in-window points, a
uniform random subset above it), and the subset above the budget is the
one the tiled call draws from its fixed seeds.  So :func:`tile_points`
is a frozen copy of the port's device crop (``TiledInference`` with
``device_crop=True`` as of this benchmark's first version: the scene
shuffled by a ``torch.Generator`` seeded 0, sorted by (x-column, y), each
tile's runs read by strided gathers and compacted by uniform draws of a
generator seeded 1).  The rest is written out here.
"""

import numpy as np
import torch

SENTINEL = 1e9


def tile_origins(lo, hi, tile, overlap):
    stride = max(tile - overlap, tile * 0.5)
    n = max(int(np.ceil(max(hi - lo - overlap, 1e-9) / stride)), 1)
    origins = np.minimum(lo + stride * np.arange(n), max(hi - tile, lo))
    return np.unique(origins)


def _sortable_y(y):
    bits = (y + 0.0).contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.to(torch.int64) + 2 ** 31


def _key(col, y):
    return (col.to(torch.int64) << 32) + _sortable_y(y)


class Crop:
    """The device crop's tile buffers (frozen copy, see the module's
    docstring)."""

    def __init__(self, spec, max_pts, crop_cols=8):
        self.tile_x = spec.pcr[3] - spec.pcr[0]
        self.tile_y = spec.pcr[4] - spec.pcr[1]
        self.crop_cols = crop_cols
        self.xcell = self.tile_x / crop_cols
        self.n_runs = crop_cols + 1
        self.max_pts = int(max_pts)
        self.rb = max(2 * self.max_pts // self.n_runs // 8 * 8, 8)

    def sort(self, scene, lo0):
        gen = torch.Generator(device=scene.device).manual_seed(0)
        perm = torch.randperm(scene.shape[0], generator=gen,
                              device=scene.device)
        scene = scene[perm]
        xcol = torch.floor((scene[:, 0] - lo0) / self.xcell).to(torch.int32)
        o1 = torch.argsort(scene[:, 1], stable=True)
        o2 = torch.argsort(xcol[o1], stable=True)
        order = o1[o2]
        s = scene[order]
        return s, _key(xcol[order], s[:, 1])

    def draws(self, dev):
        gen = torch.Generator(device=dev).manual_seed(1)
        return torch.rand((max(self.n_runs * self.rb, self.max_pts),),
                          generator=gen, device=dev)

    def tile(self, sorted_scene, key, shift, lo0, u):
        """(max_pts, C) points of the tile at ``shift`` (x0, y0, z0) in its
        own frame, sentinels past its points."""
        n_runs, rb, max_pts = self.n_runs, self.rb, self.max_pts
        n, c = sorted_scene.shape
        dev = sorted_scene.device
        shifts = shift[None]
        x0, y0 = shifts[:, 0], shifts[:, 1]
        y1 = y0 + torch.tensor(self.tile_y, dtype=torch.float32)
        cx0 = torch.floor((x0 - lo0) / self.xcell).to(torch.int32)
        cols = cx0[:, None] + torch.arange(n_runs, dtype=torch.int32,
                                           device=dev)[None]
        starts = torch.searchsorted(
            key, _key(cols, y0[:, None].expand(1, n_runs)).reshape(-1))
        ends = torch.searchsorted(
            key, _key(cols, y1[:, None].expand(1, n_runs)).reshape(-1))
        starts, lens = starts.reshape(1, -1), (ends - starts).reshape(1, -1)
        i = torch.arange(rb, dtype=torch.float32, device=dev)
        stride = lens.clamp(min=rb).to(torch.float32) / rb
        off = torch.floor(i * stride[..., None]).to(torch.int64)
        valid = off < lens[..., None]
        off = torch.minimum(off, (lens[..., None] - 1).clamp(min=0))
        rows = (starts[..., None] + off).clamp(max=n - 1)
        vals = sorted_scene[rows.reshape(-1)].reshape(1, n_runs * rb, c)
        valid = valid.reshape(1, n_runs * rb)
        local = torch.cat([vals[..., :3] - shifts[:, None], vals[..., 3:]],
                          dim=-1)
        if n_runs * rb < max_pts:
            short = max_pts - n_runs * rb
            local = torch.cat([local, local.new_zeros((1, short, c))], 1)
            valid = torch.cat([valid, valid.new_zeros((1, short))], 1)
        in_win = valid & (local[..., 0] >= 0) & (local[..., 0] < self.tile_x)
        order_key = (u + torch.where(in_win, 0.0, 2.0)
                     + torch.where(valid, 0.0, 4.0))
        sel = torch.argsort(order_key, dim=1, stable=True)[:, :max_pts]
        out = torch.gather(local, 1, sel[..., None].expand(1, max_pts, c))
        keep = torch.gather(valid, 1, sel)
        return torch.where(keep[..., None], out,
                           torch.tensor(SENTINEL, dtype=out.dtype,
                                        device=dev))[0]


def tiles(scene, spec, max_pts, overlap, device):
    """Each tile of a plot, in the tiled call's order: (its ``shift`` (x0,
    y0, z0) in the plot's frame, its (max_pts, C) points in its own
    frame)."""
    pts = np.asarray(scene, np.float32)
    lo, hi = pts[:, :3].min(0), pts[:, :3].max(0)
    crop = Crop(spec, max_pts)
    xs = tile_origins(lo[0], hi[0], crop.tile_x, overlap)
    ys = tile_origins(lo[1], hi[1], crop.tile_y, overlap)
    scene_t = torch.as_tensor(pts, device=device)
    sorted_scene, key = crop.sort(scene_t, float(lo[0]))
    u = crop.draws(device)
    for x0 in xs:
        for y0 in ys:
            shift = torch.tensor([x0, y0, lo[2]], dtype=torch.float32,
                                 device=device)
            yield shift, crop.tile(sorted_scene, key, shift, float(lo[0]), u)


def plot_detections(arch, scene, params, spec, max_pts, overlap, device,
                    quant, max_merge=2048):
    """The reference's detections of a whole plot by the architecture
    ``arch``: ``bbox`` (n, 9) and ``score`` (n,) in the plot's frame, the
    merge's survivors; and for each tile (``tiles``) its ``shift`` and its
    head's ``logit``, ``reg``, ``anchor`` and ``cut_logit``, as
    ``arch.predict`` gives them."""
    anc = arch.anchors(spec, device)
    boxes, scores, heads = [], [], []
    for shift, tile in tiles(scene, spec, max_pts, overlap, device):
        d = arch.predict(tile, max_pts, params, spec, anc, quant)
        b = d["bbox"][d["valid"]].clone()
        b[:, :3] += shift
        boxes.append(b)
        scores.append(d["score"][d["valid"]])
        heads.append({"shift": shift, "logit": d["logit"], "reg": d["reg"],
                      "anchor": d["anchor"], "cut_logit": d["cut_logit"]})
    boxes, scores = torch.cat(boxes), torch.cat(scores)
    if len(scores) > max_merge:
        top = arch.top_lowest_index(scores, max_merge).sort().values
        boxes, scores = boxes[top], scores[top]
    keep = arch.greedy_nms(boxes, scores, spec.score_thr,
                           arch.overlap_matrix(boxes, spec.nms_thresh))
    return {"bbox": boxes[keep].cpu().numpy(),
            "score": scores[keep].cpu().numpy(), "tiles": heads}
