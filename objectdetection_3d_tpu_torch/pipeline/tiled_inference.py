"""Tiled inference over scenes larger than the model's window, with a
global NMS merge.

Port of the JAX package's ``pipeline/tiled_inference.py``.  The model sees
one fixed xy window (``point_cloud_range``); a forest plot is larger.  So
the window slides over the scene with overlap, each tile is cropped to the
model's point budget and predicted, its detections are shifted back into
the scene frame, and one greedy NMS over all tiles merges the duplicates
of objects that several tiles saw.

Two crops give each tile its points:

* the host crop (``device_crop=False``): the scene is bucket-sorted in
  numpy once, and each tile's in-window points are filtered from the few
  buckets its window overlaps; an over-budget tile keeps a uniform random
  subset (``np.random.default_rng(0).choice``), as in the JAX package;
* the device crop (the default): the scene is shuffled and sorted by
  (x-column, y) once on the model's device; each tile's candidates are
  one run per x-column with exact y bounds, read by one strided gather of
  ``rb`` rows per run and compacted to the point budget, in-window rows
  first in uniform random order, x-margin rows as filler and ``1e9``
  sentinels last.  The filler and the sentinels lie outside the model's
  range after the shift, so the voxelizer's range check drops them.

Differences from the JAX package, by design:

* no ``jax.jit`` and no ``lax.map``: the sort, each chunk's crop and its
  predict are ordinary torch calls on the device.  Every chunk is enqueued
  before any result is read back, and the detections come back in one
  copy at the end; nothing in the tile loop waits for the device;
* the shuffle and the compaction draw from ``torch.Generator``s seeded 0
  and 1 on the scene's device, which cannot equal ``jax.random``'s draws.
  Below the budget every tile's in-window set is the same as the JAX
  package's; an over-budget tile keeps a different uniform subset;
* the scene is not padded to a 256k-row bucket (that bounded the JAX
  package's recompiles; padding rows only ever sorted to the tail);
* a run's y bounds come from ``torch.searchsorted`` on an exact int64
  (x-column, y) key, in place of the JAX package's (runs, N) masked
  counts: within a column the rows are y-sorted, so the two give the same
  bounds.
"""

import numpy as np
import torch

from objectdetection_3d_tpu_torch.ops.nms import multiclass_nms

SENTINEL = 1e9   # a coordinate outside every window


def _sortable_y(y):
    """float32 ``y`` as int64 keys in the same order (``-0.0`` taken as
    ``0.0``; no NaN): the float's bits, with the magnitude bits of a
    negative value flipped, offset to be non-negative below 2**32."""
    bits = (y + 0.0).contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.to(torch.int64) + 2 ** 31


class TiledInference:
    """Sliding-window detector over scenes larger than the model range."""

    def __init__(self, model, overlap=5.0, batch_tiles=1,
                 max_merge_boxes=2048, predict_fn=None, device_crop=True,
                 crop_cols=8):
        """
        Args:
            model: the port's ``PointPillars``, weights loaded; tiles run
                on its device.
            overlap: tile overlap in meters (objects up to ``overlap``
                wide are seen whole by at least one tile).
            batch_tiles: tiles per predict call.
            max_merge_boxes: budget of the global NMS merge; above it the
                top-scoring candidates are kept.
            predict_fn: external ``predict(batch)``, e.g. a
                ``model.make_predict_fn()`` of another model, or
                ``parallel.make_sharded_predict_fn(model, mesh)``, which
                splits each chunk's tiles over the data group and
                gathers their detections; default the model's own
                ``predict``.
            device_crop: crop tiles on the model's device; False = numpy
                host crop.
            crop_cols: x-columns per tile width for the sort grid.  The
                crop is exact in y; finer columns cut the out-of-window
                x-margin (wasted point budget) at the cost of more gather
                runs per tile.
        """
        self.model = model
        self.overlap = float(overlap)
        self.batch_tiles = int(batch_tiles)
        self.max_merge_boxes = int(max_merge_boxes)
        self.device_crop = bool(device_crop)
        self.crop_cols = int(crop_cols)
        self._predict = predict_fn or model.make_predict_fn()

        pcr = model.point_cloud_range
        self.tile_x = pcr[3] - pcr[0]
        self.tile_y = pcr[4] - pcr[1]
        self.xcell = self.tile_x / self.crop_cols
        # a tile window can straddle crop_cols + 1 x-columns
        self.n_runs = self.crop_cols + 1
        self.max_pts = int(model.tpu_cfg["max_points_static"])
        # the candidate stage reads 2x the point budget: per-run caps then
        # truncate only dense clusters, and the compaction brings the
        # in-window rows down to the budget
        self.rb = max(2 * self.max_pts // self.n_runs // 8 * 8, 8)

    def _tile_origins(self, lo, hi, tile, overlap):
        stride = max(tile - overlap, tile * 0.5)
        n = max(int(np.ceil(max(hi - lo - overlap, 1e-9) / stride)), 1)
        origins = lo + stride * np.arange(n)
        # clamp the last tile inside the scene
        origins = np.minimum(origins, max(hi - tile, lo))
        return np.unique(origins)

    def _merge(self, boxes, scores, labels, valid):
        """(n,) keep mask of the global NMS over (n, 9) boxes, (n,)
        scores, labels and candidate validity, on the model's device."""
        dev = self.model.device
        boxes, scores, labels, valid = (
            torch.as_tensor(a, device=dev)
            for a in (boxes, scores, labels, valid))
        num_classes = max(self.model.num_classes, 1)
        cls_scores = torch.where(
            labels[:, None] == torch.arange(num_classes, device=dev)[None],
            scores[:, None], torch.zeros((), device=dev))
        keep = multiclass_nms(
            boxes, cls_scores,
            score_thr=float(self.model.head_cfg.get("score_thr", 0.1)),
            iou_thr=float(self.model.head_cfg.get("nms_thresh", 0.7)),
            nms_dim=self.model.nms_dim, valid_mask=valid)
        return keep.any(dim=1)

    # ---- host crop path ----------------------------------------------
    def _bucket_sort(self, points, lo):
        """Pre-sort the scene into tile-stride buckets, once: each tile's
        candidates are then the few contiguous bucket slices its window
        overlaps, not a mask over the whole scene."""
        sx = max(self.tile_x - self.overlap, self.tile_x * 0.5)
        sy = max(self.tile_y - self.overlap, self.tile_y * 0.5)
        bx = np.floor((points[:, 0] - lo[0]) / sx).astype(np.int64)
        by = np.floor((points[:, 1] - lo[1]) / sy).astype(np.int64)
        nbx = max(int(bx.max()) + 1, 1)
        nby = max(int(by.max()) + 1, 1)
        bid = bx * nby + by
        order = np.argsort(bid, kind="stable")
        sorted_pts = points[order]
        starts = np.searchsorted(bid[order], np.arange(nbx * nby + 1))
        return sorted_pts, starts, (sx, sy, nbx, nby)

    def _crop_tile(self, sorted_pts, starts, grid, lo, pcr, x0, y0):
        """One tile's in-window points in the local frame, at most the
        point budget of them (a uniform random subset above it)."""
        sx, sy, nbx, nby = grid
        # buckets whose stride cell can intersect [x0, x0 + tile)
        bx0 = max(int(np.floor((x0 - lo[0]) / sx)), 0)
        bx1 = min(int(np.floor((x0 + self.tile_x - lo[0]) / sx)), nbx - 1)
        by0 = max(int(np.floor((y0 - lo[1]) / sy)), 0)
        by1 = min(int(np.floor((y0 + self.tile_y - lo[1]) / sy)), nby - 1)
        parts = []
        for cx in range(bx0, bx1 + 1):
            for cy in range(by0, by1 + 1):
                b = cx * nby + cy
                parts.append(sorted_pts[starts[b]:starts[b + 1]])
        cand = parts[0] if len(parts) == 1 else np.concatenate(parts)
        shift = np.array([x0, y0, lo[2]], np.float32)
        xyz = cand[:, :3]
        sel = np.all((xyz >= pcr[:3] + shift)
                     & (xyz < pcr[3:] + shift), axis=1)
        local = cand[sel]
        local[:, :3] -= shift
        if local.shape[0] > self.max_pts:
            idx = np.random.default_rng(0).choice(
                local.shape[0], self.max_pts, replace=False)
            local = local[idx]
        return local

    # ---- device crop path ----------------------------------------------
    def _sort_scene_cols(self, scene, lo0):
        """Shuffle, then stable-sort the scene rows by (x-column, y).

        The shuffle (``torch.Generator`` seeded 0) makes a truncation
        among equal sort keys a uniform random subset; spatial uniformity
        under truncation comes from the strided gather of
        :meth:`_crop_cols`.

        Returns:
            the (N, C) sorted rows and their (N,) int64 (x-column, y)
            keys, nondecreasing.
        """
        gen = torch.Generator(device=scene.device).manual_seed(0)
        perm = torch.randperm(scene.shape[0], generator=gen,
                              device=scene.device)
        scene = scene[perm]
        xcol = torch.floor((scene[:, 0] - lo0) / self.xcell).to(torch.int32)
        o1 = torch.argsort(scene[:, 1], stable=True)
        o2 = torch.argsort(xcol[o1], stable=True)
        order = o1[o2]
        s = scene[order]
        return s, self._col_y_key(xcol[order], s[:, 1])

    @staticmethod
    def _col_y_key(col, y):
        """Exact int64 key of (int32 column, float32 y) in lexicographic
        order."""
        return (col.to(torch.int64) << 32) + _sortable_y(y)

    def _run_bounds(self, key, shifts, lo0):
        """(T, n_runs) start and length of each tile's run per x-column:
        the rows of column ``c`` with ``y0 <= y < y0 + tile_y``.

        Within a column the rows are y-sorted, so a search for ``(c,
        y0)`` in the keys lands at the column's base plus its count of
        rows with ``y < y0``: the JAX package's masked counts.
        """
        x0, y0 = shifts[:, 0], shifts[:, 1]
        y1 = y0 + torch.tensor(self.tile_y, dtype=torch.float32)
        cx0 = torch.floor((x0 - lo0) / self.xcell).to(torch.int32)
        run_cols = cx0[:, None] + torch.arange(
            self.n_runs, dtype=torch.int32, device=key.device)[None]
        t = run_cols.shape[0]
        lo_key = self._col_y_key(run_cols, y0[:, None].expand(t,
                                                              self.n_runs))
        hi_key = self._col_y_key(run_cols, y1[:, None].expand(t,
                                                              self.n_runs))
        starts = torch.searchsorted(key, lo_key.reshape(-1)).reshape(t, -1)
        ends = torch.searchsorted(key, hi_key.reshape(-1)).reshape(t, -1)
        return starts, ends - starts

    def _crop_cols(self, sorted_scene, key, shifts, lo0, u):
        """(T, max_pts, C) local-frame point buffers of the tiles whose
        (T, 3) ``shifts`` (x0, y0, z0) are given.

        Each of a tile's ``n_runs`` runs is read by one strided gather of
        ``rb`` rows: stride 1 when the run fits (the exact candidates),
        ``len / rb`` when it does not (a systematic spatial subsample of
        the y-sorted run).  The compaction then keeps the point budget:
        in-window rows first in the uniform random order of ``u``, x-margin
        rows as filler, sentinels last.
        """
        n_runs, rb, max_pts = self.n_runs, self.rb, self.max_pts
        n, c = sorted_scene.shape
        t = shifts.shape[0]
        dev = sorted_scene.device
        starts, lens = self._run_bounds(key, shifts, lo0)      # (T, R)

        i = torch.arange(rb, dtype=torch.float32, device=dev)
        stride = lens.clamp(min=rb).to(torch.float32) / rb
        off = torch.floor(i * stride[..., None]).to(torch.int64)  # (T,R,rb)
        valid = off < lens[..., None]
        off = torch.minimum(off, (lens[..., None] - 1).clamp(min=0))
        # a run of length 0 may start at n: its rows are all sentinels
        rows = (starts[..., None] + off).clamp(max=n - 1)
        vals = sorted_scene[rows.reshape(-1)].reshape(t, n_runs * rb, c)
        valid = valid.reshape(t, n_runs * rb)
        local = torch.cat([vals[..., :3] - shifts[:, None], vals[..., 3:]],
                          dim=-1)
        if n_runs * rb < max_pts:   # degenerate tiny budgets
            short = max_pts - n_runs * rb
            local = torch.cat([local, local.new_zeros((t, short, c))], 1)
            valid = torch.cat([valid, valid.new_zeros((t, short))], 1)

        in_win = valid & (local[..., 0] >= 0) & (local[..., 0]
                                                 < self.tile_x)
        order_key = (u + torch.where(in_win, 0.0, 2.0)
                     + torch.where(valid, 0.0, 4.0))
        sel = torch.argsort(order_key, dim=1, stable=True)[:, :max_pts]
        out = torch.gather(local, 1, sel[..., None].expand(t, max_pts, c))
        keep = torch.gather(valid, 1, sel)
        return torch.where(keep[..., None], out,
                           torch.tensor(SENTINEL, dtype=out.dtype,
                                        device=dev))

    def _compaction_draws(self, dev):
        """The compaction's uniform draws (``torch.Generator`` seeded 1),
        one per candidate row, shared by every tile as the JAX package's
        fixed key is."""
        gen = torch.Generator(device=dev).manual_seed(1)
        n = max(self.n_runs * self.rb, self.max_pts)
        return torch.rand((n,), generator=gen, device=dev)

    def __call__(self, points):
        """Detect over a full scene.

        Args:
            points: (N, C) numpy cloud in scene coordinates (feature
                columns as configured for the model).
        Returns:
            list of {'bbox', 'label', 'score'} dicts in scene coordinates.
        """
        points = np.asarray(points, np.float32)
        lo = points[:, :3].min(axis=0)
        hi = points[:, :3].max(axis=0)

        xs = self._tile_origins(lo[0], hi[0], self.tile_x, self.overlap)
        ys = self._tile_origins(lo[1], hi[1], self.tile_y, self.overlap)
        tiles = [(x0, y0) for x0 in xs for y0 in ys]
        max_pts = self.max_pts
        pcr = np.asarray(self.model.point_cloud_range)
        dev = self.model.device

        shifts_np = np.asarray([[x0, y0, lo[2]] for (x0, y0) in tiles],
                               np.float32)
        n_tiles = len(tiles)
        bt = self.batch_tiles
        n_chunks = -(-n_tiles // bt)
        pad_tiles = n_chunks * bt - n_tiles
        if pad_tiles:
            shifts_np = np.concatenate(
                [shifts_np, np.repeat(shifts_np[-1:], pad_tiles, 0)])

        if self.device_crop:
            lo0 = float(lo[0])
            sorted_scene, key = self._sort_scene_cols(
                torch.as_tensor(points, device=dev), lo0)
            shifts = torch.as_tensor(shifts_np, device=dev)
            u = self._compaction_draws(dev)
            num = torch.full((bt,), max_pts, dtype=torch.int32, device=dev)
        else:
            sorted_pts, starts, grid = self._bucket_sort(points, lo)

        # every chunk is enqueued before any result is read back
        pending = []
        for ci in range(n_chunks):
            if self.device_crop:
                batch = {"points": self._crop_cols(
                    sorted_scene, key, shifts[ci * bt:(ci + 1) * bt], lo0,
                    u), "num_points": num}
            else:
                batch_pts = np.zeros((bt, max_pts, points.shape[1]),
                                     np.float32)
                batch_n = np.zeros((bt,), np.int32)
                for j in range(bt):
                    x0, y0 = tiles[min(ci * bt + j, n_tiles - 1)]
                    local = self._crop_tile(sorted_pts, starts, grid, lo,
                                            pcr, x0, y0)
                    batch_pts[j, :local.shape[0]] = local
                    batch_n[j] = local.shape[0]
                batch = {"points": batch_pts, "num_points": batch_n}
            pending.append(self._predict(batch))

        # one copy to the host for the whole scene
        packed = torch.cat([torch.cat(
            [p["bbox"].float(), p["score"][..., None].float(),
             p["label"][..., None].float(), p["valid"][..., None].float()],
            dim=-1) for p in pending]).cpu().numpy()
        all_boxes, all_scores, all_labels = [], [], []
        for t, (x0, y0) in enumerate(tiles):
            v = packed[t, :, 11] > 0
            b = packed[t, v, :9].copy()
            b[:, 0] += x0
            b[:, 1] += y0
            b[:, 2] += lo[2]
            all_boxes.append(b)
            all_scores.append(packed[t, v, 9])
            all_labels.append(packed[t, v, 10].astype(np.int32))
        return self._merge_host(all_boxes, all_scores, all_labels)

    def _merge_host(self, all_boxes, all_scores, all_labels):
        if not all_boxes or sum(len(b) for b in all_boxes) == 0:
            return []
        boxes = np.concatenate(all_boxes)
        scores = np.concatenate(all_scores)
        labels = np.concatenate(all_labels)
        if len(boxes) > self.max_merge_boxes:
            # over the merge budget: keep the top-scoring candidates (a
            # cut in tile order would drop high-scoring detections of
            # later tiles before the global NMS)
            top = np.argsort(-scores, kind="stable")[: self.max_merge_boxes]
            top.sort()  # keep tile order among the survivors
            boxes, scores, labels = boxes[top], scores[top], labels[top]

        n = self.max_merge_boxes
        pb = np.zeros((n, 9), np.float32)
        pb[:len(boxes)] = boxes
        ps = np.zeros((n,), np.float32)
        ps[:len(scores)] = scores
        pl = np.zeros((n,), np.int32)
        pl[:len(labels)] = labels
        pv = np.arange(n) < len(boxes)

        keep = self._merge(pb, ps, pl, pv).cpu().numpy()[:len(boxes)]
        return [{"bbox": boxes[k], "label": int(labels[k]),
                 "score": float(scores[k])}
                for k in np.where(keep)[0]]
