"""Host input pipeline: preprocess, static-shape batching, prefetch.

The port's copy of the JAX package's ``dataset/loader.py``: a padding
batcher that emits fixed-shape numpy arrays, and a background-thread
prefetcher (with an optional thread pool) that overlaps host
preprocessing with the card's work.  Host threads and numpy, as in the
JAX package, so the same seed gives the same batches array for array.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class PreprocessedDataset:
    """Applies model preprocess/transform per item.

    When ``seed`` is given, every item gets its own RNG derived from
    ``(seed, epoch, index)`` and passed to ``preprocess``: augmentation is
    then reproducible regardless of worker count or scheduling order.
    Call ``set_epoch`` each epoch so augmentations differ across epochs.
    """

    def __init__(self, dataset=None, preprocess=None, transform=None,
                 seed=None):
        self.dataset = dataset
        self.preprocess = preprocess
        self.transform = transform
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __getitem__(self, index):
        dataset = self.dataset
        index = index % len(dataset)
        attr = dataset.get_attr(index)
        if self.preprocess:
            if self.seed is not None:
                rng = np.random.default_rng(
                    [int(self.seed), self.epoch, index])
                data = self.preprocess(dataset.get_data(index), attr,
                                       rng=rng)
            else:
                data = self.preprocess(dataset.get_data(index), attr)
        else:
            data = dataset.get_data(index)
        if self.transform is not None:
            data = self.transform(data, attr)
        return {"data": data, "attr": attr}

    def __len__(self):
        return len(self.dataset)


class DetectionBatch:
    """One padded, fixed-shape batch.

    Attributes: the arrays (points, labels, bboxes, ...), the per-item
    attrs, and the padding bookkeeping of the static shapes.
    """

    def __init__(self, arrays, attrs):
        self.arrays = arrays  # dict of numpy arrays
        self.attr = attrs

    @property
    def points(self):
        return self.arrays["points"]

    @property
    def bboxes(self):
        return self.arrays["bboxes"]

    @property
    def labels(self):
        return self.arrays["labels"]

    def unpadded_boxes(self, i):
        """(G_i, 9) valid GT boxes of item i."""
        m = self.arrays["gt_mask"][i]
        return self.arrays["bboxes"][i][m]

    def unpadded_labels(self, i):
        m = self.arrays["gt_mask"][i]
        return self.arrays["labels"][i][m]


class StaticBatcher:
    """Pads per-cloud dicts into fixed-shape arrays.

    Args:
        max_points: per-cloud point budget P (clouds beyond it are randomly
            subsampled — the voxel cap would drop the excess anyway).
        max_gt: GT box budget G (excess boxes dropped with a warning).
        num_features: point feature columns C.
        box_params_num: box parameter count (9).
    """

    def __init__(self, max_points, max_gt, num_features, box_params_num=9,
                 seed=0):
        self.max_points = int(max_points)
        self.max_gt = int(max_gt)
        self.num_features = int(num_features)
        self.box_params_num = int(box_params_num)
        self.rng = np.random.default_rng(seed)

    def collate(self, items):
        b = len(items)
        p, g, c = self.max_points, self.max_gt, self.num_features
        points = np.zeros((b, p, c), np.float32)
        n_points = np.zeros((b,), np.int32)
        boxes = np.zeros((b, g, self.box_params_num), np.float32)
        labels = np.zeros((b, g), np.int32)
        gt_mask = np.zeros((b, g), bool)
        attrs = []

        for i, item in enumerate(items):
            data = item["data"]
            attrs.append(item.get("attr", {}))
            pts = np.asarray(data["point"], np.float32).reshape(-1, c)
            if pts.shape[0] > p:
                sel = self.rng.choice(pts.shape[0], p, replace=False)
                pts = pts[sel]
            points[i, :pts.shape[0]] = pts
            n_points[i] = pts.shape[0]

            bb = np.asarray(data.get("bboxes", np.zeros((0, 9))),
                            np.float32).reshape(-1, self.box_params_num)
            lb = np.asarray(data.get("labels", np.zeros(len(bb))),
                            np.int64).reshape(-1)
            if bb.shape[0] > g:
                print(f"StaticBatcher: dropping {bb.shape[0] - g} GT boxes "
                      f"beyond the static budget {g}")
                bb, lb = bb[:g], lb[:g]
            boxes[i, :bb.shape[0]] = bb
            labels[i, :lb.shape[0]] = lb
            gt_mask[i, :bb.shape[0]] = True

        arrays = {
            "points": points,
            "num_points": n_points,
            "bboxes": boxes,
            "labels": labels,
            "gt_mask": gt_mask,
            # real (non-repeat) items; DataLoader._make flips the repeats
            "item_valid": np.ones((b,), bool),
        }
        return DetectionBatch(arrays, attrs)


class DataLoader:
    """Batched iterator with background-thread prefetch.

    ``num_workers > 1`` fetches the items of each batch through a thread
    pool.  ``np.load`` IO and numpy's larger passes release the GIL;
    per-item RNG seeding in ``PreprocessedDataset`` keeps results
    identical for any worker count.
    """

    def __init__(self, dataset, batcher, batch_size=1, prefetch=2,
                 drop_last=False, num_workers=0):
        self.dataset = dataset
        self.batcher = batcher
        self.batch_size = int(batch_size)
        self.prefetch = int(prefetch)
        self.drop_last = drop_last
        self.num_workers = int(num_workers or 0)
        self._pool = (ThreadPoolExecutor(max_workers=self.num_workers)
                      if self.num_workers > 1 else None)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        n = len(self.dataset)
        idx = list(range(n))
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        batches = self._indices()
        if self._pool is not None:
            yield from self._iter_pooled(batches)
            return
        if self.prefetch <= 0:
            for bidx in batches:
                yield self._make(bidx)
            return

        q = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for bidx in batches:
                    q.put(self._make(bidx))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()

    def _iter_pooled(self, batches):
        """Pool-backed iteration: per-ITEM futures are kept in flight across
        batch boundaries, so workers stay busy even at batch_size 1.
        Batches are yielded strictly in order; collate stays on the consumer
        thread (the batcher's subsampling RNG is therefore race-free)."""
        from collections import deque

        depth = self.num_workers + max(self.prefetch, 1) * self.batch_size
        pending = deque()   # (bidx, [item futures])
        inflight = 0
        it = iter(batches)
        try:
            while True:
                while inflight < depth:
                    try:
                        bidx = next(it)
                    except StopIteration:
                        break
                    futs = [self._pool.submit(self.dataset.__getitem__, i)
                            for i in bidx]
                    inflight += len(futs)
                    pending.append(futs)
                if not pending:
                    break
                futs = pending.popleft()
                items = [f.result() for f in futs]
                inflight -= len(futs)
                yield self._finish(items)
        finally:
            while pending:
                for f in pending.popleft():
                    f.cancel()

    def _make(self, bidx):
        return self._finish([self.dataset[i] for i in bidx])

    def _finish(self, items):
        # short batches are padded by repeating the last item; the repeats
        # are flagged so metrics/losses can ignore them
        pad = self.batch_size - len(items)
        attr_pad = []
        if pad > 0:
            items = items + [items[-1]] * pad
            attr_pad = [True] * pad
        batch = self.batcher.collate(items)
        batch.pad_flags = [False] * (len(items) - len(attr_pad)) + attr_pad
        batch.arrays["item_valid"] = ~np.asarray(batch.pad_flags)
        return batch
