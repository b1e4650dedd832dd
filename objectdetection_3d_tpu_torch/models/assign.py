"""Anchor-target assignment for one point cloud.

Port of the JAX package's ``models/assign.py::assign_targets``.  On the
path the flagship runs, the anchor grid is factored into cells x combos
(``layout``) and the tiers are:

1. **Containment, prefilter key and top-3 slots** — K3
   (``ops/assign_geometry.chunk_geometry``) over chunks of 16 GTs gives
   each anchor's exact containment IoU (``vol_small / vol_big`` where one
   box holds the other), the slab-overlap bound's ranking key, the SAT
   "may overlap" flag and the running top-3 GTs by key; each GT's
   top-K anchors by key are its stage-2 candidates.
2. **Exact candidates** — K6 (``ops/gathered_iou3d.iou_gathered``) clips
   the (G, K) candidate pairs.
3. **Exact anchor tier** (``exact_anchor_tier``, on by default) — K7
   (``iou_gathered_pair``) clips every anchor against its top-2 GTs by
   key.
4. **Sound negatives** — an anchor is negative only when its evaluated
   maximum is below threshold and either SAT proves it disjoint from every
   GT or the third key (plus the tiebreak slack) bounds every pair
   evaluated nowhere; anchors the bound cannot clear are ignored.
5. **Rescue** — every anchor reaching a GT's row maximum (over all three
   exact paths) is positive when that maximum reaches the GT's negative
   threshold; K4 (``containment_rescue``) finds the containment achievers.

Without a layout (an anchor grid that does not factor into cells x
combos) the JAX package's layout-free branch runs: each GT's top-K
anchors by an axis-aligned box IoU upper bound (:func:`upper_bound_rows`,
one chunk of GTs at a time), K6 on those candidates, and negatives
proven by the k-th bound of each GT; there is no containment tier, no
exact anchor tier and no rescue by K4.

The prefilter is an exact top-K that takes the lowest anchor index first
among equal keys, for every ``tpu.assign_prefilter``: ``full`` and
``block`` are exact top-Ks in the JAX package too (``block`` up to ties at
the k-th value).  The JAX package runs ``lax.approx_max_k`` at recall 0.99
for ``approx``; on the CPU that is the same exact top-K, on a TPU it may
miss candidates (ROADMAP C3).
"""

import torch

from objectdetection_3d_tpu_torch.models.anchors import BBoxCoder
from objectdetection_3d_tpu_torch.ops import assign_geometry as geo
from objectdetection_3d_tpu_torch.ops import gathered_iou3d
from objectdetection_3d_tpu_torch.ops.boxes import (
    box_corners_3d,
    limit_period,
    rotation_matrices,
)

#: tiebreak weight on the axis distance; the slack it can add to the sound
#: bound is _TIEBREAK_EPS * scene diagonal
_TIEBREAK_EPS = 1e-6
_TIEBREAK_SLACK = _TIEBREAK_EPS * 100.0


def aabb_and_volume(boxes):
    """(lo (..., 3), hi (..., 3), volume (...)) of each box's axis-aligned
    bounding box of its rotated corners, and the box's own volume."""
    corners = box_corners_3d(boxes)
    dims = boxes[..., 3:6]
    return (corners.amin(dim=-2), corners.amax(dim=-2),
            dims[..., 0] * dims[..., 1] * dims[..., 2])


def upper_bound_rows(gt_lo, gt_hi, gt_vol, an_lo, an_hi, an_vol):
    """(G', N) IoU upper bounds of G' GTs against N anchors: the overlap
    of the axis-aligned bounding boxes over the union of the boxes' own
    volumes.  Built one axis at a time, so no (G', N, 3) tensor is
    made."""
    inter = None
    for ax in range(3):
        w = torch.clamp(torch.minimum(gt_hi[:, None, ax], an_hi[None, :, ax])
                        - torch.maximum(gt_lo[:, None, ax],
                                        an_lo[None, :, ax]), min=0.0)
        inter = w if inter is None else inter * w
    denom = gt_vol[:, None] + an_vol[None, :] - inter
    return torch.where(denom > 1e-6, inter / torch.clamp(denom, min=1e-6),
                       torch.zeros_like(denom))


def make_anchor_layout(anchors, num_combos):
    """Factor a flat grid-anchor tensor into (cells x combos) structure.

    Anchor flat order is ``((y*W + x)*S + s)*R + r``: cell-major with
    ``num_combos = S*R`` contiguous combos sharing one cell center, every
    cell repeating the same (size, rotation) combos.

    Args:
        anchors: (N, 9) float32 anchor boxes, N = num_cells * num_combos.
    Returns:
        (cell_centers (Nc, 3) box-bottom centers, combo_rot (M, 3, 3),
        combo_half (M, 3), combo_vol (M,), combo_offset (M, 3)
        bottom-center -> volumetric-center offsets), on anchors' device.
    Raises:
        ValueError: if the anchors do not factor.
    """
    anchors = anchors.to(torch.float32)
    n = anchors.shape[0]
    if n % num_combos:
        raise ValueError(f"{n} anchors do not split into cells of "
                         f"{num_combos} combos")
    a = anchors.reshape(n // num_combos, num_combos, 9)
    if not bool((a[:, :, :3] == a[:, :1, :3]).all()):
        raise ValueError("combos of one cell must share the cell center")
    if not bool((a[:, :, 3:] == a[:1, :, 3:]).all()):
        raise ValueError("every cell must repeat the same combo (size, "
                         "rotation) set")
    cell_centers = a[:, 0, :3].contiguous()
    dims = a[0, :, 3:6]
    rots = a[0, :, 6:9]
    combo_rot = rotation_matrices(rots[:, 0], rots[:, 1], rots[:, 2])
    combo_half = dims / 2
    combo_vol = dims[:, 0] * dims[:, 1] * dims[:, 2]
    combo_offset = combo_rot[:, :, 2] * (dims[:, 2:3] / 2)
    return cell_centers, combo_rot, combo_half, combo_vol, combo_offset


def _merge_best(m1, b1, m2, b2):
    """Merge two (max, best-gt) pairs; ties prefer the LOWER gt index."""
    better2 = (m2 > m1) | ((m2 == m1) & (b2 < b1))
    return torch.maximum(m1, m2), torch.where(better2, b2, b1)


def _tier_exact_pair(gt_boxes, gt_mask, anchors, a1, v1, a2, v2, g,
                     pair_fn):
    """Exact IoU of every anchor against its top-2 selected GTs (tier 3);
    invalid selections (sentinel id, masked GT, all-masked key) give 0."""
    safe1 = torch.clamp(a1, 0, max(g - 1, 0))
    safe2 = torch.clamp(a2, 0, max(g - 1, 0))
    t1, t2 = pair_fn(gt_boxes, gt_mask, safe1, safe2, anchors)
    zero = torch.zeros_like(t1)
    t1 = torch.where((a1 < g) & (v1 > -1e9), t1, zero)
    t2 = torch.where((a2 < g) & (v2 > -1e9), t2, zero)
    return t1, t2


def packed_order_key(x):
    """An int64 key per element of a float tensor whose descending order
    is the value's, then the lowest index along the last dim first.

    The high 32 bits hold an order-preserving int32 image of the float32
    value (bf16 is widened first; ``+ 0.0`` makes -0.0 tie with +0.0);
    the low 32 bits hold the complement of the index.  NaN ranks above
    +inf, every NaN alike, as ``torch.topk`` and ``torch.sort`` rank it.
    The keys of a row are distinct, so any top-k of them is exact.
    """
    x = x.float() + 0.0
    bits = x.view(torch.int32)
    hi = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    hi = torch.where(torch.isnan(x), torch.iinfo(torch.int32).max, hi)
    lo = 0xFFFFFFFF - torch.arange(x.shape[-1], dtype=torch.int64,
                                   device=x.device)
    return (hi.to(torch.int64) << 32) | lo


def topk_rows_lowest_index(key, k):
    """(G', k) indices of each row's k largest values; among equal values
    the lowest index is taken first.  Indices come in ascending order.

    One ``torch.topk`` over :func:`packed_order_key`: the output's shape
    is static and nothing waits for the host.
    """
    idx = torch.topk(packed_order_key(key), k, dim=1).indices
    return torch.sort(idx, dim=1).values


class _Kernels:
    """The four kernels' entry points: the wrappers, or the plain PyTorch
    versions on any device."""

    def __init__(self, plain):
        self.geometry = (geo.chunk_geometry_plain if plain
                         else geo.chunk_geometry)
        self.rescue = (geo.containment_rescue_plain if plain
                       else geo.containment_rescue)
        self.gathered = (gathered_iou3d.iou_gathered_plain if plain
                         else gathered_iou3d.iou_gathered)
        self.pair = (gathered_iou3d.iou_gathered_pair_plain if plain
                     else gathered_iou3d.iou_gathered_pair)


def geometry_tier(gt_boxes, gt_mask, layout, combo_tab, g, k, gt_chunk,
                  geometry_fn):
    """Tier 1 over GT chunks: K3 (``geometry_fn``) per chunk, merged.

    Returns a dict of the per-anchor ``cont_max`` / ``cont_best``
    (containment max, first best GT), ``overlap_possible``, the top-3
    ``v1..v3`` / ``a1..a3``; the per-GT ``cont_row_max``; ``cand_idx``
    (G, K), each GT's top-K anchors by key; and the ``chunks`` (GT ids)
    with their ``tables`` ((ftab, tabs) pairs, which the rescue pass
    reuses: a masked padding row is a GT its own chunk covers).
    """
    cells = layout[0]
    dev = cells.device
    n = cells.shape[0] * layout[1].shape[0]
    # padding rows wrap onto real GTs for equal chunk sizes and are masked
    # out of the geometry (a duplicated GT must not take two top-3 slots)
    chunk = min(gt_chunk, g)
    pad_g = (-g) % chunk
    gt_idx = torch.arange(g + pad_g, device=dev) % max(g, 1)
    chunks = gt_idx.reshape(-1, chunk)
    chunks_ok = (torch.arange(g + pad_g, device=dev) < g).reshape(-1, chunk)

    cont_max = torch.zeros((n,), dtype=torch.float32, device=dev)
    cont_best = torch.full((n,), g, dtype=torch.int32, device=dev)
    overlap_possible = torch.zeros((n,), dtype=torch.bool, device=dev)
    ninf = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    v1, v2, v3 = ninf, ninf, ninf
    a1, a2, a3 = cont_best, cont_best, cont_best
    cand, row_maxes, tables = [], [], []
    for idx_c, ok_c in zip(chunks, chunks_ok):
        ftab, tabs = geo.chunk_tables(gt_boxes[idx_c], gt_mask[idx_c] & ok_c,
                                      layout)
        out = geometry_fn(ftab, idx_c.to(torch.int32), tabs, combo_tab,
                          cells, g)
        cand.append(topk_rows_lowest_index(out["key"], k))
        cont_max, cont_best = _merge_best(cont_max, cont_best, out["cm"],
                                          out["cb"])
        overlap_possible = overlap_possible | (out["mb"] > 0)
        for w, gw in ((out["v1"], out["a1"]), (out["v2"], out["a2"]),
                      (out["v3"], out["a3"])):
            v1, a1, v2, a2, v3, a3 = geo.top3_merge(v1, a1, v2, a2, v3, a3,
                                                    w, gw)
        row_maxes.append(out["rmax"].amax(dim=1))
        tables.append((ftab, tabs))
        del out
    cont_row_max = torch.zeros((g,), dtype=torch.float32, device=dev)
    cont_row_max = cont_row_max.scatter_reduce(
        0, chunks.reshape(-1), torch.cat(row_maxes), "amax")
    return {"cont_max": cont_max, "cont_best": cont_best,
            "overlap_possible": overlap_possible, "v1": v1, "a1": a1,
            "v2": v2, "a2": a2, "v3": v3, "a3": a3,
            "cont_row_max": cont_row_max, "cand_idx": torch.cat(cand)[:g],
            "chunks": chunks, "tables": tables}


def aabb_tier(anchors, gt_boxes, g, k, gt_chunk, anchor_aabb=None):
    """Stage 1 without a layout: each GT's top-K anchors by
    :func:`upper_bound_rows`, over chunks of ``gt_chunk`` GTs, and each
    anchor's bound on the pairs no GT evaluates,
    ``max_g min(ub, kth(g))``: a pair outside its GT's top-K has a bound
    no greater than that GT's k-th.

    Padding rows of the last chunk wrap onto real GTs, as in the JAX
    package: their candidates are cut by ``[:g]`` and, as duplicates,
    they cannot raise the maximum.

    Returns ``(cand_idx (G, K), unev_bound (N,))``.
    """
    n = anchors.shape[0]
    dev = anchors.device
    an_lo, an_hi, an_vol = (aabb_and_volume(anchors) if anchor_aabb is None
                            else anchor_aabb)
    gt_lo, gt_hi, gt_vol = aabb_and_volume(gt_boxes)
    chunk = min(gt_chunk, g)
    pad_g = (-g) % chunk
    chunks = (torch.arange(g + pad_g, device=dev) % max(g, 1)).reshape(
        -1, chunk)
    unev = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    cand = []
    for idx_c in chunks:
        ub = upper_bound_rows(gt_lo[idx_c], gt_hi[idx_c], gt_vol[idx_c],
                              an_lo, an_hi, an_vol)
        idx = topk_rows_lowest_index(ub, k)
        kth = torch.gather(ub, 1, idx).amin(dim=1)
        unev = torch.maximum(unev,
                             torch.minimum(ub, kth[:, None]).amax(dim=0))
        cand.append(idx)
        del ub
    return torch.cat(cand)[:g], unev


def assign_targets(anchors, gt_boxes, gt_labels, gt_mask, pos_thr, neg_thr,
                   layout, candidates_per_gt=512, gt_chunk=16,
                   num_classes=1, combo_tab=None, exact_anchor_tier=True,
                   anchor_aabb=None, plain=False):
    """Assign GT boxes to anchors for one point cloud.

    Positive if the max IoU over GTs reaches ``pos_thr``; negative if below
    ``neg_thr`` (soundly, see the module docstring); the low-quality rescue
    marks every anchor achieving a GT's row max as positive when that max
    reaches ``neg_thr``.  The target is the argmax GT, the lowest index on
    ties.  Thresholds may be (num_classes,) tensors: each anchor is judged
    by the class of its best GT.

    Args:
        anchors: (N, 9) flat anchor boxes.
        gt_boxes: (G, 9) padded GT boxes; gt_labels: (G,) int;
            gt_mask: (G,) bool validity.
        pos_thr, neg_thr: scalars or (num_classes,) tensors.
        layout: the anchor grid's :func:`make_anchor_layout`, or None
            for the layout-free branch (:func:`aabb_tier`).
        candidates_per_gt: K, anchors examined exactly per GT.
        gt_chunk: GTs per chunk (one K3 launch on the layout path, one
            (gt_chunk, N) bound without it).
        combo_tab: the layout's :func:`combo_table` (computed if None).
        exact_anchor_tier: run tier 3 (K7).  False leaves it out, as the
            JAX package does: no tier values, and the unevaluated pairs
            are bounded by the first key ``v1`` instead of the third.
            Read on the layout path only.
        anchor_aabb: the anchors' :func:`aabb_and_volume` (computed if
            None); read without a layout only.
        plain: run the plain PyTorch versions of K3, K4, K6 and K7 on
            whatever device the inputs lie on (the reference route that
            the kernels are held against on the card).
    Returns:
        dict of per-anchor ``pos_mask``, ``neg_mask`` (N,) bool,
        ``best_gt`` (N,) int64 (clipped; meaningful under pos_mask),
        ``max_overlap`` (N,), ``target_deltas`` (N, 9),
        ``target_labels`` (N,) int32 (num_classes for background),
        ``dir_targets`` (N, 3) int32 and ``num_pos`` (int32 scalar).
    """
    ops = _Kernels(plain)
    dev = anchors.device
    n = anchors.shape[0]
    g = gt_boxes.shape[0]
    k = min(candidates_per_gt, n)
    gt_boxes = gt_boxes.to(torch.float32)
    gt_mask = gt_mask.to(torch.bool)
    tier = exact_anchor_tier and layout is not None
    if layout is None:
        cand_idx, unev_bound = aabb_tier(anchors, gt_boxes, g, k, gt_chunk,
                                         anchor_aabb)
        geom = {"cont_max": torch.zeros((n,), dtype=torch.float32,
                                        device=dev),
                "cont_best": torch.full((n,), g, dtype=torch.int32,
                                        device=dev),
                "overlap_possible": torch.ones((n,), dtype=torch.bool,
                                               device=dev),
                "cont_row_max": torch.zeros((g,), dtype=torch.float32,
                                            device=dev),
                "cand_idx": cand_idx}
    else:
        cells = layout[0]
        if n != cells.shape[0] * layout[1].shape[0]:
            raise ValueError("layout does not match the anchor count")
        if combo_tab is None:
            combo_tab = geo.combo_table(layout)
        geom = geometry_tier(gt_boxes, gt_mask, layout, combo_tab, g, k,
                             gt_chunk, ops.geometry)
        v1, a1, v2, a2, v3 = (geom[x]
                              for x in ("v1", "a1", "v2", "a2", "v3"))
    cont_max, cont_best = geom["cont_max"], geom["cont_best"]

    # --- tier 3: every anchor against its top-2 GTs ------------------------
    if tier:
        t1, t2 = _tier_exact_pair(gt_boxes, gt_mask, anchors, a1, v1, a2, v2,
                                  g, ops.pair)
        t2 = torch.where(a2 == a1, torch.zeros_like(t2), t2)  # duplicate
        tier_max = torch.maximum(t1, t2)
        tier_best = torch.where((t1 > t2) | ((t1 == t2) & (a1 <= a2)), a1,
                                a2)
        tier_best = torch.where(tier_max > 0, tier_best,
                                torch.full_like(tier_best, g))
        # sound bound on pairs evaluated nowhere: every GT outside the
        # top-2 has key <= v3, and a pair's true IoU <= its bound <= key +
        # SLACK
        unev_bound = torch.clamp(v3 + _TIEBREAK_SLACK, min=0.0)
    else:
        tier_max = torch.zeros((n,), dtype=torch.float32, device=dev)
        tier_best = torch.full((n,), g, dtype=torch.int32, device=dev)
        if layout is not None:
            # no pair is evaluated by the tier: v1 bounds every GT's key
            unev_bound = torch.clamp(v1 + _TIEBREAK_SLACK, min=0.0)

    # --- tier 2: exact IoU of the (G, K) candidates ------------------------
    cand_idx = geom["cand_idx"]                             # (G, K)
    rows = torch.arange(g, dtype=torch.int32,
                        device=dev)[:, None].expand(g, k).reshape(-1)
    exact = ops.gathered(gt_boxes, gt_mask, rows,
                         anchors[cand_idx.reshape(-1)]).reshape(g, k)
    exact = torch.where(gt_mask[:, None], exact,
                        torch.full_like(exact, -1.0))  # padded GT never wins

    flat_idx = cand_idx.reshape(-1)
    flat_iou = exact.reshape(-1)
    cand_max = torch.zeros((n,), dtype=exact.dtype, device=dev)
    cand_max = torch.clamp(
        cand_max.scatter_reduce(0, flat_idx, flat_iou, "amax"), min=0.0)
    winner = (exact >= cand_max[cand_idx]) & gt_mask[:, None] & (exact > 0)
    g_ids = torch.arange(g, dtype=torch.int32,
                         device=dev)[:, None].expand(g, k)
    cand_best = torch.full((n,), g, dtype=torch.int32, device=dev)
    cand_best = cand_best.scatter_reduce(
        0, flat_idx, torch.where(winner, g_ids, g).reshape(-1), "amin")
    cand_row_max = exact.amax(dim=1)

    # --- merge the three exact paths (ties prefer the lower GT index) ----
    max_overlap, best_gt = _merge_best(cand_max, cand_best, cont_max,
                                       cont_best)
    max_overlap, best_gt = _merge_best(max_overlap, best_gt, tier_max,
                                       tier_best)
    best_gt_clipped = torch.clamp(best_gt, 0, max(g - 1, 0)).long()
    row_max = torch.maximum(cand_row_max, geom["cont_row_max"])
    if tier:
        safe1 = torch.clamp(a1, 0, max(g - 1, 0)).long()
        safe2 = torch.clamp(a2, 0, max(g - 1, 0)).long()
        zeros_g = torch.zeros((g,), dtype=torch.float32, device=dev)
        row_max = torch.maximum(row_max, torch.maximum(
            zeros_g.scatter_reduce(0, safe1, t1, "amax"),
            zeros_g.scatter_reduce(0, safe2, t2, "amax")))

    c = max(num_classes, 1)
    pos_thr = torch.as_tensor(pos_thr, dtype=torch.float32,
                              device=dev) * torch.ones((c,), device=dev)
    neg_thr = torch.as_tensor(neg_thr, dtype=torch.float32,
                              device=dev) * torch.ones((c,), device=dev)
    lbl_safe = torch.clamp(gt_labels.long(), 0, c - 1)
    anchor_lbl = lbl_safe[best_gt_clipped]

    pos = max_overlap >= pos_thr[anchor_lbl]
    neg = ((max_overlap < neg_thr[anchor_lbl])
           & (~geom["overlap_possible"] | (unev_bound < neg_thr.min())))

    rescue_ok = (row_max >= neg_thr[lbl_safe]) & gt_mask          # (G,)
    rescue = (exact >= row_max[:, None]) & rescue_ok[:, None] & (exact > 0)
    pos_extra = torch.zeros((n,), dtype=torch.bool, device=dev)
    pos_extra[flat_idx[rescue.reshape(-1)]] = True
    if tier:
        pos_extra |= (t1 >= row_max[safe1]) & rescue_ok[safe1] & (t1 > 0)
        pos_extra |= (t2 >= row_max[safe2]) & rescue_ok[safe2] & (t2 > 0)
    if layout is not None:
        for idx_c, (ftab, tabs) in zip(geom["chunks"], geom["tables"]):
            rthr = torch.stack([row_max[idx_c],
                                rescue_ok[idx_c].to(torch.float32)], dim=1)
            pos_extra |= ops.rescue(ftab, rthr.contiguous(), tabs,
                                    combo_tab, cells) > 0
    pos = pos | pos_extra
    neg = neg & ~pos

    tgt_boxes = gt_boxes[best_gt_clipped]
    # anchors without a positive target encode against themselves: padded
    # GT rows have zero dims and would put log(0) into the masked loss
    safe_tgt = torch.where(pos[:, None], tgt_boxes, anchors)
    target_deltas = BBoxCoder.encode(anchors, safe_tgt)
    target_labels = torch.where(
        pos, gt_labels.to(torch.int32)[best_gt_clipped],
        torch.full_like(best_gt, num_classes)).to(torch.int32)

    # per-axis 2-bin direction targets: limit to [0, 2 pi), bin =
    # floor(r / pi) % 2
    wrapped = limit_period(tgt_boxes[:, 6:9], 0.0, 2 * torch.pi)
    dir_targets = torch.remainder(
        torch.floor(wrapped / torch.pi).to(torch.int32), 2)

    return {
        "pos_mask": pos,
        "neg_mask": neg,
        "best_gt": best_gt_clipped,
        "max_overlap": max_overlap,
        "target_deltas": target_deltas,
        "target_labels": target_labels,
        "dir_targets": dir_targets,
        "num_pos": pos.sum().to(torch.int32),
    }
