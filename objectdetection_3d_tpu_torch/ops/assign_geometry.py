"""Target-assignment geometry of a GT chunk against the anchor grid: kernels
K3 (``chunk_geometry``) and K4 (``containment_rescue``).

Port of the JAX package's ``ops/assign_geometry.py``.  The anchor grid is
factored into cells x combos (``models/assign.make_anchor_layout``), so
every per-(GT, anchor) quantity follows from center offsets projected on
6 face axes (3 GT axes + 3 combo axes):

* ``key``: the slab-overlap IoU upper bound minus a 1e-6 axis-distance
  tiebreak, -1e9 for a masked GT; the per-GT top-K ranks anchors by it;
* the closed-form containment IoU (``vol_small / vol_big`` where one box
  holds the other, else 0);
* the SAT "may overlap" flag on the 6 face axes.

The outputs are in the flat cell-major anchor order ``n = cell * M + m``
(the JAX kernel writes combo-major only for its TPU lane layout).

On a CUDA tensor a wrapper launches the hand-written kernel in
``csrc/assign_geometry.cu``; on a CPU tensor it runs the plain version
below.  The plain versions are elementwise tensor code, in the kernel's
order of operations and without ``einsum`` or ``matmul``, so on the card
the two agree bit for bit.  The tables (``chunk_tables``, ``combo_table``)
are tiny and are inputs to both.  A CUDA tensor never takes a plain
version.
"""

import ctypes

import torch

from objectdetection_3d_tpu_torch.ops import cuda_lib
from objectdetection_3d_tpu_torch.ops.boxes import rotation_matrices

#: tiebreak weight on the axis distance (``models/assign._TIEBREAK_EPS``)
_TIEBREAK_EPS = 1e-6

_ARGS_GEOMETRY = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p] * 4
_ARGS_RESCUE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def top3_merge(c1, g1, c2, g2, c3, g3, w, gw):
    """Fold candidate (w, gw) into a running per-anchor top-3 by key.

    Ties keep the incumbent (strict ``>``), so earlier-merged (lower-id)
    GTs win equal keys.
    """
    b1 = w > c1
    n1 = torch.where(b1, w, c1)
    m1 = torch.where(b1, gw, g1)
    w2 = torch.where(b1, c1, w)
    gw2 = torch.where(b1, g1, gw)
    b2 = w2 > c2
    n2 = torch.where(b2, w2, c2)
    m2 = torch.where(b2, gw2, g2)
    w3 = torch.where(b2, c2, w2)
    gw3 = torch.where(b2, g2, gw2)
    b3 = w3 > c3
    n3 = torch.where(b3, w3, c3)
    m3 = torch.where(b3, gw3, g3)
    return n1, m1, n2, m2, n3, m3


def combo_table(layout):
    """(16, M) float32 per-combo constants: rotation (9, row-major), half
    dims (3), volume, and the combo offset on its own axes (3)."""
    _, crot, chalf, cvol, coff = layout
    coff_on_v = torch.einsum("mc,mcj->mj", coff, crot)
    rows = [crot[:, c, j] for c in range(3) for j in range(3)]
    rows += [chalf[:, i] for i in range(3)]
    rows += [cvol]
    rows += [coff_on_v[:, j] for j in range(3)]
    return torch.stack(rows).to(torch.float32).contiguous()


def chunk_tables(gt_boxes, gt_mask, layout):
    """Per-GT tables of one chunk (all tiny).

    Returns:
        ftab: (gch, 17) — u (9, row-major), hg (3), cg.u (3), volg, mask;
        tabs: (4, gch * 3, M) — hap, hgp, corr and cgv: anchor half
            extents cross-projected on the GT axes, GT half extents on the
            combo axes, the combo offset on the GT axes and the GT center
            on the combo axes.
    """
    _, crot, chalf, _, coff = layout
    gch = gt_boxes.shape[0]
    m = crot.shape[0]
    u = rotation_matrices(gt_boxes[:, 6], gt_boxes[:, 7], gt_boxes[:, 8])
    hg = gt_boxes[:, 3:6] / 2
    cg = gt_boxes[:, :3] + u[:, :, 2] * hg[:, 2:3]
    volg = gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5]
    cgu = torch.einsum("gc,gci->gi", cg, u)

    cross = torch.einsum("gki,mkj->gmij", u, crot).abs()
    ha_proj = torch.einsum("gmij,mj->gmi", cross, chalf)   # on gt axes
    hg_proj = torch.einsum("gmij,gi->gmj", cross, hg)      # on combo axes
    corr = torch.einsum("mc,gci->gmi", coff, u)
    cg_on_v = torch.einsum("gc,mcj->gmj", cg, crot)

    ftab = torch.cat([u.reshape(gch, 9), hg, cgu, volg[:, None],
                      gt_mask.to(torch.float32)[:, None]], dim=1)
    tabs = torch.stack([t.permute(0, 2, 1).reshape(gch * 3, m)
                        for t in (ha_proj, hg_proj, corr, cg_on_v)])
    return (ftab.to(torch.float32).contiguous(),
            tabs.to(torch.float32).contiguous())


def _anchor_frame(combo, cells):
    """Per-combo rows (M,) and per-cell columns (Nc, 1) of the grid, and
    the cell centers on the combo axes, (Nc, M) each."""
    cell = [cells[:, c:c + 1] for c in range(3)]
    crot = [[combo[c * 3 + j] for j in range(3)] for c in range(3)]
    cell_on_v = [crot[0][j] * cell[0] + crot[1][j] * cell[1]
                 + crot[2][j] * cell[2] for j in range(3)]
    return cell, cell_on_v


def _containment(ft, tabs, g, combo, cell, cell_on_v, full):
    """The geometry of GT ``g`` against every anchor, (Nc, M) tensors, in
    the kernel's order of operations."""
    hap, hgp, corr, cgv = (tabs[k, g * 3:g * 3 + 3] for k in range(4))
    chalf = [combo[9 + j] for j in range(3)]
    cvol = combo[12]
    coffv = [combo[13 + j] for j in range(3)]
    volg, gmask = ft[15], ft[16]

    pa = d2 = None
    in_a = sep_a = None
    for i in range(3):
        hg = ft[9 + i]
        base = (ft[0 * 3 + i] * cell[0] + ft[1 * 3 + i] * cell[1]
                + ft[2 * 3 + i] * cell[2] - ft[12 + i])
        aa = (base + corr[i]).abs()
        ina = aa <= hg - hap[i]
        in_a = ina if in_a is None else in_a & ina
        if full:
            sepa = aa > hg + hap[i]
            sep_a = sepa if sep_a is None else sep_a | sepa
            wa = torch.clamp(torch.minimum(torch.minimum(
                hg + hap[i] - aa, 2.0 * hg), 2.0 * hap[i]), min=0.0)
            pa = wa if pa is None else pa * wa
            if i == 0:
                d2 = aa * aa
            elif i == 1:
                d2 = d2 + aa * aa
    pb = None
    in_b = sep_b = None
    for j in range(3):
        ab = (cgv[j] - cell_on_v[j] - coffv[j]).abs()
        inb = ab <= chalf[j] - hgp[j]
        in_b = inb if in_b is None else in_b & inb
        if full:
            sepb = ab > chalf[j] + hgp[j]
            sep_b = sepb if sep_b is None else sep_b | sepb
            wb = torch.clamp(torch.minimum(torch.minimum(
                chalf[j] + hgp[j] - ab, 2.0 * chalf[j]), 2.0 * hgp[j]),
                min=0.0)
            pb = wb if pb is None else pb * wb

    ratio_a = cvol / torch.clamp(volg, min=1e-6)
    ratio_b = volg / torch.clamp(cvol, min=1e-6)
    zero = torch.zeros_like(ratio_a)
    iou = torch.where(in_a, ratio_a,
                      torch.where(in_b, ratio_b, zero)) * gmask
    if not full:
        return iou, None, None
    d_axis = torch.sqrt(d2)
    inter = torch.minimum(torch.minimum(pa, pb), torch.minimum(volg, cvol))
    denom = volg + cvol - inter
    ub = torch.where(denom > 1e-6, inter / torch.clamp(denom, min=1e-6),
                     torch.zeros_like(denom))
    key = torch.where(gmask > 0.0, ub - _TIEBREAK_EPS * d_axis,
                      torch.full_like(ub, -1e9))
    maybe = ~(sep_a | sep_b) & (gmask > 0.0)
    return iou, key, maybe


def chunk_geometry_plain(ftab, gid, tabs, combo, cells, g_sentinel):
    """Plain PyTorch version of :func:`chunk_geometry` (same arguments
    and outputs)."""
    gch = ftab.shape[0]
    nc, m = cells.shape[0], combo.shape[1]
    cell, cell_on_v = _anchor_frame(combo, cells)
    dev = cells.device
    shp = (nc, m)
    cm = torch.zeros(shp, dtype=torch.float32, device=dev)
    sent = torch.full(shp, int(g_sentinel), dtype=torch.int32, device=dev)
    cb, a1, a2, a3 = sent, sent, sent, sent
    ninf = torch.full(shp, float("-inf"), dtype=torch.float32, device=dev)
    v1, v2, v3 = ninf, ninf, ninf
    mb = torch.zeros(shp, dtype=torch.bool, device=dev)
    keys, rmax = [], []
    for g in range(gch):
        iou, key, maybe = _containment(ftab[g], tabs, g, combo, cell,
                                       cell_on_v, True)
        gid_g = gid[g].expand(shp)
        keys.append(key.reshape(-1))
        rmax.append(iou.amax(dim=1))
        better = iou > cm
        cm = torch.where(better, iou, cm)
        cb = torch.where(better, gid_g, cb)
        mb = mb | maybe
        v1, a1, v2, a2, v3, a3 = top3_merge(v1, a1, v2, a2, v3, a3, key,
                                            gid_g)
    flat = {k: t.reshape(-1) for k, t in (
        ("cm", cm), ("cb", cb), ("v1", v1), ("a1", a1), ("v2", v2),
        ("a2", a2), ("v3", v3), ("a3", a3), ("mb", mb.to(torch.int32)))}
    return {"key": torch.stack(keys), **flat, "rmax": torch.stack(rmax)}


def rescue_flags(ftab, rthr, tabs, combo):
    """(gch, M) int32 flags of the rescue's (GT, combo) pairs, as K4
    computes them.  Bit 0 (A): ``ratio_a * gmask`` (anchor inside the GT)
    reaches the row max with rescue allowed and is > 0, and the anchor can
    fit in the GT (every ``hg - hap >= 0``); bit 1 (B): the same for
    ``ratio_b`` where the GT can fit in the anchor (every ``chalf - hgp >=
    0``); bit 2 (T), on live pairs: the anchor can fit.  A pair hits iff
    ``(T and in_a) ? A : (B and in_b)``, so a pair with neither A nor B
    never hits."""
    gch, m = ftab.shape[0], combo.shape[1]
    volg, gmask = ftab[:, 15:16], ftab[:, 16:17]
    cvol = combo[12][None, :]
    row_max, ok = rthr[:, 0:1], rthr[:, 1:2] > 0.0
    iou_a = cvol / torch.clamp(volg, min=1e-6) * gmask
    iou_b = volg / torch.clamp(cvol, min=1e-6) * gmask
    hap, hgp = (tabs[k].reshape(gch, 3, m) for k in (0, 1))
    fit_a = (ftab[:, 9:12, None] - hap >= 0.0).all(dim=1)
    fit_b = (combo[9:12][None] - hgp >= 0.0).all(dim=1)
    live_a = (iou_a >= row_max) & ok & (iou_a > 0.0) & fit_a
    live_b = (iou_b >= row_max) & ok & (iou_b > 0.0) & fit_b
    test_a = fit_a & (live_a | live_b)
    return (live_a.to(torch.int32) + 2 * live_b.to(torch.int32)
            + 4 * test_a.to(torch.int32))


def containment_rescue_plain(ftab, rthr, tabs, combo, cells):
    """Plain PyTorch version of :func:`containment_rescue`."""
    cell, cell_on_v = _anchor_frame(combo, cells)
    hit = torch.zeros((cells.shape[0], combo.shape[1]), dtype=torch.bool,
                      device=cells.device)
    for g in range(ftab.shape[0]):
        iou, _, _ = _containment(ftab[g], tabs, g, combo, cell, cell_on_v,
                                 False)
        hit = hit | ((iou >= rthr[g, 0]) & (rthr[g, 1] > 0.0) & (iou > 0.0))
    return hit.reshape(-1).to(torch.int32)


def _check(ftab, tabs, combo, cells, extra):
    """Validate the kernels' inputs; ``extra`` maps a name to (tensor,
    shape, dtype).  Returns (device, gch, M, Nc)."""
    gch, m, nc = ftab.shape[0], combo.shape[1], cells.shape[0]
    f32 = torch.float32
    want = {"ftab": (ftab, (gch, 17), f32),
            "tabs": (tabs, (4, gch * 3, m), f32),
            "combo": (combo, (16, m), f32), "cells": (cells, (nc, 3), f32),
            **extra}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [t for t, _, _ in want.values()]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("inputs lie on different devices")
    dev = cells.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernels take contiguous tensors")
    return dev, gch, m, nc


def chunk_geometry(ftab, gid, tabs, combo, cells, g_sentinel):
    """Fused geometry of one GT chunk against the whole anchor grid.

    Args:
        ftab, tabs: the chunk's tables from :func:`chunk_tables`.
        gid: (gch,) int32 global GT ids, ascending.
        combo: (16, M) from :func:`combo_table`.
        cells: (Nc, 3) float32 cell centers (box bottoms).
        g_sentinel: int stored for "no GT" slots.
    Returns:
        dict of ``key`` (gch, N) float32; per-anchor (N,) ``cm`` (the
        containment max), ``cb`` (its first-achieving GT), ``mb`` (int32
        SAT "may overlap" flag), ``v1..v3`` / ``a1..a3`` (running top-3
        keys and GT ids); and ``rmax`` (gch, Nc), each GT's containment
        maximum over the combos of a cell.  N = Nc * M in flat cell-major
        order.
    Raises:
        ValueError: on the card, for a live GT row (mask > 0) with a
            negative or NaN dim, naming its id.
    """
    dev, gch, m, nc = _check(ftab, tabs, combo, cells, {
        "gid": (gid, (ftab.shape[0],), torch.int32)})
    if dev.type == "cpu":
        return chunk_geometry_plain(ftab, gid, tabs, combo, cells,
                                    g_sentinel)
    # the kernel keeps a (GT, cell) containment maximum only where it is
    # >= 0: a live GT with a negative (or NaN) dim, whose containment IoUs
    # can all be negative, is refused (not while a CUDA graph is being
    # captured: the check reads the flags back to the host)
    if not torch.cuda.is_current_stream_capturing():
        bad = (ftab[:, 16] > 0) & ~(ftab[:, 9:12] >= 0).all(dim=1)
        if bool(bad.any()):
            raise ValueError(
                f"chunk_geometry: GT rows {gid[bad].tolist()} have a "
                f"negative or NaN dim; the kernel takes boxes with "
                f"non-negative dims")
    n = nc * m
    key = torch.empty((gch, n), dtype=torch.float32, device=dev)
    outf = torch.empty((4, n), dtype=torch.float32, device=dev)
    outi = torch.empty((5, n), dtype=torch.int32, device=dev)
    rmax = torch.empty((gch, nc), dtype=torch.float32, device=dev)
    cuda_lib.launch("assign_geometry", "chunk_geometry", _ARGS_GEOMETRY,
                    (ftab.data_ptr(), gid.data_ptr(), tabs.data_ptr(),
                     combo.data_ptr(), cells.data_ptr(), gch, m, nc,
                     int(g_sentinel), key.data_ptr(), outf.data_ptr(),
                     outi.data_ptr(), rmax.data_ptr()), dev)
    chunk_geometry.launches += 1
    cm, v1, v2, v3 = outf
    cb, a1, a2, a3, mb = outi
    return {"key": key, "cm": cm, "cb": cb, "v1": v1, "a1": a1, "v2": v2,
            "a2": a2, "v3": v3, "a3": a3, "mb": mb, "rmax": rmax}


def containment_rescue(ftab, rthr, tabs, combo, cells):
    """(N,) int32: 1 where some GT of the chunk has a containment IoU > 0
    that reaches its row max ``rthr[:, 0]`` with rescue allowed
    (``rthr[:, 1] > 0``)."""
    dev, gch, m, nc = _check(ftab, tabs, combo, cells, {
        "rthr": (rthr, (ftab.shape[0], 2), torch.float32)})
    if dev.type == "cpu":
        return containment_rescue_plain(ftab, rthr, tabs, combo, cells)
    out = torch.empty((nc * m,), dtype=torch.int32, device=dev)
    cuda_lib.launch("assign_geometry", "containment_rescue", _ARGS_RESCUE,
                    (ftab.data_ptr(), rthr.data_ptr(), tabs.data_ptr(),
                     combo.data_ptr(), cells.data_ptr(), gch, m, nc,
                     out.data_ptr()), dev)
    containment_rescue.launches += 1
    return out


chunk_geometry.launches = 0
containment_rescue.launches = 0
