"""Rotated 3D box overlap: the exact volume clipper and the SAT test.

The clipper is the Sutherland-Hodgman computation of the JAX package's
Pallas clipper body (``ops/pallas_iou3d.py::_clip_volumes_blocks``), in
float32: the boundary of the intersection of two convex boxes A and B is
the faces of A clipped into B plus the faces of B clipped into A.  Each of
the 12 quad faces of a pair is clipped by the other box's 6 half-spaces;
the enclosed volume follows from the divergence theorem over the clipped
outward-wound polygons.  What the port keeps of that body:

* the ring storage grows per plane (``_RING_SLOTS`` / ``_RING_CAPS``): a
  convex n-gon clipped by a half-space has at most n + 1 vertices;
* the candidate order (each kept vertex, then its edge's crossing point),
  and ``cnt = min(run, cap)``;
* ``_EPS`` = 1e-6 on the inside test and the crossing denominator, the
  asymmetric ``_SHRINK`` = 1e-5 (A's faces meet B's planes pulled in, B's
  faces meet A's pushed out, so a face plane shared by both boxes counts
  once), and the 1e-6 union guard of the IoU.

Here the slot axis is a tensor dimension, so one clip is a few dozen
tensor ops over (slots, 12 polygons, pairs); pairs are processed in chunks
of ``PAIR_CHUNK`` so that memory stays bounded at any pair count.  The
CUDA kernels of ``ops/gathered_iou3d.py`` run the same arithmetic, one
face per thread.
"""

import torch

from objectdetection_3d_tpu_torch.ops.boxes import (
    _CORNER_SIGNS,
    box_axes,
    box_corners_3d,
)

_EPS = 1e-6
_SHRINK = 1e-5
#: union guard of the IoU ratio
_UNION_EPS = 1e-6
#: ring slots entering clip plane p (geometric max is 4 + p; two slack
#: slots absorb numerically degenerate rings)
_RING_SLOTS = (4, 7, 8, 9, 10, 11)
#: ring slots emitted by plane p (the next plane's input)
_RING_CAPS = (7, 8, 9, 10, 11, 12)
#: quad faces with outward winding (right-hand rule), as corner indices
FACES_OUTWARD = (
    (0, 3, 2, 1),  # bottom (-z)
    (4, 5, 6, 7),  # top    (+z)
    (0, 1, 5, 4),  # y-
    (2, 3, 7, 6),  # y+
    (0, 4, 7, 3),  # x-
    (1, 2, 6, 5),  # x+
)
#: aligned pairs clipped per chunk of the plain clipper
PAIR_CHUNK = 1 << 15
#: how far (metres) beyond ``_EPS`` every corner must lie for the
#: separating-plane test to clear a direction: it covers the rounding of
#: crossing points at tens of metres and sinf/cosf's last bits
SEPARATION_MARGIN = 1e-3


def _rot_entries(rx, ry, rz):
    """Rz @ Ry @ Rx entries as a 3x3 nested list of (T,) tensors."""
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    return [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]


def _corners(fields, r):
    """(8, T) x, y and z of the box corners (bottom-anchored boxes)."""
    x, y, z, dx, dy, dz = fields[:6]
    xs, ys, zs = [], [], []
    for sx_, sy_, sz_ in _CORNER_SIGNS:
        lx = sx_ * dx / 2
        ly = sy_ * dy / 2
        lz = sz_ * dz
        xs.append(x + r[0][0] * lx + r[0][1] * ly + r[0][2] * lz)
        ys.append(y + r[1][0] * lx + r[1][1] * ly + r[1][2] * lz)
        zs.append(z + r[2][0] * lx + r[2][1] * ly + r[2][2] * lz)
    return torch.stack(xs), torch.stack(ys), torch.stack(zs)


def _planes(fields, r):
    """6 outward half-spaces ``n . p <= off`` as (6, T) nx, ny, nz, off,
    in the order +x, -x, +y, -y, +z, -z."""
    x, y, z, dx, dy, dz = fields[:6]
    cxm = x + r[0][2] * dz / 2
    cym = y + r[1][2] * dz / 2
    czm = z + r[2][2] * dz / 2
    out = ([], [], [], [])
    for axis, half in ((0, dx / 2), (1, dy / 2), (2, dz / 2)):
        nx, ny, nz = r[0][axis], r[1][axis], r[2][axis]
        base = nx * cxm + ny * cym + nz * czm
        for plane in ((nx, ny, nz, base + half),
                      (-nx, -ny, -nz, -(base - half))):
            for lst, val in zip(out, plane):
                lst.append(val)
    return tuple(torch.stack(lst) for lst in out)


def _face_volumes(b1, b2, work=None):
    """(12, T) signed volumes under the clipped faces of aligned (T, 9)
    float32 pairs: rows 0-5 box 1's faces in box 2, rows 6-11 box 2's in
    box 1.  Where ``work`` is a dict, it receives (12, T) counts per face:
    ``slots``, the live ring vertices entering the six planes; ``crossings``,
    the crossing points the planes keep; ``triangles``, the fan's terms."""
    f1, f2 = b1.unbind(-1), b2.unbind(-1)
    r1, r2 = _rot_entries(*f1[6:]), _rot_entries(*f2[6:])
    faces = torch.tensor(FACES_OUTWARD, device=b1.device).t()   # (4, 6)
    # rows 0-5: faces of box 1; rows 6-11: faces of box 2 -> (4, 12, T)
    c1, c2 = _corners(f1, r1), _corners(f2, r2)
    vx, vy, vz = (torch.cat([a[faces], b[faces]], dim=1)
                  for a, b in zip(c1, c2))
    t = b1.shape[0]
    cnt = torch.full((12, t), 4, dtype=torch.int32, device=b1.device)

    # box 1's faces meet box 2's planes pulled in by _SHRINK, box 2's
    # faces meet box 1's pushed out: (6 planes, 12 rows, T)
    p1, p2 = _planes(f1, r1), _planes(f2, r2)
    nrm = [torch.cat([b[:, None].expand(6, 6, t), a[:, None].expand(6, 6, t)],
                     dim=1) for a, b in zip(p1[:3], p2[:3])]
    off = torch.cat([(p2[3] - _SHRINK)[:, None].expand(6, 6, t),
                     (p1[3] + _SHRINK)[:, None].expand(6, 6, t)], dim=1)

    for p, (slots, cap) in enumerate(zip(_RING_SLOTS, _RING_CAPS)):
        vx, vy, vz = vx[:slots], vy[:slots], vz[:slots]
        s = nrm[0][p] * vx + nrm[1][p] * vy + nrm[2][p] * vz - off[p]
        inside = s <= _EPS
        i = torch.arange(slots, device=b1.device,
                         dtype=torch.int32)[:, None, None]
        wrap = cnt[None] == i + 1

        def nxt(a, wrap=wrap):
            """Ring successor with the dynamic count."""
            return torch.where(wrap, a[:1], torch.roll(a, -1, 0))

        sn = nxt(s)
        denom = s - sn
        denom = torch.where(denom.abs() > _EPS, denom,
                            torch.full_like(denom, _EPS))
        tt = torch.clamp(s / denom, 0.0, 1.0)
        edge_valid = i < cnt[None]
        # candidate 2i is kept vertex i, candidate 2i+1 the crossing point
        # of edge (i, i+1)
        ok = torch.stack([edge_valid & inside,
                          edge_valid & (inside != (sn <= _EPS))], dim=1)
        ok = ok.reshape(2 * slots, 12, t)
        pos = torch.cumsum(ok, 0, dtype=torch.int32) - ok.int()
        dest = torch.where(ok & (pos < cap), pos, cap).long()
        new = []
        for v in (vx, vy, vz):
            cross = v + tt * (nxt(v) - v)
            cand = torch.stack([v, cross], dim=1).reshape(2 * slots, 12, t)
            buf = torch.zeros((cap + 1, 12, t), dtype=v.dtype,
                              device=v.device)
            new.append(buf.scatter_(0, dest, cand)[:cap])
        vx, vy, vz = new
        if work is not None:
            work["slots"] = work.get("slots", 0) + cnt
            work["crossings"] = work.get("crossings", 0) + (
                ok[1::2] & (pos[1::2] < cap)).sum(0, dtype=torch.int32)
        cnt = torch.clamp(ok.sum(0, dtype=torch.int32), max=cap)

    # divergence-theorem fan over each clipped polygon, in order
    total = torch.zeros((12, t), dtype=b1.dtype, device=b1.device)
    for i in range(1, _RING_CAPS[-1] - 1):
        crx = vy[i] * vz[i + 1] - vz[i] * vy[i + 1]
        cry = vz[i] * vx[i + 1] - vx[i] * vz[i + 1]
        crz = vx[i] * vy[i + 1] - vy[i] * vx[i + 1]
        contrib = vx[0] * crx + vy[0] * cry + vz[0] * crz
        total = total + torch.where(i + 1 < cnt, contrib,
                                    torch.zeros_like(contrib)) / 6.0
    if work is not None:
        work["triangles"] = torch.clamp(cnt - 2, min=0)
    return total


def _clip_chunk(b1, b2):
    """Intersection volumes of aligned (T, 9) float32 pairs -> (T,): the
    12 face volumes summed in row order."""
    total = _face_volumes(b1, b2)
    vol = total[0]
    for row in range(1, 12):
        vol = vol + total[row]
    return vol


def _beyond(corners, planes, shift):
    """(T,) bool: all 8 corners lie beyond one of the 6 planes (offsets
    moved by ``shift``) by more than ``_EPS + SEPARATION_MARGIN``."""
    nx, ny, nz, off = planes
    s = (nx[:, None] * corners[0][None] + ny[:, None] * corners[1][None]
         + nz[:, None] * corners[2][None] - (off + shift)[:, None])
    return (s > _EPS + SEPARATION_MARGIN).all(dim=1).any(dim=0)


def separated_directions(boxes1, boxes2):
    """The separating-plane test that the K5, K6 and K7 kernels run before
    the clip, for aligned (P, 9) pairs -> (P, 2) bool.

    Column 0: all 8 corners of box 1 lie beyond one of box 2's planes
    pulled in by ``_SHRINK`` by more than ``_EPS + SEPARATION_MARGIN``, so
    the clipper keeps no vertex of box 1's faces there and they add
    exactly 0.  Column 1: the same for box 2's corners against box 1's
    planes pushed out.  A pair cleared in both columns has intersection
    volume exactly 0.
    """
    b1 = boxes1.to(torch.float32).reshape(-1, 9)
    b2 = boxes2.to(torch.float32).reshape(-1, 9)
    out = []
    for i in range(0, b1.shape[0], 8 * PAIR_CHUNK):
        f1 = b1[i:i + 8 * PAIR_CHUNK].unbind(-1)
        f2 = b2[i:i + 8 * PAIR_CHUNK].unbind(-1)
        r1, r2 = _rot_entries(*f1[6:]), _rot_entries(*f2[6:])
        out.append(torch.stack([
            _beyond(_corners(f1, r1), _planes(f2, r2), -_SHRINK),
            _beyond(_corners(f2, r2), _planes(f1, r1), _SHRINK)],
            dim=-1))
    if not out:
        return torch.zeros((0, 2), dtype=torch.bool, device=b1.device)
    return torch.cat(out)


def clip_work(boxes1, boxes2, cleared):
    """What the clip of aligned (P, 9) pairs needs on the directions that
    ``cleared`` ((P, 2) bool, as ``separated_directions`` returns it) leaves
    open, counted by the plain clipper on these pairs: a dict of
    ``directions`` (open ones), ``slots`` (live ring vertices entering a
    plane), ``crossings`` (crossing points kept) and ``triangles`` (fan
    terms), each summed over the open directions' faces."""
    b1 = boxes1.to(torch.float32).reshape(-1, 9)
    b2 = boxes2.to(torch.float32).reshape(-1, 9)
    keep = ~cleared.all(-1)
    b1, b2, cleared = b1[keep], b2[keep], cleared[keep]
    out = {"directions": int((~cleared).sum()), "slots": 0, "crossings": 0,
           "triangles": 0}
    for i in range(0, b1.shape[0], PAIR_CHUNK):
        work = {}
        _face_volumes(b1[i:i + PAIR_CHUNK], b2[i:i + PAIR_CHUNK], work)
        c = cleared[i:i + PAIR_CHUNK]
        face_open = ~torch.cat([c[:, :1].expand(-1, 6),
                                c[:, 1:].expand(-1, 6)], dim=1).t()
        for key in ("slots", "crossings", "triangles"):
            out[key] += int((work[key] * face_open).sum())
    return out


def intersection_volume_aligned(boxes1, boxes2):
    """Intersection volumes of aligned (P, 9) box pairs -> (P,) float32,
    in chunks of ``PAIR_CHUNK`` pairs."""
    b1 = boxes1.to(torch.float32).reshape(-1, 9)
    b2 = boxes2.to(torch.float32).reshape(-1, 9)
    if b1.shape != b2.shape:
        raise ValueError(f"unaligned pairs {tuple(boxes1.shape)} and "
                         f"{tuple(boxes2.shape)}")
    if b1.shape[0] == 0:
        return b1.new_zeros((0,))
    return torch.cat([_clip_chunk(b1[i:i + PAIR_CHUNK], b2[i:i + PAIR_CHUNK])
                      for i in range(0, b1.shape[0], PAIR_CHUNK)])


def intersection_volume_3d_aligned(boxes1, boxes2):
    """Elementwise intersection volumes of aligned (N, 9) x (N, 9) boxes
    (the JAX package's name for :func:`intersection_volume_aligned`)."""
    return intersection_volume_aligned(boxes1, boxes2)


def intersection_volume_3d(boxes1, boxes2):
    """Pairwise intersection volumes, (N, 9) x (K, 9) -> (N, K)."""
    n, k = boxes1.shape[0], boxes2.shape[0]
    b1 = boxes1.float()[:, None, :].expand(n, k, 9)
    b2 = boxes2.float()[None, :, :].expand(n, k, 9)
    return intersection_volume_aligned(b1.reshape(-1, 9),
                                       b2.reshape(-1, 9)).reshape(n, k)


def iou3d_upper_bound(boxes1, boxes2):
    """A provable upper bound on the exact pairwise IoU, (N, 9) x (K, 9)
    -> (N, K): the intersection of the corners' axis-aligned envelopes
    bounds the true one, and ``I / (v1 + v2 - I)`` grows with I."""
    c1, c2 = box_corners_3d(boxes1), box_corners_3d(boxes2)
    lo = torch.maximum(c1.amin(dim=-2)[:, None], c2.amin(dim=-2)[None])
    hi = torch.minimum(c1.amax(dim=-2)[:, None], c2.amax(dim=-2)[None])
    inter = torch.clamp(hi - lo, min=0.0).prod(dim=-1)
    denom = _volume(boxes1)[:, None] + _volume(boxes2)[None] - inter
    return torch.where(denom > _EPS, inter / torch.clamp(denom, min=_EPS),
                       torch.zeros_like(denom))


def iou_from_volumes(inter, vol1, vol2, eps=_UNION_EPS):
    """``inter / (vol1 + vol2 - inter)`` with ``inter`` clipped at 0, and 0
    where the union is at most ``eps``."""
    inter = torch.clamp(inter, min=0.0)
    union = vol1 + vol2 - inter
    return torch.where(union > eps, inter / torch.clamp(union, min=eps),
                       torch.zeros_like(union))


def _volume(boxes):
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 5]


def iou3d_aligned(boxes1, boxes2):
    """Exact IoU of aligned rotated boxes (N, 9) x (N, 9) -> (N,)."""
    inter = intersection_volume_aligned(boxes1, boxes2)
    return iou_from_volumes(inter, _volume(boxes1.float()),
                            _volume(boxes2.float()), _EPS)


def iou3d(boxes1, boxes2):
    """Exact pairwise IoU of rotated 3D boxes, (N, 9) x (K, 9) -> (N, K).

    Zero-volume (padding) boxes get IoU 0.
    """
    n, k = boxes1.shape[0], boxes2.shape[0]
    b1 = boxes1.float()[:, None, :].expand(n, k, 9)
    b2 = boxes2.float()[None, :, :].expand(n, k, 9)
    return iou3d_aligned(b1.reshape(-1, 9), b2.reshape(-1, 9)).reshape(n, k)


def obb_intersect(boxes1, boxes2, margin=0.0):
    """Exact pairwise intersection TEST of rotated 3D boxes (SAT).

    Two convex boxes are disjoint iff one of 15 candidate axes separates
    them (3 face normals each + 9 edge cross products).

    Args:
        boxes1: (N, 9), boxes2: (K, 9).
        margin: positive shrinks boxes (stricter), negative expands.
    Returns:
        (N, K) bool intersection matrix.
    """
    rot1, mid1 = box_axes(boxes1)      # (N, 3, 3) columns = axes
    rot2, mid2 = box_axes(boxes2)
    half1 = boxes1[:, 3:6] * 0.5       # (N, 3)
    half2 = boxes2[:, 3:6] * 0.5
    n, k = boxes1.shape[0], boxes2.shape[0]

    ax1 = rot1.transpose(-1, -2)       # (N, 3 axes, 3)
    ax2 = rot2.transpose(-1, -2)       # (K, 3 axes, 3)

    # 15 candidate axes per pair: (N, K, 15, 3)
    a1 = ax1[:, None, :, :].expand(n, k, 3, 3)
    a2 = ax2[None, :, :, :].expand(n, k, 3, 3)
    cross = torch.linalg.cross(a1[:, :, :, None, :].expand(n, k, 3, 3, 3),
                               a2[:, :, None, :, :].expand(n, k, 3, 3, 3),
                               dim=-1)
    cross = cross.reshape(n, k, 9, 3)
    axes = torch.cat([a1, a2, cross], dim=2)
    # degenerate cross products (parallel edges) project everything to 0;
    # normalize defensively and mask them out of the separation test
    norm = torch.linalg.vector_norm(axes, dim=-1, keepdim=True)
    ok_axis = norm[..., 0] > 1e-6
    axes = axes / norm.clamp(min=1e-6)

    d = mid2[None, :, :] - mid1[:, None, :]          # (N, K, 3)
    dist = torch.einsum("nkai,nki->nka", axes, d).abs()
    # projection radii: r = sum_b half_b * |axis . box_axis_b|
    proj1 = torch.einsum("nkai,nbi->nkab", axes, ax1).abs()
    r1 = torch.einsum("nkab,nb->nka", proj1, half1)
    proj2 = torch.einsum("nkai,kbi->nkab", axes, ax2).abs()
    r2 = torch.einsum("nkab,kb->nka", proj2, half2)

    separated = ok_axis & (dist > r1 + r2 + margin)
    return ~separated.any(dim=-1)
