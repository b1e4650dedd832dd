"""Rotated 3D box geometry of the plain reference, in float32.

Boxes are ``(x, y, z, dx, dy, dz, rx, ry, rz)`` with ``z`` at the box
bottom and the rotation ``Rz @ Ry @ Rx`` about the bottom centre.

* :func:`intersection_volume` is the exact volume of the intersection of
  two convex boxes: each of the 12 quad faces of a pair is clipped by the
  other box's six half-spaces (Sutherland-Hodgman) and the enclosed
  volume follows from the divergence theorem.  It is a frozen copy of the
  port's plain clipper (``ops/iou3d.py`` as of this benchmark's first
  version), kept here so that later changes to the port cannot move it.
* :func:`boxes_overlap` is the separating-axis test of two oriented boxes
  (15 candidate axes), written out here.
* :func:`aabb` gives the axis-aligned envelope of a box's corners, which
  bounds where a box can meet another.
"""

import torch

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
#: aligned pairs clipped per chunk
PAIR_CHUNK = 1 << 15
# corner layout: p0=(-,-,z) p1=(+,-,z) p2=(+,+,z) p3=(-,+,z) bottom,
# p4..p7 the same xy at z+dz (top)
_CORNER_SIGNS = (
    (-1.0, -1.0, 0.0), (1.0, -1.0, 0.0), (1.0, 1.0, 0.0), (-1.0, 1.0, 0.0),
    (-1.0, -1.0, 1.0), (1.0, -1.0, 1.0), (1.0, 1.0, 1.0), (-1.0, 1.0, 1.0),
)


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


def _face_volumes(b1, b2):
    """(12, T) signed volumes under the clipped faces of aligned (T, 9)
    float32 pairs: rows 0-5 box 1's faces in box 2, rows 6-11 box 2's in
    box 1."""
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
    return total




def intersection_volume(boxes1, boxes2):
    """Exact intersection volumes of aligned (P, 9) box pairs -> (P,)
    float32, in chunks of ``PAIR_CHUNK`` pairs."""
    b1 = boxes1.to(torch.float32).reshape(-1, 9)
    b2 = boxes2.to(torch.float32).reshape(-1, 9)
    out = [_face_volumes(b1[i:i + PAIR_CHUNK], b2[i:i + PAIR_CHUNK]).sum(0)
           for i in range(0, b1.shape[0], PAIR_CHUNK)]
    return torch.cat(out) if out else b1.new_zeros((0,))


def volume(boxes):
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 5]


def iou_aligned(boxes1, boxes2):
    """Exact IoU of aligned (P, 9) box pairs -> (P,); 0 where the union is
    at most 1e-6."""
    inter = torch.clamp(intersection_volume(boxes1, boxes2), min=0.0)
    union = volume(boxes1.float()) + volume(boxes2.float()) - inter
    return torch.where(union > _UNION_EPS,
                       inter / torch.clamp(union, min=_UNION_EPS),
                       torch.zeros_like(union))


def rotation(boxes):
    """(..., 3, 3) ``Rz @ Ry @ Rx`` of each box's three angles."""
    r = _rot_entries(boxes[..., 6], boxes[..., 7], boxes[..., 8])
    return torch.stack([torch.stack(row, -1) for row in r], -2)


def corners(boxes):
    """(..., 8, 3) corners of each box."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=boxes.dtype,
                         device=boxes.device)
    dims = boxes[..., 3:6]
    half = torch.cat([dims[..., :2] * 0.5, dims[..., 2:3]], dim=-1)
    local = signs * half[..., None, :]
    return local @ rotation(boxes).transpose(-1, -2) + boxes[..., None, :3]


def aabb(boxes):
    """(lo (..., 3), hi (..., 3)): the axis-aligned envelope of each box's
    corners."""
    c = corners(boxes)
    return c.amin(dim=-2), c.amax(dim=-2)


def boxes_overlap(boxes1, boxes2):
    """(N, K) bool: whether box i of (N, 9) ``boxes1`` and box j of (K, 9)
    ``boxes2`` intersect, by the separating-axis test: two convex boxes
    are disjoint iff one of their 3 + 3 face normals or 9 edge cross
    products separates their projections.  Degenerate cross products
    (parallel edges) are left out."""
    rot1, rot2 = rotation(boxes1), rotation(boxes2)      # columns = axes
    mid1 = boxes1[:, :3] + rot1[..., :, 2] * boxes1[:, 5:6] * 0.5
    mid2 = boxes2[:, :3] + rot2[..., :, 2] * boxes2[:, 5:6] * 0.5
    ax1, ax2 = rot1.transpose(-1, -2), rot2.transpose(-1, -2)  # rows
    n, k = boxes1.shape[0], boxes2.shape[0]
    a1 = ax1[:, None].expand(n, k, 3, 3)
    a2 = ax2[None].expand(n, k, 3, 3)
    cross = torch.linalg.cross(a1[:, :, :, None].expand(n, k, 3, 3, 3),
                               a2[:, :, None].expand(n, k, 3, 3, 3), dim=-1)
    axes = torch.cat([a1, a2, cross.reshape(n, k, 9, 3)], dim=2)
    norm = torch.linalg.vector_norm(axes, dim=-1, keepdim=True)
    usable = norm[..., 0] > 1e-6
    axes = axes / norm.clamp(min=1e-6)
    dist = torch.einsum("nkai,nki->nka", axes,
                        mid2[None] - mid1[:, None]).abs()
    r1 = torch.einsum("nkab,nb->nka",
                      torch.einsum("nkai,nbi->nkab", axes, ax1).abs(),
                      boxes1[:, 3:6] * 0.5)
    r2 = torch.einsum("nkab,kb->nka",
                      torch.einsum("nkai,kbi->nkab", axes, ax2).abs(),
                      boxes2[:, 3:6] * 0.5)
    return ~(usable & (dist > r1 + r2)).any(dim=-1)
