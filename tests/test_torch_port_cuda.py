"""The port's CUDA kernels against their plain versions, on a card.

K1, K2, K3 and K4 are held bit-exact (K1 across its tile edges, rows
and calls; K4 under row maxima and masked rows of every kind); K5, K6 and K7 (the clipper, whose
sine and cosine may differ from PyTorch's in the last bit) within 1e-5 of IoU
or of the volume scale, and exactly 0 wherever the plain
separating-plane test clears a pair.  K5 on random, far-apart, dense
(jittered copies), one-way-cleared, face-gap and non-finite or
zero-size pairs (NaN and inf where the plain version has them), at pair
counts on both sides of a warp and a block, back to back and replayed
from a CUDA graph; its wrapper refuses 2^30 pairs before it allocates.
The train step with gradient accumulation and the eval step run on the
card at the tiny width (float32, TF32 off) against their CPU runs, with
their kernel launches counted.  The conv kernels K8, K9 (forward, and the
backward's dx and dw) and K10 sum in float32 in another order than their
plain versions: in float32 within 1e-4 of the largest element (with TF32
off), in bf16 within 1e-2 (a few bf16 roundings of the output, or of
K8's intermediate, land on the other side).  C8: predict (float32 and
bf16) and three train steps (with and without ``device_augment``) give
the same bits on every run with PyTorch's deterministic mode off.  C9:
K3's wrapper refuses live GT rows with a negative or NaN dim and stays
bit-exact with them masked.  Serving: the flagship predict exported by
``torch.export`` under each knob set, reloaded and called, against the
live predict, with each kernel's launches through the artifact.  The
sharded paths (``parallel/``, tiny width, float32, TF32 off): world 1
over nccl and two ranks sharing the card over gloo against one device
at the CPU tests' tolerances (``rank_cases.check_step``, ``check_preds``),
K1 and K2 launched on every rank.

Marked ``cuda``: without a CUDA device (or without nvcc) every test skips
with its reason.  On the card:

    python -m pytest --noconftest -m cuda -q tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch and the port.)
"""

import shutil

import numpy as np
import pytest
import torch

from objectdetection_3d_tpu_torch.models.assign import make_anchor_layout
from objectdetection_3d_tpu_torch.ops.assign_geometry import (
    chunk_geometry,
    chunk_geometry_plain,
    chunk_tables,
    combo_table,
    containment_rescue,
    containment_rescue_plain,
    rescue_flags,
)
from objectdetection_3d_tpu_torch.ops.fused_stage import (
    fused_stage,
    fused_stage_plain,
)
from objectdetection_3d_tpu_torch.ops.gathered_iou3d import (
    intersection_volume_aligned,
    intersection_volume_aligned_plain,
    iou_gathered,
    iou_gathered_pair,
    iou_gathered_pair_plain,
    iou_gathered_plain,
)
from objectdetection_3d_tpu_torch.ops.grid_scatter import (
    scatter_to_grid,
    scatter_to_grid_plain,
)
from objectdetection_3d_tpu_torch.ops.iou3d import separated_directions
from objectdetection_3d_tpu_torch.ops.pallas_conv import (
    subm_conv3d,
    subm_conv3d_plain,
)
from objectdetection_3d_tpu_torch.ops.voxel_scan import (
    postsort_scan,
    postsort_scan_plain,
)
from objectdetection_3d_tpu_torch.ops.zfold_conv import (
    conv2d_3x3,
    conv2d_3x3_plain,
)
from objectdetection_3d_tpu_torch.scene import jittered

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None and shutil.which("nvcc") is None:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _sorted_rows(rng, b, p, sentinel, n_valid):
    rows = []
    for n in n_valid:
        r = np.sort(rng.integers(0, sentinel, n))
        rows.append(np.concatenate([r, np.full(p - n, sentinel)]))
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("b,p", [(1, 131072), (3, 5000), (2, 1), (4, 4097)])
def test_postsort_scan_kernel_matches_plain(cuda, b, p):
    rng = np.random.default_rng(p)
    sentinel = 997
    n_valid = [int(rng.integers(0, p + 1)) for _ in range(b)]
    n_valid[0] = p
    cells = torch.from_numpy(_sorted_rows(rng, b, p, sentinel, n_valid))
    cells = cells.to(cuda)
    before = postsort_scan.launches
    vox, rank = postsort_scan(cells, sentinel)
    torch.cuda.synchronize()
    assert postsort_scan.launches == before + 1
    want_vox, want_rank = postsort_scan_plain(cells, sentinel)
    assert torch.equal(vox, want_vox)
    assert torch.equal(rank, want_rank)


# K1's tile is 2048 ids: one tile less one, one, one plus one, and 2^20
# ids (512 tiles, the longest carry chain of the reduce-then-scan)
@pytest.mark.parametrize("b,p", [(1, 2047), (1, 2048), (3, 2049),
                                 (1, 1 << 20)])
def test_postsort_scan_tiles_match_plain(cuda, b, p):
    rng = np.random.default_rng(p + b)
    sentinel = p // 4 + 1
    n_valid = [p] + [int(rng.integers(0, p + 1)) for _ in range(b - 1)]
    cells = torch.from_numpy(_sorted_rows(rng, b, p, sentinel, n_valid))
    cells = cells.to(cuda)
    vox, rank = postsort_scan(cells, sentinel)
    want_vox, want_rank = postsort_scan_plain(cells, sentinel)
    assert torch.equal(vox, want_vox)
    assert torch.equal(rank, want_rank)


def test_postsort_scan_rows_restart_on_card(cuda):
    """B = 4 rows without sentinel, each starting with the id the row
    before ends with, and long runs across tiles; then the same with an
    all-sentinel row."""
    rng = np.random.default_rng(4)
    p = 3 * 2048 + 5
    rows, last = [], 0
    for _ in range(4):
        row = last + np.cumsum(rng.random(p) < 0.02)
        rows.append(row - row[0] + last)
        last = int(rows[-1][-1])
    cells = torch.from_numpy(np.stack(rows).astype(np.int32)).to(cuda)
    sentinel = last + 1
    for r in range(1, 4):
        assert cells[r, 0] == cells[r - 1, -1]
    for case in (cells, torch.cat([cells[:2], torch.full_like(
            cells[:1], sentinel), cells[2:3]])):
        vox, rank = postsort_scan(case, sentinel)
        want_vox, want_rank = postsort_scan_plain(case, sentinel)
        assert torch.equal(vox, want_vox)
        assert torch.equal(rank, want_rank)
        assert (vox[:, 0] <= 0).all() and (rank[:, 0] == 0).all()


def test_postsort_scan_back_to_back_calls(cuda):
    """Two calls in a row on different rows, then the first rows again: no
    state carries from one call to the next."""
    rng = np.random.default_rng(5)
    p = 5 * 2048
    a = torch.from_numpy(_sorted_rows(rng, 2, p, 3000, [p, p // 2]))
    b = torch.from_numpy(_sorted_rows(rng, 2, p, 3000, [p // 3, p]))
    a, b = a.to(cuda), b.to(cuda)
    before = postsort_scan.launches
    got = [postsort_scan(x, 3000) for x in (a, b, a)]
    assert postsort_scan.launches == before + 3
    for x, (vox, rank) in zip((a, b, a), got):
        want_vox, want_rank = postsort_scan_plain(x, 3000)
        assert torch.equal(vox, want_vox)
        assert torch.equal(rank, want_rank)


# bytes of grid that one block of K2's zero fill writes
_FILL_BLOCK_BYTES = 512 * 4 * 16


def _fill_edge_ids(n, row_bytes, v):
    """The cells on both sides of every other boundary between K2's fill
    blocks (the blocks between hold no voxel), then padding."""
    ids = set()
    for edge in range(_FILL_BLOCK_BYTES, n * row_bytes,
                      2 * _FILL_BLOCK_BYTES):
        ids.update({(edge - 1) // row_bytes, edge // row_bytes})
    ids = sorted(ids)[:v]
    return np.array(ids + [n] * (v - len(ids)), np.int32)


# (b, d, h, w, c, V, occupied voxels; -1: the cells on the edges of the
# fill's blocks, _fill_edge_ids)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 100, 40, 40, 20, 4096, 3000),
                                   (3, 3, 7, 5, 3, 40, 17),
                                   (2, 2, 8, 8, 4, 16, 0),
                                   (1, 4, 16, 16, 20, 1024, 1024),
                                   (2, 8, 64, 64, 20, 700, -1)])
def test_scatter_to_grid_kernel_matches_plain(cuda, dtype, shape):
    b, d, h, w, c, v, na = shape
    rng = np.random.default_rng(sum(shape))
    n = d * h * w
    ids = np.full((b, v), n, np.int32)
    for i in range(b):
        if na < 0:
            ids[i] = _fill_edge_ids(n, c * torch.finfo(dtype).bits // 8, v)
        else:
            ids[i, :na] = np.sort(rng.choice(n, na, replace=False))
    feats = torch.from_numpy(rng.normal(0, 1, (b, v, c)).astype(np.float32))
    feats = feats.to(cuda, dtype)
    ids = torch.from_numpy(ids).to(cuda)
    before = scatter_to_grid.launches
    got = scatter_to_grid(feats, ids, (d, h, w))
    torch.cuda.synchronize()
    assert scatter_to_grid.launches == before + 1
    assert torch.equal(got, scatter_to_grid_plain(feats, ids, (d, h, w)))
    one = scatter_to_grid(feats[0], ids[0], (d, h, w))
    assert torch.equal(one, got[0])
    # features one element off 16-byte alignment: narrower copy pieces
    shifted = torch.empty(feats.numel() + 1, dtype=dtype, device=cuda)
    shifted = shifted[1:].view_as(feats).copy_(feats)
    assert torch.equal(scatter_to_grid(shifted, ids, (d, h, w)), got)


def test_kernel_wrappers_reject_bad_input(cuda):
    cells = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        postsort_scan(cells.t(), 5)
    feats = torch.zeros((8, 4), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        scatter_to_grid(feats, cells[0], (2, 2, 2))
    # K5's list items hold p << 2: 2^30 pairs (a zero-stride view, 36 GiB
    # if copied) are refused before any copy or allocation
    big = torch.zeros((9,), device=cuda).expand(2 ** 30, 9)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match="2\\^30"):
        intersection_volume_aligned(big, big)
    assert torch.cuda.memory_allocated(cuda) == before


def _random_pairs(rng, p):
    """Random box pairs with identical, face-touching and nested pairs
    among them (the clipper's degenerate cases)."""
    b1 = np.zeros((p, 9), np.float32)
    b1[:, :3] = rng.uniform(-5, 5, (p, 3))
    b1[:, 3:6] = rng.uniform(0.3, 4.0, (p, 3))
    b1[:, 6:9] = rng.uniform(-0.6, 0.6, (p, 3))
    b2 = (b1 + rng.normal(0, 0.8, (p, 9))).astype(np.float32)
    b2[:, 3:6] = np.abs(b2[:, 3:6]) + 0.2
    q = p // 8
    b2[:q] = b1[:q]
    b2[q:2 * q] = b1[q:2 * q]
    b2[q:2 * q, 0] += b1[q:2 * q, 3]
    b2[2 * q:3 * q] = b1[2 * q:3 * q]
    b2[2 * q:3 * q, 3:6] *= 0.5
    return b1, b2


def _separation_cases(rng, g):
    """A (g, 9) table of trunk-like boxes (rows 0-3 upright) and, per row
    id in ids, an aligned box: far apart, 1.2 mm and 0.8 mm beyond a face
    (just outside and inside the separating-plane test's 1 mm margin),
    touching a face, nested, and in each 32-pair run (a warp) alternately
    identical and 20 m away."""
    table = np.zeros((g, 9), np.float32)
    table[:, :2] = rng.uniform(0, 40, (g, 2))
    table[:, 2] = rng.uniform(0, 0.5, g)
    table[:, 3:5] = rng.uniform(0.3, 1.5, (g, 2))
    table[:, 5] = rng.uniform(5, 20, g)
    table[:, 6:9] = rng.uniform(-0.3, 0.3, (g, 3))
    table[:4, 6:9] = 0
    ids, boxes = [], []
    for k in range(8 * 64):
        case = k % 8
        i = int(rng.integers(0, 4 if case in (1, 2, 3) else g))
        b = table[i].copy()
        if case == 0:                          # far apart
            b[:2] += rng.choice([-1, 1], 2) * rng.uniform(10, 30, 2)
        elif case in (1, 2, 3):                # a face gap of 1.2, 0.8, 0 mm
            b[0] += b[3] + (1.2e-3, 0.8e-3, 0.0)[case - 1]
        elif case == 4:                        # nested
            b[3:6] *= 0.5
        elif case == 5:                        # overlapping
            b[:3] += rng.normal(0, 0.3, 3)
            b[6:9] += rng.normal(0, 0.1, 3)
        ids.append(i)
        boxes.append(b)
    # a warp of alternating identical and far-apart pairs
    for lane in range(32):
        i = int(rng.integers(0, g))
        b = table[i].copy()
        if lane % 2:
            b[1] += 20.0
        ids.append(i)
        boxes.append(b)
    return table, np.array(ids, np.int32), np.stack(boxes)


@pytest.mark.parametrize("case", ["random-1", "random-1000", "random-70000",
                                  "separation"])
def test_gathered_iou_kernels_match_plain(cuda, case):
    g = 37
    if case == "separation":
        rng = np.random.default_rng(5)
        table, ids_a, boxes2 = _separation_cases(rng, g)
        p = len(ids_a)
        ids_b = rng.integers(0, g, p).astype(np.int32)
    else:
        p = int(case.split("-")[1])
        rng = np.random.default_rng(p)
        table, boxes2 = _random_pairs(rng, max(p, g))
        table, boxes2 = table[:g], boxes2[:p]
        ids_a = rng.integers(0, g, p).astype(np.int32)
        ids_b = rng.integers(0, g, p).astype(np.int32)
    table = torch.from_numpy(table).to(cuda)
    boxes2 = torch.from_numpy(boxes2).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=g) > 0.2).to(cuda)
    ids_a = torch.from_numpy(ids_a).to(cuda)
    ids_b = torch.from_numpy(ids_b).to(cuda)
    before = (iou_gathered.launches, iou_gathered_pair.launches)
    one = iou_gathered(table, valid, ids_a, boxes2)
    pair = iou_gathered_pair(table, valid, ids_a, ids_b, boxes2)
    torch.cuda.synchronize()
    assert (iou_gathered.launches, iou_gathered_pair.launches) == (
        before[0] + 1, before[1] + 1)
    want_one = iou_gathered_plain(table, valid, ids_a, boxes2)
    want_pair = iou_gathered_pair_plain(table, valid, ids_a, ids_b, boxes2)
    assert (one - want_one).abs().max() <= 1e-5
    for got, want in zip(pair, want_pair):
        assert (got - want).abs().max() <= 1e-5
    assert torch.equal(pair[0], one)
    # pairs the separating-plane test clears are exactly 0 in both
    for ids, got, want in zip((ids_a, ids_b), pair, want_pair):
        cleared = separated_directions(table[ids.long()], boxes2).all(-1)
        assert bool((got[cleared] == 0).all())
        assert bool((want[cleared] == 0).all())
        if case == "separation" and ids is ids_a:
            assert 0 < int(cleared.sum()) < p
            assert int((want > 0).sum()) > 0


def _grid_layout(rng, nc, device):
    sizes = np.array([[0.75, 0.75, 12], [1.3, 1.3, 17], [1.0, 1.75, 20]],
                     np.float32)
    rots = np.array([[0, 0, 0], [0, 0, 1.57], [0.3142, 0, 0],
                     [-0.3142, 0, 0]], np.float32)
    cells = rng.uniform(0, 40, (nc, 3)).astype(np.float32)
    cells[:, 2] = 0.0
    combos = np.array([np.concatenate([s, r]) for s in sizes for r in rots],
                      np.float32)
    anchors = np.concatenate([np.repeat(cells, len(combos), 0),
                              np.tile(combos, (nc, 1))], 1)
    anchors = torch.from_numpy(anchors).to(device)
    return anchors, make_anchor_layout(anchors, len(combos))


# (cells, GTs, rows): the last row masked; every row masked (zero boxes, as
# the padding of a flagship chunk); the second half masked copies of the
# first (as geometry_tier wraps a short last chunk).  12,005 cells are 572
# groups of 21, a ragged last round for K3's persistent blocks.
@pytest.mark.parametrize("nc,gch,rows", [
    pytest.param(160000, 16, "last-masked", id="160000-16"),
    pytest.param(1001, 5, "last-masked", id="1001-5"),
    (12005, 16, "all-masked"), (12005, 16, "wrapped")])
def test_assign_geometry_kernels_bit_exact(cuda, nc, gch, rows):
    rng = np.random.default_rng(nc)
    anchors, layout = _grid_layout(rng, nc, cuda)
    gt = np.zeros((gch, 9), np.float32)
    gt[:, :2] = rng.uniform(0, 40, (gch, 2))
    gt[:, 2] = rng.uniform(0.2, 1.0, gch)
    gt[:, 3:5] = rng.uniform(0.5, 1.0, (gch, 1))
    gt[:, 5] = rng.uniform(10, 14, gch)
    gt[:, 6:9] = rng.uniform(-0.2, 0.2, (gch, 3))
    # a thin upright GT on a cell center, inside that cell's larger anchors
    gt[1] = [*anchors[5, :2].tolist(), 0.5, 0.5, 0.5, 12.0, 0.01, -0.01,
             0.3]
    keep = np.arange(gch) != gch - 1
    if rows == "all-masked":
        gt[:] = 0.0
        keep[:] = False
    elif rows == "wrapped":
        gt[gch // 2:] = gt[:gch - gch // 2]
        keep = np.arange(gch) < gch // 2
    mask = torch.from_numpy(keep).to(cuda)
    ftab, tabs = chunk_tables(torch.from_numpy(gt).to(cuda), mask, layout)
    combo = combo_table(layout)
    gid = torch.arange(3, 3 + gch, dtype=torch.int32, device=cuda)
    before = chunk_geometry.launches
    got = chunk_geometry(ftab, gid, tabs, combo, layout[0], 128)
    want = chunk_geometry_plain(ftab, gid, tabs, combo, layout[0], 128)
    torch.cuda.synchronize()
    assert chunk_geometry.launches == before + 1
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert (int((got["cm"] > 0).sum()) > 0) == (rows != "all-masked")

    rthr = torch.stack([got["rmax"].amax(dim=1),
                        torch.ones(gch, device=cuda)], dim=1).contiguous()
    before = containment_rescue.launches
    hit = containment_rescue(ftab, rthr, tabs, combo, layout[0])
    want_hit = containment_rescue_plain(ftab, rthr, tabs, combo, layout[0])
    torch.cuda.synchronize()
    assert containment_rescue.launches == before + 1
    assert torch.equal(hit, want_hit)
    assert (int(hit.sum()) > 0) == (rows != "all-masked")


def _thin_trunks(rng, anchors, gch):
    """Thin upright GT boxes on cell centres, inside the cells' unrotated
    0.75 x 0.75 x 12 anchors (and the larger ones)."""
    gt = np.zeros((gch, 9), np.float32)
    cells = rng.choice(anchors.shape[0] // 12, gch, replace=False) * 12
    gt[:, :2] = anchors[cells, :2].cpu().numpy()
    gt[:, 2] = rng.uniform(0.1, 0.3, gch)
    gt[:, 3:5] = rng.uniform(0.4, 0.6, (gch, 1))
    gt[:, 5] = rng.uniform(10.0, 11.5, gch)
    return gt


# K4 under row maxima that are not the rows' own containment maxima:
# "ok-zero" (rescue off on every other row), "unreached" (every other row
# max above any IoU), "masked-negative" / "masked-nan" (a masked row
# holding a box with a negative dim / NaNs, rescue allowed), "one-size"
# (each row max the ratio only the smallest anchor size reaches)
@pytest.mark.parametrize("case", ["ok-zero", "unreached", "masked-negative",
                                  "masked-nan", "one-size"])
def test_containment_rescue_kernel_bit_exact(cuda, case):
    rng = np.random.default_rng(len(case))
    nc, gch = 12005, 16
    anchors, layout = _grid_layout(rng, nc, cuda)
    gt = _thin_trunks(rng, anchors, gch)
    keep = np.ones(gch, bool)
    if case.startswith("masked"):
        keep[-1] = False
        gt[-1] = gt[0]
        gt[-1, 3] = -0.5 if case == "masked-negative" else np.nan
        if case == "masked-nan":
            gt[-1, 6] = np.nan
    mask = torch.from_numpy(keep).to(cuda)
    ftab, tabs = chunk_tables(torch.from_numpy(gt).to(cuda), mask, layout)
    combo = combo_table(layout)
    own = chunk_geometry_plain(ftab, torch.arange(gch, dtype=torch.int32,
                                                  device=cuda), tabs,
                               combo, layout[0], gch)["rmax"].amax(dim=1)
    row_max, ok = own.clone(), torch.ones(gch, device=cuda)
    if case == "ok-zero":
        ok[::2] = 0.0
    elif case == "unreached":
        row_max[::2] = 1.5
    elif case.startswith("masked"):
        row_max[-1] = 0.0
    else:
        row_max = ftab[:, 15] / combo[12, 0]
    rthr = torch.stack([row_max, ok], dim=1).contiguous()
    before = containment_rescue.launches
    hit = containment_rescue(ftab, rthr, tabs, combo, layout[0])
    want = containment_rescue_plain(ftab, rthr, tabs, combo, layout[0])
    torch.cuda.synchronize()
    assert containment_rescue.launches == before + 1
    assert torch.equal(hit, want)
    assert int(hit.sum()) > 0
    live = (rescue_flags(ftab, rthr, tabs, combo) & 3) != 0
    if case == "one-size":
        assert live[:, :4].any() and not live[:, 4:].any()
    elif case.startswith("masked"):
        assert not live[-1].any()


def _aligned_pairs(kind, p, rng):
    """(boxes1, boxes2), (p, 9) float32 pairs of one kind for K5."""
    if kind == "random":
        return _random_pairs(rng, p)
    # trunk-like boxes over a 40 x 40 m plot
    b1 = np.zeros((p, 9), np.float32)
    b1[:, :2] = rng.uniform(0, 40, (p, 2))
    b1[:, 3:6] = rng.uniform([0.5, 0.5, 5.0], [1.8, 1.8, 20.0], (p, 3))
    b1[:, 6] = rng.choice([0.0, 0.3142, -0.3142], p)
    b1[:, 8] = rng.choice([0.0, 1.57], p)
    if kind == "far":
        b2 = b1.copy()
        b2[:, :2] += rng.choice([-1, 1], (p, 2)) * rng.uniform(25, 40,
                                                              (p, 2))
        return b1, b2
    if kind == "dense":
        return b1, jittered(b1, rng)
    if kind == "one-way":
        # a small box turned 45 degrees about z, 5 cm beyond a face of a
        # large upright box: all its corners lie beyond that face's plane,
        # but the large box's corners straddle every plane of the small
        # one; odd pairs swap the two boxes
        big = np.zeros((p, 9), np.float32)
        big[:, :2] = rng.uniform(0, 40, (p, 2))
        big[:, 3:6] = rng.uniform(4.0, 8.0, (p, 3))
        small = big.copy()
        small[:, 3:6] = rng.uniform(0.3, 0.6, (p, 3))
        small[:, 0] += big[:, 3] / 2 + small[:, 3] + 0.05
        small[:, 2] += big[:, 5] / 3
        small[:, 8] = np.pi / 4
        odd = np.arange(p) % 2 == 1
        return np.where(odd[:, None], big, small), np.where(odd[:, None],
                                                            small, big)
    if kind == "gaps":
        table, ids, boxes = _separation_cases(rng, 37)
        reps = -(-p // len(ids))
        return (np.tile(table[ids], (reps, 1))[:p],
                np.tile(boxes, (reps, 1))[:p])
    # non-finite and zero-size boxes among random pairs
    b1, b2 = _random_pairs(rng, max(p, 16))
    b1, b2 = b1[:p], b2[:p]
    bad = [(0, 0, np.nan), (1, 3, np.inf), (0, 6, np.nan), (1, 0, -np.inf),
           (0, 5, np.inf), (1, 8, np.nan), (0, 2, 1e30)]
    for i in range(p):
        k = i % (len(bad) + 4)
        if k < len(bad):
            which, field, val = bad[k]
            (b1, b2)[which][i, field] = val
        elif k == len(bad):
            b1[i, 3:6] = 0.0
        elif k == len(bad) + 1:
            b2[i, 3] = 0.0
        elif k == len(bad) + 2:
            # one upright box twice, 3e19 m out on every axis: the fan's
            # products overflow to inf, and inf - inf is NaN
            b1[i, :3] = 3e19
            b1[i, 6:9] = 0.0
            b2[i] = b1[i]
    return b1, b2


_ALIGNED_KINDS = ["random", "far", "dense", "one-way", "gaps", "nonfinite"]


@pytest.mark.parametrize("p", [1, 31, 33, 127, 129, 1000, 70000])
@pytest.mark.parametrize("kind", _ALIGNED_KINDS)
def test_aligned_volume_kernel_matches_plain(cuda, kind, p):
    b1, b2 = _aligned_pairs(kind, p, np.random.default_rng(p + 1))
    b1 = torch.from_numpy(b1).to(cuda)
    b2 = torch.from_numpy(b2).to(cuda)
    before = intersection_volume_aligned.launches
    got = intersection_volume_aligned(b1, b2)
    torch.cuda.synchronize()
    assert intersection_volume_aligned.launches == before + 1
    want = intersection_volume_aligned_plain(b1, b2)
    # NaN and inf where the plain version has them, element for element
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    assert (got[fin] - want[fin]).abs().max() <= \
        1e-5 * want[fin].abs().max()
    sep = separated_directions(b1, b2)
    both = sep.all(-1)
    assert bool((got[both] == 0).all()) and bool((want[both] == 0).all())
    if kind == "far":
        assert bool(both.all())
    elif kind == "dense" and p >= 1000:
        # most copies overlap; a thin box tilted and lifted by up to 0.4
        # of its height can clear its copy
        assert float(both.float().mean()) < 0.1
        assert float((want > 0).float().mean()) > 0.75
    elif kind == "one-way" and p > 1:
        one = sep.any(-1) & ~both
        assert bool(one.all()) and bool(sep[0::2, 0].all()) and \
            bool(sep[1::2, 1].all())
        assert bool((want > 0).sum() == 0)


def test_aligned_volume_graph_replays_and_back_to_back(cuda):
    """Calls in a row on different pairs, then three replays of a CUDA
    graph of one call: each equals its eager call, so the list's count
    starts from zero in every call."""
    rng = np.random.default_rng(9)
    a = [torch.from_numpy(x).to(cuda)
         for x in _aligned_pairs("gaps", 5000, rng)]
    b = [torch.from_numpy(x).to(cuda)
         for x in _aligned_pairs("dense", 3000, rng)]
    eager_a = intersection_volume_aligned(*a)
    eager_b = intersection_volume_aligned(*b)
    again = [intersection_volume_aligned(*x) for x in (a, b, a)]
    torch.cuda.synchronize()
    for got, want in zip(again, (eager_a, eager_b, eager_a)):
        assert torch.equal(got, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        intersection_volume_aligned(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        replayed = intersection_volume_aligned(*a)
    before = intersection_volume_aligned.launches
    for _ in range(3):
        replayed.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager_a)
        # an eager call between replays leaves its own count behind
        assert torch.equal(intersection_volume_aligned(*b), eager_b)
    assert intersection_volume_aligned.launches == before + 3


@pytest.fixture
def exact_fp32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


CONV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _assert_rel(got, want, dtype):
    """got within CONV_TOL[dtype] of want's largest element, where dtype
    is the type the kernel computed in."""
    assert got.dtype == want.dtype
    err = (got.double() - want.double()).abs().max()
    assert err <= CONV_TOL[dtype] * want.double().abs().max(), float(err)


def _normal(rng, shape, scale, device, dtype=torch.float32):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(
        np.float32)).to(device, dtype)


# (B, D, H, W, C, Co): D = 1, 2, 3 (runs shorter than the plane ring);
# D = 100 and 64 on one and four tiles, which the bf16 kernel cuts into
# several z runs; C 20 and 12 (8-byte halo pieces), 16 and 24 (16-byte), 3
# (element by element); Co 20, 32, 64; H, W not multiples of the 8 x 16
# tile; and 325 tiles, more than one wave of blocks.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 7, 16, 24, 20, 20),
                                   (2, 5, 13, 9, 3, 32),
                                   (1, 4, 8, 40, 24, 64),
                                   (1, 1, 8, 16, 20, 20),
                                   (2, 2, 9, 17, 16, 32),
                                   (1, 3, 16, 16, 24, 20),
                                   (1, 100, 8, 16, 20, 20),
                                   (1, 64, 16, 32, 12, 32),
                                   (1, 5, 200, 200, 20, 32)])
def test_subm_conv3d_kernel_matches_plain(cuda, exact_fp32, dtype, shape):
    b, d, h, w, c, co = shape
    rng = np.random.default_rng(sum(shape))
    x = _normal(rng, (b, d, h, w, c), 1.0, cuda, dtype)
    k = _normal(rng, (3, 3, 3, c, co), 0.1, cuda)
    before = subm_conv3d.launches
    got = subm_conv3d(x, k)
    torch.cuda.synchronize()
    assert subm_conv3d.launches == before + 1
    assert got.dtype == dtype
    _assert_rel(got, subm_conv3d_plain(x, k), dtype)


# (N, H, W, C, Co): the bf16 kernel's slice widths 80, 64 x 2, 24, 8
# (Co = 7 and 20 of the dx pass), 40, 72; C not a multiple of 16 (120, 7,
# 20, 24, 40) or of 8 (7, 20: no TMA); H, W not multiples of the tile
# (13 x 7, W < 16); N = 1; and 70 images of 2 x 3 tiles, 420 tiles that
# leave the persistent blocks a ragged last round.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 16, 24, 120, 80),
                                   (2, 9, 13, 128, 128),
                                   (1, 8, 33, 7, 20), (2, 5, 5, 40, 64),
                                   (1, 13, 7, 24, 40),
                                   (2, 11, 19, 128, 72),
                                   (70, 17, 33, 64, 24)])
def test_conv2d_3x3_kernel_and_backward_match_plain(cuda, exact_fp32, dtype,
                                                    shape):
    n, h, w, c, co = shape
    rng = np.random.default_rng(sum(shape))
    x = _normal(rng, (n, h, w, c), 1.0, cuda, dtype)
    k = _normal(rng, (3, 3, c, co), 0.05, cuda)
    g = _normal(rng, (n, h, w, co), 1.0, cuda, dtype)
    before = (conv2d_3x3.launches, conv2d_3x3.dx_launches)
    xa, ka = x.clone().requires_grad_(), k.clone().requires_grad_()
    got = conv2d_3x3(xa, ka)
    got.backward(g)
    torch.cuda.synchronize()
    assert (conv2d_3x3.launches, conv2d_3x3.dx_launches) == (
        before[0] + 1, before[1] + 1)
    xb, kb = x.clone().requires_grad_(), k.clone().requires_grad_()
    want = conv2d_3x3_plain(xb, kb)
    want.backward(g)
    _assert_rel(got.detach(), want.detach(), dtype)
    _assert_rel(xa.grad, xb.grad, dtype)
    assert got.dtype == dtype and ka.grad.dtype == torch.float32
    _assert_rel(ka.grad, kb.grad, dtype)


# (B, D, H, W, C, Co): Co 20, 32, 64 (and 7) over C 20, 32, 3 (and 24,
# 12: 16- and 8-byte halo pieces, and C = 3 loaded element by element);
# D = 3, even and odd; H, W not multiples of the 8 x 16 tile; D = 100 on
# one tile, which the bf16 kernel cuts into z runs of 4 output slices,
# the last of 1; and 200 tiles of 64 channels, more than one wave of
# blocks.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 9, 16, 24, 20, 20),
                                   (2, 7, 13, 9, 20, 32),
                                   (1, 6, 8, 40, 32, 64), (1, 3, 5, 5, 3, 7),
                                   (1, 3, 9, 17, 20, 20),
                                   (1, 8, 16, 16, 20, 32),
                                   (2, 11, 9, 21, 32, 64),
                                   (1, 5, 8, 16, 3, 64),
                                   (1, 6, 11, 35, 24, 20),
                                   (1, 7, 10, 18, 12, 32),
                                   (1, 100, 8, 16, 20, 20),
                                   (1, 7, 160, 160, 32, 64)])
def test_fused_stage_kernel_matches_plain(cuda, exact_fp32, dtype, shape):
    b, d, h, w, c, co = shape
    rng = np.random.default_rng(sum(shape))
    mask = torch.from_numpy(rng.uniform(size=(b, d, h, w)) < 0.4).to(
        cuda, dtype)
    x = _normal(rng, (b, d, h, w, c), 1.0, cuda, dtype) * mask[..., None]
    ks = _normal(rng, (3, 3, 3, c, co), 0.1, cuda)
    kd = _normal(rng, (3, co, co), 0.2, cuda)
    vecs = [torch.from_numpy(v.astype(np.float32)).to(cuda) for v in (
        rng.uniform(0.5, 1.5, co), rng.normal(0, 0.2, co),
        rng.uniform(0.5, 1.5, co), rng.normal(0, 0.2, co))]
    before = fused_stage.launches
    got = fused_stage(x, mask, ks, kd, *vecs)
    torch.cuda.synchronize()
    assert fused_stage.launches == before + 1
    assert tuple(got.shape) == (b, (d - 3) // 2 + 1, h, w, co)
    assert got.dtype == dtype
    _assert_rel(got, fused_stage_plain(x, mask, ks, kd, *vecs), dtype)


def test_conv_wrappers_reject_bad_input(cuda):
    x = torch.zeros((1, 4, 8, 8, 20), device=cuda)
    k3 = torch.zeros((3, 3, 3, 20, 20), device=cuda)
    with pytest.raises(ValueError):            # C > 24
        subm_conv3d(torch.zeros((1, 4, 8, 8, 32), device=cuda),
                    torch.zeros((3, 3, 3, 32, 20), device=cuda))
    with pytest.raises(ValueError):            # float16
        subm_conv3d(x.half(), k3)
    with pytest.raises(ValueError):            # float32 B * D > 65535
        subm_conv3d(torch.zeros((1, 65536, 1, 1, 4), device=cuda),
                    torch.zeros((3, 3, 3, 4, 8), device=cuda))
    # bf16 walks z inside a block: D = 65536 runs
    yb = subm_conv3d(torch.ones((1, 65536, 1, 1, 4), device=cuda,
                                dtype=torch.bfloat16),
                     torch.full((3, 3, 3, 4, 8), 0.5, device=cuda))
    assert bool((yb[0, 1:-1] == 6.0).all())
    assert bool((yb[0, [0, -1]] == 4.0).all())
    with pytest.raises(ValueError):            # C > 128
        conv2d_3x3(torch.zeros((1, 8, 8, 130), device=cuda),
                   torch.zeros((3, 3, 130, 8), device=cuda))
    with pytest.raises(ValueError):            # kernel on the CPU
        conv2d_3x3(x[0], torch.zeros((3, 3, 20, 8)))
    with pytest.raises(ValueError):            # float32 N > 65535
        conv2d_3x3(torch.zeros((65536, 1, 1, 8), device=cuda),
                   torch.zeros((3, 3, 8, 8), device=cuda))
    # bf16 counts tiles, not images: N = 65536 runs
    xb = torch.ones((65536, 1, 1, 8), device=cuda, dtype=torch.bfloat16)
    kb = torch.full((3, 3, 8, 8), 0.5, device=cuda)
    assert bool((conv2d_3x3(xb, kb) == 4.0).all())
    mask = torch.zeros((1, 4, 8, 8), device=cuda)
    kd = torch.zeros((3, 20, 20), device=cuda)
    vec = torch.zeros((20,), device=cuda)
    with pytest.raises(ValueError):            # D < 3
        fused_stage(x[:, :2], mask[:, :2], k3, kd, vec, vec, vec, vec)
    with pytest.raises(ValueError):            # mask of another shape
        fused_stage(x, mask[:, :3], k3, kd, vec, vec, vec, vec)
    with pytest.raises(ValueError):            # C > 32
        fused_stage(torch.zeros((1, 4, 8, 8, 33), device=cuda), mask,
                    torch.zeros((3, 3, 3, 33, 20), device=cuda), kd, vec,
                    vec, vec, vec)
    boxes = torch.zeros((5, 9), device=cuda)
    with pytest.raises(ValueError):            # unaligned pairs
        intersection_volume_aligned(boxes, boxes[:4])


# ---------------------------------------------------------------------------
# the training pipeline's steps on the card
# ---------------------------------------------------------------------------
_STEP_KERNELS = {"postsort_scan": postsort_scan,
                 "scatter_to_grid": scatter_to_grid,
                 "chunk_geometry": chunk_geometry,
                 "containment_rescue": containment_rescue,
                 "iou_gathered": iou_gathered,
                 "iou_gathered_pair": iou_gathered_pair}


def _launch_counts(fn):
    for k in _STEP_KERNELS.values():
        k.launches = 0
    fn()
    torch.cuda.synchronize()
    return {name: k.launches for name, k in _STEP_KERNELS.items()}


def _tiny_models(device):
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.network import init_parameters

    cpu = PointPillars(configs.tiny_model_cfg(), device="cpu")
    init_parameters(cpu.net, torch.Generator().manual_seed(3))
    card = PointPillars(configs.tiny_model_cfg(), device=device)
    card.net.load_state_dict(cpu.net.state_dict())
    return cpu, card


def _recorded_grads(model, store):
    tx = model.get_optimizer(dict(lr=1e-3, betas=(0.95, 0.99),
                                  weight_decay=0.01), grad_clip_value=2.0)
    update = tx.step

    def step(closure=None):
        for name, p in model.net.named_parameters():
            store[name] = p.grad.detach().cpu().clone()
        return update(closure)

    tx.step = step
    return tx


def test_accumulation_step_on_card_matches_cpu(cuda, exact_fp32):
    """Two chunks of one at the tiny width, float32: losses 1e-4, the
    pooled gradient rtol 1e-4 of each leaf's largest element, parameters
    1e-4 / 1e-5 where that gradient is above its tolerance and within
    2 lr elsewhere (AdamW's first step is lr * g / (|g| + 1e-8)), running
    statistics 1e-4 / 1e-5; every kernel of the step launched."""
    from tiny import tiny_batch

    cpu, card = _tiny_models(cuda)
    batch = tiny_batch(batch_size=2, seed=1)
    g_cpu, g_card = {}, {}
    want = cpu.make_train_step(_recorded_grads(cpu, g_cpu),
                               microbatch=1)(batch)
    step = card.make_train_step(_recorded_grads(card, g_card), microbatch=1)
    out = {}
    counts = _launch_counts(lambda: out.update(step(batch)))
    assert all(counts.values()), counts
    assert int(want["num_pos"]) > 0
    assert set(out) == set(want)
    for k in want:
        np.testing.assert_allclose(float(out[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    card_state = {k: v.cpu() for k, v in card.net.state_dict().items()}
    for k, v in cpu.net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(card_state[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            continue
        g = g_cpu[k].abs()
        scale = float(g.max())
        np.testing.assert_allclose(g_card[k].numpy(), g_cpu[k].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=k)
        sure = g > 1e-4 * scale
        diff = (card_state[k] - v).abs()
        assert bool((diff[~sure] <= 2e-3 + 1e-5).all()), k
        np.testing.assert_allclose(card_state[k][sure].numpy(),
                                   v[sure].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_eval_step_launches_one_forward_and_one_assignment(cuda):
    """The eval step's launches are those of one predict forward plus one
    target assignment, every step kernel among them."""
    from tiny import tiny_batch

    _, card = _tiny_models(cuda)
    batch = tiny_batch(batch_size=2, seed=2)
    eval_fn = card.make_eval_fn()
    eval_fn(batch)                                       # warm-up
    counts = _launch_counts(lambda: eval_fn(batch))
    predicted = _launch_counts(lambda: card.predict(batch))
    assigned = _launch_counts(lambda: card.assign(batch))
    assert counts == {k: predicted[k] + assigned[k] for k in counts}
    assert all(counts.values()), counts
    assert counts["postsort_scan"] == counts["scatter_to_grid"] == 1
    losses, preds = eval_fn(batch)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert preds["bbox"].device.type == "cuda"


def test_accelerator_device_names_resolve_to_the_card(cuda):
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import (
        PointPillars,
        resolve_device,
    )
    from objectdetection_3d_tpu_torch.utils import convert_device_name

    for name in ("tpu", "tpu:0", "gpu", "accelerator"):
        assert resolve_device(convert_device_name(name)).type == "cuda"
    model = PointPillars(configs.tiny_model_cfg(),
                         device=convert_device_name("tpu"))
    assert model.anchors.device.type == "cuda"
    assert next(model.net.parameters()).device.type == "cuda"


def test_tiled_inference_on_card(cuda, exact_fp32):
    """Tiled inference at the tiny width on the card: the device crop
    delivers each tile's numpy in-window set (as a multiset), K1 and K2
    launch once per chunk, and, with weights trained on the card until
    they detect, the detections on a scene of two copies of the training
    cloud equal the CPU's host-crop run (a nonzero count and the labels
    exact, boxes within 1e-3)."""
    from tiny import tiny_batch

    from objectdetection_3d_tpu_torch.pipeline.tiled_inference import (
        TiledInference,
    )

    cpu, card = _tiny_models(cuda)
    batch = tiny_batch(batch_size=2, seed=7)
    step = card.make_train_step(card.get_optimizer(
        dict(lr=1e-2, betas=[0.95, 0.99], weight_decay=0.01),
        grad_clip_value=2.0))
    for _ in range(60):
        step(batch)
    cpu.net.load_state_dict(card.net.state_dict())
    rng = np.random.default_rng(3)
    scene = np.concatenate([rng.uniform([0, 0, 0], [20, 14, 3], (1800, 3)),
                            rng.uniform(0, 1, (1800, 1))],
                           axis=1).astype(np.float32)
    recorded = []
    predict = card.make_predict_fn()

    def recording(batch):
        recorded.append(batch["points"].cpu().numpy())
        return predict(batch)

    ti = TiledInference(card, overlap=2.0, batch_tiles=2,
                        predict_fn=recording, max_merge_boxes=64)
    counts = _launch_counts(lambda: ti(scene))
    lo = scene[:, :3].min(0)
    tiles = [(x0, y0)
             for x0 in ti._tile_origins(lo[0], scene[:, 0].max(), 8.0, 2.0)
             for y0 in ti._tile_origins(lo[1], scene[:, 1].max(), 8.0, 2.0)]
    assert counts["postsort_scan"] == counts["scatter_to_grid"] == len(
        recorded) == -(-len(tiles) // 2)
    pcr = np.asarray(card.point_cloud_range, np.float32)
    pts = np.concatenate(recorded)
    for t, (x0, y0) in enumerate(tiles):
        shift = np.array([x0, y0, lo[2]], np.float32)
        inw = np.all((pts[t, :, :3] >= pcr[:3]) & (pts[t, :, :3] < pcr[3:]),
                     axis=1)
        sel = np.all((scene[:, :3] >= pcr[:3] + shift)
                     & (scene[:, :3] < pcr[3:] + shift), axis=1)
        want = scene[sel].copy()
        want[:, :3] -= shift
        assert sorted(map(tuple, np.round(pts[t, inw], 4))) == sorted(
            map(tuple, np.round(want, 4)))
    cloud = batch["points"][0][: int(batch["num_points"][0])]
    shifted = cloud.copy()
    shifted[:, 0] += 8.0
    scene = (np.concatenate([cloud, shifted])
             + np.float32([30.0, 10.0, 5.0, 0.0])).astype(np.float32)
    got = TiledInference(card, overlap=2.0, max_merge_boxes=64)(scene)
    want = TiledInference(cpu, overlap=2.0, max_merge_boxes=64,
                          device_crop=False)(scene)
    assert len(got) == len(want) > 0
    key = lambda d: (d["label"], round(float(d["bbox"][0]), 2))  # noqa: E731
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        assert a["label"] == b["label"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_is_bitwise_reproducible_on_card(cuda, exact_fp32, dtype):
    """C8: two predicts of one batch with PyTorch's deterministic mode
    off give the same bits (the PFN's centroid sums in integers)."""
    from tiny import tiny_batch

    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars

    _, card = _tiny_models(cuda)
    cfg = configs.tiny_model_cfg()
    cfg["tpu"] = dict(cfg["tpu"], compute_dtype=dtype)
    # the seeded weights score every anchor near 0.01: keep them all
    cfg["head"] = dict(cfg["head"], score_thr=0.0)
    model = PointPillars(cfg, device=cuda)
    model.net.load_state_dict(card.net.state_dict())
    assert not torch.are_deterministic_algorithms_enabled()
    batch = tiny_batch(batch_size=2, seed=4)
    first = model.predict(batch)
    for _ in range(3):
        again = model.predict(batch)
        for key in first:
            assert torch.equal(first[key], again[key]), key
    assert bool(first["valid"].any())


@pytest.mark.parametrize("augment", [False, True])
def test_train_steps_are_bitwise_reproducible_on_card(cuda, augment):
    """C8: three train steps from one start, run twice with the
    deterministic mode off, give the same losses and every parameter and
    running statistic bit for bit (with ``device_augment``, from the same
    generator seed)."""
    from tiny import tiny_batch

    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars

    start, _ = _tiny_models(cuda)
    cfg = configs.tiny_model_cfg()
    if augment:
        cfg["device_augment"] = {"rotate": {}, "flip_x": True,
                                 "translate": {"std": 0.3}}
    runs = []
    for _ in range(2):
        model = PointPillars(cfg, device=cuda)
        model.net.load_state_dict(start.net.state_dict())
        step = model.make_train_step(model.get_optimizer(
            dict(lr=1e-3), grad_clip_value=2.0))
        losses = [step(tiny_batch(batch_size=2, seed=s)) for s in (1, 2, 3)]
        runs.append((losses, model.net.state_dict()))
    for a, b in zip(runs[0][0], runs[1][0]):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    for name, val in runs[0][1].items():
        assert torch.equal(val, runs[1][1][name]), name


def test_chunk_geometry_refuses_live_rows_with_negative_dims(cuda):
    """C9: K3 keeps a (GT, cell) containment maximum only where it is
    >= 0, so its wrapper refuses a live GT row with a negative (or NaN)
    dim, naming it; masked rows with negative dims stay bit-exact."""
    rng = np.random.default_rng(7)
    anchors, layout = _grid_layout(rng, 1001, cuda)
    gt = np.zeros((5, 9), np.float32)
    gt[:, :2] = rng.uniform(0, 40, (5, 2))
    gt[:, 3:6] = [0.8, 0.8, 12.0]
    gt[2, 3:6] = -30.0
    gt[4, 4] = np.nan
    combo = combo_table(layout)
    gid = torch.arange(10, 15, dtype=torch.int32, device=cuda)
    for live, named in (([1, 1, 1, 1, 0], "[12]"),
                        ([1, 1, 0, 1, 1], "[14]")):
        mask = torch.tensor(live, dtype=torch.bool, device=cuda)
        ftab, tabs = chunk_tables(torch.from_numpy(gt).to(cuda), mask,
                                  layout)
        before = chunk_geometry.launches
        with pytest.raises(ValueError, match=named.replace("[", r"\[")):
            chunk_geometry(ftab, gid, tabs, combo, layout[0], 128)
        assert chunk_geometry.launches == before
    gt[4, 4] = 0.8
    mask = torch.tensor([1, 1, 0, 1, 1], dtype=torch.bool, device=cuda)
    ftab, tabs = chunk_tables(torch.from_numpy(gt).to(cuda), mask, layout)
    got = chunk_geometry(ftab, gid, tabs, combo, layout[0], 128)
    want = chunk_geometry_plain(ftab, gid, tabs, combo, layout[0], 128)
    torch.cuda.synchronize()
    for name in want:
        assert torch.equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# serving: predict exported with torch.export, reloaded and served
# ---------------------------------------------------------------------------
_SERVING_KNOBS = {
    "default": ({}, {}),
    "fused_stages": ({"fused_stages": True}, {"fused_stage": 3}),
    "pallas_subm_conv+zfold_pallas": (
        {"pallas_subm_conv": True, "zfold_pallas": True},
        {"subm_conv3d": 2, "conv2d_3x3": 1}),
}


@pytest.mark.parametrize("knobs", _SERVING_KNOBS)
def test_serving_round_trip_at_flagship_width_on_card(cuda, knobs,
                                                      tmp_path):
    """The flagship predict (bf16, the trained npz) exported at B = 1,
    saved, reloaded and called on two clouds: labels and ``valid`` exact,
    boxes and scores within 1e-6 of the live predict (the same kernels in
    the same order), and through the artifact each kernel launches as
    often as in the live predict: K1 and K2 once a cloud, K8 3, K10 2 and
    K9 once under their knobs."""
    import os

    from objectdetection_3d_tpu_torch import configs, serving
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.weights import load_npz
    from objectdetection_3d_tpu_torch.scene import make_batch, tree_scene

    tpu, per_cloud = _SERVING_KNOBS[knobs]
    model = PointPillars(configs.flagship_cfg(tpu), device=cuda)
    load_npz(model.net, os.path.join(os.path.dirname(__file__), "..",
                                     "artifacts", "overfit_ckpt.npz"))
    program, manifest = serving.export_predict(model)
    serving.save_exported(program, manifest, str(tmp_path))
    serve, manifest = serving.load_serving(str(tmp_path))
    assert manifest["device"] == "cuda"
    assert manifest["device_name"] == torch.cuda.get_device_name(0)
    counted = {"postsort_scan": postsort_scan,
               "scatter_to_grid": scatter_to_grid,
               "fused_stage": fused_stage, "subm_conv3d": subm_conv3d,
               "conv2d_3x3": conv2d_3x3}
    p = model.tpu_cfg["max_points_static"]
    for seed in (0, 1):
        batch = make_batch(tree_scene(seed), p)
        want = model.predict(batch)
        for fn in counted.values():
            fn.launches = 0
        got = serve(batch)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counted.items()}
        assert launches == {k: {"postsort_scan": 1, "scatter_to_grid": 1,
                                **per_cloud}.get(k, 0) for k in counted}
        assert bool(want["valid"].any())
        for k in ("label", "valid"):
            assert torch.equal(got[k], want[k]), k
        for k in ("bbox", "score"):
            err = float((got[k] - want[k]).abs().max())
            assert err <= 1e-6, (k, err)


# ---------------------------------------------------------------------------
# the sharded paths on the card (parallel/): world 1 over nccl, and two
# ranks sharing the card over gloo
# ---------------------------------------------------------------------------
_PAR_OPT = dict(lr=3e-3, betas=[0.95, 0.99], weight_decay=0.01)
_RANK_KERNELS = ("postsort_scan", "scatter_to_grid", "chunk_geometry",
                 "containment_rescue", "iou_gathered", "iou_gathered_pair")


def _par_case(cuda, kind, mesh, batch, **kw):
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.network import init_parameters
    import rank_cases as rr

    model = PointPillars(configs.tiny_model_cfg(), device=cuda)
    init_parameters(model.net, torch.Generator().manual_seed(3))
    return dict(kind=kind, mesh=mesh, device=str(cuda), exact_fp32=True,
                cfg=configs.tiny_model_cfg(), state=rr.model_state(model),
                opt=_PAR_OPT, clip=2.0, batch=batch, **kw)


def test_world_one_over_nccl_matches_one_device(cuda, exact_fp32,
                                                tmp_path):
    """The sharded step and predict at world 1 over nccl against the
    one-device step and predict; every step kernel launched."""
    import rank_cases as rr
    from objectdetection_3d_tpu_torch.parallel import spawn
    from tiny import tiny_batch

    step = _par_case(cuda, "train", (1, 1), tiny_batch(batch_size=2,
                                                       seed=3))
    pred = _par_case(cuda, "predict", (1, 1), tiny_batch(batch_size=2,
                                                         seed=4),
                     fn="predict")
    (got_step, got_pred), = spawn(rr.run_cases, 1, tmp_path,
                                  args=([step, pred],), backend="nccl")
    rr.check_step([got_step], rr.train(step), _PAR_OPT["lr"])
    assert all(got_step["launches"][k] for k in _RANK_KERNELS)
    want = rr.predict(pred)
    rr.check_preds(got_pred["preds"], want["preds"])
    assert got_pred["launches"] == want["launches"]


def test_two_ranks_share_the_card_over_gloo(cuda, exact_fp32, tmp_path):
    """World 2 on one card over gloo: the data-parallel step, the spatial
    1 x 2 predict and the spatial 1 x 2 step against one device, with
    K1 and K2 launched on every rank."""
    import rank_cases as rr
    from objectdetection_3d_tpu_torch.parallel import spawn
    from tiny import tiny_batch

    cases = [
        _par_case(cuda, "train", (2, 1), tiny_batch(batch_size=4, seed=3)),
        _par_case(cuda, "predict", (1, 2), tiny_batch(batch_size=2,
                                                      seed=9),
                  fn="spatial_predict"),
        _par_case(cuda, "train", (1, 2), tiny_batch(batch_size=2, seed=5),
                  spatial=True),
    ]
    ranks = spawn(rr.run_cases, 2, tmp_path, args=(cases,),
                  backend="gloo")
    rr.check_step([r[0] for r in ranks], rr.train(cases[0]),
                  _PAR_OPT["lr"])
    want = rr.predict(cases[1])["preds"]
    for r in ranks:
        rr.check_preds(r[1]["preds"], want)
    single = dict(cases[2])
    del single["spatial"]
    rr.check_step([r[2] for r in ranks], rr.train(single), _PAR_OPT["lr"])
    for r in ranks:
        for res in r:
            assert res["launches"]["postsort_scan"] > 0
            assert res["launches"]["scatter_to_grid"] > 0
