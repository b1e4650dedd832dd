"""Gather-based sparse 3D convolution primitives (``tpu.sparse_middle``).

Port of the JAX package's ``ops/sparse_conv.py``.  The active set of one
cloud is kept sorted by flat cell id in (z, y, x) raster order (the
voxelizer's order) and padded to a static size with a validity mask.
Neighbour lookup goes through a dense int32 cell -> row index map (one
scatter per active set, then plain gathers), and each conv is one
``(V, K*C) @ (K*C, C_out)`` matmul.  Semantics are those of the
dense-masked encoder:

* submanifold conv: outputs only at the input active set, neighbours
  outside it contribute zero;
* strided (3, 1, 1) / (2, 1, 1) conv: the output active set is every site
  that receives at least one active input, built by sorting and
  deduplicating the candidate ids.

Every function takes one cloud; shapes are static.  Nothing here is a
kernel of the JAX package: its gathers, sorts and matmuls are XLA code,
and here PyTorch's.
"""

import torch


def flatten_cells(coords, grid_dhw):
    """(V, 3) int (z, y, x) -> (V,) int32 flat ids in (z, y, x) raster
    order; the sentinel ``D*H*W`` for padding rows (coordinate -1)."""
    d, h, w = grid_dhw
    flat = (coords[:, 0] * h + coords[:, 1]) * w + coords[:, 2]
    return torch.where(coords[:, 0] >= 0, flat, d * h * w).to(torch.int32)


def build_index_map(cell_flat, grid_dhw):
    """Dense cell id -> active row map.

    Args:
        cell_flat: (V,) sorted flat ids, the sentinel ``D*H*W`` for
            padding.
    Returns:
        (D*H*W + 1,) int32: ``map[q]`` is the row of cell q, V where q is
        inactive or q is the sentinel (V addresses the zero row the
        gathers append to the features).

    Padding rows are routed one past the sentinel slot, into a dump slot
    that is cut off: a scatter with repeated indices keeps an arbitrary
    writer, and ``map[sentinel]`` must stay V.
    """
    d, h, w = grid_dhw
    v = cell_flat.shape[0]
    sentinel = d * h * w
    idx = torch.where(cell_flat < sentinel, cell_flat, sentinel + 1).long()
    out = torch.full((sentinel + 2,), v, dtype=torch.int32,
                     device=cell_flat.device)
    out.scatter_(0, idx, torch.arange(v, dtype=torch.int32,
                                      device=cell_flat.device))
    return out[:sentinel + 1]


def neighbor_lookup(cell_flat, query_flat):
    """Binary search of query ids in the sorted active ids (the JAX
    package keeps it as an oracle of the index map).

    Returns:
        (idx, found): idx in [0, V) (clipped), found bool.
    """
    v = cell_flat.shape[0]
    pos = torch.searchsorted(cell_flat, query_flat)
    pos_c = pos.clamp(0, v - 1)
    return pos_c, cell_flat[pos_c] == query_flat


def _zero_padded(feats):
    """``feats`` with a zero row V appended: missing neighbours read it."""
    return torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])


def subm_conv3d_sparse(feats, coords, index_map, active_mask, kernel,
                       grid_dhw):
    """3x3x3 submanifold conv on a sorted sparse active set.

    Args:
        feats: (V, C) active-site features (padding rows zero).
        coords: (V, 3) int (z, y, x).
        index_map: :func:`build_index_map` of this active set.
        active_mask: (V,) bool validity.
        kernel: (3, 3, 3, C, C_out) weights, taps [dz, dy, dx] (the JAX
            layout).
        grid_dhw: (D, H, W).
    Returns:
        (V, C_out) features at the same active set, in ``feats``' dtype
        (the products summed in float32 for bf16 as for float32).
    """
    d, h, w = grid_dhw
    c = feats.shape[1]
    co = kernel.shape[-1]
    z, y, x = coords[:, 0], coords[:, 1], coords[:, 2]
    feats_pad = _zero_padded(feats)
    gathered = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zz, yy, xx = z + dz, y + dy, x + dx
                ok = (active_mask & (zz >= 0) & (zz < d) & (yy >= 0)
                      & (yy < h) & (xx >= 0) & (xx < w))
                q = torch.where(ok, (zz * h + yy) * w + xx, d * h * w)
                gathered.append(feats_pad[index_map[q].long()])
    stacked = torch.cat(gathered, dim=-1)                  # (V, 27*C)
    wmat = kernel.reshape(27 * c, co).to(feats.dtype)
    return (stacked @ wmat) * active_mask[:, None].to(feats.dtype)


def downsample_z_active_set(coords, active_mask, grid_dhw, out_budget):
    """Active set of a (3, 1, 1)-kernel (2, 1, 1)-stride VALID sparse
    conv: (z', y, x) is active iff an input (2z' + k, y, x), k < 3, is.

    The <= 3 candidate output ids of every input are sorted and
    deduplicated, then the unique ids are moved to the front by a stable
    sort of their ranks; no shape depends on the data.

    Returns:
        dict with coords (V', 3) int32 (-1 padding), cell_flat (V',)
        int32, active_mask (V',) bool and the new grid (D', H, W);
        V' = ``out_budget``.
    """
    d, h, w = grid_dhw
    d_out = (d - 3) // 2 + 1
    sentinel = w * h * d_out
    dev = coords.device
    z, y, x = coords[:, 0], coords[:, 1], coords[:, 2]
    cands = []
    for k in range(3):
        zo = z - k
        ok = (active_mask & (zo >= 0) & (zo % 2 == 0)
              & (torch.div(zo, 2, rounding_mode="floor") < d_out))
        zp = torch.div(zo, 2, rounding_mode="floor")
        cands.append(torch.where(ok, (zp * h + y) * w + x, sentinel))
    cand = torch.cat(cands).to(torch.int32)                 # (3V,)
    cand_sorted = torch.sort(cand).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       cand_sorted[1:] != cand_sorted[:-1]])
    first &= cand_sorted < sentinel
    rank = torch.where(first, torch.cumsum(first, 0) - 1, cand.shape[0])
    order = torch.argsort(rank, stable=True)
    take = min(out_budget, cand.shape[0])
    uniq = cand_sorted[order][:take]
    if take < out_budget:
        uniq = torch.cat([uniq, torch.full((out_budget - take,), sentinel,
                                           dtype=uniq.dtype, device=dev)])
    n_out = torch.clamp(first.sum(), max=out_budget)
    mask = torch.arange(out_budget, device=dev) < n_out
    uniq = torch.where(mask, uniq, sentinel).to(torch.int32)
    xo = uniq % w
    yo = torch.div(uniq, w, rounding_mode="floor") % h
    zo = torch.div(uniq, w * h, rounding_mode="floor")
    out_coords = torch.where(mask[:, None], torch.stack([zo, yo, xo], -1),
                             -1).to(torch.int32)
    return {"coords": out_coords, "cell_flat": uniq, "active_mask": mask,
            "grid": (d_out, h, w)}


def strided_z_conv_sparse(feats, in_index_map, out_coords, out_mask,
                          kernel, grid_dhw):
    """(3, 1, 1)-kernel (2, 1, 1)-stride VALID sparse conv.

    Args:
        feats: (V, C) features on the input active set.
        in_index_map: :func:`build_index_map` of the input active set.
        out_coords: (V', 3) output (z', y, x); out_mask: (V',) bool.
        kernel: (3, C, C_out), tap k reads input z = 2z' + k.
        grid_dhw: the input grid (D, H, W).
    Returns:
        (V', C_out).
    """
    d, h, w = grid_dhw
    c = feats.shape[1]
    co = kernel.shape[-1]
    zp, y, x = out_coords[:, 0], out_coords[:, 1], out_coords[:, 2]
    feats_pad = _zero_padded(feats)
    gathered = []
    for k in range(3):
        zi = 2 * zp + k
        ok = out_mask & (zi >= 0) & (zi < d)
        q = torch.where(ok, (zi * h + y) * w + x, d * h * w)
        gathered.append(feats_pad[in_index_map[q].long()])
    stacked = torch.cat(gathered, dim=-1)                   # (V', 3*C)
    wmat = kernel.reshape(3 * c, co).to(feats.dtype)
    return (stacked @ wmat) * out_mask[:, None].to(feats.dtype)


def scatter_pseudo_image(feats, coords, active_mask, grid_dhw):
    """Sparse final-stage features -> dense (C*D, H, W) pseudo-image, its
    channels (C, D)-major as the reference's ``view(N, C*D, H, W)`` (the
    JAX package returns the (H, W, C*D) transpose)."""
    d, h, w = grid_dhw
    c = feats.shape[1]
    cell = flatten_cells(coords, grid_dhw).long()
    cell = torch.where(active_mask, cell, d * h * w)
    img = feats.new_zeros((c, d * h * w + 1))
    img.index_copy_(1, cell, feats.t())
    return img[:, :-1].reshape(c * d, h, w)
