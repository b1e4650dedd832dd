"""Static-shape voxelization, at point granularity or into (V, M, C)
buffers.

Port of the JAX package's ``ops/voxelize.py`` (``_cells_sorted``,
``voxelize_points``, ``_finalize_points_scan``, ``voxelize``,
``Voxelizer``):

1. each point gets a flat cell id in (z, y, x) raster order, or the
   sentinel ``D*H*W`` when it is padding or out of range;
2. points are ordered by (cell, priority, index), the priority being
   -reflectance, a uniform draw (the JAX package's ``shuffle_key`` path,
   here from a ``torch.Generator``) or nothing.  ``torch.sort`` takes one
   key, so two stable sorts compose the order: the priority first, then
   the cell id.  The result is the JAX package's stable two-key
   ``lax.sort`` order, bit for bit, ties included (every padding point
   carries the sentinel);
3. the post-sort scan (``ops/voxel_scan.py``, a CUDA kernel on the card)
   gives each point its run index and in-run rank, and two sorted scatters
   give per-voxel counts and head cells;
4. for the buffers (:func:`voxelize_batch`), each kept point is written to
   slot ``rank`` of its voxel: the JAX package's ``voxelize`` copies the
   first ``M`` points of each run into its slots in the same order.

The whole batch is processed at once: rows are independent clouds.
"""

import torch

from objectdetection_3d_tpu_torch.ops.voxel_scan import postsort_scan


def _grid_of(voxel_size, point_cloud_range):
    return tuple(
        int(round((point_cloud_range[3 + i] - point_cloud_range[i])
                  / voxel_size[i]))
        for i in range(3))


def cells_sorted(points, num_points, *, voxel_size, point_cloud_range,
                 reflectance_sampling=True, generator=None):
    """Sort phase: (B, P) sorted flat cell ids and the (B, P, C) points in
    (cell, priority, index) order.  The priority is -reflectance; without
    ``reflectance_sampling`` a uniform draw from ``generator`` (a
    ``torch.Generator`` on the points' device), else none (input
    order)."""
    b, p, c = points.shape
    dev = points.device
    pcr = torch.tensor(point_cloud_range[:3], dtype=points.dtype, device=dev)
    vsz = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    gx, gy, gz = _grid_of(voxel_size, point_cloud_range)

    idx = torch.arange(p, device=dev)
    valid = idx[None, :] < num_points.to(dev)[:, None]
    cell3 = torch.floor((points[..., :3] - pcr) / vsz).to(torch.int32)
    hi = torch.tensor((gx, gy, gz), dtype=torch.int32, device=dev)
    # a non-finite coordinate is out of range; its int32 conversion is not
    # (NaN converts to 0 on the card and in XLA, which would put the point
    # into a real voxel)
    finite = torch.isfinite(points[..., :3]).all(dim=-1)
    in_range = ((cell3 >= 0) & (cell3 < hi)).all(dim=-1) & finite
    ok = valid & in_range

    sentinel = gx * gy * gz
    cell = (cell3[..., 2] * gy + cell3[..., 1]) * gx + cell3[..., 0]
    cell = torch.where(ok, cell, sentinel).to(torch.int32)

    secondary = None
    if reflectance_sampling:
        secondary = -points[..., 3]
    elif generator is not None:
        secondary = torch.rand((b, p), generator=generator, device=dev,
                               dtype=points.dtype)
    if secondary is not None:
        order = torch.argsort(secondary, dim=1, stable=True)
        cell, by_cell = torch.sort(torch.gather(cell, 1, order), dim=1,
                                   stable=True)
        order = torch.gather(order, 1, by_cell)
    else:
        cell, order = torch.sort(cell, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand(b, p, c))
    return cell, pts_s


def finalize_points_scan(cell_s, pts_s, vox, rank, *, grid,
                         max_points_per_voxel, max_voxels):
    """Point-granularity outputs from the scan's (vox, rank)."""
    b = cell_s.shape[0]
    dev = cell_s.device
    sentinel = grid[0] * grid[1] * grid[2]
    v = max_voxels
    in_rng = cell_s < sentinel
    pt_voxel = torch.where(in_rng, vox.clamp(max=v), v).to(torch.int32)
    pt_valid = in_rng & (vox < v) & (rank < max_points_per_voxel)
    minus1 = torch.full_like(vox, -1)
    num_voxels = (torch.where(in_rng, vox, minus1).amax(dim=1) + 1).clamp(
        max=v).to(torch.int32)
    voxel_mask = (torch.arange(v, device=dev)[None, :]
                  < num_voxels[:, None])
    seg = pt_voxel.long()
    counts = torch.zeros((b, v + 1), dtype=torch.int32, device=dev)
    counts = counts.scatter_add_(1, seg, pt_valid.to(torch.int32))[:, :v]
    # every point of a run carries the same cell id: scatter-min = head
    vcell = torch.full((b, v + 1), sentinel, dtype=torch.int32, device=dev)
    vcell = vcell.scatter_reduce_(1, seg, cell_s, "amin")[:, :v]
    coords = torch.stack([vcell // (grid[0] * grid[1]),
                          (vcell // grid[0]) % grid[1],
                          vcell % grid[0]], dim=-1)
    coords = torch.where(voxel_mask[..., None], coords, -1).to(torch.int32)
    return {
        "points": pts_s,
        "pt_voxel": pt_voxel,
        "pt_valid": pt_valid,
        "coords": coords,
        "num_points_per_voxel": counts,
        "num_voxels": num_voxels,
        "voxel_mask": voxel_mask,
    }


def voxelize_points_batch(points, num_points, *, voxel_size,
                          point_cloud_range, max_points_per_voxel,
                          max_voxels, reflectance_sampling=True,
                          generator=None):
    """Voxelize a padded batch WITHOUT per-voxel buffers.

    Args:
        points: (B, P, C) float points, the first ``num_points[b]`` rows of
            each item valid; columns 0-2 are xyz, column 3 reflectance.
        num_points: (B,) valid counts.
    Returns:
        dict with (per item, batched on dim 0)
            points: (P, C) cell-sorted points,
            pt_voxel: (P,) int32 voxel index of each point; ``max_voxels``
                for out-of-range / overflow points (a dump slot),
            pt_valid: (P,) bool — in range, voxel kept, within the cap,
            coords: (V, 3) int32 (z, y, x), -1 for padding voxels,
            num_points_per_voxel: (V,) int32 capped counts,
            num_voxels: int32,
            voxel_mask: (V,) bool.
        ``generator``: see :func:`cells_sorted`.
    """
    return _voxelize_points_ranked(
        points, num_points, voxel_size=voxel_size,
        point_cloud_range=point_cloud_range,
        max_points_per_voxel=max_points_per_voxel, max_voxels=max_voxels,
        reflectance_sampling=reflectance_sampling, generator=generator)[0]


def _voxelize_points_ranked(points, num_points, *, voxel_size,
                            point_cloud_range, max_points_per_voxel,
                            max_voxels, reflectance_sampling, generator):
    """:func:`voxelize_points_batch`'s dict and the (B, P) slot of each
    sorted point in its voxel (read where ``pt_valid``)."""
    grid = _grid_of(voxel_size, point_cloud_range)
    cell_s, pts_s = cells_sorted(
        points, num_points, voxel_size=voxel_size,
        point_cloud_range=point_cloud_range,
        reflectance_sampling=reflectance_sampling, generator=generator)
    vox, rank = postsort_scan(cell_s, grid[0] * grid[1] * grid[2])
    return finalize_points_scan(
        cell_s, pts_s, vox, rank, grid=grid,
        max_points_per_voxel=max_points_per_voxel,
        max_voxels=max_voxels), rank


def voxelize_points(points, num_points, *, voxel_size, point_cloud_range,
                    max_points_per_voxel, max_voxels,
                    reflectance_sampling=True):
    """One padded (P, C) cloud; the outputs of
    :func:`voxelize_points_batch` without the batch dimension."""
    n = torch.as_tensor(num_points, device=points.device).reshape(1)
    out = voxelize_points_batch(
        points[None], n, voxel_size=voxel_size,
        point_cloud_range=point_cloud_range,
        max_points_per_voxel=max_points_per_voxel, max_voxels=max_voxels,
        reflectance_sampling=reflectance_sampling)
    return {k: val[0] for k, val in out.items()}


def voxelize_batch(points, num_points, *, voxel_size, point_cloud_range,
                   max_points_per_voxel, max_voxels,
                   reflectance_sampling=True, generator=None):
    """Voxelize a padded batch into per-voxel point buffers (the JAX
    package's ``voxelize``, one cloud per row).

    Args: as :func:`voxelize_points_batch`.
    Returns:
        dict with (per item, batched on dim 0)
            voxels: (V, M, C) the kept points of each voxel in slots
                0..count-1, zeros elsewhere,
            coords: (V, 3) int32 (z, y, x), -1 for padding voxels,
            num_points_per_voxel: (V,) int32,
            num_voxels: int32,
            voxel_mask: (V,) bool.
    """
    pp, rank = _voxelize_points_ranked(
        points, num_points, voxel_size=voxel_size,
        point_cloud_range=point_cloud_range,
        max_points_per_voxel=max_points_per_voxel, max_voxels=max_voxels,
        reflectance_sampling=reflectance_sampling, generator=generator)
    b, p, c = points.shape
    m, v = max_points_per_voxel, max_voxels
    # every kept point owns one (voxel, slot); the others go to slot 0 of
    # a dump voxel, which is cut off
    slot = torch.where(pp["pt_valid"],
                       pp["pt_voxel"].long() * m + rank.long(), v * m)
    buf = torch.zeros((b, (v + 1) * m, c), dtype=points.dtype,
                      device=points.device)
    buf.scatter_(1, slot[..., None].expand(b, p, c), pp["points"])
    return {
        "voxels": buf[:, :v * m].reshape(b, v, m, c),
        "coords": pp["coords"],
        "num_points_per_voxel": pp["num_points_per_voxel"],
        "num_voxels": pp["num_voxels"],
        "voxel_mask": pp["voxel_mask"],
    }


def voxelize(points, num_points, *, voxel_size, point_cloud_range,
             max_points_per_voxel, max_voxels, reflectance_sampling=True,
             generator=None):
    """Voxelize one padded cloud, (P, C) points and its count, into
    per-voxel point buffers: :func:`voxelize_batch` of a batch of one,
    the JAX package's ``voxelize``."""
    out = voxelize_batch(
        points[None], torch.as_tensor(num_points,
                                      device=points.device).reshape(1),
        voxel_size=voxel_size, point_cloud_range=point_cloud_range,
        max_points_per_voxel=max_points_per_voxel, max_voxels=max_voxels,
        reflectance_sampling=reflectance_sampling, generator=generator)
    return {k: v[0] for k, v in out.items()}


class Voxelizer:
    """Configured voxelization op: point granularity
    (:meth:`points_batch`) or per-voxel buffers (``__call__``)."""

    def __init__(self, voxel_size, point_cloud_range, max_voxel_points,
                 max_voxels, reflectance_sampling=True):
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.max_voxel_points = int(max_voxel_points)
        self.max_voxels = int(max_voxels)
        self.reflectance_sampling = bool(reflectance_sampling)
        self.grid_size = _grid_of(self.voxel_size, self.point_cloud_range)

    def points_batch(self, points, num_points):
        """Batched point-granularity voxelization: (B, P, C) points and
        (B,) counts -> the batched dict of :func:`voxelize_points_batch`."""
        return voxelize_points_batch(
            points, num_points, voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range,
            max_points_per_voxel=self.max_voxel_points,
            max_voxels=self.max_voxels,
            reflectance_sampling=self.reflectance_sampling)

    def __call__(self, points, num_points, generator=None):
        """Batched buffer voxelization: (B, P, C) points and (B,) counts
        -> the batched dict of :func:`voxelize_batch`; ``generator`` draws
        the insertion order when reflectance sampling is off."""
        return voxelize_batch(
            points, num_points, voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range,
            max_points_per_voxel=self.max_voxel_points,
            max_voxels=self.max_voxels,
            reflectance_sampling=self.reflectance_sampling,
            generator=generator)
