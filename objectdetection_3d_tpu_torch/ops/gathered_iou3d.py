"""Exact rotated-3D intersections of box pairs: kernels K5, K6 and K7.

Port of the JAX package's ``ops/pallas_iou3d.py``:
``intersection_volume_aligned`` (K5, the backend-dispatched
``intersection_volume_aligned_pallas``), ``iou_gathered`` (K6,
``iou_gathered_pallas``) and ``iou_gathered_pair`` (K7,
``iou_gathered_pair_pallas``).  Target assignment runs K6 on the (G, K)
candidate pairs of stage 2 and K7 on every anchor against its top-2 GTs
(the exact anchor tier); K5 is the aligned clipper that the JAX
package's ``tools/profile_assign.py`` times over the tier's pairs.

On a CUDA tensor a wrapper launches the hand-written kernel in
``csrc/iou3d_clip.cu``; on a CPU tensor it runs the plain version, the
plain clipper of ``ops/iou3d.py`` (after the row gather, for K6/K7).  A
CUDA tensor never takes the plain version.  All three first run a
separating-plane test per pair (``ops/iou3d.separated_directions`` is its
plain version) and clip only what it cannot clear, 12 lanes to a pair;
the wrappers allocate the kernels' scratch (the list of pairs to clip,
and K6/K7's per-row records).
"""

import ctypes

import torch

from objectdetection_3d_tpu_torch.ops import cuda_lib
from objectdetection_3d_tpu_torch.ops.iou3d import (
    _UNION_EPS,
    iou_from_volumes,
)
from objectdetection_3d_tpu_torch.ops.iou3d import (
    intersection_volume_aligned as intersection_volume_aligned_plain,
)

#: table rows the kernels take
MAX_TABLE_ROWS = 1024
#: floats of a table row's record in the kernels' scratch
_ROW_RECORD = 72
#: pairs K5 takes: its list items hold ``p << 2`` in 32 bits
MAX_ALIGNED_PAIRS = 2 ** 30

_ARGS_ONE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p]
_ARGS_ALIGNED = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_void_p]
_ARGS_PAIR = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def iou_gathered_plain(table, valid, ids, boxes2):
    """Plain PyTorch version of :func:`iou_gathered`."""
    b1 = table.float()[ids.long()]
    b2 = boxes2.float()
    inter = intersection_volume_aligned_plain(b1, b2)
    vol1 = b1[:, 3] * b1[:, 4] * b1[:, 5]
    vol2 = b2[:, 3] * b2[:, 4] * b2[:, 5]
    iou = iou_from_volumes(inter, vol1, vol2, _UNION_EPS)
    return iou * valid[ids.long()].to(iou.dtype)


def iou_gathered_pair_plain(table, valid, ids_a, ids_b, boxes2):
    """Plain PyTorch version of :func:`iou_gathered_pair`."""
    return (iou_gathered_plain(table, valid, ids_a, boxes2),
            iou_gathered_plain(table, valid, ids_b, boxes2))


def _check(table, valid, id_streams, boxes2):
    g = table.shape[0]
    p = boxes2.shape[0]
    if table.dim() != 2 or table.shape[1] != 9 or valid.shape != (g,):
        raise ValueError(f"table must be (G, 9) with (G,) valid, got "
                         f"{tuple(table.shape)} / {tuple(valid.shape)}")
    if boxes2.dim() != 2 or boxes2.shape[1] != 9:
        raise ValueError(f"boxes2 must be (P, 9), got {tuple(boxes2.shape)}")
    for ids in id_streams:
        if ids.shape != (p,) or ids.dtype != torch.int32:
            raise ValueError(f"ids must be ({p},) int32, got "
                             f"{tuple(ids.shape)} {ids.dtype}")
    tensors = (table, valid, boxes2, *id_streams)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("inputs lie on different devices")
    dev = table.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not 0 < g <= MAX_TABLE_ROWS:
        raise ValueError(f"the kernels hold 1..{MAX_TABLE_ROWS} table rows, "
                         f"got {g}")
    if dev.type == "cuda" and p >= 2 ** 29:
        raise ValueError(f"the kernels take fewer than 2^29 pairs, got {p}")
    return dev


def _scratch(g, streams, p, dev):
    """The kernels' scratch: (g, 72) float32 row records, and an int32
    count followed by room for ``streams * p`` list items."""
    return (torch.empty((g, _ROW_RECORD), dtype=torch.float32, device=dev),
            torch.empty((1 + streams * p,), dtype=torch.int32, device=dev))


def _table10(table, valid):
    """(G, 10) float32: 9 box fields + validity, the kernels' table."""
    return torch.cat([table.float(), valid.float()[:, None]],
                     dim=1).contiguous()


def iou_gathered(table, valid, ids, boxes2):
    """Masked IoU of the pairs ``(table[ids[p]], boxes2[p])``.

    Args:
        table: (G, 9) box table (e.g. padded GT boxes).
        valid: (G,) row validity (bool or float).
        ids: (P,) int32 table rows in [0, G).
        boxes2: (P, 9) aligned counterpart boxes.
    Returns:
        (P,) float32 IoU; 0 wherever ``valid[ids[p]]`` is falsy.
    """
    dev = _check(table, valid, (ids,), boxes2)
    if dev.type == "cpu":
        return iou_gathered_plain(table, valid, ids, boxes2)
    p = boxes2.shape[0]
    tab = _table10(table, valid)
    ids = ids.contiguous()
    b2 = boxes2.float().contiguous()
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    rec, work = _scratch(tab.shape[0], 1, p, dev)
    cuda_lib.launch("iou3d_clip", "iou_gathered", _ARGS_ONE,
                    (tab.data_ptr(), tab.shape[0], ids.data_ptr(),
                     b2.data_ptr(), out.data_ptr(), p, rec.data_ptr(),
                     work.data_ptr()), dev)
    iou_gathered.launches += 1
    return out


def iou_gathered_pair(table, valid, ids_a, ids_b, boxes2):
    """Masked IoUs of ``(table[ids_a[p]], boxes2[p])`` and
    ``(table[ids_b[p]], boxes2[p])``, both in one pass over ``boxes2``.

    Returns:
        ((P,), (P,)) float32 IoUs; 0 where the table row is invalid.
    """
    dev = _check(table, valid, (ids_a, ids_b), boxes2)
    if dev.type == "cpu":
        return iou_gathered_pair_plain(table, valid, ids_a, ids_b, boxes2)
    p = boxes2.shape[0]
    tab = _table10(table, valid)
    ids_a, ids_b = ids_a.contiguous(), ids_b.contiguous()
    b2 = boxes2.float().contiguous()
    out = torch.empty((2, p), dtype=torch.float32, device=dev)
    rec, work = _scratch(tab.shape[0], 2, p, dev)
    cuda_lib.launch("iou3d_clip", "iou_gathered_pair", _ARGS_PAIR,
                    (tab.data_ptr(), tab.shape[0], ids_a.data_ptr(),
                     ids_b.data_ptr(), b2.data_ptr(), out.data_ptr(), p,
                     rec.data_ptr(), work.data_ptr()), dev)
    iou_gathered_pair.launches += 1
    return out[0], out[1]


def intersection_volume_aligned(boxes1, boxes2):
    """Intersection volumes of the aligned pairs ``(boxes1[p], boxes2[p])``.

    Args:
        boxes1, boxes2: (P, 9) boxes.
    Returns:
        (P,) float32 volumes, not clamped at 0 (the clipper's rounding
        can leave a touching pair slightly negative).
    """
    if boxes1.dim() != 2 or boxes1.shape[1] != 9 or \
            boxes2.shape != boxes1.shape:
        raise ValueError(f"boxes must be two (P, 9) arrays, got "
                         f"{tuple(boxes1.shape)} / {tuple(boxes2.shape)}")
    dev = boxes1.device
    if boxes2.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"boxes must lie on one CPU or CUDA device, got "
                         f"{dev} and {boxes2.device}")
    if dev.type == "cpu":
        return intersection_volume_aligned_plain(boxes1, boxes2)
    p = boxes1.shape[0]
    if p >= MAX_ALIGNED_PAIRS:
        raise ValueError(f"the kernel takes fewer than 2^30 pairs, got {p}")
    b1 = boxes1.float().contiguous()
    b2 = boxes2.float().contiguous()
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    # the list's count, then room for every pair
    work = torch.empty((1 + p,), dtype=torch.int32, device=dev)
    cuda_lib.launch("iou3d_clip", "intersection_volume_aligned",
                    _ARGS_ALIGNED,
                    (b1.data_ptr(), b2.data_ptr(), out.data_ptr(), p,
                     work.data_ptr()), dev)
    intersection_volume_aligned.launches += 1
    return out


intersection_volume_aligned.launches = 0
iou_gathered.launches = 0
iou_gathered_pair.launches = 0
