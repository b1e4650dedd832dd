"""One eval-mode vertical-encoder stage in one pass: kernel K8.

Port of the JAX package's ``ops/fused_stage.py::fused_stage_call``, which
the vertical encoder's ``fused_stages`` knob sends its narrow stages
through at inference.  It computes, with the batch norms as their eval
affines ``a * x + b``:

* ``y = round(relu(subm(x) * a_s + b_s) * mask)``: the 3x3x3 SAME subm
  conv summed in float32, then mask, affine and ReLU, rounded to the
  compute type as the TPU kernel's ``y0.astype(o_ref.dtype)`` does;
* ``out = round(relu(down(y) * a_d + b_d) * maxpool_z(mask))``: the
  (3,1,1)/(2,1,1) VALID down conv summed in float32, its affine and ReLU
  under the pooled mask.

The layout is the unfolded one, channels last: the JAX wrapper's z fold,
selector matrices and banded weights exist for the TPU's 128 lanes and
are not carried over.  The pooled mask itself is not an output: the
encoder takes it from ``max_pool3d``, as the JAX package does.

:func:`fused_stage` calls the custom operator ``od3d::fused_stage``
(``ops/custom_ops.py``; no gradient: the encoder takes it in eval mode
only).  On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_stage.cu`` (:func:`stage_kernel`).  In bf16 a block walks the output slices of its
pixel tile in z, computing each subm slice once, with the weights resident
in shared memory and both convs on the tensor cores (the subm weights
packed by ``pallas_conv.kernel_weights``, the down weights by
:func:`down_weights`); in float32 a block computes one output slice on the
CUDA cores.  On a CPU tensor it runs the plain version below, the same
arithmetic as float32 tap loops.  A CUDA tensor never takes the plain
version.
"""

import ctypes

import torch
import torch.nn.functional as F

from objectdetection_3d_tpu_torch.ops import cuda_lib
from objectdetection_3d_tpu_torch.ops.pallas_conv import (
    DTYPE_CODES,
    check_grid,
    conv3d_acc_plain,
    kernel_weights,
)

#: the JAX gate's widths (``_fused_zb``): C <= 32, Co <= 64; the bf16
#: kernel keeps all of its weights in shared memory
MAX_IN_CHANNELS = 32
MAX_OUT_CHANNELS = 64
# the bf16 kernel's tiles are 8 rows high; a grid dimension holds 65535
_TILE_H = 8

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8


def fused_stage_plain(x, mask, subm_w, down_w, a_s, b_s, a_d, b_d):
    """Plain PyTorch version of :func:`fused_stage`."""
    dt = x.dtype
    acc = conv3d_acc_plain(x, subm_w)
    y = (torch.relu(acc * a_s.float() + b_s.float())
         * mask[..., None].float()).to(dt).float()
    d_out = (x.shape[1] - 3) // 2 + 1
    wd = down_w.to(dt).float()
    dd = None
    for t in range(3):
        term = y[:, t:t + 2 * (d_out - 1) + 1:2] @ wd[t]
        dd = term if dd is None else dd + term
    md = F.max_pool3d(mask.float()[:, None], (3, 1, 1), (2, 1, 1))[:, 0]
    return (torch.relu(dd * a_d.float() + b_d.float())
            * md[..., None]).to(dt)


def down_weights(down_w, np_):
    """The (3, Co, Co) down weights ([t, in, out]) as the bf16 kernel's
    tensor-core B operand: (3, np, kd) with ``[t, n, k] = down_w[t, k,
    n]``, zero beyond Co, for the subm body's padded width ``np`` and kd =
    16 * ceil(np / 16) (whole k16 steps); contiguous."""
    co = down_w.shape[-1]
    kd = -(-np_ // 16) * 16
    wp = down_w.new_zeros((3, np_, kd))
    wp[:, :co, :co] = down_w.transpose(1, 2)
    return wp.contiguous()


def fused_stage(x, mask, subm_w, down_w, a_s, b_s, a_d, b_d):
    """One eval-mode encoder stage.

    Args:
        x: (B, D, H, W, C) float32 or bf16 stage input, D >= 3, C <= 32.
        mask: (B, D, H, W) activity (0/1); cast to ``x.dtype``.
        subm_w: (3, 3, 3, C, Co) subm conv weights, Co <= 64.
        down_w: (3, Co, Co) down conv weights ([t, in, out]).
        a_s, b_s, a_d, b_d: (Co,) eval affines of the two batch norms,
            taken in float32.
        (Weights are cast to ``x.dtype``.)
    Returns:
        (B, (D-3)//2+1, H, W, Co) in ``x.dtype``.
    """
    dev = check_grid(x)
    b, d, h, w, c = x.shape
    if subm_w.dim() != 5 or tuple(subm_w.shape[:4]) != (3, 3, 3, c):
        raise ValueError(f"subm_w must be (3, 3, 3, {c}, Co), got "
                         f"{tuple(subm_w.shape)}")
    co = subm_w.shape[-1]
    if tuple(down_w.shape) != (3, co, co):
        raise ValueError(f"down_w must be (3, {co}, {co}), got "
                         f"{tuple(down_w.shape)}")
    if tuple(mask.shape) != (b, d, h, w):
        raise ValueError(f"mask must be {(b, d, h, w)}, got "
                         f"{tuple(mask.shape)}")
    for vec in (a_s, b_s, a_d, b_d):
        if tuple(vec.shape) != (co,):
            raise ValueError(f"affines must be ({co},), got "
                             f"{tuple(vec.shape)}")
    if d < 3 or not (0 < c <= MAX_IN_CHANNELS
                     and 0 < co <= MAX_OUT_CHANNELS):
        raise ValueError(f"fused_stage takes D >= 3, 1..{MAX_IN_CHANNELS} "
                         f"input and 1..{MAX_OUT_CHANNELS} output channels, "
                         f"got D={d}, C={c}, Co={co}")
    tensors = (mask, subm_w, down_w, a_s, b_s, a_d, b_d)
    if any(t.device != dev for t in tensors):
        raise ValueError("inputs lie on different devices")
    if dev.type == "cuda":
        d_out = (d - 3) // 2 + 1
        if x.dtype == torch.float32 and b * d_out > 65535:
            raise ValueError(f"B * D' = {b * d_out} exceeds the float32 "
                             f"kernel's grid")
        if x.dtype == torch.bfloat16 and (b > 65535
                                          or -(-h // _TILE_H) > 65535):
            raise ValueError(f"B = {b} or H = {h} exceeds the bf16 kernel's "
                             f"grid")
    return torch.ops.od3d.fused_stage(x, mask, subm_w, down_w, a_s, b_s,
                                      a_d, b_d)


def stage_kernel(x, mask, subm_w, down_w, a_s, b_s, a_d, b_d):
    """Launch K8 on CUDA inputs (shapes as :func:`fused_stage` checks
    them)."""
    b, d, h, w, c = x.shape
    co = subm_w.shape[-1]
    d_out = (d - 3) // 2 + 1
    dt = x.dtype
    x = x.contiguous()
    m = mask.to(dt).contiguous()
    ws, np_ = kernel_weights(subm_w.to(dt).reshape(27, c, co))
    if dt == torch.bfloat16:
        wd = down_weights(down_w.to(dt), np_)
    else:
        wd = down_w.float().contiguous()
    vec = torch.stack([a_s, b_s, a_d, b_d]).float().contiguous()
    out = torch.empty((b, d_out, h, w, co), dtype=dt, device=x.device)
    cuda_lib.launch("fused_stage", "fused_stage", _ARGTYPES,
                    (x.data_ptr(), m.data_ptr(), ws.data_ptr(),
                     wd.data_ptr(), vec.data_ptr(), out.data_ptr(), b, d, h,
                     w, c, co, np_, DTYPE_CODES[dt]), x.device)
    fused_stage.launches += 1
    return out


fused_stage.launches = 0
