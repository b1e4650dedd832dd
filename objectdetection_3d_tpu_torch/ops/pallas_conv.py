"""3x3x3 SAME convolution for narrow channels: kernel K10.

Port of the JAX package's ``ops/pallas_conv.py::subm_conv3d_pallas``, the
inference-only conv that the vertical encoder's ``pallas_subm_conv`` knob
sends its C <= 24 stages through.  Layouts are the JAX package's: the
input is (B, D, H, W, C) channels last and the kernel (3, 3, 3, C, Co) in
(dz, dy, dx) tap order.

:func:`subm_conv3d` calls the custom operator ``od3d::subm_conv3d``
(``ops/custom_ops.py``): on a CUDA tensor it launches the hand-written
kernel in ``csrc/subm_conv3d.cu`` (:func:`subm_kernel`; bf16 on the
tensor cores, float32 on the CUDA cores); on a CPU tensor it runs the
plain version below, 27 float32 matrix products over shifted views.  A
CUDA tensor never takes the plain version.  The operator has no
gradient: the encoder takes it in eval mode only.  All sum in float32 and round the output to the input's type.
"""

import ctypes

import torch
import torch.nn.functional as F

from objectdetection_3d_tpu_torch.ops import cuda_lib

MAX_IN_CHANNELS = 24
MAX_OUT_CHANNELS = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# output-channel widths of the kernels' tensor-core body (8 per fragment)
_MMA_WIDTHS = (24, 32, 64, 80, 128)
# tile rows of the bf16 body (csrc/halo_ring.cuh)
_TILE_H = 8

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8


def conv3d_acc_plain(x, kernel):
    """The float32 sum of a 3x3x3 SAME conv: (B, D, H, W, C) x
    (3, 3, 3, C, Co) -> (B, D, H, W, Co) float32, the weights rounded to
    ``x.dtype`` first, as the kernels take them."""
    b, d, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wk = kernel.to(x.dtype).float()
    acc = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                term = xp[:, dz:dz + d, dy:dy + h, dx:dx + w] @ wk[dz, dy, dx]
                acc = term if acc is None else acc + term
    return acc


def subm_conv3d_plain(x, kernel):
    """Plain PyTorch version of :func:`subm_conv3d`."""
    return conv3d_acc_plain(x, kernel).to(x.dtype)


def kernel_weights(w):
    """The (taps, C, Co) weights as a kernel takes them: float32 as they
    are, with width 0; bf16 packed for the tensor-core body as
    (ceil(C/16), taps, np, 16), zero-padded, with its width np (the
    smallest of ``_MMA_WIDTHS`` that holds Co).

    Returns:
        (contiguous weights, np).
    """
    if w.dtype == torch.float32:
        return w.contiguous(), 0
    taps, c, co = w.shape
    np_ = next(n for n in _MMA_WIDTHS if n >= co)
    chunks = -(-c // 16)
    wp = w.new_zeros((taps, chunks * 16, np_))
    wp[:, :c, :co] = w
    wp = wp.reshape(taps, chunks, 16, np_).permute(1, 0, 3, 2)
    return wp.contiguous(), np_


def check_grid(x, name="x"):
    """Raise unless ``x`` is a (B, D, H, W, C) float32 or bf16 tensor on
    the CPU or a CUDA device; returns its device."""
    if x.dim() != 5:
        raise ValueError(f"{name} must be (B, D, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def subm_conv3d(x, kernel):
    """3x3x3 SAME conv, bias-free, of a narrow-channel grid.

    Args:
        x: (B, D, H, W, C) float32 or bf16, C <= 24.
        kernel: (3, 3, 3, C, Co) weights, Co <= 64; cast to ``x.dtype``.
    Returns:
        (B, D, H, W, Co) in ``x.dtype``, summed in float32.
    """
    dev = check_grid(x)
    b, d, h, w, c = x.shape
    if kernel.shape[:4] != (3, 3, 3, c) or kernel.dim() != 5:
        raise ValueError(f"kernel must be (3, 3, 3, {c}, Co), got "
                         f"{tuple(kernel.shape)}")
    co = kernel.shape[-1]
    if not (0 < c <= MAX_IN_CHANNELS and 0 < co <= MAX_OUT_CHANNELS):
        raise ValueError(f"subm_conv3d takes 1..{MAX_IN_CHANNELS} input and "
                         f"1..{MAX_OUT_CHANNELS} output channels, got {c} "
                         f"and {co}")
    if kernel.device != dev:
        raise ValueError("x and kernel lie on different devices")
    if dev.type == "cuda":
        if x.dtype == torch.float32 and b * d > 65535:
            raise ValueError(f"B * D = {b * d} exceeds the float32 kernel's "
                             f"grid")
        if x.dtype == torch.bfloat16 and (b > 65535
                                          or -(-h // _TILE_H) > 65535):
            raise ValueError(f"B = {b} or H = {h} exceeds the bf16 kernel's "
                             f"grid")
    return torch.ops.od3d.subm_conv3d(x, kernel)


def subm_kernel(x, kernel):
    """Launch K10 on CUDA ``x`` and ``kernel`` (shapes as
    :func:`subm_conv3d` checks them)."""
    b, d, h, w, c = x.shape
    co = kernel.shape[-1]
    x = x.contiguous()
    wk, np_ = kernel_weights(kernel.to(x.dtype).reshape(27, c, co))
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    cuda_lib.launch("subm_conv3d", "subm_conv3d", _ARGTYPES,
                    (x.data_ptr(), wk.data_ptr(), out.data_ptr(), b, d, h,
                     w, c, co, np_, DTYPE_CODES[x.dtype]), x.device)
    subm_conv3d.launches += 1
    return out


subm_conv3d.launches = 0
