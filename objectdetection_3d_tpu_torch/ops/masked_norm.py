"""The vertical encoder's eval-mode stage norm in one pass: kernel K11.

It replaces no Pallas kernel.  After each conv of a stage the encoder
masks its output, applies the masked batch norm and a ReLU; on the TPU
XLA fuses that chain into one loop, while the port ran it eagerly as
about 13 ATen passes a stage over the dense grid.  In eval mode the
batch norm is its affine ``a * x + b`` (``MaskedBatchNorm.eval_affine``),
and since the mask is 0 or 1,
``relu(bn(x * mask, mask)) == relu(x * a + b) * mask``, so one pass
computes the chain:

    y = round(relu(x * a[c] + b[c]) * mask)

in float32 (float64 for a float64 tensor on the CPU), rounded once to
``x``'s type.

:func:`masked_affine_relu` calls the custom operator
``od3d::masked_affine_relu`` (``ops/custom_ops.py``; no gradient: the
encoder takes it in eval mode only).  On a CUDA tensor it launches the
hand-written kernel in ``csrc/masked_norm.cu`` (:func:`norm_kernel`),
whose bound is bytes: it reads ``x`` and the mask once and writes ``y``
once, in 16-byte vectors, from a persistent grid-stride launch.  The
wrapper takes only what the kernel takes and copies nothing: a CUDA
``x`` must be contiguous channels-last (the NDHWC view of a
channels_last_3d activation) and 16-byte aligned.  Both are checked at
the launch: a traced call has no address, and ``torch.export``'s fake
conv3d gives NCDHW strides where cuDNN's gives channels_last_3d ones.
On a CPU tensor it runs the plain version below, whatever the strides.  A CUDA tensor never takes the
plain version.
"""

import ctypes

import torch

from objectdetection_3d_tpu_torch.ops import cuda_lib
from objectdetection_3d_tpu_torch.ops.pallas_conv import DTYPE_CODES

#: a and b live in the kernel's shared memory, 8 bytes a channel; the
#: port's encoder widths lie in 8..196, each a multiple of 4, which the
#: kernel's runs of four channels need
MAX_CHANNELS = 256

_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])


def masked_affine_relu_plain(x, mask, a, b):
    """Plain PyTorch version of :func:`masked_affine_relu`: the product,
    then the sum, each rounded in ``a``'s type, then the ReLU and the mask;
    returns a contiguous tensor, as the kernel does."""
    wt = a.dtype
    y = torch.relu(x.to(wt) * a + b) * mask.to(wt)[..., None]
    return y.to(x.dtype).contiguous()


def masked_affine_relu(x, mask, a, b):
    """The eval-mode masked batch norm and ReLU of a channels-last tensor.

    Args:
        x: (..., C) float32 or bf16 (float64 too on the CPU), the NDHWC
            view of a stage's activation; on a card contiguous, 16-byte
            aligned, and C a multiple of 4 up to :data:`MAX_CHANNELS`.
        mask: (...) activity (0/1) of ``x``'s pixels, in ``x``'s type;
            contiguous on a card.  (Layouts and alignment are checked at
            the launch.)
        a, b: (C,) eval affine of the batch norm, float32 (float64 for a
            float64 ``x``).
    Returns:
        ``round(relu(x * a + b) * mask)``, contiguous, in ``x``'s type.
    """
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    if x.dtype not in DTYPE_CODES and x.dtype != torch.float64:
        raise ValueError(f"x must be float32, bfloat16 or (on the CPU) "
                         f"float64, got {x.dtype}")
    if x.dim() < 1 or tuple(mask.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"mask must be x's shape without its channels "
                         f"{tuple(x.shape[:-1])}, got {tuple(mask.shape)}")
    if mask.dtype != x.dtype:
        raise ValueError(f"mask must be {x.dtype}, got {mask.dtype}")
    c = x.shape[-1]
    for vec in (a, b):
        if tuple(vec.shape) != (c,) or vec.dtype != wide:
            raise ValueError(f"a and b must be ({c},) {wide}, got "
                             f"{tuple(vec.shape)} {vec.dtype}")
    dev = x.device
    if any(t.device != dev for t in (mask, a, b)):
        raise ValueError("inputs lie on different devices")
    if dev.type == "cuda":
        if x.dtype not in DTYPE_CODES:
            raise ValueError(f"the kernel takes float32 or bfloat16, got "
                             f"{x.dtype}")
        if not 0 < c <= MAX_CHANNELS or c % 4:
            raise ValueError(f"the kernel takes a multiple of 4 channels up "
                             f"to {MAX_CHANNELS}, got {c}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return torch.ops.od3d.masked_affine_relu(x, mask, a, b)


def norm_kernel(x, mask, a, b):
    """Launch K11 on CUDA inputs (as :func:`masked_affine_relu` checks
    them); raises on what the kernel cannot read: strided inputs (x must
    be contiguous channels-last) or an ``x`` off 16-byte alignment (a
    view's offset)."""
    if not all(t.is_contiguous() for t in (x, mask, a, b)):
        raise ValueError("x, mask, a and b must be contiguous on a card, x "
                         "channels-last (the kernel copies nothing)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned on a card")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        cuda_lib.launch("masked_norm", "masked_affine_relu", _ARGTYPES,
                        (x.data_ptr(), mask.data_ptr(), a.data_ptr(),
                         b.data_ptr(), out.data_ptr(), x.numel(),
                         x.shape[-1], DTYPE_CODES[x.dtype]), x.device)
        masked_affine_relu.launches += 1
    return out


masked_affine_relu.launches = 0
