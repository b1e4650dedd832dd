"""3x3 SAME 2D convolution on the z-folded encoder layout: kernel K9.

Port of the JAX package's ``ops/zfold_conv.py::conv2d_3x3_pallas``, the
conv that the vertical encoder's ``zfold_pallas`` knob runs its folded
subm convs through (``models/layers.py``).  Layouts are the JAX
package's: the input is (N, H, W, C) channels last and the weights
(3, 3, C, Co) in (dy, dx) tap order, with C, Co <= 128.

:func:`conv2d_3x3` calls the custom operator ``od3d::conv2d_3x3``
(``ops/custom_ops.py``), whose registered gradient is the JAX function's
``custom_vjp``: its input gradient (``od3d::conv2d_3x3_dx``) is the same
conv of the cotangent with the taps flipped and the channels swapped
(:func:`dx_weights`), and its weight gradient the 9 contractions over
the N*H*W rows (:func:`weight_grad`), left to ``torch.matmul`` as the
JAX package leaves them to XLA.  On a CUDA tensor the forward conv and
the input gradient's conv launch the hand-written kernel in
``csrc/zfold_conv.cu`` (:func:`conv_kernel`; bf16 on the tensor cores
through wgmma, with the weights packed by :func:`wgmma_weights`; float32
on the CUDA cores), counted apart in ``conv2d_3x3.launches`` and
``conv2d_3x3.dx_launches``; on a CPU tensor both run the plain version,
9 float32 matrix products over shifted views.  A CUDA tensor never takes
the plain version.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from objectdetection_3d_tpu_torch.ops import cuda_lib
from objectdetection_3d_tpu_torch.ops.pallas_conv import DTYPE_CODES

MAX_CHANNELS = 128
# the bf16 kernel's tiles are 8 (or more) x 16 pixels, counted in a
# 32-bit int
_TILE_H, _TILE_W = 8, 16

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7


def conv2d_3x3_plain(x, w):
    """Plain PyTorch version of :func:`conv2d_3x3`'s forward: the float32
    sum of the 9 taps, rounded to ``x.dtype``.  Differentiable by
    autograd."""
    _, h, width, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wk = w.to(x.dtype).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, dy:dy + h, dx:dx + width] @ wk[dy, dx]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def slice_width(co):
    """Output channels per block of the bf16 kernel: all ``co`` (rounded
    up to 8) up to 80, else half of them, so that a slice's weights stay
    resident in shared memory."""
    width = co if co <= 80 else -(-co // 2)
    return -(-width // 8) * 8


def wgmma_weights(w):
    """The (3, 3, C, Co) weights packed for the bf16 kernel's wgmma B
    operand.

    The output channels are cut into ``ceil(Co / ns)`` slices of ``ns =
    slice_width(Co)``.  Per slice, tap (dy, dx) and 64-channel chunk of C,
    ns rows of 64 channels (128 bytes), zero-padded, K-major with the
    128-byte swizzle: 16-byte piece j of row n holds channels
    8 * (j ^ (n % 8)) .. + 8.

    Returns:
        (contiguous (nsl, 9, nch, ns, 8, 8) tensor of w's type, ns).
    """
    c, co = w.shape[2:]
    ns = slice_width(co)
    nsl, nch = -(-co // ns), -(-c // 64)
    wp = w.new_zeros((9, nch * 64, nsl * ns))
    wp[:, :c, :co] = w.reshape(9, c, co)
    # (tap, chunk, piece, element, slice, n) -> (slice, tap, chunk, n,
    # piece, element)
    wp = wp.reshape(9, nch, 8, 8, nsl, ns).permute(4, 0, 1, 5, 2, 3)
    index = _swizzle(ns, w.device)[None, None, None, :, :, None]
    return wp.gather(4, index.expand(nsl, 9, nch, ns, 8, 8)), ns


@functools.lru_cache(maxsize=None)
def _swizzle(ns, device):
    """(ns, 8) index: the piece of row n stored at position j,
    j ^ (n % 8)."""
    n = torch.arange(ns, device=device)
    return torch.arange(8, device=device)[None, :] ^ (n[:, None] % 8)


def conv_kernel(x, w, counter):
    """Launch K9: the conv of CUDA (N, H, W, C) ``x`` with (3, 3, C, Co)
    ``w`` of the same type, counted in ``conv2d_3x3.<counter>``."""
    x = x.contiguous()
    n, h, width, c = x.shape
    co = w.shape[-1]
    if x.dtype == torch.bfloat16:
        wk, ns = wgmma_weights(w)
    else:
        wk, ns = w.contiguous(), 0
    out = torch.empty((n, h, width, co), dtype=x.dtype, device=x.device)
    cuda_lib.launch("zfold_conv", "conv2d_3x3", _ARGTYPES,
                    (x.data_ptr(), wk.data_ptr(), out.data_ptr(), n, h,
                     width, c, co, ns, DTYPE_CODES[x.dtype]), x.device)
    setattr(conv2d_3x3, counter, getattr(conv2d_3x3, counter) + 1)
    return out


def dx_weights(w):
    """The input gradient's (3, 3, Co, C) taps: tap (dy, dx) is tap
    (2-dy, 2-dx) of ``w`` with in/out channels swapped."""
    return w.flip(0, 1).transpose(2, 3)


def weight_grad(x, g):
    """The weight gradient of the conv of (N, H, W, C) ``x``, for its
    (N, H, W, Co) cotangent ``g``: dw[dy, dx] = sum over n, h, w of
    x[h+dy-1, w+dx-1] g[h, w]."""
    _, h, width, c = x.shape
    co = g.shape[-1]
    xz = F.pad(x, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(-1, co)
    return torch.stack([
        xz[:, dy:dy + h, dx:dx + width].reshape(-1, c).t() @ g2
        for dy in range(3) for dx in range(3)]).reshape(3, 3, c, co)


def conv2d_3x3(x, w):
    """3x3 SAME 2D conv, bias-free.

    Args:
        x: (N, H, W, C) float32 or bf16, C <= 128.
        w: (3, 3, C, Co) weights, Co <= 128; cast to ``x.dtype`` (the
            gradient flows back through the cast).
    Returns:
        (N, H, W, Co) in ``x.dtype``, summed in float32.
    """
    if x.dim() != 4 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be (N, H, W, C) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, _, _, c = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, Co), got {tuple(w.shape)}")
    co = w.shape[-1]
    if not (0 < c <= MAX_CHANNELS and 0 < co <= MAX_CHANNELS):
        raise ValueError(f"conv2d_3x3 takes 1..{MAX_CHANNELS} input and "
                         f"output channels, got {c} and {co}")
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise ValueError(f"x and w must lie on one CPU or CUDA device, got "
                         f"{x.device} and {w.device}")
    if x.device.type == "cuda" and x.dtype == torch.float32 and n > 65535:
        raise ValueError(f"N = {n} exceeds the float32 kernel's grid")
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        _, h, width, _ = x.shape
        tiles = n * -(-h // _TILE_H) * -(-width // _TILE_W)
        if tiles >= 2 ** 31:
            raise ValueError(f"{tiles} tiles of 8x16 pixels exceed the "
                             f"bf16 kernel's 32-bit tile count")
    return torch.ops.od3d.conv2d_3x3(x, w.to(x.dtype))


conv2d_3x3.launches = 0
conv2d_3x3.dx_launches = 0
