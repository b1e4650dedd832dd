"""What the K9 wrapper computes in Python for its bf16 kernel
(``ops/zfold_conv.py``): the slice widths and the swizzled wgmma weight
packing.

The packing is unpacked here by a plain loop over its documented layout
and compared, exactly, with the weights it came from, in both
orientations the wrapper packs: ``w`` for the forward conv and
``w.flip(0, 1).transpose(2, 3)`` for the input gradient's.  No JAX function packs weights, so no JAX reference runs.
"""

import numpy as np
import pytest
import torch

from objectdetection_3d_tpu_torch.ops.zfold_conv import (
    slice_width,
    wgmma_weights,
)

torch.set_num_threads(1)


def _unpack(packed, ns):
    """(3, 3, nch*64, nsl*ns) weights from the packed (nsl, 9, nch, ns, 8,
    8) layout: piece j of row n holds channels 8 * (j ^ (n % 8)) .. + 8."""
    nsl, _, nch = packed.shape[:3]
    w = np.zeros((9, nch * 64, nsl * ns), packed.dtype)
    for s in range(nsl):
        for n in range(ns):
            for j in range(8):
                c0 = 8 * (j ^ (n % 8))
                for ch in range(nch):
                    w[:, ch * 64 + c0:ch * 64 + c0 + 8, s * ns + n] = \
                        packed[s, :, ch, n, j]
    return w.reshape(3, 3, nch * 64, nsl * ns)


@pytest.mark.parametrize("co,ns,slices", [(1, 8, 1), (7, 8, 1), (20, 24, 1),
                                          (64, 64, 1), (72, 72, 1),
                                          (80, 80, 1), (81, 48, 2),
                                          (120, 64, 2), (128, 64, 2)])
def test_slice_width(co, ns, slices):
    assert slice_width(co) == ns
    assert -(-co // ns) == slices
    assert ns % 8 == 0 and ns <= 80


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("c,co", [(120, 80), (120, 128), (128, 128),
                                  (7, 20), (24, 40), (40, 64), (128, 1)])
def test_wgmma_weights_unpack_to_w(c, co, transpose):
    rng = np.random.default_rng(c * 1000 + co)
    w = torch.from_numpy(rng.normal(0, 1, (3, 3, c, co)).astype(np.float32))
    want = w.flip(0, 1).transpose(2, 3) if transpose else w
    packed, ns = wgmma_weights(want.to(torch.bfloat16))
    cin, cout = want.shape[2:]
    assert ns == slice_width(cout)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    nch = -(-cin // 64)
    assert tuple(packed.shape) == (-(-cout // ns), 9, nch, ns, 8, 8)
    got = _unpack(packed.float().numpy(), ns)
    want = want.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[:, :, :cin, :cout], want)
    # the padding beyond C and Co is zero
    assert not got[:, :, cin:].any() and not got[:, :, :, cout:].any()

