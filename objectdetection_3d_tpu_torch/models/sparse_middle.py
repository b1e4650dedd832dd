"""The gather-based vertical encoder (``tpu.sparse_middle``).

Port of the JAX package's ``models/sparse_middle.py``: a twin of
``layers.SparseMiddleExtractor`` with the same parameters under the same
names and shapes (``subm_{i}_kernel`` (Cout, Cin, 3, 3, 3),
``down_{i}_kernel`` (Cout, Cout, 3, 1, 1), ``subm_bn_{i}``,
``down_bn_{i}``), so one checkpoint drives either encoder.  Instead of the
dense (B, C, D, H, W) grid it keeps each cloud's active set sorted by
flat cell id and runs every conv as neighbour gathers and one matmul
(``ops/sparse_conv.py``).  The masked batch norms take their statistics
over the active sites of the whole batch, as the dense encoder's do.
"""

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_3d_tpu_torch.models.layers import (
    MaskedBatchNorm,
    _lecun_normal,
)
from objectdetection_3d_tpu_torch.ops.sparse_conv import (
    build_index_map,
    downsample_z_active_set,
    scatter_pseudo_image,
    strided_z_conv_sparse,
    subm_conv3d_sparse,
)


class SparseMiddleExtractorGather(nn.Module):
    """Vertical encoder over sorted sparse active sets.

    Args:
        grid: (D, H, W) of the voxel grid.
        budget: active sites kept per stage; 0 = the voxel budget V.
    """

    def __init__(self, in_channels, out_channels, grid, budget=0,
                 dtype=torch.float32):
        super().__init__()
        self.out_channels = tuple(int(c) for c in out_channels)
        self.grid = tuple(int(g) for g in grid)
        self.budget = int(budget)
        self.dtype = dtype
        c = int(in_channels)
        for i, ch in enumerate(self.out_channels):
            self.register_parameter(f"subm_{i}_kernel", nn.Parameter(
                _lecun_normal((ch, c, 3, 3, 3), 27 * c)))
            self.add_module(f"subm_bn_{i}", MaskedBatchNorm(ch))
            self.register_parameter(f"down_{i}_kernel", nn.Parameter(
                _lecun_normal((ch, ch, 3, 1, 1), 3 * ch)))
            self.add_module(f"down_bn_{i}", MaskedBatchNorm(ch))
            c = ch

    @staticmethod
    def _bn_relu(bn, x, mask):
        """``bn`` over the active rows of the whole (B, V, C) batch."""
        b, v, c = x.shape
        y = bn(x.reshape(b * v, c), mask.reshape(b * v, 1))
        return F.relu(y).reshape(b, v, c)

    def forward(self, feats, coords, cell_flat, active_mask):
        """
        Args:
            feats: (B, V, C) voxel features (padding rows zero).
            coords: (B, V, 3) int (z, y, x), -1 padding.
            cell_flat: (B, V) sorted flat ids (sentinel padding).
            active_mask: (B, V) bool validity.
        Returns:
            (B, C_out * D_final, H, W) pseudo-image.
        """
        b = feats.shape[0]
        budget = self.budget or feats.shape[1]
        x = feats.to(self.dtype)
        grid = self.grid
        index_map = [build_index_map(cell_flat[i], grid) for i in range(b)]
        for s in range(len(self.out_channels)):
            k_subm = getattr(self, f"subm_{s}_kernel").permute(2, 3, 4, 1, 0)
            x = torch.stack([subm_conv3d_sparse(
                x[i], coords[i], index_map[i], active_mask[i], k_subm, grid)
                for i in range(b)])
            x = self._bn_relu(getattr(self, f"subm_bn_{s}"), x, active_mask)

            new = [downsample_z_active_set(coords[i], active_mask[i], grid,
                                           budget) for i in range(b)]
            k_down = getattr(self, f"down_{s}_kernel")[:, :, :, 0, 0]
            k_down = k_down.permute(2, 1, 0)                  # (3, C, Co)
            x = torch.stack([strided_z_conv_sparse(
                x[i], index_map[i], new[i]["coords"],
                new[i]["active_mask"], k_down, grid) for i in range(b)])
            coords = torch.stack([n["coords"] for n in new])
            active_mask = torch.stack([n["active_mask"] for n in new])
            grid = new[0]["grid"]
            index_map = [build_index_map(n["cell_flat"], grid) for n in new]
            x = self._bn_relu(getattr(self, f"down_bn_{s}"), x, active_mask)
        return torch.stack([scatter_pseudo_image(x[i], coords[i],
                                                 active_mask[i], grid)
                            for i in range(b)])
