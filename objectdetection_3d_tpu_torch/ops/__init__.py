"""Tensor ops of the port: box geometry, voxelization, the CUDA kernels
and NMS.  Importing the package registers predict's kernels as the
``torch.ops.od3d`` custom operators (``custom_ops``), which their
wrappers call."""

from objectdetection_3d_tpu_torch.ops import custom_ops  # noqa: F401
