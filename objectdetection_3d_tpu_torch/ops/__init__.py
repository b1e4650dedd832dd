"""Tensor ops of the port: box geometry, voxelization, the CUDA kernels
and NMS."""
