"""PyTorch + CUDA port of objectdetection_3d_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (``ops/``, ``models/``) so
each module's counterpart sits at the same relative path.  It imports
torch only: nothing of JAX and nothing of ``objectdetection_3d_tpu``.

Slice 1 covers single-cloud inference, points in and boxes out:
voxelize -> point PFN -> grid build -> vertical encoder -> sparse RPN ->
head -> decode -> NMS (``models.detector.PointPillars.predict``).  The two
hand-written CUDA kernels on that path live in ``csrc/`` and are bound in
``ops/voxel_scan.py`` and ``ops/grid_scatter.py``.
"""
